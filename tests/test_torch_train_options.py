"""The trainer's options against the JAX package: Adafactor, the bf16 Adam
first moment, TensorBoard logging and async checkpoints.

fp32 on the CPU.  The optimizers are held against the JAX package's
``make_optimizer`` (optax 0.2.6) under ``jax.jit``, as the JAX step runs
it, on fixed gradients of a tree whose trainable leaves include factored
shapes (two dims >= 128: a (300, 128) embedding, stacked (2, 128, 160) and
(2, 160, 128) layer kernels, a (130, 129) matrix) and unfactored ones, and
a frozen leaf.  Tolerances, each with its reason:

* Adafactor params: atol 1e-6 and rtol 1e-6, and its factored statistics
  rtol 1e-5: the means over the factored axes are summed in XLA's order
  and torch's, then go through rsqrt (a few ulps of each update);
* AdamW with bf16 mu: the stored ``mu`` bit-equal to optax's when the
  clip does not bite (the gradients entering the moment are the same
  bits); with the clip biting, the global norms differ in their last
  bits, so at most 1 in 10,000 elements of ``mu`` may sit one bf16 ulp
  off, and the params are held at atol 1e-6 and rtol 1e-6;
* the port's Trainer against JAX's step (``attn_impl="xla"``): the
  logged losses and grad norms rtol 1e-4, the bar of
  ``test_torch_train.py::test_train_step_matches_jax``, and the params
  at atol 5e-6 = lr * 5e-3 (updates normalised by the second moment),
  except, as there, an element whose gradient came within 1e-6 of zero at
  some step: Adam's lr * g / (|g| + eps) may then move it by up to 2 lr a
  step.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils import checkpoint as tckpt
from mjvideo_tpu_torch.utils.bridge import from_jax_params
from test_torch_train import make_batch

torch.set_num_threads(1)
LR = 1e-3


def _tree(rng):
    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"regression_layer": {"kernel": arr(4, 3)},
            "criteria_gating": {"layer_0": {"kernel": arr(3, 2)}},
            "aspect_gating": {"layer_0": {"kernel": arr(3, 2)}},
            "model": {"vision_model": {"w": arr(5)},
                      "language_model": {
                          "tok_embeddings": arr(300, 128),
                          "layers": {"wq": arr(2, 128, 160),
                                     "wo": arr(2, 160, 128),
                                     "norm": arr(2, 128)},
                          "norm": {"weight": arr(128)},
                          "square": arr(130, 129)}}}


def _find(state, field):
    """The first node of an optax state with attribute ``field``."""
    if hasattr(state, field):
        return state
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (tuple, list)):
        for x in state:
            got = _find(x, field)
            if got is not None:
                return got
    return None


def _by_path(tree):
    return {jtrainer._path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_leaves_with_path(tree)
            if hasattr(leaf, "dtype")}


def _run_both(kw, steps=7, scale=0.4):
    """``steps`` micro-steps of fixed gradients through both optimizers:
    (the port's flat params, its state, JAX's params, JAX's state)."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    tc_j = jtrainer.TrainConfig(learning_rate=LR, total_steps=6, **kw)
    tc_t = ttrainer.TrainConfig(learning_rate=LR, total_steps=6, **kw)
    jopt = jtrainer.make_optimizer(tc_j, params)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    update = jax.jit(jopt.update)
    apply = jax.jit(optax.apply_updates)
    tp = from_jax_params(params, device="cpu")
    topt = ttrainer.make_optimizer(tc_t, tp)
    tstate = topt.init(tp)
    for _ in range(steps):
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
            params)
        upd, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = apply(jp, upd)
        tg = ttrainer.flatten_state(from_jax_params(grads, device="cpu"))
        tstate = topt.update({p: tg[p] for p in topt.paths}, tstate, tp)
    return ttrainer.flatten_state(tp), tstate, _by_path(jp), jstate, topt


def _params_close(flat, want, frozen_from=None):
    for path, t in flat.items():
        np.testing.assert_allclose(t.numpy(), want[path], atol=1e-6,
                                   rtol=1e-6, err_msg=path)


@pytest.mark.parametrize("kw", [
    dict(stage=1),
    dict(stage=2, weight_decay=0.1, schedule="cosine", warmup_steps=2),
    dict(stage=3, gradient_accumulation_steps=2, max_grad_norm=0.5,
         weight_decay=0.05, schedule="constant"),
], ids=["stage1", "wd-cosine-warmup", "accum2-clip"])
def test_adafactor_matches_optax(kw):
    flat, state, want, jstate, topt = _run_both(dict(optimizer="adafactor",
                                                     **kw))
    _params_close(flat, want)
    before = ttrainer.flatten_state(from_jax_params(
        _tree(np.random.default_rng(1)), device="cpu"))
    for path in flat:
        if path not in topt.paths:  # frozen: untouched
            assert torch.equal(flat[path], before[path]), path
    # The factored statistics: the same dims chosen, the same values.
    fs = _find(jstate, "v_row")
    rows, cols, full = _by_path(fs.v_row), _by_path(fs.v_col), _by_path(fs.v)
    factored = {p for p in topt.paths
                if ttrainer.factored_dims(tuple(flat[p].shape))}
    assert factored == {"model/language_model/tok_embeddings",
                        "model/language_model/layers/wq",
                        "model/language_model/layers/wo",
                        "model/language_model/square"}
    assert set(state["v_row"]) == set(state["v_col"]) == factored
    assert set(state["v"]) == set(topt.paths) - factored
    for path in topt.paths:
        if path in factored:
            for got, ref in ((state["v_row"][path], rows[path]),
                             (state["v_col"][path], cols[path])):
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                           err_msg=path)
        else:
            np.testing.assert_allclose(state["v"][path].numpy(), full[path],
                                       rtol=1e-5, err_msg=path)
    assert ttrainer.state_bytes(state) < ttrainer.state_bytes(
        ttrainer.Optimizer(ttrainer.TrainConfig(**{**kw, "optimizer":
                                                   "adamw"}),
                           set(topt.paths)).init(
            from_jax_params(_tree(np.random.default_rng(1)), device="cpu")))


def _mu_bits(state, jstate):
    """(differing elements, elements) of the stored bf16 first moments."""
    want = _by_path(_find(jstate, "mu").mu)
    off = total = 0
    for path, mu in state["mu"].items():
        assert mu.dtype == torch.bfloat16
        ref = want[path]
        assert ref.dtype == ml_dtypes.bfloat16
        off += int((mu.float().numpy() != ref.astype(np.float32)).sum())
        total += mu.numel()
    return off, total


@pytest.mark.parametrize("kw,clip_bites", [
    (dict(stage=1, max_grad_norm=1e4), False),
    (dict(stage=3, max_grad_norm=1e4, gradient_accumulation_steps=2,
          weight_decay=0.1, warmup_steps=2), False),
    (dict(stage=3, max_grad_norm=0.5, gradient_accumulation_steps=2), True),
], ids=["stage1", "accum2-wd-warmup", "accum2-clip"])
def test_bf16_adam_mu_matches_optax(kw, clip_bites):
    flat, state, want, jstate, _ = _run_both(dict(adam_mu_dtype="bfloat16",
                                                  **kw))
    off, total = _mu_bits(state, jstate)
    if clip_bites:
        assert off <= total // 10_000
    else:
        assert off == 0
    _params_close(flat, want)
    assert state["nu"]["model/language_model/square"].dtype == torch.float32


# --------------------------------------------------------- the Trainer

@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jax.jit(lambda key: jreward.init_reward_params(key, cfg))(
        jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_value_and_grad(setup):
    """The JAX stage-3 loss's value and gradient, jitted once for every
    optimizer case (the first half of JAX's ``make_train_step``)."""
    cfg, _ = setup
    tc = jtrainer.TrainConfig(stage=3, attn_impl="xla", remat=False)
    return jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(cfg, tc)))


@pytest.mark.parametrize("opt", [
    dict(optimizer="adamw"), dict(adam_mu_dtype="bfloat16"),
    dict(optimizer="adafactor", weight_decay=0.1),
], ids=["adamw", "bf16-mu", "adafactor"])
def test_trainer_matches_jax_step(setup, jax_value_and_grad, tmp_path, opt):
    """Two stage-3 micro-steps of the port's ``Trainer`` against JAX's
    step, its loss gradient and its ``make_optimizer`` jitted apart (one
    compile of the gradient serves the three optimizers): the logged
    losses and grad norms, then the params."""
    cfg, params = setup
    batches = [make_batch(cfg, B=1, frames=1, seed=80 + i) for i in range(2)]
    common = dict(stage=3, learning_rate=LR, total_steps=4, **opt)
    jopt = jtrainer.make_optimizer(jtrainer.TrainConfig(**common), params)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    update = jax.jit(jopt.update)
    want, small = [], None
    for batch in batches:
        loss, grads = jax_value_and_grad(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append((float(loss), float(optax.global_norm(grads))))
        tiny = {p: np.abs(g) < 1e-6 for p, g in _by_path(grads).items()}
        small = tiny if small is None else {
            p: small[p] | t for p, t in tiny.items()}
        upd, jstate = update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    tt = ttrainer.Trainer(cfg, from_jax_params(params, device="cpu"),
                          ttrainer.TrainConfig(
                              checkpoint_dir=str(tmp_path), log_every=1,
                              checkpoint_every=10**9, remat=False, **common))
    tt.train(iter(batches))
    got = [(r["loss"], r["grad_norm"])
           for r in _lines(tmp_path / "metrics.jsonl")]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    want_p = ttrainer.flatten_state(from_jax_params(
        jax.tree.map(np.asarray, jp), device="cpu"))
    for path, t in ttrainer.flatten_state(tt.params).items():
        got, ref = t.detach().numpy(), want_p[path].numpy()
        off = np.abs(got - ref) > 5e-6
        if off.any():  # only where a gradient came near Adam's eps
            assert small[path][off].all(), path
            assert np.abs(got - ref).max() <= 2 * LR * len(batches), path


def _trainer(cfg, params, d, **kw):
    tc = ttrainer.TrainConfig(stage=3, learning_rate=LR, total_steps=4,
                              checkpoint_dir=str(d), **kw)
    return ttrainer.Trainer(cfg, from_jax_params(params, device="cpu"), tc)


def test_tensorboard_holds_the_jsonl_scalars(setup, tmp_path, monkeypatch):
    import sys

    # TensorBoard imports TensorFlow where it finds one (about 20 s); its
    # own stub writes the same event files.
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    cfg, params = setup
    batches = [make_batch(cfg, B=1, frames=1, seed=90 + i) for i in range(3)]
    tr = _trainer(cfg, params, tmp_path, log_every=1, tensorboard=True,
                  checkpoint_every=10**9)
    tr.train(iter(batches))
    tr.log({"step": tr.step, "eval": {"preference": 0.5}, "epoch": 0})
    logged = _lines(tmp_path / "metrics.jsonl")
    want = {}
    for rec in logged:
        for k, v in rec.items():
            if isinstance(v, (int, float)) and k != "step":
                want.setdefault(k, []).append((rec["step"], float(v)))
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == set(want) == {
        "loss", "grad_norm", "stage", "elapsed_s", "epoch"}
    for tag, rows in want.items():
        got = [(e.step, e.value) for e in acc.Scalars(tag)]
        assert [s for s, _ in got] == [s for s, _ in rows], tag
        np.testing.assert_array_equal(
            np.float32([v for _, v in got]), np.float32([v for _, v in rows]))


def test_tensorboard_missing_keeps_jsonl(setup, tmp_path, monkeypatch,
                                         capsys):
    """Without the writer the trainer says so in one line and logs JSONL."""
    import sys

    cfg, params = setup
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tr = _trainer(cfg, params, tmp_path, log_every=1, tensorboard=True,
                  checkpoint_every=10**9)
    assert "tensorboard logging is off" in capsys.readouterr().out
    tr.train(iter([make_batch(cfg, B=1, frames=1, seed=1)]))
    assert len(_lines(tmp_path / "metrics.jsonl")) == 1
    assert not (tmp_path / "tb").exists()


def _load(path):
    return torch.load(path, map_location="cpu")


def _assert_same(a, b, where=""):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, where
        assert torch.equal(a, b.to(a.device)), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    else:
        assert a == b, where


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_async_checkpoints_equal_blocking_ones(setup, tmp_path, monkeypatch,
                                               opt):
    """``async_checkpoint`` with a save every step and two kept: after
    ``train()`` returns, each file reloads equal to a blocking save of the
    same state, though each write is slowed so that the next step updates
    the live tensors in place while it runs; the rotation never removes a
    file while a save is pending; resume from it is exact."""
    import time

    cfg, params = setup
    batches = [make_batch(cfg, B=1, frames=1, seed=60 + i) for i in range(4)]
    kw = dict(checkpoint_every=1, keep_checkpoints=2, optimizer=opt,
              gradient_accumulation_steps=2)
    blocking = _trainer(cfg, params, tmp_path / "block", **kw)
    blocking.train(iter(batches))

    real_write, real_remove = tckpt._write, os.remove
    removed = []

    def slow_write(state, path):
        time.sleep(0.2)
        real_write(state, path)

    def pending():
        return tckpt._PENDING is not None and tckpt._PENDING.is_alive()

    def remove(path):
        assert not pending(), path
        removed.append(os.path.basename(path))
        real_remove(path)

    monkeypatch.setattr(tckpt, "_write", slow_write)
    monkeypatch.setattr(os, "remove", remove)
    tr = _trainer(cfg, params, tmp_path / "async", async_checkpoint=True,
                  **kw)
    tr.train(iter(batches))
    assert not pending()
    assert removed == ["stage3_step1.pt", "stage3_step2.pt"]
    names = sorted(os.listdir(tmp_path / "async"))
    assert [n for n in names if n.endswith(".pt")] == [
        "stage3_step3.pt", "stage3_step4.pt"]
    assert not any(".tmp" in n for n in names)
    for step in (3, 4):
        name = f"stage3_step{step}.pt"
        _assert_same(_load(tmp_path / "block" / name),
                     _load(tmp_path / "async" / name), name)
    again = _trainer(cfg, params, tmp_path / "async", async_checkpoint=True,
                     **kw)
    assert again.resume_latest().endswith("stage3_step4.pt")
    for p, t in ttrainer.flatten_state(again.params).items():
        assert torch.equal(t, ttrainer.flatten_state(blocking.params)[p]), p


def test_host_snapshot_is_a_copy():
    state = {"a": torch.ones(3), "n": 2, "b": {"c": torch.zeros(2)}}
    snap = tckpt.host_snapshot(state)
    state["a"].add_(1.0)
    state["b"]["c"].sub_(1.0)
    assert torch.equal(snap["a"], torch.ones(3)) and snap["n"] == 2
    assert torch.equal(snap["b"]["c"], torch.zeros(2))
