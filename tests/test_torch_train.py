"""The port's training (``mjvideo_tpu_torch.train``) against the JAX package.

``tiny_test_config`` in fp32 on the CPU; batches have the dict layout of
``PairCollator`` (the one ``tests/test_train_eval.py`` builds), made from
numpy seeds; JAX parameters cross through ``from_jax_params``.  JAX runs
with ``attn_impl="xla"`` (exact softmax, autograd), the port with its
default ``"auto"`` (on the CPU: K2's twin forward with the lse and the
K4a/K4b twin backward inside the autograd Function).  Tolerances, each
with its reason:

* losses: rtol 1e-6, the same fp32 formulas;
* learning rates: rtol 1e-6, optax computes in fp32, the port in fp64;
* optimizer updates on fixed gradients: atol 1e-7, rtol 1e-6, the same
  fp32 operations in the same order;
* the train step (loss, grad_norm, gradients): rtol 1e-4 and atol 1e-6 on
  gradients, the same fp32 model summed in other orders through 2 layers
  (the JAX package's own remat bar, ``test_train_eval.py:402``);
* the params after the step: atol 2e-6 = lr * 2e-3, except where the JAX
  gradient is below 1e-6: Adam's first update is lr * g / (|g| + eps), so
  an element whose gradient is within the gradient tolerance of eps = 1e-8
  may move by up to 2 lr (measured: 1 of 16,384 elements of one kernel,
  8.3e-6 off).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.train import losses as jlosses
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch.models.reward import RewardOutput
from mjvideo_tpu_torch.train import losses as tlosses
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
LR = 1e-3


def make_batch(cfg, B=2, frames=2, seed=0):
    """The ``PairCollator`` layout at small size (numpy)."""
    rng = np.random.default_rng(seed)
    c = cfg.chat
    n_img = c.num_image_token * frames
    T = n_img + 16
    batch = {}
    for v in (0, 1):
        ids = np.full((B, T), 5, np.int32)
        ids[:, 2:2 + n_img] = c.img_context_token_id
        batch[f"video_{v}_pixel_values"] = rng.normal(
            size=(B, frames, c.vision.image_size, c.vision.image_size, 3)
        ).astype(np.float32)
        batch[f"video_{v}_input_ids"] = ids
        mask = np.ones((B, T), np.int32)
        mask[-1, T - 3:] = 0  # a ragged row: its tail is padding
        ids[-1, T - 3:] = c.llm.pad_token_id
        batch[f"video_{v}_attention_mask"] = mask
        batch[f"video_{v}_gating_pos"] = np.full((B,), T - 6, np.int32)
        batch[f"video_{v}_criteria_score"] = rng.choice(
            [-1.0, 0.0, 1.0], size=(B, 28)).astype(np.float32)
        batch[f"video_{v}_criteria_related"] = rng.integers(
            0, 2, size=(B, 28)).astype(np.float32)
        batch[f"video_{v}_aspect_score"] = rng.choice(
            [-1.0, 0.0, 1.0], size=(B, 5)).astype(np.float32)
        batch[f"video_{v}_aspect_related"] = rng.integers(
            0, 2, size=(B, 5)).astype(np.float32)
        batch[f"video_{v}_overall_score"] = rng.choice(
            [-1.0, 1.0], size=(B, 1)).astype(np.float32)
        batch[f"video_{v}_overall_related"] = np.ones((B, 1), np.float32)
    batch["aspect_preference"] = rng.integers(0, 2, (B, 5)).astype(np.int32)
    batch["aspect_mask"] = rng.integers(0, 2, (B, 5)).astype(np.float32)
    batch["overall_preference"] = rng.integers(0, 2, (B, 1)).astype(np.int32)
    batch["overall_mask"] = np.ones((B, 1), np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jax.jit(lambda key: jreward.init_reward_params(key, cfg))(
        jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


def fresh(params_np):
    return from_jax_params(params_np, device="cpu")


# ------------------------------------------------------------------ losses

def _random_outputs(rng, B=3):
    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def probs(*shape):
        return rng.uniform(0.05, 0.95, size=shape).astype(np.float32)

    fields = dict(rewards=arr(B, 28), hidden_state=arr(B, 4),
                  prompt_embedding=arr(B, 4),
                  criteria_gating_output=arr(B, 28),
                  aspect_gating_output=probs(B, 5),
                  aspect_weights=probs(B, 28), aspect_scores=arr(B, 5),
                  score=arr(B))
    return fields


LOSSES = ["criteria_loss", "aspect_score_loss", "stage1_loss",
          "stage2_loss", "stage3_loss"]


@pytest.mark.parametrize("mse", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(name, mse):
    rng = np.random.default_rng(LOSSES.index(name) + 10 * mse)
    tiny = tiny_test_config()
    batch = make_batch(tiny, B=3, frames=1, seed=3)
    o0, o1 = _random_outputs(rng), _random_outputs(rng)
    j0 = jreward.RewardOutput(**{k: jnp.asarray(v) for k, v in o0.items()})
    j1 = jreward.RewardOutput(**{k: jnp.asarray(v) for k, v in o1.items()})
    t0 = RewardOutput(**{k: torch.from_numpy(v) for k, v in o0.items()})
    t1 = RewardOutput(**{k: torch.from_numpy(v) for k, v in o1.items()})
    want = getattr(jlosses, name)(j0, j1, batch, mse=mse)
    got = getattr(tlosses, name)(t0, t1, to_torch(batch), mse=mse)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_pairwise_and_sparsity_terms_match_jax():
    rng = np.random.default_rng(7)
    s0, s1 = rng.normal(size=(4, 5)), rng.normal(size=(4, 5))
    pref = rng.integers(0, 2, (4, 5))
    mask = rng.integers(0, 2, (4, 5)).astype(np.float32)
    g0, g1 = rng.uniform(0, 0.9, (2, 4, 5))
    r0, r1 = rng.integers(0, 2, (2, 4, 5)).astype(np.float32)
    T = torch.from_numpy
    for mean in (True, False):
        np.testing.assert_allclose(
            tlosses.bradley_terry_loss(T(s0), T(s1), T(pref), T(mask), 0.7,
                                       mean_over_mask=mean).item(),
            float(jlosses.bradley_terry_loss(s0, s1, pref, mask, 0.7,
                                             mean_over_mask=mean)),
            rtol=1e-6)
    np.testing.assert_allclose(
        tlosses.gating_sparsity_loss(T(g0), T(g1), T(r0), T(r1), 4).item(),
        float(jlosses.gating_sparsity_loss(g0, g1, r0, r1, 4)), rtol=1e-6)
    # An all-zero mask is 0, not NaN, for the mean-normalised terms.
    zero = tlosses.bradley_terry_loss(T(s0), T(s1), T(pref), T(mask * 0))
    assert zero.item() == 0.0
    assert tlosses.STAGES.keys() == jlosses.STAGES.keys()
    for k, spec in tlosses.STAGES.items():
        assert spec.trainable_paths == jlosses.STAGES[k].trainable_paths


# -------------------------------------------------------------- schedules

@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
def test_learning_rate_matches_optax_schedules(schedule, warmup):
    tc = ttrainer.TrainConfig(learning_rate=2e-3, total_steps=10,
                              warmup_steps=warmup, schedule=schedule)
    decay = max(tc.total_steps - warmup, 1)
    if schedule == "linear":
        main = optax.linear_schedule(tc.learning_rate, 0.0, decay)
    elif schedule == "cosine":
        main = optax.cosine_decay_schedule(tc.learning_rate, decay)
    else:
        main = lambda count: tc.learning_rate  # noqa: E731
    ref = main
    if warmup:
        ref = optax.join_schedules(
            [optax.linear_schedule(0.0, tc.learning_rate, warmup), main],
            [warmup])
    lr = ttrainer.make_schedule(tc)
    for count in range(14):
        np.testing.assert_allclose(lr(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-12)
    assert lr(0) == (0.0 if warmup else tc.learning_rate)


def _optimizer_tree(rng):
    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"regression_layer": {"kernel": arr(4, 3)},
            "criteria_gating": {"layer_0": {"kernel": arr(3, 2)}},
            "aspect_gating": {"layer_0": {"kernel": arr(3, 2)}},
            "model": {"vision_model": {"w": arr(5)},
                      "language_model": {"tok_embeddings": arr(6, 4),
                                         "norm": {"weight": arr(4)}}}}


@pytest.mark.parametrize("kw", [
    dict(stage=1),
    dict(stage=2, weight_decay=0.1, schedule="cosine", warmup_steps=2),
    dict(stage=3, gradient_accumulation_steps=2, max_grad_norm=0.5),
    dict(stage=3, gradient_accumulation_steps=3, schedule="constant",
         weight_decay=0.05, max_grad_norm=100.0),
], ids=["stage1", "wd-cosine-warmup", "accum2-clip", "accum3-constant"])
def test_optimizer_matches_optax_on_fixed_gradients(kw):
    """Clipping, AdamW, the schedule and MultiSteps against the JAX
    package's ``make_optimizer`` for 7 micro-steps of fixed gradients."""
    rng = np.random.default_rng(1)
    params = _optimizer_tree(rng)
    tc_j = jtrainer.TrainConfig(learning_rate=LR, total_steps=6, **kw)
    tc_t = ttrainer.TrainConfig(learning_rate=LR, total_steps=6, **kw)
    jopt = jtrainer.make_optimizer(tc_j, params)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = from_jax_params(params, device="cpu")
    topt = ttrainer.make_optimizer(tc_t, tp)
    tstate = topt.init(tp)
    flat = ttrainer.flatten_state(tp)
    for _ in range(7):
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * 0.4).astype(np.float32),
            params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                  jp)
        jp = optax.apply_updates(jp, upd)
        tgrads = ttrainer.flatten_state(from_jax_params(grads, device="cpu"))
        tstate = topt.update({p: tgrads[p] for p in topt.paths}, tstate, tp)
        want = ttrainer.flatten_state(from_jax_params(
            jax.tree.map(np.asarray, jp), device="cpu"))
        for path, t in flat.items():
            np.testing.assert_allclose(t.numpy(), want[path].numpy(),
                                       atol=1e-7, rtol=1e-6, err_msg=path)


def test_unported_options_raise_with_their_roadmap_item(setup, tmp_path):
    cfg, params = setup
    # ZeRO-1 and the mesh axes train (tests/test_torch_zero1.py); under a
    # model axis above 1, LoRA and the w8a8 modes still raise, and the
    # QK-norm ViT splits (tests/test_torch_mesh_judges.py).
    import dataclasses

    from mjvideo_tpu_torch import configs as tconfigs
    from mjvideo_tpu_torch.models.reward import init_reward_params
    from mjvideo_tpu_torch.ops.quant import quantize_params_mode
    from mjvideo_tpu_torch.parallel.mesh import Mesh, shard_params

    tcfg, mesh = tconfigs.tiny_test_config(), Mesh.local(1, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        ttrainer.Trainer(tcfg, fresh(params), ttrainer.TrainConfig(
            lora_rank=2, checkpoint_dir=str(tmp_path)), mesh=mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        shard_params(quantize_params_mode(fresh(params), "int8",
                                          min_elements=1024), mesh, cfg=tcfg)
    qk = dataclasses.replace(tcfg, chat=dataclasses.replace(
        tcfg.chat, vision=dataclasses.replace(
            tcfg.chat.vision, qk_normalization=True, norm_type="rms_norm")))
    state = init_reward_params(qk, generator=torch.Generator().manual_seed(0),
                               device=torch.device("cpu"),
                               dtype=torch.float32)
    shards = shard_params(state, mesh, cfg=qk)
    C = qk.chat.vision.hidden_size
    assert shards[0]["model"]["vision_model"]["layers"]["attn"]["qkv"][
        "kernel"].shape[-1] == 3 * C // 2
    # Adafactor, bf16 mu, async checkpoints, TensorBoard and remat="dots"
    # are ported (tests/test_torch_train_options.py), LoRA too
    # (tests/test_torch_lora.py); a misspelt value raises.
    for kw in (dict(optimizer="adam"), dict(adam_mu_dtype="float16")):
        with pytest.raises(ValueError, match="unknown"):
            ttrainer.make_optimizer(ttrainer.TrainConfig(**kw), params)
    # Sequence-parallel training is ported (tests/test_torch_sequence.py):
    # it needs the group its shards live in, as JAX needs the mesh.
    with pytest.raises(ValueError, match="unknown sp kind"):
        ttrainer.make_optimizer(ttrainer.TrainConfig(sp="tree"), params)
    with pytest.raises(ValueError, match="sp_group"):
        ttrainer.make_loss_fn(cfg, ttrainer.TrainConfig(sp="ring"))
    from mjvideo_tpu_torch.ops.remat import remat_wrap

    with pytest.raises(ValueError, match="unknown remat policy"):
        remat_wrap(lambda x: x, "matmuls")


# ------------------------------------------------------ freeze and the step

@pytest.mark.parametrize("stage", [1, 2, 3])
def test_trainable_set_matches_jax_mask(setup, stage):
    _, params = setup
    mask = jtrainer.trainable_mask(params, stage)
    want = {jtrainer._path_str(path) for path, on in
            jax.tree_util.tree_leaves_with_path(mask) if on}
    got = ttrainer.trainable_mask(fresh(params), stage)
    assert got == want
    assert not any(p.startswith(("model/vision_model", "model/mlp1"))
                   for p in got)


@pytest.mark.parametrize("stage", [1, 3])
def test_train_step_matches_jax(setup, stage):
    """One step: loss, grad_norm, gradients leaf by leaf and the updated
    params against the JAX step; frozen leaves bit-identical."""
    cfg, params = setup
    batch = make_batch(cfg, seed=stage)
    kw = dict(stage=stage, learning_rate=LR, total_steps=4)
    tc_j = jtrainer.TrainConfig(attn_impl="xla", **kw)
    tc_t = ttrainer.TrainConfig(**kw)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.jit(jax.grad(jtrainer.make_loss_fn(cfg, tc_j)))(
        jax.tree.map(jnp.asarray, params), jbatch)
    jopt = jtrainer.make_optimizer(tc_j, params)
    jp = jax.tree.map(jnp.asarray, params)
    jp1, _, jm = jtrainer.make_train_step(cfg, tc_j, jopt)(
        jp, jopt.init(jp), jbatch)

    tp = fresh(params)
    topt = ttrainer.make_optimizer(tc_t, tp)
    tbatch = to_torch(batch)
    ttrainer.set_trainable(tp, set(topt.paths))
    flat = ttrainer.flatten_state(tp)
    loss = ttrainer.make_loss_fn(cfg, tc_t)(tp, tbatch)
    tgrads = dict(zip(topt.paths, torch.autograd.grad(
        loss, [flat[p] for p in topt.paths])))
    want_g = ttrainer.flatten_state(from_jax_params(
        jax.tree.map(np.asarray, jgrads), device="cpu"))
    for path, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), want_g[path].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=path)

    tp1, _, tm = ttrainer.make_train_step(cfg, tc_t, topt)(
        tp, topt.init(tp), tbatch)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-4)
    want_p = ttrainer.flatten_state(from_jax_params(
        jax.tree.map(np.asarray, jp1), device="cpu"))
    before = ttrainer.flatten_state(fresh(params))
    moved = False
    for path, t in ttrainer.flatten_state(tp1).items():
        got = t.detach().numpy()
        off = np.abs(got - want_p[path].numpy()) > 2e-6
        if off.any():  # only where the gradient is near Adam's eps
            assert np.abs(want_g[path].numpy()[off]).max() < 1e-6, path
            assert np.abs(got - want_p[path].numpy()).max() <= 2 * LR, path
        if path in topt.paths:
            moved = moved or not np.array_equal(got, before[path].numpy())
        else:
            np.testing.assert_array_equal(got, before[path].numpy())
    assert moved


def test_accumulating_two_batches_matches_one_concatenated_batch(setup):
    """k = 2 micro-steps == one step on the concatenated batch (Adam makes
    the update invariant to the loss scale), and nothing moves before the
    window closes (``tests/test_losses.py:193`` for JAX)."""
    cfg, params = setup
    b1, b2 = make_batch(cfg, seed=0), make_batch(cfg, seed=1)
    full = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
    kw = dict(stage=1, learning_rate=LR, total_steps=4, schedule="none",
              remat=False)
    tc_f = ttrainer.TrainConfig(**kw)
    p_full = fresh(params)
    opt_f = ttrainer.make_optimizer(tc_f, p_full)
    ttrainer.make_train_step(cfg, tc_f, opt_f)(p_full, opt_f.init(p_full),
                                               to_torch(full))

    tc_a = ttrainer.TrainConfig(gradient_accumulation_steps=2, **kw)
    p_acc = fresh(params)
    opt_a = ttrainer.make_optimizer(tc_a, p_acc)
    step = ttrainer.make_train_step(cfg, tc_a, opt_a)
    p_acc, st, _ = step(p_acc, opt_a.init(p_acc), to_torch(b1))
    before = ttrainer.flatten_state(fresh(params))
    for path, t in ttrainer.flatten_state(p_acc).items():
        assert torch.equal(t.detach(), before[path]), path
    assert st["mini_step"] == 1
    p_acc, st, _ = step(p_acc, st, to_torch(b2))
    assert st["mini_step"] == 0 and st["gradient_step"] == 1
    ref = ttrainer.flatten_state(p_full)
    for path, t in ttrainer.flatten_state(p_acc).items():
        rel = ((t - ref[path]).norm() / (ref[path].norm() + 1e-12)).item()
        assert rel < 5e-5, (path, rel)


def test_remat_on_and_off_give_the_same_gradients(setup):
    cfg, params = setup
    batch = to_torch(make_batch(cfg, B=1, frames=1, seed=4))
    grads = []
    for remat in (True, False):
        tc = ttrainer.TrainConfig(stage=3, remat=remat)
        tp = fresh(params)
        paths = sorted(ttrainer.trainable_mask(tp, 3))
        ttrainer.set_trainable(tp, set(paths))
        flat = ttrainer.flatten_state(tp)
        loss = ttrainer.make_loss_fn(cfg, tc)(tp, batch)
        grads.append(torch.autograd.grad(loss, [flat[p] for p in paths]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_save_and_resume_give_a_bit_identical_next_step(setup, tmp_path):
    """train(3 micro-steps) + save + resume + train(1) == train(4), with the
    checkpoint in the middle of an accumulation window."""
    cfg, params = setup
    batches = [make_batch(cfg, B=1, frames=1, seed=50 + i) for i in range(4)]

    def make(name):
        tc = ttrainer.TrainConfig(stage=3, learning_rate=LR, total_steps=4,
                                  gradient_accumulation_steps=2, log_every=1,
                                  checkpoint_every=10**9,
                                  checkpoint_dir=str(tmp_path / name))
        return ttrainer.Trainer(cfg, fresh(params), tc)

    tr_a = make("a")
    tr_a.train(iter(batches))
    tr_b = make("b")
    tr_b.train(iter(batches[:3]))
    assert tr_b.opt_state["mini_step"] == 1
    path = tr_b.save()
    assert os.path.basename(path) == "stage3_step3.pt"
    tr_c = make("b")
    assert tr_c.resume_latest() == path and tr_c.step == 3
    tr_c.train(iter(batches[3:]))
    assert tr_c.step == 4
    a = ttrainer.flatten_state(tr_a.params)
    for p, t in ttrainer.flatten_state(tr_c.params).items():
        assert torch.equal(t, a[p]), p
    logged = (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()
    assert len(logged) == 4 and '"grad_norm"' in logged[0]
    warm = ttrainer.flatten_state(ttrainer.warm_start(fresh(params), path))
    for p, t in ttrainer.flatten_state(tr_b.params).items():
        assert torch.equal(warm[p], t), p


def test_training_modules_import_no_jax():
    code = """
import sys
import mjvideo_tpu_torch.train as tr
from mjvideo_tpu_torch.ops import remat
assert tr.Trainer and remat.remat_wrap
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
