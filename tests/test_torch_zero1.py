"""Training on a (data, model) mesh and ZeRO-1 (``train/trainer.py``'s
``Optimizer``) against the JAX package's unsharded training step.

``tiny_test_config`` in fp32 on the CPU, stage 3, batches of 2 pairs (the
data axis of 2 divides them), accumulation 2, three micro-steps: one
optimizer step and one more accumulation.  JAX's step is its
``Trainer``'s step body, the jitted ``value_and_grad`` of ``make_loss_fn``
and ``make_optimizer``'s update jitted apart (one compile of the loss's
gradient a module, where the ``Trainer`` compiles the whole step per
optimizer).  Tolerances, each with its reason:

* the params after the steps: atol 2e-6 against JAX (the unsharded port's
  bar, ``test_torch_train.py``), an element off that by at most 2 lr where
  Adam's first update divides a gradient near eps (``lr * g / (|g| +
  eps)``), on under 1% of a leaf's elements;
* ZeRO-1 against the replicated run on the same mesh, a save and resume,
  and a resume into another mesh's or an unsharded ``Trainer``:
  ``torch.equal`` (the update is elementwise; the norm's cells are the
  same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config as jax_tiny
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch.configs import tiny_test_config
from mjvideo_tpu_torch.parallel.mesh import Mesh
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils.bridge import flatten_state, from_jax_params

from test_torch_train import make_batch

torch.set_num_threads(1)
LR = 1e-3
STEPS = 3


@pytest.fixture(scope="module")
def setup():
    cfg = jax_tiny()
    params = jax.jit(lambda key: jreward.init_reward_params(key, cfg))(
        jax.random.PRNGKey(0))
    batches = [make_batch(cfg, B=2, seed=s) for s in range(STEPS + 1)]
    return cfg, jax.tree.map(np.asarray, params), batches


@pytest.fixture(scope="module")
def jax_loss_grad(setup):
    """JAX's stage-3 loss and its gradient, jitted once for the module."""
    cfg = setup[0]
    tc = _tc(jtrainer, "unused", attn_impl="xla")
    return jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(cfg, tc)))


def _jax_steps(loss_grad, params, batches, **kw):
    """JAX's unsharded steps (``trainer.py`` ``make_train_step``'s body):
    the gradient, then ``make_optimizer``'s update and ``apply_updates``;
    the params after them, as numpy."""
    tc = _tc(jtrainer, "unused", attn_impl="xla", **kw)
    opt = jtrainer.make_optimizer(tc, params)

    @jax.jit
    def update(grads, state, p):
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state

    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    for b in batches:
        _, grads = loss_grad(p, {k: jnp.asarray(v) for k, v in b.items()})
        p, state = update(grads, state, p)
    return jax.tree.map(np.asarray, p)


def _tc(pkg, tmp, **kw):
    base = dict(stage=3, learning_rate=LR, total_steps=4, remat=False,
                gradient_accumulation_steps=2, checkpoint_dir=str(tmp),
                log_every=1)
    return pkg.TrainConfig(**{**base, **kw})


def _run(params, tc, batches, mesh, steps=STEPS):
    tr = ttrainer.Trainer(tiny_test_config(),
                          from_jax_params(params, device="cpu"), tc,
                          mesh=mesh)
    tr.train(batches[:steps])
    return tr


def _equal(a, b):
    fa, fb = flatten_state(a), flatten_state(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if torch.is_tensor(v):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_meshed_training_matches_jax_trainer(setup, jax_loss_grad, tmp_path,
                                             optimizer):
    """Three micro-steps at ``local(2, 2)`` without and with ZeRO-1
    against JAX's unsharded step; ZeRO-1 bit-equal to the replicated run,
    each data rank keeping half the optimizer state."""
    cfg, params, batches = setup
    want = flatten_state(from_jax_params(_jax_steps(
        jax_loss_grad, params, batches[:STEPS], optimizer=optimizer),
        device="cpu"))
    mesh = Mesh.local(2, 2)
    runs = {z: _run(params, _tc(ttrainer, tmp_path / f"z{z}",
                                optimizer=optimizer, zero1=z), batches, mesh)
            for z in (False, True)}
    before = flatten_state(from_jax_params(params, device="cpu"))
    got = flatten_state(runs[False].whole_params())
    moved = 0
    for path, t in got.items():
        err = np.abs(t.detach().numpy() - want[path].numpy())
        off = err > 2e-6
        if off.any():
            assert err.max() <= 2 * LR, path
            assert off.mean() < 0.01, (path, off.mean())
        moved += not torch.equal(t, before[path])
    assert moved > 0
    _equal(runs[True].whole_params(), runs[False].whole_params())
    _equal(runs[True].whole_opt_state(), runs[False].whole_opt_state())
    rep = runs[False].optimizer.rank_bytes(runs[False].opt_state)
    zero = runs[True].optimizer.rank_bytes(runs[True].opt_state)
    for rank, n in zero.items():
        assert n < 0.6 * rep[rank], (rank, n, rep[rank])


def test_zero1_resume_is_bit_exact_and_resumes_elsewhere(setup, tmp_path):
    """A ZeRO-1 run at ``local(2, 2)`` saved after 3 micro-steps and
    resumed: the 4th micro-step is bit-equal to the unbroken run's.  The
    file is the unsharded run's layout: an unsharded ``Trainer`` and one
    on ``local(1, 2)`` resume it into the same whole state."""
    cfg, params, batches = setup
    mesh = Mesh.local(2, 2)
    tc = _tc(ttrainer, tmp_path, zero1=True)
    whole = _run(params, tc, batches, mesh)
    path = whole.save()
    whole.train(batches[STEPS:])
    back = _run(params, tc, batches, mesh, steps=0)
    assert back.resume_latest() == path and back.step == STEPS
    back.train(batches[STEPS:])
    _equal(back.whole_params(), whole.whole_params())
    _equal(back.whole_opt_state(), whole.whole_opt_state())

    saved = ttrainer.load_state(path)
    for other in (None, Mesh.local(1, 2)):
        tr = _run(params, _tc(ttrainer, tmp_path, zero1=True), batches,
                  other, steps=0)
        tr.resume_latest()
        _equal(tr.whole_params(), saved["params"])
        _equal(tr.whole_opt_state(), saved["opt_state"])


def test_lora_trains_over_the_data_axis_with_zero1(setup, tmp_path):
    """LoRA at ``local(2, 1)`` with ZeRO-1: the adapters are ordinary
    leaves, sliced over the data axis; two micro-steps within the module's
    bar of the unsharded LoRA ``Trainer``.  Under a model axis above 1 LoRA
    raises, naming ROADMAP item 12."""
    cfg, params, batches = setup
    kw = dict(stage=1, lora_rank=2, gradient_accumulation_steps=1)
    one = _run(params, _tc(ttrainer, tmp_path / "one", **kw), batches, None,
               steps=2)
    dp = _run(params, _tc(ttrainer, tmp_path / "dp", zero1=True, **kw),
              batches, Mesh.local(2, 1), steps=2)
    assert any("#d" in s and s.split("#")[0].endswith("/.b")
               for s in dp.opt_state["mu"])
    got, want = flatten_state(dp.whole_params()), flatten_state(one.params)
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[path].detach().numpy(), atol=2e-6,
                                   err_msg=path)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        _run(params, _tc(ttrainer, tmp_path / "tp", **kw), batches,
             Mesh.local(1, 2), steps=0)


def test_async_save_on_a_mesh_equals_the_blocking_one(setup, tmp_path):
    """Under ``async_checkpoint`` the state is gathered on the calling
    thread and written in the background: the file equals a blocking
    save's."""
    cfg, params, batches = setup
    mesh = Mesh.local(2, 2)
    files = {}
    for mode in (False, True):
        tr = _run(params, _tc(ttrainer, tmp_path / str(mode), zero1=True,
                              async_checkpoint=mode), batches, mesh)
        files[mode] = tr.save()
        ttrainer.wait_for_saves()
    _equal(ttrainer.load_state(files[True]), ttrainer.load_state(files[False]))


def test_factored_adafactor_over_the_model_axis(tmp_path):
    """At width 128 Adafactor factors the decoder's kernels; where the
    model axis splits a factored dim, its row or column mean sums the
    ranks' partial sums.  Three micro-steps at ``local(2, 2)`` with ZeRO-1
    against the unsharded ``Trainer`` (held against JAX in
    ``test_torch_train_options.py``), to the module's atol 2e-6."""
    from mjvideo_tpu_torch.models.reward import init_reward_params

    cfg = tiny_test_config(hidden_size=128)
    batches = [make_batch(cfg, B=2, seed=s) for s in range(STEPS)]
    runs = []
    for mesh in (None, Mesh.local(2, 2)):
        state = init_reward_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.float32)
        tr = ttrainer.Trainer(cfg, state, _tc(
            ttrainer, tmp_path / str(mesh), optimizer="adafactor",
            zero1=mesh is not None), mesh=mesh)
        tr.train(batches)
        runs.append(tr)
    assert any(runs[1].opt_state["v_row"])
    assert any("#m" in k for k in runs[1].opt_state["v_row"])
    got = flatten_state(runs[1].whole_params())
    for path, want in flatten_state(runs[0].params).items():
        np.testing.assert_allclose(got[path].detach().numpy(),
                                   want.detach().numpy(), atol=2e-6,
                                   err_msg=path)
