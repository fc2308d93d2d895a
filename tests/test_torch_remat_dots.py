"""``remat="dots"`` (``mjvideo_tpu_torch/ops/remat.py``) against
``remat=False`` / ``True`` and against the JAX package's ``"dots"``.

``tiny_test_config`` in fp32 on the CPU, the batches of
``tests/test_torch_train.py``.  The gradient is taken over the stage-3
trainable set and the ViT's layer stack, so both the ViT blocks and the
decoder layers are checkpointed.  Tolerances:

* the port's three policies: bit-equal (the recompute runs the same fp32
  operations on the same inputs, the saved products are the first
  forward's);
* against JAX's ``"dots"`` step (``attn_impl="xla"``): loss rtol 1e-4,
  gradients atol 1e-6 and rtol 1e-4, the bar of
  ``test_torch_train.py::test_train_step_matches_jax`` (the same model
  summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils.bridge import from_jax_params
from test_torch_train import make_batch, to_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jax.jit(lambda key: jreward.init_reward_params(key, cfg))(
        jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


class _MatmulCount(TorchDispatchMode):
    """Counts the ``aten.mm`` / ``aten.addmm`` calls that reach the
    dispatcher; a product that the selective checkpoint serves from its
    cache never does."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _value_and_grad(cfg, params, batch, remat):
    """(loss, gradients, mm calls in the forward, mm calls in the
    backward) over the stage-3 trainable set and the ViT's layers."""
    tp = from_jax_params(params, device="cpu")
    flat = ttrainer.flatten_state(tp)
    paths = sorted(ttrainer.trainable_mask(tp, 3) | {
        p for p in flat if p.startswith("model/vision_model/layers/")})
    ttrainer.set_trainable(tp, set(paths))
    loss_fn = ttrainer.make_loss_fn(cfg, ttrainer.TrainConfig(stage=3,
                                                              remat=remat))
    with _MatmulCount() as fwd:
        loss = loss_fn(tp, batch)
    with _MatmulCount() as bwd:
        grads = torch.autograd.grad(loss, [flat[p] for p in paths])
    return loss, dict(zip(paths, grads)), fwd.n, bwd.n


def _block_products(cfg, videos=2):
    """The weight products inside the checkpointed layers: q/k/v (one
    product in the ViT), the projection and two MLP products a ViT block,
    q, k, v, o and three MLP products a decoder layer."""
    c = cfg.chat
    return videos * (4 * c.vision.num_hidden_layers
                     + 7 * c.llm.num_hidden_layers)


def test_dots_gives_the_same_loss_and_gradients(setup):
    cfg, params = setup
    batch = to_torch(make_batch(cfg, B=1, frames=1, seed=4))
    ref_loss, ref, _, _ = _value_and_grad(cfg, params, batch, False)
    for remat in (True, "dots"):
        loss, grads, _, _ = _value_and_grad(cfg, params, batch, remat)
        assert torch.equal(loss, ref_loss), remat
        for p, g in grads.items():
            assert torch.equal(g, ref[p]), (remat, p)


@pytest.mark.parametrize("early_stop", [True, False])
def test_dots_recomputes_no_product_and_full_remat_all(setup, early_stop):
    """Backward mm counts: ``"dots"`` calls as many as no remat (every
    saved product comes from the cache), ``True`` adds the layers' forward
    products.  With the checkpoint's early stop (the default) the
    recompute of a decoder layer ends before its last product (w2), whose
    output no backward reads."""
    cfg, params = setup
    batch = to_torch(make_batch(cfg, B=1, frames=1, seed=4))
    with set_checkpoint_early_stop(early_stop):
        counts = {r: _value_and_grad(cfg, params, batch, r)[2:]
                  for r in (False, True, "dots")}
    fwd = {n for n, _ in counts.values()}
    assert len(fwd) == 1  # the forward runs the same products
    plain = counts[False][1]
    assert counts["dots"][1] == plain
    skipped = 0 if not early_stop else 2 * cfg.chat.llm.num_hidden_layers
    assert counts[True][1] - plain == _block_products(cfg) - skipped


def test_dots_matches_jax_dots(setup):
    """Loss and trainable gradients of a stage-3 step under ``"dots"``
    against ``jax.grad`` of the JAX loss under ``remat="dots"``."""
    cfg, params = setup
    batch = make_batch(cfg, seed=3)
    tc_j = jtrainer.TrainConfig(stage=3, attn_impl="xla", remat="dots")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        jtrainer.make_loss_fn(cfg, tc_j)))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = from_jax_params(params, device="cpu")
    paths = sorted(ttrainer.trainable_mask(tp, 3))
    ttrainer.set_trainable(tp, set(paths))
    flat = ttrainer.flatten_state(tp)
    loss = ttrainer.make_loss_fn(
        cfg, ttrainer.TrainConfig(stage=3, remat="dots"))(tp, to_torch(batch))
    grads = torch.autograd.grad(loss, [flat[p] for p in paths])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = ttrainer.flatten_state(from_jax_params(
        jax.tree.map(np.asarray, jgrads), device="cpu"))
    for p, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), want[p].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=p)


def test_dots_without_autograd_runs_plainly(setup):
    """Under ``torch.no_grad`` a ``"dots"`` layer is the plain layer: no
    checkpoint, the same output."""
    from mjvideo_tpu_torch.ops.remat import remat_wrap

    calls = []

    def block(x):
        calls.append(torch.is_grad_enabled())
        return x @ x.T

    x = torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = remat_wrap(block, "dots")(x)
    assert torch.equal(got, x @ x.T) and calls == [False]
