"""The port's differentiable reward path against the JAX package's.

``RewardScorer.score_fn`` and ``score_fn_with_params`` against JAX's
``jax.grad`` of the same closures at ``tiny_test_config``, fp32 on the CPU,
with the weights bridged by ``from_jax_params``; the w8a8 refusal; three
steps of the port's VADER loop against the same steps built from
``examples/vader_loop.py``'s render and ``optax.adam``; the guard of the
kernels without a backward.  The JAX scorer runs ``attn_impl="xla"`` (the
exact softmax with autodiff); the port runs its kernels' twins (the bound
K1 and K2 forwards with the lse, the K4 nc and K4a/K4b backwards), so the
two agree to fp32 rounding: the score to atol 2e-5 (the bar of
``test_torch_scorer.py``), each gradient to 1e-4 of its largest entry
(forward and backward each sum the same terms in other orders, through 2
ViT and 2 decoder layers, then the pixel gradient through the patch embed).
JAX's side is ``score_fn_with_params``, differentiated once in the
module's fixture for both the weights and the pixels (``score_fn`` is the
same closure with the weights bound).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data.prompts import (ByteTokenizer, build_video_question,
                                      prepare_chat_input)
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models.reward import init_reward_params as jax_init
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.examples import vader_loop
from mjvideo_tpu_torch.ops.quant import quantize_params_mode
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
BUCKET = 256
FRAMES = 2
CAPTION = "a bright colorful scene"
GRAD_REL_TOL = 1e-4
# The leaves whose gradient ``score_fn_with_params`` is held on: the ViT's
# qkv, the projector's first kernel, the decoder's q/k/v kernels and the
# regression head.
LEAVES = (
    ("model", "vision_model", "layers", "attn", "qkv", "kernel"),
    ("model", "mlp1", "fc1", "kernel"),
    ("model", "language_model", "layers", "attention", "wq", "kernel"),
    ("model", "language_model", "layers", "attention", "wk", "kernel"),
    ("model", "language_model", "layers", "attention", "wv", "kernel"),
    ("regression_layer", "kernel"),
)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_REL_TOL * np.abs(want).max(),
                               err_msg=name)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init(key, cfg))(jax.random.PRNGKey(2)))
    tok = ByteTokenizer()
    common = dict(length_buckets=(BUCKET,), gating_pattern=tok.gating_pattern())
    jax_scorer = JaxRewardScorer(cfg, params, tok, attn_impl="xla",
                                 dtype=jnp.float32, **common)
    port = RewardScorer(cfg, from_jax_params(params, device="cpu"), tok,
                        dtype=torch.float32, **common)
    chat = prepare_chat_input(jax_scorer.cfg.chat, tok,
                              build_video_question(CAPTION, FRAMES),
                              num_patches_list=[1] * FRAMES,
                              gating_pattern=tok.gating_pattern())
    size = cfg.chat.image_size
    pix = np.random.default_rng(0).normal(
        size=(FRAMES, size, size, 3)).astype(np.float32)
    # JAX's score and its gradients to the weights and the pixels, in one
    # compile: ``score_fn_with_params`` is ``score_fn`` with the weights as
    # an argument.
    f = jax_scorer.score_fn_with_params(chat.input_ids[0], chat.gating_pos)
    score, (g_params, g_pix) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pix))
    return dict(cfg=cfg, params=params, tok=tok, jax=jax_scorer, port=port,
                ids=chat.input_ids[0], gpos=chat.gating_pos, pix=pix,
                score=float(score), g_params=g_params, g_pix=np.asarray(g_pix))


def test_score_fn_pixel_gradient_matches_jax(setup):
    """The score and its gradient to the pixels; the score also equals
    ``score_batch``'s, and the ViT ran K1 with the lse and K4 nc's twins
    (no launch: the CPU has no kernel)."""
    s = setup
    want, want_g = s["score"], s["g_pix"]
    pix = torch.from_numpy(s["pix"]).requires_grad_()
    before = dict(kernels.launch_counts)
    score = s["port"].score_fn(s["ids"], s["gpos"])(pix)
    (grad,) = torch.autograd.grad(score, pix)
    assert kernels.launch_counts == before
    assert score.dim() == 0
    np.testing.assert_allclose(score.item(), float(want), atol=2e-5)
    batch = s["port"].score_batch(s["pix"], [s["ids"]], [s["gpos"]]).score
    np.testing.assert_allclose(score.item(), batch[0].item(), atol=2e-5)
    assert np.abs(np.asarray(want_g)).max() > 0
    _close(grad.numpy(), want_g, "pixel gradient")


def test_score_fn_with_params_leaf_gradients_match_jax(setup):
    """The gradients of a few weights (ViT qkv, ``mlp1``, decoder wq/wk/wv,
    ``regression_layer``), each stacked over its layers, and the pixels'."""
    s = setup
    want_p, want_x = s["g_params"], s["g_pix"]
    state = from_jax_params(s["params"], device="cpu")
    leaves = [_get(state, p).requires_grad_() for p in LEAVES]
    pix = torch.from_numpy(s["pix"]).requires_grad_()
    score = s["port"].score_fn_with_params(s["ids"], s["gpos"])(state, pix)
    grads = torch.autograd.grad(score, leaves + [pix])
    for path, g in zip(LEAVES, grads):
        want = np.asarray(_get(want_p, path))
        assert np.abs(want).max() > 0, path
        _close(g.numpy(), want, "/".join(path))
    _close(grads[-1].numpy(), want_x, "pixel gradient")


def test_score_fn_refuses_w8a8_and_accepts_weight_only(setup):
    """w8a8 (``quant="int8"``, or a state holding a ``QuantKernel``) is
    refused with the JAX package's message: its activation quantization
    has zero gradient.  The weight-only modes give a finite, nonzero pixel
    gradient."""
    s = setup
    state = from_jax_params(s["params"], device="cpu")
    common = dict(dtype=torch.float32, length_buckets=(BUCKET,),
                  gating_pattern=s["tok"].gating_pattern())
    refused = (RewardScorer(s["cfg"], state, s["tok"], quant="int8", **common),
               RewardScorer(s["cfg"], quantize_params_mode(
                   state, "int8-noattn", min_elements=1024), s["tok"],
                   **common))
    for scorer in refused:
        for fn in (scorer.score_fn, scorer.score_fn_with_params):
            with pytest.raises(ValueError, match="w8a8"):
                fn(s["ids"], s["gpos"])
    for mode in ("int8-wo", "int4-wo"):
        scorer = RewardScorer(s["cfg"], quantize_params_mode(
            state, mode, min_elements=1024), s["tok"], **common)
        assert RewardScorer(s["cfg"], state, s["tok"], quant=mode, **common)
        pix = torch.from_numpy(s["pix"]).requires_grad_()
        score = scorer.score_fn(s["ids"], s["gpos"])(pix)
        (grad,) = torch.autograd.grad(score, pix)
        assert torch.isfinite(grad).all() and grad.abs().max() > 0, mode


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_vader_loop", REPO / "examples" / "vader_loop.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vader_loop_matches_jax_steps(setup):
    """Three Adam steps of the port's loop (``render``, ``reward_fn``,
    ``make_step``) against the same steps built from the JAX example's
    render, ``score_fn_with_params`` and ``optax.adam``, from one
    numpy-seeded field: the reward at each step and the field after."""
    s = setup
    coarse, lr, size = 16, 0.05, s["cfg"].chat.image_size
    field0 = 0.1 * np.random.default_rng(1).normal(
        size=(FRAMES, coarse, coarse, 3)).astype(np.float32)

    _, render = _jax_example().make_generator(jax.random.PRNGKey(1), FRAMES,
                                              coarse, size)
    score_fn = s["jax"].score_fn_with_params(s["ids"], s["gpos"])
    opt = optax.adam(lr)

    @jax.jit
    def jax_step(params, field, opt_state):
        loss, grads = jax.value_and_grad(
            lambda f: -score_fn(params, render(f)))(field)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(field, updates), opt_state, -loss

    params = jax.tree.map(jnp.asarray, s["params"])
    jfield = jnp.asarray(field0)
    opt_state = opt.init(jfield)
    want = []
    for _ in range(3):
        jfield, opt_state, r = jax_step(params, jfield, opt_state)
        want.append(float(r))

    field = torch.from_numpy(field0.copy()).requires_grad_()
    np.testing.assert_allclose(vader_loop.render(field, size).detach().numpy(),
                               np.asarray(render(jnp.asarray(field0))),
                               atol=1e-5)
    step = vader_loop.make_step(
        vader_loop.reward_fn(s["port"], FRAMES, CAPTION), field, size, lr)
    got = [float(step()) for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=2e-5)
    # Adam divides each update by the root of its squared gradient, so an
    # entry whose gradient is near 0 moves by up to lr times that
    # gradient's relative error: 1e-4 is 2e-3 of lr.
    np.testing.assert_allclose(field.detach().numpy(), np.asarray(jfield),
                               atol=1e-4)


def test_forward_only_guard_refuses_a_differentiable_call():
    """The guard of K3, K2r, K5, K6 and K7 on a CUDA tensor: a call that
    autograd would need to differentiate raises (those kernels write into
    ``torch.empty`` and have no backward); without grad it passes."""
    x = torch.zeros(2, 3)
    kernels.forward_only("w4_matmul", x, torch.ones(1))
    with pytest.raises(NotImplementedError, match="w4_matmul has no backward"):
        kernels.forward_only("w4_matmul", x, x.clone().requires_grad_())
    with torch.no_grad():
        kernels.forward_only("q8g_matmul", x.clone().requires_grad_())
