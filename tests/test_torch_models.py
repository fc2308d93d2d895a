"""The port's towers and reward forward against the JAX package.

``tiny_test_config`` in fp32 on the CPU; JAX parameters cross through
``from_jax_params`` and JAX runs with ``attn_impl="xla"`` (exact softmax),
the port with its default ``impl="auto"`` (the kernels' plain twins on the
CPU, which shift the softmax by the norm bound).  Tolerance atol 2e-5 with
rtol 1e-5: the same fp32 functions summed in other orders, through 2 layers
of each tower at unit activation scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.models import internvl as jinternvl
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.models import vit as jvit
from mjvideo_tpu_torch.models import internvl as tinternvl
from mjvideo_tpu_torch.models import reward as treward
from mjvideo_tpu_torch.models import vit as tvit
from mjvideo_tpu_torch.utils.bridge import from_jax_params, to_numpy

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jax.jit(lambda key: jreward.init_reward_params(key, cfg))(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    # Non-trivial norm/bias/LayerScale values, so that every parameter
    # reaches the output through its own path.
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (a + rng.normal(size=a.shape).astype(a.dtype) * 0.05
                   if a.ndim >= 1 and a.shape[-1] > 1 and a.size < 5000 else a),
        params)
    ch = cfg.chat
    n_img = ch.num_image_token
    T = 2 * n_img + 14
    ids = rng.integers(10, 200, size=(2, T)).astype(np.int32)
    ids[0, 3:3 + n_img] = ch.img_context_token_id
    ids[1, 5:5 + n_img] = ch.img_context_token_id
    ids[1, T - 4:] = ch.llm.pad_token_id
    mask = (ids != ch.llm.pad_token_id).astype(np.int32)
    pix = rng.normal(size=(2, ch.image_size, ch.image_size, 3)).astype(np.float32)
    gpos = np.array([T - 6, T - 9], np.int32)
    return cfg, params, from_jax_params(params), pix, ids, mask, gpos


def test_bridge_round_trip_keeps_layouts(setup):
    _, params, state, *_ = setup
    back = to_numpy(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # Dense kernels stay (in, out), layers stacked on a leading L axis.
    cfg = setup[0]
    C = cfg.chat.vision.hidden_size
    assert tuple(state["model"]["vision_model"]["layers"]["attn"]["qkv"]
                 ["kernel"].shape) == (cfg.chat.vision.num_hidden_layers, C, 3 * C)


def test_vit_forward_matches_jax(setup):
    cfg, params, state, pix, *_ = setup
    vp = params["model"]["vision_model"]
    ref = jax.jit(lambda p, x: jvit.vit_forward(
        p, cfg.chat.vision, x, attn_impl="xla", remat=False))(vp, jnp.asarray(pix))
    got = tvit.vit_forward(state["model"]["vision_model"], cfg.chat.vision,
                           torch.from_numpy(pix))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # select_layer=-2 stops one layer early on both sides.
    ref2 = jvit.vit_forward(vp, cfg.chat.vision, jnp.asarray(pix),
                            select_layer=-2, attn_impl="xla", remat=False)
    got2 = tvit.vit_forward(state["model"]["vision_model"], cfg.chat.vision,
                            torch.from_numpy(pix), select_layer=-2)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), **TOL)


def test_chat_forward_matches_jax(setup):
    cfg, params, state, pix, ids, mask, _ = setup
    ref = jax.jit(lambda p, x, i, m: jinternvl.chat_forward(
        p, cfg.chat, x, i, m, attn_impl="xla", remat=False))(
            params["model"], jnp.asarray(pix), jnp.asarray(ids),
            jnp.asarray(mask))
    got = tinternvl.chat_forward(state["model"], cfg.chat,
                                 torch.from_numpy(pix), torch.from_numpy(ids),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_reward_forward_matches_jax_in_every_field(setup):
    cfg, params, state, pix, ids, mask, gpos = setup
    ref = jax.jit(lambda p, x, i, m, g: jreward.reward_forward(
        p, cfg, x, i, m, g, attn_impl="xla", remat=False))(
            params, jnp.asarray(pix), jnp.asarray(ids), jnp.asarray(mask),
            jnp.asarray(gpos))
    got = treward.reward_forward(state, cfg, torch.from_numpy(pix),
                                 torch.from_numpy(ids), torch.from_numpy(mask),
                                 torch.from_numpy(gpos))
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_reward_head_clamps_indices_like_jax_clip(setup):
    """No pad in a row wraps the pool index to T - 1; gating positions past
    either end land where JAX's gather puts them (negative counts from the
    end, then ``mode="clip"``)."""
    cfg, params, state, *_ = setup
    rng = np.random.default_rng(1)
    B, T, C = 2, 9, cfg.hidden_size
    hidden = rng.normal(size=(B, T, C)).astype(np.float32)
    ids = rng.integers(10, 200, size=(B, T)).astype(np.int32)
    ids[1, 6:] = cfg.chat.llm.pad_token_id
    gpos = np.array([T + 5, -3], np.int32)  # -> T - 1 and T - 3
    ref = jreward.reward_head(params, cfg, jnp.asarray(hidden),
                              jnp.asarray(ids), jnp.asarray(gpos))
    got = treward.reward_head(state, cfg, torch.from_numpy(hidden),
                              torch.from_numpy(ids), torch.from_numpy(gpos))
    np.testing.assert_allclose(got.hidden_state.numpy()[0], hidden[0, T - 1])
    np.testing.assert_allclose(got.hidden_state.numpy()[1], hidden[1, 5])
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_position_embedding_f1_on_grid_exact_off_grid_follows_reference(setup):
    """ROADMAP F1.  With the patch kernel zeroed, embeddings are cls/bias +
    position embeddings.  On the native grid (56 px) the port equals JAX
    exactly.  Off it (70 px) the port follows the reference's
    ``F.interpolate(bicubic, align_corners=False)`` and JAX its
    ``jax.image.resize``: measured here max |delta| 1.6e-2, 7.1% of the
    largest value, so the test requires more than 5% (fp32 rounding is
    ~1e-7 of it)."""
    cfg, params, *_ = setup
    vc = cfg.chat.vision
    emb = jax.tree.map(np.copy, params["model"]["vision_model"]["embeddings"])
    emb["patch_embedding"]["kernel"][:] = 0.0
    temb = from_jax_params(emb)
    rng = np.random.default_rng(2)
    for px, exact in ((56, True), (70, False)):
        x = rng.normal(size=(2, px, px, 3)).astype(np.float32)
        ref = np.asarray(jvit.embeddings(emb, vc, jnp.asarray(x)))
        got = tvit.embeddings(temb, vc, torch.from_numpy(x)).numpy()
        if exact:
            np.testing.assert_array_equal(got, ref)
        else:
            rel = np.abs(got - ref).max() / np.abs(ref).max()
            assert rel > 0.05, rel
            assert np.isfinite(got).all()
