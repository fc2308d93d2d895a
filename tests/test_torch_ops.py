"""The port's ops against the JAX package's, fp32 on the CPU.

Same numpy inputs (``np.random.default_rng``) go through both.  Tolerances:
elementwise ops agree to fp32 rounding (atol 1e-6 at unit scale); products
and softmaxes sum in another order (atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops import attention as jattn
from mjvideo_tpu.ops import matmul as jmm
from mjvideo_tpu.ops import norms as jnorms
from mjvideo_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
from mjvideo_tpu.ops import quant as jquant
from mjvideo_tpu.ops import rope as jrope
from mjvideo_tpu_torch.ops import attention as tattn
from mjvideo_tpu_torch.ops import matmul as tmm
from mjvideo_tpu_torch.ops import norms as tnorms
from mjvideo_tpu_torch.ops import pixel_shuffle as tps
from mjvideo_tpu_torch.ops import quant as tquant
from mjvideo_tpu_torch.ops import rope as trope

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3 + 1
    w = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rms_norm(_t(x), _t(w), eps=1e-5).numpy(),
        _np(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5)),
        atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(
        tnorms.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        _np(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))),
        atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("scaling", [None, "linear", "dynamic"])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(1)
    S, H, D = 40, 3, 16
    kw = dict(base=10000.0, scaling_type=scaling, scaling_factor=2.0,
              max_position_embeddings=32)  # dynamic engages: 40 > 32
    jc, js = jrope.rope_tables(S, D, **kw)
    tc, ts = trope.rope_tables(S, D, device=CPU, **kw)
    # Tables: fp32 powers and cosines of arguments up to ~40 rad.
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5)
    q = rng.normal(size=(2, S, H, D)).astype(np.float32)
    k = rng.normal(size=(2, S, H, D)).astype(np.float32)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = trope.apply_rope(_t(q), _t(k), tc, ts)
    np.testing.assert_allclose(tq.numpy(), _np(jq), atol=5e-5)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=5e-5)


def test_rope_position_ids_and_pregathered_tables_match_jax():
    """The cached layer rotates each new token by its cache slot: the
    tables gathered at ``position_ids`` (B, S), and the (B, S, D)
    pre-gathered branch."""
    rng = np.random.default_rng(8)
    B, S, H, D, L = 2, 5, 3, 16, 40
    jc, js = jrope.rope_tables(L, D)
    tc, ts = trope.rope_tables(L, D, device=CPU)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, H, D)).astype(np.float32)
    pos = np.array([[0, 3, 9, 17, 39], [30, 31, 32, 33, 34]])
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js,
                              jnp.asarray(pos))
    tq, tk = trope.apply_rope(_t(q), _t(k), tc, ts, torch.from_numpy(pos))
    np.testing.assert_allclose(tq.numpy(), _np(jq), atol=5e-5)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=5e-5)
    # Pre-gathered (B, S, D) values give the same rotation as the gather.
    pq, pk = trope.apply_rope(_t(q), _t(k), tc[pos], ts[pos])
    np.testing.assert_array_equal(pq.numpy(), tq.numpy())
    np.testing.assert_array_equal(pk.numpy(), tk.numpy())
    jq3, _ = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc[pos], js[pos])
    np.testing.assert_allclose(pq.numpy(), _np(jq3), atol=5e-5)


def test_quantize_kv_matches_jax_exactly():
    """Per-(slot, head) int8 with round-half-even: equal int8 values and
    scales, including a zero vector, exact .5 ties and bf16 input."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 0, :2] = (127.0, 0.5)  # scale 1: 0.5 rounds to even 0
    x[0, 1, 0, 2] = 2.5
    for xin in (x, x.astype(jnp.bfloat16)):
        jq, js = jquant.quantize_kv(jnp.asarray(xin))
        tq, ts = tquant.quantize_kv(torch.from_numpy(np.asarray(xin,
                                                                np.float32)))
        np.testing.assert_array_equal(tq.numpy(), _np(jq))
        np.testing.assert_array_equal(ts.numpy(), _np(js))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(
            tquant.dequantize_kv(tq, ts, torch.float32).numpy(),
            _np(jquant.dequantize_kv(jq, js, jnp.float32)))
    assert tq[0, 1, 0, 1] == 0 and tq[0, 1, 0, 2] == 2


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_pixel_shuffle_matches_jax_exactly(version):
    # Non-square W != H and distinct values pin the W/H axis naming.
    x = np.arange(2 * 4 * 6 * 8, dtype=np.float32).reshape(2, 4, 6, 8)
    np.testing.assert_array_equal(
        tps.pixel_shuffle(_t(x), 0.5, version).numpy(),
        _np(jax_pixel_shuffle(jnp.asarray(x), 0.5, version)))


def test_dot_and_erf_gelu_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 24)).astype(np.float32) * 2
    w = rng.normal(size=(24, 12)).astype(np.float32)
    np.testing.assert_allclose(tmm.dot(_t(x), _t(w)).numpy(),
                               _np(jmm.dot(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-5)
    np.testing.assert_allclose(tmm.dot_f32(_t(x), _t(w)).numpy(),
                               _np(jmm.dot_f32(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-5)
    # fp32: JAX uses the exact erf form, as the port does at every dtype.
    np.testing.assert_allclose(tmm.gelu(_t(x)).numpy(),
                               _np(jmm.gelu(jnp.asarray(x))), atol=1e-6)


def test_attention_bias_and_kv_valid_mask_match_jax():
    rng = np.random.default_rng(3)
    mask = (rng.random((2, 9)) > 0.3).astype(np.int32)
    for causal in (False, True):
        for m in (None, mask):
            jb = jattn.make_attention_bias(
                None if m is None else jnp.asarray(m), 6, 9, causal)
            tb = tattn.make_attention_bias(
                None if m is None else _t(m), 6, 9, causal, device=CPU)
            if jb is None:
                assert tb is None
            else:
                np.testing.assert_array_equal(tb.numpy(), _np(jb))
    np.testing.assert_array_equal(
        tattn.kv_valid_mask(3, 10, 7, device=CPU).numpy(),
        _np(jattn.kv_valid_mask(3, 10, 7)))


@pytest.mark.parametrize("causal,masked,Hq,Hkv", [
    (True, True, 4, 2),    # decoder shape: GQA, causal, padding
    (False, True, 4, 4),   # non-causal masked MHA
    (False, False, 6, 2),  # non-causal GQA
])
def test_attention_plain_matches_attention_xla(causal, masked, Hq, Hkv):
    rng = np.random.default_rng(4)
    B, S, D = 2, 23, 16
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(S)[None] < np.array([[S], [S - 7]])).astype(np.int32)
    ref = jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attention_mask=None if mask is None else jnp.asarray(mask),
        causal=causal, impl="xla")
    got = tattn.multi_head_attention(
        _t(q), _t(k), _t(v), attention_mask=None if mask is None else _t(mask),
        causal=causal, impl="plain")
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)
