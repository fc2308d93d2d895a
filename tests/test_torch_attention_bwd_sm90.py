"""The K4 nc twin, which the Hopper backward template
(``mjvideo_tpu_torch/csrc/attention_bwd_sm90.cuh``) is held against on the
card, at that template's tile edges.

The dK/dV kernel streams q rows in tiles of 64 and holds 128 keys a CTA; the
dQ kernel holds 192 q rows and streams keys in tiles of 64.  S = 63, 129
and 193 leave a partial tile at each of those edges.  The twin
(``vit_attention_bwd_plain``) is held against the JAX package's
``_bwd_impl(causal=False)`` in Pallas interpret mode on the 8-padded rows,
as ``tests/test_torch_flash_attention.py`` does at S = 37 and 65: in fp32
to atol 2e-5 (the same sums in another order), in bf16 to 2^-7 of max|JAX|
(one bf16 ulp of the largest gradient; p and dS are rounded to bf16 on
both sides, at places a few fp32 ulps apart).

The dK/dV kernel takes no per-score mask on a tile that reaches past S,
and the dQ kernel masks only its last key tile, because padded rows
contribute exact zeros when they are zero with lse = DEAD_LSE and delta = 0
(TMA's zero fill and the kernel's guarded lse loads); the last test pins
that on the twin's arithmetic.  The kernels themselves run
only on the card (``tests/test_torch_kernels_bwd_sm90.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import _bwd_impl, _fwd_impl
from mjvideo_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

B, H, D = 1, 2, 64  # D = 64: the template's head dim


def _padded_inputs(S, seed):
    """q, k, v and dO padded to a multiple of 8 rows as the JAX ViT pads
    them: k, v and dO zero on the tail, q's tail random."""
    rng = np.random.default_rng(seed)
    Sp = -(-S // 8) * 8
    q, k, v, do = (rng.normal(size=(B, Sp, H, D)).astype(np.float32)
                   for _ in range(4))
    for t in (k, v, do):
        t[:, S:] = 0.0
    return q, k, v, do


def _jax_backward(q, k, v, do, S, dtype):
    """JAX's forward with the lse, then ``_bwd_impl(causal=False)``, both
    in interpret mode; returns (out, lse (B, H, S), (dq, dk, dv)) as numpy
    arrays in fp32."""
    qj, kj, vj, doj = (jnp.asarray(t, dtype) for t in (q, k, v, do))
    out, lse = _fwd_impl(qj, kj, vj, None, None, False, None, None, None,
                         True, True, kv_valid=S, norm_bound=True)
    grads = _bwd_impl(qj, kj, vj, None, None, out, lse, doj, False, None,
                      None, None, True)
    as32 = lambda a: np.array(jnp.asarray(a, jnp.float32))  # noqa: E731
    return (as32(out), np.asarray(lse)[:, :, 0, :S],
            tuple(as32(g) for g in grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [63, 129, 193])
def test_k4_nc_twin_matches_pallas_backward_at_tile_edges(S, dtype):
    q, k, v, do = _padded_inputs(S, 100 + S)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    out, lse, want = _jax_backward(q, k, v, do, S, jdt)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a[:, :S])).to(tdt)

    got = tfa.vit_attention_backward_plain(
        T(q), T(k), T(v), T(out), torch.from_numpy(np.ascontiguousarray(lse)),
        T(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float().numpy(), w[:, :S]
        assert np.all(np.isfinite(g)), name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-5,
                                       err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= 2 ** -7 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Sp", [(63, 64), (65, 128), (129, 192),
                                  (193, 256)])
def test_k4_nc_padding_rows_add_exact_zeros(S, Sp, dtype):
    """Rows appended past S with q = k = v = dO = 0, lse = DEAD_LSE and
    delta = 0 leave dq, dk and dv of the real rows bit-equal: padded q rows
    get p = exp(0 - DEAD_LSE) = 0, padded keys add dS * 0 to dq."""
    rng = np.random.default_rng(S)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, S, H, D))
                                    .astype(np.float32)).to(dtype)
                   for _ in range(4))
    out, lse = tfa.vit_attention_plain(q, k, v, return_lse=True)
    delta = tfa.attention_delta(out, do)
    real = tfa.vit_attention_bwd_plain(q, k, v, do, lse, delta)

    def pad(t, value=0.0):
        width = [(0, 0)] * t.dim()
        width[1 if t.dim() == 4 else 2] = (0, Sp - S)
        flat = [w for pair in reversed(width) for w in pair]
        return torch.nn.functional.pad(t, flat, value=value)

    padded = tfa.vit_attention_bwd_plain(
        pad(q), pad(k), pad(v), pad(do), pad(lse, tfa.DEAD_LSE), pad(delta))
    for name, a, b in zip(("dq", "dk", "dv"), real, padded):
        assert torch.equal(a, b[:, :S]), name
