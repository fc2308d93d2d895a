"""The K4a/K4b twin, which the Hopper backward template
(``mjvideo_tpu_torch/csrc/attention_bwd_sm90.cuh`` at D = 128) is held
against on the card, at that template's edges; and the sources' pins.

On the card K4a holds 128 keys a CTA and streams q tiles of 32 rows of each
of a kv head's G q heads; K4b holds 128 q rows a CTA and streams key tiles
of 64.  T = 63-193 put the sequence on each side of those edges.  The twin
(``decoder_attention_bwd_plain`` through ``decoder_attention_backward_plain``)
is held against the JAX package's ``_bwd_impl`` in Pallas interpret mode
from the JAX forward's out and lse (``_fwd_impl(with_lse=True)``, the exact
K3 form), at (1, T, 4/2, 128) with GQA: causal with a ragged right pad,
the all-gather form (Q != K at a positive q_offset), a negative q_offset
(every key above the diagonal: every gradient exactly 0), a key mask that
masks one whole 128-key block beside left padding with dead rows, and the
non-causal form with a mask.  Tolerances as
``tests/test_torch_flash_attention.py`` holds the decoder backward: fp32
to atol 2e-5 and rtol 1e-5 (the same sums in another order); bf16 to 2^-7
of max|JAX| (one bf16 ulp of the largest gradient; p and dS are rounded to
bf16 on both sides, at places a few fp32 ulps apart).  The kernels
themselves run only on the card
(``tests/test_torch_kernels_decoder_bwd_sm90.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import _bwd_impl, _fwd_impl
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

Hq, Hkv, D = 4, 2, 128  # GQA 2, D = 128: the decoder template's head dim
TILE_EDGES = (63, 64, 65, 127, 128, 129, 191, 192, 193)
REPO = Path(__file__).resolve().parent.parent


def _inputs(Q, K, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(1, Q, Hq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(1, K, Hkv, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _backward(q, k, v, do, mask, off, causal, dtype):
    """JAX's forward with the lse and ``_bwd_impl``, both in interpret mode,
    and the twin from JAX's out and lse; returns (twin, JAX) gradients as
    fp32 numpy arrays (dq, dk, dv) and the (1, Hq, Q) lse."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qj, kj, vj, doj = (jnp.asarray(t, jdt) for t in (q, k, v, do))
    mj = None if mask is None else jnp.asarray(mask)
    oj = None if off is None else jnp.asarray(off, jnp.int32)
    out, lse = _fwd_impl(qj, kj, vj, mj, oj, causal, None, None, None, True,
                         True)
    want = _bwd_impl(qj, kj, vj, mj, oj, out, lse, doj, causal, None, None,
                     None, True)
    lse = np.ascontiguousarray(np.asarray(lse)[:, :, 0, :q.shape[1]])

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(tdt)

    got = tfa.decoder_attention_backward_plain(
        T(q), T(k), T(v), None if mask is None else torch.from_numpy(mask),
        None if off is None else torch.from_numpy(np.asarray(off, np.int32)),
        torch.from_numpy(np.array(jnp.asarray(out, jnp.float32))).to(tdt),
        torch.from_numpy(lse), T(do), causal=causal)
    as32 = lambda a: np.array(jnp.asarray(a, jnp.float32))  # noqa: E731
    return ([g.float().numpy() for g in got], [as32(w) for w in want], lse)


def _assert_close(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.all(np.isfinite(g)), name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-5,
                                       err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= 2 ** -7 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", TILE_EDGES)
def test_k4_twin_matches_pallas_backward_at_tile_edges(T, dtype):
    """Causal self-attention, its last 3 keys masked (a ragged right pad):
    dk and dv exactly 0 there on both sides."""
    q, k, v, do = _inputs(T, T, 200 + T)
    mask = np.ones((1, T), np.int32)
    mask[:, T - 3:] = 0
    got, want, _ = _backward(q, k, v, do, mask, None, True, dtype)
    _assert_close(got, want, dtype)
    for g, w in zip(got[1:], want[1:]):
        assert not g[mask == 0].any() and not w[mask == 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_twin_matches_pallas_backward_all_gather_form(dtype):
    """Q != K: 65 q rows at q_offset 128 against all 193 keys, the form of
    an all-gather shard's rows."""
    q, k, v, do = _inputs(65, 193, 7)
    got, want, _ = _backward(q, k, v, do, None, (128,), True, dtype)
    _assert_close(got, want, dtype)


def test_k4_twin_is_exactly_zero_at_a_negative_offset():
    """q_offset -64 on 64 rows and 64 keys: every key lies above the
    diagonal (a later shard's ring chunk), so every row is dead and dq, dk
    and dv are exactly 0 on both sides."""
    q, k, v, do = _inputs(64, 64, 8)
    got, want, lse = _backward(q, k, v, do, None, (-64,), True, "float32")
    assert np.all(lse == tfa.DEAD_LSE)
    for g, w in zip(got, want):
        assert not g.any() and not w.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_twin_matches_pallas_backward_with_a_masked_key_block(dtype):
    """Keys 128-255 of 256 masked (one whole dK/dV block of 128 keys) and
    the first 5 (left padding: rows 0-4 see no key): dq exactly 0 on the
    dead rows, dk and dv exactly 0 on every masked key."""
    q, k, v, do = _inputs(256, 256, 9)
    mask = np.ones((1, 256), np.int32)
    mask[:, :5] = 0
    mask[:, 128:] = 0
    got, want, lse = _backward(q, k, v, do, mask, None, True, dtype)
    _assert_close(got, want, dtype)
    dead = lse >= tfa.DEAD_LSE * 0.5  # (1, Hq, Q)
    assert dead[:, :, :5].all() and not dead[:, :, 5:].any()
    assert not got[0][:, :5].any() and not want[0][:, :5].any()
    for g, w in zip(got[1:], want[1:]):
        assert not g[mask == 0].any() and not w[mask == 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_twin_matches_pallas_backward_non_causal_with_mask(dtype):
    q, k, v, do = _inputs(129, 129, 10)
    mask = np.ones((1, 129), np.int32)
    mask[:, 40:70] = 0
    got, want, _ = _backward(q, k, v, do, mask, None, False, dtype)
    _assert_close(got, want, dtype)
    for g in got[1:]:
        assert not g[mask == 0].any()


def _instantiations(source: str) -> int:
    """The distinct (Config, causal) launches a source makes of the
    backward template."""
    return len(set(re.findall(r"launch_(?:dkdv|dq)<bwd::(\w+), (true|false)>",
                              source)))


def test_k4_sources_run_on_the_hopper_backward_template():
    """K4a/K4b's entries include the wgmma/TMA backward template and no
    longer the WMMA one, which is gone from the sources and from
    ``kernels.HEADERS`` (the build hash); the D = 128 Configs exist; and
    chip_smoke's count of the Hopper instantiations equals what the sources
    define."""
    csrc = kernels.CSRC
    entry = (csrc / "decoder_attention_bwd.cu").read_text()
    assert '#include "attention_bwd_sm90.cuh"' in entry
    assert '#include "attention_bwd.cuh"' not in entry
    assert not (csrc / "attention_bwd.cuh").exists()
    assert "attention_bwd.cuh" not in kernels.HEADERS
    assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(
        kernels.HEADERS)
    header = (csrc / "attention_bwd_sm90.cuh").read_text()
    for name in ("DkdvD128", "DqD128"):
        assert re.search(rf"using {name} = Config<128, ", header), name
    # The backward template's instantiations: K4 nc's two and K4a/K4b's
    # four at D = 128 and four at D = 96 (each kernel causal and not).
    bwd = sum(_instantiations((csrc / f).read_text())
              for f in ("vit_attention_bwd.cu", "decoder_attention_bwd.cu"))
    assert bwd == 10
    # The forward template's 14 of the main paths (K3 causal and not, K2r,
    # K2, K1; K2 and K3 causal and not and K2r at D = 96; K1 at D = 80; K1
    # and K1m at D = 72; K3 not causal at D = 112; K1 at D = 128) and the
    # A/B variants' (B1's modes and B2's hp; B3 is B2's hp 1), the
    # key-norm partial pass 7 (K1/K2's at D = 64, 72, 80,
    # 96 and 128, K2r's with its norms at 128 and 96), kmax's fold 1, K2r's
    # scan 1, the int8 GEMM's 2 and K6's pre-pass 1 (chip_smoke.py's
    # SM90_KERNELS).
    variants = len(kernels.VARIANT_MODES) + len(kernels.TMAJOR_HP)
    smoke = (REPO / "chip_smoke.py").read_text()
    want = re.search(r"^SM90_INSTANTIATIONS = (\d+)$", smoke, re.M)
    assert want is not None and int(want.group(1)) == (
        14 + variants + 7 + 1 + 1 + 2 + 1 + bwd)
