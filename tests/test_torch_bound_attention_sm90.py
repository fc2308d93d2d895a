"""The bound of K1 and K2 and their twins at the Hopper template's tile
edges, on the CPU.

``key_norm_max`` (the plain twin of the pre-pass kernel of K1 and K2) is
held against the JAX package's norm-bound arithmetic written out in
``jnp`` on the same numpy inputs: ``_fwd_impl``'s masked (B, Hkv) reduce
(``mjvideo_tpu/ops/flash_attention.py:484-511``) and ``_fwd_nc_kernel``'s
in-kernel max over one (b, head)'s keys (:131-135).  The K2 twin is held
against ``flash_attention(causal=True, norm_bound=True)`` and the K1 twin
against the non-causal ``norm_bound`` path, both in Pallas interpret mode
(the JAX package's own CPU route), at the template's edges: q tiles of
64-row warpgroups (128 rows for K2, 192 for K1) and 128-key kv tiles, so K
in {127, 128, 129, 1025} and q rows 63, 64, 65, 127, 128, 129 and, for K1,
191-193; GQA with a per-row q_offset; a left-padded row whose first queries
see no key.  The same twins are held on bf16 inputs, the kernels' dtype,
against the same JAX paths on the same bf16 values.  The K1-lse and K2-lse
twins (``return_lse=True``) are held at the same edges against
``_fwd_impl(..., with_lse=True, norm_bound=True, interpret=True)``, whose
(B, Hq, 8, Qp) lse is read at ``[:, :, 0, :Q]``: live rows to LSE_TOL nats
(fp32 sums in another order, an ulp or two of an lse near 10), K2's dead
rows ``DEAD_LSE`` in both.  Tolerances: the fp32
norms are sums of squares taken in another order than XLA's, so relative
1e-6, on bf16 keys too (the twin, like ``_fwd_impl``, widens them to fp32
first); the attention twins atol 2e-5 on fp32 inputs, as
``tests/test_torch_flash_attention.py`` holds them (fp32 sums in different
orders), and 2^-7 of max|JAX| on bf16 inputs, the bound ``chip_smoke.py``
holds a bf16 kernel to (both round p and the output to bf16, so an fp32
sum taken in another order can move a p across a bf16 rounding edge).  The
kernels themselves run only on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import _fwd_impl, flash_attention
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# (B, K, Hkv, D, mask kind): the ViT's D = 64 over a whole tile, the
# decoder's D = 128 with holes, a fully masked row and an odd K.
NORM_CASES = {
    "vit_tile": (2, 1025, 4, 64, None),
    "vit_holes": (2, 77, 2, 64, "holes"),
    "decoder_holes": (2, 129, 2, 128, "holes"),
    "decoder_dead_row": (2, 300, 8, 128, "dead_row"),
}


def _keys(case):
    B, K, Hkv, D, kind = NORM_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    k = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    # Varied norms, so the max is one key's and the mask matters.
    k *= rng.uniform(0.2, 3.0, size=(B, K, Hkv, 1)).astype(np.float32)
    mask = None
    if kind is not None:
        mask = (rng.uniform(size=(B, K)) > 0.3).astype(np.int32)
        if kind == "dead_row":
            mask[1] = 0
    return k, mask


def _jax_masked_kmax(k, mask):
    """``_fwd_impl``'s reduce on (B, K, Hkv, D): (B, Hkv)."""
    B, K = k.shape[:2]
    k32 = jnp.transpose(jnp.asarray(k), (0, 2, 1, 3)).astype(jnp.float32)
    kn2 = jnp.sum(k32 * k32, axis=-1)
    m = jnp.ones((B, K), jnp.int32) if mask is None else jnp.asarray(mask)
    kn2 = kn2 * (m != 0)[:, None, :].astype(jnp.float32)
    return np.asarray(jnp.sqrt(jnp.max(kn2, axis=-1)))


def _jax_nc_kmax(k):
    """``_fwd_nc_kernel``'s max, one program per (b, head): (B, H)."""
    out = np.zeros(k.shape[0:1] + k.shape[2:3], np.float32)
    for b in range(k.shape[0]):
        for h in range(k.shape[2]):
            k32 = jnp.asarray(k[b, :, h])
            out[b, h] = float(jnp.sqrt(jnp.max(jnp.sum(k32 * k32, axis=-1))))
    return out


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_key_norm_max_twin_matches_jax_norm_bound(case):
    """The pre-pass twin's (B, Hkv) bound against ``_fwd_impl``'s masked
    reduce, and for the maskless ViT cases against ``_fwd_nc_kernel``'s
    max; a row with every key masked has bound 0."""
    k, mask = _keys(case)
    got = tfa.key_norm_max(torch.from_numpy(k),
                           None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (k.shape[0],
                                                        k.shape[2])
    np.testing.assert_allclose(got.numpy(), _jax_masked_kmax(k, mask),
                               rtol=1e-6, atol=0)
    if mask is None:
        np.testing.assert_allclose(got.numpy(), _jax_nc_kmax(k), rtol=1e-6,
                                   atol=0)
    if NORM_CASES[case][-1] == "dead_row":
        assert not got[1].any()


@pytest.mark.parametrize("case", ["vit_tile", "decoder_holes"])
def test_key_norm_max_twin_matches_jax_norm_bound_on_bf16_keys(case):
    """The kernels' keys are bf16: the twin on bf16 keys against
    ``_fwd_impl``'s reduce on the same bf16 values."""
    k, mask = _keys(case)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    got = tfa.key_norm_max(kb, None if mask is None else
                           torch.from_numpy(mask))
    want = _jax_masked_kmax(jnp.asarray(k).astype(jnp.bfloat16), mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# (B, Q, K, Hq, Hkv, q_offset per row or None, left pad of row 1): the
# template's edges, self-attention and continuations over a longer cache.
K2_CASES = {
    "k127": (2, 127, 127, 4, 2, None, 5),
    "k128": (2, 128, 128, 4, 2, None, 5),
    "k129": (2, 129, 129, 4, 2, None, 5),
    "k1025": (1, 1025, 1025, 2, 1, None, 0),
    "q63_offset": (2, 63, 129, 4, 2, (66, 40), 5),
    "q64_offset": (2, 64, 129, 4, 2, (65, 1), 5),
    "q65_offset": (2, 65, 129, 4, 2, (64, 30), 5),
    "q127_offset": (2, 127, 257, 4, 2, (130, 2), 9),
    "q128_offset": (2, 128, 257, 4, 2, (129, 0), 9),
}


def _k2_inputs(case):
    B, Q, K, Hq, Hkv, off, pad = K2_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    D = 16
    q = rng.normal(size=(B, Q, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    mask = np.ones((B, K), np.int32)
    mask[-1, :pad] = 0
    mask[0, K - 3:] = 0  # a right-padded row too
    off = None if off is None else np.asarray(off, np.int32)
    return q, k, v, mask, off


LSE_TOL = 1e-5


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_twin_matches_pallas_bound_kernel_at_tile_edges(case):
    """The K2 twin (``decoder_attention`` on the CPU) against
    ``_fwd_bound_kernel`` through ``flash_attention(causal=True,
    norm_bound=True)``: GQA, a left-padded row (its first queries dead,
    exactly 0 in both), per-row offsets past a q tile's edge."""
    q, k, v, mask, off = _k2_inputs(case)
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = np.asarray(flash_attention(J(q), J(k), J(v), attention_mask=J(mask),
                                     causal=True, q_offset=J(off),
                                     norm_bound=True))
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = tfa.flash_attention(T(q), T(k), T(v), T(mask), causal=True,
                              q_offset=T(off), norm_bound=True).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    dead = ~tfa._decoder_allowed(T(q), T(k), T(mask), T(off)).any(-1)
    if K2_CASES[case][-1] and off is None:
        assert dead.any()
    assert np.all(got[dead.numpy()] == 0.0)
    assert np.all(ref[dead.numpy()] == 0.0)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_lse_twin_matches_pallas_bound_kernel_at_tile_edges(case):
    """The K2-lse twin (``decoder_attention_plain(return_lse=True)``)
    against ``_fwd_bound_kernel(with_lse=True)`` at the K2 cases' edges:
    the output to 2e-5, live rows' lse to LSE_TOL nats, the left-padded
    dead rows exactly 0 and ``DEAD_LSE`` in both."""
    q, k, v, mask, off = _k2_inputs(case)
    Q = q.shape[1]
    out, lse = _fwd_impl(_j(q), _j(k), _j(v), _j(mask), _j(off), True, None,
                         None, None, True, True, norm_bound=True)
    lse = np.asarray(lse)[:, :, 0, :Q]
    got, got_lse = tfa.decoder_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                               _t(off), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-5)
    dead = ~tfa._decoder_allowed(_t(q), _t(k), _t(mask), _t(off)).any(-1)
    dead = dead[:, None, :].expand(got_lse.shape).numpy()  # (B, Hq, Q)
    if K2_CASES[case][-1] and off is None:
        assert dead.any()
    assert np.all(got_lse.numpy()[dead] == tfa.DEAD_LSE)
    assert np.all(lse[dead] == tfa.DEAD_LSE)
    np.testing.assert_allclose(got_lse.numpy()[~dead], lse[~dead],
                               atol=LSE_TOL, rtol=0)


K1_EDGES = (63, 64, 65, 127, 128, 129, 191, 192, 193, 1025)


@pytest.mark.parametrize("S", K1_EDGES)
def test_k1_twin_matches_pallas_nc_kernel_at_tile_edges(S):
    """The K1 twin (``vit_attention`` on the CPU) against ``_fwd_nc_kernel``
    with ``norm_bound`` through ``flash_attention(causal=False,
    norm_bound=True)``, at D = 64 with S on both sides of the template's
    64-row warpgroup, 128-key kv tile and 192-row q tile edges, up to the
    448 px tile's 1025 (one key past the eighth kv tile)."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(1, S, 2, 64)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False,
                                     norm_bound=True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False,
                              norm_bound=True).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("S", K1_EDGES)
def test_k1_lse_twin_matches_pallas_nc_kernel_at_tile_edges(S):
    """The K1-lse twin (``vit_attention_plain(return_lse=True)``) against
    ``_fwd_nc_kernel(with_lse=True)`` at the K1 edges, on S rows as they
    are (JAX pads them to a multiple of 8 and subtracts the pad's mass):
    the output to 2e-5 and every row's lse to LSE_TOL nats; no row
    underflows here, so the two dead-row rules do not differ."""
    rng = np.random.default_rng(S + 1)
    q, k, v = (rng.normal(size=(1, S, 2, 64)).astype(np.float32)
               for _ in range(3))
    out, lse = _fwd_impl(_j(q), _j(k), _j(v), None, None, False, None, None,
                         None, True, True, norm_bound=True)
    got, got_lse = tfa.vit_attention_plain(_t(q), _t(k), _t(v),
                                           return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-5)
    assert got_lse.max().item() < tfa.DEAD_LSE * 0.5
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse)[:, :, 0, :S], atol=LSE_TOL,
                               rtol=0)


BF16_REL_TOL = 2.0 ** -7
# (kind, B, Q = K, Hq, Hkv, D): K2 with GQA and a left-padded row at the
# decoder's D = 128 and past a 128-key tile; K1 at D = 64 past a 64-row
# warpgroup, a 192-row q tile and the 448 px tile's 1025.
BF16_CASES = {
    "k2_129_d64": ("k2", 2, 129, 4, 2, 64),
    "k2_300_d128": ("k2", 2, 300, 4, 2, 128),
    "k1_65": ("k1", 1, 65, 2, 2, 64),
    "k1_193": ("k1", 1, 193, 2, 2, 64),
    "k1_1025": ("k1", 1, 1025, 2, 2, 64),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_k1_and_k2_twins_match_pallas_kernels_on_bf16_inputs(case):
    """The K2 and K1 twins on bf16 q/k/v (the kernels' dtype) against
    ``flash_attention(norm_bound=True)`` on the same bf16 values, each to
    2^-7 of max|JAX|; K2's dead rows exactly 0 in both."""
    kind, B, S, Hq, Hkv, D = BF16_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    mask = None
    if kind == "k2":
        mask = np.ones((B, S), np.int32)
        mask[1, :5] = 0
    J = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    T = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    ref = flash_attention(J(q), J(k), J(v), causal=kind == "k2",
                          norm_bound=True, attention_mask=None if mask is None
                          else jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    got = tfa.flash_attention(T(q), T(k), T(v), None if mask is None else
                              torch.from_numpy(mask), causal=kind == "k2",
                              norm_bound=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - ref).max() <= BF16_REL_TOL * np.abs(ref).max()
    if mask is not None:
        dead = np.zeros((B, S), bool)
        dead[1, :5] = True
        assert np.all(got[dead] == 0.0) and np.all(ref[dead] == 0.0)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_k1_and_k2_lse_twins_match_pallas_kernels_on_bf16_inputs(case):
    """The K2-lse and K1-lse twins on bf16 q/k/v against ``_fwd_impl(...,
    with_lse=True, norm_bound=True)`` on the same bf16 values: the output
    to 2^-7 of max|JAX|, live rows' lse to LSE_TOL nats (both take the
    norms, scores and sums in fp32), K2's dead rows DEAD_LSE in both."""
    kind, B, S, Hq, Hkv, D = BF16_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 1)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    causal = kind == "k2"
    mask = None
    if causal:
        mask = np.ones((B, S), np.int32)
        mask[1, :5] = 0
    J = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    T = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    ref, ref_lse = _fwd_impl(J(q), J(k), J(v), _j(mask), None, causal, None,
                             None, None, True, True, norm_bound=True)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_lse = np.asarray(ref_lse)[:, :, 0, :S]
    if causal:
        got, lse = tfa.decoder_attention_plain(T(q), T(k), T(v), _t(mask),
                                               return_lse=True)
    else:
        got, lse = tfa.vit_attention_plain(T(q), T(k), T(v), return_lse=True)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got, lse = got.float().numpy(), lse.numpy()
    assert np.abs(got - ref).max() <= BF16_REL_TOL * np.abs(ref).max()
    dead = np.zeros((B, Hq, S), bool)
    if causal:
        dead[1, :, :5] = True
    assert np.all(lse[dead] == tfa.DEAD_LSE)
    assert np.all(ref_lse[dead] == tfa.DEAD_LSE)
    np.testing.assert_allclose(lse[~dead], ref_lse[~dead], atol=LSE_TOL,
                               rtol=0)


def test_k1_and_k2_pre_pass_is_counted_under_its_own_name():
    """The pre-pass of K1 and K2 has its own counter, reset with the rest;
    a CPU call takes the twins and launches nothing."""
    assert {"vit_attention", "decoder_attention", "key_norm_max",
            "key_norm_cummax"} <= set(kernels.launch_counts)
    kernels.reset_launch_counts()
    q = torch.zeros(1, 8, 2, 64)
    tfa.vit_attention(q, q, q)
    tfa.decoder_attention(torch.zeros(1, 8, 2, 128), torch.zeros(1, 8, 1, 128),
                          torch.zeros(1, 8, 1, 128))
    assert not any(kernels.launch_counts.values())
    kernels.launch_counts["key_norm_max"] = 2
    kernels.reset_launch_counts()
    assert kernels.launch_counts["key_norm_max"] == 0


def test_k1_and_k2_share_the_hopper_template():
    """K1 and K2, with the lse and without, are launched from the wgmma/TMA
    template, which every build hashes; the WMMA header is gone (its last
    user, B3, moved onto the template too), from the sources and from
    ``kernels.HEADERS``, and no source uses WMMA."""
    assert "decoder_attention_sm90.cuh" in kernels.HEADERS
    vit = (kernels.CSRC / "vit_attention.cu").read_text()
    dec = (kernels.CSRC / "decoder_attention.cu").read_text()
    assert "launch_attention<sm90::D64" in vit
    assert "ShiftMode::kKeyMax" in vit and "ShiftMode::kKeyMax" in dec
    assert not (kernels.CSRC / "bound_attention.cuh").exists()
    assert "bound_attention.cuh" not in kernels.HEADERS
    for path in kernels.CSRC.iterdir():
        text = path.read_text()
        assert "launch_bound_attention" not in text, path.name
        assert '#include "bound_attention.cuh"' not in text, path.name
        assert "wmma" not in text and "<mma.h>" not in text, path.name
