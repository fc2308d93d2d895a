"""Plain twins of K1, K2 (with and without the lse), K2r, K3, K4a and K4b
against the JAX Pallas kernels in interpret mode, and the autograd Function
against autograd through the exact-softmax oracle.

The JAX side runs ``flash_attention``, ``_fwd_impl`` and ``_bwd_impl`` as the
JAX package's own tests do on the CPU (Pallas interpret mode).  Inputs come
from one numpy generator and run in fp32.  Tolerance atol 2e-5: both sides
compute the same sums in fp32 in different orders, the JAX package's own
kernel-vs-XLA bar (``tests/test_flash_attention.py``); the backward gradients
reach about 6 in size and are held to atol 2e-5 with rtol 1e-5.  The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_kernels.py`` compare them with these twins there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import _bwd_impl, _fwd_impl, flash_attention
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.ops.attention import (
    attention_plain,
    make_attention_bias,
    multi_head_attention,
)

torch.set_num_threads(1)


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("S", [37, 65])
def test_k1_twin_matches_pallas_nc_kernel_with_kv_valid_tail(S):
    """The JAX ViT path pre-pads to 8 rows, zeroes the tail of k/v and
    declares ``kv_valid``; the port takes S as it is."""
    rng = np.random.default_rng(S)
    B, H, D = 2, 2, 32
    Sp = -(-S // 8) * 8
    q = _rand(rng, (B, Sp, H, D))
    k = _rand(rng, (B, Sp, H, D))
    v = _rand(rng, (B, Sp, H, D))
    k[:, S:] = 0.0
    v[:, S:] = 0.0
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, kv_valid=S, norm_bound=True)
    got = tfa.vit_attention(torch.from_numpy(q[:, :S]),
                            torch.from_numpy(k[:, :S]),
                            torch.from_numpy(v[:, :S]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :S], atol=2e-5)
    # The same call through the dispatch point, with the bound as the ViT
    # passes it.
    via = multi_head_attention(torch.from_numpy(q[:, :S]),
                               torch.from_numpy(k[:, :S]),
                               torch.from_numpy(v[:, :S]), causal=False,
                               norm_bound=True)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_k2_twin_matches_pallas_bound_kernel_with_gqa_and_dead_rows():
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, D = 3, 67, 4, 2, 16
    q = _rand(rng, (B, S, Hq, D))
    k = _rand(rng, (B, S, Hkv, D))
    v = _rand(rng, (B, S, Hkv, D))
    mask = np.ones((B, S), np.int32)
    mask[1, S - 23:] = 0            # ragged right padding
    mask[2, :4] = 0                 # left padding: rows 0-3 see no key
    mask[2, 50:] = 0
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          attention_mask=jnp.asarray(mask), causal=True,
                          norm_bound=True)
    got = tfa.decoder_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    assert np.all(got.numpy()[2, :4] == 0.0)
    assert np.all(np.asarray(ref)[2, :4] == 0.0)
    via = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               attention_mask=torch.from_numpy(mask),
                               causal=True, norm_bound=True)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_k2_twin_honours_q_offset():
    """A suffix of queries at a per-row offset sees the same keys as those
    rows of the full self-attention."""
    rng = np.random.default_rng(5)
    B, S, Hq, Hkv, D = 2, 40, 4, 2, 16
    q = torch.from_numpy(_rand(rng, (B, S, Hq, D)))
    k = torch.from_numpy(_rand(rng, (B, S, Hkv, D)))
    v = torch.from_numpy(_rand(rng, (B, S, Hkv, D)))
    full = tfa.decoder_attention_plain(q, k, v)
    off = torch.tensor([10, 25], dtype=torch.int32)
    for b in range(B):
        o = int(off[b])
        part = tfa.decoder_attention_plain(q[b:b + 1, o:o + 8], k[b:b + 1],
                                           v[b:b + 1], q_offset=off[b:b + 1])
        torch.testing.assert_close(part, full[b:b + 1, o:o + 8],
                                   atol=1e-6, rtol=1e-6)


def test_wrappers_raise_for_kernel_less_shapes_and_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    # Non-causal GQA has no bound kernel; without the bound it takes K3.
    with pytest.raises(NotImplementedError):
        multi_head_attention(q, k, k, causal=False, norm_bound=True)
    assert multi_head_attention(q, k, k, causal=False).shape == q.shape
    with pytest.raises(ValueError):
        multi_head_attention(q, q, q, impl="flash")
    with pytest.raises(ValueError, match="causal"):
        multi_head_attention(q, k, k, causal=False, norm_bound="rows")


# (B, Q, K, Hq, Hkv, D, q_offset): causal self-attention with Q = K = 70 (not
# a multiple of 64), and a per-row q_offset (each row's 45 queries start at
# its own position of the 70 keys).
BWD_CASES = {
    "self": (2, 70, 70, 4, 2, 32, None),
    "q_offset": (2, 45, 70, 4, 2, 32, (25, 10)),
}


def _bwd_inputs(case):
    B, Q, K, Hq, Hkv, D, off = BWD_CASES[case]
    rng = np.random.default_rng(len(case))
    q = _rand(rng, (B, Q, Hq, D))
    k = _rand(rng, (B, K, Hkv, D))
    v = _rand(rng, (B, K, Hkv, D))
    do = _rand(rng, (B, Q, Hq, D))
    mask = np.ones((B, K), np.int32)
    mask[0, K - 9:] = 0            # ragged right padding
    mask[1, :12] = 0               # left padding: early rows see no key
    mask[1, 60:] = 0
    off = None if off is None else np.asarray(off, np.int32)
    return q, k, v, do, mask, off


def _jax_forward_with_lse(q, k, v, mask, off):
    return _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask), None if off is None
                     else jnp.asarray(off), True, None, None, None, True,
                     True, norm_bound=True)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_k2_lse_twin_matches_pallas_bound_kernel(case):
    """Causal, ragged mask, dead rows, GQA, per-row q_offset: the output and
    the true lse (``DEAD_LSE`` on dead rows) of ``_fwd_bound_kernel`` with
    ``with_lse``, whose (B, Hq, 8, Qp) layout is read as lse[:, :, 0, :Q]."""
    q, k, v, _, mask, off = _bwd_inputs(case)
    Q = q.shape[1]
    out, lse = _jax_forward_with_lse(q, k, v, mask, off)
    lse = np.asarray(lse)[:, :, 0, :Q]
    got, got_lse = tfa.decoder_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), None if off is None else torch.from_numpy(off),
        return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-5)
    dead = lse >= tfa.DEAD_LSE * 0.5
    assert dead.sum() > 0
    np.testing.assert_array_equal(got_lse.numpy()[dead], lse[dead])
    np.testing.assert_allclose(got_lse.numpy()[~dead], lse[~dead], atol=2e-5)
    # Without the lse the twin returns the same output alone.
    alone = tfa.decoder_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), None if off is None else torch.from_numpy(off))
    np.testing.assert_array_equal(alone.numpy(), got.numpy())


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_k4_twins_match_pallas_backward_kernels(case):
    """``decoder_attention_backward_plain`` against ``_bwd_impl`` (K4a and
    K4b in interpret mode) from the same out, lse and dO; dq is exactly 0 on
    dead rows, dk and dv exactly 0 on masked keys."""
    q, k, v, do, mask, off = _bwd_inputs(case)
    Q = q.shape[1]
    out, lse = _jax_forward_with_lse(q, k, v, mask, off)
    want = _bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask), None if off is None
                     else jnp.asarray(off), out, lse, jnp.asarray(do), True,
                     None, None, None, True)
    T = torch.from_numpy
    toff = None if off is None else T(off)
    lse_n = np.ascontiguousarray(np.asarray(lse)[:, :, 0, :Q])
    got = tfa.decoder_attention_backward_plain(
        T(q), T(k), T(v), T(mask), toff, T(np.array(out)), T(lse_n), T(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5, err_msg=name)
    dq, dk, dv = (g.numpy() for g in got)
    dead = lse_n >= tfa.DEAD_LSE * 0.5  # (B, Hq, Q)
    assert np.all(dq.transpose(0, 2, 1, 3)[dead] == 0.0)
    assert np.all(dk[mask == 0] == 0.0) and np.all(dv[mask == 0] == 0.0)
    # The kernels' twin, asked for each kernel's part alone, gives the same
    # numbers as the driver's twin.
    delta = tfa.attention_delta(T(np.array(out)), T(do))
    args = (T(q), T(k), T(v), T(do), T(lse_n), delta, T(mask), toff)
    _, dk2, dv2 = tfa.decoder_attention_bwd_plain(*args, want_dq=False)
    dq2, none_k, none_v = tfa.decoder_attention_bwd_plain(*args,
                                                          want_dkdv=False)
    assert none_k is None and none_v is None
    for a, b in ((dq2, got[0]), (dk2, got[1]), (dv2, got[2])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_autograd_function_gradients_match_exact_softmax_autograd():
    """Through ``decoder_attention`` with q, k, v requiring grad (the
    Function: K2-with-lse twin forward, K4 twin backward) against autograd
    through ``attention_plain`` with the causal and padding bias.  Ragged
    right padding only: a row with no visible key is 0 here but uniform in
    the oracle."""
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 2, 67, 4, 2, 16
    q0, k0, v0 = (_rand(rng, s) for s in
                  ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    do = torch.from_numpy(_rand(rng, (B, S, Hq, D)))
    mask = np.ones((B, S), np.int32)
    mask[1, S - 20:] = 0
    mask_t = torch.from_numpy(mask)
    grads = []
    for path in ("function", "oracle"):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q0, k0, v0))
        if path == "function":
            out = tfa.decoder_attention(q, k, v, mask_t)
        else:
            bias = make_attention_bias(mask_t, S, S, True, device=q.device)
            out = attention_plain(q, k, v, bias=bias)
        grads.append((out,) + torch.autograd.grad(out, (q, k, v), do))
    for name, a, b in zip(("out", "dq", "dk", "dv"), *grads):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5, rtol=1e-5, err_msg=name)
    # Without grad the same call takes K2's path and builds no graph.
    with torch.no_grad():
        plain = tfa.decoder_attention(*(torch.from_numpy(a)
                                        for a in (q0, k0, v0)), mask_t)
    np.testing.assert_array_equal(plain.numpy(), grads[0][0].detach().numpy())


# K3 and K2r cases, (B, Q, K, Hq, Hkv, D, q_offset, mask kind, causal):
# causal GQA self-attention; odd Q = K; left padding (the first keys of row
# 1 masked, so its first rows see no key); the continuation shape (Q < K,
# per-row q_offset, the cache masked past each row's suffix); non-causal
# masked (K3 only: K2r needs causality).
EXACT_CASES = {
    "causal_gqa": (2, 64, 64, 4, 2, 16, None, None, True),
    "odd": (2, 37, 37, 4, 2, 16, None, "right", True),
    "left_padded": (3, 45, 45, 4, 2, 16, None, "left", True),
    "continuation": (2, 19, 70, 4, 2, 16, (40, 23), "cache", True),
    "non_causal_masked": (2, 33, 41, 4, 2, 16, None, "right", False),
}


def _exact_inputs(case):
    B, Q, K, Hq, Hkv, D, off, kind, causal = EXACT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = _rand(rng, (B, Q, Hq, D))
    k = _rand(rng, (B, K, Hkv, D))
    v = _rand(rng, (B, K, Hkv, D))
    mask = None if kind is None else np.ones((B, K), np.int32)
    if kind == "right":
        mask[1, K - 9:] = 0
    elif kind == "left":
        mask[1, :7] = 0
        mask[2, :3] = 0
        mask[2, K - 5:] = 0
    elif kind == "cache":  # valid: each row's prefix and its Q-row suffix
        for b, o in enumerate(off):
            mask[b, o + Q:] = 0
        mask[1, :2] = 0
    off = None if off is None else np.asarray(off, np.int32)
    return q, k, v, mask, off, causal


def _both(case, norm_bound):
    q, k, v, mask, off, causal = _exact_inputs(case)
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    ref = np.asarray(flash_attention(J(q), J(k), J(v), attention_mask=J(mask),
                                     causal=causal, q_offset=J(off),
                                     norm_bound=norm_bound))
    fn = tfa.exact_attention if not norm_bound else tfa.decoder_attention_rows
    kw = {"causal": causal} if not norm_bound else {}
    got = fn(T(q), T(k), T(v), T(mask), T(off), **kw)
    return got.numpy(), ref, mask


@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_k3_twin_matches_pallas_exact_kernel(case):
    """``exact_attention`` (the K3 twin on the CPU) against ``_fwd_kernel``
    through ``flash_attention(..., norm_bound=False)``; dead rows 0 in
    both."""
    got, ref, mask = _both(case, False)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    if case == "left_padded":
        assert np.all(got[1, :7] == 0.0) and np.all(ref[1, :7] == 0.0)


@pytest.mark.parametrize("case", sorted(c for c in EXACT_CASES
                                        if EXACT_CASES[c][-1]))
def test_k2r_twin_matches_pallas_row_bound_kernel(case):
    """``decoder_attention_rows`` (the K2r twin) against
    ``_fwd_bound_kernel(row_bound=True)`` through
    ``flash_attention(..., norm_bound="rows")``."""
    got, ref, _ = _both(case, "rows")
    np.testing.assert_allclose(got, ref, atol=2e-5)
    if case == "left_padded":
        assert np.all(got[1, :7] == 0.0) and np.all(ref[1, :7] == 0.0)


def test_k2r_prefix_rows_are_bit_identical():
    """Mirror of the JAX package's row-bound determinism test: the per-row
    bound of a prefix row depends on the keys at or before it, so a
    prefix-only call and a full-sequence call give bit-identical bounds and
    rows for the prefix."""
    rng = np.random.default_rng(13)
    S, P, Hq, Hkv, D = 96, 64, 8, 2, 32
    qf, kf, vf = (torch.from_numpy(_rand(rng, s)) for s in
                  ((1, S, Hq, D), (1, S, Hkv, D), (1, S, Hkv, D)))
    assert torch.equal(tfa.row_key_bound(kf, None, None, S, Hq)[..., :P],
                       tfa.row_key_bound(kf[:, :P], None, None, P, Hq))
    full = tfa.decoder_attention_rows(qf, kf, vf)
    prefix = tfa.decoder_attention_rows(qf[:, :P], kf[:, :P], vf[:, :P])
    assert torch.equal(full[:, :P], prefix)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(qf, kf, vf, causal=False, norm_bound="rows")


def _vit_padded_inputs(S, seed):
    """q, k, v and dO padded to a multiple of 8 rows as the JAX ViT pads
    them (``vit.py:250-256``): k and v zero on the tail (the ``kv_valid``
    contract, ``vit.py:184-190``), dO zero there too; q's tail random."""
    rng = np.random.default_rng(seed)
    B, H, D = 2, 2, 32
    Sp = -(-S // 8) * 8
    q, k, v, do = (_rand(rng, (B, Sp, H, D)) for _ in range(4))
    k[:, S:] = 0.0
    v[:, S:] = 0.0
    do[:, S:] = 0.0
    return q, k, v, do


def _jax_nc_forward_with_lse(q, k, v, S):
    return _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                     None, False, None, None, None, True, True, kv_valid=S,
                     norm_bound=True)


@pytest.mark.parametrize("S", [37, 65])
def test_k1_lse_twin_matches_pallas_nc_kernel(S):
    """The K1-lse twin on S rows against ``_fwd_nc_kernel(with_lse=True)``
    on the 8-padded rows with ``kv_valid = S``: the output and the true lse
    of the real rows (its (B, H, 8, Sp) layout read as lse[:, :, 0, :S]).
    No row underflows here, so the two lse rules (the kernel's DEAD_LSE,
    the TPU's m + log(1e-30)) do not differ."""
    q, k, v, _ = _vit_padded_inputs(S, S)
    out, lse = _jax_nc_forward_with_lse(q, k, v, S)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, :S]))  # noqa: E731
    got, got_lse = tfa.vit_attention_plain(T(q), T(k), T(v), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out)[:, :S], atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :, 0, :S],
                               atol=2e-5)
    assert got_lse.max().item() < tfa.DEAD_LSE * 0.5
    # Without the lse the twin returns the same output alone.
    alone = tfa.vit_attention_plain(T(q), T(k), T(v))
    np.testing.assert_array_equal(alone.numpy(), got.numpy())


@pytest.mark.parametrize("S", [37, 65])
def test_k4_nc_twin_matches_pallas_backward_kernels(S):
    """``vit_attention_bwd_plain`` (the K4 nc twin) on S rows against
    ``_bwd_impl(causal=False)`` (K4a/K4b non-causal, in interpret mode) on
    the padded rows, from the JAX forward's out and lse; rows [:S] of dq,
    dk and dv.  The JAX backward lets the zero pad keys into p; they add
    nothing to the real rows' gradients, since k = v = 0 and dO = 0 there."""
    q, k, v, do = _vit_padded_inputs(S, S + 1)
    out, lse = _jax_nc_forward_with_lse(q, k, v, S)
    want = _bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                     None, out, lse, jnp.asarray(do), False, None, None, None,
                     True)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, :S]))  # noqa: E731
    lse_n = torch.from_numpy(np.ascontiguousarray(np.asarray(lse)[:, :, 0, :S]))
    out_t = T(np.asarray(out))
    got = tfa.vit_attention_backward_plain(T(q), T(k), T(v), out_t, lse_n,
                                           T(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :S], atol=2e-5,
                                   rtol=1e-5, err_msg=name)
    # Each kernel's part alone gives the same numbers.
    delta = tfa.attention_delta(out_t, T(do))
    args = (T(q), T(k), T(v), T(do), lse_n, delta)
    dq, none_k, none_v = tfa.vit_attention_bwd_plain(*args, want_dkdv=False)
    none_q, dk, dv = tfa.vit_attention_bwd_plain(*args, want_dq=False)
    assert none_k is None and none_v is None and none_q is None
    for a, b in ((dq, got[0]), (dk, got[1]), (dv, got[2])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_vit_autograd_function_matches_exact_softmax_autograd():
    """Through ``vit_attention`` with q, k, v requiring grad (the Function:
    K1-lse twin forward, K4 nc twin backward) against autograd through
    ``attention_plain`` with no bias, at S = 37; q, k and v are views into
    one qkv tensor, as the ViT makes them."""
    rng = np.random.default_rng(9)
    B, S, H, D = 2, 37, 2, 32
    qkv0 = _rand(rng, (B, S, 3 * H * D))
    do = torch.from_numpy(_rand(rng, (B, S, H, D)))
    results = []
    for path in ("function", "oracle"):
        qkv = torch.from_numpy(qkv0).requires_grad_()
        q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))
        fn = tfa.vit_attention if path == "function" else attention_plain
        out = fn(q, k, v)
        results.append((out,) + torch.autograd.grad(out, qkv, do))
    for name, a, b in zip(("out", "dqkv"), *results):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5, rtol=1e-5, err_msg=name)
    # Without grad the same call takes K1's path and builds no graph.
    qkv = torch.from_numpy(qkv0).requires_grad_()
    q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    with torch.no_grad():
        plain = tfa.vit_attention(q, k, v)
    assert plain.grad_fn is None
    np.testing.assert_array_equal(plain.numpy(),
                                  results[0][0].detach().numpy())
