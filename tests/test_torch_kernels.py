"""The CUDA kernels against their plain twins, on a card.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda -q

(``--noconftest`` skips the JAX device setup of ``tests/conftest.py``.)
Without a card every test here skips.  Tolerances, the bounds
``chip_smoke.py`` states: each bf16 output (K1, K2, K2r, K3, K4a's dk and dv,
K4b's dq, K4 nc's dq, dk and dv, B1, B2, B3) to max|kernel - plain| /
max|plain| <= 2**-7, one bf16 ulp of the largest output at worst; K1's,
K2's and K3's fp32 lse to max|kernel - plain| <= LSE_TOL; the pre-passes
(K2r's, and K1's and K2's) to relative 2e-6.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


LSE_TOL = 1e-5


def _assert_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -7 * want.float().abs().max().item(), err


def _decoder_inputs(g, dev, B=2, T=130, Q=None):
    q = _randn(g, dev, B, Q or T, 4, 128)
    k = _randn(g, dev, B, T, 2, 128)
    v = _randn(g, dev, B, T, 2, 128)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[1, :3] = 0
    mask[1, 100:] = 0
    return q, k, v, mask


@pytest.mark.cuda
def test_kernels_match_twins_at_odd_shapes(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # K1 on strided views into one qkv tensor, S not a multiple of 64.
    B, S, H, D = 2, 77, 4, 64
    q, k, v = (t.view(B, S, H, D) for t in
               _randn(g, cuda_device, B, S, 3 * H * D).split(H * D, dim=-1))
    before = kernels.launch_counts["vit_attention"]
    got = fa.vit_attention(q, k, v)
    assert kernels.launch_counts["vit_attention"] == before + 1
    _assert_close(got, fa.vit_attention_plain(q, k, v))
    # K2: GQA, ragged mask, dead rows, T not a multiple of 64.
    B, T = 2, 130
    q = _randn(g, cuda_device, B, T, 4, 128)
    k = _randn(g, cuda_device, B, T, 2, 128)
    v = _randn(g, cuda_device, B, T, 2, 128)
    mask = torch.ones(B, T, dtype=torch.int32, device=cuda_device)
    mask[1, :3] = 0
    mask[1, 100:] = 0
    got = fa.decoder_attention(q, k, v, mask)
    _assert_close(got, fa.decoder_attention_plain(q, k, v, mask))
    assert got[1, :3].abs().max().item() == 0.0
    # A per-row q_offset: a suffix of queries matches those rows of the full
    # self-attention.
    off = torch.tensor([40, 90], dtype=torch.int32, device=cuda_device)
    for b in range(B):
        o = int(off[b])
        part = fa.decoder_attention(q[b:b + 1, o:o + 33].contiguous(),
                                    k[b:b + 1], v[b:b + 1], mask[b:b + 1],
                                    q_offset=off[b:b + 1])
        _assert_close(part, got[b:b + 1, o:o + 33])


def _qkv_views(g, dev, B, S, H=4, D=64):
    """q, k, v as strided views into one (B, S, 3 H D) tensor, as the ViT
    makes them."""
    return tuple(t.view(B, S, H, D) for t in
                 _randn(g, dev, B, S, 3 * H * D).split(H * D, dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [65, 1025])
def test_k1_lse_and_k4_nc_match_twins(cuda_device, S):
    """K1 with the lse, K4 nc dK/dV and K4 nc dQ against their twins on qkv
    views, at S = 65 and the 448 px tile's 1025 (one real row in the last
    q tile and in the last kv tile)."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = _qkv_views(g, cuda_device, 2, S)
    scale = 64 ** -0.5
    before = dict(kernels.launch_counts)
    out, lse = kernels.vit_attention(q, k, v, fa.key_norm_max(k), scale,
                                     with_lse=True)
    ref, ref_lse = fa.vit_attention_plain(q, k, v, return_lse=True)
    _assert_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    dout = _randn(g, cuda_device, *q.shape)
    delta = fa.attention_delta(ref, dout)
    dk, dv = kernels.vit_attention_bwd_dkdv(q, k, v, dout, ref_lse, delta,
                                            scale)
    dq = kernels.vit_attention_bwd_dq(q, k, v, dout, ref_lse, delta, scale)
    for name in ("vit_attention", "vit_attention_lse",
                 "vit_attention_bwd_dkdv", "vit_attention_bwd_dq"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    rdq, rdk, rdv = fa.vit_attention_bwd_plain(q, k, v, dout, ref_lse, delta)
    _assert_close(dk, rdk)
    _assert_close(dv, rdv)
    _assert_close(dq, rdq)


@pytest.mark.cuda
def test_vit_autograd_function_launches_k1_lse_and_k4_nc(cuda_device):
    """With the qkv tensor requiring grad, ``vit_attention`` runs K1 with the
    lse forward and K4 nc backward, and its gradient matches the twins';
    without grad it launches K1 alone and builds no graph."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    B, S, H, D = 2, 77, 4, 64
    qkv = _randn(g, cuda_device, B, S, 3 * H * D).requires_grad_()
    q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    dout = _randn(g, cuda_device, B, S, H, D)
    before = dict(kernels.launch_counts)
    out = fa.vit_attention(q, k, v)
    (grad,) = torch.autograd.grad(out, qkv, dout)
    for name in ("vit_attention", "vit_attention_lse",
                 "vit_attention_bwd_dkdv", "vit_attention_bwd_dq"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    qd, kd, vd = (t.detach() for t in (q, k, v))
    ref, ref_lse = fa.vit_attention_plain(qd, kd, vd, return_lse=True)
    want = fa.vit_attention_backward_plain(qd, kd, vd, ref, ref_lse, dout)
    _assert_close(out, ref)
    for got, w in zip(grad.view(B, S, 3, H, D).unbind(2), want):
        _assert_close(got, w)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        plain = fa.vit_attention(q, k, v)
    assert plain.grad_fn is None
    assert kernels.launch_counts["vit_attention"] == before["vit_attention"] + 1
    assert (kernels.launch_counts["vit_attention_lse"]
            == before["vit_attention_lse"])


@pytest.mark.cuda
def test_kernel_wrappers_raise_instead_of_falling_back(cuda_device):
    q = torch.zeros(1, 8, 4, 64, device=cuda_device)  # fp32: no kernel
    with pytest.raises(ValueError, match="bfloat16"):
        fa.vit_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.vit_attention(q, q, q)
    # K4 nc takes a dense dout only.
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v = _qkv_views(g, cuda_device, 1, 70)
    lse = torch.zeros(1, 4, 70, device=cuda_device)
    dout = _randn(g, cuda_device, 1, 70, 8, 64)[:, :, :4]
    with pytest.raises(ValueError, match="dense"):
        kernels.vit_attention_bwd_dq(q, k, v, dout, lse, lse, 0.125)


@pytest.mark.cuda
def test_k2_lse_and_k4_match_twins(cuda_device):
    """K2 with the lse, K4a and K4b against their twins: GQA, a ragged mask
    with dead rows, T not a multiple of 64, and a per-row q_offset."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for Q, off in ((None, None), (75, (40, 55))):
        q, k, v, mask = _decoder_inputs(g, cuda_device, Q=Q)
        off = (None if off is None else
               torch.tensor(off, dtype=torch.int32, device=cuda_device))
        scale = 128 ** -0.5
        kmax = fa.key_norm_max(k, mask)
        before = dict(kernels.launch_counts)
        out, lse = kernels.decoder_attention(q, k, v, mask, kmax, off, scale,
                                             with_lse=True)
        ref, ref_lse = fa.decoder_attention_plain(q, k, v, mask, off,
                                                  return_lse=True)
        _assert_close(out, ref)
        dead = ref_lse >= fa.DEAD_LSE * 0.5
        assert dead.any() or off is not None  # offsets pass row 1's pad
        assert torch.equal(lse[dead], ref_lse[dead])
        assert (lse - ref_lse)[~dead].abs().max().item() <= LSE_TOL
        dout = _randn(g, cuda_device, *q.shape)
        delta = fa.attention_delta(ref, dout)
        dk, dv = kernels.decoder_attention_bwd_dkdv(q, k, v, dout, ref_lse,
                                                    delta, mask, off, scale)
        dq = kernels.decoder_attention_bwd_dq(q, k, v, dout, ref_lse, delta,
                                              mask, off, scale)
        for name in ("decoder_attention", "decoder_attention_bwd_dkdv",
                     "decoder_attention_bwd_dq"):
            assert kernels.launch_counts[name] == before[name] + 1
        rdq, rdk, rdv = fa.decoder_attention_bwd_plain(q, k, v, dout, ref_lse,
                                                       delta, mask, off)
        _assert_close(dk, rdk)
        _assert_close(dv, rdv)
        _assert_close(dq, rdq)
        assert dk[mask == 0].abs().max().item() == 0.0
        assert dv[mask == 0].abs().max().item() == 0.0
        assert not dq.transpose(1, 2)[dead].any()


@pytest.mark.cuda
def test_autograd_function_launches_k2_lse_and_k4(cuda_device):
    """With q, k, v requiring grad, ``decoder_attention`` runs K2 with the
    lse forward and K4a/K4b backward, and its gradients match the twins'."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, mask = _decoder_inputs(g, cuda_device)
    dout = _randn(g, cuda_device, *q.shape)
    before = dict(kernels.launch_counts)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.decoder_attention(*leaves, mask)
    grads = torch.autograd.grad(out, leaves, dout)
    for name in ("decoder_attention", "decoder_attention_bwd_dkdv",
                 "decoder_attention_bwd_dq"):
        assert kernels.launch_counts[name] == before[name] + 1
    ref, ref_lse = fa.decoder_attention_plain(q, k, v, mask, return_lse=True)
    want = fa.decoder_attention_backward_plain(q, k, v, mask, None, ref,
                                               ref_lse, dout)
    _assert_close(out, ref)
    for got, w in zip(grads, want):
        _assert_close(got, w)


def _left_padded(g, dev, B=2, T=150, Q=None):
    """Judge-like inputs: row 1 left-padded (its first 37 keys masked, so
    its first 37 queries are dead) and right-padded from key 140."""
    q, k, v, mask = _decoder_inputs(g, dev, B=B, T=T, Q=Q)
    mask[1] = 1
    mask[1, :37] = 0
    mask[1, 140:] = 0
    return q, k, v, mask


@pytest.mark.cuda
def test_k3_and_k2r_match_twins_at_odd_shapes(cuda_device):
    """K3 (causal and not) and K2r against their twins: GQA, T not a
    multiple of 64, leading dead rows, and the continuation shape (Q < K,
    per-row q_offset over a cache masked past each row's suffix)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, mask = _left_padded(g, cuda_device)
    for name, kern, plain in (
            ("exact_attention", fa.exact_attention, fa.exact_attention_plain),
            ("decoder_attention_rows", fa.decoder_attention_rows,
             fa.decoder_attention_rows_plain)):
        before = kernels.launch_counts[name]
        got = kern(q, k, v, mask)
        assert kernels.launch_counts[name] == before + 1
        _assert_close(got, plain(q, k, v, mask))
        assert got[1, :37].abs().max().item() == 0.0
        # Continuation: 45 queries at slots off..off+44 over the 150-slot
        # cache, slots past each row's suffix not yet valid.
        off = torch.tensor([61, 90], dtype=torch.int32, device=cuda_device)
        cmask = mask.clone()
        for b in range(2):
            cmask[b, int(off[b]) + 45:] = 0
        qs = _randn(g, cuda_device, 2, 45, 4, 128)
        got = kern(qs, k, v, cmask, off)
        _assert_close(got, plain(qs, k, v, cmask, off))
    got = fa.exact_attention(q, k, v, mask, causal=False)
    _assert_close(got, fa.exact_attention_plain(q, k, v, mask, causal=False))
    # The Hopper template's tile edges: q tiles of 128 rows (two warpgroups
    # of 64), kv tiles of 128 keys with K ragged by one key past the second;
    # GQA and MHA; negative, zero and positive offsets; a left-padded row and
    # a fully masked batch row, whose dead rows must be exactly 0.
    K = 2 * 128 + 1
    for Hq, Hkv in ((16, 8), (16, 16)):
        k = _randn(g, cuda_device, 2, K, Hkv, 128)
        v = _randn(g, cuda_device, 2, K, Hkv, 128)
        for dead_row in (False, True):
            mask = torch.ones(2, K, dtype=torch.int32, device=cuda_device)
            mask[0, 200:] = 0
            mask[1, :37] = 0
            if dead_row:
                mask[1] = 0
            for Q in (1, 63, 64, 127, 129, 200):
                q = _randn(g, cuda_device, 2, Q, Hq, 128)
                for o in (None, -70, 0, max(K - Q, 9)):
                    off = (None if o is None else torch.full(
                        (2,), o, dtype=torch.int32, device=cuda_device))
                    dead = ~fa._decoder_allowed(q, k, mask, off).any(-1)
                    for kern, plain in (
                            (fa.exact_attention, fa.exact_attention_plain),
                            (fa.decoder_attention_rows,
                             fa.decoder_attention_rows_plain)):
                        got = kern(q, k, v, mask, off)
                        _assert_close(got, plain(q, k, v, mask, off))
                        assert not got[dead].any(), (Hq, Hkv, Q, o)
                got = fa.exact_attention(q, k, v, mask, causal=False)
                _assert_close(got, fa.exact_attention_plain(q, k, v, mask,
                                                            causal=False))
                if dead_row:
                    assert not got[1].any()


@pytest.mark.cuda
def test_key_norm_cummax_matches_twin(cuda_device):
    """K2r's pre-pass (the key-norm partial pass and its scan) against its
    twin: one key, K past a 128-key chunk, at 1024 and an odd 3001, k as a
    strided view (a cache's (B, K, Hkv, D) slots), a mask with holes and
    none; norms summed exactly in double against the twin's fp32 sums, so
    relative 2e-6, and the running max exact in structure (never
    decreasing along K)."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    for K, with_mask in ((1, True), (129, False), (1024, True), (3001, True)):
        kv = _randn(g, cuda_device, 2, K, 2, 8, 128)
        k = kv[:, :, 0]  # row stride 2 * Hkv * D
        mask = None
        if with_mask:
            mask = (torch.rand(2, K, generator=g, device=cuda_device) > 0.3
                    ).to(torch.int32)
            mask[1, : K // 2] = 0
        before = kernels.launch_counts["key_norm_cummax"]
        got = kernels.key_norm_cummax(k, mask)
        assert kernels.launch_counts["key_norm_cummax"] == before + 1
        want = fa.key_norm_cummax(k, mask)
        assert got.shape == want.shape == (2, 8, K)
        assert torch.allclose(got, want, rtol=2e-6, atol=0.0)
        assert bool((got[..., 1:] >= got[..., :-1]).all())


@pytest.mark.cuda
def test_k2r_prefix_rows_are_bit_identical(cuda_device):
    """K2r's bound depends on the tokens at or before a row, so the rows of
    a prefix-only prefill equal those of a full-prompt prefill bit for bit
    (the TPU kernel's property, ``flash_attention.py:347-358``)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, mask = _left_padded(g, cuda_device, T=200)
    P = 131
    full = fa.decoder_attention_rows(q, k, v, mask)
    part = fa.decoder_attention_rows(q[:, :P].contiguous(),
                                     k[:, :P].contiguous(),
                                     v[:, :P].contiguous(),
                                     mask[:, :P].contiguous())
    assert torch.equal(part, full[:, :P])


@pytest.mark.cuda
def test_k3_and_k2r_wrappers_raise_instead_of_falling_back(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, mask = _left_padded(g, cuda_device)
    for kern in (fa.exact_attention, fa.decoder_attention_rows,
                 fa.exact_attention_with_lse):
        with pytest.raises(ValueError, match="bfloat16"):
            kern(q.float(), k.float(), v.float(), mask)
        # A CPU/CUDA mix raises in the checks, or in K2r's bound before
        # them; neither takes the twin.
        with pytest.raises((ValueError, RuntimeError)):
            kern(q, k.cpu(), v, mask)
        with pytest.raises((ValueError, RuntimeError)):
            kern(q, k, v, mask.cpu())
    # K2r and the ring's K3 lse have no backward of their own; K3 takes
    # _ExactAttention (K3 lse, K4a, K4b).
    for kern in (fa.decoder_attention_rows, fa.exact_attention_with_lse):
        with pytest.raises(NotImplementedError, match="backward"):
            kern(q.clone().requires_grad_(), k, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [37, 65, 129, 1025])
def test_k2_and_k1_on_the_sm90_template_match_twins(cuda_device, S):
    """K2 and K1 without the lse (the wgmma/TMA template, their kmax from
    the pre-pass) against their twins at odd lengths: K2 with GQA, a
    ragged mask (row 1 left-padded by 7 keys and right-padded from 4/5 of
    S) whose dead rows must be exactly 0, and a per-row q_offset over the
    whole cache; K1 on qkv views, S one row past a q tile at 65, 129 and
    1025.  Each op launches its kernel and one pre-pass."""
    g = torch.Generator(device=cuda_device).manual_seed(20 + S)
    q = _randn(g, cuda_device, 2, S, 16, 128)
    k = _randn(g, cuda_device, 2, S, 8, 128)
    v = _randn(g, cuda_device, 2, S, 8, 128)
    mask = torch.ones(2, S, dtype=torch.int32, device=cuda_device)
    mask[1, :7] = 0
    mask[1, 4 * S // 5:] = 0
    before = dict(kernels.launch_counts)
    got = fa.decoder_attention(q, k, v, mask)
    for name in ("decoder_attention", "key_norm_max"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    assert kernels.launch_counts["decoder_attention_lse"] == before[
        "decoder_attention_lse"]
    _assert_close(got, fa.decoder_attention_plain(q, k, v, mask))
    dead = ~fa._decoder_allowed(q, k, mask, None).any(-1)
    assert dead.sum().item() == 7 and not got[dead].any()
    # A suffix of 33 queries at each row's own offset over the S slots.
    n = min(33, S - 1)
    off = torch.tensor([S - n, S // 3], dtype=torch.int32,
                       device=cuda_device)
    qs = _randn(g, cuda_device, 2, n, 16, 128)
    got = fa.decoder_attention(qs, k, v, mask, off)
    _assert_close(got, fa.decoder_attention_plain(qs, k, v, mask, off))
    dead = ~fa._decoder_allowed(qs, k, mask, off).any(-1)
    assert not got[dead].any()
    # K1 on views into one qkv tensor, 16 heads of 64.
    q, k, v = _qkv_views(g, cuda_device, 2, S, H=16)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        got = fa.vit_attention(q, k, v)
    for name in ("vit_attention", "key_norm_max"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    _assert_close(got, fa.vit_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [63, 64, 65, 127, 128, 129, 191, 192, 193,
                               1025])
def test_k2_lse_and_k1_lse_on_the_sm90_template_match_twins(cuda_device, S):
    """K2 lse and K1 lse (the Hopper template's lse epilogue) against their
    twins at the template's tile edges: K2 with GQA and row 1 left-padded
    by 7 keys (its first 7 rows dead: output exactly 0, lse exactly
    DEAD_LSE), K1 on qkv views; live rows' lse to LSE_TOL.  On the same
    inputs and kmax the output with the lse is bit-equal to the output
    without it."""
    g = torch.Generator(device=cuda_device).manual_seed(40 + S)
    q = _randn(g, cuda_device, 2, S, 16, 128)
    k = _randn(g, cuda_device, 2, S, 8, 128)
    v = _randn(g, cuda_device, 2, S, 8, 128)
    mask = torch.ones(2, S, dtype=torch.int32, device=cuda_device)
    mask[1, :7] = 0
    scale = 128 ** -0.5
    kmax = kernels.key_norm_max(k, mask)
    before = dict(kernels.launch_counts)
    out, lse = kernels.decoder_attention(q, k, v, mask, kmax, None, scale,
                                         with_lse=True)
    for name in ("decoder_attention", "decoder_attention_lse"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    ref, ref_lse = fa.decoder_attention_plain(q, k, v, mask, return_lse=True)
    _assert_close(out, ref)
    dead = ~fa._decoder_allowed(q, k, mask, None).any(-1)  # (B, Q)
    assert dead.sum().item() == 7 and not out[dead].any()
    dead = dead[:, None, :].expand_as(lse)
    assert bool((lse[dead] == fa.DEAD_LSE).all())
    assert bool((ref_lse[dead] == fa.DEAD_LSE).all())
    assert (lse - ref_lse)[~dead].abs().max().item() <= LSE_TOL
    alone = kernels.decoder_attention(q, k, v, mask, kmax, None, scale)
    assert torch.equal(out, alone)
    q, k, v = _qkv_views(g, cuda_device, 2, S, H=16)
    kmax = kernels.key_norm_max(k)
    before = dict(kernels.launch_counts)
    out, lse = kernels.vit_attention(q, k, v, kmax, 64 ** -0.5,
                                     with_lse=True)
    for name in ("vit_attention", "vit_attention_lse"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    ref, ref_lse = fa.vit_attention_plain(q, k, v, return_lse=True)
    _assert_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    assert torch.equal(out, kernels.vit_attention(q, k, v, kmax, 64 ** -0.5))


@pytest.mark.cuda
def test_k1_lse_marks_rows_whose_sum_underflows_dead(cuda_device):
    """Where one key 400 times longer than the rest puts the bound
    thousands of nats above every score, every sum underflows: K1 lse gives
    an output of exactly 0 and the lse DEAD_LSE on every row, as its twin
    does."""
    g = torch.Generator(device=cuda_device).manual_seed(30)
    q, k, v = _qkv_views(g, cuda_device, 1, 130)
    k[0, 5] = 400.0
    out, lse = kernels.vit_attention(q, k, v, kernels.key_norm_max(k),
                                     64 ** -0.5, with_lse=True)
    ref, ref_lse = fa.vit_attention_plain(q, k, v, return_lse=True)
    assert torch.isfinite(out).all() and not out.any() and not ref.any()
    assert bool((lse == fa.DEAD_LSE).all())
    assert bool((ref_lse == fa.DEAD_LSE).all())


@pytest.mark.cuda
def test_k1_floor_gives_zero_not_nan_where_the_bound_underflows(cuda_device):
    """One key 400 times longer than the rest puts the bound thousands of
    nats above every score: every sum underflows to 0, which the floor
    (the twin's jnp.maximum(l, 1e-30) rule) turns into an output of
    exactly 0 in both, never NaN."""
    g = torch.Generator(device=cuda_device).manual_seed(30)
    q, k, v = _qkv_views(g, cuda_device, 1, 130)
    k[0, 5] = 400.0
    got = fa.vit_attention(q, k, v)
    want = fa.vit_attention_plain(q, k, v)
    assert torch.isfinite(got).all()
    _assert_close(got, want)


@pytest.mark.cuda
def test_key_norm_max_matches_twin(cuda_device):
    """The pre-pass against its twin at D = 64 (qkv views, row stride 3 H D)
    and 128 (a cache's strided slots), K below, at and past one 32-key
    chunk, the ViT's 1025 and the long clip's 53,722, with a mask with
    holes, a fully masked row (bound 0) and none.  The kernel sums the
    squares exactly in double, the twin in fp32 in torch's order: relative
    2e-6."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    for D, K, with_mask in ((64, 1025, False), (64, 31, False),
                            (128, 1, True), (128, 32, True),
                            (128, 3001, True), (128, 53722, True)):
        if D == 64:
            k = _qkv_views(g, cuda_device, 2, K, H=16)[1]
        else:
            k = _randn(g, cuda_device, 2, K, 2, 8, 128)[:, :, 1]
        # Varied norms, so the max is one key's; in place, keeping the view.
        k.mul_((1.0 + 3.0 * torch.rand(2, K, k.shape[2], 1, generator=g,
                                       device=cuda_device)).to(k.dtype))
        mask = None
        if with_mask:
            mask = (torch.rand(2, K, generator=g, device=cuda_device) > 0.3
                    ).to(torch.int32)
            mask[1] = 0
        before = kernels.launch_counts["key_norm_max"]
        got = kernels.key_norm_max(k, mask)
        assert kernels.launch_counts["key_norm_max"] == before + 1
        want = fa.key_norm_max(k, mask)
        assert got.shape == want.shape == (2, k.shape[2])
        assert torch.allclose(got, want, rtol=2e-6, atol=0.0), (D, K)
        if with_mask:
            assert not got[1].any()


@pytest.mark.cuda
def test_k1_k2_and_pre_pass_wrappers_raise_instead_of_falling_back(
        cuda_device):
    """The sm90 K1 and K2 and the pre-pass refuse a wrong head dim, a
    non-dense head, a misaligned view and a CPU/CUDA mix; none takes its
    twin."""
    g = torch.Generator(device=cuda_device).manual_seed(32)
    q, k, v = _qkv_views(g, cuda_device, 1, 70)
    kmax = kernels.key_norm_max(k)
    qd, kd, vd, mask = _decoder_inputs(g, cuda_device)
    dmax = kernels.key_norm_max(kd, mask)
    wide = _randn(g, cuda_device, 1, 70, 4, 128)
    with pytest.raises(ValueError, match="head dim"):
        kernels.vit_attention(wide, wide, wide, kmax, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        kernels.decoder_attention(q, k, v, None, kmax, None, 0.125)
    # 72, 80 and 96 are built (SigLIP, the Qwen2-VL tower, Phi-3); 56 is
    # not.
    with pytest.raises(ValueError, match="head dim"):
        kernels.key_norm_max(_randn(g, cuda_device, 1, 70, 4, 56))
    # Non-dense heads: every other head of a wider tensor.
    sparse = _randn(g, cuda_device, 1, 70, 8, 64)[:, :, ::2]
    with pytest.raises(ValueError, match="dense"):
        kernels.vit_attention(sparse, sparse, sparse, kmax, 0.125)
    with pytest.raises(ValueError, match="dense"):
        kernels.key_norm_max(sparse)
    # A view whose rows start 8 bytes off a 16-byte boundary.
    flat = _randn(g, cuda_device, 1, 70 * 4 * 64 + 4)
    bad = flat[:, 4:].view(1, 70, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        kernels.vit_attention(bad, bad, bad, kmax, 0.125)
    with pytest.raises(ValueError, match="aligned"):
        kernels.key_norm_max(bad)
    # CPU/CUDA mixes.
    with pytest.raises(ValueError):
        kernels.vit_attention(q, k.cpu(), v, kmax, 0.125)
    with pytest.raises(ValueError):
        kernels.vit_attention(q, k, v, kmax.cpu(), 0.125)
    with pytest.raises(ValueError):
        kernels.decoder_attention(qd, kd, vd, mask.cpu(), dmax, None, 0.125)
    with pytest.raises(ValueError):
        kernels.key_norm_max(kd, mask.cpu())
    with pytest.raises((ValueError, RuntimeError)):
        fa.decoder_attention(qd, kd.cpu(), vd, mask)
    with pytest.raises((ValueError, RuntimeError)):
        fa.vit_attention(q, k.cpu(), v)


def _ring_chunk(g, dev, L=128):
    """One shard's L queries and a chunk's L keys.  Row 1 masks the
    chunk's first 70 keys: at offset 0 its rows 0-69 see no key, and rows
    70-127 see none in the first kv tile and some in the second (K3's
    rescale from kNegInf)."""
    q = _randn(g, dev, 2, L, 4, 128)
    k = _randn(g, dev, 2, L, 2, 128)
    v = _randn(g, dev, 2, L, 2, 128)
    mask = torch.ones(2, L, dtype=torch.int32, device=dev)
    mask[0, L - 9:] = 0
    mask[1, :70] = 0
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_k3_lse_and_k4_match_twins_at_ring_offsets(cuda_device, causal):
    """K3 lse, K4a and K4b against their twins at the ring's relative
    offsets -L, -L/2 (a later shard's chunk: every row dead, or the tile's
    last rows' positions in (-64, 0)), 0, L/2 and L; dead rows exactly 0
    and DEAD_LSE, masked keys exactly 0 in dk and dv."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, mask = _ring_chunk(g, cuda_device)
    L, scale = q.shape[1], 128 ** -0.5
    dout = _randn(g, cuda_device, *q.shape)
    for rel in (-L, -L // 2, 0, L // 2, L):
        off = torch.full((2,), rel, dtype=torch.int32, device=cuda_device)
        before = dict(kernels.launch_counts)
        out, lse = fa.exact_attention_with_lse(q, k, v, mask, off,
                                               causal=causal)
        assert (kernels.launch_counts["exact_attention_lse"]
                == before["exact_attention_lse"] + 1)
        ref, ref_lse = fa.exact_attention_plain(q, k, v, mask, off,
                                                causal=causal,
                                                return_lse=True)
        dead = ref_lse >= fa.DEAD_LSE * 0.5
        assert torch.equal(lse >= fa.DEAD_LSE * 0.5, dead), rel
        assert torch.equal(lse[dead], ref_lse[dead])
        if (~dead).any():
            assert (lse - ref_lse)[~dead].abs().max().item() <= LSE_TOL
            _assert_close(out, ref)
        assert not out.transpose(1, 2)[dead].any()
        # The backward from a finite lse on every row, as the ring's merge
        # gives it: this chunk's lse + 0.5 where live, 3.0 where dead.
        glse = torch.where(dead, 3.0, ref_lse + 0.5).contiguous()
        delta = fa.attention_delta(ref, dout)
        got = fa.attention_backward_from_delta(q, k, v, dout, glse, delta,
                                               mask, off, scale, causal)
        want = fa.decoder_attention_bwd_plain(q, k, v, dout, glse, delta,
                                              mask, off, scale,
                                              causal=causal)
        for gt, w in zip(got, want):
            if w.abs().max().item() == 0.0:
                assert not gt.any(), rel
            else:
                _assert_close(gt, w)
        for gt in got[1:]:
            assert not gt[mask == 0].any()


@pytest.mark.cuda
def test_exact_autograd_function_launches_k3_lse_and_k4(cuda_device):
    """With q, k, v requiring grad, ``exact_attention`` at the all-gather
    shape (Q = K/4 at q_offset K/2) runs K3 with the lse forward and
    K4a/K4b backward, and its gradients match the twins'."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, mask = _decoder_inputs(g, cuda_device, T=256, Q=64)
    off = torch.full((2,), 128, dtype=torch.int32, device=cuda_device)
    dout = _randn(g, cuda_device, *q.shape)
    before = dict(kernels.launch_counts)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.exact_attention(*leaves, mask, off)
    grads = torch.autograd.grad(out, leaves, dout)
    for name in ("exact_attention", "exact_attention_lse",
                 "decoder_attention_bwd_dkdv", "decoder_attention_bwd_dq"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    ref, ref_lse = fa.exact_attention_plain(q, k, v, mask, off,
                                            return_lse=True)
    want = fa.decoder_attention_backward_plain(q, k, v, mask, off, ref,
                                               ref_lse, dout)
    _assert_close(out, ref)
    for got, w in zip(grads, want):
        _assert_close(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [37, 1025])
def test_vit_attention_variants_match_twins(cuda_device, S):
    """B1 in each mode, B2 at each hp and B3 against their twins on qkv
    views, at S = 37 (one partial tile) and the 448 px tile's 1025; each
    call moves its launch counter by one."""
    from mjvideo_tpu_torch.ops import vit_attention_variants as va

    g = torch.Generator(device=cuda_device).manual_seed(14)
    q, k, v = _qkv_views(g, cuda_device, 2, S)
    calls = [("vit_attention_variant", lambda m=m: va.variant_attention(
                 q, k, v, m), lambda m=m: va.variant_attention_plain(
                 q, k, v, m)) for m in va.VARIANT_MODES]
    calls += [("vit_attention_tmajor", lambda n=n: va.tmajor_attention(
                  q, k, v, hp=n), lambda: va.tmajor_attention_plain(q, k, v))
              for n in va.TMAJOR_HP]
    calls.append(("vit_attention_bshd", lambda: va.bshd_attention(q, k, v),
                  lambda: va.bshd_attention_plain(q, k, v)))
    for name, kern, plain in calls:
        before = kernels.launch_counts[name]
        got = kern()
        assert kernels.launch_counts[name] == before + 1, name
        _assert_close(got, plain())


@pytest.mark.cuda
@pytest.mark.parametrize("S,kv_valid", [(1032, 1025), (40, 33)])
def test_bshd_kernel_excludes_keys_past_kv_valid(cuda_device, S, kv_valid):
    """B3 at the JAX ViT's pre-padded length: the keys at or past
    ``kv_valid`` are never read (NaN there changes nothing)."""
    from mjvideo_tpu_torch.ops import vit_attention_variants as va

    g = torch.Generator(device=cuda_device).manual_seed(15)
    q, k, v = _qkv_views(g, cuda_device, 2, S)
    k[:, kv_valid:] = 0
    v[:, kv_valid:] = 0
    got = va.bshd_attention(q, k, v, kv_valid)
    assert got.shape == (2, S, 4 * 64)
    _assert_close(got, va.bshd_attention_plain(q, k, v, kv_valid))
    k[:, kv_valid:] = float("nan")
    v[:, kv_valid:] = float("nan")
    assert torch.equal(va.bshd_attention(q, k, v, kv_valid), got)


@pytest.mark.cuda
def test_variant_wrappers_raise_instead_of_falling_back(cuda_device):
    from mjvideo_tpu_torch.ops import vit_attention_variants as va

    g = torch.Generator(device=cuda_device).manual_seed(16)
    q, k, v = _qkv_views(g, cuda_device, 1, 70)
    calls = (lambda *t: va.variant_attention(*t, "exp2"),
             lambda *t: va.tmajor_attention(*t, hp=2),
             lambda *t: va.bshd_attention(*t, 60))
    for call in calls:
        with pytest.raises(ValueError, match="bfloat16"):
            call(q.float(), k.float(), v.float())
        with pytest.raises(ValueError):
            call(q, k.cpu(), v)
        with pytest.raises(NotImplementedError, match="backward"):
            call(q.clone().requires_grad_(), k, v)
    q32 = torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16, device=cuda_device)
    for call in calls[:2]:
        with pytest.raises(ValueError, match="head dim"):
            call(q32, q32, q32)
    q6 = torch.zeros(1, 8, 6, 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="hp"):
        kernels.vit_attention_tmajor(q6, q6, q6, 4, 0.125)
    with pytest.raises(ValueError, match="mode"):
        kernels.vit_attention_variant(q, k, v, "exp", 0.125)


def _grouped_operands(g, dev, M, K, N, group):
    """bf16 x (M, K) and a (K, N) kernel quantized with ``group`` rows per
    scale by the port's own quantizer."""
    from mjvideo_tpu_torch.ops import quant as q8

    x = _randn(g, dev, M, K)
    w = torch.randn((K, N), generator=g, device=dev) * 0.05
    return x, q8.quantize_kernel(w, group_size=group)


@pytest.mark.cuda
def test_k6_and_k7_match_twins_at_odd_shapes(cuda_device):
    """K6 (fused) and K7 (pre-quantized) against their twins: M tails, odd
    N, g of 32, 64 and 128, bf16 and fp32 outputs; K7 against K6 on the
    same x.  Both twins' int32 partials are exact, so only the fp32 sum
    order may differ: 2**-7 of max|plain| as elsewhere."""
    from mjvideo_tpu_torch.ops import quant as q8

    g = torch.Generator(device=cuda_device).manual_seed(6)
    for M, K, N, group in ((1, 256, 33, 32), (70, 512, 201, 64),
                           (130, 1024, 384, 128), (2, 2048, 1003, 128)):
        x, qk = _grouped_operands(g, cuda_device, M, K, N, group)
        ws = qk.scale.float()
        for out_dtype in (torch.bfloat16, torch.float32):
            before = kernels.launch_counts["q8g_matmul_fused"]
            got = q8.q8g_matmul_fused(x, qk.q, ws, out_dtype)
            assert kernels.launch_counts["q8g_matmul_fused"] == before + 1
            assert got.dtype == out_dtype and got.shape == (M, N)
            _assert_close(got, q8.q8g_matmul_fused_plain(x, qk.q, ws,
                                                         out_dtype))
        xq, a_s = q8._quantize_rows_grouped(x.float(), K // group, group)
        before = kernels.launch_counts["q8g_matmul"]
        got7 = q8.q8g_matmul(xq, a_s, qk.q, ws)
        assert kernels.launch_counts["q8g_matmul"] == before + 1
        _assert_close(got7, q8.q8g_matmul_plain(xq, a_s, qk.q, ws))
        _assert_close(got7, q8.q8g_matmul_fused(x, qk.q, ws, torch.float32))


@pytest.mark.cuda
def test_k5_matches_twin_at_odd_shapes(cuda_device):
    """K5 against its twin at M of 1, 2, 7 and 32, odd N, groups of 16 to
    128, and ``dot_q4``'s routes: K5 at 32 rows or fewer, the dequantized
    halves above."""
    from mjvideo_tpu_torch.ops import matmul as mm
    from mjvideo_tpu_torch.ops import quant4 as q4

    g = torch.Generator(device=cuda_device).manual_seed(7)
    for M, K, N, group in ((1, 256, 77, 64), (2, 512, 1001, 128),
                           (7, 160, 96, 16), (32, 1024, 300, 128)):
        w = torch.randn((K, N), generator=g, device=cuda_device) * 0.05
        k4 = q4.quantize_kernel_q4(w, group_size=group)
        x = _randn(g, cuda_device, M, K)
        before = kernels.launch_counts["w4_matmul"]
        got = q4.w4_matmul(x, k4.packed, k4.scale)
        assert kernels.launch_counts["w4_matmul"] == before + 1
        _assert_close(got, q4.w4_matmul_plain(x, k4.packed, k4.scale))
        _assert_close(mm.dot(x, k4), q4.w4_matmul_plain(x, k4.packed,
                                                        k4.scale))
    before = kernels.launch_counts["w4_matmul"]
    big = _randn(g, cuda_device, 33, K)
    _assert_close(mm.dot_f32(big, k4),
                  q4.w4_matmul_plain(big, k4.packed, k4.scale))
    assert kernels.launch_counts["w4_matmul"] == before


@pytest.mark.cuda
def test_int8_matmul_is_exact_at_decode_rows_and_odd_n(cuda_device):
    """The per-column w8a8 product (``torch._int_mm``, padded where it asks)
    against an exact int64 product on the CPU."""
    from mjvideo_tpu_torch.ops import quant as q8

    g = torch.Generator(device=cuda_device).manual_seed(8)
    for M, K, N in ((2, 2048, 1003), (17, 64, 40), (300, 200, 96)):
        a = torch.randint(-127, 128, (M, K), generator=g, device=cuda_device,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=g, device=cuda_device,
                          dtype=torch.int8)
        want = a.cpu().long() @ b.cpu().long()
        assert torch.equal(q8.int8_matmul(a, b).cpu().long(), want)


@pytest.mark.cuda
def test_quant_wrappers_raise_instead_of_falling_back(cuda_device):
    from mjvideo_tpu_torch.ops import quant as q8
    from mjvideo_tpu_torch.ops import quant4 as q4

    g = torch.Generator(device=cuda_device).manual_seed(9)
    x, qk = _grouped_operands(g, cuda_device, 4, 256, 64, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        q8.q8g_matmul_fused(x.float(), qk.q, qk.scale.float(), torch.float32)
    with pytest.raises(ValueError):
        q8.q8g_matmul_fused(x, qk.q.cpu(), qk.scale.float(), torch.float32)
    bad = q8.quantize_kernel(torch.randn(240, 64, device=cuda_device),
                             group_size=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        q8.q8g_matmul_fused(_randn(g, cuda_device, 4, 240), bad.q,
                            bad.scale.float(), torch.float32)
    k4 = q4.quantize_kernel_q4(torch.randn(256, 64, device=cuda_device), 64)
    with pytest.raises(ValueError, match="M <= 32"):
        q4.w4_matmul(_randn(g, cuda_device, 33, 256), k4.packed, k4.scale)
    # A CUDA input that needs a gradient is refused, not detached.
    xg = x.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        q8.q8g_matmul_fused(xg, qk.q, qk.scale.float(), torch.float32)
    with pytest.raises(NotImplementedError, match="backward"):
        q4.w4_matmul(_randn(g, cuda_device, 2, 256).requires_grad_(),
                     k4.packed, k4.scale)


@pytest.mark.cuda
def test_quantizers_on_the_card_equal_the_cpu(cuda_device):
    """A state quantized where it lies (``RewardScorer(quant=...)`` on the
    card) is bit-equal to the same state quantized on the CPU."""
    from mjvideo_tpu_torch.ops import quant as q8
    from mjvideo_tpu_torch.ops import quant4 as q4

    g = torch.Generator(device=cuda_device).manual_seed(10)
    w = torch.randn((3, 512, 96), generator=g, device=cuda_device)
    w = w.to(torch.bfloat16)
    for group in (None, 64, 128):
        got, want = (q8.quantize_kernel(t, group_size=group)
                     for t in (w, w.cpu()))
        assert torch.equal(got.q.cpu(), want.q)
        assert torch.equal(got.scale.cpu(), want.scale)
    got, want = (q4.quantize_kernel_q4(t, group_size=64) for t in (w, w.cpu()))
    assert torch.equal(got.packed.cpu(), want.packed)
    assert torch.equal(got.scale.cpu(), want.scale)
    # A CPU state quantized leaf by leaf onto the card (``device=``).
    state = {"mlp": {"fc1": {"kernel": w.cpu(), "bias": w[0, 0].cpu()}}}
    for mode in ("int8-g64", "int4-wo"):
        moved = q8.quantize_params_mode(state, mode, min_elements=1024,
                                        device=cuda_device)
        here = q8.quantize_params_mode(state, mode, min_elements=1024)
        assert moved["mlp"]["fc1"]["bias"].device == cuda_device
        assert len(q8.quant_nodes(moved)) == len(q8.quant_nodes(here)) == 1
        for a, b in zip(q8.quant_nodes(moved), q8.quant_nodes(here)):
            for f in ("q", "packed", "scale"):
                if hasattr(a, f):
                    assert getattr(a, f).device == cuda_device
                    assert torch.equal(getattr(a, f).cpu(), getattr(b, f))
