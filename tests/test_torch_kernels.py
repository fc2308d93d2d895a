"""The CUDA kernels against their plain twins, on a card.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda -q

(``--noconftest`` skips the JAX device setup of ``tests/conftest.py``.)
Without a card every test here skips.  Tolerances, the bounds
``chip_smoke.py`` states: each bf16 output (K1, K2, K2r, K3, K4a's dk and dv,
K4b's dq) to max|kernel - plain| / max|plain| <= 2**-7, one bf16 ulp of the
largest output at worst; K2's fp32 lse to max|kernel - plain| <= LSE_TOL.
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


@pytest.mark.cuda
def test_kernel_wrappers_raise_instead_of_falling_back(cuda_device):
    q = torch.zeros(1, 8, 4, 64, device=cuda_device)  # fp32: no kernel
    with pytest.raises(ValueError, match="bfloat16"):
        fa.vit_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.vit_attention(q, q, q)


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
    for kern in (fa.exact_attention, fa.decoder_attention_rows):
        with pytest.raises(ValueError, match="bfloat16"):
            kern(q.float(), k.float(), v.float(), mask)
        # A CPU/CUDA mix raises in the checks, or in K2r's bound before
        # them; neither takes the twin.
        with pytest.raises((ValueError, RuntimeError)):
            kern(q, k.cpu(), v, mask)
        with pytest.raises((ValueError, RuntimeError)):
            kern(q, k, v, mask.cpu())
        with pytest.raises(NotImplementedError, match="backward"):
            kern(q.clone().requires_grad_(), k, v, mask)
