"""K2, its key-norm pre-pass and K3 at Phi-3's head dim of 96 on the card
(``Config<96, 2, 3>`` of ``csrc/decoder_attention_sm90.cuh``: two 64-column
boxes a row, the second half TMA's zero fill), and the forms still refused
there.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_d96_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerances: each kernel output
within 2^-7 of max|plain| of its twin (one bf16 ulp of the largest output:
kernel and twin round p to bf16 alike and differ in fp32 summation order);
the pre-pass's kmax within 1e-6 of its twin and the same bits for every
chunk count; each K2 op bit-equal to the kernel alone on the standalone
kmax; two launches bit-identical; rows that see no key exactly 0.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa

D = 96
REL_TOL = 2 ** -7
PREPASS_REL_TOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


# (B, T, Hq, Hkv): a single token, each side of the 128-row q tile and the
# 128-key kv tile with GQA, and the 4B's (2, 3072, 32, 32).
K2_CASES = ((1, 1, 4, 4), (2, 127, 8, 8), (2, 129, 8, 2), (3, 200, 4, 4),
            (2, 3072, 32, 32))


def _decoder_inputs(gen, dev, B, T, Hq, Hkv):
    """q, k, v, a ragged (B, T) int32 mask (the last row masks its first 5
    keys and its last third: its first 5 queries see no key) and the dead
    rows."""
    q, k, v = (_randn(gen, dev, B, T, h, D) for h in (Hq, Hkv, Hkv))
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    if T > 8:
        mask[-1, :5] = 0
        mask[-1, T - T // 3:] = 0
    dead = mask.cumsum(1) == 0
    return q, k, v, mask, dead


def _rel(got, ref):
    top = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / max(top, 1e-30)


@pytest.mark.cuda
def test_k2_op_and_kernel_alone_at_d96(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(20)
    for B, T, Hq, Hkv in K2_CASES:
        q, k, v, mask, dead = _decoder_inputs(g, cuda_device, B, T, Hq, Hkv)
        scale = D ** -0.5
        before = dict(kernels.launch_counts)
        got = kernels.decoder_attention_op(q, k, v, mask, None, scale)
        for name in ("decoder_attention", "key_norm_max",
                     "decoder_attention_d96", "key_norm_max_d96"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        again = kernels.decoder_attention_op(q, k, v, mask, None, scale)
        kmax = kernels.key_norm_max(k, mask)
        alone = kernels.decoder_attention(q, k, v, mask, kmax, None, scale)
        ref = fa.decoder_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        assert got.shape == (B, T, Hq, D) and torch.isfinite(got).all()
        assert torch.equal(got, alone), (B, T)
        assert torch.equal(got, again), (B, T)
        assert _rel(got, ref) <= REL_TOL, (B, T, _rel(got, ref))
        assert not got[dead].any()


@pytest.mark.cuda
def test_key_norm_max_at_d96_is_the_same_for_every_chunk_count(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(21)
    for B, T, _, Hkv in K2_CASES + ((1, 3072, 64, 64),):
        scale = torch.rand((B, T, Hkv, 1), generator=g, device=cuda_device)
        k = (_randn(g, cuda_device, B, T, Hkv, D).float()
             * (3 * scale + 0.2)).to(torch.bfloat16)
        mask = (torch.rand((B, T), generator=g, device=cuda_device)
                > 0.3).int()
        want = fa.key_norm_max(k, mask)
        got = kernels.key_norm_max(k, mask)
        assert _rel(got, want) <= PREPASS_REL_TOL, (B, T, Hkv)
        plan = kernels.key_norm_parts(B, T, Hkv, D)
        for parts in sorted({min(T, n) for n in (1, 2, 3, 7, plan, T)}):
            assert torch.equal(kernels.key_norm_max(k, mask, parts=parts),
                               got), (B, T, parts)


# (B, Q, K, Hq, Hkv, q_offset or None, causal): a prefill, a causal
# continuation at an offset, a decode step (Q = 1), and non-causal.
K3_CASES = ((2, 129, 129, 8, 2, None, True), (2, 200, 330, 4, 4, 130, True),
            (2, 1, 300, 8, 8, 299, True), (2, 129, 257, 8, 4, None, False),
            (2, 3072, 3072, 32, 32, None, True))


@pytest.mark.cuda
def test_k3_at_d96(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(22)
    for B, Q, K, Hq, Hkv, off, causal in K3_CASES:
        q = _randn(g, cuda_device, B, Q, Hq, D)
        k, v = (_randn(g, cuda_device, B, K, Hkv, D) for _ in range(2))
        mask = torch.ones((B, K), dtype=torch.int32, device=cuda_device)
        mask[-1, :7] = 0
        mask[0, K - 9:] = 0
        offset = (None if off is None else torch.full(
            (B,), off, dtype=torch.int32, device=cuda_device))
        before = dict(kernels.launch_counts)
        got = kernels.exact_attention(q, k, v, mask, offset, D ** -0.5,
                                      causal=causal)
        for name in ("exact_attention", "exact_attention_d96"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        again = kernels.exact_attention(q, k, v, mask, offset, D ** -0.5,
                                        causal=causal)
        ref = fa.exact_attention_plain(q, k, v, mask, offset, causal=causal)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert torch.equal(got, again), (B, Q, K)
        assert _rel(got, ref) <= REL_TOL, (B, Q, K, _rel(got, ref))
        dead = ~fa._allowed(q, k, mask, offset, causal).any(-1)
        assert not got[dead.expand(B, Q)].any()


def _d96(dev, B=1, T=64, H=4):
    g = torch.Generator(device=dev).manual_seed(23)
    return (_randn(g, dev, B, T, H, D) for _ in range(3))


@pytest.mark.cuda
def test_forms_not_built_at_d96_refuse_before_any_launch(cuda_device):
    q, k, v = _d96(cuda_device)
    lse = torch.zeros((1, 4, 64), device=cuda_device)
    before = dict(kernels.launch_counts)
    calls = (
        lambda: kernels.decoder_attention_op(q, k, v, None, None, 1.0,
                                             with_lse=True),
        lambda: kernels.decoder_attention(q, k, v, None,
                                          torch.ones((1, 4),
                                                     device=cuda_device),
                                          None, 1.0, with_lse=True),
        lambda: kernels.exact_attention(q, k, v, None, None, 1.0,
                                        with_lse=True),
        lambda: kernels.decoder_attention_rows_op(q, k, v, None, None, 1.0),
        lambda: kernels.key_norm_cummax(k),
        lambda: kernels.decoder_attention_bwd_dkdv(q, k, v, q, lse, lse,
                                                   None, None, 1.0),
        lambda: kernels.decoder_attention_bwd_dq(q, k, v, q, lse, lse, None,
                                                 None, 1.0),
        # Under autograd K2 and K3 take their lse forms: refused at once.
        lambda: fa.decoder_attention(q.requires_grad_(), k, v),
        lambda: fa.exact_attention(q.requires_grad_(), k, v),
    )
    for call in calls:
        with pytest.raises(NotImplementedError, match="item 5b"):
            call()
    assert kernels.launch_counts == before


@pytest.mark.cuda
def test_c_entries_refuse_the_lse_at_d96(cuda_device):
    """The C entries admit D = 96 for K2 and K3 without the lse only."""
    q, k, v = _d96(cuda_device)
    lib = kernels._load()
    out = torch.empty_like(q)
    lse = torch.empty((1, 4, 64), device=cuda_device)
    kmax = kernels.key_norm_max(k)
    stream = torch.cuda.current_stream().cuda_stream
    strides = (q.stride(0), q.stride(1)) * 3
    common = (1, 64, 64, 4, 4, D, *strides, 1.0)
    err = lib.mjv_decoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, kmax.data_ptr(),
        None, out.data_ptr(), lse.data_ptr(), *common, stream)
    assert err != 0
    err = lib.mjv_exact_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
        out.data_ptr(), lse.data_ptr(), *common, 1, stream)
    assert err != 0
    err = lib.mjv_exact_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
        out.data_ptr(), None, *common, 1, stream)
    assert err == 0
    part = torch.empty((1, 1, 4), device=cuda_device)
    kcum = torch.empty((1, 4, 64), device=cuda_device)
    err = lib.mjv_key_norm_cummax(k.data_ptr(), None, part.data_ptr(),
                                  kcum.data_ptr(), 1, 64, 4, D, k.stride(0),
                                  k.stride(1), 1, stream)
    assert err != 0
    torch.cuda.synchronize()
