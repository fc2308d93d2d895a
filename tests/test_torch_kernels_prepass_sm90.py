"""The two pre-passes of the main paths on the card: K1/K2's key-norm max
(partial maxima folded by the attention kernel behind a programmatic
dependent launch) and K6's activation quantization.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_prepass_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerances: the pre-pass's kmax
is an exact max of norms summed exactly, so every chunk count gives the
same bits and the twin (fp32 sums in torch's order) lies within
PREPASS_REL_TOL of it; each K1/K2 op (one C call: the partial pass, then
the attention kernel folding the partials) is bit-equal to the kernel
alone on the standalone ``kernels.key_norm_max``, and a second launch is
bit-identical; K6's pre-pass and K6 are bit-equal to their twins.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa
from mjvideo_tpu_torch.ops import quant as q8

PREPASS_REL_TOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _keys(gen, dev, B, K, Hkv, D):
    """bf16 keys with varied norms, so the max is one key's."""
    scale = torch.rand((B, K, Hkv, 1), generator=gen, device=dev) * 3 + 0.2
    return (_randn(gen, dev, B, K, Hkv, D).float() * scale).to(torch.bfloat16)


# (B, K, Hkv, D, mask kind): single keys, each side of a 32-key chunk, the
# ViT's tile and the decoder's bucket; "chunk" masks a whole chunk of the
# plan's, "dead" every key of row 1.
KMAX_CASES = ((1, 1, 8, 128, None), (2, 31, 8, 128, "holes"),
              (2, 32, 16, 64, None), (2, 33, 8, 128, "dead"),
              (8, 1025, 16, 64, None), (2, 3072, 8, 128, "chunk"),
              (1, 3072, 8, 128, "chunk"))


def _mask(gen, dev, B, K, kind):
    if kind is None:
        return None
    mask = (torch.rand((B, K), generator=gen, device=dev) > 0.3).int()
    if kind == "dead":
        mask[1] = 0
    elif kind == "chunk":
        mask[:, 16:48] = 0  # the plan's chunk 1 (16 keys) and 2, and more
        mask[0, 40:] = 1
    return mask


@pytest.mark.cuda
def test_key_norm_max_is_the_same_for_every_chunk_count(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(15)
    for B, K, Hkv, D, kind in KMAX_CASES:
        k = _keys(g, cuda_device, B, K, Hkv, D)
        mask = _mask(g, cuda_device, B, K, kind)
        plan = kernels.key_norm_parts(B, K, Hkv, D)
        want = fa.key_norm_max(k, mask)
        before = kernels.launch_counts["key_norm_max"]
        got = kernels.key_norm_max(k, mask)
        assert kernels.launch_counts["key_norm_max"] == before + 1
        rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        assert rel.item() <= PREPASS_REL_TOL, (B, K, kind)
        for parts in sorted({min(K, n) for n in (1, 2, 3, 7, plan, K)}):
            again = kernels.key_norm_max(k, mask, parts=parts)
            assert torch.equal(again, got), (B, K, kind, parts)
        if kind == "dead":
            assert not got[1].any()
        twin = fa.key_norm_fold(fa.key_norm_partials(k, mask, plan))
        assert torch.equal(twin, want)


def _vit_inputs(gen, dev, B, S, H, D=64):
    return (t.view(B, S, H, D)
            for t in _randn(gen, dev, B, S, 3 * H * D).split(H * D, dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
def test_k1_op_is_the_kernel_alone_on_the_standalone_kmax(cuda_device,
                                                          with_lse):
    g = torch.Generator(device=cuda_device).manual_seed(16)
    for B, S, H in ((8, 1025, 16), (2, 1025, 16), (1, 63, 4), (3, 200, 16)):
        q, k, v = _vit_inputs(g, cuda_device, B, S, H)
        scale = 64 ** -0.5
        before = dict(kernels.launch_counts)
        got = kernels.vit_attention_op(q, k, v, scale, with_lse=with_lse)
        assert (kernels.launch_counts["key_norm_max"]
                == before["key_norm_max"] + 1)
        assert (kernels.launch_counts["vit_attention"]
                == before["vit_attention"] + 1)
        again = kernels.vit_attention_op(q, k, v, scale, with_lse=with_lse)
        alone = kernels.vit_attention(q, k, v, kernels.key_norm_max(k), scale,
                                      with_lse=with_lse)
        got, again, alone = ((t if with_lse else (t,))
                             for t in (got, again, alone))
        for a, b, c in zip(got, again, alone):
            assert torch.equal(a, c), (B, S, H)
            assert torch.equal(a, b), (B, S, H)
        ref = fa.vit_attention_plain(q, k, v)
        err = (got[0].float() - ref.float()).abs().max()
        assert err.item() <= 2 ** -7 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
def test_k2_op_is_the_kernel_alone_on_the_standalone_kmax(cuda_device,
                                                          with_lse):
    g = torch.Generator(device=cuda_device).manual_seed(17)
    # (B, Q, K, Hq, Hkv, q_offset): serving's bucket with a ragged mask,
    # training's prompt, and a continuation over a longer cache.
    for B, Q, K, Hq, Hkv, off in ((2, 3072, 3072, 16, 8, None),
                                  (1, 799, 799, 16, 8, None),
                                  (2, 128, 2496, 16, 8, 2308)):
        q = _randn(g, cuda_device, B, Q, Hq, 128)
        k = _randn(g, cuda_device, B, K, Hkv, 128)
        v = _randn(g, cuda_device, B, K, Hkv, 128)
        mask = torch.ones((B, K), dtype=torch.int32, device=cuda_device)
        if B == 2:
            mask[1, K - 600:] = 0
            mask[1, :5] = 0
        offset = (None if off is None else
                  torch.full((B,), off, dtype=torch.int32,
                             device=cuda_device))
        scale = 128 ** -0.5
        before = dict(kernels.launch_counts)
        got = kernels.decoder_attention_op(q, k, v, mask, offset, scale,
                                           with_lse=with_lse)
        assert (kernels.launch_counts["key_norm_max"]
                == before["key_norm_max"] + 1)
        again = kernels.decoder_attention_op(q, k, v, mask, offset, scale,
                                             with_lse=with_lse)
        alone = kernels.decoder_attention(q, k, v, mask,
                                          kernels.key_norm_max(k, mask),
                                          offset, scale, with_lse=with_lse)
        got, again, alone = ((t if with_lse else (t,))
                             for t in (got, again, alone))
        for a, b, c in zip(got, again, alone):
            assert torch.equal(a, c), (B, Q, K)
            assert torch.equal(a, b), (B, Q, K)


# (M, K, g): M = 1 and 2, a tail past a CTA's rows (8 rows of K = 2,048
# at g = 128), a decoder wq's 2,333 rows, and every lane plan: g 32-128 (4
# lanes a group), 256 and 1,024 (8 and 32 lanes), 96 (3 pieces a lane) and
# 288 (9 pieces a lane: the group read twice).
QUANT_CASES = ((1, 2048, 128), (2, 2048, 128), (9, 2048, 128),
               (2333, 2048, 128), (130, 1024, 32), (70, 512, 64),
               (129, 768, 96), (33, 2048, 256), (5, 4096, 1024),
               (17, 576, 288))


def _activations(gen, dev, M, K, g):
    """bf16 x with a zero row, a group whose values sit at +-amax, and
    values whose quotient by the scale is a tie (k + 0.5)."""
    x = _randn(gen, dev, M, K).float()
    x[0, :g] = 0.0
    if M > 1:
        x[1, :g] = 1.0
        x[1, 1:g:2] = -1.0
    if M > 2:
        # amax 127 (scale exactly 1): k + 0.5 values are ties.
        x[2, :g] = torch.arange(g, device=dev).float() % 8 - 3.5
        x[2, 0] = 127.0
    return x.to(torch.bfloat16)


@pytest.mark.cuda
def test_k6_pre_pass_is_bit_equal_to_the_twin_at_the_edges(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(18)
    for M, K, group in QUANT_CASES:
        x = _activations(g, cuda_device, M, K, group)
        G = K // group
        xq, a_s = kernels.q8g_quantize(x, G)
        want_xq, want_as = q8._quantize_rows_grouped(x.float(), G, group)
        assert torch.equal(xq, want_xq), (M, K, group)
        assert torch.equal(a_s, want_as), (M, K, group)
        xq2, a_s2 = kernels.q8g_quantize(x, G)
        assert torch.equal(xq2, xq) and torch.equal(a_s2, a_s)
        # The zero group's scale is the floor.
        assert a_s[0, 0].item() == torch.tensor(1e-12).item()


@pytest.mark.cuda
def test_k6_with_its_dependent_gemm_is_bit_equal_to_k7(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(19)
    for M, K, group in QUANT_CASES:
        N = 200
        x = _activations(g, cuda_device, M, K, group)
        w = torch.randn((K, N), generator=g, device=cuda_device) * 0.05
        qk = q8.quantize_kernel(w, group_size=group)
        G = K // group
        got = kernels.q8g_matmul_fused(x, qk.q, qk.scale, torch.float32)
        again = kernels.q8g_matmul_fused(x, qk.q, qk.scale, torch.float32)
        xq, a_s = kernels.q8g_quantize(x, G)
        alone = kernels.q8g_matmul(xq, a_s, qk.q, qk.scale)
        assert torch.equal(got, alone) and torch.equal(got, again)
        want = q8.q8g_matmul_fused_plain(x, qk.q, qk.scale, torch.float32)
        assert torch.equal(got, want), (M, K, group)
