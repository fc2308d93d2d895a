"""K3 lse, K6, K7 and K6's pre-pass on the card, against their plain
twins.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_hopper_k3lse_q8g.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerances: K3 lse's output
bit-equal to K3's on the same inputs (one instantiation; the lse is its
epilogue), its lse within LSE_TOL nats of the twin's on live rows and
exactly DEAD_LSE on dead ones; K6, K7 and the pre-pass bit-equal to their
twins (exact int32 partials, then the twin's fp32 steps in its order).
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa
from mjvideo_tpu_torch.ops import quant as q8

LSE_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_k3_lse_is_k3_with_an_lse_epilogue(cuda_device, causal):
    """At ring offsets around a 200-row chunk (a later shard's: every row
    dead; inside the 128-row q tile; past the chunk), K3 lse's output
    equals K3's bit for bit, its lse the twin's to LSE_TOL, dead rows
    DEAD_LSE and 0."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    L = 200
    q = _randn(g, cuda_device, 2, L, 4, 128)
    k = _randn(g, cuda_device, 2, L, 2, 128)
    v = _randn(g, cuda_device, 2, L, 2, 128)
    mask = torch.ones(2, L, dtype=torch.int32, device=cuda_device)
    mask[0, L - 9:] = 0
    mask[1, :70] = 0
    for rel in (-L, -L // 2, -1, 0, L // 2, L, 3 * L):
        off = torch.full((2,), rel, dtype=torch.int32, device=cuda_device)
        before = kernels.launch_counts["exact_attention_lse"]
        out, lse = kernels.exact_attention(q, k, v, mask, off, 128 ** -0.5,
                                           causal=causal, with_lse=True)
        assert kernels.launch_counts["exact_attention_lse"] == before + 1
        alone = kernels.exact_attention(q, k, v, mask, off, 128 ** -0.5,
                                        causal=causal)
        assert torch.equal(out, alone), rel
        ref, ref_lse = fa.exact_attention_plain(q, k, v, mask, off,
                                                causal=causal,
                                                return_lse=True)
        dead = ref_lse >= fa.DEAD_LSE * 0.5
        assert torch.equal(lse >= fa.DEAD_LSE * 0.5, dead), rel
        assert bool((lse[dead] == fa.DEAD_LSE).all())
        assert not out.transpose(1, 2)[dead].any()
        if causal and rel == -L:
            assert dead.all()
        if (~dead).any():
            assert (lse - ref_lse)[~dead].abs().max().item() <= LSE_TOL, rel
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= 2 ** -7 * ref.float().abs().max().item(), rel


# (M, K, N, g): M tails, odd N, g of 32, 64, 96 (groups across the 128-byte
# stages), 128, 512 and 1024 (a group wider than the stage ring).
Q8G_CASES = ((1, 256, 33, 32), (70, 512, 201, 64), (129, 768, 256, 96),
             (130, 1024, 384, 128), (2, 2048, 1003, 128),
             (64, 2048, 130, 512), (3, 4096, 129, 1024))


@pytest.mark.cuda
def test_k6_k7_and_the_pre_pass_are_bit_equal_to_their_twins(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    for M, K, N, group in Q8G_CASES:
        x = _randn(g, cuda_device, M, K)
        w = torch.randn((K, N), generator=g, device=cuda_device) * 0.05
        qk = q8.quantize_kernel(w, group_size=group)
        assert q8.is_k_major(qk.q)
        ws, G = qk.scale, K // group
        xq, a_s = kernels.q8g_quantize(x, G)
        want_xq, want_as = q8._quantize_rows_grouped(x.float(), G, group)
        assert torch.equal(xq, want_xq) and torch.equal(a_s, want_as)
        for out_dtype in (torch.bfloat16, torch.float32):
            before = dict(kernels.launch_counts)
            got = q8.q8g_matmul_fused(x, qk.q, ws, out_dtype)
            assert (kernels.launch_counts["q8g_matmul_fused"]
                    == before["q8g_matmul_fused"] + 1)
            assert (kernels.launch_counts["q8g_quantize"]
                    == before["q8g_quantize"] + 1)
            want = q8.q8g_matmul_fused_plain(x, qk.q, ws, out_dtype)
            assert torch.equal(got, want), (M, K, N, group, out_dtype)
        got7 = q8.q8g_matmul(xq, a_s, qk.q, ws)
        assert torch.equal(got7, q8.q8g_matmul_plain(xq, a_s, qk.q, ws))
        assert torch.equal(got7, kernels.q8g_matmul_fused(x, qk.q, ws,
                                                          torch.float32))


@pytest.mark.cuda
def test_k6_and_k7_refuse_a_weight_that_is_not_k_major(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(14)
    x = _randn(g, cuda_device, 4, 256)
    qk = q8.quantize_kernel(torch.randn((256, 64), generator=g,
                                        device=cuda_device), group_size=64)
    with pytest.raises(ValueError, match="k-major"):
        kernels.q8g_matmul_fused(x, qk.q.contiguous(), qk.scale,
                                 torch.float32)
    xq, a_s = kernels.q8g_quantize(x, 4)
    with pytest.raises(ValueError, match="k-major"):
        kernels.q8g_matmul(xq, a_s, qk.q.contiguous(), qk.scale)
