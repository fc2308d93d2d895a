"""The CUDA kernels against their plain twins, on a card.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda -q

(``--noconftest`` skips the JAX device setup of ``tests/conftest.py``.)
Without a card every test here skips.  Tolerance: max|kernel - plain| /
max|plain| <= 2**-7, one bf16 ulp of the largest output at worst, the bound
``chip_smoke.py`` states.
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


def _assert_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -7 * want.float().abs().max().item(), err


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
