"""K4 nc dK/dV and dQ (the ViT attention backward on the Hopper template
``csrc/attention_bwd_sm90.cuh``) against their plain twin, on a card.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_bwd_sm90.py --noconftest -m cuda -q

Without a card every test here skips.  Tolerance, the bound
``chip_smoke.py`` states: each bf16 gradient to max|kernel - plain| /
max|plain| <= 2**-7, one bf16 ulp of the largest gradient at worst.  The
sizes put S on each side of the template's tile edges: 64 q rows streamed
and 128 keys held a CTA by dK/dV, 192 q rows held and 64 keys streamed by
dQ, and the ViT's 1025 (one real key in dK/dV's last tile).
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa

TILE_EDGES = (63, 64, 65, 127, 128, 129, 191, 192, 193, 1025)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _operands(dev, B, S, H, seed):
    """q, k, v as strided views into one (B, S, 3 H 64) tensor, as the ViT
    makes them, a random dO, the twin's lse and delta."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (t.view(B, S, H, 64) for t in
               _randn(g, dev, B, S, 3 * H * 64).split(H * 64, dim=-1))
    dout = _randn(g, dev, B, S, H, 64)
    out, lse = fa.vit_attention_plain(q, k, v, return_lse=True)
    return q, k, v, dout, lse, fa.attention_delta(out, dout)


def _assert_close(name, got, want):
    assert torch.isfinite(got).all(), name
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -7 * want.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("S", TILE_EDGES)
def test_k4_nc_matches_twin_at_tile_edges(cuda_device, S):
    args = _operands(cuda_device, 2, S, 4, S)
    scale = 64 ** -0.5
    before = dict(kernels.launch_counts)
    dk, dv = kernels.vit_attention_bwd_dkdv(*args, scale)
    dq = kernels.vit_attention_bwd_dq(*args, scale)
    for name in ("vit_attention_bwd_dkdv", "vit_attention_bwd_dq"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    want = fa.vit_attention_bwd_plain(*args)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.shape == w.shape and got.is_contiguous(), name
        _assert_close(name, got, w)


@pytest.mark.cuda
def test_k4_nc_two_launches_are_bit_identical(cuda_device):
    """No atomics: every output row is summed by one thread in a fixed
    order, at the ViT's (8, 1025, 16, 64)."""
    args = _operands(cuda_device, 8, 1025, 16, 5)
    scale = 64 ** -0.5
    first = (*kernels.vit_attention_bwd_dkdv(*args, scale),
             kernels.vit_attention_bwd_dq(*args, scale))
    second = (*kernels.vit_attention_bwd_dkdv(*args, scale),
              kernels.vit_attention_bwd_dq(*args, scale))
    for name, a, b in zip(("dk", "dv", "dq"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_k4_nc_wrappers_raise_on_head_dim_and_tma_strides(cuda_device):
    """A head dim other than 64, a row stride TMA cannot take (not a
    multiple of 16 bytes) and a base pointer off 16 bytes are refused,
    never computed."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    lse = torch.zeros(1, 4, 70, device=cuda_device)
    for fn in (kernels.vit_attention_bwd_dkdv, kernels.vit_attention_bwd_dq):
        x = _randn(g, cuda_device, 1, 70, 4, 32)
        with pytest.raises(ValueError, match="head dim"):
            fn(x, x, x, x, lse, lse, 0.125)
        # Row stride 3 H D + 4 elements: 8 bytes off a multiple of 16.
        q, k, v = (t.view(1, 70, 4, 64) for t in _randn(
            g, cuda_device, 1, 70, 3 * 4 * 64 + 4)[..., :3 * 4 * 64]
            .split(4 * 64, dim=-1))
        dout = _randn(g, cuda_device, 1, 70, 4, 64)
        with pytest.raises(ValueError, match="16-byte"):
            fn(q, k, v, dout, lse, lse, 0.125)
        # A base pointer 2 bytes past a 16-byte boundary.
        flat = _randn(g, cuda_device, 70 * 4 * 64 + 1)
        off = flat[1:].view(1, 70, 4, 64)
        with pytest.raises(ValueError, match="16-byte"):
            fn(off, off, off, dout, lse, lse, 0.125)
