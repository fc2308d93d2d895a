"""The attention kernels at the head counts of a model rank of 2 at the 2B
widths (``parallel/mesh.py``'s head split) against their plain twins, and
a rank's heads against the whole layer's, on a card.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_mesh_sm90.py --noconftest -m cuda -q

Without a card every test here skips.  Tolerances, the bounds
``chip_smoke.py`` states: each bf16 output to max|kernel - plain| /
max|plain| <= 2**-7, K2's lse to 1e-5 nats on live rows; a rank's heads
bit-equal to the whole layer's on those heads, given the same q, k and v
(the bound's key norms are per (batch, kv head), so a head group computes
what it computes among all heads).  Shapes: K1 on a clip's 8 tiles of
1,025 tokens at 8 of the ViT's 16 heads of 64; K2 at the 3,072 bucket
with a ragged mask at 8/4 of the decoder's 16/8 heads of 128; K2 lse, K4a
and K4b at a training prompt of 799 tokens, every key live.
"""

import pytest
import torch

from mjvideo_tpu_torch.ops import flash_attention as fa

TOL = 2 ** -7
LSE_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def _vit_views(t, H, D):
    """q, k, v: (B, S, H, D) views into a (B, S, 3 H D) qkv product."""
    B, S, _ = t.shape
    return [u.view(B, S, H, D) for u in t.split(H * D, dim=-1)]


@pytest.mark.cuda
def test_k1_at_a_ranks_heads(cuda_device):
    dev, H, D = cuda_device, 16, 64
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = _randn(g, dev, 8, 1025, 3 * H * D)
    whole = fa.vit_attention(*_vit_views(qkv, H, D))
    C = H * D
    for j in range(2):
        mine = torch.cat([qkv[..., i * C + j * C // 2:i * C + (j + 1) * C // 2]
                          for i in range(3)], -1)
        views = _vit_views(mine, H // 2, D)
        got = fa.vit_attention(*views)
        _close(got, fa.vit_attention_plain(*views))
        assert torch.equal(got, whole[:, :, j * H // 2:(j + 1) * H // 2])


def _decoder_operands(dev, B, T, Hq, Hkv, D, ragged, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(g, dev, B, T, Hq, D)
    k, v = _randn(g, dev, B, T, Hkv, D), _randn(g, dev, B, T, Hkv, D)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    if ragged:
        mask[-1, T - 700:] = 0
    return q, k, v, mask


def _rank(q, k, v, j, m=2):
    Hq, Hkv = q.shape[2], k.shape[2]
    qs = slice(j * Hq // m, (j + 1) * Hq // m)
    ks = slice(j * Hkv // m, (j + 1) * Hkv // m)
    return (q[:, :, qs].contiguous(), k[:, :, ks].contiguous(),
            v[:, :, ks].contiguous()), qs


@pytest.mark.cuda
def test_k2_at_a_ranks_heads(cuda_device):
    q, k, v, mask = _decoder_operands(cuda_device, 2, 3072, 16, 8, 128,
                                      ragged=True, seed=1)
    whole = fa.decoder_attention(q, k, v, mask)
    for j in range(2):
        (qj, kj, vj), qs = _rank(q, k, v, j)
        got = fa.decoder_attention(qj, kj, vj, mask)
        _close(got, fa.decoder_attention_plain(qj, kj, vj, mask))
        assert torch.equal(got, whole[:, :, qs])


@pytest.mark.cuda
def test_k2_lse_k4a_k4b_at_a_ranks_heads(cuda_device):
    """Training's K2 with the lse and its backward K4a/K4b at a rank's 8/4
    heads, through the autograd Function against the twins, and the
    rank's gradients against the whole layer's on its heads (bit-equal,
    the dK/dV of a kv head summed over its own query group only)."""
    dev = cuda_device
    q, k, v, mask = _decoder_operands(dev, 1, 799, 16, 8, 128, ragged=False,
                                      seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    dout = _randn(g, dev, 1, 799, 16, 128)
    scale = 128 ** -0.5

    def grads(q, k, v, dout):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fa.decoder_attention(*leaves, mask)
        return (out.detach(),) + torch.autograd.grad(out, leaves, dout)

    whole = grads(q, k, v, dout)
    for j in range(2):
        (qj, kj, vj), qs = _rank(q, k, v, j)
        dj = dout[:, :, qs].contiguous()
        out, lse = fa._decoder_attention_fwd(qj, kj, vj, mask, None, scale,
                                             with_lse=True)
        ref, ref_lse = fa.decoder_attention_plain(qj, kj, vj, mask,
                                                  return_lse=True)
        _close(out, ref)
        assert (lse - ref_lse).abs().max().item() <= LSE_TOL
        got = grads(qj, kj, vj, dj)
        want = fa.decoder_attention_bwd_plain(
            qj, kj, vj, dj, lse, fa.attention_delta(out, dj), mask, None,
            scale)
        for name, a, b in zip(("dq", "dk", "dv"), got[1:], want):
            _close(a, b)
        ks = slice(j * 4, (j + 1) * 4)
        for a, b in zip(got, (whole[0][:, :, qs], whole[1][:, :, qs],
                              whole[2][:, :, ks], whole[3][:, :, ks])):
            assert torch.equal(a, b)
