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
and K4b at a training prompt of 799 tokens, every key live.  The judges'
towers and decoders on a mesh: K1 at 8 of SigLIP's 16 heads of 72, 8 of
the Qwen2-VL tower's 16 heads of 80 and 5 of InternViT-6B's 25 heads of
128 (q and k dense, as its QK-norm makes them); K1m at 8 of SigLIP's heads
under a patch mask; K3 not causal at 8 of EVA's 16 heads of 112; K3 at
each judge decoder's rank heads (8/4, 14/2, 24/4, 16/4 of 128) over a
cache with a suffix's ``q_offset``, and K2r at 8/4 over a prefix.  A
rank's heads are bit-equal to the whole layer's for K1 (its bound's key
norms are per head) and for K3 (exact, per head).
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


@pytest.mark.cuda
@pytest.mark.parametrize("H,D,m,dense", [(16, 72, 2, False),
                                         (16, 80, 2, False),
                                         (25, 128, 5, True)],
                         ids=["siglip", "qwen2vl", "internvit6b"])
def test_k1_at_a_judge_towers_rank_heads(cuda_device, H, D, m, dense):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(4)
    qkv = _randn(g, dev, 4, 1025, 3 * H * D)
    q, k, v = _vit_views(qkv, H, D)
    if dense:
        q, k = q.contiguous(), k.contiguous()
    whole = fa.vit_attention(q, k, v)
    n = H // m
    for j in range(m):
        hs = slice(j * n, (j + 1) * n)
        qj, kj, vj = (t[:, :, hs].contiguous() for t in (q, k, v))
        got = fa.vit_attention(qj, kj, vj)
        _close(got, fa.vit_attention_plain(qj, kj, vj))
        assert torch.equal(got, whole[:, :, hs])


@pytest.mark.cuda
def test_k1m_at_a_ranks_heads(cuda_device):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(5)
    N, S = 4, 2730
    q, k, v = (_randn(g, dev, N, S, 8, 72) for _ in range(3))
    live = torch.tensor([2730, 1242, 1242, 2000], device=dev)
    mask = (torch.arange(S, device=dev)[None] < live[:, None]).to(
        torch.int32)
    got = fa.vit_attention_masked(q, k, v, mask)
    _close(got, fa.vit_attention_masked_plain(q, k, v, mask))


@pytest.mark.cuda
def test_k3_d112_at_a_ranks_heads(cuda_device):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(6)
    H, D = 16, 112
    q, k, v = _vit_views(_randn(g, dev, 8, 257, 3 * H * D), H, D)
    whole = fa.exact_attention(q, k, v, causal=False)
    for j in range(2):
        hs = slice(j * 8, (j + 1) * 8)
        qj, kj, vj = (t[:, :, hs].contiguous() for t in (q, k, v))
        got = fa.exact_attention(qj, kj, vj, causal=False)
        _close(got, fa.exact_attention_plain(qj, kj, vj, causal=False))
        assert torch.equal(got, whole[:, :, hs])


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(8, 4), (14, 2), (24, 4), (16, 4)],
                         ids=["internlm2-1.8b", "qwen2-7b", "internlm2-20b",
                              "llama3-mistral"])
def test_k3_continuation_at_a_decoders_rank_heads(cuda_device, Hq, Hkv):
    """A suffix of 128 queries at slots 2308 + i over a cache of 2,560
    slots, 25 suffix slots live: K3 at a rank's heads against its twin,
    and the whole layer's K3 (twice the heads) on those heads."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(7)
    B, Q, K, D, P = 2, 128, 2560, 128, 2308
    q = _randn(g, dev, B, Q, 2 * Hq, D)
    k, v = _randn(g, dev, B, K, 2 * Hkv, D), _randn(g, dev, B, K, 2 * Hkv, D)
    mask = torch.zeros((B, K), dtype=torch.int32, device=dev)
    mask[:, :P + 25] = 1
    off = torch.full((B,), P, dtype=torch.int32, device=dev)
    whole = fa.exact_attention(q, k, v, mask, off)
    for j in range(2):
        (qj, kj, vj), qs = _rank(q, k, v, j)
        got = fa.exact_attention(qj, kj, vj, mask, off)
        _close(got, fa.exact_attention_plain(qj, kj, vj, mask, off))
        assert torch.equal(got, whole[:, :, qs])


@pytest.mark.cuda
def test_k2r_prefix_at_a_ranks_heads(cuda_device):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (_randn(g, dev, 1, 2368, h, 128) for h in (8, 4, 4))
    mask = torch.ones((1, 2368), dtype=torch.int32, device=dev)
    mask[:, 2308:] = 0
    got = fa.decoder_attention_rows(q, k, v, mask)
    _close(got, fa.decoder_attention_rows_plain(q, k, v, mask))
