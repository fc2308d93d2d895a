"""K3 not causal at the EVA2-CLIP-E tower's head dim of 112 on the card
(``Config<112, 2, 3>`` of ``csrc/decoder_attention_sm90.cuh``: two 64-column
boxes a row, the second holding 48 real columns and 16 of TMA's zero fill,
q k^T over exactly 7 k-steps, p v at n128, the output stored at a
112-element row stride; launched by ``csrc/exact_attention.cu`` with
``CAUSAL = false`` only).

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_d112_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerances: each output within 2^-7
of max|plain| of its twin (one bf16 ulp of the largest output: kernel and
twin round p to bf16 alike and differ in fp32 summation order), every row
and every column, the last row's and the second box's included; two
launches bit-identical; every refusal before any launch.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa
from mjvideo_tpu_torch.ops.attention import multi_head_attention

D = 112
REL_TOL = 2 ** -7
# (B, Q, K, H): one key; each side of the 128-row q tile and the 128-key
# tile; a 224 px frame's 257 tokens (the last key tile one live key) at the
# tower's 16 heads, a video's 8 frames; whole tiles (Q = K = 1024); queries
# over more keys than rows.
SHAPES = ((1, 1, 1, 2), (2, 127, 127, 2), (1, 128, 128, 4),
          (3, 129, 129, 2), (2, 257, 257, 16), (8, 257, 257, 16),
          (2, 1024, 1024, 16), (1, 100, 257, 4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _rel(got, ref):
    top = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / max(top, 1e-30)


def _qkv(gen, dev, B, Q, K, H, views):
    """q, k, v as the tower makes them: strided views into one (B, S, 3, H,
    D) product (a row of 3 x H x 224 bytes, k's base H x 224 bytes in:
    16-byte multiples), or dense heads; the keys' norms spread, as a
    post-norm tower's un-normalised residual gives them."""
    S = max(Q, K)
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device=dev)
    qkv[:, :, 1] *= 4 * torch.rand((B, S, 1, H, 1), generator=gen,
                                   device=dev)[:, :, 0] + 0.2
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :Q, 0], qkv[:, :K, 1], qkv[:, :K, 2]
    if not views:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["dense", "qkv_views"])
def test_k3_at_d112_not_causal(cuda_device, views):
    g = torch.Generator(device=cuda_device).manual_seed(112)
    scale = D ** -0.5
    for B, Q, K, H in SHAPES:
        q, k, v = _qkv(g, cuda_device, B, Q, K, H, views)
        before = dict(kernels.launch_counts)
        got = kernels.exact_attention(q, k, v, None, None, scale,
                                      causal=False)
        for name in ("exact_attention", "exact_attention_d112"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        again = kernels.exact_attention(q, k, v, None, None, scale,
                                        causal=False)
        ref = fa.exact_attention_plain(q, k, v, causal=False)
        torch.cuda.synchronize()
        shape = (B, Q, K, H)
        assert got.shape == (B, Q, H, D) and got.is_contiguous()
        assert torch.isfinite(got).all(), shape
        assert torch.equal(got, again), shape
        assert _rel(got, ref) <= REL_TOL, (shape, _rel(got, ref))
        # Every row and column: the last row's, and the second box's 48.
        assert _rel(got[:, -1], ref[:, -1]) <= REL_TOL, shape
        assert _rel(got[..., 64:], ref[..., 64:]) <= REL_TOL, shape
        assert _rel(got[..., 96:], ref[..., 96:]) <= REL_TOL, shape


@pytest.mark.cuda
def test_tower_route_launches_k3_at_d112(cuda_device):
    """``multi_head_attention(causal=False)`` and ``flash_attention`` at
    D = 112, under no_grad, launch K3 (no pre-pass, no bound kernel) and
    return its output."""
    g = torch.Generator(device=cuda_device).manual_seed(113)
    q, k, v = _qkv(g, cuda_device, 8, 257, 257, 16, True)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        a = multi_head_attention(q, k, v, causal=False)
        b = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = dict(kernels.launch_counts)
    changed = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    assert changed == {"exact_attention": 2, "exact_attention_d112": 2}
    want = kernels.exact_attention(q, k, v, None, None, D ** -0.5,
                                   causal=False)
    assert torch.equal(a, want) and torch.equal(b, want)


@pytest.mark.cuda
def test_d112_forms_not_built_are_refused(cuda_device):
    """K3 causal, K3 lse and the backward are not built at D = 112: the
    wrappers refuse, the C entry returns an error, nothing launches; a
    causal tower call raises rather than falling back."""
    g = torch.Generator(device=cuda_device).manual_seed(114)
    q, k, v = _qkv(g, cuda_device, 1, 64, 64, 2, False)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="built for head dim 96 or 128"):
        kernels.exact_attention(q, k, v, None, None, 1.0, causal=True)
    with pytest.raises(ValueError, match="built for head dim 96 or 128"):
        kernels.exact_attention(q, k, v, None, None, 1.0, causal=False,
                                with_lse=True)
    with pytest.raises(ValueError, match="built for head dim 96 or 128"):
        fa.exact_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="built for head dim 96 or 128"):
        fa.exact_attention_with_lse(q, k, v, causal=False)
    lse = torch.zeros((1, 2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="built for head dim 96 or 128"):
        kernels.decoder_attention_bwd_dq(q, k, v, q, lse, lse, None, None,
                                         1.0)
    lib = kernels._load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    strides = (q.stride(0), q.stride(1)) * 3
    for causal, lse_ptr in ((1, None), (0, lse.data_ptr()),
                            (1, lse.data_ptr())):
        err = lib.mjv_exact_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
            out.data_ptr(), lse_ptr, 1, 64, 64, 2, 2, D, *strides, 1.0,
            causal, stream)
        assert err != 0, (causal, lse_ptr)
    assert kernels.launch_counts == before
    qg = q.float().requires_grad_()
    with pytest.raises(ValueError, match="built for head dim 96 or 128"):
        fa.exact_attention(qg.to(torch.bfloat16), k, v, causal=False)
