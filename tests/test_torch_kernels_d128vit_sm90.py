"""K1 at InternViT-6B's head dim of 128 with 25 heads on the card
(``Config<128, 2, 3>`` of ``csrc/decoder_attention_sm90.cuh``, K2's Config,
not causal, ``ShiftMode::kKeyMax`` with the 1e-30 floor; two full
64-column boxes a row), behind its pre-pass ``key_norm_partial_kernel<128>``.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_d128vit_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  The operands come as the 6B tower
makes them: q and k dense 3200-element rows (QK-RMSNorm writes them), v a
view into the qkv product with 9600-element rows; and all three views.
Tolerances: K1's output within 2^-7 of max|plain| of its twin (one bf16
ulp of the largest output: kernel and twin round p to bf16 alike and
differ in fp32 summation order), the last row and the second box's
columns each on their own; the op bit-equal to the kernel alone on the
standalone kmax; two launches bit-identical; the pre-pass's kmax within
1e-6 of its twin and the same bits for every chunk count.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa

D = 128
REL_TOL = 2 ** -7
PREPASS_REL_TOL = 1e-6
# (B, S, H): one key, each side of the 128-row q and 128-key tiles (S = 129
# leaves one live key in the last key tile and one live row in the last q
# tile, as S = 1025 does), and the tower's 8 and 2 tiles of 1025 tokens.
SHAPES = ((1, 1, 25), (2, 127, 5), (1, 128, 4), (3, 129, 25), (2, 257, 25),
          (2, 1025, 25), (8, 1025, 25))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _rel(got, ref):
    top = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / max(top, 1e-30)


def _qkv(gen, dev, B, S, H, views):
    """q, k and v cut from one (B, S, 3 H D) product, k's norms spread; q
    and k dense copies unless ``views``."""
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device=dev)
    qkv[:, :, 1] *= 3 * torch.rand((B, S, 1, H, 1), generator=gen,
                                   device=dev)[:, :, 0] + 0.2
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if not views:
        q, k = q.contiguous(), k.contiguous()
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["dense_qk", "qkv_views"])
def test_k1_op_and_kernel_alone_at_d128(cuda_device, views):
    g = torch.Generator(device=cuda_device).manual_seed(128)
    for B, S, H in SHAPES:
        q, k, v = _qkv(g, cuda_device, B, S, H, views)
        scale = D ** -0.5
        before = dict(kernels.launch_counts)
        got = kernels.vit_attention_op(q, k, v, scale)
        for name in ("vit_attention", "key_norm_max", "vit_attention_d128"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        again = kernels.vit_attention_op(q, k, v, scale)
        kmax = kernels.key_norm_max(k)
        alone = kernels.vit_attention(q, k, v, kmax, scale)
        ref = fa.vit_attention_plain(q, k, v)
        torch.cuda.synchronize()
        assert got.shape == (B, S, H, D) and got.is_contiguous()
        assert torch.isfinite(got).all(), (B, S, H)
        assert torch.equal(got, alone), (B, S, H)
        assert torch.equal(got, again), (B, S, H)
        assert _rel(got, ref) <= REL_TOL, (B, S, H, _rel(got, ref))
        # The last row (the tail tile's one live row at S = 129 and 1025)
        # and the second 64-column box, each on its own.
        assert _rel(got[:, -1], ref[:, -1]) <= REL_TOL, (B, S, H)
        assert _rel(got[..., 64:], ref[..., 64:]) <= REL_TOL, (B, S, H)


@pytest.mark.cuda
def test_flash_attention_routes_d128_to_k1(cuda_device):
    """``flash_attention(norm_bound=True)`` non-causal and maskless at
    D = 128, and the ViT's ``multi_head_attention``, launch the K1 op (one
    K1, one pre-pass each) under no_grad, bit-equal to the op."""
    from mjvideo_tpu_torch.ops.attention import multi_head_attention

    g = torch.Generator(device=cuda_device).manual_seed(129)
    q, k, v = _qkv(g, cuda_device, 2, 1025, 25, False)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, norm_bound=True)
        mha = multi_head_attention(q, k, v, causal=False, norm_bound=True)
    torch.cuda.synchronize()
    want = kernels.vit_attention_op(q, k, v, D ** -0.5)
    assert torch.equal(got, want) and torch.equal(mha, want)
    assert kernels.launch_counts["vit_attention_d128"] == \
        before["vit_attention_d128"] + 3
    assert kernels.launch_counts["key_norm_max"] == \
        before["key_norm_max"] + 3


@pytest.mark.cuda
def test_key_norm_max_at_25_heads_of_128_is_the_same_for_every_chunk_count(
        cuda_device):
    """25 heads of 128 fill 50 of a pass's 64 key-vector slots (2 whole
    keys a pass): kmax within 1e-6 of the twin at every chunk count, the
    same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(130)
    for B, S, H in SHAPES:
        _, k, _ = _qkv(g, cuda_device, B, S, H, False)
        want = fa.key_norm_max(k)
        got = kernels.key_norm_max(k)
        assert _rel(got, want) <= PREPASS_REL_TOL, (B, S, H)
        plan = kernels.key_norm_parts(B, S, H, D)
        for parts in sorted({min(S, n) for n in (1, 2, 3, 7, plan, S)}):
            assert torch.equal(kernels.key_norm_max(k, parts=parts),
                               got), (B, S, H, parts)


@pytest.mark.cuda
def test_d128_k1_forms_not_built_are_refused(cuda_device):
    """K1 with the lse and K4 nc are not built at D = 128: the wrappers
    refuse the head dim and the C entries return an error, launching
    nothing but the op's pre-pass; autograd through the ViT attention at
    D = 128 raises naming the roadmap item."""
    g = torch.Generator(device=cuda_device).manual_seed(131)
    q, k, v = _qkv(g, cuda_device, 1, 64, 25, False)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="built for head dim 64"):
        kernels.vit_attention_op(q, k, v, 1.0, with_lse=True)
    with pytest.raises(ValueError, match="built for head dim 64"):
        kernels.vit_attention(q, k, v, kernels.key_norm_max(k), 1.0,
                              with_lse=True)
    lse = torch.zeros((1, 25, 64), device=cuda_device)
    for fn in (kernels.vit_attention_bwd_dkdv, kernels.vit_attention_bwd_dq):
        with pytest.raises(ValueError, match="built for head dim 64"):
            fn(q, k, v, q, lse, lse, 1.0)
    lib = kernels._load()
    out = torch.empty_like(q)
    kmax = torch.ones((1, 25), device=cuda_device)
    err = lib.mjv_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(),
        out.data_ptr(), lse.data_ptr(), 1, 64, 25, D, q.stride(0),
        q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), 1.0,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    before["key_norm_max"] += 1  # the standalone kmax above
    assert kernels.launch_counts == before
    qg = q.float().requires_grad_()
    with pytest.raises(NotImplementedError, match="K1 lse and K4 nc"):
        fa.vit_attention(qg, k.float(), v.float())
