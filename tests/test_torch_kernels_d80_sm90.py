"""K1 and its key-norm pre-pass at the Qwen2-VL vision tower's head dim of 80
on the card (``Config<80, 2, 3>`` of ``csrc/decoder_attention_sm90.cuh``:
D128's layout, two 64-column boxes a row with columns 80-127 TMA's zero
fill, the output stored at an 80-element row stride;
``key_norm_partial_kernel<80>``, 16 lanes a key of which 6 add nothing).

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_d80_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerances: K1's output within 2^-7
of max|plain| of its twin (one bf16 ulp of the largest output: kernel and
twin round p to bf16 alike and differ in fp32 summation order), every
element of every row; the op bit-equal to the kernel alone on the
standalone kmax; two launches bit-identical; the pre-pass's kmax within
1e-6 of its twin and the same bits for every chunk count.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa

D = 80
REL_TOL = 2 ** -7
PREPASS_REL_TOL = 1e-6
# (B, S, H): one key, each side of the 128-row q and 128-key tiles, and
# the tower's slabs: 8 frames at 364 px (4, 676) and at 280 x 504 (4, 720).
SHAPES = ((1, 1, 2), (2, 127, 2), (1, 128, 4), (3, 129, 2), (2, 257, 16),
          (4, 676, 16), (4, 720, 16))


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
    """q, k, v as the tower makes them: q and k dense (after the rotary),
    v a strided view into the (B, S, 3 H D) qkv product; with ``views``
    all three are views into it."""
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device=dev)
    qkv[:, :, 1] *= 3 * torch.rand((B, S, 1, H, 1), generator=gen,
                                   device=dev)[:, :, 0] + 0.2
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if not views:
        q, k = q.contiguous(), k.contiguous()
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["dense", "qkv_views"])
def test_k1_op_and_kernel_alone_at_d80(cuda_device, views):
    g = torch.Generator(device=cuda_device).manual_seed(80)
    for B, S, H in SHAPES:
        q, k, v = _qkv(g, cuda_device, B, S, H, views)
        scale = D ** -0.5
        before = dict(kernels.launch_counts)
        got = kernels.vit_attention_op(q, k, v, scale)
        for name in ("vit_attention", "key_norm_max", "vit_attention_d80",
                     "key_norm_max_d80"):
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
        # Every row and column, the last row's last columns included.
        assert _rel(got[:, -1], ref[:, -1]) <= REL_TOL, (B, S, H)
        assert _rel(got[..., 64:], ref[..., 64:]) <= REL_TOL, (B, S, H)


@pytest.mark.cuda
def test_flash_attention_routes_d80_to_k1(cuda_device):
    """``flash_attention(norm_bound=True)`` non-causal and maskless at
    D = 80 launches the K1 op (one K1, one pre-pass), under no_grad."""
    g = torch.Generator(device=cuda_device).manual_seed(81)
    q, k, v = _qkv(g, cuda_device, 4, 676, 16, False)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, norm_bound=True)
    torch.cuda.synchronize()
    want = kernels.vit_attention_op(q, k, v, D ** -0.5)
    assert torch.equal(got, want)
    assert kernels.launch_counts["vit_attention_d80"] == \
        before["vit_attention_d80"] + 2


@pytest.mark.cuda
def test_key_norm_max_at_d80_is_the_same_for_every_chunk_count(cuda_device):
    """The 6 idle lanes of each key add nothing: kmax within 1e-6 of the
    twin, whose sums see only the 80 columns, at every chunk count."""
    g = torch.Generator(device=cuda_device).manual_seed(82)
    for B, S, H in SHAPES:
        _, k, _ = _qkv(g, cuda_device, B, S, H, True)
        want = fa.key_norm_max(k)
        got = kernels.key_norm_max(k)
        assert _rel(got, want) <= PREPASS_REL_TOL, (B, S, H)
        plan = kernels.key_norm_parts(B, S, H, D)
        for parts in sorted({min(S, n) for n in (1, 2, 3, 7, plan, S)}):
            assert torch.equal(kernels.key_norm_max(k, parts=parts),
                               got), (B, S, H, parts)


@pytest.mark.cuda
def test_d80_forms_not_built_are_refused(cuda_device):
    """K1 with the lse and K4 nc are not built at D = 80: the wrappers
    refuse the head dim and the C entries return an error, launching
    nothing; autograd through the ViT attention raises."""
    g = torch.Generator(device=cuda_device).manual_seed(83)
    q, k, v = _qkv(g, cuda_device, 1, 64, 2, False)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="built for head dim 64"):
        kernels.vit_attention_op(q, k, v, 1.0, with_lse=True)
    with pytest.raises(ValueError, match="built for head dim 64"):
        kernels.vit_attention(q, k, v, kernels.key_norm_max(k), 1.0,
                              with_lse=True)
    lse = torch.zeros((1, 2, 64), device=cuda_device)
    for fn in (kernels.vit_attention_bwd_dkdv, kernels.vit_attention_bwd_dq):
        with pytest.raises(ValueError, match="built for head dim 64"):
            fn(q, k, v, q, lse, lse, 1.0)
    lib = kernels._load()
    out = torch.empty_like(q)
    kmax = torch.ones((1, 2), device=cuda_device)
    err = lib.mjv_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(),
        out.data_ptr(), lse.data_ptr(), 1, 64, 2, D, q.stride(0),
        q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), 1.0,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    before["key_norm_max"] += 1
    before["key_norm_max_d80"] += 1
    assert kernels.launch_counts == before
    qg = q.float().requires_grad_()
    with pytest.raises(NotImplementedError, match="Queue 2 item 2"):
        fa.vit_attention(qg, k.float(), v.float())
