"""K1, K1m and their key-norm pre-pass at SigLIP-so400m's head dim of 72 on
the card (``Config<72, 2, 3>`` of ``csrc/decoder_attention_sm90.cuh``: two
64-column boxes a row with columns 72-127 TMA's zero fill, q k^T over 5
k-steps, the output stored at a 72-element row stride; K1m is K2's masked
path with ``CAUSAL = false``; ``key_norm_partial_kernel<72>``, 16 lanes a
key of which 7 add nothing).

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_d72_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerances: each output within 2^-7
of max|plain| of its twin (one bf16 ulp of the largest output: kernel and
twin round p to bf16 alike and differ in fp32 summation order), every
element of every row; each op bit-equal to its kernel alone on the
standalone kmax; two launches bit-identical; the pre-pass's kmax within
1e-6 of its twin and the same bits for every chunk count; K1m's rows of an
image with no live patch exactly 0.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa

D = 72
REL_TOL = 2 ** -7
PREPASS_REL_TOL = 1e-6
# (B, S, H): one key, each side of the 128-row q and 128-key tiles, one
# 16-head frame of MiniCPM-V's 24 x 43 grid, VideoScore's 39 x 70 and a
# 980 x 980 frame's 70 x 70 (past the 4,096 keys where JAX leaves its
# maskless kernel).
SHAPES = ((1, 1, 2), (2, 127, 2), (1, 128, 4), (3, 129, 2), (2, 257, 16),
          (2, 1032, 16), (2, 2730, 16), (1, 4900, 16))
# (images, grid h, grid w, live grids): VideoScore's split frames, the
# quadrants' 27 x 45 and the original's 39 x 70 on a 39 x 70 grid; uneven
# grids at the tile edges; an image with no live patch.
MASKED = ((5, 39, 70, ((27, 45),) * 4 + ((39, 70),)),
          (3, 9, 15, ((9, 14), (5, 15), (1, 1))),
          (2, 12, 11, ((12, 11), (0, 0))))


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
    """q, k, v as the tower makes them: dense outputs of three projections,
    or, with ``views``, strided views into one (B, S, 3 H D) product (a row
    of 3 x 16 x 144 bytes, k's base 2,304 bytes in: 16-byte multiples)."""
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device=dev)
    qkv[:, :, 1] *= 3 * torch.rand((B, S, 1, H, 1), generator=gen,
                                   device=dev)[:, :, 0] + 0.2
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if not views:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _patch_mask(n, gh, gw, live, dev):
    """(n, gh * gw) int32: image i's top-left live[i] patches, the rest
    padding (bottom/right), as ``videoscore_forward`` pools it."""
    m = torch.zeros((n, gh, gw), dtype=torch.int32, device=dev)
    for i, (h, w) in enumerate(live):
        m[i, :h, :w] = 1
    return m.reshape(n, gh * gw)


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["dense", "qkv_views"])
def test_k1_op_and_kernel_alone_at_d72(cuda_device, views):
    g = torch.Generator(device=cuda_device).manual_seed(72)
    for B, S, H in SHAPES:
        q, k, v = _qkv(g, cuda_device, B, S, H, views)
        scale = D ** -0.5
        before = dict(kernels.launch_counts)
        got = kernels.vit_attention_op(q, k, v, scale)
        for name in ("vit_attention", "key_norm_max", "vit_attention_d72",
                     "key_norm_max_d72"):
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
        # Every row and column, the last row's and the second box's too.
        assert _rel(got[:, -1], ref[:, -1]) <= REL_TOL, (B, S, H)
        assert _rel(got[..., 64:], ref[..., 64:]) <= REL_TOL, (B, S, H)


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["dense", "qkv_views"])
def test_masked_op_and_kernel_alone_at_d72(cuda_device, views):
    g = torch.Generator(device=cuda_device).manual_seed(73)
    H = 16
    for n, gh, gw, live in MASKED:
        S = gh * gw
        q, k, v = _qkv(g, cuda_device, n, S, H, views)
        mask = _patch_mask(n, gh, gw, live, cuda_device)
        scale = D ** -0.5
        before = dict(kernels.launch_counts)
        got = kernels.vit_attention_masked_op(q, k, v, mask, scale)
        for name in ("vit_attention_masked", "key_norm_max",
                     "key_norm_max_d72", "key_norm_max_masked_d72"):
            assert kernels.launch_counts[name] == before[name] + 1, name
        assert kernels.launch_counts["vit_attention"] == \
            before["vit_attention"]
        again = kernels.vit_attention_masked_op(q, k, v, mask, scale)
        kmax = kernels.key_norm_max(k, mask)
        alone = kernels.vit_attention_masked(q, k, v, mask, kmax, scale)
        ref = fa.vit_attention_masked_plain(q, k, v, mask)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), (n, gh, gw)
        assert torch.equal(got, alone), (n, gh, gw)
        assert torch.equal(got, again), (n, gh, gw)
        assert _rel(got, ref) <= REL_TOL, (n, gh, gw, _rel(got, ref))
        for i, (h, w) in enumerate(live):
            if h * w == 0:  # no live key: every row 0
                assert not got[i].any(), (n, gh, gw, i)
            else:
                assert _rel(got[i], ref[i]) <= REL_TOL, (n, gh, gw, i)
        # A masked key moves nothing: changing it leaves the output.
        k2, v2 = k.clone(), v.clone()
        dead = mask == 0
        k2[dead] = 7.0
        v2[dead] = -7.0
        assert torch.equal(
            kernels.vit_attention_masked(q, k2, v2, mask, kmax, scale),
            alone), (n, gh, gw)


@pytest.mark.cuda
def test_flash_attention_routes_d72(cuda_device):
    """``flash_attention(norm_bound=True)`` non-causal at D = 72 launches
    the K1 op without a mask and the K1m op with one (each one kernel and
    one pre-pass), under no_grad; grouped heads with a mask still raise."""
    g = torch.Generator(device=cuda_device).manual_seed(74)
    q, k, v = _qkv(g, cuda_device, 2, 1032, 16, False)
    mask = _patch_mask(2, 24, 43, ((24, 43), (20, 30)), cuda_device)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, norm_bound=True)
        got_m = fa.flash_attention(q, k, v, mask, norm_bound=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts["vit_attention_d72"] == \
        before["vit_attention_d72"] + 1
    assert kernels.launch_counts["vit_attention_masked"] == \
        before["vit_attention_masked"] + 1
    assert torch.equal(got, kernels.vit_attention_op(q, k, v, D ** -0.5))
    assert torch.equal(got_m, kernels.vit_attention_masked_op(
        q, k, v, mask, D ** -0.5))
    with pytest.raises(NotImplementedError, match="grouped"):
        fa.flash_attention(q, k[:, :, :8], v[:, :, :8], mask,
                           norm_bound=True)


@pytest.mark.cuda
def test_key_norm_max_at_d72_masked_or_not_every_chunk_count(cuda_device):
    """The 7 idle lanes of each key add nothing and a masked key gives
    nothing: kmax within 1e-6 of the twin, whose sums see only the 72
    columns and the live keys, at every chunk count."""
    g = torch.Generator(device=cuda_device).manual_seed(75)
    for B, S, H in SHAPES:
        _, k, _ = _qkv(g, cuda_device, B, S, H, True)
        mask = (torch.rand((B, S), generator=g, device=cuda_device)
                < 0.7).to(torch.int32)
        for m in (None, mask):
            want = fa.key_norm_max(k, m)
            got = kernels.key_norm_max(k, m)
            assert _rel(got, want) <= PREPASS_REL_TOL, (B, S, H)
            plan = kernels.key_norm_parts(B, S, H, D)
            for parts in sorted({min(S, n) for n in (1, 2, 3, 7, plan, S)}):
                assert torch.equal(kernels.key_norm_max(k, m, parts=parts),
                                   got), (B, S, H, parts)


@pytest.mark.cuda
def test_d72_forms_not_built_are_refused(cuda_device):
    """K1 with the lse and K4 nc are not built at D = 72, nor K1m at any
    other head dim: the wrappers refuse, the C entries return an error,
    nothing launches; autograd through either form raises."""
    g = torch.Generator(device=cuda_device).manual_seed(76)
    q, k, v = _qkv(g, cuda_device, 1, 64, 2, False)
    mask = torch.ones((1, 64), dtype=torch.int32, device=cuda_device)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="built for head dim 64"):
        kernels.vit_attention_op(q, k, v, 1.0, with_lse=True)
    lse = torch.zeros((1, 2, 64), device=cuda_device)
    for fn in (kernels.vit_attention_bwd_dkdv, kernels.vit_attention_bwd_dq):
        with pytest.raises(ValueError, match="built for head dim 64"):
            fn(q, k, v, q, lse, lse, 1.0)
    q64 = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16,
                      device=cuda_device)
    with pytest.raises(ValueError, match="built for head dim 72"):
        kernels.vit_attention_masked_op(q64, q64, q64, mask, 1.0)
    lib = kernels._load()
    out = torch.empty_like(q64)
    kmax = torch.ones((1, 2), device=cuda_device)
    err = lib.mjv_vit_attention_masked(
        q64.data_ptr(), q64.data_ptr(), q64.data_ptr(), mask.data_ptr(),
        kmax.data_ptr(), out.data_ptr(), 1, 64, 2, 64, q64.stride(0),
        q64.stride(1), q64.stride(0), q64.stride(1), q64.stride(0),
        q64.stride(1), 1.0, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    assert kernels.launch_counts == before
    qg = q.float().requires_grad_()
    with pytest.raises(NotImplementedError, match="Queue 2 item 2"):
        fa.vit_attention(qg, k.float(), v.float())
    with pytest.raises(NotImplementedError, match="Queue 2 item 2"):
        fa.vit_attention_masked(qg, k.float(), v.float(), mask)
