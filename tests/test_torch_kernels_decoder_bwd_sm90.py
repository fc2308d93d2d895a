"""K4a dK/dV and K4b dQ (the decoder attention backward on the Hopper
template ``csrc/attention_bwd_sm90.cuh`` at D = 128) against their plain
twin, on a card.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_decoder_bwd_sm90.py --noconftest -m cuda -q

Without a card every test here skips.  Tolerance, the bound
``chip_smoke.py`` states: each bf16 gradient to max|kernel - plain| /
max|plain| <= 2**-7, one bf16 ulp of the largest gradient at worst; exact
zeros where the twin has them by construction (dead rows, masked keys, a
chunk no row sees).  The sizes put T on each side of the template's tile
edges (32 q rows or 64 keys streamed, 128 keys or q rows held a CTA), the
ring's chunk offsets at T = 3,072 over 4 shards, and the all-gather
shard's 768 rows against 3,072 keys.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa

TILE_EDGES = (63, 64, 65, 127, 128, 129, 191, 192, 193)
RING_OFFSETS = (-768, 0, 768, 2304)
L = 768  # a ring chunk of T = 3,072 over 4 shards
D = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _operands(dev, B, Q, K, Hq, Hkv, seed, mask=None, off=None,
              causal=True):
    """q, k, v, a random dO, the twin's lse (1e30 on dead rows) and delta,
    the mask and offset: the kernels' operands."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, dout = _randn(g, dev, B, Q, Hq, D), _randn(g, dev, B, Q, Hq, D)
    k, v = _randn(g, dev, B, K, Hkv, D), _randn(g, dev, B, K, Hkv, D)
    out, lse = fa.exact_attention_plain(q, k, v, mask, off, causal=causal,
                                        return_lse=True)
    return (q, k, v, dout, lse.contiguous(), fa.attention_delta(out, dout),
            mask, off)


def _offset(dev, o, B=1):
    return torch.full((B,), o, dtype=torch.int32, device=dev)


def _run(args, causal=True):
    scale = D ** -0.5
    dk, dv = kernels.decoder_attention_bwd_dkdv(*args, scale, causal)
    dq = kernels.decoder_attention_bwd_dq(*args, scale, causal)
    return dq, dk, dv


def _assert_matches_twin(args, causal=True):
    got = _run(args, causal)
    want = fa.decoder_attention_bwd_plain(*args, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.is_contiguous(), name
        assert torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2 ** -7 * w.float().abs().max().item(), (name, err)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("T", TILE_EDGES)
def test_k4_matches_twin_at_tile_edges(cuda_device, T):
    """Causal, GQA 4/2, batch 1 with its first 5 keys and its last 10
    masked (dead rows and masked keys): the launch counters move by one
    each, dq exactly 0 on dead rows, dk and dv exactly 0 on masked keys."""
    mask = torch.ones((2, T), dtype=torch.int32, device=cuda_device)
    mask[1, :5] = 0
    mask[1, T - 10:] = 0
    args = _operands(cuda_device, 2, T, T, 4, 2, T, mask)
    before = dict(kernels.launch_counts)
    dq, dk, dv = _assert_matches_twin(args)
    for name in ("decoder_attention_bwd_dkdv", "decoder_attention_bwd_dq"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    assert not dq[1, :5].any()
    assert not dk[mask == 0].any() and not dv[mask == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("T", (65, 193))
def test_k4_non_causal_with_mask_matches_twin(cuda_device, T):
    mask = torch.ones((2, T), dtype=torch.int32, device=cuda_device)
    mask[0, T // 3:T // 2] = 0
    args = _operands(cuda_device, 2, T, T, 4, 2, T + 7, mask, causal=False)
    _, dk, dv = _assert_matches_twin(args, causal=False)
    assert not dk[mask == 0].any() and not dv[mask == 0].any()
    # And without a mask.
    args = _operands(cuda_device, 2, T, T, 4, 2, T + 8, causal=False)
    _assert_matches_twin(args, causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("rel", RING_OFFSETS)
def test_k4_matches_twin_at_ring_offsets(cuda_device, rel):
    """A ring chunk (1, 768, 768, 16/8, 128) at q_offset rel, the first 5
    keys masked: at -768 every key lies above the diagonal, so every CTA
    walks nothing and every output is exactly 0."""
    mask = torch.ones((1, L), dtype=torch.int32, device=cuda_device)
    mask[:, :5] = 0
    args = _operands(cuda_device, 1, L, L, 16, 8, 40 + rel // 768, mask,
                     _offset(cuda_device, rel))
    got = _assert_matches_twin(args)
    if rel == -L:
        assert not any(g.any() for g in got)
    else:
        assert all(g.any() for g in got)


@pytest.mark.cuda
def test_k4_all_gather_shape_matches_twin(cuda_device):
    """768 q rows at q_offset 2,304 against all 3,072 keys (Q != K), the
    bucket's last 600 keys masked."""
    mask = torch.ones((1, 4 * L), dtype=torch.int32, device=cuda_device)
    mask[:, 4 * L - 600:] = 0
    args = _operands(cuda_device, 1, L, 4 * L, 16, 8, 50, mask,
                     _offset(cuda_device, 3 * L))
    _, dk, dv = _assert_matches_twin(args)
    assert not dk[mask == 0].any() and not dv[mask == 0].any()


@pytest.mark.cuda
def test_k4_fully_masked_key_blocks_write_zeros(cuda_device):
    """Keys 128-383 (two whole dK/dV blocks of 128 keys) masked: their
    CTAs walk nothing and write exact zeros, and every output matches the
    twin (dQ's tiles over those keys take the per-score mask)."""
    T = 512
    mask = torch.ones((1, T), dtype=torch.int32, device=cuda_device)
    mask[:, 128:384] = 0
    args = _operands(cuda_device, 1, T, T, 4, 2, 60, mask)
    _, dk, dv = _assert_matches_twin(args)
    assert not dk[:, 128:384].any() and not dv[:, 128:384].any()
    assert dk[:, :128].any() and dk[:, 384:].any()


@pytest.mark.cuda
def test_k4_two_launches_are_bit_identical(cuda_device):
    """No atomics: every output row is summed by one thread in a fixed
    order, at the reward gradient's (1, 3072, 16/8, 128) with 2,362 live
    keys."""
    mask = torch.ones((1, 3072), dtype=torch.int32, device=cuda_device)
    mask[:, 2362:] = 0
    args = _operands(cuda_device, 1, 3072, 3072, 16, 8, 7, mask)
    first, second = _run(args), _run(args)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_k4_wrappers_refuse_what_the_template_cannot_take(cuda_device):
    """A head dim other than 128, a row stride that is not a multiple of
    16 bytes and a base that is not 16-byte aligned each raise before a
    launch: there is no fallback."""
    args = list(_operands(cuda_device, 1, 64, 64, 4, 2, 3))
    g = torch.Generator(device=cuda_device).manual_seed(4)
    for fn in (kernels.decoder_attention_bwd_dkdv,
               kernels.decoder_attention_bwd_dq):
        small = [a[..., :64].contiguous() if i < 4 else a
                 for i, a in enumerate(args)]
        with pytest.raises(ValueError, match="head dim"):
            fn(*small, 64 ** -0.5)
        wide = _randn(g, cuda_device, 1, 64, 4 * D + 4)
        q_bad = wide[..., :4 * D].view(1, 64, 4, D)  # row stride 516
        with pytest.raises(ValueError, match="16-byte"):
            fn(q_bad, *args[1:], D ** -0.5)
        flat = _randn(g, cuda_device, 64 * 2 * D + 8)
        k_bad = flat[1:1 + 64 * 2 * D].view(1, 64, 2, D)  # base 2 bytes off
        with pytest.raises(ValueError, match="16-byte"):
            fn(args[0], k_bad, *args[2:], D ** -0.5)
