"""K2r's pre-pass and B3 on the card: ``key_norm_cummax`` as the key-norm
partial pass (each key's norm and its chunk's max, plain stores) and a
scan behind it as a programmatic dependent, the K2r op (pre-pass and
kernel in one C call), and B3 as B2's hp 1 walk on the wgmma/TMA forward
template over its ``kv_valid`` keys.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_rows_bshd_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerances: kcum sums each key's
squares exactly in double, so it lies within PREPASS_REL_TOL of max|plain|
of its twin (fp32 sums in torch's order), and every chunk count, every
prefix of the keys and the op's own pre-pass give the same bits; its last
column is ``key_norm_max``'s to the bit.  The K2r op is bit-equal to the
kernel alone on the standalone kcum.  B3 is within 2**-7 of max|plain| of
its twin (``chip_smoke.py``'s bar) and, on its rows below ``kv_valid``,
bit-equal to B2 at hp 1 on q, k and v cut there.  k and v rows at and past
``kv_valid`` are NaN: B3 never reads them.
"""

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as fa
from mjvideo_tpu_torch.ops import vit_attention_variants as va

PREPASS_REL_TOL = 1e-6
REL_TOL = 2 ** -7
H, D = 4, 64
# chip_smoke.py's JUDGE_SHAPES: (B, Q, K, Hq, Hkv, D, q_offset).
JUDGE_SHAPES = {
    "prefill": (2, 3072, 3072, 16, 8, 128, None),
    "prefix": (1, 2368, 2368, 16, 8, 128, None),
    "continuation": (2, 128, 2560, 16, 8, 128, 2308),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _rel(got, want):
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    return err / top if top else (0.0 if err == 0.0 else float("inf"))


def _keys(gen, dev, B, K, Hkv):
    """bf16 keys with varied norms (so the running max steps up along K)
    as a strided view, a cache's (B, K, Hkv, 128) slots of a wider row."""
    scale = torch.rand((B, K, Hkv, 1), generator=gen, device=dev) * 3 + 0.2
    k = torch.randn((B, K, 2, Hkv, 128), generator=gen, device=dev)
    return (k[:, :, 0] * scale).to(torch.bfloat16)


def _mask(gen, dev, B, K, dead_row=True):
    mask = (torch.rand((B, K), generator=gen, device=dev) > 0.3).int()
    mask[:, 16:40] = 0  # at least one whole chunk of 12 keys or fewer
    if dead_row and B > 1:
        mask[1] = 0
    return mask


# (B, K, Hkv): one key, each side of one chunk, training's 799, the judge's
# prefix and prefill buckets, one key past the prefill's.
KCUM_CASES = ((2, 1, 8), (2, 12, 8), (2, 13, 8), (1, 799, 8), (1, 2368, 8),
              (2, 3072, 8), (2, 3073, 2))


@pytest.mark.cuda
def test_kcum_matches_its_twin_and_key_norm_max(cuda_device):
    """Against the twin to PREPASS_REL_TOL, never decreasing, 0 on a fully
    masked batch row; the last column bit-equal to ``key_norm_max``; one
    launch counted; a second launch and every chunk count the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    for B, K, Hkv in KCUM_CASES:
        k = _keys(g, cuda_device, B, K, Hkv)
        for mask in (_mask(g, cuda_device, B, K), None):
            before = kernels.launch_counts["key_norm_cummax"]
            got = kernels.key_norm_cummax(k, mask)
            assert kernels.launch_counts["key_norm_cummax"] == before + 1
            want = fa.key_norm_cummax(k, mask)
            assert got.shape == want.shape == (B, Hkv, K)
            assert _rel(got, want) <= PREPASS_REL_TOL, (B, K, Hkv)
            assert bool((got[..., 1:] >= got[..., :-1]).all())
            if mask is not None and B > 1:
                assert not got[1].any()
            assert torch.equal(got[..., -1], kernels.key_norm_max(k, mask))
            assert torch.equal(kernels.key_norm_cummax(k, mask), got)
            plan = kernels.key_norm_parts(B, K, Hkv, 128)
            for parts in sorted({min(K, n) for n in (1, 2, 7, plan, K)}):
                again = kernels.key_norm_cummax(k, mask, parts=parts)
                assert torch.equal(again, got), (B, K, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("K,P", [(3072, 2308), (3072, 1537), (3072, 12),
                                 (3072, 1), (2368, 2308), (2560, 2308)])
def test_kcum_of_a_prefix_is_the_prefix_of_kcum(cuda_device, K, P):
    """The pre-pass of k cut at P, under its own plan, equals the first P
    columns of the whole one's, bit for bit (K2r's prefix rows rest on
    it)."""
    g = torch.Generator(device=cuda_device).manual_seed(K + P)
    k = _keys(g, cuda_device, 2, K, 8)
    mask = _mask(g, cuda_device, 2, K, dead_row=False)
    full = kernels.key_norm_cummax(k, mask)
    cut = kernels.key_norm_cummax(k[:, :P], mask[:, :P].contiguous())
    assert torch.equal(cut, full[..., :P])


def _judge_inputs(gen, dev, shape):
    """chip_smoke's judge inputs: the prefill left-pads both rows, the
    prefix masks its bucket's tail, the continuation its cache's."""
    B, Q, K, Hq, Hkv, D_, off = shape

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = randn(B, Q, Hq, D_), randn(B, K, Hkv, D_), randn(B, K, Hkv, D_)
    mask = torch.ones((B, K), dtype=torch.int32, device=dev)
    if off is None and B == 2:
        mask[0, :56] = 0
        mask[1, :160] = 0
    elif off is None:
        mask[:, 2308:] = 0
    else:
        mask[:, off + 25:] = 0
        off = torch.full((B,), off, dtype=torch.int32, device=dev)
    return q, k, v, mask, off


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(JUDGE_SHAPES))
def test_k2r_op_is_the_kernel_alone_on_the_standalone_kcum(cuda_device,
                                                           name):
    """The K2r op (one C call: the partial pass, the scan and K2r, each
    behind the last as a programmatic dependent) bit-equal to K2r alone on
    ``kernels.key_norm_cummax``, a second launch bit-identical, one launch
    of each counter, and within 2**-7 of the twin."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    q, k, v, mask, off = _judge_inputs(g, cuda_device, JUDGE_SHAPES[name])
    scale = 128 ** -0.5
    before = dict(kernels.launch_counts)
    got = kernels.decoder_attention_rows_op(q, k, v, mask, off, scale)
    for counter in ("key_norm_cummax", "decoder_attention_rows"):
        assert kernels.launch_counts[counter] == before[counter] + 1
    again = kernels.decoder_attention_rows_op(q, k, v, mask, off, scale)
    kcum = kernels.key_norm_cummax(k, mask)
    alone = kernels.decoder_attention_rows(q, k, v, mask, kcum, off, scale)
    assert torch.equal(got, alone) and torch.equal(got, again)
    assert torch.equal(fa.decoder_attention_rows(q, k, v, mask, off), got)
    want = fa.decoder_attention_rows_plain(q, k, v, mask, off)
    assert _rel(got, want) <= REL_TOL


@pytest.mark.cuda
def test_k2r_pre_pass_refuses_what_it_was_not_built_for(cuda_device):
    k64 = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        kernels.key_norm_cummax(k64, None)
    k = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="parts"):
        kernels.key_norm_cummax(k, None, parts=9)
    lib = kernels._load()
    part = torch.empty(1, 1, 2, device=cuda_device)
    out = torch.empty(1, 2, 8, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    invalid = 1  # cudaErrorInvalidValue
    assert lib.mjv_key_norm_cummax(k64.data_ptr(), None, part.data_ptr(),
                                   out.data_ptr(), 1, 8, 2, 64, k64.stride(0),
                                   k64.stride(1), 1, stream) == invalid


def _qkv(seed, dev, B, S, kv):
    """q, k, v (B, S, H, D) bf16 views into one (B, S, 3 H D) qkv tensor,
    the k and v rows at and past ``kv`` NaN."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * D), generator=g, device=dev).to(
        torch.bfloat16)
    qkv[:, kv:, H * D:] = float("nan")
    return tuple(t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))


B3_CASES = [(S, kv) for S in (1, 37, 64, 65, 1025, 1032)
            for kv in sorted({min(S, n) for n in (1, 63, 64, 65, S)})]


@pytest.mark.cuda
@pytest.mark.parametrize("S,kv", B3_CASES)
def test_b3_over_its_live_keys(cuda_device, S, kv):
    """B3 with the keys at and past ``kv_valid`` NaN: finite, within 2**-7
    of its twin, its rows below ``kv_valid`` bit-equal to B2 hp 1 on q, k
    and v cut there, one launch counted, a second launch bit-identical."""
    q, k, v = _qkv(S * 7 + kv, cuda_device, 2, S, kv)
    before = kernels.launch_counts["vit_attention_bshd"]
    got = va.bshd_attention(q, k, v, kv)
    assert kernels.launch_counts["vit_attention_bshd"] == before + 1
    assert got.shape == (2, S, H * D) and torch.isfinite(got).all()
    want = va.bshd_attention_plain(q, k, v, kv)
    assert _rel(got, want) <= REL_TOL, (S, kv)
    b2 = va.tmajor_attention(q[:, :kv], k[:, :kv], v[:, :kv], hp=1)
    assert torch.equal(got.view(q.shape)[:, :kv], b2), (S, kv)
    assert torch.equal(va.bshd_attention(q, k, v, kv), got)


@pytest.mark.cuda
def test_b3_refusals_are_unchanged(cuda_device):
    q, k, v = _qkv(3, cuda_device, 1, 70, 70)
    for bad in (0, 71):
        with pytest.raises(ValueError, match="kv_valid"):
            kernels.vit_attention_bshd(q, k, v, bad, 0.125)
    lib = kernels._load()
    out = torch.empty(q.shape, dtype=q.dtype, device=cuda_device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 70,
            H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), 0.125]
    stream = torch.cuda.current_stream().cuda_stream
    for bad in (0, 71):
        assert lib.mjv_vit_attention_bshd(*args, bad, stream) == 1
