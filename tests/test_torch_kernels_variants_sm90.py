"""B1 and B2, the ViT attention A/B variants, on the card: the wgmma/TMA
forward template at D = 64, B1's four softmax modes as its policies and
B2 at each hp.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_kernels_variants_sm90.py \\
        --noconftest -m cuda -q

Without a card every test here skips.  Tolerance: each output within
2**-7 of max|plain| of its twin (one bf16 ulp of the largest output at
worst), as ``chip_smoke.py`` holds B1-B3; B2 is one kernel at every hp
(the same walk and the same fp32 order for each row), so its hp agree bit
for bit, and no launch reads a key or q row past S.
"""

import ctypes

import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import vit_attention_variants as va

REL_TOL = 2 ** -7
H, D = 4, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a (the kernels have no CPU "
                    "mode); run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _qkv(seed, dev, B, S, rows=None):
    """q, k, v (B, S, H, D) bf16 views into one (B, rows, 3 H D) qkv
    tensor (rows >= S), and that tensor."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, rows or S, 3 * H * D), generator=g,
                      device=dev).to(torch.bfloat16)
    q, k, v = (t[:, :S].view(B, S, H, D) if rows else t.view(B, S, H, D)
               for t in qkv.split(H * D, dim=-1))
    return q, k, v, qkv


def _calls(q, k, v):
    """(label, kernel call, twin call) for every B1 mode and B2 hp."""
    out = [(f"B1 {m}", lambda m=m: va.variant_attention(q, k, v, m),
            lambda m=m: va.variant_attention_plain(q, k, v, m))
           for m in va.VARIANT_MODES]
    out += [(f"B2 hp={n}", lambda n=n: va.tmajor_attention(q, k, v, hp=n),
             lambda: va.tmajor_attention_plain(q, k, v))
            for n in va.TMAJOR_HP]
    return out


def _rel(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err / want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 37, 64, 65, 1025])
def test_each_mode_and_hp_matches_its_twin(cuda_device, S):
    """Every B1 mode and B2 hp on qkv views, at one key, a partial tile,
    a 64-key tile's edge and the 448 px tile's 1025 (one key in the last
    128-key tile); each call counts one launch under its name."""
    q, k, v, _ = _qkv(20 + S, cuda_device, 2, S)
    for label, kern, plain in _calls(q, k, v):
        name = ("vit_attention_variant" if label.startswith("B1")
                else "vit_attention_tmajor")
        before = kernels.launch_counts[name]
        got = kern()
        assert kernels.launch_counts[name] == before + 1, label
        assert got.shape == q.shape and got.is_contiguous(), label
        assert torch.isfinite(got).all(), label
        rel = _rel(got, plain())
        assert rel <= REL_TOL, (label, S, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [65, 1025])
def test_b2_is_bit_identical_across_hp_and_launches(cuda_device, S):
    """B2 at hp 1, 2 and 4 gives the same bits (each row walks the same
    tiles in the same order, whatever its CTA's other heads), and a second
    launch of every B1 mode and B2 hp repeats the first bit for bit."""
    q, k, v, _ = _qkv(30 + S, cuda_device, 2, S)
    outs = {n: va.tmajor_attention(q, k, v, hp=n) for n in va.TMAJOR_HP}
    for n in va.TMAJOR_HP[1:]:
        assert torch.equal(outs[n], outs[1]), n
    for label, kern, _ in _calls(q, k, v):
        assert torch.equal(kern(), kern()), label


@pytest.mark.cuda
@pytest.mark.parametrize("S", [37, 1025])
def test_rows_past_s_are_never_read(cuda_device, S):
    """q/k/v as views of the first S rows of a longer qkv tensor whose
    rows past S are NaN: the outputs equal those on a tensor of S rows
    exactly (TMA's bounds stop at S)."""
    q, k, v, _ = _qkv(40 + S, cuda_device, 2, S)
    qn, kn, vn, big = _qkv(40 + S, cuda_device, 2, S, rows=S + 131)
    big[:, :S] = torch.cat([t.reshape(2, S, H * D) for t in (q, k, v)], -1)
    big[:, S:] = float("nan")
    for (label, kern, _), (_, kern_n, _) in zip(_calls(q, k, v),
                                                 _calls(qn, kn, vn)):
        assert torch.equal(kern_n(), kern()), label


@pytest.mark.cuda
@pytest.mark.parametrize("S", [200, 1025])
def test_a_max_in_the_last_key_tile(cuda_device, S):
    """Rows whose largest logit, about 20 nats above the rest, sits in the
    last key tile: the online max must rescale everything before it.  One
    key past 128 ahead of the end carries a direction that half the heads'
    q rows share."""
    q, k, v, _ = _qkv(50 + S, cuda_device, 2, S)
    scale = D ** -0.5
    big = torch.zeros(D, device=cuda_device)
    big[0] = 1.0
    k[:, S - 1, :2] = (big * 10.0).to(k.dtype)
    q[:, :, :2] = (q[:, :, :2].float() * 0.25).to(q.dtype)
    q[:, :, :2, 0] = (torch.full_like(q[:, :, :2, 0], 2.0 / scale)
                      .to(q.dtype))
    for label, kern, plain in _calls(q, k, v):
        want = plain()
        rel = _rel(kern(), want)
        assert rel <= REL_TOL, (label, S, rel)
        # The planted key dominates the heads that share its direction.
        top = (want[:, :, :2].float() - v[:, S - 1:S, :2].float()).abs()
        assert top.max().item() < 0.05, label


@pytest.mark.cuda
def test_refusals_are_unchanged(cuda_device):
    """The wrappers refuse what no kernel takes before any launch; a C
    entry given a mode, hp or head dim it has no kernel for returns CUDA's
    invalid-value error, which a wrapper raises: nothing falls back."""
    q, k, v, _ = _qkv(60, cuda_device, 1, 70)
    with pytest.raises(ValueError, match="mode"):
        kernels.vit_attention_variant(q, k, v, "exp", 0.125)
    with pytest.raises(ValueError, match="hp"):
        kernels.vit_attention_tmajor(q, k, v, 3, 0.125)
    q6 = torch.zeros(1, 8, 6, 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="hp"):
        kernels.vit_attention_tmajor(q6, q6, q6, 4, 0.125)
    with pytest.raises(NotImplementedError, match="backward"):
        va.variant_attention(q.clone().requires_grad_(), k, v, "bf16s")
    lib = kernels._load()
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 70,
            H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), ctypes.c_float(0.125)]
    stream = torch.cuda.current_stream().cuda_stream
    invalid = 1  # cudaErrorInvalidValue
    assert lib.mjv_vit_attention_variant(*args, 4, stream) == invalid
    assert lib.mjv_vit_attention_tmajor(*args, 3, stream) == invalid
    bad_d = list(args)
    bad_d[7] = 32
    assert lib.mjv_vit_attention_variant(*bad_d, 0, stream) == invalid
    assert lib.mjv_vit_attention_tmajor(*bad_d, 1, stream) == invalid
    with pytest.raises(RuntimeError):
        kernels._raise_on("vit_attention_variant", invalid)
