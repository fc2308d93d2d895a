"""K1 and its key-norm pre-pass at InternViT-6B's head dim of 128 with 25
heads, on the CPU.

The plain twins (what the CPU path of ``vit_attention`` and
``key_norm_max`` computes, and what the card's kernels are held against in
``tests/test_torch_kernels_d128vit_sm90.py`` and ``chip_smoke.py``) against
the JAX package: K1's twin against ``_fwd_nc_kernel`` with the
Cauchy-Schwarz bound through ``_fwd_nc_impl(..., norm_bound=True,
interpret=True)`` at (2, 33, 5, 128) and at S = 129, where the last
128-key tile holds one live key and the last 128-row q tile one live row
(atol 2e-5: fp32 sums in another order), the operands as the 6B tower
makes them: q and k dense rows after QK-RMSNorm, v a view into the qkv
product; the pre-pass's kmax against ``_fwd_nc_kernel``'s max (:131-135)
written out in ``jnp`` (relative 1e-6), every chunk plan of its partials
folding to the same bits.  Then the plan at 25 heads of 128, the sources
(both C entries admit D = 128 for K1 without the lse, on K2's
``Config<128, 2, 3>`` not causal and floored) and the wrappers' rules: on
a CPU tensor K1 and the pre-pass pass the head-dim check and raise for the
device; K1 with the lse and autograd at D = 128 are refused.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import _fwd_nc_impl
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.ops.attention import multi_head_attention

torch.set_num_threads(1)

D = 128
# (B, S, H): the oracle's stated shape, and one live key (and q row) in the
# last 128-wide tile.
SHAPES = {"oracle_33": (2, 33, 5), "tail_129": (1, 129, 5)}


def _qkv(case):
    """q and k dense, v a view into the (B, S, 3 H D) product, as numpy
    arrays over one buffer; k's norms spread."""
    B, S, H = SHAPES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    qkv = rng.normal(size=(B, S, 3, H, D)).astype(np.float32)
    qkv[:, :, 1] *= rng.uniform(0.2, 3.0, size=(B, S, H, 1)).astype(
        np.float32)
    return qkv


def _torch_operands(qkv):
    t = torch.from_numpy(qkv)
    q, k, v = t[:, :, 0].contiguous(), t[:, :, 1].contiguous(), t[:, :, 2]
    assert v.stride(1) == 3 * v.shape[2] * D and q.stride(1) == q.shape[2] * D
    return q, k, v


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_k1_twin_at_d128_matches_pallas_nc_kernel(case):
    qkv = _qkv(case)
    ref = np.asarray(_fwd_nc_impl(*(jnp.asarray(qkv[:, :, i])
                                    for i in range(3)),
                                  None, None, None, True, False,
                                  norm_bound=True))
    q, k, v = _torch_operands(qkv)
    got = tfa.vit_attention(q, k, v)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    # The routes the tower takes: flash_attention's and the ViT block's.
    assert torch.equal(tfa.flash_attention(q, k, v, norm_bound=True), got)
    assert torch.equal(multi_head_attention(q, k, v, causal=False,
                                            norm_bound=True), got)
    # The last row sees every key, the lone one in the last tile too.
    assert np.abs(got.numpy()[:, -1] - ref[:, -1]).max() < 2e-5


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_pre_pass_twin_at_25_heads_of_128_matches_jax_max(case):
    k = _qkv(case)[:, :, 1]
    want = np.asarray(jnp.sqrt(jnp.max(jnp.sum(jnp.asarray(k) ** 2, -1), 1)))
    got = tfa.key_norm_max(torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    B, S, H, _ = k.shape
    plan = kernels.key_norm_parts(B, S, H, D)
    for parts in sorted({1, 3, plan, S}):
        folded = tfa.key_norm_fold(tfa.key_norm_partials(
            torch.from_numpy(k), None, parts))
        assert torch.equal(folded, got), parts


def test_key_norm_plan_at_25_heads_of_128():
    """D = 128's 16 pieces take 16 lanes: 64 key vectors a pass, so 25
    heads fill 50 slots with 2 whole keys; the tower's (8, 1025, 25) plans
    66 chunks (528 CTAs over 8 clips), (2, 1025, 25) 256 (the cap)."""
    assert kernels.key_norm_lanes(D) == 16
    assert kernels.key_norm_parts(8, 1025, 25, D) == 66
    assert kernels.key_norm_parts(2, 1025, 25, D) == 256
    assert kernels.key_norm_parts(1, 1, 25, D) == 1


# --- the sources -------------------------------------------------------------

def _source(name):
    return (kernels.CSRC / name).read_text()


def test_c_entries_admit_d128_for_k1_without_the_lse():
    """Both K1 entries (the kernel alone and the op) take D = 128 without
    the lse, on Config D128 not causal, kKeyMax, floored; the op launches
    the pre-pass's partials first and K1 as its programmatic dependent."""
    vit = _source("vit_attention.cu")
    assert vit.count("if (D == 128 && lse == nullptr) {  // InternViT-6B's "
                     "heads") == 2
    assert vit.count("launch_attention<sm90::D128, false,\n"
                     "                                  "
                     "sm90::ShiftMode::kKeyMax, true>(") == 2
    op = vit[vit.index("extern \"C\" int mjv_vit_attention_op("):]
    branch = op[op.index("if (D == 128"):op.index("if (D == 72")]
    assert "launch_key_norm_partials(k, nullptr, part," in branch
    assert "scale, stream, true);" in branch
    alone = vit[:vit.index("extern \"C\" int mjv_vit_attention_op(")]
    branch = alone[alone.index("if (D == 128"):alone.index("if (D == 72")]
    assert "kmax, 1, nullptr, out, nullptr" in branch
    assert "launch_key_norm_partials" not in branch
    # The pre-pass at 128 exists (K2's), without a mask here.
    assert "key_norm_partial_kernel<128>" in _source("decoder_attention.cu")


def test_d128_config_fits_the_card():
    """K1 at D = 128 runs K2's ``Config<128, 2, 3>``: two full 64-column
    boxes, 2 consumer warpgroups of 64 q rows, 3 stages of 128 keys; its
    shared memory by the template's arithmetic and its register split fit
    one H100 SM."""
    header = _source("decoder_attention_sm90.cuh")
    m = re.search(r"using D128 = Config<128, (\d+), (\d+)>;", header)
    assert m is not None
    wg, stages = map(int, m.groups())
    assert (wg, stages) == (2, 3)
    boxes, block_q, block_k = D // 64, 64 * wg, 128
    smem = (boxes * block_q * 128 + stages * 2 * boxes * block_k * 128
            + (2 * stages + 2) * 8 + stages * 16 + 16 + 1024)
    assert smem <= 232448, smem
    regs = re.search(r"struct Regs<2> \{[^}]*kConsumer = (\d+), kProducer = "
                     r"(\d+);", header)
    consumer, producer = map(int, regs.groups())
    assert wg * 128 * consumer + 128 * producer <= 65536
    # K1 is listed among the template's users at 128.
    assert "K1  (kKeyMax, D = 64, 72, 80 or 128, FLOOR)" in header


# --- the wrappers ------------------------------------------------------------

def _d128(B=1, S=8, H=25):
    """q and k dense (B, S, H, 128), v a view with 3 H D-element rows."""
    qkv = torch.zeros((B, S, 3, H, D), dtype=torch.bfloat16)
    return qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]


@pytest.mark.parametrize("form", ["K1 op", "K1", "pre-pass"])
def test_k1_forms_at_d128_pass_the_head_dim_check(form):
    """On a CPU tensor the D = 128 forms raise for the device, not for D or
    the operands' strides, and launch nothing."""
    q, k, v = _d128()
    calls = {
        "K1 op": lambda: kernels.vit_attention_op(q, k, v, 1.0),
        "K1": lambda: kernels.vit_attention(q, k, v, torch.ones(1, 25), 1.0),
        "pre-pass": lambda: kernels.key_norm_max(k),
    }
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="a CUDA device"):
        calls[form]()
    assert kernels.launch_counts == before


def test_k1_takes_d128_without_the_lse_only(monkeypatch):
    """K1's checks admit 128 beside 64, 72 and 80 without the lse; with it
    (K1 lse, built at D = 64 only) 64 alone."""
    seen = []
    monkeypatch.setattr(kernels, "_check_qkv",
                        lambda name, dims, *ts: seen.append(dims))
    q, k, v = _d128()
    kernels._check_vit("vit_attention", q, k, v, False)
    kernels._check_vit("vit_attention", q, k, v, True)
    assert seen == [(64, 72, 80, 128), (64,)]


def test_autograd_at_d128_raises_naming_the_roadmap_item():
    """K1 with the lse and K4 nc are not built at D = 128: autograd through
    the ViT attention at D = 128 raises naming K4NC_D128_NEXT, on any
    device (no silent fallback); the forward without autograd runs and
    counts under ``vit_attention_d128`` on the card only."""
    assert "vit_attention_d128" in kernels.launch_counts
    assert "InternViT-6B" in tfa.K4NC_D128_NEXT
    q = torch.zeros(1, 8, 2, D, requires_grad=True)
    with pytest.raises(NotImplementedError,
                       match=re.escape(tfa.K4NC_D128_NEXT)):
        tfa.vit_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        assert tfa.vit_attention(q, q, q).shape == q.shape
    before = dict(kernels.launch_counts)
    kernels._count("vit_attention", D)
    assert kernels.launch_counts["vit_attention_d128"] == \
        before["vit_attention_d128"] + 1
    kernels._count("decoder_attention", D)
    assert kernels.launch_counts["vit_attention_d128"] == \
        before["vit_attention_d128"] + 1
    kernels.launch_counts.update(before)
