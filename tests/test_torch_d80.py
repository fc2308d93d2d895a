"""K1 and its key-norm pre-pass at the Qwen2-VL vision tower's head dim of
80, on the CPU.

The plain twins (what the CPU path of ``vit_attention`` and
``key_norm_max`` computes, and what the card's kernels are held against in
``tests/test_torch_kernels_d80_sm90.py`` and ``chip_smoke.py``) against the
JAX package: K1's twin against ``_fwd_nc_kernel`` with the Cauchy-Schwarz
bound through ``_fwd_nc_impl(..., norm_bound=True, interpret=True)`` at
(2, 40, 2, 80), where that oracle reads 5.4e-7 against an fp32 softmax, and
at the sides of the card's 128-row and 128-key tiles (atol 2e-5, fp32 sums
in another order); the pre-pass's kmax against ``_fwd_nc_kernel``'s max
(:131-135) written out in ``jnp`` (relative 1e-6), every chunk plan of its
partials folding to the same bits.  Then the layout: D = 80 runs as D128's
(two 64-column boxes, columns 80-127 zero), and the twin on inputs padded
with zero columns to 128 gives exact zeros there and the D = 80 output in
the first 80.  Then the sources (``Config<80, 2, 3>`` fits one SM, only K1
without the lse and the pre-pass admit 80) and the wrappers' rules: on a
CPU tensor K1 and the pre-pass pass the head-dim check and raise for the
device; K1 with the lse, K4 nc and autograd at D = 80 are refused.
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

D = 80
# (B, S, H): the oracle's stated shape, each side of the 128-row q tile and
# 128-key tile, and one temporal slab of a 196-patch frame pair.
SHAPES = {"oracle_40": (2, 40, 2), "tile_127": (1, 127, 2),
          "tile_129": (1, 129, 3), "slab_196": (2, 196, 2)}


def _qkv(case):
    B, S, H = SHAPES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    k *= rng.uniform(0.2, 3.0, size=(B, S, H, 1)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_k1_twin_at_d80_matches_pallas_nc_kernel(case):
    q, k, v = _qkv(case)
    ref = np.asarray(_fwd_nc_impl(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), None, None, None, True,
                                  False, norm_bound=True))
    got = tfa.vit_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    # The route: flash_attention takes K1 for D = 80 as for 64.
    routed = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), norm_bound=True)
    assert torch.equal(routed, got)
    assert torch.equal(multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        norm_bound=True), got)


def test_k1_oracle_agrees_with_a_softmax_at_the_stated_shape():
    q, k, v = _qkv("oracle_40")
    ref = np.asarray(_fwd_nc_impl(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), None, None, None, True,
                                  False, norm_bound=True))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    soft = np.einsum("bhqk,bkhd->bqhd", p, v)
    assert np.abs(ref - soft).max() < 1e-5


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_pre_pass_twin_at_d80_matches_jax_max(case):
    _, k, _ = _qkv(case)
    want = np.asarray(jnp.sqrt(jnp.max(jnp.sum(jnp.asarray(k) ** 2, -1), 1)))
    got = tfa.key_norm_max(torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    B, S, H, _ = k.shape
    plan = kernels.key_norm_parts(B, S, H, D)
    for parts in sorted({1, 3, plan, S}):
        folded = tfa.key_norm_fold(tfa.key_norm_partials(
            torch.from_numpy(k), None, parts))
        assert torch.equal(folded, got), parts


def test_d80_in_d128_layout_gives_zero_columns():
    """The kernel's layout on the twin: q, k and v padded with zero columns
    to 128 (TMA's zero fill), scale kept at 80^-0.5: the bound and the
    scores are unchanged, columns 80-127 exactly 0, the first 80 the D = 80
    output to 1e-5 (the fp32 sums over 128 columns run in another order)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv("tile_129"))
    pad = [torch.nn.functional.pad(t, (0, 128 - D)) for t in (q, k, v)]
    wide = tfa.vit_attention_plain(*pad, scale=D ** -0.5)
    assert torch.equal(tfa.key_norm_max(pad[1]), tfa.key_norm_max(k))
    assert not wide[..., D:].any()
    torch.testing.assert_close(wide[..., :D], tfa.vit_attention_plain(q, k, v),
                               atol=1e-5, rtol=0)


def test_key_norm_plan_at_d80():
    """D = 80's 10 pieces take 16 lanes, 6 of them idle: 64 key vectors a
    pass, as at 96 and 128; the tower's (4, 676, 16) plans 132 chunks."""
    assert kernels.key_norm_lanes(D) == 16
    assert kernels.key_norm_parts(4, 676, 16, D) == 132
    with pytest.raises(ValueError, match="exceed one pass"):
        kernels.key_norm_parts(1, 8, 65, D)


# --- the sources -------------------------------------------------------------

def _source(name):
    return (kernels.CSRC / name).read_text()


def test_d80_config_fits_the_card():
    """``Config<80, 2, 3>`` is D128's layout (two 64-column boxes, a
    64-float accumulator, 2 consumer warpgroups): its shared memory by the
    template's arithmetic and its register split fit one H100 SM."""
    header = _source("decoder_attention_sm90.cuh")
    m = re.search(r"using D80 = Config<80, (\d+), (\d+)>;", header)
    assert m is not None
    wg, stages = map(int, m.groups())
    assert (wg, stages) == (2, 3)
    assert "static_assert(D == 64 || D == 80 || D == 96 || D == 128" in header
    boxes, block_q, block_k = (D + 63) // 64, 64 * wg, 128
    assert boxes == 2 and D // 16 == 5  # the score products' k-steps
    smem = (boxes * block_q * 128 + stages * 2 * boxes * block_k * 128
            + (2 * stages + 2) * 8 + stages * 16 + 16 + 1024)
    assert smem <= 232448, smem
    regs = re.search(r"struct Regs<2> \{[^}]*kConsumer = (\d+), kProducer = "
                     r"(\d+);", header)
    consumer, producer = map(int, regs.groups())
    assert wg * 128 * consumer + 128 * producer <= 65536
    # The epilogue stores C::kD columns a row at a kD-element stride.
    assert "* C::kD + 2 * c;" in header
    assert "for (int j = 0; j < C::kD / 8; ++j) {" in header


def test_c_entries_admit_d80_for_k1_and_its_pre_pass_only():
    vit = _source("vit_attention.cu")
    assert vit.count("launch_attention<sm90::D80, false, "
                     "sm90::ShiftMode::kKeyMax,") == 2  # kernel alone, op
    assert "if (D == 80 && lse == nullptr)" in vit
    assert "if (D != 64 && (D != 80 || lse != nullptr))" in vit
    dec = _source("decoder_attention.cu")
    assert "key_norm_partial_kernel<80>" in dec
    assert "key_norm_partial_kernel<80, true>" not in dec
    assert "(D != 64 && D != 80 && D != 96 && D != 128)" in dec
    assert "static_assert(D == 64 || D == 80 || D == 96 || D == 128" in dec
    # The backward template stays at 64, 96 and 128.
    assert "static_assert(D == 64 || D == 96 || D == 128" in _source(
        "attention_bwd_sm90.cuh")


def _d80(*shape):
    return torch.zeros(shape or (1, 8, 2, D), dtype=torch.bfloat16)


@pytest.mark.parametrize("form", ["K1 op", "K1", "pre-pass"])
def test_k1_forms_at_d80_pass_the_head_dim_check(form):
    """On a CPU tensor the D = 80 forms raise for the device, not for D,
    and launch nothing."""
    q = _d80()
    calls = {
        "K1 op": lambda: kernels.vit_attention_op(q, q, q, 1.0),
        "K1": lambda: kernels.vit_attention(q, q, q, torch.ones(1, 2), 1.0),
        "pre-pass": lambda: kernels.key_norm_max(q),
    }
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="a CUDA device"):
        calls[form]()
    assert kernels.launch_counts == before


def test_autograd_at_d80_raises_naming_the_roadmap_item():
    """K1 with the lse and K4 nc are not built at D = 80 (the card tests
    hold their wrappers' refusals): autograd through the ViT attention at
    D = 80 raises naming the roadmap item, on any device (no silent
    fallback), and the forward without autograd runs."""
    assert "vit_attention_d80" in kernels.launch_counts
    assert "key_norm_max_d80" in kernels.launch_counts
    q = torch.zeros(1, 8, 2, D, requires_grad=True)
    with pytest.raises(NotImplementedError, match="Queue 2 item 2"):
        tfa.vit_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        assert tfa.vit_attention(q, q, q).shape == q.shape
