"""K1, K1m and their key-norm pre-pass at SigLIP-so400m's head dim of 72, on
the CPU.

The plain twins (what the CPU path of ``vit_attention``,
``vit_attention_masked`` and ``key_norm_max`` computes, and what the card's
kernels are held against in ``tests/test_torch_kernels_d72_sm90.py`` and
``chip_smoke.py``) against the JAX package's Pallas kernels in interpret
mode: K1's twin against ``_fwd_impl(norm_bound=True, interpret=True)``
without a mask, which runs ``_fwd_nc_kernel`` while ``round_up(K, 8) <=
4096`` and ``_fwd_bound_kernel`` with an all-ones mask past it (the port
takes K1 at every length: the same function); K1m's twin against
``_fwd_impl(causal=False, attention_mask=..., norm_bound=True,
interpret=True)``, ``_fwd_bound_kernel`` non-causal.  Tolerance atol 2e-5
(fp32 sums in another order; outputs are O(1)).  The pre-pass's kmax
against the kernels' max written out in ``jnp`` (relative 1e-6), masked and
not, every chunk plan folding to the same bits.  Then the layout (D = 72 in
D128's boxes: zero columns 72-127 change nothing), the sources and the
wrappers' rules.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import _fwd_impl
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.ops.attention import multi_head_attention

torch.set_num_threads(1)

D = 72
ATOL = 2e-5
# (B, S, H): each side of the 128-row q tile and 128-key tile, one small
# frame's grid, and past the 4,096 keys where JAX leaves its maskless
# kernel (a 980 x 980 frame has 4,900).
SHAPES = {"tile_127": (1, 127, 2), "tile_129": (2, 129, 2),
          "frame_156": (2, 156, 2), "past_4096": (1, 4100, 1)}
# (images, grid h, grid w, live grids): padded bottom/right, one image with
# no live patch.
MASKED = {"split_9x15": (3, 9, 15, ((9, 14), (5, 15), (1, 1))),
          "dead_12x11": (2, 12, 11, ((12, 11), (0, 0))),
          "tile_13x10": (2, 13, 10, ((13, 10), (7, 3)))}


def _qkv(case, B, S, H):
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    k *= rng.uniform(0.2, 3.0, size=(B, S, H, 1)).astype(np.float32)
    return q, k, v


def _patch_mask(n, gh, gw, live):
    m = np.zeros((n, gh, gw), np.int32)
    for i, (h, w) in enumerate(live):
        m[i, :h, :w] = 1
    return m.reshape(n, gh * gw)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_k1_twin_at_d72_matches_pallas(case):
    q, k, v = _qkv(case, *SHAPES[case])
    ref = np.asarray(_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, False,
        D ** -0.5, None, None, True, False, norm_bound=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.vit_attention(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    # The route: flash_attention takes K1 at every length.
    assert torch.equal(tfa.flash_attention(tq, tk, tv, norm_bound=True), got)
    assert torch.equal(multi_head_attention(tq, tk, tv, norm_bound=True),
                       got)


@pytest.mark.parametrize("case", sorted(MASKED))
def test_masked_twin_at_d72_matches_pallas_bound_kernel(case):
    n, gh, gw, live = MASKED[case]
    q, k, v = _qkv(case, n, gh * gw, 2)
    mask = _patch_mask(n, gh, gw, live)
    ref = np.asarray(_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        None, False, D ** -0.5, None, None, True, False, norm_bound=True))
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = tfa.vit_attention_masked(tq, tk, tv, tm)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    for i, (h, w) in enumerate(live):
        if h * w == 0:
            assert not got[i].any()  # no live key: 0, as the kernel's l = 0
    assert torch.equal(tfa.flash_attention(tq, tk, tv, tm, norm_bound=True),
                       got)
    assert torch.equal(multi_head_attention(tq, tk, tv, attention_mask=tm,
                                            norm_bound=True), got)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_pre_pass_twin_at_d72_matches_jax_max(case):
    _, k, _ = _qkv(case, *SHAPES[case])
    B, S, H, _ = k.shape
    mask = (np.random.default_rng(3).random((B, S)) < 0.6).astype(np.int32)
    for m in (None, mask):
        kn2 = jnp.sum(jnp.asarray(k) ** 2, -1)
        if m is not None:
            kn2 = kn2 * jnp.asarray(m)[:, :, None]
        want = np.asarray(jnp.sqrt(jnp.max(kn2, 1)))
        tm = None if m is None else torch.from_numpy(m)
        got = tfa.key_norm_max(torch.from_numpy(k), tm)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        plan = kernels.key_norm_parts(B, S, H, D)
        for parts in sorted({1, 3, plan, S}):
            folded = tfa.key_norm_fold(tfa.key_norm_partials(
                torch.from_numpy(k), tm, parts))
            assert torch.equal(folded, got), parts


def test_d72_in_d128_layout_gives_zero_columns():
    """The kernel's layout on the twins: q, k and v padded with zero columns
    to 128 (TMA's zero fill; the fifth k-step reads 72-79 as zeros), scale
    kept at 72^-0.5: bounds and scores unchanged, columns 72-127 exactly 0,
    the first 72 the D = 72 output to 1e-5."""
    q, k, v = (torch.from_numpy(a) for a in _qkv("pad", 2, 129, 2))
    pad = [torch.nn.functional.pad(t, (0, 128 - D)) for t in (q, k, v)]
    wide = tfa.vit_attention_plain(*pad, scale=D ** -0.5)
    assert torch.equal(tfa.key_norm_max(pad[1]), tfa.key_norm_max(k))
    assert not wide[..., D:].any()
    torch.testing.assert_close(wide[..., :D], tfa.vit_attention_plain(q, k, v),
                               atol=1e-5, rtol=0)
    mask = torch.from_numpy(_patch_mask(2, 3, 43, ((3, 43), (2, 20))))
    wide = tfa.vit_attention_masked_plain(*pad, mask, scale=D ** -0.5)
    assert not wide[..., D:].any()
    torch.testing.assert_close(
        wide[..., :D], tfa.vit_attention_masked_plain(q, k, v, mask),
        atol=1e-5, rtol=0)


def test_key_norm_plan_at_d72():
    """D = 72's 9 pieces take 16 lanes, 7 of them idle: 64 key vectors a
    pass; VideoScore's (16, 2730, 16) plans 33 chunks, its split frames'
    (20, 2730, 16) 27, MiniCPM-V's (8, 1032, 16) 66, a 980 px frame's (1,
    4900, 16) 256."""
    assert kernels.key_norm_lanes(D) == 16
    assert [kernels.key_norm_parts(*s, D) for s in (
        (16, 2730, 16), (20, 2730, 16), (8, 1032, 16), (1, 4900, 16))] == [
        33, 27, 66, 256]
    with pytest.raises(ValueError, match="exceed one pass"):
        kernels.key_norm_parts(1, 8, 65, D)


# --- the sources -------------------------------------------------------------

def _source(name):
    return (kernels.CSRC / name).read_text()


def test_d72_config_fits_the_card_and_takes_five_k_steps():
    """``Config<72, 2, 3>`` is D128's layout (two 64-column boxes, a
    64-float accumulator, 2 consumer warpgroups): its shared memory and
    register split fit one H100 SM; q k^T rounds its k-steps up (5 at 72,
    the fifth reading the zero fill; unchanged at 64, 80, 96, 128); the
    epilogue stores 9 column blocks at a 72-element stride."""
    header = _source("decoder_attention_sm90.cuh")
    m = re.search(r"using D72 = Config<72, (\d+), (\d+)>;", header)
    assert m is not None
    wg, stages = map(int, m.groups())
    assert (wg, stages) == (2, 3)
    assert "D == 128 || D == 72 ||" in header
    boxes, block_q, block_k = (D + 63) // 64, 64 * wg, 128
    assert boxes == 2 and (D + 15) // 16 == 5 and D * 2 % 16 == 0
    smem = (boxes * block_q * 128 + stages * 2 * boxes * block_k * 128
            + (2 * stages + 2) * 8 + stages * 16 + 16 + 1024)
    assert smem <= 232448, smem
    regs = re.search(r"struct Regs<2> \{[^}]*kConsumer = (\d+), kProducer = "
                     r"(\d+);", header)
    consumer, producer = map(int, regs.groups())
    assert wg * 128 * consumer + 128 * producer <= 65536
    assert "for (int kk = 0; kk < (C::kD + 15) / 16; ++kk) {" in header
    assert all((d + 15) // 16 == d // 16 for d in (64, 80, 96, 128))
    assert "for (int j = 0; j < C::kD / 8; ++j) {" in header


def test_c_entries_admit_d72_for_k1_k1m_and_the_pre_pass_only():
    vit = _source("vit_attention.cu")
    assert vit.count("launch_attention<sm90::D72, false, "
                     "sm90::ShiftMode::kKeyMax,") == 2  # kernel alone, op
    assert vit.count("if (D == 72 && lse == nullptr)") == 2
    dec = _source("decoder_attention.cu")
    assert "key_norm_partial_kernel<72>" in dec
    assert "key_norm_partial_kernel<72, true>" not in dec
    assert "return causal ? k2_head_dim(D) : D == 72;" in dec
    assert dec.count("if (!k2_head_dim(D, false) || mask == nullptr)") == 2
    # K1m: the masked path, not causal, no floor; alone and as the op.
    assert dec.count("launch_attention<sm90::D72, false, "
                     "sm90::ShiftMode::kKeyMax>(") == 2
    assert "static bool k2_head_dim(int D) { return D == 128 || D == 96; }" \
        in dec
    # The backward template stays at 64, 96 and 128.
    assert "static_assert(D == 64 || D == 96 || D == 128" in _source(
        "attention_bwd_sm90.cuh")
    assert set(kernels.ARGTYPES) >= {"mjv_vit_attention_masked",
                                     "mjv_vit_attention_masked_op"}


def _d72(*shape):
    return torch.zeros(shape or (1, 8, 2, D), dtype=torch.bfloat16)


@pytest.mark.parametrize("form", ["K1 op", "K1", "K1m op", "K1m",
                                  "pre-pass", "masked pre-pass"])
def test_d72_forms_pass_the_head_dim_check(form):
    """On a CPU tensor the D = 72 forms raise for the device, not for D,
    and launch nothing."""
    q = _d72()
    m = torch.ones((1, 8), dtype=torch.int32)
    calls = {
        "K1 op": lambda: kernels.vit_attention_op(q, q, q, 1.0),
        "K1": lambda: kernels.vit_attention(q, q, q, torch.ones(1, 2), 1.0),
        "K1m op": lambda: kernels.vit_attention_masked_op(q, q, q, m, 1.0),
        "K1m": lambda: kernels.vit_attention_masked(q, q, q, m,
                                                    torch.ones(1, 2), 1.0),
        "pre-pass": lambda: kernels.key_norm_max(q),
        "masked pre-pass": lambda: kernels.key_norm_max(q, m),
    }
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="a CUDA device"):
        calls[form]()
    assert kernels.launch_counts == before


def test_grouped_masked_and_autograd_raise():
    """Non-causal grouped attention with a mask has no bound kernel (no path
    needs it); autograd through K1 or K1m at D = 72 raises naming the
    roadmap item, on any device; the counters exist."""
    for name in ("vit_attention_d72", "key_norm_max_d72",
                 "vit_attention_masked", "key_norm_max_masked_d72"):
        assert name in kernels.launch_counts
    q = torch.zeros(1, 8, 4, D)
    k = torch.zeros(1, 8, 2, D)
    m = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="grouped"):
        tfa.flash_attention(q, k, k, m, norm_bound=True)
    qg = torch.zeros(1, 8, 2, D, requires_grad=True)
    kd = qg.detach()
    with pytest.raises(NotImplementedError, match="Queue 2 item 2"):
        tfa.vit_attention(qg, kd, kd)
    with pytest.raises(NotImplementedError, match="Queue 2 item 2"):
        tfa.vit_attention_masked(qg, kd, kd, m)
    with torch.no_grad():
        assert tfa.vit_attention_masked(qg, kd, kd, m).shape == qg.shape
