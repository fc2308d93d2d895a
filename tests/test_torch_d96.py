"""K2, K2 lse, its key-norm pre-pass, K3, K3 lse, K4a and K4b at Phi-3's head
dim of 96 (MJ-VIDEO-4B's decoder), on the CPU.

The plain twins (what the CPU path of ``decoder_attention``,
``key_norm_max``, ``exact_attention`` and their backward computes, and
what the card's kernels are held against in
``tests/test_torch_kernels_d96_sm90.py`` and ``chip_smoke.py``) against the
JAX package's Pallas kernels in interpret mode, through
``flash_attention(norm_bound=True | False)``, ``_fwd_impl(with_lse=True,
norm_bound=True)``, ``flash_attention_with_lse`` and ``_bwd_impl``, at
D = 96 with GQA, ragged and left-padded masks, dead rows, per-row
q_offsets and sequences on each side of the card's 128-row and 128-key
tiles; atol 2e-5 (rtol 1e-5 for the gradients: the same fp32 sums in other
orders, as ``tests/test_torch_flash_attention.py`` holds them at D = 16),
dead rows exactly 0 (and their lse ``DEAD_LSE``), dq exactly 0 on dead rows
and dk, dv exactly 0 on masked keys.  The pre-pass's partials and fold
against ``_fwd_impl``'s key-norm reduce written out in ``jnp`` (relative
1e-6: fp32 sums of squares in another order).  Then the sources: the
forward and backward ``Config``s at 96 fit the card's shared memory and
registers, the C entries admit D = 96 for K2, K3, their lse forms, the
pre-pass, K4a and K4b and for nothing else, and the wrappers refuse K2r and
its pre-pass at D = 96 before any check or launch, naming the next ROADMAP
item.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import (
    _bwd_impl,
    _fwd_impl,
    flash_attention,
    flash_attention_with_lse,
)
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

D = 96

# (B, T, Hq, Hkv, mask kind): each side of the 128-row / 128-key tiles,
# MHA as in Phi-3 and one GQA case.
CASES = {
    "ragged_127": (2, 127, 2, 2, "ragged"),
    "left_padded_129": (2, 129, 2, 2, "left"),
    "gqa_130": (2, 130, 4, 2, "ragged"),
    "unmasked_128": (1, 128, 2, 2, None),
}
# The gradient forms' cases: CASES' at q_offset 0, and GQA with a ragged
# mask at a per-row q_offset (rows see keys up to q_offset + i).
GRAD_CASES = dict(CASES, offset_gqa_130=(2, 130, 4, 2, "ragged"))
OFFSETS = {"offset_gqa_130": (7, 40)}


def _inputs(case):
    B, T, Hq, Hkv, kind = GRAD_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    k *= rng.uniform(0.2, 3.0, size=(B, T, Hkv, 1)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    mask = None
    if kind == "ragged":
        mask = np.ones((B, T), np.int32)
        mask[-1, T - 37:] = 0
    elif kind == "left":
        mask = np.ones((B, T), np.int32)
        mask[1, :9] = 0  # rows 0-8 of batch 1 see no key
        mask[0, T - 5:] = 0
    return q, k, v, mask


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _dead(q, k, mask, off=None, causal=True):
    allowed = tfa._allowed(_t(q), _t(k), _t(mask), _t(off), causal)
    return (~allowed.any(-1)).expand(q.shape[0], q.shape[1]).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_twin_at_d96_matches_pallas_bound_kernel(case):
    q, k, v, mask = _inputs(case)
    ref = np.asarray(flash_attention(_j(q), _j(k), _j(v),
                                     attention_mask=_j(mask), causal=True,
                                     norm_bound=True))
    got = tfa.decoder_attention(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    dead = _dead(q, k, mask)
    assert np.all(got[dead] == 0.0) and np.all(ref[dead] == 0.0)
    assert (dead.any() == (case == "left_padded_129"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pre_pass_twin_at_d96_matches_jax_reduce(case):
    """kmax of ``_fwd_impl``'s reduce (flash_attention.py:484-511): the
    largest masked key norm per (b, kv head); every chunk plan folds to
    the same bits."""
    _, k, _, mask = _inputs(case)
    B, T, Hkv, _ = k.shape
    m = np.ones((B, T), np.int32) if mask is None else mask
    kn2 = jnp.sum(jnp.asarray(k) ** 2, axis=-1) * (jnp.asarray(m) != 0)[
        :, :, None].astype(jnp.float32)
    want = np.asarray(jnp.sqrt(jnp.max(kn2, axis=1)))
    got = tfa.key_norm_max(_t(k), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    plan = kernels.key_norm_parts(B, T, Hkv, D)
    for parts in sorted({1, 3, plan, T}):
        folded = tfa.key_norm_fold(tfa.key_norm_partials(_t(k), _t(mask),
                                                         parts))
        assert torch.equal(folded, got), parts


# (Q rows, K keys, per-row q_offset or None, causal): a prefill, a decode
# step and a continuation over a cache, and the non-causal form.
K3_CASES = {
    "prefill": (129, 129, None, True),
    "decode_step": (1, 140, (139, 100), True),
    "continuation": (7, 135, (128, 120), True),
    "non_causal": (65, 131, None, False),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_twin_at_d96_matches_pallas_exact_kernel(case):
    Q, K, off, causal = K3_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    B, Hq, Hkv = 2, 2, 2
    q = rng.normal(size=(B, Q, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    mask = np.ones((B, K), np.int32)
    mask[1, :6] = 0
    if off is not None:
        off = np.asarray(off, np.int32)
        for b, o in enumerate(off):
            mask[b, o + Q:] = 0
    ref = np.asarray(flash_attention(_j(q), _j(k), _j(v),
                                     attention_mask=_j(mask), causal=causal,
                                     q_offset=_j(off), norm_bound=False))
    got = tfa.exact_attention(_t(q), _t(k), _t(v), _t(mask), _t(off),
                              causal=causal).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    dead = _dead(q, k, mask, off, causal)
    assert np.all(got[dead] == 0.0) and np.all(ref[dead] == 0.0)


def _offset(case):
    off = OFFSETS.get(case)
    return None if off is None else np.asarray(off, np.int32)


def _jax_bound_with_lse(q, k, v, mask, off):
    """``_fwd_bound_kernel(with_lse=True)`` in interpret mode: the output,
    the (B, Hq, Q) lse read from its (B, Hq, 8, Qp) layout, and that
    layout (``_bwd_impl`` reads it)."""
    out, raw = _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         _j(mask), _j(off), True, None, None, None, True,
                         True, norm_bound=True)
    lse = np.ascontiguousarray(np.asarray(raw)[:, :, 0, :q.shape[1]])
    return out, lse, raw


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_k2_lse_twin_at_d96_matches_pallas_bound_kernel(case):
    q, k, v, mask = _inputs(case)
    off = _offset(case)
    out, lse, _ = _jax_bound_with_lse(q, k, v, mask, off)
    got, got_lse = tfa.decoder_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                               _t(off), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-5)
    dead = lse >= tfa.DEAD_LSE * 0.5  # (B, Hq, Q)
    np.testing.assert_array_equal(got_lse.numpy() >= tfa.DEAD_LSE * 0.5, dead)
    assert np.all(got_lse.numpy()[dead] == tfa.DEAD_LSE)
    np.testing.assert_allclose(got_lse.numpy()[~dead], lse[~dead], atol=2e-5)
    assert np.all(got.numpy().transpose(0, 2, 1, 3)[dead] == 0.0)
    assert dead.any() == (case == "left_padded_129")
    alone = tfa.decoder_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                        _t(off))
    np.testing.assert_array_equal(alone.numpy(), got.numpy())


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_k4_twins_at_d96_match_pallas_backward_kernels(case):
    """``decoder_attention_backward_plain`` (K4a's and K4b's twin) against
    ``_bwd_impl`` in interpret mode from the same out, lse and dO."""
    q, k, v, mask = _inputs(case)
    off = _offset(case)
    do = np.random.default_rng(len(case)).normal(size=q.shape).astype(
        np.float32)
    out, lse, raw = _jax_bound_with_lse(q, k, v, mask, off)
    want = _bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     _j(mask), _j(off), out, raw, jnp.asarray(do), True,
                     None, None, None, True)
    got = tfa.decoder_attention_backward_plain(
        _t(q), _t(k), _t(v), _t(mask), _t(off), _t(np.array(out)), _t(lse),
        _t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5, err_msg=name)
        assert g.numpy().any(), name
    dq, dk, dv = (g.numpy() for g in got)
    dead = lse >= tfa.DEAD_LSE * 0.5
    assert np.all(dq.transpose(0, 2, 1, 3)[dead] == 0.0)
    if mask is not None:
        assert np.all(dk[mask == 0] == 0.0) and np.all(dv[mask == 0] == 0.0)


# K3 lse at the ring's chunk offsets: one shard's L queries over one chunk's
# L keys, GQA 4/2, row 0 masking the chunk's last 5 keys and row 1 its
# first 6; (relative offset, causal).
RING_L = 130
K3_LSE_CASES = {"later_chunk": (-RING_L, True), "diagonal": (0, True),
                "earlier_chunk": (RING_L, True), "non_causal": (0, False)}


@pytest.mark.parametrize("case", sorted(K3_LSE_CASES))
def test_k3_lse_twin_at_d96_matches_pallas_exact_kernel(case):
    rel, causal = K3_LSE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(2, RING_L, 4, D)).astype(np.float32)
    k = rng.normal(size=(2, RING_L, 2, D)).astype(np.float32)
    v = rng.normal(size=(2, RING_L, 2, D)).astype(np.float32)
    mask = np.ones((2, RING_L), np.int32)
    mask[0, RING_L - 5:] = 0
    mask[1, :6] = 0
    out, lse = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attention_mask=jnp.asarray(mask), causal=causal,
        q_offset=jnp.asarray(rel, jnp.int32), interpret=True)
    out, lse = np.asarray(out), np.asarray(lse)[:, :, 0, :RING_L]
    off = torch.full((2,), rel, dtype=torch.int32)
    got, got_lse = tfa.exact_attention_with_lse(_t(q), _t(k), _t(v), _t(mask),
                                                off, causal=causal)
    got, got_lse = got.numpy(), got_lse.numpy()
    dead = lse >= tfa.DEAD_LSE * 0.5
    np.testing.assert_array_equal(got_lse >= tfa.DEAD_LSE * 0.5, dead)
    assert np.all(got_lse[dead] == tfa.DEAD_LSE)
    np.testing.assert_allclose(got_lse[~dead], lse[~dead], atol=2e-5)
    np.testing.assert_allclose(got, out, atol=2e-5)
    assert np.all(got.transpose(0, 2, 1, 3)[dead] == 0.0)
    assert dead.all() == (case == "later_chunk")
    assert dead[1, :, :6].all() == (case == "diagonal" or case ==
                                    "later_chunk")
    alone = tfa.exact_attention(_t(q), _t(k), _t(v), _t(mask), off,
                                causal=causal)
    np.testing.assert_array_equal(alone.numpy(), got)


# --- the sources -------------------------------------------------------------

def _source(name):
    return (kernels.CSRC / name).read_text()


def test_d96_config_fits_the_card():
    """``Config<96, 2, 3>`` lays D = 96 out as D128 (two 64-column boxes, a
    64-float accumulator): its shared memory, by the template's own
    arithmetic, and its register split stay within one H100 SM's."""
    header = _source("decoder_attention_sm90.cuh")
    m = re.search(r"using D96 = Config<96, (\d+), (\d+)>;", header)
    assert m is not None
    wg, stages = map(int, m.groups())
    assert "static_assert(D == 64 || D == 96 || D == 128" in header
    assert "kBoxes = (D + 63) / 64" in header
    assert "kAcc = 32 * kBoxes" in header
    boxes, block_q, block_k = (D + 63) // 64, 64 * wg, 128
    q_bytes = boxes * block_q * 128
    stage = 2 * boxes * block_k * 128
    bar = q_bytes + stages * stage
    smem = bar + (2 * stages + 2) * 8 + stages * 16 + 16 + 1024
    assert smem <= 232448, smem
    regs = re.search(r"struct Regs<%d> \{[^}]*kConsumer = (\d+), kProducer = "
                     r"(\d+);" % wg, header)
    consumer, producer = map(int, regs.groups())
    assert wg * 128 * consumer + 128 * producer <= 65536


def test_d96_backward_configs_fit_the_card():
    """K4a's and K4b's ``Config<96, ...>`` of ``attention_bwd_sm90.cuh`` lay
    D = 96 out as D128 (two 64-column boxes, a 64-float accumulator): their
    shared memory, by the template's own arithmetic, fits one CTA's 232,448
    bytes and their register split one SM's 65,536 registers."""
    header = _source("attention_bwd_sm90.cuh")
    assert "static_assert(D == 64 || D == 96 || D == 128" in header
    assert "kBoxes = (D + 63) / 64" in header
    assert "kAcc = 32 * kBoxes" in header
    regs_of = {}
    for wg in (2, 3):
        m = re.search(r"struct Regs<%d> \{[^}]*kConsumer = (\d+), kProducer"
                      r" = (\d+);" % wg, _source("decoder_attention_sm90.cuh"))
        regs_of[wg] = tuple(map(int, m.groups()))
    for name in ("DkdvD96", "DqD96"):
        m = re.search(r"using %s = Config<96, (\d+), (\d+), (\d+)>;" % name,
                      header)
        assert m is not None, name
        wg, stages, block_n = map(int, m.groups())
        boxes, block_m = (D + 63) // 64, 64 * wg
        held, streamed = boxes * block_m * 128, boxes * block_n * 128
        rows_off = 2 * held + stages * 2 * streamed
        bar_off = rows_off + stages * block_n * 8 + stages * 16
        smem = bar_off + (2 * stages + 1) * 8 + 1024
        assert smem <= 232448, (name, smem)
        consumer, producer = regs_of[wg]
        assert wg * 128 * consumer + 128 * producer <= 65536, name
    # The same shapes as D = 128's, which the card runs without a spill.
    assert re.search(r"using DkdvD128 = Config<128, 2, 4, 32>;", header)
    assert re.search(r"using DqD128 = Config<128, 2, 3, 64>;", header)
    assert "using DkdvD96 = Config<96, 2, 4, 32>;" in header
    assert "using DqD96 = Config<96, 2, 3, 64>;" in header


def test_c_entries_admit_d96_for_k2_its_pre_pass_and_k3_only():
    """The C entries admit Phi-3's 96 for K2 and K2 lse (the kernel alone
    and the op), K3 and K3 lse (causal and not), the pre-pass, K4a and K4b
    (causal and not), and refuse it for K2r and its pre-pass's per-key
    norms; every other head dim but 128 (64 for the pre-pass) is refused."""
    dec = _source("decoder_attention.cu")
    assert "static bool k2_head_dim(int D) { return D == 128 || D == 96; }" \
        in dec
    assert dec.count("if (!k2_head_dim(D))") == 2  # kernel alone, op
    assert dec.count("launch_attention<sm90::D96, true, "
                     "sm90::ShiftMode::kKeyMax>") == 2  # kernel alone, op
    assert "key_norm_partial_kernel<96>" in dec
    assert "(norms != nullptr && D != 128)" in dec  # K2r's form
    # K2r's pre-pass and its kernel-alone entry stay at InternLM2's 128.
    assert dec.count("if (D != 128) return int(cudaErrorInvalidValue);") == 2
    assert "launch_attention<sm90::D96, true, sm90::ShiftMode::kRows>" \
        not in dec
    exact = _source("exact_attention.cu")
    assert "if (D == 96) {  // Phi-3's heads" in exact
    assert "lse == nullptr" not in exact
    for causal in ("true", "false"):
        assert f"launch_attention<D96, {causal}, ShiftMode::kExact>" in exact
    bwd = _source("decoder_attention_bwd.cu")
    assert bwd.count("if (D == 96) {  // Phi-3's heads") == 2
    for kernel in ("dkdv", "dq"):
        cfg = "DkdvD96" if kernel == "dkdv" else "DqD96"
        for causal in ("true", "false"):
            assert f"launch_{kernel}<bwd::{cfg}, {causal}>" in bwd
    assert bwd.count("if (D != 128) return int(cudaErrorInvalidValue);") == 2


def test_key_norm_plan_at_d96():
    """D = 96's 12 pieces take 16 lanes: 64 key vectors a pass, as at
    D = 128."""
    assert [kernels.key_norm_lanes(d) for d in (64, 96, 128)] == [8, 16, 16]
    assert kernels.key_norm_parts(2, 3072, 32, 96) == 256
    assert kernels.key_norm_parts(1, 3, 64, 96) == 3
    with pytest.raises(ValueError, match="exceed one pass"):
        kernels.key_norm_parts(1, 8, 65, 96)


def _refused():
    q = torch.zeros(1, 8, 4, D, dtype=torch.bfloat16)
    return {
        "K2r op": lambda: kernels.decoder_attention_rows_op(q, q, q, None,
                                                            None, 1.0),
        "K2r": lambda: kernels.decoder_attention_rows(
            q, q, q, None, torch.zeros(1, 4, 8), None, 1.0),
        "K2r pre-pass": lambda: kernels.key_norm_cummax(q),
    }


def _built():
    q = torch.zeros(1, 8, 4, D, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 8)
    return {
        "K2 lse op": lambda: kernels.decoder_attention_op(
            q, q, q, None, None, 1.0, with_lse=True),
        "K2 lse": lambda: kernels.decoder_attention(
            q, q, q, None, torch.ones(1, 4), None, 1.0, with_lse=True),
        "K3 lse": lambda: kernels.exact_attention(q, q, q, None, None, 1.0,
                                                  with_lse=True),
        "K4a": lambda: kernels.decoder_attention_bwd_dkdv(
            q, q, q, q, lse, lse, None, None, 1.0),
        "K4b": lambda: kernels.decoder_attention_bwd_dq(
            q, q, q, q, lse, lse, None, None, 1.0),
    }


@pytest.mark.parametrize("form", sorted(_refused()))
def test_forms_not_built_at_d96_refuse_first_naming_the_next_item(form):
    """K2r and its pre-pass: refused before the device check, so a CPU
    tensor reaches it too; on the card it comes before any launch (the
    card test holds the counters)."""
    before = dict(kernels.launch_counts)
    with pytest.raises(NotImplementedError, match="item 5c"):
        _refused()[form]()
    assert kernels.launch_counts == before


@pytest.mark.parametrize("form", sorted(_built()))
def test_forms_built_at_d96_pass_the_head_dim_check(form):
    """K2 lse (the kernel alone and the op), K3 lse, K4a and K4b take
    D = 96: on a CPU tensor they raise for the device, not for D, and
    launch nothing."""
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="a CUDA device"):
        _built()[form]()
    assert kernels.launch_counts == before


def test_admitted_forms_at_d96_pass_the_head_dim_check():
    """K2, its pre-pass and K3 without the lse reach the device check, past
    the refusal: on a CPU tensor they raise for the device, not for D."""
    q = torch.zeros(1, 8, 4, D, dtype=torch.bfloat16)
    for call in (lambda: kernels.decoder_attention_op(q, q, q, None, None,
                                                      1.0),
                 lambda: kernels.exact_attention(q, q, q, None, None, 1.0),
                 lambda: kernels.key_norm_max(q)):
        with pytest.raises(ValueError, match="a CUDA device"):
            call()
