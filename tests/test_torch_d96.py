"""K2, its key-norm pre-pass and K3 at Phi-3's head dim of 96 (MJ-VIDEO-4B's
decoder), on the CPU.

The plain twins (what the CPU path of ``decoder_attention``,
``key_norm_max`` and ``exact_attention`` computes, and what the card's
kernels are held against in ``tests/test_torch_kernels_d96_sm90.py`` and
``chip_smoke.py``) against the JAX package's Pallas kernels in interpret
mode through ``flash_attention(norm_bound=True | False)``, at D = 96 with
ragged and left-padded masks, dead rows and sequences on each side of the
card's 128-row and 128-key tiles; atol 2e-5 (the same fp32 sums in other
orders, as ``tests/test_torch_flash_attention.py`` holds them at D = 16),
dead rows exactly 0.  The pre-pass's partials and fold against ``_fwd_impl``'s
key-norm reduce written out in ``jnp`` (relative 1e-6: fp32 sums of squares
in another order).  Then the sources: ``Config<96, ...>`` fits the card's
shared memory and registers, the C entries admit D = 96 for K2, its
pre-pass and K3 only without the lse, and the wrappers refuse the other
forms at D = 96 before any check or launch, naming the next ROADMAP item.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import flash_attention
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


def _inputs(case):
    B, T, Hq, Hkv, kind = CASES[case]
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


def test_c_entries_admit_d96_for_k2_its_pre_pass_and_k3_only():
    dec = _source("decoder_attention.cu")
    assert "return D == 128 || (D == 96 && lse == nullptr);" in dec
    assert dec.count("if (!k2_head_dim(D, lse))") == 2  # kernel alone, op
    assert dec.count("launch_attention<sm90::D96, true, "
                     "sm90::ShiftMode::kKeyMax>") == 2  # kernel alone, op
    assert "key_norm_partial_kernel<96>" in dec
    assert "(norms != nullptr && D != 128)" in dec  # K2r's form
    # K2r's pre-pass and its kernel-alone entry stay at InternLM2's 128.
    assert dec.count("if (D != 128) return int(cudaErrorInvalidValue);") == 2
    exact = _source("exact_attention.cu")
    assert "if (D == 96 && lse == nullptr) {" in exact
    for causal in ("true", "false"):
        assert f"launch_attention<D96, {causal}, ShiftMode::kExact>" in exact
    bwd = _source("decoder_attention_bwd.cu")
    assert "D96" not in bwd and "D != 128" in bwd


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
    lse = torch.zeros(1, 4, 8)
    return {
        "K2 lse op": lambda: kernels.decoder_attention_op(
            q, q, q, None, None, 1.0, with_lse=True),
        "K2 lse": lambda: kernels.decoder_attention(
            q, q, q, None, torch.ones(1, 4), None, 1.0, with_lse=True),
        "K3 lse": lambda: kernels.exact_attention(q, q, q, None, None, 1.0,
                                                  with_lse=True),
        "K2r op": lambda: kernels.decoder_attention_rows_op(q, q, q, None,
                                                            None, 1.0),
        "K2r": lambda: kernels.decoder_attention_rows(
            q, q, q, None, torch.zeros(1, 4, 8), None, 1.0),
        "K2r pre-pass": lambda: kernels.key_norm_cummax(q),
        "K4a": lambda: kernels.decoder_attention_bwd_dkdv(
            q, q, q, q, lse, lse, None, None, 1.0),
        "K4b": lambda: kernels.decoder_attention_bwd_dq(
            q, q, q, q, lse, lse, None, None, 1.0),
    }


@pytest.mark.parametrize("form", sorted(_refused()))
def test_forms_not_built_at_d96_refuse_first_naming_the_next_item(form):
    """Refused before the device check, so a CPU tensor reaches it too; on
    the card it comes before any launch (the card test holds the
    counters)."""
    before = dict(kernels.launch_counts)
    with pytest.raises(NotImplementedError, match="item 5b"):
        _refused()[form]()
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
