"""The two pre-passes of the main paths on the CPU: their twins against the
JAX package, their plans, and what their sources may and may not do.

* K1/K2's key-norm max is now a partial pass (the largest masked key norm
  of each chunk of keys) whose partials the attention kernel folds.  The
  twin of that decomposition, ``key_norm_fold(key_norm_partials(...))``,
  equals ``key_norm_max``'s twin to the bit (max is exact and sqrt
  monotone) at every chunk count, and the JAX package's norm-bound reduce
  (``_fwd_impl``, ``mjvideo_tpu/ops/flash_attention.py:484-511``, written
  out in ``jnp`` as ``tests/test_torch_bound_attention_sm90.py`` does) to
  1e-6 relative: fp32 sums of squares in another order than XLA's.
* K6's pre-pass quantizes each (row, group) of x; its twin
  ``_quantize_rows_grouped`` is held bit-equal to JAX's
  (``mjvideo_tpu/ops/quant.py:276``) at the new kernel's edges: one row, a
  tail past a CTA's rows, a zero row (the scale's 1e-12 floor), values at
  +-amax and quotients that tie at .5.
* The sources: the partial pass and K2r's scan write with plain stores (no
  atomics) and their entries zero nothing; only the fused entries (the K1,
  K2 and K2r ops, K6, and K2r's pre-pass, whose scan follows its partial
  pass) launch with programmatic stream serialization.

The kernels themselves run only on the card
(``tests/test_torch_kernels_prepass_sm90.py``, ``chip_smoke.py``).
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops import quant as jq
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

# (B, K, Hkv, D, mask kind): K = 1, 31, 32, 33 (each side of a 32-key
# chunk), the ViT's 1,025-token tile and the decoder's 3,072 bucket;
# "chunk" masks whole chunks, "dead" every key of batch row 1.
KMAX_CASES = {
    "k1": (2, 1, 4, 128, None),
    "k31": (2, 31, 2, 128, "dead"),
    "k32": (1, 32, 4, 64, None),
    "k33": (2, 33, 2, 128, "chunk"),
    "k1025": (2, 1025, 4, 64, None),
    "k3072": (2, 3072, 2, 128, "chunk"),
}
PARTS = (1, 3, 16)


def _keys(case):
    B, K, Hkv, D, kind = KMAX_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    k = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    k *= rng.uniform(0.2, 3.0, size=(B, K, Hkv, 1)).astype(np.float32)
    mask = None
    if kind is not None:
        mask = (rng.uniform(size=(B, K)) > 0.3).astype(np.int32)
        if kind == "dead":
            mask[1] = 0
        else:  # the first 16 keys of each row: chunk 0 of 16 parts or more
            mask[:, :min(K, 16)] = 0
    return k, mask


def _jax_masked_kmax(k, mask):
    """``_fwd_impl``'s reduce on (B, K, Hkv, D): (B, Hkv)."""
    B, K = k.shape[:2]
    k32 = jnp.transpose(jnp.asarray(k), (0, 2, 1, 3)).astype(jnp.float32)
    kn2 = jnp.sum(k32 * k32, axis=-1)
    m = jnp.ones((B, K), jnp.int32) if mask is None else jnp.asarray(mask)
    kn2 = kn2 * (m != 0)[:, None, :].astype(jnp.float32)
    return np.asarray(jnp.sqrt(jnp.max(kn2, axis=-1)))


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("case", sorted(KMAX_CASES))
def test_partials_then_fold_is_key_norm_max(case, parts):
    """The partial pass's twin folded equals ``key_norm_max``'s twin to the
    bit at every chunk count (more parts than keys leaves chunks empty,
    which write 0), and JAX's reduce to fp32 ulps; a chunk with no live key
    is 0, and so is a row with none."""
    k, mask = _keys(case)
    B, K, Hkv, D, kind = KMAX_CASES[case]
    kt = torch.from_numpy(k)
    mt = None if mask is None else torch.from_numpy(mask)
    partials = tfa.key_norm_partials(kt, mt, parts)
    assert partials.dtype == torch.float32
    assert partials.shape == (B, parts, Hkv)
    want = tfa.key_norm_max(kt, mt)
    assert torch.equal(tfa.key_norm_fold(partials), want)
    np.testing.assert_allclose(want.numpy(), _jax_masked_kmax(k, mask),
                               rtol=1e-6, atol=0)
    chunk = -(-K // parts)
    for c in range(parts):
        lo, hi = c * chunk, min(K, (c + 1) * chunk)
        live = (np.ones((B, max(hi - lo, 0)), bool) if mask is None
                else mask[:, lo:hi] != 0)
        empty = ~live.any(axis=1)
        assert not partials[torch.from_numpy(empty), c].any()
    if kind == "dead":
        assert not want[1].any()


def test_partials_twin_on_bf16_keys_matches_jax():
    """On bf16 keys, the kernels' dtype, against ``_fwd_impl``'s reduce on
    the same bf16 values."""
    k, mask = _keys("k3072")
    kb = torch.from_numpy(k).to(torch.bfloat16)
    got = tfa.key_norm_fold(tfa.key_norm_partials(
        kb, torch.from_numpy(mask), kernels.key_norm_parts(2, 3072, 2, 128)))
    want = _jax_masked_kmax(jnp.asarray(k).astype(jnp.bfloat16), mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_the_plan_of_the_partial_pass():
    """About KEY_NORM_CTAS CTAs, at least one whole pass of keys each, at
    most KEY_NORM_PARTS_MAX partials: the main paths' shapes, the long
    clip's, and a refusal where one pass cannot hold a key."""
    plan = kernels.key_norm_parts
    assert plan(2, 3072, 8, 128) == 256      # 12 keys (24 KB) a CTA
    assert plan(8, 1025, 16, 64) == 66       # 528 CTAs of 16 keys
    assert plan(1, 799, 8, 128) == 100       # one pass of 8 keys each
    assert plan(1, 53760, 8, 128) == kernels.KEY_NORM_PARTS_MAX
    assert plan(1, 1, 8, 128) == 1
    for B, K, Hkv, D in ((1, 5, 1, 64), (64, 20000, 8, 128),
                         (3, 777, 64, 128), (2, 100, 128, 64)):
        n = plan(B, K, Hkv, D)
        assert 1 <= n <= min(K, kernels.KEY_NORM_PARTS_MAX)
    with pytest.raises(ValueError, match="heads"):
        plan(1, 10, 65, 128)


# (M, K, g): one row, a tail past the 8 rows of K = 2,048 that one CTA of
# the pre-pass holds at g = 128, the 3 pieces a lane of g = 96 and the 9 of
# g = 288 (the group read twice).
QUANT_CASES = {
    "m1": (1, 2048, 128),
    "m9_tail": (9, 2048, 128),
    "g96": (5, 768, 96),
    "g288": (3, 576, 288),
    "g32": (4, 256, 32),
}


def _activations(case):
    """bf16-valued fp32 x with a zero row, a group at +-amax and a group of
    exact ties (amax 127: scale 1, quotients k + 0.5)."""
    M, K, g = QUANT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[0, :g] = 0.0
    if M > 1:
        x[1, :g] = 1.5
        x[1, 1:g:2] = -1.5
    if M > 2:
        x[2, :g] = np.arange(g) % 8 - 3.5
        x[2, 0] = 127.0
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_rows_grouped_twin_is_jax_at_the_edges(case):
    x = _activations(case)
    M, K, g = QUANT_CASES[case]
    G = K // g
    xq, a_s = jq._quantize_rows_grouped(jnp.asarray(x), G, g)
    txq, ta_s = tq._quantize_rows_grouped(torch.from_numpy(x), G, g)
    assert np.array_equal(txq.numpy(), np.asarray(xq))
    assert np.array_equal(ta_s.numpy(), np.asarray(a_s))
    assert ta_s[0, 0].item() == np.float32(1e-12)
    if M > 1:
        assert set(np.unique(txq[1, :g].numpy())) == {-127, 127}
    if M > 2:
        # Ties round to even: -3.5 -> -4, -2.5 -> -2, ..., 3.5 -> 4.
        assert txq[2, 1:8].tolist() == [-2, -2, 0, 0, 2, 2, 4]


def _entries(source: str):
    """{name: body} of each ``extern "C"`` function in a CUDA source."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(', source):
        i = source.index("{", m.end())
        depth, j = 0, i
        while True:
            depth += {"{": 1, "}": -1}.get(source[j], 0)
            j += 1
            if depth == 0:
                break
        out[m.group(1)] = source[i:j]
    return out


def _source(name):
    return (kernels.CSRC / name).read_text()


def test_the_partial_pass_has_no_atomics_and_its_entry_no_memset():
    src = _source("decoder_attention.cu")
    start = src.index("key_norm_partial_kernel(")
    kernel = src[start:src.index("key_norm_fold_kernel(")]
    assert "atomic" not in kernel
    # K2r's pre-pass, and the whole source: no atomic call, no memset.
    start = src.index("key_norm_scan_kernel(")
    assert "atomic" not in src[start:src.index("// K2r's pre-pass on")]
    assert not re.search(r"atomic\w*\(", src) and "cudaMemset" not in src
    entries = _entries(src)
    for name in ("mjv_key_norm_max", "mjv_decoder_attention_op",
                 "mjv_key_norm_cummax", "mjv_decoder_attention_rows_op"):
        assert "Memset" not in entries[name] and "memset" not in entries[name]
    assert "Memset" not in _entries(_source("vit_attention.cu"))[
        "mjv_vit_attention_op"]
    for name in ("key_norm_max", "vit_attention_op", "decoder_attention_op",
                 "key_norm_cummax", "decoder_attention_rows_op"):
        wrapper = inspect.getsource(getattr(kernels, name))
        assert "torch.zeros" not in wrapper and "zero_" not in wrapper
        assert "fill_" not in wrapper


def test_only_the_fused_entries_launch_as_programmatic_dependents():
    """The attribute is set in one helper, ``launch_dependent``; the K1, K2
    and K2r ops and K6 reach it (``launch_attention(..., true)`` or
    ``launch_gemm(..., true)``), and so does K2r's pre-pass
    (``launch_key_norm_cummax``: the scan behind the partial pass), alone
    or in K2r's op; the kernel-alone entries, K3, K4 and K7 do not, so none
    of them can start before its predecessor ends."""
    header = _source("decoder_attention_sm90.cuh")
    assert header.count("cudaLaunchAttributeProgrammaticStreamSerialization") == 1
    fused = {"mjv_decoder_attention_op", "mjv_vit_attention_op",
             "mjv_q8g_matmul_fused", "mjv_decoder_attention_rows_op",
             "mjv_key_norm_cummax"}
    seen = set()
    for name in sorted(p.name for p in kernels.CSRC.glob("*.cu")):
        src = _source(name)
        assert "ProgrammaticStreamSerialization" not in src, name
        for entry, body in _entries(src).items():
            seen.add(entry)
            dependent = bool(re.search(
                r"stream, true\)|s, true\)|launch_key_norm_cummax\(", body))
            assert dependent == (entry in fused), entry
    assert fused <= seen
    assert {"mjv_decoder_attention", "mjv_vit_attention",
            "mjv_decoder_attention_rows", "mjv_exact_attention",
            "mjv_q8g_matmul", "mjv_decoder_attention_bwd_dkdv",
            "mjv_vit_attention_bwd_dq"} <= seen
    # K2r's op: the partial pass launched plainly, the scan as its
    # dependent, then K2r as the scan's.
    dec = _source("decoder_attention.cu")
    helper = dec[dec.index("int launch_key_norm_cummax("):]
    helper = helper[:helper.index("\n}\n")]
    assert helper.index("launch_partials(") < helper.index(
        "sm90::launch_dependent(")
    assert "key_norm_scan_kernel" in helper
    rows_op = _entries(dec)["mjv_decoder_attention_rows_op"]
    assert rows_op.index("launch_key_norm_cummax(") < rows_op.index(
        "ShiftMode::kRows>")
    # The dependents wait: the attention kernel before it folds the
    # partials (K1, K2) or reads kcum (K2r), the scan before it reads the
    # partials, the GEMM's producer before its xq and a_s; the pre-passes
    # release them once their loads are issued (the scan at once).
    assert header.count("grid_dependency_wait();") == 2
    q8g = _source("q8g_matmul.cu")
    assert q8g.count("grid_dependency_wait();") == 1
    assert q8g.count("grid_launch_dependents();") == 1
    assert dec.count("grid_dependency_wait();") == 1  # the scan's
    # The partial pass after its loads or with no keys, the scan at once.
    assert dec.count("grid_launch_dependents();") == 3


def test_the_ops_and_the_pre_pass_entries_are_bound():
    for name in ("mjv_vit_attention_op", "mjv_decoder_attention_op",
                 "mjv_key_norm_max", "mjv_vit_attention",
                 "mjv_decoder_attention", "mjv_decoder_attention_rows_op",
                 "mjv_key_norm_cummax"):
        assert name in kernels.ARGTYPES
    # q, k, v, partials, out, lse; B, S, H, D; six strides; parts, scale,
    # stream.
    assert len(kernels.ARGTYPES["mjv_vit_attention_op"]) == 19
    assert len(kernels.ARGTYPES["mjv_decoder_attention_op"]) == 23
    assert len(kernels.ARGTYPES["mjv_key_norm_max"]) == 12
    # K2r's op: kcum in place of the lse; its pre-pass as key_norm_max's.
    assert len(kernels.ARGTYPES["mjv_decoder_attention_rows_op"]) == 23
    assert len(kernels.ARGTYPES["mjv_key_norm_cummax"]) == 12
