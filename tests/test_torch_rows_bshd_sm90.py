"""K2r's pre-pass and B3 on the Hopper templates, on the CPU.

* K2r's bound column ``kcum`` (the running max along K of the masked key
  norms) is now the key-norm partial pass, which also stores each key's
  norm, then a scan per chunk of keys that starts from the earlier chunks'
  largest partial.  Its twin, ``key_norm_cummax_chunked``, equals
  ``key_norm_cummax``'s to the bit at every chunk count (max is exact), its
  last column is ``key_norm_fold(key_norm_partials(...))`` (kmax), a prefix
  of the keys gives the prefix of kcum under the plans
  ``kernels.key_norm_parts`` picks for both lengths (K2r's prefix rows rest
  on it), and it is held against the JAX package's ``kcum``
  (``_fwd_impl``, ``mjvideo_tpu/ops/flash_attention.py:489-497``, written
  out in ``jnp``) on bf16 keys to 1e-6 relative: fp32 sums of squares in
  another order than XLA's.
* B3 is B2's hp 1 walk over the keys below ``kv_valid``: PR 16's
  ``online_walk`` (``tests/test_torch_variants_sm90.py``) on k and v cut at
  ``kv_valid``, with q rows past it, is held against B3's twin to 2**-7 of
  max|plain|, the card's bar.
* The sources: B3's entry launches the forward template with ``kv_valid``
  as K, no WMMA is left, and K2r's op chains its partial pass, scan and
  kernel with plain stores and programmatic dependent launches.

The kernels themselves run only on the card
(``tests/test_torch_kernels_rows_bshd_sm90.py``, ``chip_smoke.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.ops import vit_attention_variants as va
from test_torch_variants_sm90 import REL_TOL, online_walk

torch.set_num_threads(1)

# K: one key, one chunk of the judge's prefill plan (12 keys), training's
# 799, the 3,072 bucket and one key past it.  Every case has masked keys,
# the first 40 masked (a whole chunk at the plan's 256 parts of 12) and
# batch row 1 fully masked.
KCUM_KEYS = (1, 12, 799, 3072, 3073)
PARTS = (1, 2, 7, 256)
B, HKV, D = 2, 2, 128


def _keys(K, Hkv=HKV, seed=None):
    rng = np.random.default_rng(K if seed is None else seed)
    k = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    # Varied norms, so the running max steps up along K.
    k *= rng.uniform(0.2, 3.0, size=(B, K, Hkv, 1)).astype(np.float32)
    mask = (rng.uniform(size=(B, K)) > 0.3).astype(np.int32)
    mask[:, :40] = 0
    mask[1] = 0
    mask[0, -1] = 1
    return k, mask


def _cases():
    return [(K, n) for K in KCUM_KEYS
            for n in sorted({min(K, p) for p in PARTS + (K,)})]


@pytest.mark.parametrize("K,parts", _cases())
def test_chunked_kcum_is_key_norm_cummax(K, parts):
    """Partials, then the scan: ``key_norm_cummax``'s bits at every chunk
    count, never decreasing along K, 0 on the fully masked row and on the
    masked head of row 0; the last column is kmax's fold of the
    partials."""
    k, mask = (torch.from_numpy(a) for a in _keys(K))
    got = tfa.key_norm_cummax_chunked(k, mask, parts)
    assert got.dtype == torch.float32 and got.shape == (B, HKV, K)
    assert torch.equal(got, tfa.key_norm_cummax(k, mask))
    kmax = tfa.key_norm_fold(tfa.key_norm_partials(k, mask, parts))
    assert torch.equal(got[..., -1], kmax)
    assert bool((got[..., 1:] >= got[..., :-1]).all())
    assert not got[1].any() and not got[0, :, :min(K, 40) - 1].any()
    if K > 1:
        assert got[0, :, -1].gt(0).all()


def test_a_chunk_with_no_live_key_carries_the_max_before_it():
    """At the plan's 256 chunks of 12 keys, chunk 100 has every key masked:
    its kcum is the max of the chunks before it, the earlier chunks' scan
    carried across it."""
    k, mask = _keys(3072, Hkv=8)
    mask[0, 1200:1212] = 0
    k, mask = torch.from_numpy(k), torch.from_numpy(mask)
    parts = kernels.key_norm_parts(B, 3072, 8, D)
    assert -(-3072 // parts) == 12
    got = tfa.key_norm_cummax_chunked(k, mask, parts)
    assert not tfa.key_norm_partials(k, mask, parts)[0, 100].any()
    held = got[0, :, 1199:1212]
    assert torch.equal(held, held[:, :1].expand_as(held))
    assert torch.equal(got, tfa.key_norm_cummax(k, mask))


def _jax_kcum(k, mask):
    """``_fwd_impl``'s ``kcum`` on (B, K, Hkv, D) keys: (B, Hkv, K)."""
    k32 = jnp.transpose(jnp.asarray(k), (0, 2, 1, 3)).astype(jnp.float32)
    kn2 = jnp.sum(k32 * k32, axis=-1)
    kn2 = kn2 * (jnp.asarray(mask) != 0)[:, None, :].astype(jnp.float32)
    return np.asarray(jax.lax.cummax(jnp.sqrt(kn2), axis=2))


def test_chunked_kcum_on_bf16_keys_matches_jax():
    """On bf16 keys, the kernels' dtype, at the judge's prefill shape and
    the plan's chunks, against ``_fwd_impl``'s ``kcum`` on the same bf16
    values."""
    k, mask = _keys(3072, Hkv=8, seed=5)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    parts = kernels.key_norm_parts(B, 3072, 8, D)
    got = tfa.key_norm_cummax_chunked(kb, torch.from_numpy(mask), parts)
    want = _jax_kcum(jnp.asarray(k).astype(jnp.bfloat16), mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# (K, P): the judge's prefill bucket cut at the shared prefix (2,308 keys:
# chunks of 10 against 12), at K // 2 + 1 (chunks of 8), at one chunk and
# at one key; the prefix bucket and the continuation's cache at the prefix.
PREFIXES = ((3072, 2308), (3072, 1537), (3072, 12), (3072, 1), (2368, 2308),
            (2560, 2308))


@pytest.mark.parametrize("K,P", PREFIXES)
def test_kcum_of_a_prefix_is_the_prefix_of_kcum(K, P):
    """kcum of k[:, :P] under the plan for P equals kcum[..., :P] under the
    plan for K, bit for bit: K2r's rows of a prefix-only prefill equal
    those of the full prompt."""
    k, mask = (torch.from_numpy(a) for a in _keys(K, Hkv=8, seed=K + P))
    full = tfa.key_norm_cummax_chunked(
        k, mask, kernels.key_norm_parts(B, K, 8, D))
    cut = tfa.key_norm_cummax_chunked(
        k[:, :P], mask[:, :P], kernels.key_norm_parts(B, P, 8, D))
    assert torch.equal(cut, full[..., :P])


def test_the_plans_of_k2rs_pre_pass_at_the_judges_shapes():
    """K2r's pre-pass takes K1/K2's plan: 256 chunks at the judge's
    prefill (12 keys a chunk), prefix (10) and continuation (10), and at
    the shared prefix's 2,308 keys (10); 193 chunks of 8 at 1,537."""
    plan = kernels.key_norm_parts
    assert plan(2, 3072, 8, 128) == 256
    assert plan(1, 2368, 8, 128) == 256
    assert plan(2, 2560, 8, 128) == 256
    assert plan(2, 2308, 8, 128) == 256
    assert plan(2, 1537, 8, 128) == 193


def _qkv(seed, S, kv, H=2):
    """q, k, v (1, S, H, 64) bf16; k and v NaN at and past ``kv``."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, S, H, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    k[:, kv:] = float("nan")
    v[:, kv:] = float("nan")
    return q, k, v


@pytest.mark.parametrize("S,kv", [(37, 37), (1032, 1025), (24, 17)])
def test_b3_walk_over_its_live_keys_matches_the_twin(S, kv):
    """B3's walk, B2's hp 1 (64-key tiles, the exact online max) over the
    keys below ``kv_valid`` with every q row (those past it too), against
    B3's twin; the keys past ``kv_valid`` are NaN and neither reads them."""
    q, k, v = _qkv(S + kv, S, kv)
    want = va.bshd_attention_plain(q, k, v, kv).view(q.shape)
    assert torch.isfinite(want.float()).all()
    got = online_walk(q, k[:, :kv], v[:, :kv], "exact", 64)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL * want.float().abs().max().item(), err


def _source(name):
    return (kernels.CSRC / name).read_text()


def _entry(text, name):
    start = text.index(f'extern "C" int {name}(')
    end = text.find('extern "C"', start + 1)
    return text[start:end if end > 0 else len(text)]


def test_b3_launches_the_forward_template_over_kv_valid_keys():
    """B3's entry is B2's hp 1 launch with ``kv_valid`` as K (its k/v
    tensor maps end there), the helper passes K on, and the file holds no
    kernel of its own."""
    text = _source("vit_attention_variants.cu")
    b3 = " ".join(_entry(text, "mjv_vit_attention_bshd").split())
    assert ("return launch_sm90<Hp1, ShiftMode::kExact>(q, k, v, out, B, S, "
            "kv_valid, H,") in b3
    assert "kv_valid < 1 || kv_valid > S" in b3
    helper = " ".join(text[text.index("int launch_sm90("):].split())
    assert ("launch_attention<C, false, SHIFT, false, VAR>( q, k, v, nullptr,"
            " nullptr, 1, nullptr, out, nullptr, B, S, K, H, H,") in helper
    for gone in ("<<<", "wmma", "<mma.h>", "__global__"):
        assert gone not in text, gone


def test_no_wmma_and_no_bound_attention_header_are_left():
    assert not (kernels.CSRC / "bound_attention.cuh").exists()
    assert "bound_attention.cuh" not in kernels.HEADERS
    for path in sorted(kernels.CSRC.iterdir()):
        text = path.read_text()
        assert "nvcuda::wmma" not in text and "<mma.h>" not in text, path
        assert "bound_attention.cuh" not in text, path


def test_the_rows_op_chains_partials_scan_and_kernel():
    """K2r's op: the partial pass (plain launch, each key's norm stored),
    the scan as its programmatic dependent, K2r as the scan's, reading kcum
    only after its wait; no memset, no atomics; launch_attention takes a
    dependent K2r."""
    dec = _source("decoder_attention.cu")
    op = _entry(dec, "mjv_decoder_attention_rows_op")
    assert op.index("launch_key_norm_cummax(") < op.index(
        "ShiftMode::kRows>(")
    assert "stream, true)" in op
    helper = dec[dec.index("int launch_key_norm_cummax("):]
    helper = helper[:helper.index("\n}\n")]
    assert "launch_partials(k, mask, part, kcum," in helper
    assert "sm90::launch_dependent(" in helper
    assert "key_norm_scan_kernel" in helper
    scan = dec[dec.index("key_norm_scan_kernel(const"):]
    scan = scan[:scan.index("\n}\n")]
    assert scan.index("grid_dependency_wait()") < scan.index("part +")
    assert "key_norm_partial_kernel<128, true>" in dec
    assert not re.search(r"atomic\w*\(", dec) and "emset(" not in dec
    header = _source("decoder_attention_sm90.cuh")
    body = header[header.index("attention_kernel(const __grid_constant__"):]
    wait = body.index("if (r == 0) grid_dependency_wait();")
    assert wait < body.index("const float kc = bound[")
    assert "SHIFT != ShiftMode::kRows)" in header
    assert "torch.zeros" not in re.sub(r"#.*", "", _wrapper_text())


def _wrapper_text():
    import inspect

    return "".join(inspect.getsource(getattr(kernels, name)) for name in (
        "key_norm_cummax", "decoder_attention_rows_op"))


def test_k2r_on_the_cpu_takes_the_twin_and_launches_nothing():
    """``decoder_attention_rows`` on CPU tensors is the twin, whatever the
    op's route on the card; no counter moves."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 20, 4, 128, generator=g)
    k = torch.randn(1, 20, 2, 128, generator=g)
    v = torch.randn(1, 20, 2, 128, generator=g)
    mask = torch.ones(1, 20, dtype=torch.int32)
    mask[0, :3] = 0
    kernels.reset_launch_counts()
    got = tfa.decoder_attention_rows(q, k, v, mask)
    assert not any(kernels.launch_counts.values())
    assert torch.equal(got, tfa.decoder_attention_rows_plain(q, k, v, mask))
