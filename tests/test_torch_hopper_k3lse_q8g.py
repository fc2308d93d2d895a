"""K3 lse, K6 and K7 on the Hopper templates, and F4's flush budget, on the
CPU.

* The K3-lse twin (``exact_attention_plain(return_lse=True)``, what
  ``exact_attention_with_lse`` computes for a CPU tensor) against
  ``_fwd_impl(..., with_lse=True, interpret=True)`` (``_fwd_kernel`` with
  its lse) at the wgmma/TMA template's edges: Q and K in {127, 128, 129}
  around the 128-row q tile and the 128-key kv tile, GQA 4/2, a key mask
  with a left-padded row, and q_offset -K (a later shard's chunk: every
  causal row dead), 0 and K / 2, causal and not.  Tolerances: atol 2e-5 on
  fp32 inputs (fp32 sums in another order, as
  ``tests/test_torch_flash_attention.py`` holds them); 2^-7 of max|JAX| on
  bf16 inputs (both round p and the output to bf16, so a sum in another
  order can move a p across a rounding edge); the lse to 1e-5 nats on live
  rows and exactly ``DEAD_LSE`` on dead ones, whose output is exactly 0.
* The K6 and K7 twins on k-major weights (the layout the port now stores
  every int8 weight in), at an M tail, an odd N and g of 32 and 128: bit
  for bit against the same twins on the row-major weight, and against
  ``_q8g_matmul_pallas_fused`` / ``_q8g_matmul_pallas(interpret=True)`` to
  1e-5 of max|pallas|, the bar of ``tests/test_torch_quant.py`` (both take
  an exact int32 partial per group and the same fp32 steps, but XLA on the
  CPU contracts the interpreted kernel's scale products and sum into other
  roundings, an ulp or two: 666 of 7,437 values at (37, 256, 201) g 32).
* The layout: ``quantize_kernel`` (2-D and stacked, per column and
  grouped) gives JAX's values bit for bit in a k-major ``q``
  (``q.stride(-2) == 1``); the bridge, a stacked node's slices and a
  ``torch.save`` round trip keep it; ``int8_matmul`` reads it with no copy.
* The routes: K3 lse launches the Hopper template from
  ``exact_attention.cu``, which no longer includes the WMMA header; K6 and
  K7 run the int8 wgmma GEMM.
* F4's instrument (``tools/k2lse_budget_torch.py``): its counts find the
  rows whose bound overshoots their largest score past
  ``ex2.approx.ftz``'s 87.3-nat budget, and none on random decoder inputs.
"""

import importlib.util
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops import quant as jq
from mjvideo_tpu.ops.flash_attention import _fwd_impl
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.ops import quant as tq
from mjvideo_tpu_torch.utils.bridge import from_jax_params, map_state

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

LSE_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -7

# (Q = K, q_offset as a multiple of K: -1, 0 or 1/2)
K3_LSE_CASES = [(n, rel) for n in (127, 128, 129) for rel in ("-K", "0",
                                                                "K/2")]


def _k3_inputs(n, seed):
    """B = 2, GQA 4/2, D = 16; row 1 masks its first 7 keys (its first 7
    queries see no key at offset 0), row 0 its last 3."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, n, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, n, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, n, 2, 16)).astype(np.float32)
    mask = np.ones((2, n), np.int32)
    mask[1, :7] = 0
    mask[0, n - 3:] = 0
    return q, k, v, mask


def _close(got, ref, rel=1e-5):
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _offset(n, rel):
    return {"-K": -n, "0": 0, "K/2": n // 2}[rel]


def _jax_k3_lse(q, k, v, mask, off, causal):
    n = q.shape[1]
    out, lse = _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask),
                         jnp.full((q.shape[0],), off, jnp.int32) if causal
                         else None, causal, None, None, None, True, True)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)[:, :, 0, :n]


def _check_lse(got_lse, lse):
    dead = lse >= tfa.DEAD_LSE * 0.5
    np.testing.assert_array_equal(got_lse >= tfa.DEAD_LSE * 0.5, dead)
    assert np.all(got_lse[dead] == tfa.DEAD_LSE)
    assert np.all(lse[dead] == tfa.DEAD_LSE)
    if (~dead).any():
        np.testing.assert_allclose(got_lse[~dead], lse[~dead], atol=LSE_TOL,
                                   rtol=0)
    return dead


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,rel", K3_LSE_CASES)
def test_k3_lse_twin_matches_pallas_at_the_hopper_tile_edges(n, rel, causal):
    """The K3-lse twin against ``_fwd_kernel(with_lse=True)`` on fp32
    inputs: output to 2e-5, the lse to 1e-5 nats, dead rows exactly 0 and
    DEAD_LSE in both."""
    q, k, v, mask = _k3_inputs(n, n + len(rel))
    off = _offset(n, rel)
    out, lse = _jax_k3_lse(q, k, v, mask, off, causal)
    got, got_lse = tfa.exact_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), torch.full((2,), off, dtype=torch.int32),
        causal=causal)
    got, got_lse = got.numpy(), got_lse.numpy()
    dead = _check_lse(got_lse, lse)
    np.testing.assert_allclose(got, out, atol=2e-5)
    rows_dead = dead.transpose(0, 2, 1)  # (B, Q, Hq)
    assert np.all(got[rows_dead] == 0.0) and np.all(out[rows_dead] == 0.0)
    if causal and rel == "-K":
        assert dead.all()
    if causal and rel == "0":
        assert dead[1, :, :7].all() and not dead[1, :, 7:].any()


@pytest.mark.parametrize("n,rel", [(127, "0"), (129, "K/2"), (128, "-K")])
def test_k3_lse_twin_matches_pallas_on_bf16_inputs(n, rel):
    """The same on bf16 q/k/v (the kernel's dtype): output to 2^-7 of
    max|JAX|, the lse to 1e-5 nats (both take the scores and sums in
    fp32)."""
    q, k, v, mask = _k3_inputs(n, 3 * n)
    off = _offset(n, rel)
    J = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    T = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out, lse = _fwd_impl(J(q), J(k), J(v), jnp.asarray(mask),
                         jnp.full((2,), off, jnp.int32), True, None, None,
                         None, True, True)
    out = np.asarray(out.astype(jnp.float32))
    lse = np.asarray(lse)[:, :, 0, :n]
    got, got_lse = tfa.exact_attention_with_lse(
        T(q), T(k), T(v), torch.from_numpy(mask),
        torch.full((2,), off, dtype=torch.int32))
    assert got.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    _check_lse(got_lse.numpy(), lse)
    top = np.abs(out).max()
    assert np.abs(got.float().numpy() - out).max() <= BF16_REL_TOL * max(
        top, 1e-30)


# (M, K, N, g): an M tail, odd N, g of 32 and 128.
Q8G_CASES = [(37, 256, 201, 32), (5, 512, 129, 128), (70, 384, 33, 128),
             (1, 128, 97, 32)]


@pytest.mark.parametrize("M,K,N,g", Q8G_CASES)
def test_k6_and_k7_twins_on_k_major_weights_match_pallas(M, K, N, g):
    """The twins take the k-major weight the port stores: the row-major
    weight's results to the bit, the Pallas kernels' to 1e-5."""
    rng = np.random.default_rng(M * K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    jk = jq.quantize_kernel(jnp.asarray(w), group_size=g)
    ref6 = np.asarray(jq._q8g_matmul_pallas_fused(
        jnp.asarray(x), jk.q, jk.scale, out_dtype=jnp.float32, block_m=8,
        block_n=N, interpret=True))
    tk = tq.quantize_kernel(torch.from_numpy(w), group_size=g)
    assert tq.is_k_major(tk.q)
    got6 = tq.q8g_matmul_fused(torch.from_numpy(x), tk.q, tk.scale,
                               torch.float32)
    rows6 = tq.q8g_matmul_fused(torch.from_numpy(x), tk.q.contiguous(),
                                tk.scale, torch.float32)
    assert torch.equal(got6, rows6)
    _close(got6.numpy(), ref6)
    G = K // g
    xq, a_s = jq._quantize_rows_grouped(jnp.asarray(x), G, g)
    ref7 = np.asarray(jq._q8g_matmul_pallas(xq, a_s, jk.q, jk.scale,
                                            block_m=8, block_n=N,
                                            interpret=True))
    txq, ta_s = (torch.from_numpy(np.asarray(a)) for a in (xq, a_s))
    got7 = tq.q8g_matmul(txq, ta_s, tk.q, tk.scale)
    assert torch.equal(got7, tq.q8g_matmul(txq, ta_s, tk.q.contiguous(),
                                           tk.scale))
    _close(got7.numpy(), ref7)
    # K7 on K6's own quantization is K6 (fp32 out).
    assert torch.equal(got7, got6)


@pytest.mark.parametrize("group_size", [None, 32, 128])
@pytest.mark.parametrize("stacked", [False, True])
def test_quantize_kernel_is_k_major_and_bit_equal_to_jax(group_size,
                                                         stacked):
    rng = np.random.default_rng(11)
    shape = (3, 256, 96) if stacked else (256, 96)
    w = rng.normal(size=shape).astype(np.float32)
    ref = jq.quantize_kernel(jnp.asarray(w), group_size=group_size)
    got = tq.quantize_kernel(torch.from_numpy(w), group_size=group_size)
    assert got.q.dtype == torch.int8 and got.q.shape == shape
    assert got.q.stride(-2) == 1 and got.q.stride(-1) == 256
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    if stacked:
        for i in range(3):
            assert tq.is_k_major(got.q[i])
            np.testing.assert_array_equal(got.q[i].numpy(),
                                          np.asarray(ref.q[i]))


def test_bridge_slices_and_checkpoints_keep_the_k_major_layout():
    """JAX's quantized node through ``from_jax_params``, a stacked node's
    slices by ``map_state``, and a ``torch.save`` round trip: each int8
    weight stays a k-major view with JAX's values, and ``int8_matmul``'s
    column-major operand is the weight itself (no copy)."""
    rng = np.random.default_rng(12)
    w = rng.normal(size=(2, 128, 64)).astype(np.float32)
    w1 = jq.quantize_kernel(jnp.asarray(w), group_size=32)
    tree = {"layers": {"w1": {"kernel": w1}},
            "head": {"kernel": jq.quantize_kernel(jnp.asarray(w[0]))}}
    state = from_jax_params(tree, device="cpu")
    node = state["layers"]["w1"]["kernel"]
    assert node.q.stride() == (128 * 64, 1, 128)
    np.testing.assert_array_equal(node.q.numpy(),
                                  np.asarray(tree["layers"]["w1"]["kernel"].q))
    one = map_state(lambda a: a[1], state["layers"])["w1"]["kernel"]
    assert tq.is_k_major(one.q)
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    back = torch.load(buf, weights_only=False)
    assert back["layers"]["w1"]["kernel"].q.stride() == node.q.stride()
    head = back["head"]["kernel"].q
    assert tq.is_k_major(head) and head.t().is_contiguous()
    a = torch.from_numpy(rng.integers(-127, 128, size=(3, 128)).astype(
        np.int8))
    np.testing.assert_array_equal(
        tq.int8_matmul(a, head).numpy(),
        a.long().numpy() @ np.asarray(tree["head"]["kernel"].q).astype(
            np.int64))


def test_k3_lse_and_k6_run_the_hopper_templates():
    """K3 lse is the kExact instantiation's lse epilogue of the wgmma/TMA
    template (its refusal lifted), and exact_attention.cu no longer
    includes the WMMA header; K6 and K7 run the int8 wgmma GEMM on a
    k-major weight, K6 behind its pre-pass, counted on its own."""
    exact = (kernels.CSRC / "exact_attention.cu").read_text()
    assert "bound_attention.cuh" not in exact
    assert "launch_attention<D128, true, ShiftMode::kExact>" in exact
    assert "out, lse, B, Q, K" in exact
    tmpl = (kernels.CSRC / "decoder_attention_sm90.cuh").read_text()
    assert "SHIFT == ShiftMode::kRows) {" in tmpl  # the only lse refusal
    q8g = (kernels.CSRC / "q8g_matmul.cu").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in q8g
    assert "mma.sync.aligned" not in q8g
    assert "decoder_attention_sm90.cuh" in q8g
    assert "q8g_quantize" in kernels.launch_counts


def test_k6_wrapper_refuses_a_weight_that_is_not_k_major():
    """A row-major (K, N) weight would need a transposed copy per call:
    the card's wrappers refuse it (the check runs before any launch)."""
    w = torch.zeros((128, 64), dtype=torch.int8)
    assert not tq.is_k_major(w) and tq.is_k_major(tq.k_major(w))
    with pytest.raises(ValueError, match="k-major"):
        kernels._group_operands("q8g_matmul", w, torch.ones(1, 64), 4, 128,
                                w.device)


def _budget_tool():
    """``tools/k2lse_budget_torch.py``, loaded by its path (``tools`` is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        "_k2lse_budget", REPO / "tools" / "k2lse_budget_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _overshoot_rows(T=6, D=128):
    """One kv head whose key of largest norm is orthogonal to q (s = 0)
    while the others score 5 nats against a bound of 100: every row's
    bound overshoots its largest score by 95 nats."""
    scale = D ** -0.5
    q = np.zeros((1, T, 1, D), np.float32)
    q[..., 1] = 1.0 / scale  # |q| scale = 1
    k = np.zeros((1, T, 1, D), np.float32)
    k[0, 0, 0, 0] = 100.0
    k[0, 1:, 0, 1] = 5.0
    v = np.random.default_rng(13).normal(size=(1, T, 1, D)).astype(
        np.float32)
    return [torch.from_numpy(a) for a in (q, k, v)], scale


def test_f4_budget_counts_name_rows_past_the_flush_budget():
    """F4's instrument.  ``budget_counts`` (the twin's arithmetic) finds
    every row of a head whose bound overshoots its largest score by 95
    nats, past ex2.approx.ftz's 87.3 (the kernels flush such a row, as
    the TPU kernel's 85-nat budget does), and the live keys below 2^-126;
    the fp32 twin, whose torch.exp keeps subnormal p, keeps those rows
    alive with the exact softmax's output.  On random decoder inputs, as
    at training's stepped weights (largest gap 48 nats), it finds none."""
    tool = _budget_tool()
    (q, k, v), scale = _overshoot_rows()
    T = q.shape[1]
    mask = torch.ones((1, T), dtype=torch.int32)
    counts = tool.budget_counts(q, k, v, mask, scale)
    assert counts["gap_over_87"] == T and counts["pairs"] == T
    assert counts["flushed_keys"] == T * (T + 1) // 2
    assert 94.0 < counts["max_gap"] < 101.0
    out, lse = tfa.decoder_attention_plain(q, k, v, mask, return_lse=True)
    assert (lse < tfa.DEAD_LSE * 0.5).all()
    np.testing.assert_allclose(out[0, 1:].numpy(),
                               tfa.exact_attention_plain(q, k, v)[0, 1:]
                               .numpy(), rtol=0, atol=1e-3)
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 200, h, 128)).astype(
        np.float32)).to(torch.bfloat16) for h in (4, 2, 2))
    counts = tool.budget_counts(q, k, v, torch.ones((1, 200),
                                                    dtype=torch.int32),
                                128 ** -0.5)
    assert counts["gap_over_87"] == 0 and counts["flushed_keys"] == 0
    assert counts["pairs"] == 4 * 200 and counts["max_gap"] < 87.3
