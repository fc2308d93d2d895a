"""K5 on Hopper, on the CPU: the k-major nibble layout, the twin at the
new kernel's edges, the route and the wrapper's refusal.

* The layout: ``quantize_kernel_q4`` (2-D and stacked) gives JAX's packed
  values and scales bit for bit in a k-major ``packed`` (a (K/2, N) view of
  an (N, K/2) contiguous tensor); ``dequantize_kernel_q4`` is JAX's; the
  bridge, a stacked node's slices, a ``torch.save`` round trip and
  ``quantize_params_int4`` keep the layout.
* The twin (``w4_matmul_plain``, what ``w4_matmul`` computes for a CPU
  tensor) on the k-major weight is bit-equal to the twin on the row-major
  one, and matches ``_w4_matmul_pallas(..., interpret=True)`` to TWIN_REL
  of max|pallas| (the bar of ``tests/test_torch_quant.py``: both round each
  dequantized weight once and sum in fp32, in another order), on fp32 and
  on bf16 inputs, at the kernel's edges: M on each side of its 8-row tiles
  up to 32; N at each Config's BN - 1, BN and BN + 1 and odd; g of 16,
  32, 64 and 128; K/2 not a whole number of 64-byte k-blocks, and K/2 of
  5 k-blocks (a cluster split that leaves a short last slice).
* ``dot_q4`` at 33 rows takes the dequantized halves on the k-major weight
  (never K5), equal to JAX's ``dot_q4``.
* The wrapper refuses a row-major packed weight before any launch; the
  source holds no atomics and the wrapper no memset.
"""

import inspect
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops import quant4 as jq4
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import matmul as tmm
from mjvideo_tpu_torch.ops import quant as tq
from mjvideo_tpu_torch.ops import quant4 as tq4
from mjvideo_tpu_torch.utils.bridge import from_jax_params, map_state

torch.set_num_threads(1)
TWIN_REL = 1e-5
SOURCE = (kernels.CSRC / "w4_matmul.cu").read_text()
# The production Configs' columns per CTA: M <= 16, and 17 <= M <= 32.
BN = int(re.search(r"using W4 = Config<(\d+),", SOURCE).group(1))
BN_WIDE = int(re.search(r"using W4Wide = Config<(\d+),", SOURCE).group(1))

# (M, K, N, g): the kernel's edges (see the module docstring).
K5_CASES = [
    (1, 256, BN - 1, 16), (2, 256, BN, 32), (3, 512, BN + 1, 64),
    (8, 640, 77, 64), (16, 672, 33, 16), (17, 1024, BN_WIDE + 1, 128),
    (32, 512, BN_WIDE - 1, 32), (32, 2048, 3, 128),
]


def _close(got, ref, rel=TWIN_REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _k_major(t: torch.Tensor) -> bool:
    K2, N = t.shape[-2:]
    return t.stride(-2) == 1 and t.stride(-1) == K2


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("group_size", [16, 64, 128])
def test_quantize_kernel_q4_is_k_major_and_bit_equal_to_jax(stacked,
                                                            group_size):
    rng = np.random.default_rng(21)
    shape = (3, 256, 72) if stacked else (256, 72)
    w = rng.normal(size=shape).astype(np.float32)
    ref = jq4.quantize_kernel_q4(jnp.asarray(w), group_size=group_size)
    got = tq4.quantize_kernel_q4(torch.from_numpy(w), group_size=group_size)
    assert got.packed.dtype == torch.int8
    assert got.packed.shape == shape[:-2] + (128, 72) and _k_major(got.packed)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(
        got.scale.float().numpy(), np.asarray(ref.scale.astype(jnp.float32)))
    _close(tq4.dequantize_kernel_q4(got), jq4.dequantize_kernel_q4(ref), 0)
    if stacked:
        for i in range(3):
            assert tq.is_k_major(got.packed[i])


def test_bridge_slices_checkpoints_and_quantize_params_keep_the_layout():
    """JAX's Q4Kernel through ``from_jax_params``, a stacked node's slices
    by ``map_state``, a ``torch.save`` round trip and
    ``quantize_params_int4``: each packed weight stays a k-major view with
    JAX's values."""
    rng = np.random.default_rng(22)
    w = (rng.normal(size=(2, 256, 48)) * 0.05).astype(np.float32)
    tree = {"layers": {"w1": {"kernel": jq4.quantize_kernel_q4(
        jnp.asarray(w), group_size=32)}},
        "head": {"kernel": jq4.quantize_kernel_q4(jnp.asarray(w[0]),
                                                  group_size=64)}}
    state = from_jax_params(tree, device="cpu")
    node = state["layers"]["w1"]["kernel"]
    assert isinstance(node, tq4.Q4Kernel)
    assert node.packed.stride() == (128 * 48, 1, 128)
    np.testing.assert_array_equal(
        node.packed.numpy(), np.asarray(tree["layers"]["w1"]["kernel"].packed))
    one = map_state(lambda a: a[1], state["layers"])["w1"]["kernel"]
    assert tq.is_k_major(one.packed)
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    back = torch.load(buf, weights_only=False)
    assert back["layers"]["w1"]["kernel"].packed.stride() == \
        node.packed.stride()
    head = back["head"]["kernel"].packed
    assert tq.is_k_major(head) and head.t().is_contiguous()
    np.testing.assert_array_equal(
        head.numpy(), np.asarray(tree["head"]["kernel"].packed))
    params = {"mlp": {"kernel": torch.from_numpy(w)}}
    q = tq4.quantize_params_int4(params, exclude=[], min_elements=1,
                                 group_size=64, device="cpu")
    k4 = q["mlp"]["kernel"]
    assert isinstance(k4, tq4.Q4Kernel) and _k_major(k4.packed)
    np.testing.assert_array_equal(
        k4.packed.numpy(),
        np.asarray(jq4.quantize_kernel_q4(jnp.asarray(w), 64).packed))


@pytest.mark.parametrize("M,K,N,g", K5_CASES)
def test_k5_twin_on_the_k_major_weight_matches_pallas(M, K, N, g):
    """fp32 inputs: the twin on the k-major weight equals the twin on the
    row-major one to the bit and ``_w4_matmul_pallas`` to TWIN_REL; so does
    ``dot_f32``, K5's route for a CPU tensor."""
    rng = np.random.default_rng(M * K + N + g)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jk = jq4.quantize_kernel_q4(jnp.asarray(w), group_size=g)
    ref = jq4._w4_matmul_pallas(jnp.asarray(x), jk.packed, jk.scale,
                                block_n=N, interpret=True)
    tk = tq4.quantize_kernel_q4(torch.from_numpy(w), group_size=g)
    assert _k_major(tk.packed)
    tx = torch.from_numpy(x)
    got = tq4.w4_matmul(tx, tk.packed, tk.scale)
    assert torch.equal(got, tq4.w4_matmul_plain(tx, tk.packed.contiguous(),
                                                tk.scale))
    _close(got, ref)
    _close(tmm.dot_f32(tx, tk), ref)


@pytest.mark.parametrize("M,K,N,g", [(2, 256, BN + 1, 16), (17, 640, 77, 64),
                                     (32, 1024, BN - 1, 128)])
def test_k5_twin_on_bf16_inputs_matches_pallas(M, K, N, g):
    """bf16 x: both round each dequantized weight to bf16 before the
    fp32-accumulated product (as ``test_k5_twin_matches_pallas``)."""
    rng = np.random.default_rng(M + K + N)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jk = jq4.quantize_kernel_q4(jnp.asarray(w), group_size=g)
    ref = jq4._w4_matmul_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                                jk.packed, jk.scale, block_n=N,
                                interpret=True)
    tk = from_jax_params({"k": jk}, device="cpu")["k"]
    assert _k_major(tk.packed)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = tq4.w4_matmul(tx, tk.packed, tk.scale)
    assert torch.equal(got, tq4.w4_matmul_plain(tx, tk.packed.contiguous(),
                                                tk.scale))
    _close(got, ref)


def test_dot_q4_over_32_rows_takes_the_halves_on_the_k_major_weight(
        monkeypatch):
    rng = np.random.default_rng(23)
    w = (rng.normal(size=(256, 96)) * 0.05).astype(np.float32)
    x = rng.normal(size=(3, 11, 256)).astype(np.float32)  # 33 rows
    jk = jq4.quantize_kernel_q4(jnp.asarray(w), group_size=32)
    ref = jq4.dot_q4(jnp.asarray(x), jk)
    tk = tq4.quantize_kernel_q4(torch.from_numpy(w), group_size=32)
    assert _k_major(tk.packed)

    def no_k5(*args):
        raise AssertionError("33 rows reached K5")

    monkeypatch.setattr(tq4, "w4_matmul", no_k5)
    monkeypatch.setattr(tq4, "w4_matmul_plain", no_k5)
    got = tmm.dot(torch.from_numpy(x), tk)
    _close(got, ref)
    # The halves keep the weight's layout: the same values as row-major.
    lo, hi = tq4._deq_halves(tk, torch.float32)
    assert _k_major(lo) and _k_major(hi)
    rm = tq4.Q4Kernel(packed=tk.packed.contiguous(), scale=tk.scale)
    for a, b in zip((lo, hi), tq4._deq_halves(rm, torch.float32)):
        assert torch.equal(a, b)


def test_k5_wrapper_refuses_a_packed_weight_that_is_not_k_major():
    """A row-major packed weight would need a transposed copy per call: the
    wrapper refuses it before any launch (its checks run before the CUDA
    ones, so a CPU tensor shows the order)."""
    x = torch.zeros((2, 256), dtype=torch.bfloat16)
    packed = torch.zeros((128, 64), dtype=torch.int8)
    scale = torch.ones((2, 64), dtype=torch.bfloat16)
    assert not tq.is_k_major(packed) and tq.is_k_major(tq.k_major(packed))
    before = kernels.launch_counts["w4_matmul"]
    with pytest.raises(ValueError, match="k-major"):
        kernels._w4_operands("w4_matmul", x, packed, scale)
    with pytest.raises(ValueError, match="k-major"):
        kernels.w4_matmul(x, packed, scale)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels._w4_operands("w4_matmul", x, tq.k_major(packed), scale)
    assert kernels.launch_counts["w4_matmul"] == before


def test_k5_source_has_no_atomics_and_the_wrapper_no_memset():
    assert "atomicAdd" not in SOURCE and "atomic" not in SOURCE
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in SOURCE
    assert "map_shared_rank" in SOURCE and "cluster.sync()" in SOURCE
    wrapper = inspect.getsource(kernels.w4_matmul)
    assert "torch.zeros" not in wrapper and "torch.empty" in wrapper
    assert "zero_" not in wrapper and "fill_" not in wrapper
    assert "mjv_w4_plan" in kernels.ARGTYPES
