"""int4 weight-only quantization with group scales (the ``int4-wo`` mode).

Counterpart of ``mjvideo_tpu/ops/quant4.py``.  Storage is the half-split
nibble pack of a kernel w (..., K, N):

    packed (..., K/2, N) int8: low nibble of packed[k] = w[k],
                               high nibble = w[K/2 + k], both biased by 8
    scale  (..., K/g, N) bf16: one per g rows of each column

so ``x @ w == x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi)`` with no
interleave.  A product of 32 rows or fewer (decode steps, the LM head on
the last rows) is the hand-written K5 on the card (``w4_matmul``,
``csrc/w4_matmul.cu``); a larger one dequantizes the halves at x's dtype
and runs two products, as the JAX package's XLA path does.  Either way
each weight is dequantized in fp32 and rounded to x's dtype before an
fp32-accumulated product.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from .. import kernels
from .quant import (
    _EXCLUDE_DEFAULT,
    _kernel_leaf_eligible,
    _quantize_stacked,
    div,
    map_with_path,
)

# The largest product K5 serves (``quant4.py:153``).
W4_KERNEL_ROWS = 32


@dataclass
class Q4Kernel:
    """Half-split packed int4 kernel ``packed`` (..., K/2, N) int8 and
    group scales ``scale`` (..., K/g, N); g = 2 * packed rows / scale
    rows."""

    packed: torch.Tensor
    scale: torch.Tensor


def _group_size(k4: Q4Kernel) -> int:
    return 2 * k4.packed.shape[-2] // k4.scale.shape[-2]


def _quantize_q4_2d(w: torch.Tensor, g: int, scale_dtype):
    K, N = w.shape
    grouped = w.float().reshape(K // g, g, N)
    scale = div(grouped.abs().amax(-2, keepdim=True), 7.0).clamp_min(1e-10)
    # Biased nibbles in uint8: every value in [0, 15], the shifted OR too.
    q = (torch.round(grouped / scale) + 8.0).clamp(0, 15).to(torch.uint8)
    q = q.reshape(K, N)
    packed = (q[: K // 2] | (q[K // 2:] << 4)).view(torch.int8)
    return packed, scale.reshape(K // g, N).to(scale_dtype)


def quantize_kernel_q4(w: torch.Tensor, group_size: int = 128,
                       scale_dtype: torch.dtype = torch.bfloat16) -> Q4Kernel:
    """Symmetric group-wise int4 of (..., K, N) with K % (2 * group_size)
    == 0: scale = max(group amax / 7, 1e-10) in fp32, nibble = clip(
    round(w / scale) + 8, 0, 15), scales stored at ``scale_dtype``."""
    assert w.shape[-2] % (2 * group_size) == 0, (w.shape, group_size)
    packed, scale = _quantize_stacked(
        w, lambda s: _quantize_q4_2d(s, group_size, scale_dtype))
    return Q4Kernel(packed=packed, scale=scale)


def _unpack_nibbles(packed: torch.Tensor):
    """packed int8 -> (lo, hi) int32 values in [-8, 7]."""
    b = packed.to(torch.int32) & 0xFF
    return (b & 0xF) - 8, ((b >> 4) & 0xF) - 8


def _deq_halves(k4: Q4Kernel, dtype: torch.dtype):
    """Both nibble planes dequantized to (..., K/2, N) tensors of
    ``dtype``: (nibble * scale) in fp32, then rounded."""
    g = _group_size(k4)
    lo, hi = _unpack_nibbles(k4.packed)
    K2, n = k4.packed.shape[-2:]
    lead = k4.packed.shape[:-2]
    s = k4.scale.float()

    def deq(vals, sc):
        v = vals.reshape(*lead, K2 // g, g, n).float()
        return (v * sc[..., :, None, :]).reshape(*lead, K2, n).to(dtype)

    return deq(lo, s[..., : K2 // g, :]), deq(hi, s[..., K2 // g:, :])


def dequantize_kernel_q4(k4: Q4Kernel,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w_lo, w_hi = _deq_halves(k4, dtype)
    return torch.cat([w_lo, w_hi], dim=-2)


def _halves_product(x: torch.Tensor, k4: Q4Kernel) -> torch.Tensor:
    """x @ dequant(k4) through the two dequantized halves, fp32 result."""
    from .matmul import dot_f32

    K2 = k4.packed.shape[-2]
    w_lo, w_hi = _deq_halves(k4, x.dtype)
    return dot_f32(x[..., :K2], w_lo) + dot_f32(x[..., K2:], w_hi)


def w4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """K5's twin: x (M, K) times the packed kernel, (M, N) fp32."""
    return _halves_product(x, Q4Kernel(packed=packed, scale=scale))


def w4_matmul(x: torch.Tensor, packed: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """K5: the twin for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return w4_matmul_plain(x, packed, scale)
    return kernels.w4_matmul(x, packed, scale)


def dot_q4_f32(x: torch.Tensor, kernel: Q4Kernel,
               impl: str = "auto") -> torch.Tensor:
    """x @ dequant(kernel) with an fp32 result: K5 (or its twin) for 32
    rows or fewer, the dequantized halves otherwise."""
    assert kernel.packed.dim() == 2, (
        f"dot_q4 expects a per-layer kernel, got {kernel.packed.shape}")
    rows = x.numel() // x.shape[-1]
    if rows > W4_KERNEL_ROWS:
        return _halves_product(x, kernel)
    x2 = x.reshape(rows, x.shape[-1]).contiguous()
    fn = w4_matmul_plain if impl == "plain" else w4_matmul
    out = fn(x2, kernel.packed, kernel.scale)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def dot_q4(x: torch.Tensor, kernel: Q4Kernel,
           impl: str = "auto") -> torch.Tensor:
    return dot_q4_f32(x, kernel, impl).to(x.dtype)


def quantize_params_int4(
    params: Any,
    exclude: Optional[Sequence[str]] = None,
    min_elements: int = 1 << 16,
    group_size: int = 128,
    device: Any = None,
) -> Any:
    """Replace every large dense ``.../kernel`` leaf with a Q4Kernel, by
    the int8 walk's selection policy (``exclude=None``: its default list).
    A leaf whose K is not divisible by 2 * group_size gets the group halved
    until it is (floor 16), else stays full precision.  ``device`` as in
    ``quantize_params_int8``."""
    exc = [re.compile(p) for p in
           (_EXCLUDE_DEFAULT if exclude is None else exclude)]

    def one(path, leaf):
        if device is not None and isinstance(leaf, torch.Tensor):
            leaf = leaf.to(device)
        if not _kernel_leaf_eligible(path, leaf, exc, min_elements):
            return leaf
        K = leaf.shape[-2]
        g = group_size
        while g >= 16 and K % (2 * g):
            g //= 2
        if g < 16:
            return leaf
        return quantize_kernel_q4(leaf, group_size=g)

    return map_with_path(one, params)
