"""Dense products and GELU.

Counterpart of ``mjvideo_tpu/ops/matmul.py``.  Weights keep the JAX layout
``(in, out)`` and apply as ``x @ kernel``; a plain kernel's product is
``torch.matmul``, which accumulates bf16 in fp32 as the JAX package's
``preferred_element_type`` does.  ``dot`` and ``dot_f32`` dispatch the
quantized nodes of ``ops/quant.py`` and ``ops/quant4.py`` and the LoRA node
of ``ops/lora.py`` in the JAX package's order (``matmul.py:39-55``:
outlier, w8a8, weight-only int8, LoRA, int4); a LoRA node's base recurses
through them, so QLoRA works.  ``impl`` ("auto" or "plain") selects the
kernels or their plain twins.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant import (
    OutlierQuantKernel,
    QuantKernel,
    WOQuantKernel,
    dot_q8,
    dot_q8_f32,
    dot_q8_ol,
    dot_q8_ol_f32,
    dot_wo,
    dot_wo_f32,
)
from .lora import LoraKernel, dot_lora, dot_lora_f32
from .quant4 import Q4Kernel, dot_q4, dot_q4_f32


class _ProductF32(torch.autograd.Function):
    """bf16 (M, K) @ bf16 (K, N) -> fp32 (M, N) on the card: ``torch.mm``
    with ``out_dtype``, whose derivative autograd lacks.  The backward is
    a bf16 product's: the fp32 gradient rounded to bf16, each input's
    gradient a bf16 product (fp32 accumulation) at the input's dtype, as
    JAX's transpose of the product rounds it on a TPU at default
    precision."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = x.t() @ g if ctx.needs_input_grad[1] else None
        return gx, gw


def product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w 2-D) accumulated and returned in fp32, differentiable:
    JAX's ``preferred_element_type=float32``.  bf16 operands on the card
    multiply in bf16 with an fp32 output, without an fp32 copy of either
    (through ``_ProductF32`` only where autograd records the product);
    elsewhere both go to fp32 (bf16 values are exact in fp32)."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _ProductF32.apply(x2, w)
        else:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def dot(x: torch.Tensor, kernel, impl: str = "auto") -> torch.Tensor:
    """``x @ kernel`` in the promoted dtype, cast back to ``x.dtype``;
    ``kernel`` may be a tensor, a quantized node or a LoRA node."""
    if isinstance(kernel, OutlierQuantKernel):
        return dot_q8_ol(x, kernel)
    if isinstance(kernel, QuantKernel):
        return dot_q8(x, kernel, impl)
    if isinstance(kernel, WOQuantKernel):
        return dot_wo(x, kernel)
    if isinstance(kernel, LoraKernel):
        return dot_lora(x, kernel, impl)
    if isinstance(kernel, Q4Kernel):
        return dot_q4(x, kernel, impl)
    ct = torch.promote_types(x.dtype, kernel.dtype)
    return torch.matmul(x.to(ct), kernel.to(ct)).to(x.dtype)


def dot_f32(x: torch.Tensor, kernel, impl: str = "auto") -> torch.Tensor:
    """``x @ kernel`` with an fp32 result (no rounding to a narrower type);
    ``kernel`` may be a tensor, a quantized node or a LoRA node.  A plain
    kernel's product is ``product_f32``: on the card bf16 operands give an
    fp32 output without an fp32 copy of the kernel (the LM head is 2048 x
    92,553)."""
    if isinstance(kernel, OutlierQuantKernel):
        return dot_q8_ol_f32(x, kernel)
    if isinstance(kernel, QuantKernel):
        return dot_q8_f32(x, kernel, impl)
    if isinstance(kernel, WOQuantKernel):
        return dot_wo_f32(x, kernel)
    if isinstance(kernel, LoraKernel):
        return dot_lora_f32(x, kernel, impl)
    if isinstance(kernel, Q4Kernel):
        return dot_q4_f32(x, kernel, impl)
    return product_f32(x, kernel)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU at every dtype, as the reference's ``nn.GELU()``."""
    return F.gelu(x)
