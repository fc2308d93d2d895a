"""Dense products and GELU.

Counterpart of ``mjvideo_tpu/ops/matmul.py`` without the LoRA kernel.
Weights keep the JAX layout ``(in, out)`` and apply as ``x @ kernel``; a
plain kernel's product is ``torch.matmul``, which accumulates bf16 in fp32
as the JAX package's ``preferred_element_type`` does.  ``dot`` and
``dot_f32`` dispatch the quantized nodes of ``ops/quant.py`` and
``ops/quant4.py`` in the JAX package's order (``matmul.py:39-55``);
``impl`` ("auto" or "plain") selects their kernels or plain twins.
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
from .quant4 import Q4Kernel, dot_q4, dot_q4_f32


def dot(x: torch.Tensor, kernel, impl: str = "auto") -> torch.Tensor:
    """``x @ kernel`` in the promoted dtype, cast back to ``x.dtype``;
    ``kernel`` may be a tensor or a quantized node."""
    if isinstance(kernel, OutlierQuantKernel):
        return dot_q8_ol(x, kernel)
    if isinstance(kernel, QuantKernel):
        return dot_q8(x, kernel, impl)
    if isinstance(kernel, WOQuantKernel):
        return dot_wo(x, kernel)
    if isinstance(kernel, Q4Kernel):
        return dot_q4(x, kernel, impl)
    ct = torch.promote_types(x.dtype, kernel.dtype)
    return torch.matmul(x.to(ct), kernel.to(ct)).to(x.dtype)


def dot_f32(x: torch.Tensor, kernel, impl: str = "auto") -> torch.Tensor:
    """``x @ kernel`` with an fp32 result (no rounding to a narrower type);
    ``kernel`` may be a tensor or a quantized node.

    bf16 operands on the card multiply in bf16 with an fp32 output, as
    ``preferred_element_type=float32`` does, without an fp32 copy of the
    kernel (the LM head is 2048 x 92,553); elsewhere both go to fp32."""
    if isinstance(kernel, OutlierQuantKernel):
        return dot_q8_ol_f32(x, kernel)
    if isinstance(kernel, QuantKernel):
        return dot_q8_f32(x, kernel, impl)
    if isinstance(kernel, WOQuantKernel):
        return dot_wo_f32(x, kernel)
    if isinstance(kernel, Q4Kernel):
        return dot_q4_f32(x, kernel, impl)
    if x.is_cuda and x.dtype == kernel.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), kernel,
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], kernel.shape[-1])
    return torch.matmul(x.float(), kernel.float())


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU at every dtype, as the reference's ``nn.GELU()``."""
    return F.gelu(x)
