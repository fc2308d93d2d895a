"""Dense products and GELU.

Counterpart of ``mjvideo_tpu/ops/matmul.py`` without the quantized and LoRA
kernels.  Weights keep the JAX layout ``(in, out)`` and apply as
``x @ kernel``; the products are plain ``torch.matmul``, which accumulates
bf16 in fp32 as the JAX package's ``preferred_element_type`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dot(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x @ kernel`` in the promoted dtype, cast back to ``x.dtype``."""
    ct = torch.promote_types(x.dtype, kernel.dtype)
    return torch.matmul(x.to(ct), kernel.to(ct)).to(x.dtype)


def dot_f32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x @ kernel`` with an fp32 result (no rounding to a narrower type).

    bf16 operands on the card multiply in bf16 with an fp32 output, as
    ``preferred_element_type=float32`` does, without an fp32 copy of the
    kernel (the LM head is 2048 x 92,553); elsewhere both go to fp32."""
    if x.is_cuda and x.dtype == kernel.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), kernel,
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], kernel.shape[-1])
    return torch.matmul(x.float(), kernel.float())


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU at every dtype, as the reference's ``nn.GELU()``."""
    return F.gelu(x)
