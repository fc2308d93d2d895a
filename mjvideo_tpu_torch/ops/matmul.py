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
    """``x @ kernel`` with an fp32 result (no rounding to a narrower type)."""
    return torch.matmul(x.float(), kernel.float())


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU at every dtype, as the reference's ``nn.GELU()``."""
    return F.gelu(x)
