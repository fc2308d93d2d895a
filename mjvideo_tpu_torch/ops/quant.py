"""The int8 KV cache's quantizer.

Counterpart of ``quantize_kv`` / ``dequantize_kv`` in
``mjvideo_tpu/ops/quant.py:508-530``; the quantized weight kernels of that
module (K5-K7) wait for ROADMAP item 11.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(slot, head) symmetric int8: one scale per head vector (the last
    axis).  Returns ``(q int8 (..., H, D), scale fp32 (..., H))`` with
    ``q * scale[..., None] ~= x``; ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    x32 = x.float()
    scale = (x32.abs().amax(-1) / 127.0).clamp_min(1e-12)
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`."""
    return (q.float() * scale[..., None]).to(dtype)
