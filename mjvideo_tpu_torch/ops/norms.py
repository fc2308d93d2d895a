"""RMSNorm and LayerNorm with fp32 statistics.

Counterpart of ``mjvideo_tpu/ops/norms.py``.  Plain tensor code: the
elementwise chains are memory-bound and left to PyTorch for now.  The cast
order is the reference's and the JAX package's: statistics in fp32,
``rms_norm`` scales the input-dtype value by ``weight``, ``layer_norm`` runs
its affine step in fp32.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``weight * normalize(x).to(x.dtype)``, normalized in fp32."""
    input_dtype = x.dtype
    xf = x.float()
    variance = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(variance + eps)
    return (weight * xf.to(input_dtype)).to(input_dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with fp32 statistics and an fp32 affine step."""
    input_dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(input_dtype)
