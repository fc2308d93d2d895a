"""Rotary position embeddings with linear / dynamic-NTK scaling.

Counterpart of ``mjvideo_tpu/ops/rope.py`` (reference
``modeling_internlm2.py:147-247``).  Tables are built in fp32 from the padded
sequence length and cast to the activation dtype just before the rotation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_tables(
    seq_len: int,
    head_dim: int,
    base: float = 10000.0,
    scaling_type: Optional[str] = None,
    scaling_factor: float = 1.0,
    max_position_embeddings: int = 2048,
    *,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (seq_len, head_dim) fp32 on ``device``."""
    if scaling_type == "dynamic" and seq_len > max_position_embeddings:
        base = base * (
            (scaling_factor * seq_len / max_position_embeddings)
            - (scaling_factor - 1)
        ) ** (head_dim / (head_dim - 2))
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (base ** exponent)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    if scaling_type == "linear":
        t = t / scaling_factor
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(-x2, x1), as in ``modeling_internlm2.py:233-237``."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q, k of shape (B, S, H, D) at positions 0..S-1."""
    seq = q.shape[-3]
    c = cos[:seq][None, :, None, :].to(q.dtype)
    s = sin[:seq][None, :, None, :].to(q.dtype)
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s
