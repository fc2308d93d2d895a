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
    """(cos, sin), each (seq_len, head_dim) fp32 on ``device``.

    ``scaling_type`` None, ``"linear"`` or ``"dynamic"``; any other raises,
    since silently taking it as None would give other tables than the
    checkpoint was trained with (Phi-3's long-context ``su`` / ``longrope``
    rescales the frequencies and the amplitude at every position)."""
    if scaling_type not in (None, "linear", "dynamic"):
        raise ValueError(
            f"RoPE scaling {scaling_type!r} is not computed by the port "
            "(None, 'linear' or 'dynamic')")
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
               sin: torch.Tensor, position_ids: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q, k of shape (B, S, H, D) (``rope.py:62-90``).

    ``cos``/``sin``: (max_seq, D) tables, read at positions 0..S-1, or
    gathered at ``position_ids`` (B, S) (the cached layer rotates each new
    token by its cache slot); or pre-gathered per-token values (B, S, D)."""
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    elif position_ids is None:
        seq = q.shape[-3]
        c, s = cos[:seq][None, :, None, :], sin[:seq][None, :, None, :]
    else:
        c = cos[position_ids][:, :, None, :]
        s = sin[position_ids][:, :, None, :]
    c, s = c.to(q.dtype), s.to(q.dtype)
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s
