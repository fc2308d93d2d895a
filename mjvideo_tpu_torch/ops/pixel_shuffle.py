"""Pixel-shuffle (space-to-channel) downsampling.

Counterpart of ``mjvideo_tpu/ops/pixel_shuffle.py`` (reference
``InternVLChatModel.pixel_shuffle``, ``modeling_internvl_chat.py:228-242``).
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, scale_factor: float = 0.5,
                  ps_version: str = "v2") -> torch.Tensor:
    """x: (N, W, H, C) -> (N, W*s, H*s, C/s^2).

    The reference calls axis 1 W and axis 2 H; 'v1' omits the final
    swap-back, 'v2' applies it.
    """
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale_factor), int(c / scale_factor))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(n, int(h * scale_factor), int(w * scale_factor),
                  int(c / (scale_factor**2)))
    if ps_version != "v1":
        x = x.permute(0, 2, 1, 3)
    return x
