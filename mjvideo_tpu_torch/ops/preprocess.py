"""Clip preprocessing on the scorer's device: bicubic resize, tiling and
ImageNet normalisation of decoded uint8 frames.

Counterpart of ``mjvideo_tpu/ops/preprocess.py``.  The host ships decoded
frames as uint8 at their own resolution; the resize, the crop into tiles,
the thumbnail and the normalisation run where the scorer's state lies.
Separable antialiased bicubic resampling is linear, so it is two matrix
products, ``R_h @ img @ R_w^T`` per channel, with the resample matrices
built from PIL's coefficient windows on the host (``resize_matrix``; the
tile grid is chosen on the host too, ``data.video.select_tile_grid``).

The two products run in float64: the result must not depend on the
caller's TF32 setting (``torch.backends.cuda.matmul.allow_tf32``), whose
10-bit products would move a value lying near a half level to the other
side of it.  An H100 runs float64 products on its tensor cores at the
float32 rate.  With ``quantize=True`` each product is rounded half to even
and clamped to 0..255, as PIL's 8-bit path rounds between its passes, so
the result lies within one level of PIL's and of the JAX package's
(``jnp.round`` also rounds half to even; the sums differ in order).  Then
the ImageNet normalisation in float32, and the cast to the scorer's dtype
last.  The JAX package computes the products with ``jnp.einsum(...,
precision=HIGHEST)`` outside any Pallas kernel (``preprocess.py:80-85``),
so they are ``torch.matmul`` here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.video import IMAGENET_MEAN, IMAGENET_STD


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) PIL-window antialiased bicubic resample matrix."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = 2.0 * fs
    R = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        xs = np.arange(xmin, xmax)
        w = _bicubic((xs - center + 0.5) / fs)
        s = w.sum()
        if s != 0:
            w = w / s
        R[o, xmin:xmax] = w
    return R


def _resample(x: torch.Tensor, R: np.ndarray, quantize: bool) -> torch.Tensor:
    """``R`` (out, in) applied to the leading axis of ``x`` (in, ...) as one
    float64 product over every other axis."""
    rows = torch.from_numpy(R).to(x.device, torch.float64)
    y = rows @ x.reshape(x.shape[0], -1)
    if quantize:
        y = y.round().clamp_(0.0, 255.0)
    return y.reshape((R.shape[0],) + x.shape[1:])


def resize_bicubic_device(frames: torch.Tensor, out_h: int, out_w: int,
                          quantize: bool = True) -> torch.Tensor:
    """(N, H, W, C) uint8 or float frames -> (N, out_h, out_w, C) float32
    on 0..255, on the frames' device.

    The horizontal pass first, as PIL resizes; ``quantize=True`` rounds
    and clamps after each pass (PIL's 8-bit path), ``quantize=False`` is
    the smooth variant."""
    N, H, W, C = frames.shape
    x = frames.to(torch.float64).permute(2, 0, 1, 3)           # (W, N, H, C)
    x = _resample(x, resize_matrix(W, out_w), quantize)        # (P, N, H, C)
    x = x.permute(2, 1, 0, 3)                                  # (H, N, P, C)
    x = _resample(x, resize_matrix(H, out_h), quantize)        # (O, N, P, C)
    return x.permute(1, 0, 2, 3).to(torch.float32)


def _normalize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 0..255 -> ImageNet-normalised ``dtype``, by the JAX package's
    operations in fp32 (each a division by a tensor: CUDA divides by a
    Python number through its reciprocal)."""
    dev = x.device
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(IMAGENET_STD).to(dev)
    scale = torch.tensor(255.0, dtype=torch.float32, device=dev)
    return ((x / scale - mean) / std).to(dtype)


def preprocess_frames_device(frames: torch.Tensor, out_size: int = 448,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames -> normalised (N, S, S, 3) in ``dtype``:
    one tile a frame, the reward-scoring default (``max_num=1``)."""
    return _normalize(resize_bicubic_device(frames, out_size, out_size),
                      dtype)


def tile_frames_device(frames: torch.Tensor, cols: int, rows: int,
                       image_size: int = 448, thumbnail: bool = True,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``dynamic_preprocess`` for a grid (cols, rows) chosen on the host:
    resize to (rows*S, cols*S), crop the tiles row-major, append the
    thumbnail where there is more than one tile, normalise.  Returns
    (N * (cols*rows [+1]), S, S, 3) in ``dtype``."""
    N, S = frames.shape[0], image_size
    big = resize_bicubic_device(frames, rows * S, cols * S)
    tiles = (big.reshape(N, rows, S, cols, S, 3).permute(0, 1, 3, 2, 4, 5)
             .reshape(N, rows * cols, S, S, 3))
    if thumbnail and rows * cols > 1:
        thumb = resize_bicubic_device(frames, S, S)
        tiles = torch.cat([tiles, thumb[:, None]], dim=1)
    return _normalize(tiles, dtype).reshape((-1, S, S, 3))
