"""The port's clip preprocessing on the device (``ops/preprocess.py``)
against the JAX package's, and against the port's PIL host path.

Frames are uint8 made from numpy seeds; everything runs on the CPU.  The
resample matrices are bit-equal.  With ``quantize=True`` the port (float64
products) and JAX (float32 at HIGHEST) round each pass to whole levels;
their sums differ in order and precision, so a value lying within about
1e-4 of a half level may land one level apart: the bar is 1 level, and the
share of values that differ is held below 1e-3 (the readings are
1.6e-5 to 4e-5).  Without quantization the two agree to rtol 1e-5 (atol
1e-5 of a level).  The normalised outputs are held to one level over the
ImageNet std, 1 / (255 * 0.224), elementwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops import preprocess as jpre
from mjvideo_tpu_torch.data.video import IMAGENET_STD, _pil_resize, normalize
from mjvideo_tpu_torch.data.video import tile_frame as host_tile_frame
from mjvideo_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)
# One level of 0..255 after the ImageNet normalisation, at the smallest std.
LEVEL = 1.0 / (255.0 * float(IMAGENET_STD.min()))
# (H, W) -> (out_h, out_w): down-scales, up-scales, mixed, and identity.
RESIZES = (((250, 460), (112, 112)), ((100, 80), (112, 112)),
           ((72, 128), (56, 56)), ((30, 40), (56, 56)), ((56, 56), (56, 56)),
           ((90, 160), (112, 224)))


def _frames(h, w, n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("in_size,out_size",
                         [(720, 448), (1280, 1792), (100, 448), (448, 448),
                          (57, 56)])
def test_resize_matrix_bit_equal(in_size, out_size):
    got = tpre.resize_matrix(in_size, out_size)
    want = jpre.resize_matrix(in_size, out_size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_quantized_within_one_level_of_jax(src, dst):
    f = _frames(*src)
    want = np.asarray(jpre.resize_bicubic_device(jnp.asarray(f), *dst))
    got = tpre.resize_bicubic_device(torch.from_numpy(f), *dst)
    assert got.dtype == torch.float32 and got.shape == (2, *dst, 3)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.round(got))
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_smooth_matches_jax(src, dst):
    f = _frames(*src, seed=1)
    want = np.asarray(jpre.resize_bicubic_device(jnp.asarray(f), *dst,
                                                 quantize=False))
    got = tpre.resize_bicubic_device(torch.from_numpy(f), *dst,
                                     quantize=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_preprocess_frames_matches_jax():
    f = _frames(72, 128, n=3, seed=2)
    want = np.asarray(jpre.preprocess_frames_device(jnp.asarray(f), 56,
                                                    dtype=jnp.float32))
    got = tpre.preprocess_frames_device(torch.from_numpy(f), 56,
                                        dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (3, 56, 56, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LEVEL * 1.001)
    bf16 = tpre.preprocess_frames_device(torch.from_numpy(f), 56)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("thumbnail", [True, False])
@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (3, 2)])
def test_tile_frames_matches_jax(grid, thumbnail):
    cols, rows = grid
    f = _frames(50 * rows, 60 * cols, seed=3)
    want = np.asarray(jpre.tile_frames_device(
        jnp.asarray(f), cols, rows, image_size=28, thumbnail=thumbnail,
        dtype=jnp.float32))
    got = tpre.tile_frames_device(torch.from_numpy(f), cols, rows,
                                  image_size=28, thumbnail=thumbnail,
                                  dtype=torch.float32)
    per_frame = cols * rows + (thumbnail and cols * rows > 1)
    assert got.shape == want.shape == (2 * per_frame, 28, 28, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LEVEL * 1.001)


@pytest.mark.parametrize("size,max_num", [((96, 160), 2), ((64, 64), 1),
                                          ((60, 200), 6)])
def test_device_tiling_within_one_level_of_pil(size, max_num):
    """The device path against the port's PIL host path
    (``data.video.tile_frame``), in levels before the normalisation."""
    from mjvideo_tpu_torch.data.video import select_tile_grid

    h, w = size
    f = _frames(h, w, n=1, seed=4)
    S = 48
    cols, rows = select_tile_grid(w, h, 1, max_num, S)
    host = host_tile_frame(f[0], max_num=max_num, image_size=S,
                           use_thumbnail=True).astype(np.float32)
    big = tpre.resize_bicubic_device(torch.from_numpy(f), rows * S, cols * S)
    tiles = (big.reshape(1, rows, S, cols, S, 3).permute(0, 1, 3, 2, 4, 5)
             .reshape(rows * cols, S, S, 3))
    if rows * cols > 1:
        tiles = torch.cat([tiles, tpre.resize_bicubic_device(
            torch.from_numpy(f), S, S)])
    assert tiles.shape == host.shape
    assert np.abs(tiles.numpy() - host).max() <= 1.0
    # And the whole path, normalised: within a level of the host's.
    got = tpre.tile_frames_device(torch.from_numpy(f), cols, rows, S,
                                  dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, normalize(host), rtol=0,
                               atol=LEVEL * 1.001)


def test_resize_of_pil_identity_is_exact():
    f = _frames(56, 56, n=1, seed=5)
    got = tpre.resize_bicubic_device(torch.from_numpy(f), 56, 56).numpy()
    np.testing.assert_array_equal(got[0], _pil_resize(f[0], (56, 56)))
    np.testing.assert_array_equal(got[0], f[0])
