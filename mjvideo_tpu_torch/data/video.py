"""Host-side video decoding for the judge: the port's own copy of
``load_video`` and its helpers from ``mjvideo_tpu/data/video.py``.

Replaces the reference's decord/PIL/torchvision pipeline
(``scripts/data_processor/data.py``): frame sampling (``get_index``,
``data.py:127-137``), dynamic aspect-ratio tiling
(``find_closest_aspect_ratio`` ``data.py:66-79``, ``dynamic_preprocess``
``data.py:81-117``), PIL bicubic resize and ImageNet normalization
(``build_transform`` ``data.py:56-64``) and video decode (``load_video``
``data.py:158-179``), with cv2 in place of decord; ``load_image`` and the
remote fetches with their local cache (``fetch_remote_video``,
``fetch_s3_video``, ``prefetch_videos``).  The JAX package's optional
native C++ resize branch is not ported: it is bit-exact with the PIL path
kept here, and the serving fast path resizes on the device instead
(``ops/preprocess.py``).  Output is NHWC fp32.  PIL, cv2, requests and
huggingface_hub are imported inside the functions that use them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
# OpenAI-CLIP statistics (Qwen2-VL's preprocessing, models/qwen2vl.py).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

def get_frame_indices(
    num_frames: int,
    num_segments: int,
    bound: Optional[Tuple[float, float]] = None,
    fps: float = 30.0,
    first_idx: int = 0,
) -> np.ndarray:
    """Uniform frame sampling; exact ``get_index`` (``data.py:127-137``).

    Note the reference passes ``max_frame = len(vr) - 1`` as the linspace
    stop, with ``endpoint=False``.
    """
    if bound is None:
        return np.linspace(
            first_idx, num_frames - 1, num_segments, endpoint=False, dtype=int
        )
    # Clamp the window to the clip: a negative start (bound[0] < 0) or an
    # end past the last frame would otherwise produce out-of-range indices
    # that decode_frames silently substitutes with its LAST decoded frame
    # — scores computed on the wrong frames with no error.
    start_frame = max(int(bound[0] * fps), first_idx)
    end_frame = min(int(bound[1] * fps), num_frames - 1)
    end_frame = max(end_frame, start_frame)
    return np.linspace(
        start_frame, end_frame, num_segments, endpoint=False, dtype=int
    )


def find_closest_aspect_ratio(
    aspect_ratio: float,
    target_ratios: Sequence[Tuple[int, int]],
    width: int,
    height: int,
    image_size: int,
) -> Tuple[int, int]:
    """Pick the (cols, rows) grid closest in aspect ratio (``data.py:66-79``).

    Ties break toward the larger grid when the source image has more area
    than half the tiled target.
    """
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def candidate_grids(min_num: int, max_num: int) -> List[Tuple[int, int]]:
    """All (cols, rows) with min_num <= cols*rows <= max_num, area-sorted."""
    ratios = {
        (i, j)
        for n in range(min_num, max_num + 1)
        for i in range(1, n + 1)
        for j in range(1, n + 1)
        if min_num <= i * j <= max_num
    }
    return sorted(ratios, key=lambda x: x[0] * x[1])


def select_tile_grid(
    width: int, height: int, min_num: int = 1, max_num: int = 12,
    image_size: int = 448,
) -> Tuple[int, int]:
    """The grid ``dynamic_preprocess`` would choose for this image."""
    return find_closest_aspect_ratio(
        width / height, candidate_grids(min_num, max_num),
        width, height, image_size,
    )


def _pil_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bicubic antialiased resize matching PIL (``Image.resize`` default).

    torchvision ``Resize(..., InterpolationMode.BICUBIC)`` on a PIL image and
    plain ``Image.resize`` both route through PIL's bicubic filter, so using
    PIL here is reference-exact.  ``size`` is (width, height).
    """
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))


def normalize(tiles_u8: np.ndarray) -> np.ndarray:
    """uint8 (..., H, W, 3) -> fp32 ImageNet-normalized, NHWC."""
    x = tiles_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def tile_frame(
    frame: np.ndarray,  # (H, W, 3) uint8 RGB
    min_num: int = 1,
    max_num: int = 12,
    image_size: int = 448,
    use_thumbnail: bool = True,
) -> np.ndarray:
    """``dynamic_preprocess`` (``data.py:81-117``): resize to the chosen grid,
    crop image_size² tiles row-major, append a thumbnail when >1 tile.

    Returns uint8 (num_tiles, image_size, image_size, 3).
    """
    h, w = frame.shape[:2]
    cols, rows = select_tile_grid(w, h, min_num, max_num, image_size)
    tw, th = image_size * cols, image_size * rows
    resized = _pil_resize(frame, (tw, th))
    tiles = [
        resized[r * image_size:(r + 1) * image_size,
                c * image_size:(c + 1) * image_size]
        for r in range(rows)
        for c in range(cols)
    ]
    if use_thumbnail and len(tiles) != 1:
        tiles.append(_pil_resize(frame, (image_size, image_size)))
    return np.stack(tiles)


def decode_frames(
    video_path: str, frame_indices: Sequence[int]
) -> List[np.ndarray]:
    """Decode the given frame indices as RGB uint8 arrays via cv2/FFmpeg.

    Sequential decode keeping wanted frames — robust against codecs where
    random seeks land on the wrong frame (decord hides this with its own
    index; cv2 sequential grab gives the same frame-exact behavior).
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    wanted = sorted(set(int(i) for i in frame_indices))
    frames = {}
    idx = 0
    last = wanted[-1]
    while idx <= last:
        ok = cap.grab()
        if not ok:
            break
        if idx in wanted:
            ok, bgr = cap.retrieve()
            if not ok:
                break
            frames[idx] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        idx += 1
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {video_path}")
    # Clamp out-of-range requests to the last decoded frame (matches decord's
    # behavior of never indexing past len(vr)-1 because get_index can't).
    fallback = frames[max(frames)]
    return [frames.get(int(i), fallback) for i in frame_indices]


def video_metadata(video_path: str) -> Tuple[int, float]:
    """(num_frames, fps) via cv2 properties."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
    cap.release()
    if n <= 0:
        # Some containers misreport; count by grabbing.
        cap = cv2.VideoCapture(video_path)
        n = 0
        while cap.grab():
            n += 1
        cap.release()
    return n, fps


def load_video(
    video_path: str,
    bound: Optional[Tuple[float, float]] = None,
    input_size: int = 448,
    max_num: int = 1,
    num_segments: int = 32,
) -> Tuple[np.ndarray, List[int]]:
    """Decode + sample + tile + normalize one video (``data.py:158-179``).

    Returns (pixel_values fp32 NHWC (sum_patches, S, S, 3), num_patches_list).
    """
    n_frames, fps = video_metadata(video_path)
    indices = get_frame_indices(n_frames, num_segments, bound=bound, fps=fps)
    frames = decode_frames(video_path, indices)

    tiles_list, num_patches_list = [], []
    for frame in frames:
        tiles = tile_frame(
            frame, max_num=max_num, image_size=input_size, use_thumbnail=True
        )
        num_patches_list.append(tiles.shape[0])
        tiles_list.append(tiles)
    pixel_values = normalize(np.concatenate(tiles_list, axis=0))
    return pixel_values, num_patches_list


def load_image(
    image_file: str, input_size: int = 448, max_num: int = 12
) -> np.ndarray:
    """Tile + normalize one image (``data.py:119-125``); fp32 NHWC."""
    from PIL import Image

    img = np.asarray(Image.open(image_file).convert("RGB"))
    tiles = tile_frame(
        img, max_num=max_num, image_size=input_size, use_thumbnail=True
    )
    return normalize(tiles)


def fetch_remote_video(url: str, cache_dir: str = "./video_cache") -> str:
    """HTTP / HuggingFace-datasets video download with a local cache
    (``download_video``, ``data.py:33-54``).

    The cache name carries a hash of the full URL: GenAI-Bench-style
    datasets store every model's output as `.../<model>/0001.mp4`, so a
    basename-only key would silently serve model A's video for model B.
    Downloads land in a temp file and rename into place atomically — a
    dropped connection must not leave a truncated file that every later
    run treats as a complete cached video (the rename also makes
    concurrent prefetch workers of one URL last-writer-wins instead of
    interleaving into one open file)."""
    import hashlib

    os.makedirs(cache_dir, exist_ok=True)
    clean = url.split("?")[0]
    digest = hashlib.sha256(clean.encode()).hexdigest()[:16]
    local = os.path.join(cache_dir,
                         f"{digest}_{os.path.basename(clean)}")
    if os.path.exists(local):
        return local
    tmp = f"{local}.part{os.getpid()}"
    try:
        if "huggingface.co/datasets" in url:
            from huggingface_hub import hf_hub_download

            part = url.split("datasets/")[1]
            # both the web ('/blob/') and direct-download ('/resolve/')
            # URL forms point at the same repo path
            sep = "/blob/" if "/blob/" in part else "/resolve/"
            repo_id = part.split(sep)[0]
            rev_file = part.split(sep)[1]
            revision = rev_file[: rev_file.find("/")]
            filename = rev_file[rev_file.find("/") + 1:]
            import shutil

            got = hf_hub_download(
                repo_id=repo_id, filename=filename, repo_type="dataset",
                revision=revision,
            )
            shutil.copy(got, tmp)
        else:
            import requests

            r = requests.get(url, stream=True, timeout=60)
            r.raise_for_status()
            with open(tmp, "wb") as f:
                for chunk in r.iter_content(chunk_size=1 << 20):
                    f.write(chunk)
        os.replace(tmp, local)  # atomic: cache holds complete files only
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return local


def fetch_s3_video(
    s3_client, bucket: str, key: str, root: str = "./datas/videos"
) -> str:
    """S3 download with local cache (``dataset.py:22-42`` ``download_file``).

    Gated on a caller-provided boto3 client (boto3 is optional here, exactly
    as AWS creds were optional in the reference's constructor defaults).
    """
    local = os.path.join(root, key)
    if os.path.exists(local):
        return local
    os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
    s3_client.download_file(bucket, key, local)
    return local


def prefetch_videos(
    paths: Sequence[str],
    fetch_fn,
    num_workers: int = 12,
) -> None:
    """Threaded bulk prefetch of remote videos into the local cache.

    Replaces ``VideoDataset.__check_video__``'s ThreadPoolExecutor warm-up
    (``dataset.py:299-309``); ``fetch_fn`` is e.g. ``fetch_remote_video`` or
    a bound ``fetch_s3_video``.
    """
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = [pool.submit(fetch_fn, p) for p in paths]
        for f in futures:
            try:
                f.result()
            except Exception as e:  # best-effort, like the reference
                print(f"prefetch error: {e}")
