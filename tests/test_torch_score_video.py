"""The port's serving path from a video file against the JAX package's:
``RewardScorer`` with ``device_preprocess`` (decoded uint8 frames resized
and tiled where the state lies), micro-batches (``device_batch``),
``prepare_clip``, ``score_video`` and ``score_pair``; and the rest of
``data/video.py`` (``load_image``, the remote fetches and their cache).

At ``tiny_test_config`` in fp32 on the CPU, on the bridged weights of one
JAX state.  Scores and the other outputs agree within atol 2e-5 (the bar
of ``test_torch_scorer.py``).  The videos are mp4s written with cv2 as
``examples/make_sample_data.py`` writes them; the fetches run against stub
clients and local files, with no network.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data import video as jvideo
from mjvideo_tpu.data.prompts import (ByteTokenizer, build_video_question,
                                      prepare_chat_input)
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models.reward import init_reward_params as jax_init
from mjvideo_tpu_torch.data import video as tvideo
from mjvideo_tpu_torch.eval.scorer import RewardScorer, tiles_per_frame
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
BUCKET = 1024
ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init(key, cfg))(jax.random.PRNGKey(2)))
    return cfg, params, from_jax_params(params, device="cpu"), ByteTokenizer()


def _scorers(setup, **kw):
    cfg, params, state, tok = setup
    common = dict(length_buckets=(BUCKET,),
                  gating_pattern=tok.gating_pattern(), **kw)
    return (JaxRewardScorer(cfg, params, tok, attn_impl="xla",
                            dtype=jnp.float32, **common),
            RewardScorer(cfg, state, tok, dtype=torch.float32, **common))


def _close(got, want):
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=1e-5, err_msg=name)


def _write_video(path, seed, size=(64, 64), n_frames=16, fps=8.0):
    """As ``examples/make_sample_data.py:23-33`` writes its clips; ``size``
    is (width, height)."""
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        size)
    assert w.isOpened()
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)
    for i in range(n_frames):
        w.write(np.roll(base, i * 2, axis=1))
    w.release()
    return str(path)


def _frame_requests(scorer, tok, frames_per_clip, size, seed=0):
    """Decoded uint8 frames of len(frames_per_clip) clips and their
    prompts, each frame expanded to the scorer's tiles."""
    h, w = size
    per_frame = tiles_per_frame(scorer.cfg, scorer._device_grid(w, h))
    rng = np.random.default_rng(seed)
    ids, gpos = [], []
    for i, n in enumerate(frames_per_clip):
        chat = prepare_chat_input(
            scorer.cfg.chat, tok, build_video_question(f"clip {i}" * (i + 1),
                                                       n),
            num_patches_list=[per_frame] * n,
            gating_pattern=tok.gating_pattern())
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
    frames = rng.integers(0, 256, (sum(frames_per_clip), h, w, 3),
                          dtype=np.uint8)
    return frames, ids, gpos


@pytest.mark.parametrize("max_num,size", [(1, (72, 128)), (3, (56, 112))])
def test_score_batch_device_preprocess_matches_jax(setup, max_num, size):
    jax_scorer, port = _scorers(setup, device_preprocess=True,
                                device_max_num=max_num)
    frames, ids, gpos = _frame_requests(port, setup[3], (2, 1), size)
    assert port._device_grid(size[1], size[0]) == (
        (1, 1) if max_num == 1 else (2, 1))
    _close(port.score_batch(frames, ids, gpos),
           jax_scorer.score_batch(frames, ids, gpos))


def test_device_preprocess_guards_the_image_tokens(setup):
    jax_scorer, port = _scorers(setup, device_preprocess=True,
                                device_max_num=3)
    frames, ids, gpos = _frame_requests(port, setup[3], (2, 1), (56, 112))
    for scorer in (jax_scorer, port):
        with pytest.raises(ValueError, match="IMG_CONTEXT"):
            scorer.score_batch(frames[:-1], ids, gpos)


def test_port_micro_batches_equal_one_forward(setup):
    """``device_batch`` 1 and 2 against one forward of 3 clips (frames
    path), and against JAX's scorer split alike."""
    _, one = _scorers(setup, device_preprocess=True)
    frames, ids, gpos = _frame_requests(one, setup[3], (1, 2, 1), (72, 128))
    whole = one.score_batch(frames, ids, gpos)
    assert whole.score.shape == (3,)
    # The default, 8 clips a forward (chip_smoke.py phase 22's sweep).
    assert one._micro_batch(3) == 3 and one._micro_batch(20) == 8
    for micro in (1, 2):
        jax_scorer, port = _scorers(setup, device_preprocess=True,
                                    device_batch=micro)
        assert port._micro_batch(3) == micro
        got = port.score_batch(frames, ids, gpos)
        for a, b in zip(got, whole):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                       rtol=1e-5)
    _close(got, jax_scorer.score_batch(frames, ids, gpos))


def test_port_micro_batches_non_uniform_tiles(setup):
    """Host tiling gives clips different tile counts; each micro-batch
    takes its own clips' rows (``_clip_pixel_rows``)."""
    cfg, _, _, tok = setup
    jax_scorer, port = _scorers(setup, device_batch=1)
    rng = np.random.default_rng(5)
    ids, gpos, tiles = [], [], []
    for i, patches in enumerate(([1, 1], [3, 3, 3], [2])):
        chat = prepare_chat_input(port.cfg.chat, tok,
                                  build_video_question(f"c{i}", len(patches)),
                                  num_patches_list=patches,
                                  gating_pattern=tok.gating_pattern())
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
        tiles.append(sum(patches))
    assert port._clip_pixel_rows(np.zeros((sum(tiles), 1, 1, 3)), ids) == tiles
    size = cfg.chat.image_size
    pix = rng.normal(size=(sum(tiles), size, size, 3)).astype(np.float32)
    got = port.score_batch(pix, ids, gpos)
    _close(got, jax_scorer.score_batch(pix, ids, gpos))
    whole = RewardScorer(cfg, port.params, tok, dtype=torch.float32,
                         length_buckets=(BUCKET,),
                         gating_pattern=tok.gating_pattern())
    for a, b in zip(got, whole.score_batch(pix, ids, gpos)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=1e-5)


def _clip_close(got, want):
    assert set(got) == {"score", "aspect_scores", "rewards"}
    for name in got:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   atol=ATOL, rtol=1e-5, err_msg=name)


PATHS = {"host": dict(), "device": dict(device_preprocess=True,
                                        device_max_num=2)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_score_video_matches_jax(setup, tmp_path, path):
    video = _write_video(tmp_path / "wide.mp4", seed=0, size=(128, 64))
    jax_scorer, port = _scorers(setup, **PATHS[path])
    got = port.score_video(video, "a wide clip", num_segments=2, max_num=2)
    _clip_close(got, jax_scorer.score_video(video, "a wide clip",
                                            num_segments=2, max_num=2))
    # The clip tiles as (2, 1) plus the thumbnail on either path.
    pixels, ids, _ = port.prepare_clip(video, "a wide clip", 2, 2)
    assert (pixels.dtype == np.uint8) == (path == "device")
    assert int((ids == port.img_context_token_id).sum()) == (
        2 * 3 * port.cfg.chat.num_image_token)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_score_pair_matches_jax(setup, tmp_path, path):
    v0 = _write_video(tmp_path / "a.mp4", seed=1, size=(128, 64))
    v1 = _write_video(tmp_path / "b.mp4", seed=2, size=(128, 64), n_frames=9)
    jax_scorer, port = _scorers(setup, **PATHS[path])
    got = port.score_pair(v0, v1, "two clips", num_segments=2, max_num=2)
    want = jax_scorer.score_pair(v0, v1, "two clips", num_segments=2,
                                 max_num=2)
    for g, w in zip(got, want):
        _clip_close(g, w)
    assert got[0]["score"] != got[1]["score"]


def test_max_num_other_than_device_max_num_raises_in_both(setup, tmp_path):
    video = _write_video(tmp_path / "c.mp4", seed=3)
    for scorer in _scorers(setup, device_preprocess=True, device_max_num=2):
        with pytest.raises(ValueError, match="device_max_num"):
            scorer.score_video(video, "x", num_segments=2, max_num=1)


def test_device_path_of_a_square_clip_is_one_tile_a_frame(setup, tmp_path):
    video = _write_video(tmp_path / "sq.mp4", seed=4)
    _, port = _scorers(setup, device_preprocess=True)
    pixels, ids, _ = port.prepare_clip(video, "a square clip", 3)
    assert pixels.shape == (3, 64, 64, 3) and pixels.dtype == np.uint8
    assert int((ids == port.img_context_token_id).sum()) == (
        3 * port.cfg.chat.num_image_token)


# --- images and fetches ------------------------------------------------------

def test_load_image_matches_jax(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (60, 150, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(img).save(path)
    got = tvideo.load_image(path, input_size=28, max_num=6)
    want = jvideo.load_image(path, input_size=28, max_num=6)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] > 1  # tiles and the thumbnail
    np.testing.assert_array_equal(got, want)


def test_fetch_s3_video_with_a_stub_client(tmp_path):
    calls = []

    class Client:
        def download_file(self, bucket, key, local):
            calls.append((bucket, key))
            with open(local, "wb") as f:
                f.write(b"video bytes")

    root = str(tmp_path / "videos")
    for fetch in (tvideo.fetch_s3_video, jvideo.fetch_s3_video):
        calls.clear()
        local = fetch(Client(), "bucket", "a/b/clip.mp4", root=root)
        assert local == os.path.join(root, "a/b/clip.mp4")
        assert open(local, "rb").read() == b"video bytes"
        assert calls == ([("bucket", "a/b/clip.mp4")]
                         if fetch is tvideo.fetch_s3_video else [])


def _stub_requests(monkeypatch, payload=None, error=None):
    calls = []

    class Response:
        def raise_for_status(self):
            pass

        def iter_content(self, chunk_size):
            yield payload[:3]
            if error is not None:
                raise error
            yield payload[3:]

    def get(url, stream, timeout):
        calls.append(url)
        return Response()

    monkeypatch.setitem(sys.modules, "requests",
                        types.SimpleNamespace(get=get))
    return calls


def test_fetch_remote_video_cache_key_and_hit(tmp_path, monkeypatch):
    calls = _stub_requests(monkeypatch, payload=b"mp4 payload")
    cache = str(tmp_path / "cache")
    url = "https://example.invalid/modelA/0001.mp4?token=1"
    local = tvideo.fetch_remote_video(url, cache_dir=cache)
    assert os.path.basename(local).endswith("_0001.mp4")
    assert open(local, "rb").read() == b"mp4 payload"
    # The key hashes the whole URL (not the query): another model's
    # 0001.mp4 is another file; the same URL is a cache hit.
    other = tvideo.fetch_remote_video(
        "https://example.invalid/modelB/0001.mp4", cache_dir=cache)
    assert other != local
    again = tvideo.fetch_remote_video(url.split("?")[0], cache_dir=cache)
    assert again == local and len(calls) == 2
    assert sorted(os.listdir(cache)) == sorted(
        os.path.basename(p) for p in (local, other))
    # The JAX package's function names the same file and finds it cached.
    assert jvideo.fetch_remote_video(url, cache_dir=cache) == local
    assert len(calls) == 2


def test_fetch_remote_video_removes_the_partial_file(tmp_path, monkeypatch):
    _stub_requests(monkeypatch, payload=b"truncated", error=IOError("reset"))
    cache = str(tmp_path / "cache")
    with pytest.raises(IOError, match="reset"):
        tvideo.fetch_remote_video("https://example.invalid/x.mp4",
                                  cache_dir=cache)
    assert os.listdir(cache) == []


def test_prefetch_videos_fetches_each_and_survives_errors(capsys):
    seen = []

    def fetch(path):
        seen.append(path)
        if path == "bad":
            raise IOError("missing")
        return path

    tvideo.prefetch_videos(["a", "bad", "c"], fetch, num_workers=2)
    assert sorted(seen) == ["a", "bad", "c"]
    assert "prefetch error: missing" in capsys.readouterr().out


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_in_row_blocks_equals_one_block(monkeypatch, causal):
    """The fp32 oracle of a 72-tile clip forms its scores a block of query
    rows at a time (``PLAIN_BLOCK_ELEMENTS``); the blocks give the one
    block's result, with the key mask and causality."""
    from mjvideo_tpu_torch.ops import attention as A

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 70, 4, 16, generator=g)
    k, v = (torch.randn(2, 70, 2, 16, generator=g) for _ in range(2))
    mask = torch.ones(2, 70, dtype=torch.int32)
    mask[1, 60:] = 0
    whole = A.multi_head_attention(q, k, v, mask, causal=causal, impl="plain")
    monkeypatch.setattr(A, "PLAIN_BLOCK_ELEMENTS", 2 * 4 * 70 * 9)
    blocks = A.multi_head_attention(q, k, v, mask, causal=causal,
                                    impl="plain")
    assert torch.equal(blocks, whole)
