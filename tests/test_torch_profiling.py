"""The port's profiling helpers (``utils/profiling.py``) and serving example
(``examples/serve.py``) on the CPU.

``Throughput`` and ``StepTimer`` are held against the JAX package's under
the same patched ``time.perf_counter``: rates, totals and JSONL records
equal.  ``trace`` writes a Chrome trace naming the ``annotate`` region.
The serving example scores three clips of a tiny checkpoint (in bf16, as
it loads every state), its video decoding replaced by
``chip_smoke.seeded_video_source`` as the card script's phase 23 replaces
it: each JSONL score is bit-equal to ``RewardScorer.score_video`` of a
scorer built as the example builds it.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mjvideo_tpu.utils import profiling as jprof
from mjvideo_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _counters(mod, path, monkeypatch):
    clock = iter([0.0, 0.5, 0.75, 2.0, 2.25, 3.5, 3.51, 5.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    tp = mod.Throughput(ema=0.8)
    rates = [tp.update(n) for n in (1, 2, 3)]
    avg = tp.average()
    timer = mod.StepTimer(str(path))
    recs = [timer.step(loss=np.float32(0.5), step=1),
            timer.step(loss=0.25, step=2)]
    return rates, avg, tp.total, tp.rate, recs, path.read_text()


def test_throughput_and_step_timer_match_jax(tmp_path, monkeypatch):
    got = _counters(tprof, tmp_path / "port.jsonl", monkeypatch)
    want = _counters(jprof, tmp_path / "jax.jsonl", monkeypatch)
    assert got == want
    assert got[0][0] == 2.0 and got[-1].count("\n") == 2


def test_trace_writes_a_chrome_trace_naming_the_annotated_region(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.annotate("lora_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof.key_averages()
    events = json.loads((tmp_path / "tr" / tprof.TRACE_FILE).read_text())[
        "traceEvents"]
    names = {e.get("name") for e in events}
    assert "lora_region" in names
    assert any(n and "mm" in n for n in names)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny checkpoint directory written by the port, three empty
    video files, and the serving example's run over them under the seeded
    video source (two decode workers, the run traced)."""
    import chip_smoke
    from mjvideo_tpu_torch.configs import tiny_test_config
    from mjvideo_tpu_torch.examples import serve
    from mjvideo_tpu_torch.models.reward import init_reward_params
    from mjvideo_tpu_torch.utils.export import save_reward_checkpoint_dir

    root = tmp_path_factory.mktemp("serve")
    cfg = tiny_test_config()
    state = init_reward_params(cfg, generator=torch.Generator().manual_seed(1),
                               device="cpu", dtype=torch.float32)
    save_reward_checkpoint_dir(str(root / "ckpt"), state, cfg)
    videos = root / "videos"
    videos.mkdir()
    for i in range(3):
        (videos / f"clip{i}.mp4").write_bytes(b"")
    (videos / "notes.txt").write_text("not a video")
    argv = ["--model-path", str(root / "ckpt"), "--videos", str(videos),
            "--byte-tokenizer", "--device", "cpu",
            "--num-segments", "2", "--workers", "2",
            "--trace-dir", str(root / "trace"),
            "--out", str(root / "scores.jsonl")]
    with chip_smoke.seeded_video_source():
        summary = serve.main(argv)
    return root, summary


def test_serving_example_scores_equal_score_video(served):
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.eval.scorer import RewardScorer
    from mjvideo_tpu_torch.utils.checkpoint import load_reward_model

    import chip_smoke

    root, summary = served
    rows = [json.loads(line) for line in
            (root / "scores.jsonl").read_text().splitlines()]
    assert [r["video"] for r in rows] == ["clip0.mp4", "clip1.mp4",
                                          "clip2.mp4"]
    assert summary["clips"] == 3 and summary["clips_per_s"] > 0
    cfg, params = load_reward_model(str(root / "ckpt"), device="cpu")
    tok = ByteTokenizer()
    scorer = RewardScorer(cfg, params, tok,
                          gating_pattern=tok.gating_pattern(
                              cfg.chat.template))
    with chip_smoke.seeded_video_source():
        for r in rows:
            want = scorer.score_video(str(root / "videos" / r["video"]),
                                      "a generated video", num_segments=2)
            assert np.float32(r["score"]) == want["score"]
            np.testing.assert_array_equal(
                np.asarray(r["aspect_scores"], np.float32),
                want["aspect_scores"])


def test_serving_example_traces_the_first_clips(served):
    root, _ = served
    events = json.loads((root / "trace" / tprof.TRACE_FILE).read_text())[
        "traceEvents"]
    regions = {e.get("name") for e in events
               if str(e.get("name")).startswith("score ")}
    assert regions == {"score clip0.mp4", "score clip1.mp4",
                       "score clip2.mp4"}


def test_serving_example_refuses_cuda_without_a_card(tmp_path):
    from mjvideo_tpu_torch.examples import serve

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--model-path", str(tmp_path), "--videos",
                    str(tmp_path)])
