"""The API judges (``mjvideo_tpu_torch/eval/judges.py``: ``OpenAIJudge``,
``GeminiJudge``, ``_extract_frames_b64``, ``_ask_with_retries``) against
the JAX package's, and their routing in the port's eval CLI.

No network and neither client package: ``_request`` and ``time.sleep``
are monkeypatched, as ``tests/test_judges.py`` does for JAX.  Frames are
read from a clip written with cv2 from a numpy seed; the port's base64
JPEGs must be byte-equal to JAX's (the same cv2 calls on the same file).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mjvideo_tpu.eval import judges as jjudges
from mjvideo_tpu_torch.eval import cli as ecli
from mjvideo_tpu_torch.eval import judges as tjudges

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    import cv2

    path = tmp_path_factory.mktemp("api") / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                        (32, 32))
    rng = np.random.default_rng(0)
    for _ in range(120):
        w.write(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
    w.release()
    return str(path)


@pytest.mark.parametrize("every,cap,n", [(50, 8, 3), (50, 10, 3), (1, 10, 10),
                                         (7, 4, 4)])
def test_frames_are_byte_equal_to_jax(clip, every, cap, n):
    got = tjudges._extract_frames_b64(clip, every, cap)
    assert got == jjudges._extract_frames_b64(clip, every, cap)
    assert len(got) == n and all(isinstance(f, str) and f for f in got)
    assert tjudges.GeminiJudge._encode_frames(clip, every, cap) == got


def test_retry_semantics_match_jax(monkeypatch):
    """Success on the last allowed attempt after sleeps between the
    attempts; exhaustion gives "" (rating 0) without raising."""
    for mod in (tjudges, jjudges):
        calls, sleeps = {"n": 0}, []
        monkeypatch.setattr("time.sleep", sleeps.append)

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionError("transient")
            return "RATING: Good"

        assert mod._ask_with_retries(flaky, max_try=3, sleep_s=2.5) == \
            "RATING: Good"
        assert calls["n"] == 3 and sleeps == [2.5, 2.5]

        def down():
            calls["n"] += 1
            raise ConnectionError("down")

        calls["n"], sleeps[:] = 0, []
        assert mod._ask_with_retries(down, max_try=2, sleep_s=1.0) == ""
        assert calls["n"] == 2 and sleeps == [1.0]


@pytest.mark.parametrize("which", ["openai", "gemini"])
def test_judges_retry_then_record_rating_zero(monkeypatch, tmp_path, which):
    """A judge whose API fails N - 1 times still rates; one that always
    fails rates 0 and the benchmark goes on (port and JAX alike)."""
    key = "OPENAI_API_KEY" if which == "openai" else "GOOGLE_API_KEY"
    monkeypatch.setenv(key, "test-key")
    monkeypatch.setattr("time.sleep", lambda s: None)
    if which == "gemini":  # the client package's presence is checked first
        import types

        google = types.ModuleType("google")
        google.generativeai = types.ModuleType("google.generativeai")
        monkeypatch.setitem(sys.modules, "google", google)
        monkeypatch.setitem(sys.modules, "google.generativeai",
                            google.generativeai)
    records = [{"video_0_path": "a.mp4", "video_1_path": "b.mp4",
                "caption": "c", "overall_preference": "Video 1 better"}]
    results = {}
    for name, mod in (("port", tjudges), ("jax", jjudges)):
        make = mod.OpenAIJudge if which == "openai" else mod.GeminiJudge
        calls = {"n": 0}

        def flaky(prompt, video):
            calls["n"] += 1
            if calls["n"] % 3:
                raise OSError("api")
            return "RATING: Excellent"

        j = make(max_try=3, retry_sleep=0)
        monkeypatch.setattr(j, "_request", flaky)
        assert j.ask("rate", "v.mp4") == "RATING: Excellent"
        assert calls["n"] == 3
        dead = make(max_try=2, retry_sleep=0)
        monkeypatch.setattr(dead, "_request", lambda p, v: (_ for _ in ())
                            .throw(OSError("api")))
        results[name] = mod.run_overall_benchmark(
            dead, records, results_path=str(tmp_path / f"{name}.jsonl"))
        rows = [json.loads(x) for x in
                (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        assert rows[0]["score_0"] == rows[0]["score_1"] == 0
    assert results["port"] == results["jax"]
    assert results["port"]["count"] == 1


@pytest.mark.parametrize("which", ["openai", "gemini"])
def test_missing_key_raises_before_any_request(monkeypatch, which):
    key = "OPENAI_API_KEY" if which == "openai" else "GOOGLE_API_KEY"
    monkeypatch.delenv(key, raising=False)
    make = tjudges.OpenAIJudge if which == "openai" else tjudges.GeminiJudge
    j = make()
    monkeypatch.setattr(j, "_request", lambda p, v: pytest.fail("request"))
    with pytest.raises(RuntimeError, match=key):
        j.ask("rate", "v.mp4")


def test_gemini_checks_mode_and_client(monkeypatch):
    with pytest.raises(ValueError, match="mode"):
        tjudges.GeminiJudge(mode="nope")
    assert tjudges.GeminiJudge(mode="upload").mode == "upload"
    monkeypatch.setenv("GOOGLE_API_KEY", "test-key")
    monkeypatch.setitem(sys.modules, "google.generativeai", None)
    with pytest.raises(RuntimeError, match="google-generativeai"):
        tjudges.GeminiJudge().ask("rate", "v.mp4")


@pytest.mark.parametrize("judge,cls,model", [
    ("gpt4o", "OpenAIJudge", "gpt-4o"),
    ("gemini", "GeminiJudge", "gemini-1.5-flash"),
])
def test_eval_cli_routes_the_api_judges(monkeypatch, tmp_path, judge, cls,
                                        model):
    """``--judge gpt4o|gemini`` builds the API judge, ``--judge-model``
    naming the API's model, and runs the overall benchmark with it (the
    JAX CLI's ``cli.py:142-145``)."""
    from mjvideo_tpu_torch.eval import judges

    made = {}
    real = ecli._make_judge

    def capture(args):
        made["judge"] = real(args)
        return made["judge"]

    def run(judge_obj, records, root="", results_path=None):
        made["records"] = records
        return {"count": len(records)}

    monkeypatch.setattr(ecli, "_make_judge", capture)
    monkeypatch.setattr(judges, "run_overall_benchmark", run)
    data = tmp_path / "pairs.json"
    data.write_text(json.dumps([{"video_0_path": "a.mp4",
                                 "video_1_path": "b.mp4", "caption": "c",
                                 "overall_preference": "Video 1 better"}]))
    base = ["--benchmark", "overall", "--device", "cpu", "--data-json",
            str(data), "--judge", judge]
    assert ecli.main(base) == {"count": 1}
    assert type(made["judge"]).__name__ == cls
    assert made["judge"].model == model
    ecli.main(base + ["--judge-model", "custom-model"])
    assert made["judge"].model == "custom-model"


def test_api_clients_and_cv2_load_lazily():
    """Importing the judges and the CLI loads neither client package nor
    cv2."""
    code = """
import sys
from mjvideo_tpu_torch.eval import cli, judges
assert judges.OpenAIJudge and judges.GeminiJudge
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("openai", "cv2") or m.startswith("google.generativeai"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
