"""The port's labels, pair dataset, collation, host pipeline, metrics and
reports against the JAX package's, on the CPU.

``data/labels.py``, ``data/dataset.py``, ``eval/metrics.py`` and
``eval/report.py`` of ``mjvideo_tpu_torch`` are copies of the JAX
package's modules (numpy only, no device work), so they are held to them
exactly: the same label arrays, the same examples (pixels bit-equal: both
tile through the same PIL path), the same collated batches, the same metric
dicts and the same report text.  Records and videos are made as
``examples/make_sample_data.py`` makes them (its ``make_record``, cv2
mp4s), plus hand-built records for the edge cases: every preference
string, both ``mse`` settings, missing and None labels, ties and
all-masked inputs.  Nothing here runs a model.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data import dataset as jds
from mjvideo_tpu.data import labels as jlabels
from mjvideo_tpu.data.prompts import ByteTokenizer as JaxByteTokenizer
from mjvideo_tpu.eval import metrics as jmetrics
from mjvideo_tpu.eval import report as jreport
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch.data import dataset as tds
from mjvideo_tpu_torch.data import labels as tlabels
from mjvideo_tpu_torch.data.prompts import ByteTokenizer
from mjvideo_tpu_torch.eval import metrics as tmetrics
from mjvideo_tpu_torch.eval import report as treport

REPO = Path(__file__).resolve().parents[1]
PREFERENCES = ("Video 1 better", "Video 2 better", "Same", "Hard to judge",
               "", "video 1 better")
LABEL_VALUES = (0, 1, 2, 3, -1, None, 1.0, 2.0)


def _sample_data_module():
    spec = importlib.util.spec_from_file_location(
        "make_sample_data", REPO / "examples" / "make_sample_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """Four MJ-BENCH-VIDEO pairs from ``make_sample_data.make_record`` (their
    overall preferences set to cover the decided and undecided strings)
    and their cv2-written videos."""
    mod = _sample_data_module()
    root = tmp_path_factory.mktemp("eval_data")
    videos = root / "videos"
    videos.mkdir()
    rng = np.random.default_rng(0)
    records = [mod.make_record(rng, i, str(videos)) for i in range(4)]
    for rec, pref in zip(records, ("Video 1 better", "Same",
                                   "Video 2 better", "Hard to judge")):
        rec["overall_preference"] = pref
    path = root / "pairs.json"
    path.write_text(json.dumps(records))
    return str(path), str(videos), records


# ------------------------------------------------------------------ labels

def test_names_equal_jax():
    from mjvideo_tpu import configs as jconfigs

    assert tconfigs.ASPECT_NAMES == jconfigs.ASPECT_NAMES
    assert tconfigs.CRITERIA_NAMES == jconfigs.CRITERIA_NAMES


@pytest.mark.parametrize("mse", [True, False])
def test_label_values_match_jax(mse):
    for v in LABEL_VALUES:
        assert (tlabels.encode_label_value(v, mse)
                == jlabels.encode_label_value(v, mse)), v


@pytest.mark.parametrize("mse", [True, False])
def test_process_labels_match_jax(mse):
    labels = {f"c{i}": v for i, v in enumerate(LABEL_VALUES)}
    assert (tlabels.process_labels(labels, mse)
            == jlabels.process_labels(labels, mse))
    assert tlabels.process_labels({}, mse) == jlabels.process_labels({}, mse)
    for v in LABEL_VALUES:
        assert (tlabels.process_labels(v, mse, overall=True)
                == jlabels.process_labels(v, mse, overall=True))


@pytest.mark.parametrize("pref", PREFERENCES + (None,))
def test_preferences_match_jax(pref):
    assert tlabels.encode_preference(pref) == jlabels.encode_preference(pref)
    assert (tlabels.deal_preference(pref, overall=True)
            == jlabels.deal_preference(pref, overall=True))


def test_deal_preference_dict_matches_jax():
    labels = {f"a{i}": p for i, p in enumerate(PREFERENCES)}
    assert (tlabels.deal_preference(labels)
            == jlabels.deal_preference(labels))


@pytest.mark.parametrize("mse", [True, False])
def test_pair_record_labels_match_jax(sample, mse):
    for rec in sample[2]:
        _equal_dicts(tlabels.pair_record_labels(rec, mse),
                     jlabels.pair_record_labels(rec, mse))


def test_pair_record_labels_missing_and_none(sample):
    rec = json.loads(json.dumps(sample[2][0]))
    rec["video_0_label"]["object"] = None
    rec["video_1_overall_score"]["Safety"] = None
    rec["video_0_total_score"] = None
    rec["category_preference"]["Alignment"] = None
    _equal_dicts(tlabels.pair_record_labels(rec),
                 jlabels.pair_record_labels(rec))
    # A criterion missing on one side breaks the name symmetry in both.
    del rec["video_1_label"]["count"]
    for mod in (tlabels, jlabels):
        with pytest.raises(AssertionError, match="criteria"):
            mod.pair_record_labels(rec)


# ----------------------------------------------------------------- dataset

def _datasets(sample, **kw):
    path, videos, _ = sample
    cfg = tiny_test_config()
    tok = ByteTokenizer()
    common = dict(root=videos, num_segments=2,
                  gating_pattern=tok.gating_pattern(), **kw)
    return (tds.PreferencePairDataset(path, tok, tconfigs.tiny_test_config()
                                      .chat, **common),
            jds.PreferencePairDataset(path, JaxByteTokenizer(), cfg.chat,
                                      **common))


@pytest.mark.parametrize("overall", [False, True], ids=["criteria", "overall"])
def test_dataset_examples_match_jax(sample, overall):
    got, want = _datasets(sample, overall=overall)
    assert len(got) == len(want) == (2 if overall else 4)
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _equal_dicts(a, b)
        assert a["video_0_pixel_values"].shape == (2, 56, 56, 3)


@pytest.mark.parametrize("mse", [True, False])
def test_dataset_mse_matches_jax(sample, mse):
    got, want = _datasets(sample, mse=mse)
    for rec in sample[2][:1]:
        _equal_dicts(got.example(rec), want.example(rec))


def test_decode_workers_keep_order(sample):
    inline, _ = _datasets(sample, overall=True)
    pooled, _ = _datasets(sample, overall=True, decode_workers=2)
    a, b = list(inline), list(pooled)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        _equal_dicts(x, y)


@pytest.fixture(scope="module")
def examples(sample):
    got, _ = _datasets(sample)
    return list(got)


@pytest.mark.parametrize("batch_size,drop", [(1, True), (3, True),
                                             (3, False), (4, True)])
def test_collated_batches_match_jax(examples, batch_size, drop):
    got = list(tds.batched(examples, tds.PairCollator(0, 512), batch_size,
                           drop_remainder=drop))
    want = list(jds.batched(examples, jds.PairCollator(0, 512), batch_size,
                            drop_remainder=drop))
    assert len(got) == len(want) == (
        len(examples) // batch_size + (0 if drop or not len(examples)
                                       % batch_size else 1))
    for a, b in zip(got, want):
        _equal_dicts(a, b)
        assert a["video_0_input_ids"].shape == (len(a["overall_mask"]), 512)


def test_collator_pad_id_and_refusals(examples):
    for pad in (0, 7):
        _equal_dicts(tds.PairCollator(pad, 600)(examples[:2]),
                     jds.PairCollator(pad, 600)(examples[:2]))
    n = len(examples[0]["video_0_input_ids"])
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="exceeds the collator"):
            mod.PairCollator(0, n - 1)(examples[:1])
    odd = dict(examples[1])
    odd["video_0_pixel_values"] = odd["video_0_pixel_values"][:1]
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="variable tile counts"):
            mod.PairCollator(0, 512)([examples[0], odd])


@pytest.mark.parametrize("workers,ahead", [(1, None), (3, None), (3, 1),
                                           (4, 2)])
def test_pool_map_keeps_order(workers, ahead):
    import time

    def slow(i):
        time.sleep(0.002 * ((7 * i) % 5))
        return i * i

    got = list(tds.pool_map(slow, range(23), num_workers=workers,
                            num_prefetch=ahead))
    assert got == [i * i for i in range(23)]
    assert got == list(jds.pool_map(slow, range(23), num_workers=workers,
                                    num_prefetch=ahead))


def test_pool_map_raises_what_a_worker_raised():
    def fn(i):
        if i == 5:
            raise KeyError("item five")
        return i

    out = []
    with pytest.raises(KeyError, match="item five"):
        for x in tds.pool_map(fn, range(10), num_workers=3):
            out.append(x)
    assert out == [0, 1, 2, 3, 4]


def test_prefetch_runs_in_a_host_thread_and_reraises():
    main = threading.get_ident()
    seen = []

    def gen():
        for i in range(5):
            seen.append(threading.get_ident())
            yield i

    assert list(tds.prefetch(gen(), 2)) == list(range(5))
    assert seen and all(t != main for t in seen)

    def bad():
        yield 1
        raise RuntimeError("decode failed")

    it = tds.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


# ----------------------------------------------------------------- metrics

def _seeded_scores(seed, n=40, d=6):
    rng = np.random.default_rng(seed)
    # Rounded so that exact ties (score 0 at the threshold, equal pairs)
    # occur.
    scores = np.round(rng.normal(size=(n, d)), 1)
    targets = rng.choice([1.0, -1.0, 0.0], size=(n, d))
    related = (rng.random((n, d)) < 0.7).astype(np.float32)
    related[:, -1] = 0  # an all-masked dimension
    return scores, targets, related


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_dimension_metrics_match_jax(seed):
    s, t, r = _seeded_scores(seed)
    names = [f"d{i}" for i in range(s.shape[1])]
    for kw in ({}, {"names": names}, {"threshold": 0.3}):
        assert (tmetrics.binary_dimension_metrics(s, t, r, **kw)
                == jmetrics.binary_dimension_metrics(s, t, r, **kw))
    assert (tmetrics.binary_dimension_metrics(s, t, np.zeros_like(r))
            == jmetrics.binary_dimension_metrics(s, t, np.zeros_like(r)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preference_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    s0 = np.round(rng.normal(size=30), 1)
    s1 = np.round(rng.normal(size=30), 1)
    s1[:4] = s0[:4]  # ties
    pref = rng.integers(0, 2, 30)
    mask = (rng.random(30) < 0.8).astype(np.float32)
    for m in (mask, np.zeros_like(mask), np.ones_like(mask)):
        assert (tmetrics.preference_accuracy(s0, s1, pref, m)
                == jmetrics.preference_accuracy(s0, s1, pref, m))
        assert (tmetrics.strict_and_tie_aware(s0, s1, pref, m)
                == jmetrics.strict_and_tie_aware(s0, s1, pref, m))


@pytest.mark.parametrize("name", ["genai_bench_metrics",
                                  "genai_judge_metrics",
                                  "genai_videoscore_metrics"])
def test_genai_vote_metrics_match_jax(name):
    rng = np.random.default_rng(3)
    votes = ["leftvote", "rightvote", "tievote", "bothbad_vote", "other"] * 8
    left = rng.integers(0, 11, len(votes)).astype(np.float64) - 3
    right = rng.integers(0, 11, len(votes)).astype(np.float64) - 3
    right[::3] = left[::3]  # equal scores on every vote type
    got = getattr(tmetrics, name)(left, right, votes)
    assert got == getattr(jmetrics, name)(left, right, votes)
    assert got["total"] == 32
    empty = getattr(tmetrics, name)([], [], [])
    assert empty == getattr(jmetrics, name)([], [], [])


def test_tie_aware_pair_score_matches_jax():
    labels = ("left", "right", "tie", "bothbad")
    for pred in labels:
        for gt in labels:
            for tv in (0.5, 0.25):
                assert (tmetrics.tie_aware_pair_score(pred, gt, tv)
                        == jmetrics.tie_aware_pair_score(pred, gt, tv))


# ----------------------------------------------------------------- reports

def _rows():
    s, t, r = _seeded_scores(4)
    return tmetrics.binary_dimension_metrics(
        s, t, r, names=[f"dim {i}" for i in range(s.shape[1])])


def test_format_table_matches_jax():
    rows = _rows()
    for cols in (None, ["dimension", "accuracy", "count"]):
        assert (treport.format_table(rows, cols)
                == jreport.format_table(rows, cols))
    assert treport.format_table([]) == jreport.format_table([])


@pytest.mark.parametrize("ext", [".csv", ".xlsx"])
def test_save_report_matches_jax(tmp_path, ext):
    rows = _rows()
    got = treport.save_report(rows, str(tmp_path / f"port{ext}"))
    want = jreport.save_report(rows, str(tmp_path / f"jax{ext}"))
    assert os.path.splitext(got)[1] == os.path.splitext(want)[1]
    assert Path(got).read_bytes() == Path(want).read_bytes()


def test_format_table_needs_no_pandas():
    """The card's machine has no pandas: ``format_table`` and the whole
    harness import without it."""
    code = """
import sys
sys.modules["pandas"] = None
from mjvideo_tpu_torch.eval import cli, preference, report
print(report.format_table([{"a": 1.0, "b": "x"}]).splitlines()[2])
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["1.0000", "x"]


def test_harness_imports_no_jax_and_no_mjvideo_tpu():
    """In a fresh interpreter: the harness modules, the two CLIs and the
    judges' models (VideoScore, MiniCPM-V, CogVLM2, their templates,
    checkpoint branches, exporter and bridge) load no ``jax`` and no
    ``mjvideo_tpu`` module."""
    code = """
import sys
import mjvideo_tpu_torch
from mjvideo_tpu_torch.data import dataset, judge_templates, labels
from mjvideo_tpu_torch.eval import cli, judges, metrics, preference, report
from mjvideo_tpu_torch.models import cogvlm2, minicpmv, videoscore
from mjvideo_tpu_torch.train import cli as train_cli, trainer
from mjvideo_tpu_torch.utils import bridge, checkpoint, export
assert hasattr(trainer.Trainer, "evaluate")
assert hasattr(judges, "VideoScoreJudge") and hasattr(judges, "MiniCPMVJudge")
assert hasattr(bridge, "videoscore_from_jax")
assert hasattr(judges, "CogVLM2Judge") and hasattr(bridge, "cogvlm2_from_jax")
assert hasattr(export, "export_cogvlm2") and "cogvlm2" not in cli.NOT_PORTED_JUDGES
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "mjvideo_tpu" or m.startswith("mjvideo_tpu."))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
