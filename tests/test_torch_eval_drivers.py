"""The port's benchmark drivers and ``Trainer.evaluate`` against the JAX
package's, at ``tiny_test_config`` in fp32 on the CPU.

The reward drivers (``evaluate_preference``, ``evaluate_aspects``,
``evaluate_genai_bench``) run the port's ``RewardScorer`` and JAX's on the
bridged weights of one JAX state, over records and cv2-written mp4s made
as ``examples/make_sample_data.py`` makes them, one pair with videos of
unequal frame sizes among them.  Tolerances: the scores in the results
files within atol 2e-5, rtol 1e-5 (the scorer's bar,
``tests/test_torch_scorer.py``); then each metric exactly, after asserting
that every comparison it makes has a margin above 1e-4 (two scores of a
pair, or a score and its threshold), so that a difference inside the
tolerance cannot flip it; the score statistics of the binary metrics
(min/max/mean/std) within atol 2e-5.  Resume: a results file cut after k
records plus a torn fragment scores only the rest, in either package.
The judge drivers run the port's ``InternVLJudge`` against JAX's on the
same bridged chat state (answers equal), and a scripted stub judge with
fixed answers through both packages' drivers (outputs equal, and equal to
the metrics worked out by hand).  No test calls a JAX ``main``.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data import dataset as jds
from mjvideo_tpu.data.prompts import ByteTokenizer
from mjvideo_tpu.eval import judges as jjudges
from mjvideo_tpu.eval import preference as jpref
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models.internvl import init_chat_params as jax_chat_init
from mjvideo_tpu.models.reward import init_reward_params as jax_init
from mjvideo_tpu_torch.data import dataset as tds
from mjvideo_tpu_torch.eval import judges as tjudges
from mjvideo_tpu_torch.eval import metrics as tmetrics
from mjvideo_tpu_torch.eval import preference as tpref
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
ATOL, RTOL, MARGIN = 2e-5, 1e-5, 1e-4
SEGMENTS = 2
N = 4  # pairs
STATS = ("min", "max", "mean", "std")


def _sample_data_module():
    spec = importlib.util.spec_from_file_location(
        "make_sample_data", REPO / "examples" / "make_sample_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Four pairs from ``make_record``, with overall preferences of every
    kind; the last pair's second video is 48x48 against the first's 64x64."""
    mod = _sample_data_module()
    root = tmp_path_factory.mktemp("drivers")
    videos = root / "videos"
    videos.mkdir()
    rng = np.random.default_rng(1)
    records = [mod.make_record(rng, i, str(videos)) for i in range(N)]
    for rec, pref in zip(records, ("Video 1 better", "Same", "Hard to judge",
                                   "Video 2 better")):
        rec["overall_preference"] = pref
    mod.write_video(str(videos / records[-1]["video_1_path"]), seed=99,
                    size=48)
    return str(videos), records


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init(key, cfg))(jax.random.PRNGKey(5)))
    return cfg, params, from_jax_params(params, device="cpu"), ByteTokenizer()


def _scorers(setup, **kw):
    cfg, params, state, tok = setup
    common = dict(length_buckets=(1024,), gating_pattern=tok.gating_pattern(),
                  **kw)
    return (JaxRewardScorer(cfg, params, tok, attn_impl="xla",
                            dtype=jnp.float32, **common),
            RewardScorer(cfg, state, tok, dtype=torch.float32, **common))


class _Counting:
    """Counts ``score_batch`` calls of the scorer it wraps."""

    def __init__(self, scorer):
        self.scorer, self.calls = scorer, 0

    def __getattr__(self, name):
        return getattr(self.scorer, name)

    def score_batch(self, *a, **kw):
        self.calls += 1
        return self.scorer.score_batch(*a, **kw)


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _assert_margin(a, b=0.0):
    gap = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert gap.min() > MARGIN, gap


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=ATOL, rtol=RTOL)


def _run_preference(mod, scorer, data, path, **kw):
    videos, records = data
    return mod.evaluate_preference(scorer, records, root=videos,
                                   num_segments=SEGMENTS,
                                   results_path=str(path), **kw)


def _preference_run(setup, data, root, dp):
    """Both packages' ``evaluate_preference``: (port result, JAX result,
    port file, JAX file)."""
    jax_scorer, port = _scorers(setup, device_preprocess=dp)
    pf, jf = root / f"port_{dp}.jsonl", root / f"jax_{dp}.jsonl"
    return (_run_preference(tpref, port, data, pf),
            _run_preference(jpref, jax_scorer, data, jf), pf, jf)


@pytest.fixture(scope="module")
def host_tiles_run(setup, data, tmp_path_factory):
    return _preference_run(setup, data, tmp_path_factory.mktemp("pref"),
                           False)


@pytest.mark.parametrize("dp", [False, True],
                         ids=["host_tiles", "device_preprocess"])
def test_evaluate_preference_matches_jax(setup, data, host_tiles_run,
                                         tmp_path, dp):
    got, want, pf, jf = (_preference_run(setup, data, tmp_path, dp) if dp
                         else host_tiles_run)
    rows, ref = _lines(pf), _lines(jf)
    assert [r["id"] for r in rows] == [r["id"] for r in ref] == list(range(N))
    for r, w in zip(rows, ref):
        assert set(r) == set(w)
        assert (r["preference"], r["mask"]) == (w["preference"], w["mask"])
        _close([r["score_0"], r["score_1"]], [w["score_0"], w["score_1"]])
    _assert_margin([r["score_0"] for r in rows], [r["score_1"] for r in rows])
    assert got == want
    assert got["count"] == 2


def test_unequal_frame_sizes_score_each_clip_alone(setup, data):
    """Under ``device_preprocess`` a pair of 64x64 and 48x48 clips cannot
    stack: ``_score_pair`` scores each alone and concatenates fp32 numpy
    fields, equal to JAX's."""
    videos, records = data
    jax_scorer, port = _scorers(setup, device_preprocess=True)
    rec = records[-1]
    pix, ids, gpos = tpref._prepare_pair(port, rec, videos, SEGMENTS, 1)
    assert isinstance(pix, tuple) and pix[0].shape[1:] != pix[1].shape[1:]
    counting = _Counting(port)
    got = tpref._score_pair(counting, pix, ids, gpos)
    assert counting.calls == 2
    want = jpref._score_pair(jax_scorer, pix, ids, gpos)
    for name, a, b in zip(got._fields, got, want):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32, name
        assert a.shape[0] == 2, name
        _close(a, np.asarray(b))


@pytest.mark.parametrize("k", [0, 1, 3])
def test_preference_resume_scores_only_the_rest(setup, data, host_tiles_run,
                                                tmp_path, k):
    """A results file cut after k records plus a torn fragment: the port
    scores the N - k remaining pairs, repairs the torn line, and returns
    the uninterrupted run's result."""
    full, _, pf, _ = host_tiles_run
    lines = Path(pf).read_text().splitlines(keepends=True)
    cut = tmp_path / "cut.jsonl"
    cut.write_text("".join(lines[:k]) + '{"id": 3, "score_0": 0.12')
    counting = _Counting(_scorers(setup)[1])
    assert _run_preference(tpref, counting, data, cut) == full
    assert counting.calls == N - k
    assert sorted(r["id"] for r in tpref.iter_jsonl(str(cut))) == list(
        range(N))


def test_results_files_cross_read(setup, data, host_tiles_run, tmp_path):
    """The port resumes JAX's results file (nothing left to score) and JAX
    resumes the port's file cut after 2 records (two pairs scored)."""
    full, want, pf, jf = host_tiles_run
    jax_scorer, port = _scorers(setup)
    counting = _Counting(port)
    assert _run_preference(tpref, counting, data, jf) == want
    assert counting.calls == 0
    lines = Path(pf).read_text().splitlines(keepends=True)
    cut = tmp_path / "port_cut.jsonl"
    cut.write_text("".join(lines[:2]) + '{"id": 2, "sc')
    counting = _Counting(jax_scorer)
    assert _run_preference(jpref, counting, data, cut) == full
    assert counting.calls == 2
    assert sorted(r["id"] for r in jpref.iter_jsonl(str(cut))) == list(
        range(N))


def _binary_rows_equal(got, want, scores, related):
    """Decision fields exactly, score statistics within ATOL; every related
    score above MARGIN away from the 0 threshold."""
    _assert_margin(np.asarray(scores)[np.asarray(related, bool)])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in STATS} == {
            k: v for k, v in w.items() if k not in STATS}
        _close([g[s] for s in STATS], [w[s] for s in STATS])


def test_evaluate_aspects_matches_jax_and_resumes(setup, data, tmp_path):
    videos, records = data
    jax_scorer, port = _scorers(setup)
    kw = dict(root=videos, num_segments=SEGMENTS)
    got = tpref.evaluate_aspects(port, records,
                                 results_path=str(tmp_path / "p.jsonl"), **kw)
    want = jpref.evaluate_aspects(jax_scorer, records,
                                  results_path=str(tmp_path / "j.jsonl"), **kw)
    rows, ref = _lines(tmp_path / "p.jsonl"), _lines(tmp_path / "j.jsonl")
    assert [r["id"] for r in rows] == [r["id"] for r in ref]
    for r, w in zip(rows, ref):
        assert set(r) == set(w)
        for key in ("rewards_0", "rewards_1", "aspects_0", "aspects_1"):
            _close(r[key], w[key])
    from mjvideo_tpu_torch.data.labels import pair_record_labels

    labels = [pair_record_labels(rec) for rec in records]
    crit = [r[f"rewards_{v}"] for r in rows for v in (0, 1)]
    crel = [lb[f"video_{v}_criteria_related"] for lb in labels for v in (0, 1)]
    asp = [r[f"aspects_{v}"] for r in rows for v in (0, 1)]
    arel = [lb[f"video_{v}_aspect_related"] for lb in labels for v in (0, 1)]
    _binary_rows_equal(got["criteria"], want["criteria"], crit, crel)
    _binary_rows_equal(got["aspects"], want["aspects"], asp, arel)
    # The per-aspect preference: an aspect whose compared pairs all have a
    # margin above MARGIN is held to JAX's row exactly; an aspect with a
    # pair closer than that (a near tie that a difference inside the score
    # tolerance could flip) is held to JAX's count and to the metric of the
    # port's own stored scores only.
    a0 = np.asarray([r["aspects_0"] for r in rows])
    a1 = np.asarray([r["aspects_1"] for r in rows])
    ap = np.stack([lb["aspect_preference"] for lb in labels])
    am = np.stack([lb["aspect_mask"] for lb in labels])
    near = []
    for d, (g, w) in enumerate(zip(got["aspect_preference"],
                                   want["aspect_preference"])):
        m = am[:, d].astype(bool)
        if np.abs(a0[m, d] - a1[m, d]).min(initial=1.0) > MARGIN:
            assert g == w, d
        else:
            near.append(g["name"])
            assert g["count"] == w["count"]
            assert g == {"name": g["name"], **tmetrics.strict_and_tie_aware(
                a0[:, d], a1[:, d], ap[:, d], am[:, d])}
    assert len(near) < len(got["aspect_preference"]), near
    # Resume from the port's file cut after 2 records plus a torn line.
    lines = (tmp_path / "p.jsonl").read_text().splitlines(keepends=True)
    cut = tmp_path / "cut.jsonl"
    cut.write_text("".join(lines[:2]) + '{"id": 2, "rewards_0": [0.1, ')
    counting = _Counting(port)
    again = tpref.evaluate_aspects(counting, records, results_path=str(cut),
                                   **kw)
    assert counting.calls == N - 2
    assert again == got


def test_evaluate_genai_bench_matches_jax(setup, data, tmp_path):
    """Rows built here, one per vote type, ``fetch=None``."""
    videos, records = data
    rows = [{"left_video": f"{videos}/{records[i]['video_0_path']}",
             "right_video": f"{videos}/{records[i]['video_1_path']}",
             "prompt": records[i]["caption"], "vote_type": vote}
            for i, vote in enumerate(("leftvote", "rightvote", "tievote",
                                      "bothbad_vote"))]
    jax_scorer, port = _scorers(setup)
    got = tpref.evaluate_genai_bench(port, rows, num_segments=SEGMENTS,
                                     results_path=str(tmp_path / "p.jsonl"))
    want = jpref.evaluate_genai_bench(jax_scorer, rows,
                                      num_segments=SEGMENTS,
                                      results_path=str(tmp_path / "j.jsonl"))
    p, j = _lines(tmp_path / "p.jsonl"), _lines(tmp_path / "j.jsonl")
    assert [r["vote_type"] for r in p] == [r["vote_type"] for r in j]
    left = [r["score_left"] for r in p]
    right = [r["score_right"] for r in p]
    _close(left + right, [r["score_left"] for r in j]
           + [r["score_right"] for r in j])
    _assert_margin(left, right)
    _assert_margin(left + right)
    assert got == want and got["total"] == 4


def test_filter_safesora_pairs_matches_jax():
    # The record shape of make_sample_data.make_safesora_record, unanimous
    # and not, built here without videos.
    recs = []
    for i in range(6):
        win = ("video_0", "video_1")[i % 2]
        other = ("video_1", "video_0")[i % 2]
        recs.append({
            "prompt_text": f"prompt {i}",
            "video_0": {"video_path": f"a{i}.mp4"},
            "video_1": {"video_path": f"b{i}.mp4"},
            "helpfulness": win,
            "harmlessness": win if i != 2 else other,
            "sub_preferences": {"aesthetics": win if i != 4 else other,
                                "correctness": win},
        })
    recs.append({"prompt_text": "no votes", "video_0": {"video_path": "x"},
                 "video_1": {"video_path": "y"}})
    got = tpref.filter_safesora_pairs(recs)
    assert got == jpref.filter_safesora_pairs(recs)
    assert [r["caption"] for r in got] == ["prompt 0", "prompt 1",
                                           "prompt 3", "prompt 5"]


# ------------------------------------------------------------------ judges

class ScriptedJudge:
    """Fixed answers: the rating of a (prompt, video) is looked up from the
    video's name and the prompt's length, so every question gets its own
    scripted answer."""

    LEVELS = ("Poor", "Good", "Average", "Excellent", "Very Poor",
              "Above Average")

    def __init__(self):
        self.asked = []

    def answer(self, prompt, video):
        key = (len(prompt) + sum(map(ord, Path(video).name))) % len(
            self.LEVELS)
        return f"RATING: {self.LEVELS[key]}"

    def ask_batch(self, prompt, videos):
        self.asked.append((prompt, tuple(videos)))
        return [self.answer(prompt, v) for v in videos]


def _stub_records(data):
    return data[1][:4]


def test_stub_judge_overall_driver_matches_jax(data, tmp_path):
    videos, _ = data
    records = _stub_records(data)
    got = tjudges.run_overall_benchmark(ScriptedJudge(), records, root=videos,
                                        results_path=str(tmp_path / "p.jsonl"))
    want = jjudges.run_overall_benchmark(
        ScriptedJudge(), records, root=videos,
        results_path=str(tmp_path / "j.jsonl"))
    assert got == want
    assert _lines(tmp_path / "p.jsonl") == _lines(tmp_path / "j.jsonl")
    # The metrics by hand, from the scripted ratings.
    from mjvideo_tpu_torch.eval.judges import RATING_SCALE, overall_prompt

    judge = ScriptedJudge()
    s = [[RATING_SCALE[judge.answer(overall_prompt(r["caption"]),
                                    r[f"video_{v}_path"])[8:]]
          for v in (0, 1)] for r in records]
    prefs = [{"Video 1 better": 0, "Video 2 better": 1}.get(
        r["overall_preference"]) for r in records]
    decided = [(a, b, p) for (a, b), p in zip(s, prefs) if p is not None]
    correct = sum((0 if a > b else 1) == p for a, b, p in decided)
    strict = sum((a > b) if p == 0 else (b > a) for a, b, p in decided)
    ties = sum(a == b for a, b, _ in decided)
    assert got["count"] == len(decided)
    assert got["correct"] == correct
    assert got["strict"] == strict / len(decided)
    assert got["tie_aware"] == (strict + 0.5 * ties) / len(decided)


def test_stub_judge_fine_grained_driver_matches_jax(data, tmp_path):
    videos, _ = data
    records = _stub_records(data)[:2]
    judge = ScriptedJudge()
    got = tjudges.run_fine_grained_benchmark(
        judge, records, root=videos, results_path=str(tmp_path / "p.jsonl"))
    want = jjudges.run_fine_grained_benchmark(
        ScriptedJudge(), records, root=videos,
        results_path=str(tmp_path / "j.jsonl"))
    assert got == want
    rubric = tjudges.FINE_GRAINED_RUBRIC
    per_pair = len(rubric) + sum(len(c["subcategories"])
                                 for c in rubric.values())
    assert len(judge.asked) == per_pair * len(records) == 66
    acc = tjudges.fine_grained_accuracy(got)
    assert acc == jjudges.fine_grained_accuracy(want)
    for th in (3, 7):
        assert (tjudges.fine_grained_accuracy(got, th)
                == jjudges.fine_grained_accuracy(want, th))
    # Resume: a file cut after the first pair asks only the second's.
    lines = (tmp_path / "p.jsonl").read_text().splitlines(keepends=True)
    (tmp_path / "cut.jsonl").write_text(lines[0] + '{"id": 1, "capt')
    judge = ScriptedJudge()
    again = tjudges.run_fine_grained_benchmark(
        judge, records, root=videos, results_path=str(tmp_path / "cut.jsonl"))
    assert len(judge.asked) == per_pair and again == got


def test_stub_judge_genai_driver_matches_jax(data, tmp_path):
    videos, records = data
    rows = [{"left_video": r["video_0_path"], "right_video": r["video_1_path"],
             "prompt": r["caption"], "vote_type": vote}
            for r, vote in zip(records, ("leftvote", "rightvote", "tievote",
                                         "bothbad_vote"))]
    got = tjudges.run_genai_benchmark(ScriptedJudge(), rows,
                                      results_path=str(tmp_path / "p.jsonl"))
    want = jjudges.run_genai_benchmark(ScriptedJudge(), rows,
                                       results_path=str(tmp_path / "j.jsonl"))
    assert got == want and got["total"] == 4
    assert _lines(tmp_path / "p.jsonl") == _lines(tmp_path / "j.jsonl")
    assert "prefer_same_accuracy" in got


@pytest.fixture(scope="module")
def chat(setup):
    ch = tiny_test_config().chat
    params = jax_chat_init(jax.random.PRNGKey(1), ch, with_lm_head=True)
    return ch, params, from_jax_params(params, device="cpu")


def _judges(chat, **kw):
    ch, jp, tp = chat
    tok = ByteTokenizer()
    common = dict(num_segments=SEGMENTS, max_new_tokens=6, **kw)
    return (jjudges.InternVLJudge(ch, jp, tok, attn_impl="xla", **common),
            tjudges.InternVLJudge(ch, tp, tok, **common))


def test_internvl_judge_overall_driver_matches_jax(chat, data, tmp_path):
    """Two records through ``run_overall_benchmark`` on the port's judge and
    on JAX's: the answers, ratings and metrics equal."""
    videos, records = data
    jax_judge, judge = _judges(chat)
    got = tjudges.run_overall_benchmark(judge, records[:2], root=videos,
                                        results_path=str(tmp_path / "p.jsonl"))
    want = jjudges.run_overall_benchmark(
        jax_judge, records[:2], root=videos,
        results_path=str(tmp_path / "j.jsonl"))
    assert _lines(tmp_path / "p.jsonl") == _lines(tmp_path / "j.jsonl")
    assert got == want


def test_internvl_judge_fine_grained_and_genai_match_jax(chat, data,
                                                         tmp_path):
    """One record through ``run_fine_grained_benchmark`` on a rubric of one
    category and two subcategories, and two GenAI rows, on both judges."""
    videos, records = data
    cat = tjudges.FINE_GRAINED_RUBRIC["Safety"]
    rubric = {"Safety": {"description": cat["description"],
                         "subcategories": dict(list(
                             cat["subcategories"].items())[:2])}}
    jax_judge, judge = _judges(chat)
    got = tjudges.run_fine_grained_benchmark(judge, records[:1], root=videos,
                                             rubric=rubric)
    want = jjudges.run_fine_grained_benchmark(jax_judge, records[:1],
                                              root=videos, rubric=rubric)
    assert got == want
    assert (tjudges.fine_grained_accuracy(got)
            == jjudges.fine_grained_accuracy(want))
    rows = [{"left_video": f"{videos}/{r['video_0_path']}",
             "right_video": f"{videos}/{r['video_1_path']}",
             "prompt": r["caption"], "vote_type": v}
            for r, v in zip(records[:2], ("leftvote", "tievote"))]
    assert (tjudges.run_genai_benchmark(judge, rows)
            == jjudges.run_genai_benchmark(jax_judge, rows))


# -------------------------------------------------------- Trainer.evaluate

def test_trainer_evaluate_matches_jax(setup, data, tmp_path, monkeypatch):
    """The port's ``Trainer.evaluate`` against JAX's on the same collated
    batches and bridged weights: the forward runs without autograd (no
    backward), at ``tc.attn_impl``, and the parameters are unchanged."""
    from mjvideo_tpu.train.trainer import TrainConfig as JaxTC
    from mjvideo_tpu.train.trainer import Trainer as JaxTrainer
    from mjvideo_tpu_torch.train import trainer as ttrainer

    cfg, params, state, tok = setup
    videos, records = data
    path = tmp_path / "pairs.json"
    path.write_text(json.dumps(records))
    ds = tds.PreferencePairDataset(str(path), tok, cfg.chat, root=videos,
                                   num_segments=SEGMENTS,
                                   gating_pattern=tok.gating_pattern())
    batches = list(tds.batched(ds, tds.PairCollator(0, 512), 2))
    assert len(batches) == 2
    want = JaxTrainer(cfg, params, JaxTC(
        stage=3, attn_impl="xla", mesh_data_axis=1,
        checkpoint_dir=str(tmp_path / "j"))).evaluate(batches)
    tr = ttrainer.Trainer(cfg, state, ttrainer.TrainConfig(
        stage=3, attn_impl="auto", checkpoint_dir=str(tmp_path / "p")))
    before = {k: v.clone() for k, v in ttrainer.flatten_state(tr.params)
              .items()}
    seen, outs = [], []
    forward = ttrainer.reward_forward

    def spy(*a, **kw):
        out = forward(*a, **kw)
        seen.append((torch.is_grad_enabled(), kw["impl"], kw["remat"],
                     out.score.requires_grad))
        outs.append(out)
        return out

    monkeypatch.setattr(ttrainer, "reward_forward", spy)
    got = tr.evaluate(batches)
    assert seen == [(False, "auto", False, False)] * 4
    for k, v in ttrainer.flatten_state(tr.params).items():
        assert torch.equal(v, before[k]), k
    # Margins of every comparison the metrics make (outs: batch 0 video 0,
    # video 1, batch 1 video 0, video 1).
    s0 = torch.cat([outs[0].score, outs[2].score]).numpy()
    s1 = torch.cat([outs[1].score, outs[3].score]).numpy()
    mask = np.concatenate([b["overall_mask"].reshape(-1)
                           for b in batches]).astype(bool)
    _assert_margin(s0[mask], s1[mask])
    rel = {"rewards": "criteria_related", "aspect_scores": "aspect_related"}
    for field, key in rel.items():
        vals = torch.cat([getattr(o, field) for o in outs]).numpy()
        related = np.concatenate([b[f"video_{v}_{key}"] for b in batches
                                  for v in (0, 1)])
        _assert_margin(vals[related.astype(bool)])
    assert got["preference"] == want["preference"]
    assert got["preference"]["count"] == 2
    for key in ("criteria", "aspects"):
        for g, w in zip(got[key], want[key]):
            assert {k: v for k, v in g.items() if k not in STATS} == {
                k: v for k, v in w.items() if k not in STATS}
            _close([g[s] for s in STATS], [w[s] for s in STATS])
    logged = _lines(tmp_path / "p" / "metrics.jsonl")
    assert logged == [{"step": 0, "eval": json.loads(json.dumps(got))}]
