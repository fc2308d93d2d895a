"""Benchmark drivers: MJ-BENCH-VIDEO preference and aspect evaluation,
SafeSora and GenAI-Bench; the port's own copy of
``mjvideo_tpu/eval/preference.py``.

Replaces the MJ-Video eval scripts (``eval_genai_mjvideo.py``, the
``CustomTrainer.evaluate``/``evaluate_aspect`` overrides in
``overall_train.py:204-442``) and the SafeSora pair filter
(``eval_safesora_internvl2_2b.py:95-108``).  Results persist to JSONL one
record at a time (evaluations are long and may crash), and a rerun scores
only what the file does not hold yet; the file format is the JAX
package's, so either package resumes the other's file.

Clips are decoded and tokenized on the host in a ``data.dataset.prefetch``
thread (``RewardScorer.prepare_clip`` returns numpy); every device call
stays on the calling thread.  Scores leave the device as fp32 numpy before
any metric sees them.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from ..configs import ASPECT_NAMES, CRITERIA_NAMES
from ..data.dataset import prefetch
from ..data.labels import deal_preference, pair_record_labels
from ..models.reward import RewardOutput
from .metrics import (
    binary_dimension_metrics,
    genai_bench_metrics,
    preference_accuracy,
    strict_and_tie_aware,
)


def iter_jsonl(path: str):
    """The parsed records of a results JSONL, skipping torn lines: a crashed
    run can leave a truncated last line, which the writer's resume path
    re-scores, so every reader of these files skips it too."""
    with open(path) as f:
        for line in f:
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                pass


class IncrementalWriter:
    """Append-only JSONL results with resume.

    ``records`` holds the earlier runs' rows by id, so that a driver reuses
    the stored scores of items it has seen (the labels side of a metric is
    recomputed from the records; only decode and scoring are skipped)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.done = set()
        self.records: Dict = {}
        if path and os.path.exists(path):
            for r in iter_jsonl(path):
                self.done.add(r.get("id"))
                self.records[r.get("id")] = r
            # A crash mid-write leaves a torn last line without a newline;
            # an append would glue the next record onto it.  End the
            # fragment so that appends start clean (``iter_jsonl`` then
            # skips the fragment as a line of its own).
            with open(path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        f.write(b"\n")

    def seen(self, item_id) -> bool:
        return item_id in self.done

    def write(self, record: Dict) -> None:
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record, default=float) + "\n")
        self.done.add(record.get("id"))


def _pair_pixels(p0, p1):
    """One concatenated pixel batch when the clips' arrays stack, else the
    pair as it is: under ``device_preprocess`` the scorer takes the frames
    at their own resolution, and two generators' clips may differ."""
    if p0.shape[1:] == p1.shape[1:]:
        return np.concatenate([p0, p1], axis=0)
    return (p0, p1)


def _numpy_output(out: RewardOutput) -> RewardOutput:
    """A ``RewardOutput`` of device tensors (bf16 on the card) -> fp32
    numpy."""
    return RewardOutput(*(f.float().cpu().numpy() for f in out))


def _score_pair(scorer, pixels, ids, gpos) -> RewardOutput:
    """``score_batch`` over a pair, each clip on its own where the frame
    shapes differ (each then gets its own device grid); fp32 numpy."""
    if not isinstance(pixels, tuple):
        return _numpy_output(scorer.score_batch(pixels, ids, gpos))
    outs = [_numpy_output(scorer.score_batch(p, ids[v:v + 1],
                                             list(gpos)[v:v + 1]))
            for v, p in enumerate(pixels)]
    return RewardOutput(*(np.concatenate(fields) for fields in zip(*outs)))


def _prepare_pair(scorer, item, root, num_segments, max_num):
    """(pixels, ids, gating positions) of a record's two clips, on the
    host."""
    clips = [scorer.prepare_clip(
        os.path.join(root, item[f"video_{v}_path"]), item["caption"],
        num_segments=num_segments, max_num=max_num) for v in (0, 1)]
    (p0, i0, g0), (p1, i1, g1) = clips
    return _pair_pixels(p0, p1), [i0, i1], [g0, g1]


def _preference_result(s0s, s1s, prefs, masks) -> Dict[str, float]:
    """Preference accuracy plus the leaderboard's strict and tie-aware
    columns."""
    s0, s1 = np.asarray(s0s, np.float64), np.asarray(s1s, np.float64)
    res = preference_accuracy(s0, s1, np.asarray(prefs), np.asarray(masks))
    sta = strict_and_tie_aware(s0, s1, np.asarray(prefs), np.asarray(masks))
    res.update(strict=sta["strict"], tie_aware=sta["tie_aware"],
               ties=sta["ties"])
    return res


def evaluate_preference(
    scorer,
    records: Iterable[Dict],
    root: str = "",
    num_segments: int = 8,
    max_num: int = 1,
    results_path: Optional[str] = None,
) -> Dict[str, float]:
    """Pairwise overall-preference accuracy over MJ-BENCH-VIDEO records
    (``overall_train.py:390-442``, undecided pairs masked); ``scorer`` is a
    ``RewardScorer``."""
    writer = IncrementalWriter(results_path)

    def prepared():
        for i, item in enumerate(records):
            if writer.seen(i):
                continue
            pref, mask = deal_preference(item["overall_preference"],
                                         overall=True)
            yield (i, pref[0], mask[0],
                   *_prepare_pair(scorer, item, root, num_segments, max_num))

    s0s, s1s, prefs, masks = [], [], [], []
    for i, pref, mask, pixels, ids, gpos in prefetch(prepared(), 2):
        scores = _score_pair(scorer, pixels, ids, gpos).score
        rec = {"id": i, "score_0": float(scores[0]),
               "score_1": float(scores[1]), "preference": pref, "mask": mask}
        writer.write(rec)
        s0s.append(rec["score_0"])
        s1s.append(rec["score_1"])
        prefs.append(pref)
        masks.append(mask)
    if results_path and os.path.exists(results_path):
        # The file holds this run's records and the earlier runs'.
        s0s, s1s, prefs, masks = [], [], [], []
        for r in iter_jsonl(results_path):
            s0s.append(r["score_0"])
            s1s.append(r["score_1"])
            prefs.append(r["preference"])
            masks.append(r["mask"])
    return _preference_result(s0s, s1s, prefs, masks)


def evaluate_aspects(
    scorer,
    records: Iterable[Dict],
    root: str = "",
    num_segments: int = 8,
    max_num: int = 1,
    results_path: Optional[str] = None,
) -> Dict[str, List[Dict]]:
    """Per-criteria and per-aspect binary metrics over both videos of each
    pair (``overall_train.py:204-306`` / ``criteria_train.py:107-316``),
    and the per-aspect pairwise preference."""
    writer = IncrementalWriter(results_path)
    crit_scores, crit_gt, crit_rel = [], [], []
    asp_scores, asp_gt, asp_rel = [], [], []
    asp0, asp1, apref, amask = [], [], [], []

    def prepared():
        for i, item in enumerate(records):
            labels = pair_record_labels(item)
            if writer.seen(i):
                # Resume: the stored scores are reused, the labels recomputed.
                yield i, labels, None, None, None
                continue
            yield (i, labels,
                   *_prepare_pair(scorer, item, root, num_segments, max_num))

    for i, labels, pixels, ids, gpos in prefetch(prepared(), 2):
        if pixels is None:
            stored = writer.records[i]
            r0, r1 = (
                {"rewards": np.asarray(stored[f"rewards_{b}"], np.float32),
                 "aspect_scores": np.asarray(stored[f"aspects_{b}"],
                                             np.float32)}
                for b in (0, 1))
        else:
            out = _score_pair(scorer, pixels, ids, gpos)
            r0, r1 = ({"rewards": out.rewards[b],
                       "aspect_scores": out.aspect_scores[b]} for b in (0, 1))
        for v, r in ((0, r0), (1, r1)):
            crit_scores.append(r["rewards"])
            crit_gt.append(labels[f"video_{v}_criteria_score"])
            crit_rel.append(labels[f"video_{v}_criteria_related"])
            asp_scores.append(r["aspect_scores"])
            asp_gt.append(labels[f"video_{v}_aspect_score"])
            asp_rel.append(labels[f"video_{v}_aspect_related"])
        asp0.append(r0["aspect_scores"])
        asp1.append(r1["aspect_scores"])
        apref.append(labels["aspect_preference"])
        amask.append(labels["aspect_mask"])
        if pixels is not None:  # resumed items are already in the file
            writer.write({
                "id": i,
                "rewards_0": r0["rewards"].tolist(),
                "rewards_1": r1["rewards"].tolist(),
                "aspects_0": r0["aspect_scores"].tolist(),
                "aspects_1": r1["aspect_scores"].tolist(),
            })
    if not crit_scores:  # no records (e.g. every one filtered out)
        return {"criteria": [], "aspects": [], "aspect_preference": []}
    # The per-aspect pairwise preference (the leaderboard's per-aspect
    # "(strict)" columns, README.md:150-161): the two videos' aspect scores
    # against the per-aspect preference labels.
    a0, a1 = np.stack(asp0), np.stack(asp1)
    ap, am = np.stack(apref), np.stack(amask)
    aspect_pref_rows = [
        {"name": name, **strict_and_tie_aware(a0[:, d], a1[:, d], ap[:, d],
                                              am[:, d])}
        for d, name in enumerate(ASPECT_NAMES)]
    return {
        "criteria": binary_dimension_metrics(
            np.stack(crit_scores), np.stack(crit_gt), np.stack(crit_rel),
            names=CRITERIA_NAMES),
        "aspects": binary_dimension_metrics(
            np.stack(asp_scores), np.stack(asp_gt), np.stack(asp_rel),
            names=ASPECT_NAMES),
        "aspect_preference": aspect_pref_rows,
    }


def genai_driver(
    pair_scorer: Callable[[str, str, str], Dict],
    examples: Iterable[Dict],
    results_path: Optional[str] = None,
    fetch: Optional[Callable[[str], str]] = None,
):
    """The GenAI-Bench loop shared by the reward scorer and the judges:
    skip persisted ids, fetch the videos, score the pair with
    ``pair_scorer(left, right, prompt) -> record`` (holding ``score_left``
    and ``score_right``), persist it, and on resume read the file back so
    that the result covers every run.

    Returns (score_left array, score_right array, vote_types list).
    """
    writer = IncrementalWriter(results_path)
    lefts, rights, votes = [], [], []
    for i, ex in enumerate(examples):
        if writer.seen(i):
            continue
        left = fetch(ex["left_video"]) if fetch else ex["left_video"]
        right = fetch(ex["right_video"]) if fetch else ex["right_video"]
        rec = dict(pair_scorer(left, right, ex["prompt"]))
        rec["id"] = i
        rec["vote_type"] = ex["vote_type"]
        writer.write(rec)
        lefts.append(rec["score_left"])
        rights.append(rec["score_right"])
        votes.append(rec["vote_type"])
    if results_path and os.path.exists(results_path):
        lefts, rights, votes = [], [], []
        for r in iter_jsonl(results_path):
            lefts.append(r["score_left"])
            rights.append(r["score_right"])
            votes.append(r["vote_type"])
    return (np.asarray(lefts, np.float64), np.asarray(rights, np.float64),
            votes)


def evaluate_genai_bench(
    scorer,
    examples: Iterable[Dict],
    num_segments: int = 8,
    max_num: int = 1,
    results_path: Optional[str] = None,
    fetch: Optional[Callable[[str], str]] = None,
) -> Dict[str, float]:
    """GenAI-Bench video_generation eval (``eval_genai_mjvideo.py:119-165``).

    ``examples`` yield {left_video, right_video, prompt, vote_type};
    ``fetch`` maps remote paths to local files (e.g.
    ``data.video.fetch_remote_video``).
    """
    def pair_scorer(left, right, prompt):
        rl, rr = scorer.score_pair(left, right, prompt,
                                   num_segments=num_segments, max_num=max_num)
        return {"score_left": float(rl["score"]),
                "score_right": float(rr["score"])}

    lefts, rights, votes = genai_driver(pair_scorer, examples,
                                        results_path=results_path,
                                        fetch=fetch)
    return genai_bench_metrics(lefts, rights, votes)


def filter_safesora_pairs(records: Iterable[Dict]) -> List[Dict]:
    """The SafeSora-test filter and schema conversion: keep the pairs where
    helpfulness, harmlessness and every sub-preference agree
    (``eval_safesora_internvl2_2b.py:95-108``), and convert the SafeSora
    record (``prompt_text``, ``video_{0,1}.video_path``, preferences
    'video_0'/'video_1') into the pair-record schema of the other
    drivers."""
    out = []
    for r in records:
        prefs = r.get("sub_preferences", {})
        h = r.get("helpfulness")
        harm = r.get("harmlessness")
        if h is None or harm is None or h != harm:
            continue
        if not all(v == h for v in prefs.values()):
            continue
        out.append({
            "caption": r["prompt_text"],
            "video_0_path": r["video_0"]["video_path"],
            "video_1_path": r["video_1"]["video_path"],
            "overall_preference": (
                "Video 1 better" if h == "video_0" else "Video 2 better"),
        })
    return out
