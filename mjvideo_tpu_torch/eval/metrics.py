"""Evaluation metrics: the port's own copy of ``mjvideo_tpu/eval/metrics.py``.

The metric computations of the reference trainers and eval scripts:
per-dimension confusion and statistics (``criteria_train.py:107-316``,
``overall_train.py:204-306``), pairwise preference accuracy
(``overall_train.py:390-442``), the leaderboard's strict and tie-aware
columns, and GenAI-Bench vote scoring (``eval_genai_mjvideo.py:140-165``).
Inputs are numpy arrays (the drivers move scores off the device first);
outputs are plain, JSONL-ready dicts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def binary_dimension_metrics(
    scores: np.ndarray,  # (N, D) raw rewards
    targets: np.ndarray,  # (N, D) ground truth in {1, -1/0}
    related: np.ndarray,  # (N, D) 1 = labeled
    names: Optional[Sequence[str]] = None,
    threshold: float = 0.0,
) -> List[Dict]:
    """Per-dimension TP/FP/TN/FN, accuracy, precision, recall, F1 and the
    scores' min/max/mean/std over the related entries: prediction = score
    > ``threshold``, positive class = target == 1
    (``criteria_train.py:107-316``)."""
    scores = np.asarray(scores, np.float64)
    targets = np.asarray(targets, np.float64)
    related = np.asarray(related, bool)
    out = []
    for d in range(scores.shape[1]):
        m = related[:, d]
        s, t = scores[m, d], targets[m, d]
        pred_pos = s > threshold
        true_pos = t == 1
        tp = int(np.sum(pred_pos & true_pos))
        fp = int(np.sum(pred_pos & ~true_pos))
        tn = int(np.sum(~pred_pos & ~true_pos))
        fn = int(np.sum(~pred_pos & true_pos))
        n = tp + fp + tn + fn
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        out.append({
            "dimension": names[d] if names else str(d),
            "tp": tp, "fp": fp, "tn": tn, "fn": fn, "count": n,
            "accuracy": (tp + tn) / n if n else 0.0,
            "precision": prec,
            "recall": rec,
            "f1": 2 * prec * rec / (prec + rec) if prec + rec else 0.0,
            "min": float(s.min()) if s.size else 0.0,
            "max": float(s.max()) if s.size else 0.0,
            "mean": float(s.mean()) if s.size else 0.0,
            "std": float(s.std()) if s.size else 0.0,
        })
    return out


def preference_accuracy(
    score0: np.ndarray,  # (N,)
    score1: np.ndarray,  # (N,)
    preference: np.ndarray,  # (N,) 0 = video0 better, 1 = video1 better
    mask: np.ndarray,  # (N,) 1 = decided pair
) -> Dict[str, float]:
    """Masked pairwise accuracy (``overall_train.py:426-434``): the
    prediction is 1 unless score0 > score1."""
    score0 = np.asarray(score0, np.float64)
    score1 = np.asarray(score1, np.float64)
    predict = (~(score0 > score1)).astype(np.int64)
    mask = np.asarray(mask, bool)
    correct = int(np.sum((predict == np.asarray(preference)) & mask))
    count = int(np.sum(mask))
    return {
        "accuracy": correct / count if count else 0.0,
        "correct": correct,
        "count": count,
    }


def strict_and_tie_aware(
    score0: np.ndarray,
    score1: np.ndarray,
    preference: np.ndarray,  # 0 = video0 better, 1 = video1 better
    mask: np.ndarray,  # 1 = decided pair (label side)
) -> Dict[str, float]:
    """The leaderboard's two preference columns (``README.md:166-168``):
    *strict* counts a tie (equal scores) as wrong, *tie-aware* credits it
    0.5.  Undecided pairs of the labels are masked out."""
    s0 = np.asarray(score0, np.float64)
    s1 = np.asarray(score1, np.float64)
    pref = np.asarray(preference)
    m = np.asarray(mask, bool)
    win0 = s0 > s1
    win1 = s1 > s0
    correct = np.where(pref == 0, win0, win1)
    tie = ~(win0 | win1)
    count = int(np.sum(m))
    strict = float(np.sum(correct & m))
    tie_aware = strict + 0.5 * float(np.sum(tie & m))
    return {
        "strict": strict / count if count else 0.0,
        "tie_aware": tie_aware / count if count else 0.0,
        "ties": int(np.sum(tie & m)),
        "count": count,
    }


def _genai_vote_metrics(
    score_left: np.ndarray,
    score_right: np.ndarray,
    vote_types: Sequence[str],
    good_threshold: float,
    tie_credit: Optional[float],
) -> Dict[str, float]:
    """GenAI-Bench vote scoring: left/right votes compare the scores, a tie
    vote needs both videos 'good' (score > ``good_threshold``), a bothbad
    vote both 'bad'.  ``tie_credit`` (the judges') adds a prefer_same
    accuracy that credits equal scores on decided votes."""
    prefer_truth = prefer_same = prefer_total = truth = total = 0.0
    for sl, sr, vote in zip(score_left, score_right, vote_types):
        lg, rg = sl > good_threshold, sr > good_threshold
        if vote in ("rightvote", "leftvote"):
            prefer_total += 1
            total += 1
            win = sr > sl if vote == "rightvote" else sr < sl
            if win:
                prefer_truth += 1
                prefer_same += 1
                truth += 1
            elif sr == sl and tie_credit:
                prefer_same += tie_credit
        elif vote == "bothbad_vote":
            total += 1
            if not lg and not rg:
                truth += 1
        elif vote == "tievote":
            total += 1
            if lg and rg:
                truth += 1
    out = {
        "prefer_accuracy": prefer_truth / prefer_total if prefer_total else 0.0,
        "accuracy": truth / total if total else 0.0,
        "prefer_total": int(prefer_total),
        "total": int(total),
    }
    if tie_credit is not None:
        out["prefer_same_accuracy"] = (
            prefer_same / prefer_total if prefer_total else 0.0)
    return out


def genai_bench_metrics(
    score_left: np.ndarray,
    score_right: np.ndarray,
    vote_types: Sequence[str],
) -> Dict[str, float]:
    """GenAI-Bench accuracy of the reward model
    (``eval_genai_mjvideo.py:140-165``): good = reward score > 0."""
    return _genai_vote_metrics(score_left, score_right, vote_types,
                               good_threshold=0, tie_credit=None)


def genai_judge_metrics(
    score_left: np.ndarray,
    score_right: np.ndarray,
    vote_types: Sequence[str],
    good_threshold: float = 5,
) -> Dict[str, float]:
    """GenAI-Bench accuracy of a rating-scale judge
    (``eval_genai_internvl2_2b.py:176-212``): good = rating > 5, and 0.5
    prefer_same credit when the judge rates both videos equally."""
    return _genai_vote_metrics(score_left, score_right, vote_types,
                               good_threshold=good_threshold, tie_credit=0.5)


def genai_videoscore_metrics(
    score_left: np.ndarray,
    score_right: np.ndarray,
    vote_types: Sequence[str],
) -> Dict[str, float]:
    """GenAI-Bench accuracy of the VideoScore baseline
    (``eval_genai_videoScore.py:176-202``): good = summed 5-dim score > 2,
    left/right votes compared strictly, no tie credit."""
    return _genai_vote_metrics(score_left, score_right, vote_types,
                               good_threshold=2, tie_credit=None)


def tie_aware_pair_score(
    pred: str, gt: str, tie_value: float = 0.5
) -> float:
    """Tie-aware credit of the baseline GenAI evals
    (``eval_genai_internvl2_2b.py:182-212``): exact match = 1, a one-sided
    tie = ``tie_value``, else 0."""
    if pred == gt:
        return 1.0
    if "tie" in (pred, gt):
        return tie_value
    return 0.0
