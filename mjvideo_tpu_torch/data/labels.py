"""Label and preference encodings of the MJ-BENCH-VIDEO pairwise dataset:
the port's own copy of ``mjvideo_tpu/data/labels.py``.

Replaces ``process_labels`` (``scripts/data_processor/dataset.py:52-85``) and
``deal_preference`` (``dataset.py:87-112``), with their conventions
(SURVEY.md section 0):

* per-criteria value 1 = good/relevant -> score 1, related 1
* value 2 = bad/relevant -> score -1 (mse mode) or 0 (logistic), related 1
* anything else = irrelevant -> score 0, related 0
* 'Video 1 better' -> preference 0; 'Video 2 better' -> 1;
  'Same'/'Hard to judge'/other -> preference 1 with mask 0.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import numpy as np


def encode_label_value(value: int, mse: bool = True) -> Tuple[float, int]:
    """One annotation value -> (score, related)."""
    if value == 1:
        return 1.0, 1
    if value == 2:
        return (-1.0 if mse else 0.0), 1
    return 0.0, 0


def process_labels(
    labels: Union[Mapping[str, int], int],
    mse: bool = True,
    overall: bool = False,
) -> Tuple[List[float], List[int], List[str]]:
    """(scores, relateds, label_names); ``overall=True`` takes a scalar."""
    if overall:
        s, r = encode_label_value(labels, mse)
        return [s], [r], []
    scores, relateds, names = [], [], []
    for key, value in labels.items():
        s, r = encode_label_value(value, mse)
        names.append(key)
        scores.append(s)
        relateds.append(r)
    return scores, relateds, names


def encode_preference(value: str) -> Tuple[int, int]:
    """One preference string -> (preference, mask)."""
    if value == "Video 1 better":
        return 0, 1
    if value == "Video 2 better":
        return 1, 1
    return 1, 0


def deal_preference(
    labels: Union[Mapping[str, str], str], overall: bool = False
) -> Tuple[List[int], List[int]]:
    """(preferences, masks); ``overall=True`` takes a scalar string."""
    if overall:
        p, m = encode_preference(labels)
        return [p], [m]
    prefs, masks = [], []
    for value in labels.values():
        p, m = encode_preference(value)
        prefs.append(p)
        masks.append(m)
    return prefs, masks


def pair_record_labels(item: Dict, mse: bool = True) -> Dict[str, np.ndarray]:
    """One ``datas/*.json`` pair record -> flat numpy label arrays.

    The per-item label block of ``VideoDataset.__iter__``
    (``dataset.py:326-355``), with its label-name symmetry checks.
    """
    out: Dict[str, np.ndarray] = {}
    for v in (0, 1):
        c_scores, c_rel, c_names = process_labels(item[f"video_{v}_label"], mse)
        a_scores, a_rel, a_names = process_labels(
            item[f"video_{v}_overall_score"], mse)
        t_score, t_rel, _ = process_labels(
            item[f"video_{v}_total_score"], mse, overall=True)
        out[f"video_{v}_criteria_score"] = np.asarray(c_scores, np.float32)
        out[f"video_{v}_criteria_related"] = np.asarray(c_rel, np.float32)
        out[f"video_{v}_aspect_score"] = np.asarray(a_scores, np.float32)
        out[f"video_{v}_aspect_related"] = np.asarray(a_rel, np.float32)
        # The reference collator's batch keys (``dataset.py:539-540``): the
        # scalar total score ships as "overall_score".
        out[f"video_{v}_overall_score"] = np.asarray(t_score, np.float32)
        out[f"video_{v}_overall_related"] = np.asarray(t_rel, np.float32)
        if v == 0:
            names0, anames0 = c_names, a_names
        else:
            assert c_names == names0, "criteria label order mismatch"
            assert a_names == anames0, "aspect label order mismatch"

    aspect_pref, aspect_mask = deal_preference(item["category_preference"])
    overall_pref, overall_mask = deal_preference(
        item["overall_preference"], overall=True)
    out["aspect_preference"] = np.asarray(aspect_pref, np.int32)
    out["aspect_mask"] = np.asarray(aspect_mask, np.float32)
    out["overall_preference"] = np.asarray(overall_pref, np.int32)
    out["overall_mask"] = np.asarray(overall_mask, np.float32)
    return out
