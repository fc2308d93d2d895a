"""Training losses for the three-stage pipeline.

Counterpart of ``mjvideo_tpu/train/losses.py`` (reference
``scripts/train/criteria_train.py:67-105`` for stage 1,
``aspect_train.py:66-167`` for stage 2, ``overall_train.py:67-202`` for
stage 3), with the reference's normalisation quirks kept: the BCE terms are
sums, not means; the MSE divides by the element count inside the sum; the
aspect and stage-2 Bradley-Terry terms are normalised by the mask count, the
stage-3 overall one is a plain sum; gating sparsity is normalised by the
batch size.  Everything is computed in fp32, and the reference's ``.item()``
guards become ``torch.where``.

Under data parallelism each data shard computes its part of the loss, and
the parts sum to the whole batch's loss (JAX's GSPMD keeps global
semantics): every normaliser takes the whole batch's count or size
(``totals``, from ``batch_totals`` of each shard summed over the data axis
once a step), not the shard's.  The stage-3 overall Bradley-Terry term
keeps the reference's broadcast of the (B,) scores against the (B, 1)
preference and mask, a sum over every (label row, score row) pair of the
batch, so a shard's part pairs its own scores with the whole batch's
labels (``WHOLE_BATCH_KEYS``, gathered over the data axis).
``totals=None`` is the whole batch here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

# Per-criteria focal alpha table (``criteria_train.py:67-69``).
FOCAL_ALPHA_CRITERIA: Tuple[float, ...] = (
    0.35, 0.35, 0.35, 0.35, 0.35, 0.5, 0.6, 0.6, 0.65, 0.65, 0.35, 0.65,
    0.65, 0.55, 0.55, 0.4, 0.2, 0.3, 0.3, 0.3, 0.3, 0.3, 0.2, 0.3, 0.4,
    0.45, 0.45, 0.3,
)
# Per-aspect focal alpha table (``aspect_train.py:69``).
FOCAL_ALPHA_ASPECT: Tuple[float, ...] = (0.4, 0.4, 0.43, 0.2, 0.3)

# Composite weights: stage 2 (``aspect_train.py:66``), stage 3
# (``overall_train.py:69``).
ALPHA_STAGE2: Tuple[float, ...] = (0.3, 1.0, 1.0, 0.5)
ALPHA_STAGE3: Tuple[float, ...] = (0.3, 0.3, 0.3, 1.0, 1.0)

EPS = 1e-5


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def _alpha(table, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.float32,
                           device=like.device).expand(like.shape)


def focal_bce(pred_sig, target, related, alpha, eps=EPS) -> torch.Tensor:
    """Focal-weighted BCE, masked, SUMMED (``criteria_train.py:95-104``)."""
    alpha = _f32(alpha)
    loss = -(
        target * torch.log(pred_sig + eps) * alpha
        + (1.0 - target) * torch.log(1.0 - pred_sig + eps) * (1.0 - alpha)
    ) * related
    return loss.sum()


def batch_totals(batch: Dict) -> Dict[str, torch.Tensor]:
    """One data shard's counts behind the loss's normalisers (fp32 0-d
    tensors): its rows, the aspect relations of both videos and the aspect
    preference mask; summed over the data axis they are the whole
    batch's."""
    rows = batch["video_0_criteria_score"]
    out = {"rows": torch.tensor(float(rows.shape[0]), device=rows.device)}
    if "video_0_aspect_related" in batch:
        out["aspect_related"] = (_f32(batch["video_0_aspect_related"]).sum()
                                 + _f32(batch["video_1_aspect_related"]).sum())
    if "aspect_mask" in batch:
        out["aspect_mask"] = _f32(batch["aspect_mask"]).sum()
    return out


# The labels a data shard's loss reads whole (gathered over the data axis
# into ``totals``): the stage-3 overall BT pairs every label row with
# every score row.
WHOLE_BATCH_KEYS = ("overall_preference", "overall_mask")


def _rows(totals, like: torch.Tensor) -> int:
    """The whole batch's rows: ``like``'s own without ``totals``."""
    return like.shape[0] if totals is None else int(totals["rows"])


def mse_sum_over_length(pred, target, rows: Optional[int] = None
                        ) -> torch.Tensor:
    """``((pred - gt)^2 / numel).sum()``, the reference's MSE; ``rows``:
    the whole batch's, when ``pred`` holds one data shard's."""
    numel = pred.numel() if rows is None else (
        pred.numel() // pred.shape[0] * rows)
    return ((pred - target) ** 2 / numel).sum()


def criteria_loss(out0, out1, batch: Dict, mse: bool = False,
                  focal_alpha=FOCAL_ALPHA_CRITERIA,
                  eps: float = EPS, totals=None) -> torch.Tensor:
    """Stage-1 loss over the 28 criteria rewards of both videos."""
    r0, r1 = _f32(out0.rewards), _f32(out1.rewards)
    gt0 = _f32(batch["video_0_criteria_score"])
    gt1 = _f32(batch["video_1_criteria_score"])
    if mse:
        n = _rows(totals, r0)
        return (mse_sum_over_length(r0, gt0, n)
                + mse_sum_over_length(r1, gt1, n))
    rel0 = _f32(batch["video_0_criteria_related"])
    rel1 = _f32(batch["video_1_criteria_related"])
    a = _alpha(focal_alpha, r0)
    return (focal_bce(torch.sigmoid(r0), gt0, rel0, a, eps)
            + focal_bce(torch.sigmoid(r1), gt1, rel1, a, eps))


def aspect_score_loss(out0, out1, batch: Dict, mse: bool = True,
                      focal_alpha=FOCAL_ALPHA_ASPECT,
                      eps: float = EPS, totals=None) -> torch.Tensor:
    """Aspect-score regression/BCE term (``aspect_train.py:110-131``),
    the BCE divided by the whole batch's related count."""
    s0, s1 = _f32(out0.aspect_scores), _f32(out1.aspect_scores)
    gt0 = _f32(batch["video_0_aspect_score"])
    gt1 = _f32(batch["video_1_aspect_score"])
    if mse:
        n = _rows(totals, s0)
        return (mse_sum_over_length(s0, gt0, n)
                + mse_sum_over_length(s1, gt1, n))
    rel0 = _f32(batch["video_0_aspect_related"])
    rel1 = _f32(batch["video_1_aspect_related"])
    a = _alpha(focal_alpha, s0)
    total = (focal_bce(torch.sigmoid(s0), gt0, rel0, a, eps)
             + focal_bce(torch.sigmoid(s1), gt1, rel1, a, eps))
    n = (rel0.sum() + rel1.sum() if totals is None
         else totals["aspect_related"])
    return torch.where(n > 0, total / n.clamp_min(1.0), 0.0)


def bradley_terry_loss(score0, score1, preference, mask, beta: float = 1.0,
                       mean_over_mask: bool = True,
                       mask_total=None) -> torch.Tensor:
    """Pairwise BT loss (``aspect_train.py:134-147``, ``overall_train.py:
    166-186``).  preference 0 = video_0 better, 1 = video_1 better;
    ``mask_total``: the whole batch's mask count (``mask``'s own sum
    without it)."""
    score0, score1 = _f32(score0), _f32(score1)
    preference, mask = _f32(preference), _f32(mask)
    p0 = 1.0 / (1.0 + torch.exp(beta * (score1 - score0)))
    p1 = 1.0 / (1.0 + torch.exp(beta * (score0 - score1)))
    nll = -torch.log((1.0 - preference) * p0 + preference * p1) * mask
    total = nll.sum()
    if not mean_over_mask:
        return total  # the stage-3 overall BT is a plain sum
    n = mask.sum() if mask_total is None else mask_total
    return torch.where(n > 0, total / n.clamp_min(1.0), 0.0)


def gating_sparsity_loss(gate0, gate1, related0, related1, batch_size: int,
                         eps: float = EPS) -> torch.Tensor:
    """Push gate weights to 0 on unrelated slots (``aspect_train.py:
    149-163``, ``overall_train.py:188-198``); normalised by batch size."""
    g0, g1 = _f32(gate0), _f32(gate1)
    r0, r1 = _f32(related0), _f32(related1)
    loss = (-(1.0 - r0) * torch.log(1.0 - g0 + eps)
            - (1.0 - r1) * torch.log(1.0 - g1 + eps))
    return loss.sum() / batch_size


def stage1_loss(out0, out1, batch: Dict, mse: bool = False,
                totals=None) -> torch.Tensor:
    """Criteria stage (default focal BCE, ``criteria_train.py:67``)."""
    return criteria_loss(out0, out1, batch, mse=mse, totals=totals)


def stage2_loss(out0, out1, batch: Dict, mse: bool = True, beta: float = 1.0,
                alpha=ALPHA_STAGE2, totals=None) -> torch.Tensor:
    """Aspect stage composite (``aspect_train.py:66-167``): alpha[0] stage1
    + alpha[1] aspect score + alpha[2] aspect BT, and with ``mse=False``
    also alpha[3] times the criteria-gating sparsity."""
    s1 = criteria_loss(out0, out1, batch, mse=mse, totals=totals)
    s2 = aspect_score_loss(out0, out1, batch, mse=mse, totals=totals)
    bt = bradley_terry_loss(out0.aspect_scores, out1.aspect_scores,
                            batch["aspect_preference"], batch["aspect_mask"],
                            beta=beta, mask_total=None if totals is None
                            else totals["aspect_mask"])
    loss = alpha[0] * s1 + alpha[1] * s2 + alpha[2] * bt
    if not mse:
        B = _rows(totals, out0.rewards)
        loss = loss + alpha[3] * gating_sparsity_loss(
            out0.aspect_weights, out1.aspect_weights,
            batch["video_0_criteria_related"],
            batch["video_1_criteria_related"], B)
    return loss


def stage3_loss(out0, out1, batch: Dict, mse: bool = True, beta: float = 1.0,
                alpha=ALPHA_STAGE3, alpha_stage2=ALPHA_STAGE2,
                totals=None) -> torch.Tensor:
    """Overall stage composite (``overall_train.py:67-202``): alpha[0]
    stage1 + alpha[1] stage2 + alpha[2] aspect-gating sparsity + alpha[3]
    overall BT + alpha[4] overall MSE."""
    B = _rows(totals, out0.rewards)
    s1 = criteria_loss(out0, out1, batch, mse=mse, totals=totals)
    s2 = stage2_loss(out0, out1, batch, mse=mse, beta=beta,
                     alpha=alpha_stage2, totals=totals)
    gate = gating_sparsity_loss(
        out0.aspect_gating_output, out1.aspect_gating_output,
        batch["video_0_aspect_related"], batch["video_1_aspect_related"], B)
    labels = batch if totals is None else totals
    bt = bradley_terry_loss(out0.score, out1.score,
                            labels["overall_preference"],
                            labels["overall_mask"], beta=beta,
                            mean_over_mask=False)
    mse_term = (
        mse_sum_over_length(_f32(out0.score),
                            _f32(batch["video_0_overall_score"]).reshape(-1),
                            B)
        + mse_sum_over_length(_f32(out1.score),
                              _f32(batch["video_1_overall_score"]).reshape(-1),
                              B))
    return (alpha[0] * s1 + alpha[1] * s2 + alpha[2] * gate
            + alpha[3] * bt + alpha[4] * mse_term)


class StageSpec(NamedTuple):
    """One training stage: its loss and which parameter subtrees train
    (``criteria_train.py:334-338``, ``aspect_train.py:369-374``,
    ``overall_train.py:458-464``).  The ViT and the projector stay frozen in
    every stage."""

    name: str
    loss_fn: object
    trainable_paths: Tuple[str, ...]


STAGES = {
    1: StageSpec("criteria", stage1_loss,
                 ("regression_layer", "model/language_model")),
    2: StageSpec("aspect", stage2_loss,
                 ("regression_layer", "criteria_gating",
                  "model/language_model")),
    3: StageSpec("overall", stage3_loss,
                 ("regression_layer", "criteria_gating", "aspect_gating",
                  "model/language_model")),
}
