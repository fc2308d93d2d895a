"""Training step and loop: freeze policies, optax-exact AdamW and Adafactor,
accumulation, ViT DropPath and dropout, checkpoints and resume.

Counterpart of ``mjvideo_tpu/train/trainer.py`` on one device:

* ``trainable_mask`` gives the set of parameter paths that train in a stage
  (``losses.STAGES``); frozen tensors get ``requires_grad_(False)``, so
  autograd computes and stores no gradient for them (the JAX loss wraps them
  in ``stop_gradient``).  A kernel node's fields have JAX's path strings
  (``.../kernel/.w``, ``/.a``, ``/.b``, ``/.scale``; a quantized base
  ``.../kernel/.w/.qw``): nothing under ``.w`` trains.
* ``TrainConfig.lora_rank`` > 0 wraps the decoder's attention and MLP
  kernels in LoRA nodes (``ops/lora.py``, its generator seeded with the
  rank as JAX seeds ``PRNGKey(lora_rank)``), and the backbone then trains
  only their ``.a`` and ``.b`` fields; the heads keep their stage's policy.
  Over a quantized base (QLoRA: quantize, then train) the integer fields
  stay frozen; integer tensors cannot take a gradient in torch, so a
  quantized state trained without LoRA, which JAX's mask would train
  through its integer fields, raises ``ValueError``.
* ``make_optimizer`` reproduces the optax chain the JAX package builds:
  ``clip_by_global_norm`` (scale by ``max_norm / norm`` only when ``norm >=
  max_norm``, no epsilon), then ``adamw`` (moments in the parameter dtype,
  or the first moment stored in bf16 under ``adam_mu_dtype="bfloat16"``;
  decoupled weight decay) or ``adafactor`` (the factored second moment of
  ``optax.scale_by_factored_rms``, no momentum, no clipping, no parameter
  scale, weight decay not scaled by the learning rate), the learning rate
  of ``linear``, ``cosine`` or constant schedules joined to a linear warmup
  and read at optax's count (which starts at 0), and ``MultiSteps``
  gradient accumulation (a running mean of k micro-batch gradients, then
  one optimizer step).  Updates are applied in place.
* ``make_train_step`` and ``Trainer`` keep the JAX signatures; a checkpoint
  is one ``torch.save`` of the params, the optimizer state (moments or
  factored statistics, counts, accumulation buffer) and the step, kernel
  nodes as plain dicts (``utils.checkpoint.save_state``), read back with
  ``torch.load(weights_only=True)`` and the nodes revived
  (``utils.checkpoint.load_state``), so resume is bit-exact.
  ``async_checkpoint`` snapshots the state to host memory and writes it on
  a background thread (``utils.checkpoint.save_state``);
  ``tensorboard`` adds ``checkpoint_dir/tb`` event files beside the JSONL.
* A vision config with ``drop_path_rate`` or ``dropout`` above 0 trains
  with ViT DropPath and projection dropout: the step's noise key is a pure
  function of the step number (``models.vit.NoiseKey``), so a resumed run
  draws what an unbroken one does.
* ``Trainer.evaluate`` is the in-training eval: batched reward forwards
  without autograd, then the preference accuracy and the per-criteria and
  per-aspect metrics of ``eval/metrics.py``.
* ``TrainConfig.sp`` ("ring" or "allgather") runs both reward forwards
  sequence-parallel over the ``sp_group`` the caller gives (JAX passes the
  mesh): ``reward_forward(sp=)``, remat as without it.  In a distributed
  group each rank's backbone gradients cover its own rows, so they are
  summed over the group; the head runs alike on every rank and its
  gradients are whole already.

Options of ``TrainConfig`` that this port does not honour yet raise
``NotImplementedError`` naming their ROADMAP item when set away from their
default (``check_supported``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Set

import numpy as np
import torch

from ..configs import RewardConfig

from ..models.reward import reward_forward
from ..models.vit import NoiseKey
from ..utils.bridge import first_tensor, is_node, map_state, node_fields
from ..utils.checkpoint import load_state, save_state, wait_for_saves
from .losses import STAGES


@dataclass
class TrainConfig:
    """The JAX ``TrainConfig``, field for field, with its defaults."""

    stage: int = 1
    learning_rate: float = 1e-6
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    adam_mu_dtype: Optional[str] = None
    warmup_steps: int = 0
    total_steps: int = 1000
    schedule: str = "linear"
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    mse: Optional[bool] = None  # None = the stage's script default
    beta: float = 1.0
    attn_impl: str = "auto"
    remat: object = True
    optimizer: str = "adamw"
    zero1: bool = False
    sp: Optional[str] = None
    lora_rank: int = 0
    lora_alpha: Optional[float] = None
    async_checkpoint: bool = False
    log_every: int = 10
    checkpoint_every: int = 500
    checkpoint_dir: str = "./checkpoints"
    keep_checkpoints: int = 3
    mesh_model_axis: int = 1
    mesh_data_axis: int = -1
    tensorboard: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)

    def stage_mse_default(self) -> bool:
        # criteria_train.py:69 mse=False; aspect/overall default mse=True.
        return self.stage != 1


# Options not ported yet: field -> (the value that is supported, what it
# waits for).
_NOT_PORTED = {
    "zero1": (False, "ZeRO-1, ROADMAP Queue 1 item 12"),
}


def check_supported(tc: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for an option this port lacks."""
    for name, (ok, item) in _NOT_PORTED.items():
        if getattr(tc, name) != ok:
            raise NotImplementedError(
                f"TrainConfig.{name}={getattr(tc, name)!r} is not ported "
                f"yet: {item}")
    if tc.sp not in (None, "ring", "allgather"):
        raise ValueError(f"unknown sp kind {tc.sp!r}")
    if tc.optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    if tc.adam_mu_dtype not in (None, "bfloat16"):
        raise ValueError(f"unknown adam_mu_dtype {tc.adam_mu_dtype!r}")
    if tc.mesh_model_axis != 1 or tc.mesh_data_axis not in (-1, 1):
        raise NotImplementedError(
            "training on a mesh of more than one device is not ported yet: "
            "ROADMAP Queue 1 item 12 (mesh_data_axis and mesh_model_axis "
            "must be 1, or -1 for the data axis)")


def flatten_state(state, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of tensors and kernel nodes -> {"a/b/c": tensor}, in
    insertion order; a node's fields are named as JAX's path strings name
    them (``.../kernel/.w``, ``.../kernel/.w/.qw``)."""
    out: Dict[str, torch.Tensor] = {}
    items = (state.items() if isinstance(state, dict)
             else ((f".{name}", v) for name, v in node_fields(state)))
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, dict) or is_node(val):
            out.update(flatten_state(val, path + "/"))
        else:
            out[path] = val
    return out


def trainable_mask(params, stage: int, lora: bool = False) -> Set[str]:
    """The paths of the parameters that train in ``stage``
    (``trainer.py:114-133``): the stage's prefixes in ``losses.STAGES``,
    nothing under a ``.w`` field (a LoRA node's frozen base) and, with
    ``lora``, under ``model/`` only the ``.a`` and ``.b`` fields."""
    prefixes = STAGES[stage].trainable_paths

    def on(path):
        if not any(path.startswith(p) for p in prefixes) or "/.w" in path:
            return False
        if lora and path.startswith("model/"):
            return path.endswith("/.a") or path.endswith("/.b")
        return True

    return {path for path in flatten_state(params) if on(path)}


def set_trainable(params, paths: Set[str]) -> None:
    """``requires_grad_`` True on ``paths``, False on every other tensor."""
    for path, t in flatten_state(params).items():
        t.requires_grad_(path in paths)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    sq = [t.float().square().sum() for t in tensors]
    return torch.stack(sq).sum().sqrt()


def make_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """The learning rate at optax count ``c`` (``make_optimizer``'s
    ``linear_schedule`` / ``cosine_decay_schedule`` / constant, joined to a
    linear warmup from 0 when ``warmup_steps`` > 0)."""
    lr = tc.learning_rate
    decay_steps = max(tc.total_steps - tc.warmup_steps, 1)

    def main(c: int) -> float:
        if tc.schedule == "linear":
            return lr * (1.0 - min(max(c, 0), decay_steps) / decay_steps)
        if tc.schedule == "cosine":
            c = min(c, decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return lr

    if not tc.warmup_steps:
        return main
    w = tc.warmup_steps

    def joined(c: int) -> float:
        if c < w:
            return -lr * (1.0 - min(max(c, 0), w) / w) + lr
        return main(c - w)

    return joined


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in fp32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


# Adafactor's constants: ``optax.adafactor``'s defaults, as the JAX package
# builds it (``min_dim_size_to_factor``, ``decay_rate``, ``eps``).
ADAFACTOR_MIN_DIM = 128
ADAFACTOR_DECAY = 0.8
ADAFACTOR_EPS = 1e-30


def factored_dims(shape) -> Optional[tuple]:
    """(d1, d0), the second largest and the largest dim of ``shape``, when
    the second largest is at least ``ADAFACTOR_MIN_DIM``; else None
    (``optax._src.factorized._factored_dims``, the same ``np.argsort``, so
    that equal sizes break the same way).  The stacked ``(L, in, out)``
    layer kernels keep JAX's layout, so the same dims are chosen."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def state_bytes(state) -> int:
    """Bytes of every tensor in an optimizer state (nested dicts)."""
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    return 0


class Optimizer:
    """The optax chain of ``make_optimizer`` over the trainable paths:
    ``MultiSteps(clip_by_global_norm -> adamw | adafactor)`` when
    accumulating, the chain alone otherwise.  ``update`` applies the step to
    the parameters in place and returns the new state."""

    def __init__(self, tc: TrainConfig, paths: Set[str]):
        self.tc = tc
        self.paths: List[str] = sorted(paths)
        self.schedule = make_schedule(tc)
        self.accumulate = tc.gradient_accumulation_steps
        self.mu_dtype = (torch.bfloat16 if tc.adam_mu_dtype == "bfloat16"
                         else None)

    def init(self, params) -> Dict[str, Any]:
        flat = flatten_state(params)

        def zeros(dtype=None):
            return {p: torch.zeros_like(flat[p], dtype=dtype).detach()
                    for p in self.paths}

        if self.tc.optimizer == "adafactor":
            state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
            for p in self.paths:
                t = flat[p].detach()
                dims = factored_dims(tuple(t.shape))
                if dims is None:
                    state["v"][p] = torch.zeros_like(t)
                else:
                    d1, d0 = dims
                    state["v_row"][p] = torch.zeros_like(t.sum(d0))
                    state["v_col"][p] = torch.zeros_like(t.sum(d1))
        else:
            state = {"count": 0, "mu": zeros(self.mu_dtype), "nu": zeros()}
        if self.accumulate > 1:
            state.update(mini_step=0, gradient_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def _apply(self, grads: Dict[str, torch.Tensor], state, flat) -> None:
        tc = self.tc
        gnorm = global_norm(grads.values())
        if not bool(gnorm < tc.max_grad_norm):
            grads = {p: (g / gnorm.to(g.dtype)) * tc.max_grad_norm
                     for p, g in grads.items()}
        if tc.optimizer == "adafactor":
            self._adafactor(grads, state, flat)
        else:
            self._adamw(grads, state, flat)
        state["count"] += 1

    def _adamw(self, grads, state, flat) -> None:
        """``optax.adamw``.  A first moment stored narrower than the
        gradient (``adam_mu_dtype="bfloat16"`` on fp32 parameters) is read
        back in the gradient's dtype and times ``b1`` rounded to the
        moment's dtype (optax's weakly typed ``b1 * mu``), as the JAX
        package's jitted step computes it, so the stored ``mu`` is
        bit-equal to optax's; the update uses that wider moment, and only
        the stored ``mu`` is rounded.  On bf16 parameters
        the moment is bf16 either way, as in optax."""
        tc = self.tc
        count = state["count"] + 1
        bc1 = _bias_correction(tc.adam_b1, count)
        bc2 = _bias_correction(tc.adam_b2, count)
        step_size = -self.schedule(state["count"])
        for p in self.paths:
            g, mu, nu = grads[p], state["mu"][p], state["nu"][p]
            if mu.dtype == g.dtype:
                mu.mul_(tc.adam_b1).add_(g * (1 - tc.adam_b1))
                m = mu
            else:
                # XLA contracts the jitted ``(1 - b1) * g + b1 * mu`` into
                # one fma: the product b1 * mu is exact, (1 - b1) * g is not
                # rounded, the sum is rounded once (fp64 holds it).
                b1 = float(torch.tensor(tc.adam_b1, dtype=mu.dtype))
                m = (g.double() * float(np.float32(1 - tc.adam_b1))
                     + mu.double() * b1).to(g.dtype)
                mu.copy_(m)
            nu.mul_(tc.adam_b2).add_((g * g) * (1 - tc.adam_b2))
            u = (m / bc1) / ((nu / bc2).sqrt() + tc.adam_eps)
            param = flat[p]
            u = (u + tc.weight_decay * param) * step_size
            param.add_(u)

    def _adafactor(self, grads, state, flat) -> None:
        """``optax.adafactor(lr, multiply_by_parameter_scale=False,
        clipping_threshold=None, weight_decay_rate=wd or None)``:
        ``scale_by_factored_rms`` (decay ``1 - (count + 1)^-0.8``, eps added
        to the squared gradient, the row statistic normalised by its mean,
        the column one not), then times the learning rate, plus ``wd *
        param`` (not scaled by the learning rate), negated.  The statistics
        are stored in the parameter dtype and computed in fp32."""
        tc = self.tc
        t = np.float32(state["count"] + 1)
        decay = np.float32(1.0) - t ** np.float32(-ADAFACTOR_DECAY)
        keep, new = float(decay), float(np.float32(1.0) - decay)
        lr = self.schedule(state["count"])
        for p in self.paths:
            g, param = grads[p], flat[p]
            g2 = g * g + ADAFACTOR_EPS
            dims = factored_dims(tuple(g.shape))
            if dims is None:
                v = state["v"][p]
                v.copy_(keep * v.float() + new * g2.float())
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][p], state["v_col"][p]
                v_row.copy_(keep * v_row.float()
                            + new * g2.mean(d0).float())
                v_col.copy_(keep * v_col.float()
                            + new * g2.mean(d1).float())
                reduced = d1 - 1 if d1 > d0 else d1
                row = (v_row / v_row.mean(reduced, keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            u = u * lr
            if tc.weight_decay:
                u = u + tc.weight_decay * param
            param.sub_(u)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state, params):
        flat = flatten_state(params)
        if self.accumulate <= 1:
            self._apply(grads, state, flat)
            return state
        n = state["mini_step"]
        for p in self.paths:
            acc = state["acc"][p]
            acc.add_((grads[p] - acc) / (n + 1))
        if n == self.accumulate - 1:
            self._apply(state["acc"], state, flat)
            for acc in state["acc"].values():
                acc.zero_()
            state["mini_step"] = 0
            state["gradient_step"] += 1
        else:
            state["mini_step"] = n + 1
        return state


def make_optimizer(tc: TrainConfig, params) -> Optimizer:
    """The optimizer over ``trainable_mask(params, tc.stage, lora=
    tc.lora_rank > 0)``; raises ``ValueError`` where that set holds an
    integer tensor (a quantized base trained without LoRA)."""
    check_supported(tc)
    paths = trainable_mask(params, tc.stage, lora=tc.lora_rank > 0)
    flat = flatten_state(params)
    ints = sorted(p for p in paths if not flat[p].is_floating_point())
    if ints:
        raise ValueError(
            f"stage {tc.stage} would train {len(ints)} integer tensors of "
            f"quantized kernels ({ints[0]}, ...): a quantized base trains "
            "only with LoRA adapters (lora_rank > 0)")
    return Optimizer(tc, paths)


def _sp_spec(tc: TrainConfig, sp_group):
    if tc.sp is None:
        return None
    if sp_group is None:
        raise ValueError("tc.sp requires the sp_group argument")
    return {"group": sp_group, "kind": tc.sp}


def make_loss_fn(cfg: RewardConfig, tc: TrainConfig,
                 sp_group=None) -> Callable:
    """(params, batch, vit_rng=None) -> scalar fp32 loss: two reward
    forwards, one per video, then the stage loss.  ``sp_group`` (a
    ``parallel.sequence.SequenceGroup``) is required when ``tc.sp`` is
    set.  ``vit_rng`` (a ``vit.NoiseKey``): the ViT's DropPath and dropout,
    video v drawing from ``vit_rng.fold_in(v)``, as JAX folds it."""
    mse = tc.mse if tc.mse is not None else tc.stage_mse_default()
    stage_loss = STAGES[tc.stage].loss_fn
    sp = _sp_spec(tc, sp_group)

    def loss_fn(params, batch, vit_rng=None):
        outs = []
        for v in (0, 1):
            pix = batch[f"video_{v}_pixel_values"]
            # (B, P, H, W, 3) -> (B*P, H, W, 3), as criteria_train.py:70-72.
            pix = pix.reshape((-1,) + tuple(pix.shape[-3:]))
            outs.append(reward_forward(
                params, cfg, pix, batch[f"video_{v}_input_ids"],
                batch[f"video_{v}_attention_mask"],
                batch[f"video_{v}_gating_pos"], impl=tc.attn_impl,
                remat=tc.remat, sp=sp,
                vit_rng=None if vit_rng is None else vit_rng.fold_in(v)))
        if tc.stage > 1:
            return stage_loss(outs[0], outs[1], batch, mse=mse, beta=tc.beta)
        return stage_loss(outs[0], outs[1], batch, mse=mse)

    return loss_fn


def make_train_step(cfg: RewardConfig, tc: TrainConfig,
                    optimizer: Optimizer, sp_group=None) -> Callable:
    """(params, opt_state, batch, rng=None) -> (params, opt_state,
    {"loss", "grad_norm"}).  The params are updated in place (the JAX step
    donates them); ``grad_norm`` is the global norm of the micro-batch's
    trainable gradients before clipping; ``rng``: the step's ViT noise
    key."""
    loss_fn = make_loss_fn(cfg, tc, sp_group)
    trainable = set(optimizer.paths)
    # Backbone gradients cover one rank's rows in a distributed group.
    summed = ([] if sp_group is None or sp_group.is_local else
              [p for p in optimizer.paths if p.startswith("model/")])

    def train_step(params, opt_state, batch, rng=None):
        set_trainable(params, trainable)
        flat = flatten_state(params)
        leaves = [flat[p] for p in optimizer.paths]
        loss = loss_fn(params, batch, rng)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {p: torch.zeros_like(t) if g is None else g
                 for p, t, g in zip(optimizer.paths, leaves, grads)}
        if summed:
            import torch.distributed as dist

            for p in summed:
                dist.all_reduce(grads[p], group=sp_group.process_group)
        gnorm = global_norm(grads.values())
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def place_batch(batch, device: torch.device,
                pixel_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A batch of arrays -> tensors on ``device``: pixels in
    ``pixel_dtype``, other floats (labels) in fp32, ids and masks as they
    are."""
    def place(key, x):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
        if key.endswith("pixel_values"):
            t = t.to(pixel_dtype)
        elif t.is_floating_point():
            t = t.float()
        return t.to(device)

    return {k: place(k, v) for k, v in batch.items()}


def _detached(state):
    return map_state(lambda t: t.detach(), state)


class Trainer:
    """Deterministic training loop with ``torch.save`` checkpoints and JSONL
    metrics (``checkpoint_dir/metrics.jsonl``), and TensorBoard event files
    under ``checkpoint_dir/tb`` with ``tc.tensorboard``.  ``sp_group``: the
    sequence group of ``tc.sp`` (where JAX's ``Trainer`` takes the mesh);
    every process of a distributed group feeds the same batches."""

    def __init__(self, cfg: RewardConfig, params, tc: TrainConfig,
                 sp_group=None):
        self.cfg = cfg
        self.tc = tc
        self.device = first_tensor(params).device
        if tc.lora_rank > 0:
            from ..ops.lora import apply_lora

            # Idempotent: a state already wrapped (a warm start from a LoRA
            # checkpoint) passes through unchanged.
            params = apply_lora(
                params, torch.Generator(device=self.device).manual_seed(
                    tc.lora_rank), tc.lora_rank, alpha=tc.lora_alpha)
        self.params = params
        self.optimizer = make_optimizer(tc, params)
        self.opt_state = self.optimizer.init(params)
        self.step_fn = make_train_step(cfg, tc, self.optimizer, sp_group)
        self.step = 0
        vis = cfg.chat.vision
        self._needs_vit_rng = vis.drop_path_rate > 0.0 or vis.dropout > 0.0
        self._base_rng = NoiseKey(0)
        os.makedirs(tc.checkpoint_dir, exist_ok=True)
        self._metrics_path = os.path.join(tc.checkpoint_dir, "metrics.jsonl")
        self._saved: List[str] = []
        self._tb = None
        if tc.tensorboard:
            # The reference logs the Trainer's scalars to TensorBoard
            # (criteria_train.py:35,424); JSONL stays on either way.
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(tc.checkpoint_dir, "tb"))
            except ImportError as e:
                print(f"tensorboard logging is off ({e}); metrics go to "
                      f"{self._metrics_path} only")

    def log(self, record: Dict[str, Any]) -> None:
        """One JSONL line; with TensorBoard, each int or float entry but
        ``step`` as a scalar at ``record["step"]`` (JAX
        ``trainer.py:375-381``)."""
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None and "step" in record:
            for k, v in record.items():
                if isinstance(v, (int, float)) and k != "step":
                    self._tb.add_scalar(k, v, record["step"])
            self._tb.flush()

    def _checkpoint_path(self, step: int) -> str:
        return os.path.join(self.tc.checkpoint_dir,
                            f"stage{self.tc.stage}_step{step}.pt")

    def save(self) -> str:
        """Write this step's checkpoint (``utils.checkpoint.save_state``);
        under ``tc.async_checkpoint`` a host snapshot is written in the
        background, at most one save outstanding."""
        path = self._checkpoint_path(self.step)
        block = not self.tc.async_checkpoint
        save_state({"params": _detached(self.params),
                    "opt_state": self.opt_state, "step": self.step}, path,
                   block=block)
        # A step can save twice (checkpoint_every and the caller); one entry.
        if path not in self._saved:
            self._saved.append(path)
        if len(self._saved) > self.tc.keep_checkpoints and not block:
            wait_for_saves()  # never remove a file while a save is pending
        while len(self._saved) > self.tc.keep_checkpoints:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)
        return path

    def _pixel_dtype(self) -> torch.dtype:
        return first_tensor(self.params["model"]["vision_model"]).dtype

    @torch.no_grad()
    def evaluate(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
        """In-training eval: pairwise preference accuracy and the
        per-criteria and per-aspect binary metrics
        (``overall_train.py:390-442`` and ``evaluate_aspect`` :204-306) from
        batched reward forwards without gradients (K1 and K2 on the card,
        never their lse forms), logged to the metrics JSONL.  The
        parameters are not changed."""
        from ..configs import ASPECT_NAMES, CRITERIA_NAMES
        from ..eval.metrics import (
            binary_dimension_metrics,
            preference_accuracy,
        )

        cfg, tc = self.cfg, self.tc

        def host(t):
            return t.float().cpu().numpy()

        scores = {0: [], 1: []}
        prefs, masks = [], []
        crit_s, crit_gt, crit_rel = [], [], []
        asp_s, asp_gt, asp_rel = [], [], []
        for batch in batches:
            placed = place_batch(batch, self.device, self._pixel_dtype())
            for v in (0, 1):
                pix = placed[f"video_{v}_pixel_values"]
                o = reward_forward(
                    self.params, cfg,
                    pix.reshape((-1,) + tuple(pix.shape[-3:])),
                    placed[f"video_{v}_input_ids"],
                    placed[f"video_{v}_attention_mask"],
                    placed[f"video_{v}_gating_pos"], impl=tc.attn_impl,
                    remat=False)
                scores[v].append(host(o.score))
                asp_s.append(host(o.aspect_scores))
                crit_s.append(host(o.rewards))
                crit_gt.append(np.asarray(batch[f"video_{v}_criteria_score"]))
                crit_rel.append(
                    np.asarray(batch[f"video_{v}_criteria_related"]))
                asp_gt.append(np.asarray(batch[f"video_{v}_aspect_score"]))
                asp_rel.append(np.asarray(batch[f"video_{v}_aspect_related"]))
            prefs.append(np.asarray(batch["overall_preference"]).reshape(-1))
            masks.append(np.asarray(batch["overall_mask"]).reshape(-1))

        result = {
            "preference": preference_accuracy(
                np.concatenate(scores[0]), np.concatenate(scores[1]),
                np.concatenate(prefs), np.concatenate(masks)),
            "criteria": binary_dimension_metrics(
                np.concatenate(crit_s), np.concatenate(crit_gt),
                np.concatenate(crit_rel), names=CRITERIA_NAMES),
            "aspects": binary_dimension_metrics(
                np.concatenate(asp_s), np.concatenate(asp_gt),
                np.concatenate(asp_rel), names=ASPECT_NAMES),
        }
        self.log({"step": self.step, "eval": result})
        return result

    def resume_latest(self) -> Optional[str]:
        """Restore params, optimizer state and step from the newest
        checkpoint of this stage; with the caller feeding batches from
        ``self.step`` onward, resume is bit-exact."""
        wait_for_saves()  # never read a checkpoint still being written
        pat = re.compile(rf"stage{self.tc.stage}_step(\d+)\.pt$")
        best = None
        for name in os.listdir(self.tc.checkpoint_dir):
            m = pat.match(name)
            if m and (best is None or int(m.group(1)) > best[0]):
                best = (int(m.group(1)),
                        os.path.join(self.tc.checkpoint_dir, name))
        if best is None:
            return None
        ckpt = load_state(best[1], map_location=self.device)
        self.params = ckpt["params"]
        self.opt_state = ckpt["opt_state"]
        self.step = ckpt["step"]
        return best[1]

    def train(self, batches: Iterable[Dict[str, Any]],
              max_steps: Optional[int] = None) -> Dict[str, float]:
        last: Dict[str, float] = {}
        t0 = time.time()
        for batch in batches:
            if max_steps is not None and self.step >= max_steps:
                break
            # The ViT noise key is a function of the step number alone, so
            # a resumed run draws what an unbroken one does.
            rng = (self._base_rng.fold_in(self.step) if self._needs_vit_rng
                   else None)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state,
                place_batch(batch, self.device, self._pixel_dtype()), rng)
            self.step += 1
            if self.step % self.tc.log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                last.update(step=self.step, stage=self.tc.stage,
                            elapsed_s=round(time.time() - t0, 2))
                self.log(last)
            if self.step % self.tc.checkpoint_every == 0:
                self.save()
        if self.tc.async_checkpoint:
            wait_for_saves()  # durable before the loop returns
        return last


def warm_start(params, checkpoint_path: str):
    """The params of a checkpoint (a previous stage's) in the dtype and on
    the device of ``params``, kernel node by node field; the next stage
    builds its own optimizer.  A checkpoint whose kernels are LoRA nodes
    fits only a state wrapped alike (``KeyError`` otherwise: the train
    CLI then wraps first, as JAX's does)."""
    ref = first_tensor(params)
    ckpt = load_state(checkpoint_path, map_location=ref.device)
    loaded = flatten_state(ckpt["params"])

    def take(path, v):
        if isinstance(v, dict):
            return {k: take(f"{path}{k}/", x) for k, x in v.items()}
        if is_node(v):
            return dataclasses.replace(v, **{
                name: take(f"{path}.{name}/", x)
                for name, x in node_fields(v)})
        return loaded[path[:-1]].to(v.dtype)

    return take("", params)
