"""Training step and loop: freeze policies, optax-exact AdamW and Adafactor,
accumulation, ViT DropPath and dropout, checkpoints and resume.

Counterpart of ``mjvideo_tpu/train/trainer.py``, on one device or a
(data, model) mesh:

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
* ``Trainer(mesh=)`` (``parallel/mesh.py``; ``Mesh.local(1, 1)`` when none
  is given) places the parameters by the TP rules, splits each batch over
  the data axis and sums the gradients over it (``make_train_step``), and
  keeps the optimizer state by held leaf (``Optimizer``), each data rank
  only its slice under ``TrainConfig.zero1``; checkpoints hold the whole
  state.  One process without a mesh is the (1, 1) case of the same
  code.  LoRA and QLoRA train on any mesh: the adapters split with their
  kernels, and a column member's ``a``, whole on every model rank, has its
  ranks' gradient shares summed over the model axis
  (``parallel.mesh.model_summed``) before the data axis's sum.
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
from ..parallel.mesh import held
from ..utils.bridge import (  # noqa: F401  (flatten_state is re-exported)
    first_tensor,
    flatten_state,
    is_node,
    map_state,
    node_fields,
)
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


def check_supported(tc: TrainConfig) -> None:
    """Raise ``ValueError`` for a misspelt option value."""
    if tc.sp not in (None, "ring", "allgather"):
        raise ValueError(f"unknown sp kind {tc.sp!r}")
    if tc.optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    if tc.adam_mu_dtype not in (None, "bfloat16"):
        raise ValueError(f"unknown adam_mu_dtype {tc.adam_mu_dtype!r}")


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


def held_flat(shards, mesh, plan) -> Dict[str, torch.Tensor]:
    """{key: tensor} of the held model ranks' trees: a split leaf's piece
    of rank j under ``path#m{j}``, every other leaf once under its path."""
    out: Dict[str, torch.Tensor] = {}
    for i, (j, tree) in enumerate(zip(mesh.model_ranks, shards)):
        for path, t in flatten_state(tree).items():
            if path in plan:
                out[f"{path}#m{j}"] = t
            elif i == 0:
                out[path] = t
    return out


def _key_path(key: str) -> str:
    return key.split("#", 1)[0]


def _key_rank(key: str) -> int:
    """The model rank of a split leaf's key, 0 for a whole leaf's."""
    m = re.search(r"#m(\d+)", key)
    return int(m.group(1)) if m else 0


class Optimizer:
    """The optax chain of ``make_optimizer`` over the trainable paths:
    ``MultiSteps(clip_by_global_norm -> adamw | adafactor)`` when
    accumulating, the chain alone otherwise, over the leaves a process
    holds on a (data, model) mesh (``held_flat``'s keys; without a mesh,
    ``Mesh.local(1, 1)``, the keys are the paths).  ``update`` takes the
    gradients by key, summed over the data axis (whole on every data
    rank), applies the step to the parameters in place and returns the new
    state.

    * The global norm sums one cell per (parameter, model rank, data
      slice): each leaf's square sum cut at its ZeRO-1 slices whenever the
      data axis is above 1 (whether ``tc.zero1`` is on or not), every cell
      computed by one process and the table summed over all of them, so
      that ZeRO-1, the replicated run and every form of the mesh read the
      same bits.
    * Under ``tc.zero1`` each data rank keeps only its slice
      (``parallel.mesh.zero1_opt_shardings``) of Adam's moments,
      Adafactor's unfactored second moment and the accumulator, updates
      its slice of the parameters, and the slices are all-gathered (in
      place in a local mesh).  The update is elementwise, so ZeRO-1 is
      bit-equal to the replicated run on the same mesh.  Adafactor's
      factored statistics stay whole (replicated, as in JAX): their
      parameter's update is computed whole on every data rank.
    * Adafactor's row or column statistic over a dim the model axis splits
      sums the ranks' partial sums over the model axis.
    """

    def __init__(self, tc: TrainConfig, paths: Set[str], mesh=None,
                 plan=None):
        from ..parallel.mesh import Mesh

        self.tc = tc
        self.paths: List[str] = sorted(paths)
        self.path_index = {p: i for i, p in enumerate(self.paths)}
        self.schedule = make_schedule(tc)
        self.accumulate = tc.gradient_accumulation_steps
        self.mu_dtype = (torch.bfloat16 if tc.adam_mu_dtype == "bfloat16"
                         else None)
        self.mesh = Mesh.local(1, 1) if mesh is None else mesh
        self.plan = {} if plan is None else plan
        self.zero1 = tc.zero1 and self.mesh.data > 1
        self.keys: Optional[List[str]] = None  # set by ``_layout``

    def _layout(self, params) -> Dict[str, torch.Tensor]:
        """The held leaves by key (``params``: a whole state or the held
        model ranks' trees).  The first call also takes the held trainable
        keys, each parameter's whole shape and its ZeRO-1 dim."""
        from ..parallel.mesh import zero1_dim, zero1_opt_shardings

        shards = held(params)
        flat = held_flat(shards, self.mesh, self.plan)
        if self.keys is None:
            first = flatten_state(shards[0])
            full = {}
            for p in self.paths:
                shape = list(first[p].shape)
                if p in self.plan:
                    shape[self.plan[p].dim] *= self.mesh.model
                full[p] = tuple(shape)
            whole = {p: torch.empty(full[p], device="meta")
                     for p in self.paths}
            specs = zero1_opt_shardings({"mu": whole}, whole, self.mesh)
            self.full_shapes = full
            self.zdims = {p: zero1_dim(specs[f"mu/{p}"]) for p in whole}
            self.keys = sorted(k for k in flat
                               if _key_path(k) in self.path_index)
        return flat

    # --- slots: a key, or one data rank's slice of it under ZeRO-1 -----

    def _factored(self, key: str) -> bool:
        return (self.tc.optimizer == "adafactor"
                and factored_dims(self.full_shapes[_key_path(key)])
                is not None)

    def _sliced(self, key: str) -> bool:
        return self.zero1 and self.zdims[_key_path(key)] is not None

    def slots(self, key: str) -> List[str]:
        if not self._sliced(key):
            return [key]
        return [f"{key}#d{d}" for d in self.mesh.data_ranks]

    def view(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """Slot ``slot``'s part of its key's tensor ``t``."""
        if "#d" not in slot:
            return t
        d = int(slot.rsplit("#d", 1)[1])
        dim = self.zdims[_key_path(slot)]
        n = t.shape[dim] // self.mesh.data
        return t.narrow(dim, d * n, n)

    def _whole_over_data(self, parts: List[torch.Tensor], key: str):
        """A key's tensor from its held slices: joined along the ZeRO-1
        dim, all-gathered across processes."""
        if not self._sliced(key):
            return parts[0]
        return self.mesh.gather_data(parts, self.zdims[_key_path(key)])

    def init(self, params) -> Dict[str, Any]:
        flat = self._layout(params)

        def zeros(dtype=None, moments=True):
            return {s: torch.zeros_like(self.view(flat[k], s),
                                        dtype=dtype).detach()
                    for k in self.keys if not (moments and self._factored(k))
                    for s in self.slots(k)}

        if self.tc.optimizer == "adafactor":
            state = {"count": 0, "v_row": {}, "v_col": {},
                     "v": zeros(moments=True)}
            for k in self.keys:
                if self._factored(k):
                    d1, d0 = factored_dims(self.full_shapes[_key_path(k)])
                    t = flat[k].detach()
                    state["v_row"][k] = torch.zeros_like(t.sum(d0))
                    state["v_col"][k] = torch.zeros_like(t.sum(d1))
        else:
            state = {"count": 0, "mu": zeros(self.mu_dtype), "nu": zeros()}
        if self.accumulate > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc=zeros(moments=False))
        return state

    # --- the global norm ----------------------------------------------

    def global_norm(self, grads: Dict[str, torch.Tensor],
                    sliced: bool) -> torch.Tensor:
        """The gradients' global norm (sqrt of the sum of squares, in fp32)
        from the cell table (see the class docstring).  ``grads``: by key
        (whole over data) or, ``sliced``, by slot."""
        mesh = self.mesh
        first = next(iter(grads.values()))
        table = torch.zeros((len(self.paths), mesh.model, mesh.data),
                            dtype=torch.float32, device=first.device)
        mine_m = None if mesh.is_local else mesh.model_rank
        mine_d = None if mesh.is_local else mesh.data_rank
        for name, g in grads.items():
            path = _key_path(name)
            j = _key_rank(name)
            if mine_m is not None and j != mine_m:
                continue  # a whole leaf's cell is model rank 0's
            zdim = self.zdims[path] if mesh.data > 1 else None
            if sliced and "#d" in name:
                cells = [(int(name.rsplit("#d", 1)[1]), g)]
            elif zdim is None:
                cells = [(0, g)]
            else:
                n = g.shape[zdim] // mesh.data
                cells = [(d, g.narrow(zdim, d * n, n))
                         for d in range(mesh.data)]
            i = self.path_index[path]
            for d, c in cells:
                if mine_d is None or d == mine_d:
                    table[i, j, d] = c.float().square().sum()
        return mesh.all_reduce_world(table).sum().sqrt()

    # --- the step -------------------------------------------------------

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state, params):
        """``grads`` by key; ``params`` (a whole state or the held model
        ranks' trees) are updated in place."""
        flat = self._layout(params)
        if self.accumulate <= 1:
            self._apply({s: self.view(grads[k], s) for k in self.keys
                         for s in self.slots(k)}, state, flat)
            return state
        n = state["mini_step"]
        for k in self.keys:
            for s in self.slots(k):
                acc = state["acc"][s]
                acc.add_((self.view(grads[k], s) - acc) / (n + 1))
        if n == self.accumulate - 1:
            self._apply(state["acc"], state, flat)
            for acc in state["acc"].values():
                acc.zero_()
            state["mini_step"] = 0
            state["gradient_step"] += 1
        else:
            state["mini_step"] = n + 1
        return state

    def _apply(self, grads: Dict[str, torch.Tensor], state,
               flat: Dict[str, torch.Tensor]) -> None:
        """One optimizer step from ``grads`` by slot."""
        tc = self.tc
        gnorm = self.global_norm(grads, sliced=True)
        if not bool(gnorm < tc.max_grad_norm):
            grads = {s: (g / gnorm.to(g.dtype)) * tc.max_grad_norm
                     for s, g in grads.items()}
        slotted = [(k, s) for k in self.keys if not self._factored(k)
                   for s in self.slots(k)]
        views = {s: self.view(flat[k], s) for k, s in slotted}
        if tc.optimizer == "adafactor":
            self._adafactor(grads, state, views)
            self._factored_step(grads, state, flat)
        else:
            self._adamw(grads, state, views)
        state["count"] += 1
        if self.zero1 and not self.mesh.is_local:
            for k in self.keys:  # every data rank's slice, in place
                if self._sliced(k) and not self._factored(k):
                    whole = self._whole_over_data(
                        [views[s] for s in self.slots(k)], k)
                    flat[k].copy_(whole)

    def _adamw(self, grads, state, views) -> None:
        """``optax.adamw`` on each slot of ``views``.  A first moment
        stored narrower than the gradient (``adam_mu_dtype="bfloat16"`` on
        fp32 parameters) is read back in the gradient's dtype and times
        ``b1`` rounded to the moment's dtype (optax's weakly typed ``b1 *
        mu``), as the JAX package's jitted step computes it, so the stored
        ``mu`` is bit-equal to optax's; the update uses that wider moment,
        and only the stored ``mu`` is rounded.  On bf16 parameters the
        moment is bf16 either way, as in optax."""
        tc = self.tc
        count = state["count"] + 1
        bc1 = _bias_correction(tc.adam_b1, count)
        bc2 = _bias_correction(tc.adam_b2, count)
        step_size = -self.schedule(state["count"])
        for s, param in views.items():
            g, mu, nu = grads[s], state["mu"][s], state["nu"][s]
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
            u = (u + tc.weight_decay * param) * step_size
            param.add_(u)

    # ``optax.adafactor(lr, multiply_by_parameter_scale=False,
    # clipping_threshold=None, weight_decay_rate=wd or None)``:
    # ``scale_by_factored_rms`` (decay ``1 - (count + 1)^-0.8``, eps added to
    # the squared gradient, the row statistic normalised by its mean, the
    # column one not), then times the learning rate, plus ``wd * param``
    # (not scaled by the learning rate), negated.  The statistics are
    # stored in the parameter dtype and computed in fp32.

    def _adafactor(self, grads, state, views) -> None:
        """Adafactor's unfactored leaves, on each slot of ``views``."""
        tc = self.tc
        keep, new, lr = self._adafactor_rates(state)
        for s, param in views.items():
            g = grads[s]
            v = state["v"][s]
            v.copy_(keep * v.float() + new * (g * g + ADAFACTOR_EPS).float())
            u = g * v ** -0.5 * lr
            if tc.weight_decay:
                u = u + tc.weight_decay * param
            param.sub_(u)

    def _factored_step(self, grads, state, flat) -> None:
        """Adafactor's factored leaves on the pieces this process holds:
        each piece's gradient whole over the data axis, a mean over a dim
        the model axis splits summed over the model axis."""
        tc = self.tc
        keep, new, lr = self._adafactor_rates(state)
        by_path: Dict[str, List[str]] = {}
        for k in self.keys:
            if self._factored(k):
                by_path.setdefault(_key_path(k), []).append(k)
        for path, keys in by_path.items():
            full = self.full_shapes[path]
            d1, d0 = factored_dims(full)
            split = self.plan[path].dim if path in self.plan else None
            gs = [self._whole_over_data([grads[s] for s in self.slots(k)], k)
                  for k in keys]
            g2s = [g * g + ADAFACTOR_EPS for g in gs]

            def mean(xs, dim, split_dim, size):
                if dim != split_dim:
                    return [x.mean(dim) for x in xs]
                total = self.mesh.reduce_from_model(
                    [x.float().sum(dim) for x in xs])
                return [(total / size).to(xs[0].dtype)] * len(xs)

            rows = mean(g2s, d0, split, full[d0])
            cols = mean(g2s, d1, split, full[d1])
            reduced = d1 - 1 if d1 > d0 else d1
            v_rows, v_cols = [], []
            for k, r, c in zip(keys, rows, cols):
                v_row, v_col = state["v_row"][k], state["v_col"][k]
                v_row.copy_(keep * v_row.float() + new * r.float())
                v_col.copy_(keep * v_col.float() + new * c.float())
                v_rows.append(v_row)
                v_cols.append(v_col)
            # v_row's dim ``reduced`` is the full dim d1.
            row_means = mean(v_rows, reduced,
                             reduced if split == d1 else None, full[d1])
            for k, g, v_row, v_col, rm in zip(keys, gs, v_rows, v_cols,
                                              row_means):
                row = (v_row / rm.unsqueeze(reduced)) ** -0.5
                u = g * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                u = u * lr
                if tc.weight_decay:
                    u = u + tc.weight_decay * flat[k]
                flat[k].sub_(u)

    def _adafactor_rates(self, state):
        """(keep, new, lr): the second moment's decay ``1 - (count +
        1)^-0.8`` split into the kept and the new share, and the learning
        rate, at this count."""
        t = np.float32(state["count"] + 1)
        decay = np.float32(1.0) - t ** np.float32(-ADAFACTOR_DECAY)
        return (float(decay), float(np.float32(1.0) - decay),
                self.schedule(state["count"]))

    # --- checkpoints: the whole state and back --------------------------

    def gather_state(self, state) -> Dict[str, Any]:
        """The optimizer state as an unsharded run keeps it (by parameter
        path, whole tensors): the held slices joined over the data axis,
        the pieces over the model axis.  Collective across processes."""
        from ..parallel.mesh import join

        out = {k: v for k, v in state.items() if not isinstance(v, dict)}
        for name in ("mu", "nu", "acc", "v"):
            if name not in state:
                continue
            per_key = {k: self._whole_over_data(
                [state[name][s] for s in self.slots(k)], k)
                for k in self.keys if self.slots(k)[0] in state[name]}
            out[name] = self._join_model(
                per_key, lambda pieces, path: join(pieces, self.plan[path]))
        for name in ("v_row", "v_col"):
            if name in state:
                out[name] = self._join_model(
                    state[name], lambda pieces, path, name=name:
                    self._join_stat(pieces, path, name))
        return out

    def _join_model(self, per_key, joiner) -> Dict[str, torch.Tensor]:
        mesh = self.mesh
        out = {}
        for path in self.paths:
            if path not in self.plan:
                if path in per_key:
                    out[path] = per_key[path]
                continue
            keys = [f"{path}#m{j}" for j in mesh.model_ranks]
            if keys[0] not in per_key:
                continue
            pieces = ([per_key[k] for k in keys] if mesh.is_local
                      else mesh.gather_model(per_key[keys[0]]))
            out[path] = joiner(pieces, path)
        return out

    def _stat_dim(self, name: str, path: str) -> Optional[int]:
        """The dim of a factored statistic that the model axis splits, or
        None where the statistic is whole on every rank."""
        d1, d0 = factored_dims(self.full_shapes[path])
        gone = d0 if name == "v_row" else d1
        dim = self.plan[path].dim
        if dim == gone:
            return None
        return dim - 1 if dim > gone else dim

    def _join_stat(self, pieces, path: str, name: str):
        from ..parallel.mesh import Split, join

        dim = self._stat_dim(name, path)
        if dim is None:
            return pieces[0]
        return join(pieces, Split("rows", dim))

    def scatter_state(self, whole: Dict[str, Any], params) -> Dict[str, Any]:
        """``gather_state``'s inverse: a whole optimizer state (a
        checkpoint's, by parameter path) cut into this process's keys and
        slots, on the parameters' device (``params``: a whole state or the
        held model ranks' trees).  A tensor that is not cut is kept as it
        is."""
        from ..parallel.mesh import Split, cut

        mesh = self.mesh
        flat = self._layout(params)
        out = {k: v for k, v in whole.items() if not isinstance(v, dict)}

        def piece(t, key):
            path = _key_path(key)
            t = t.to(flat[key].device)
            if path in self.plan:
                t = cut(t, self.plan[path], _key_rank(key), mesh.model)
            return t

        for name in ("mu", "nu", "acc", "v"):
            if name not in whole:
                continue
            out[name] = {}
            for k in self.keys:
                path = _key_path(k)
                if path not in whole[name]:
                    continue
                t = piece(whole[name][path], k)
                for s in self.slots(k):
                    v = self.view(t, s)
                    out[name][s] = v.clone() if v is not t else v
        for name in ("v_row", "v_col"):
            if name not in whole:
                continue
            out[name] = {}
            for k in self.keys:
                path = _key_path(k)
                if path not in whole[name]:
                    continue
                t = whole[name][path].to(flat[k].device)
                if path in self.plan:
                    dim = self._stat_dim(name, path)
                    if dim is not None:
                        t = cut(t, Split("rows", dim), _key_rank(k),
                                mesh.model)
                out[name][k] = t
        return out

    def rank_bytes(self, state) -> Dict[tuple, int]:
        """{(data rank, model rank): bytes of the optimizer state that rank
        keeps} for the ranks this process holds."""
        out = {}
        for d in self.mesh.data_ranks:
            for m in self.mesh.model_ranks:
                total = 0
                for v in state.values():
                    if not isinstance(v, dict):
                        continue
                    for s, t in v.items():
                        if _key_rank(s) != m and "#m" in s:
                            continue
                        if "#d" in s and int(s.rsplit("#d", 1)[1]) != d:
                            continue
                        total += t.numel() * t.element_size()
                out[(d, m)] = total
        return out


def make_optimizer(tc: TrainConfig, params, mesh=None,
                   plan=None) -> Optimizer:
    """The optimizer over ``trainable_mask(params, tc.stage, lora=
    tc.lora_rank > 0)``; raises ``ValueError`` where that set holds an
    integer tensor (a quantized base trained without LoRA).  On a mesh,
    ``params`` are the held model ranks' trees and ``plan`` their split
    (``parallel.mesh.shard_params``, ``split_plan``)."""
    check_supported(tc)
    tree = held(params)[0]
    paths = trainable_mask(tree, tc.stage, lora=tc.lora_rank > 0)
    flat = flatten_state(tree)
    ints = sorted(p for p in paths if not flat[p].is_floating_point())
    if ints:
        raise ValueError(
            f"stage {tc.stage} would train {len(ints)} integer tensors of "
            f"quantized kernels ({ints[0]}, ...): a quantized base trains "
            "only with LoRA adapters (lora_rank > 0)")
    optimizer = Optimizer(tc, paths, mesh, plan)
    optimizer._layout(params)
    return optimizer


def _sp_spec(tc: TrainConfig, sp_group):
    if tc.sp is None:
        return None
    if sp_group is None:
        raise ValueError("tc.sp requires the sp_group argument")
    return {"group": sp_group, "kind": tc.sp}


def make_loss_fn(cfg: RewardConfig, tc: TrainConfig,
                 sp_group=None, mesh=None) -> Callable:
    """(params, batch, vit_rng=None, totals=None, tile0=0) -> scalar fp32
    loss: two reward forwards, one per video, then the stage loss.
    ``sp_group`` (a ``parallel.sequence.SequenceGroup``) is required when
    ``tc.sp`` is set.  ``vit_rng`` (a ``vit.NoiseKey``): the ViT's DropPath
    and dropout, video v drawing from ``vit_rng.fold_in(v)``, as JAX folds
    it, its first tile at global index ``tile0``.  ``mesh``: ``params``
    may be the held model ranks' trees, and ``batch`` one data shard's,
    whose loss divides by the whole batch's ``totals``
    (``losses.batch_totals``; the labels of ``losses.WHOLE_BATCH_KEYS``
    whole)."""
    mse = tc.mse if tc.mse is not None else tc.stage_mse_default()
    stage_loss = STAGES[tc.stage].loss_fn
    sp = _sp_spec(tc, sp_group)

    def loss_fn(params, batch, vit_rng=None, totals=None, tile0=0):
        outs = []
        for v in (0, 1):
            pix = batch[f"video_{v}_pixel_values"]
            # (B, P, H, W, 3) -> (B*P, H, W, 3), as criteria_train.py:70-72.
            pix = pix.reshape((-1,) + tuple(pix.shape[-3:]))
            key = None if vit_rng is None else vit_rng.fold_in(v)
            if key is not None and tile0:
                key = key.starting_at(tile0)
            outs.append(reward_forward(
                params, cfg, pix, batch[f"video_{v}_input_ids"],
                batch[f"video_{v}_attention_mask"],
                batch[f"video_{v}_gating_pos"], impl=tc.attn_impl,
                remat=tc.remat, sp=sp, vit_rng=key, mesh=mesh))
        kw = {} if totals is None else {"totals": totals}
        if tc.stage > 1:
            return stage_loss(outs[0], outs[1], batch, mse=mse, beta=tc.beta,
                              **kw)
        return stage_loss(outs[0], outs[1], batch, mse=mse, **kw)

    return loss_fn


def make_train_step(cfg: RewardConfig, tc: TrainConfig,
                    optimizer: Optimizer, sp_group=None) -> Callable:
    """(params, opt_state, batch, rng=None) -> (params, opt_state,
    {"loss", "grad_norm"}) on ``optimizer.mesh``.  ``params``: a whole
    state, or the held model ranks' trees (``shard_params``); they are
    updated in place (the JAX step donates them).  ``grad_norm`` is the
    global norm of the micro-batch's trainable gradients before clipping;
    ``rng``: the step's ViT noise key.

    Without ``tc.sp`` the batch splits over the data axis
    (``shard_batch``): each held data shard takes its own forward and its
    own gradient, the loss's normalisers read the whole batch's counts
    when the axis is above 1 (``losses.batch_totals`` summed over the data
    axis, the stage-3 BT's labels gathered), and the gradients are summed
    over the data axis (in shard order locally, ``all_reduce`` across
    processes), as GSPMD's psum comes before ``MultiSteps`` in JAX.  Under
    ``tc.sp`` the whole batch runs sequence-parallel over ``sp_group`` (the
    mesh's data axis in a ``Trainer``); in a distributed group each rank's
    backbone gradients cover its own rows, so they are summed over the
    group, and the head's are whole already."""
    from ..parallel.mesh import shard_batch
    from .losses import WHOLE_BATCH_KEYS, batch_totals

    from ..parallel.mesh import model_summed

    mesh = optimizer.mesh
    loss_fn = make_loss_fn(cfg, tc, sp_group, mesh)
    trainable = set(optimizer.paths)
    summed = ([] if sp_group is None or sp_group.is_local else
              [k for k in optimizer.keys if k.startswith("model/")])
    # A column member's LoRA ``a``: each model rank's gradient is its
    # share, summed over the model axis before the data axis's sum.
    shared = set(model_summed(optimizer.plan)) if mesh.model > 1 else set()
    shares = [i for i, k in enumerate(optimizer.keys) if k in shared]

    def train_step(params, opt_state, batch, rng=None):
        for tree in held(params):
            set_trainable(tree, trainable)
        flat = held_flat(held(params), mesh, optimizer.plan)
        leaves = [flat[k] for k in optimizer.keys]
        # In a local mesh the other held ranks' leaves of the shared keys.
        copies = ([flatten_state(t)[optimizer.keys[i]] for i in shares
                   for t in held(params)[1:]] if mesh.is_local else [])

        def grads_of(loss):
            inputs = leaves + copies
            got = [torch.zeros_like(t) if g is None else g for t, g in zip(
                inputs, torch.autograd.grad(loss, inputs,
                                            allow_unused=True))]
            grads, rest = got[:len(leaves)], iter(got[len(leaves):])
            for i in shares:
                if mesh.is_local:
                    for _ in range(mesh.model - 1):
                        grads[i] = grads[i] + next(rest)
                else:
                    import torch.distributed as dist

                    dist.all_reduce(grads[i], group=mesh.model_group)
            return grads

        if tc.sp is not None:
            loss = loss_fn(params, batch, rng)
            grads = grads_of(loss)
            loss = loss.detach()
            if summed:
                import torch.distributed as dist

                for k, g in zip(optimizer.keys, grads):
                    if k in summed:
                        dist.all_reduce(g, group=sp_group.process_group)
        else:
            parts = [batch] if mesh.data == 1 else shard_batch(batch, mesh)
            totals = None
            if mesh.data > 1:
                counts = [batch_totals(p) for p in parts]
                totals = {k: mesh.sum_over_data([c[k] for c in counts])
                          for k in counts[0]}
                totals.update({k: mesh.gather_data([p[k] for p in parts])
                               for k in WHOLE_BATCH_KEYS if k in batch})
            pix = batch["video_0_pixel_values"]
            tiles = (pix.shape[0] // mesh.data) * pix.shape[1]
            loss = grads = None
            for d, part in zip(mesh.data_ranks, parts):
                part_loss = loss_fn(params, part, rng, totals, d * tiles)
                part_grads = grads_of(part_loss)
                part_loss = part_loss.detach()
                if grads is None:
                    loss, grads = part_loss, part_grads
                else:
                    loss = loss + part_loss
                    grads = [a + b for a, b in zip(grads, part_grads)]
            if not mesh.is_local and mesh.data > 1:
                loss = mesh.sum_over_data([loss])
                grads = [mesh.sum_over_data([g]) for g in grads]
        grads = dict(zip(optimizer.keys, grads))
        gnorm = optimizer.global_norm(grads, sliced=False)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

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
    every process of a distributed group feeds the same batches.

    ``mesh`` (a ``parallel.mesh.Mesh``, JAX ``trainer.py:286-313``;
    ``Mesh.local(1, 1)`` by default): the parameters are placed by the TP
    rules, and ``self.params`` is the whole state where the model axis is
    1, else the list of the held model ranks' trees (``whole_params``
    gathers them); the step runs on the mesh (``make_train_step``,
    ``Optimizer``, ZeRO-1 under ``tc.zero1``), and under ``tc.sp`` the data
    axis carries the sequence (``mesh.sequence_group()``).  Without a mesh,
    ``tc.mesh_data_axis`` / ``tc.mesh_model_axis`` other than 1 (or -1 for
    the data axis) make one (``parallel.mesh.make_mesh``).  A checkpoint is
    the whole state, gathered before it is written (by rank 0 across
    processes), the same file as an unsharded run's; resume cuts it again
    for the mesh it resumes on.  LoRA wraps the whole state before it is
    placed (JAX's order), so the adapters split with their kernels
    (``parallel.mesh.split_plan``) and train on any mesh."""

    def __init__(self, cfg: RewardConfig, params, tc: TrainConfig,
                 mesh=None, sp_group=None):
        from ..parallel.mesh import Mesh, make_mesh

        self.cfg = cfg
        self.tc = tc
        self.device = first_tensor(params).device
        if mesh is None and sp_group is None and (
                tc.mesh_model_axis != 1
                or tc.mesh_data_axis not in (-1, 1)):
            mesh = make_mesh(tc.mesh_data_axis, tc.mesh_model_axis)
        if tc.sp is not None and sp_group is None and mesh is not None:
            sp_group = mesh.sequence_group()
        if mesh is None:
            mesh = Mesh.local(1, 1)
        self.mesh = mesh
        if tc.lora_rank > 0:
            from ..ops.lora import apply_lora

            # Idempotent: a state already wrapped (a warm start from a LoRA
            # checkpoint) passes through unchanged.
            params = apply_lora(
                params, torch.Generator(device=self.device).manual_seed(
                    tc.lora_rank), tc.lora_rank, alpha=tc.lora_alpha)
        self._place(params)
        self.optimizer = make_optimizer(tc, self.params, mesh, self.plan)
        self.opt_state = self.optimizer.init(self.params)
        self.step_fn = make_train_step(cfg, tc, self.optimizer, sp_group)
        self.step = 0
        vis = cfg.chat.vision
        self._needs_vit_rng = vis.drop_path_rate > 0.0 or vis.dropout > 0.0
        self._base_rng = NoiseKey(0)
        if self._writes:
            os.makedirs(tc.checkpoint_dir, exist_ok=True)
        self._metrics_path = os.path.join(tc.checkpoint_dir, "metrics.jsonl")
        self._saved: List[str] = []
        self._tb = None
        if tc.tensorboard and self._writes:
            # The reference logs the Trainer's scalars to TensorBoard
            # (criteria_train.py:35,424); JSONL stays on either way.
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(tc.checkpoint_dir, "tb"))
            except ImportError as e:
                print(f"tensorboard logging is off ({e}); metrics go to "
                      f"{self._metrics_path} only")

    @property
    def _writes(self) -> bool:
        """Whether this process writes the files: rank 0 of a distributed
        mesh, any process otherwise."""
        return self.mesh.is_local or self.mesh.rank == 0

    def _place(self, params) -> None:
        """``self.params`` and ``self.plan`` from a whole state: the held
        model ranks' trees, or the state itself where the model axis is
        1."""
        from ..parallel.mesh import shard_params, split_plan

        self.plan = split_plan(params, self.mesh.model, self.cfg)
        shards = shard_params(params, self.mesh, cfg=self.cfg)
        self.params = shards if self.mesh.model > 1 else shards[0]

    def whole_params(self):
        """The whole parameter state: the held trees joined (all-gathered
        over the model axis across processes)."""
        from ..parallel.mesh import gather_params

        return gather_params(held(self.params), self.mesh, self.plan)

    def whole_opt_state(self):
        """The optimizer state as an unsharded run keeps it (collective
        across processes)."""
        return self.optimizer.gather_state(self.opt_state)

    def log(self, record: Dict[str, Any]) -> None:
        """One JSONL line; with TensorBoard, each int or float entry but
        ``step`` as a scalar at ``record["step"]`` (JAX
        ``trainer.py:375-381``).  Rank 0 of a distributed mesh writes."""
        if not self._writes:
            return
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
        background, at most one save outstanding.  On a mesh the state is
        gathered whole on the calling thread first (every process takes
        part), and rank 0 writes it."""
        path = self._checkpoint_path(self.step)
        block = not self.tc.async_checkpoint
        state = {"params": _detached(self.whole_params()),
                 "opt_state": self.whole_opt_state(), "step": self.step}
        if not self._writes:
            return path
        save_state(state, path, block=block)
        del state
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
        return first_tensor(
            held(self.params)[0]["model"]["vision_model"]).dtype

    def _forward_split(self, placed, v: int):
        """Video ``v``'s reward forward over a placed batch without
        autograd: each held data shard's rows on a mesh without ``tc.sp``,
        the outputs gathered in row order."""
        from ..models.reward import RewardOutput
        from ..parallel.mesh import shard_batch

        mesh, tc = self.mesh, self.tc
        parts = ([placed] if mesh.data == 1 or tc.sp is not None
                 else shard_batch(placed, mesh))
        outs = []
        for part in parts:
            pix = part[f"video_{v}_pixel_values"]
            outs.append(reward_forward(
                self.params, self.cfg,
                pix.reshape((-1,) + tuple(pix.shape[-3:])),
                part[f"video_{v}_input_ids"],
                part[f"video_{v}_attention_mask"],
                part[f"video_{v}_gating_pos"], impl=tc.attn_impl,
                remat=False, mesh=mesh))
        if len(outs) == 1 and (mesh.is_local or mesh.data == 1
                               or tc.sp is not None):
            return outs[0]
        return RewardOutput(*(mesh.gather_data(list(f)) for f in zip(*outs)))

    @torch.no_grad()
    def evaluate(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
        """In-training eval: pairwise preference accuracy and the
        per-criteria and per-aspect binary metrics
        (``overall_train.py:390-442`` and ``evaluate_aspect`` :204-306) from
        batched reward forwards without gradients (K1 and K2 on the card,
        never their lse forms), logged to the metrics JSONL.  The
        parameters are not changed.  On a mesh each batch splits over the
        data axis (JAX's ``shard_batch``, ``trainer.py:415``) and the
        outputs are gathered."""
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
                o = self._forward_split(placed, v)
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
        ``self.step`` onward, resume is bit-exact.  On a mesh the whole
        checkpoint is cut again for this mesh."""
        wait_for_saves()  # never read a checkpoint still being written
        if not self.mesh.is_local:
            import torch.distributed as dist

            dist.barrier()  # rank 0's file is whole before anyone reads it
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
        self._place(ckpt["params"])
        self.opt_state = self.optimizer.scatter_state(ckpt["opt_state"],
                                                      self.params)
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
