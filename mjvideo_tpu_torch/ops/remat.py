"""Rematerialisation of the ViT blocks and the decoder layers.

Counterpart of ``mjvideo_tpu/ops/remat.py``.  ``remat`` values:

* ``False`` — run the layer plainly, keeping its activations for the
  backward pass;
* ``True`` / ``"full"`` — checkpoint the whole layer with
  ``torch.utils.checkpoint`` (non-reentrant): only its inputs are kept, and
  the backward pass runs its forward once more, as ``jax.checkpoint`` does
  (the reference's ``gradient_checkpointing``);
* ``"dots"`` — JAX's ``dots_with_no_batch_dims_saveable``: a selective
  checkpoint (``create_selective_checkpoint_contexts``) that keeps the
  outputs of the weight-activation products (``aten.mm`` / ``aten.addmm``,
  which ``torch.matmul`` folds a (B, S, C) @ (C, N) product into: the
  q/k/v/o and MLP projections) and recomputes everything else in the
  backward pass: the norms, the elementwise work and the attention (the
  plain path's batched products, the kernels' autograd Functions).

The kernels write their outputs through ctypes, outside the dispatcher, so
the selective checkpoint never sees those writes: this is sound because
every kernel wrapper writes only into buffers it allocates itself
(``kernels.py``, ``torch.empty``), never into a saved product's output, and
the kernels are deterministic, so the recomputed K1 lse / K2 lse gives the
first forward's lse to the bit.  Random draws inside a layer (the ViT's
DropPath and dropout) come from generators seeded afresh from their key at
each draw (``models/vit.py``), so the recompute draws the same masks.

With autograd off (serving) the layer runs plainly whatever ``remat`` says:
there is nothing to save.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

# The weight-activation products whose outputs "dots" keeps.
SAVED_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _dots_policy(ctx, func, *args, **kwargs):
    if getattr(func, "overloadpacket", None) in SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(block: Callable, remat) -> Callable:
    """Wrap ``block`` per the ``remat`` spec (see the module docstring)."""
    if not remat:
        return block
    if remat is True or remat == "full":
        kw = {}
    elif remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
    else:
        raise ValueError(f"unknown remat policy {remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return block(*args)
        return checkpoint(block, *args, use_reentrant=False, **kw)

    return wrapped
