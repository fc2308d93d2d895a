"""Rematerialisation of the decoder layers.

Counterpart of ``mjvideo_tpu/ops/remat.py``.  ``remat`` values:

* ``False`` — run the layer plainly, keeping its activations for the
  backward pass;
* ``True`` / ``"full"`` — checkpoint the whole layer with
  ``torch.utils.checkpoint`` (non-reentrant): only its inputs are kept, and
  the backward pass runs its forward once more, as ``jax.checkpoint`` does
  (the reference's ``gradient_checkpointing``);
* ``"dots"`` (keep the matmul outputs, recompute the rest) is not ported
  yet: ROADMAP Queue 1 item 9.

With autograd off (serving) the layer runs plainly whatever ``remat`` says:
there is nothing to save.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def remat_wrap(block: Callable, remat) -> Callable:
    """Wrap ``block`` per the ``remat`` spec (see the module docstring)."""
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs) is not ported yet: "
            "ROADMAP Queue 1 item 9; use remat=True or False")
    if not remat:
        return block
    if remat is not True and remat != "full":
        raise ValueError(f"unknown remat policy {remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return block(*args)
        return checkpoint(block, *args, use_reentrant=False)

    return wrapped
