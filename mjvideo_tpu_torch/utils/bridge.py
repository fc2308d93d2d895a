"""Parameter state: nested dicts of tensors in the JAX package's layout.

The port keeps the JAX pytree's structure and layouts unchanged: dense
kernels ``(in, out)`` applied as ``x @ kernel``, ViT and decoder layers
stacked on a leading ``L`` axis (``vit.py:60-77``, ``decoder.py:70-95``), the
patch kernel ``(P*P*3, C)``.  Crossing between the two is therefore a
leaf-by-leaf copy through numpy, with no transposes.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def map_state(fn: Callable, state):
    """Apply ``fn`` to every leaf of a nested dict, keeping its structure."""
    if isinstance(state, dict):
        return {k: map_state(fn, v) for k, v in state.items()}
    return fn(state)


def first_tensor(state) -> torch.Tensor:
    """The first leaf of a nested dict of tensors (its device is the
    state's)."""
    while isinstance(state, dict):
        state = next(iter(state.values()))
    return state


def from_jax_params(tree, *, device: torch.device = torch.device("cpu"),
                    dtype: Optional[torch.dtype] = None):
    """JAX parameter pytree (leaves: numpy or JAX arrays) -> torch state on
    ``device``, optionally cast to ``dtype``."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)

    return map_state(leaf, tree)


def to_numpy(state):
    """Torch state -> a pytree of numpy arrays in the same layout (the
    inverse of ``from_jax_params``, for the tests)."""
    return map_state(lambda t: t.detach().cpu().numpy(), state)
