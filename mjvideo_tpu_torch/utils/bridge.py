"""Parameter state: nested dicts of tensors in the JAX package's layout.

The port keeps the JAX pytree's structure and layouts unchanged: dense
kernels ``(in, out)`` applied as ``x @ kernel``, ViT and decoder layers
stacked on a leading ``L`` axis (``vit.py:60-77``, ``decoder.py:70-95``), the
patch kernel ``(P*P*3, C)``.  Crossing between the two is therefore a
leaf-by-leaf copy through numpy, with no transposes.  A quantized kernel is
one leaf of the state: a node of ``ops/quant.py`` or ``ops/quant4.py``
whose tensor fields carry the same leading layer axes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..ops.quant import (
    OutlierQuantKernel,
    QuantKernel,
    WOQuantKernel,
    is_qnode,
    k_major,
)
from ..ops.quant4 import Q4Kernel


def map_state(fn: Callable, state):
    """Apply ``fn`` to every leaf of a nested dict, keeping its structure;
    in a quantized node, to each array field (``n_outliers`` stays), which
    rebuilds the node: slicing a stacked state slices its nodes too."""
    if isinstance(state, dict):
        return {k: map_state(fn, v) for k, v in state.items()}
    if is_qnode(state):
        return dataclasses.replace(state, **{
            f.name: fn(getattr(state, f.name))
            for f in dataclasses.fields(state) if f.name != "n_outliers"})
    return fn(state)


def first_tensor(state) -> torch.Tensor:
    """The first tensor of a nested dict of tensors and quantized nodes
    (its device is the state's)."""
    while isinstance(state, dict):
        state = next(iter(state.values()))
    if is_qnode(state):
        return getattr(state, dataclasses.fields(state)[0].name)
    return state


def _jax_node(a):
    """The port's node class for a JAX quantized dataclass leaf, told by its
    field names (the JAX package's are unique: ``quant.py:70-175``,
    ``quant4.py:49-75``), or None for an array."""
    if hasattr(a, "packed") and hasattr(a, "scale"):
        return Q4Kernel
    if hasattr(a, "qw") and hasattr(a, "scale"):
        return WOQuantKernel
    if hasattr(a, "q") and hasattr(a, "scale"):
        return OutlierQuantKernel if hasattr(a, "n_outliers") else QuantKernel
    return None


def _tensor(a) -> torch.Tensor:
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no numpy type of torch's
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax_params(tree, *, device: Union[str, torch.device] = "cuda",
                    dtype: Optional[torch.dtype] = None):
    """JAX parameter pytree (leaves: numpy or JAX arrays, or the JAX
    package's quantized kernels) -> torch state on ``device`` (the card
    unless the caller asks for another), plain leaves optionally cast to
    ``dtype``.  Quantized kernels become the port's nodes with their
    integer and scale fields as they are, the int8 weights (``q``, ``qw``)
    and the packed int4 ones (``packed``) k-major, as the port's quantizers
    store them (``ops.quant.k_major``: transposed on the host, moved with
    their strides)."""
    def field(name, v):
        t = _tensor(v)
        return (k_major(t) if name in ("q", "qw", "packed")
                else t).to(device=device)

    def leaf(a):
        node = _jax_node(a)
        if node is None:
            t = _tensor(a)
            return t.to(device=device, dtype=dtype or t.dtype)
        fields = {f.name: getattr(a, f.name)
                  for f in dataclasses.fields(node)}
        return node(**{k: v if k == "n_outliers" else field(k, v)
                       for k, v in fields.items()})

    return map_state(leaf, tree)


def to_numpy(state):
    """Torch state -> a pytree of numpy arrays in the same layout (the
    inverse of ``from_jax_params``, for the tests); quantized nodes keep
    their class with numpy fields."""
    return map_state(lambda t: t.detach().cpu().numpy(), state)
