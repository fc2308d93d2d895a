"""LoRA adapters as kernel nodes of the parameter state (low-rank
finetuning).

Counterpart of ``mjvideo_tpu/ops/lora.py``.  The reference finetunes the
whole LLM in every stage (``criteria_train.py:334-338``); LoRA (Hu et al.,
2021) trains a rank-r delta ``W + (alpha / r) * A @ B`` instead.  As in the
JAX package it is a node that ``ops.matmul.dot`` dispatches on, like the
quantized nodes of ``ops/quant.py``, so the model code, the stacked layers
(``utils.bridge.map_state`` slices every field), remat and the trainer work
unchanged:

* ``x @ (W + s A B)`` is computed as ``dot(x, W) + s (x A) B``: the (K, N)
  delta is never formed, and ``x A`` is a skinny (tokens, r) product.  The
  two products are ``ops.matmul.product_f32`` (``jnp.dot`` with an fp32
  result in JAX, no Pallas kernel; on the card bf16 operands multiply on
  the tensor cores with an fp32 output), in JAX's rounding order: ``x A``
  accumulated in fp32 and rounded to ``x.dtype``, ``@ B`` in fp32, then
  ``base + scale * lo`` in fp32 (the fp32 ``scale`` promotes the sum, as
  in JAX) and rounded to ``x.dtype``.  With ``B = 0`` the result is the
  base product to the bit.
* ``W`` may be a quantized node (``WOQuantKernel``, ``Q4Kernel``): its
  product recurses through ``dot``, so the base is frozen int8 or int4 and
  the adapters train (QLoRA: quantize, then ``apply_lora``).
* Freezing: ``train.trainer.trainable_mask`` never trains a field under
  ``.w`` and, in LoRA mode, trains only the ``.a`` / ``.b`` fields under
  ``model/`` (the heads keep their stage's policy).

``a`` is drawn from an explicit ``torch.Generator``: the port cannot draw
JAX's threefry bits, so the two packages' fresh adapters differ; the tests
carry JAX's adapters across with ``utils.bridge.from_jax_params``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from .quant import is_qnode, map_with_path, revive_quant_kernels


@dataclass
class LoraKernel:
    """Frozen base kernel and trainable low-rank delta.

    ``w``: (..., K, N) tensor or quantized node (frozen); ``a``: (..., K,
    r); ``b``: (..., r, N), zero at init, so the wrapped model is the base
    model to the bit until training moves ``b``; ``scale``: ``alpha / r``
    in fp32, shaped like the leading (layer-stack) axes: () for a plain
    kernel, (L,) for a stacked one, so slicing a layer slices it too."""

    w: Any
    a: torch.Tensor
    b: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.w.shape

    @property
    def ndim(self) -> int:
        return self.w.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype


def dot_lora(x: torch.Tensor, lk: LoraKernel,
             impl: str = "auto") -> torch.Tensor:
    """``x @ (w + scale * a @ b)`` without forming the delta (``lora.py:76``)."""
    from .matmul import dot, product_f32

    base = dot(x, lk.w, impl)
    lo = product_f32(product_f32(x, lk.a).to(x.dtype), lk.b)
    return (base.float() + lk.scale.float()
            * lo.to(base.dtype).float()).to(x.dtype)


def dot_lora_f32(x: torch.Tensor, lk: LoraKernel,
                 impl: str = "auto") -> torch.Tensor:
    """As ``dot_lora`` with the base product and the sum in fp32."""
    from .matmul import dot_f32, product_f32

    base = dot_f32(x, lk.w, impl)
    lo = product_f32(product_f32(x, lk.a).to(x.dtype), lk.b)
    return base + lk.scale.float() * lo


# The reference's freeze policy unfreezes the LLM decoder; the standard
# LoRA target set is its attention and MLP projections.
DEFAULT_TARGETS = (
    r"language_model/layers/attention/w[qkvo]/kernel$",
    r"language_model/layers/feed_forward/w[123]/kernel$",
)

def apply_lora(
    params: Any,
    generator: torch.Generator,
    rank: int,
    alpha: Optional[float] = None,
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> Any:
    """Wrap every kernel whose path matches ``targets`` in a LoraKernel.

    ``a`` ~ N(0, 1/rank) drawn in fp32 from ``generator`` (on its device,
    then moved to the kernel's) and rounded to the kernel's dtype (a
    quantized node's scale dtype, as JAX's; bf16 for an integer one),
    ``b`` = 0, ``scale`` = alpha / rank with ``alpha`` defaulting to the
    rank.  Already-wrapped kernels are left alone (idempotent), and
    quantized nodes are wrappable leaves (QLoRA order: quantize, then
    ``apply_lora``).  Kernels are wrapped in the state's order; the
    tensors of the state are shared, not copied."""
    from ..utils.bridge import first_tensor

    if rank <= 0:
        return params
    alpha = float(alpha if alpha is not None else rank)
    pats = [re.compile(p) for p in targets]

    def one(path, leaf):
        if isinstance(leaf, LoraKernel):
            return leaf
        if not any(p.search(path) for p in pats):
            return leaf
        if not (torch.is_tensor(leaf) or is_qnode(leaf)) or leaf.ndim < 2:
            return leaf
        *lead, K, N = leaf.shape
        dtype = (leaf.dtype if leaf.dtype.is_floating_point
                 else torch.bfloat16)
        dev = first_tensor(leaf).device
        a = (torch.randn((*lead, K, rank), generator=generator,
                         dtype=torch.float32, device=generator.device)
             * rank ** -0.5).to(device=dev, dtype=dtype)
        b = torch.zeros((*lead, rank, N), dtype=dtype, device=dev)
        return LoraKernel(w=leaf, a=a, b=b,
                          scale=torch.full(tuple(lead), alpha / rank,
                                           dtype=torch.float32, device=dev))

    return map_with_path(one, params)


def merge_lora(params: Any) -> Any:
    """Fold every adapter into its base kernel: ``w + scale * a @ b`` in
    fp32, rounded to ``w``'s dtype (for export: the merged state is a plain
    one).  A quantized base cannot be merged losslessly: raise."""
    def one(_, n):
        if not isinstance(n, LoraKernel):
            return n
        if is_qnode(n.w):
            raise ValueError(
                "merge_lora: base kernel is quantized "
                f"({type(n.w).__name__}); dequantize or export adapters "
                "separately")
        delta = torch.matmul(n.a.float(), n.b.float())
        scale = n.scale.float().reshape(tuple(n.scale.shape) + (1, 1))
        return (n.w.float() + scale * delta).to(n.w.dtype)

    return map_with_path(one, params)


def revive_lora_kernels(tree: Any) -> Any:
    """Rebuild LoraKernel nodes from plain ``{w, a, b, scale}`` dicts (a
    checkpoint written by ``utils.checkpoint.save_state``, JAX's
    structure-less orbax restore); a ``w`` that is itself a quantized
    node's dict is revived first (``ops.quant.revive_quant_kernels``)."""
    if isinstance(tree, dict):
        if set(tree) == {"w", "a", "b", "scale"}:
            return LoraKernel(w=revive_quant_kernels(tree["w"]), a=tree["a"],
                              b=tree["b"], scale=tree["scale"])
        return {k: revive_lora_kernels(v) for k, v in tree.items()}
    return tree
