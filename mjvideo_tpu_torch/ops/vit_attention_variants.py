"""The ViT attention variants of the JAX package's A/B harnesses, each
beside its plain twin.

Counterpart of the three Pallas kernels under ``benchmarks/``:

* ``variant_attention`` replaces ``variant_impl``
  (``benchmarks/vit_attn_variants.py:63``, B1): whole-row non-causal
  softmax attention in one of four softmax modes (``VARIANT_MODES``):

  - ``"exp2"``: q is scaled by ``scale * log2(e)`` in fp32 and rounded to
    q's dtype before the product (the kernel does it in shared memory
    once the q tile lands), ``p = exp2(s - max s)``;
  - ``"bf16s"``: ``s * scale`` is rounded to bf16, m is the bf16 row max,
    ``s - m`` and ``p = exp(s - m)`` are each rounded to bf16, and l is
    summed in fp32 from the bf16 p;
  - ``"nomax"``: ``p = exp(s * scale)`` with no shift;
  - ``"exp2_nomax"``: q folded as in ``"exp2"``, ``p = exp2(s)``.

  The unshifted modes overflow once a logit passes 88 (exp) or 128
  (exp2): they are for the harness only, on inputs whose |s * scale|
  stays far below that (at N(0, 1) q and k with D = 64 it stays below
  about 8).  The JAX docstring keeps them out of the library for the
  same reason.
* ``tmajor_attention`` replaces ``tmajor_impl``
  (``benchmarks/vit_attn_variants.py:150``, B2): the exact row max on
  token-major (B, S, H, D) q/k/v with no transpose, ``hp`` adjacent heads
  per program (``TMAJOR_HP`` on the card).
* ``bshd_attention`` replaces ``nc_bshd_attention``
  (``benchmarks/vit_layout_ab.py:72``, B3): the exact row max on the
  untransposed (B, S, H, D) view, keys at or past ``kv_valid`` excluded,
  the output as (B, S, H * D).

Every variant computes ``p`` in fp32 (bf16 in ``"bf16s"``), rounds it to
v's dtype before the product with v, and divides the fp32 sum by l.  The
TPU kernels pad the keys to a multiple of 8 with zeros and subtract the
pad's mass from l analytically; the CUDA kernels and the twins give the
keys past S (or ``kv_valid``) p = 0 instead, the same function.  B2's and
B3's twin is ``exact_attention_plain`` (non-causal, over the keys below
``kv_valid``): the exact max makes l >= 1, so the TPU kernels' floor of l
at 1e-30 never acts.

For a CPU tensor each dispatcher computes the twin; for a CUDA tensor it
launches the hand-written kernel or raises: B1 and B2 run the wgmma/TMA
forward template (``csrc/decoder_attention_sm90.cuh``, through
``csrc/vit_attention_variants.cu``), which walks the keys once with a
running max and a rescale where the twins take every p against the final
max (they differ in fp32 rounding, and in ``"bf16s"`` where an earlier max
rounds d or p to another bf16); B3 runs that file's first (WMMA) kernel.  None has a backward: on a CUDA tensor that needs a gradient each
refuses the call (``kernels.forward_only``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .flash_attention import exact_attention_plain

LOG2E = kernels.LOG2E
VARIANT_MODES = kernels.VARIANT_MODES
TMAJOR_HP = kernels.TMAJOR_HP


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else scale


def variant_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mode: str,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of B1.  q/k/v: (B, S, H, D) -> (B, S, H, D) in q's
    dtype, with the mode's rounding points (see the module docstring)."""
    if mode not in VARIANT_MODES:
        raise ValueError(f"mode must be one of {VARIANT_MODES}, got {mode!r}")
    scale = _scale(q, scale)
    if mode in ("exp2", "exp2_nomax"):
        q = (q.float() * (scale * LOG2E)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mode == "exp2":
        p = torch.exp2(s - s.amax(-1, keepdim=True))
    elif mode == "exp2_nomax":
        p = torch.exp2(s)
    elif mode == "bf16s":
        s = (s * scale).to(torch.bfloat16)
        p = torch.exp(s - s.amax(-1, keepdim=True))  # each step in bf16
    else:
        p = torch.exp(s * scale)
    l = p.float().sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l).transpose(1, 2).to(q.dtype)


def tmajor_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of B2 (every ``hp`` computes the same function):
    (B, S, H, D) -> (B, S, H, D)."""
    return exact_attention_plain(q, k, v, scale=_scale(q, scale),
                                 causal=False)


def bshd_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of B3: (B, S, H, D) -> (B, S, H * D), keys at or past
    ``kv_valid`` (None: S) excluded and never read, as the kernel stages
    them as zeros."""
    B, S, H, D = q.shape
    kv = S if kv_valid is None else kv_valid
    out = exact_attention_plain(q, k[:, :kv], v[:, :kv],
                                scale=_scale(q, scale), causal=False)
    return out.reshape(B, S, H * D)


def variant_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mode: str, scale: Optional[float] = None
                      ) -> torch.Tensor:
    """B1 on a CUDA tensor, its twin on a CPU tensor."""
    if q.device.type == "cpu":
        return variant_attention_plain(q, k, v, mode, scale)
    kernels.forward_only("vit_attention_variant", q, k, v)
    return kernels.vit_attention_variant(q, k, v, mode, _scale(q, scale))


def tmajor_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     hp: int = 1, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """B2 with ``hp`` heads per CTA on a CUDA tensor, its twin on a CPU
    tensor (which checks that ``hp`` divides the heads)."""
    if q.shape[2] % hp:
        raise ValueError(f"hp={hp} must divide the {q.shape[2]} heads")
    if q.device.type == "cpu":
        return tmajor_attention_plain(q, k, v, scale)
    kernels.forward_only("vit_attention_tmajor", q, k, v)
    return kernels.vit_attention_tmajor(q, k, v, hp, _scale(q, scale))


def bshd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: Optional[int] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """B3 on a CUDA tensor, its twin on a CPU tensor: (B, S, H * D)."""
    if kv_valid is not None and not 1 <= kv_valid <= q.shape[1]:
        raise ValueError(f"kv_valid={kv_valid} must lie in [1, "
                         f"{q.shape[1]}]")
    if q.device.type == "cpu":
        return bshd_attention_plain(q, k, v, kv_valid, scale)
    kernels.forward_only("vit_attention_bshd", q, k, v)
    return kernels.vit_attention_bshd(q, k, v, kv_valid, _scale(q, scale))
