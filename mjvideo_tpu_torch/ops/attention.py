"""Attention: the plain path and the one dispatch point to the kernels.

Counterpart of ``mjvideo_tpu/ops/attention.py``.  ``attention_plain`` is
the ``attention_xla`` oracle: grouped-query attention without materialising
repeated kv heads, fp32 softmax over an additive bias.  ``multi_head_attention``
routes ``impl="auto"`` to the kernels of ``flash_attention.py`` by
``norm_bound``, as the JAX entry does: the exact softmax (K3) without it, the
bound kernels with it (K1 for non-causal maskless MHA, K2 for causal
attention), the per-row bound (K2r) with ``"rows"``; each computes its plain
twin on the CPU.  ``impl="plain"`` is the explicit oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large finite negative: keeps the softmax NaN-free
# ``attention_plain`` forms its fp32 scores in blocks of query rows of at
# most this many elements (4 GiB), so that the oracle holds a 72-tile clip's
# ViT and its ~19.5k-token prompt on one card; below it, in one block.
PLAIN_BLOCK_ELEMENTS = 1 << 30


def kv_valid_mask(batch: int, kv_len: int, kv_valid: int, *,
                  device: torch.device) -> torch.Tensor:
    """(B, K) int32 mask whose first ``kv_valid`` rows are real."""
    row = (torch.arange(kv_len, device=device) < kv_valid).to(torch.int32)
    return row[None].expand(batch, kv_len)


def make_attention_bias(
    attention_mask: Optional[torch.Tensor],
    q_len: int,
    kv_len: int,
    causal: bool,
    *,
    device: torch.device,
) -> Optional[torch.Tensor]:
    """Additive fp32 (B|1, 1, Q, K) bias from a (B, K) mask and causality."""
    bias = None
    if causal:
        q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
        k_pos = torch.arange(kv_len, device=device)[None, :]
        bias = torch.where(q_pos >= k_pos, 0.0, NEG_INF)[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask.bool(), 0.0, NEG_INF)[:, None, None, :]
        bias = pad if bias is None else bias + pad
    return bias


def attention_plain(
    q: torch.Tensor,  # (B, Q, Hq, D)
    k: torch.Tensor,  # (B, K, Hkv, D)
    v: torch.Tensor,  # (B, K, Hkv, D)
    bias: Optional[torch.Tensor] = None,  # (B|1, 1|Hq, Q, K) fp32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with an fp32 softmax; returns (B, Q, Hq, D).
    Each query row's softmax is its own, so scores past
    ``PLAIN_BLOCK_ELEMENTS`` are formed a block of rows at a time."""
    B, Q, Hq, D = q.shape
    rows = max(1, PLAIN_BLOCK_ELEMENTS // (B * Hq * k.shape[1]))
    if rows < Q:
        return torch.cat([attention_plain(
            q[:, s:s + rows], k, v,
            bias if bias is None or bias.shape[2] == 1
            else bias[:, :, s:s + rows], scale)
            for s in range(0, Q, rows)], dim=1)
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    qg = q.float().reshape(B, Q, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if bias is not None:
        bias = bias.float()
        if bias.shape[1] == 1:
            logits = logits + bias[:, :, None]
        else:
            logits = logits + bias.reshape(bias.shape[0], Hkv, G, Q,
                                           bias.shape[-1])
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(B, Q, Hq, D).to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "auto",
    norm_bound=False,
) -> torch.Tensor:
    """Unified attention entry.  q/k/v: (B, S, H, D) with Hkv <= Hq.

    ``attention_mask``: (B, K), 1 = real token.  ``impl="auto"`` takes the
    kernels (their plain twins on the CPU), chosen by ``norm_bound`` (see
    ``flash_attention.flash_attention``); ``impl="plain"`` the exact-softmax
    oracle, which ignores ``norm_bound``.
    """
    if impl == "plain":
        bias = make_attention_bias(attention_mask, q.shape[1], k.shape[1],
                                   causal, device=q.device)
        return attention_plain(q, k, v, bias=bias, scale=scale)
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    from .flash_attention import flash_attention

    return flash_attention(q, k, v, attention_mask, causal=causal,
                           scale=scale, norm_bound=norm_bound)
