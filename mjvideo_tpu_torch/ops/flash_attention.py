"""The two attention kernels of the scoring path, each beside its plain twin.

Counterpart of ``mjvideo_tpu/ops/flash_attention.py``:

* ``vit_attention`` replaces ``_fwd_nc_kernel`` (K1): non-causal, maskless
  MHA over one tile's tokens, with the Cauchy-Schwarz softmax shift
  ``m_i = |scale| * |q_i| * max_j |k_j|`` and the denominator floored at
  1e-30.  The JAX caller pre-pads 1025 -> 1032 and subtracts the pad mass
  analytically; here the kernel takes S as it is and masks its own tail.
* ``decoder_attention`` replaces ``_fwd_bound_kernel`` (K2): causal
  attention with a (B, K) key mask and GQA (q head h reads kv head h // G),
  under the same bound with ``kmax`` the largest *masked* key norm per
  (b, kv head).  Because the shift is constant along a row, the kernel keeps
  plain sums of ``exp(s - m) v`` and ``exp(s - m)`` with no running max.
  A row whose sum is 0 (every key masked) gives 0.

For a CPU tensor each wrapper computes its plain twin; for a CUDA tensor it
launches the hand-written kernel (``mjvideo_tpu_torch/kernels.py``) or
raises.  The twins keep the kernels' arithmetic: fp32 scores, the bound,
``p`` rounded to the value dtype before the product with v, the floor and
the dead-row rule.
"""

from __future__ import annotations

from typing import Optional

import torch

DEAD_FLOOR = 1e-30


def key_norm_max(k: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Hkv) fp32: the largest norm of a key the mask lets through.

    k: (B, K, Hkv, D); attention_mask: (B, K), 1 = real.  Reduced outside
    the kernels, as ``_fwd_impl`` does (``flash_attention.py:489-511``).
    """
    kn2 = k.float().square().sum(-1)  # (B, K, Hkv)
    if attention_mask is not None:
        kn2 = kn2 * (attention_mask != 0)[:, :, None].float()
    return kn2.amax(dim=1).sqrt().contiguous()


def _bound_attention_plain(q, k, v, allowed, kmax, scale, floor):
    """Shared twin arithmetic.  allowed: bool, broadcastable to (B, Q, K)."""
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Q, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qn = qf.square().sum(-1).sqrt().permute(0, 2, 3, 1)  # (B, Hkv, G, Q)
    m = (qn * (kmax * abs(scale))[:, :, None, None])[..., None]
    p = torch.where(allowed[:, None, None], torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    if floor:
        out = acc / l.clamp_min(DEAD_FLOOR)
    else:
        live = l > 0.0
        out = torch.where(live, acc / torch.where(live, l, 1.0), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Q, Hq, D).to(q.dtype)


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of K1.  q/k/v: (B, S, H, D) -> (B, S, H, D)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    allowed = torch.ones((1, 1, 1), dtype=torch.bool, device=q.device)
    return _bound_attention_plain(q, k, v, allowed, key_norm_max(k), scale,
                                  floor=True)


def decoder_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain twin of K2.  q: (B, Q, Hq, D); k/v: (B, K, Hkv, D);
    attention_mask: (B, K); q_offset: (B,) global position of q row 0."""
    B, Q = q.shape[:2]
    K = k.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dev = q.device
    off = (torch.zeros(B, dtype=torch.long, device=dev) if q_offset is None
           else q_offset.long())
    q_pos = off[:, None] + torch.arange(Q, device=dev)[None]  # (B, Q)
    allowed = q_pos[:, :, None] >= torch.arange(K, device=dev)[None, None]
    if attention_mask is not None:
        allowed = allowed & (attention_mask != 0)[:, None, :]
    return _bound_attention_plain(q, k, v, allowed,
                                  key_norm_max(k, attention_mask), scale,
                                  floor=False)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, scale)
    from .. import kernels

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return kernels.vit_attention(q, k, v, key_norm_max(k), scale)


def decoder_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return decoder_attention_plain(q, k, v, attention_mask, q_offset,
                                       scale)
    from .. import kernels

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kmax = key_norm_max(k, attention_mask)
    if attention_mask is not None:
        attention_mask = attention_mask.to(torch.int32).contiguous()
    if q_offset is not None:
        q_offset = q_offset.to(torch.int32).contiguous()
    return kernels.decoder_attention(q, k, v, attention_mask, kmax, q_offset,
                                     scale)
