"""The attention kernels, each beside its plain twin, and the decoder
attention's gradient.

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
  A row whose sum is 0 (every key masked) gives 0.  On the training path
  its instantiation with the lse (``_fwd_bound_kernel(with_lse=True)``)
  also returns the true log-sum-exp ``m + log(l)``, or ``DEAD_LSE`` where
  ``l == 0``, in the natural ``(B, Hq, Q)`` layout.
* ``decoder_attention_backward`` replaces ``_bwd_impl`` with its two
  kernels, ``_bwd_dkdv_kernel`` (K4a) and ``_bwd_dq_kernel`` (K4b): the
  exact softmax-attention gradient recomputed from the saved lse, with
  ``delta = rowsum(dO * O)`` reduced here in fp32.  K4a sums each GQA group
  inside the kernel.
* ``_DecoderAttention`` is the ``custom_vjp`` of ``_flash_attention``
  (``flash_attention.py:848-901``): forward K2 with the lse, backward K4a
  and K4b.  ``decoder_attention`` takes it only when autograd will need it,
  so the serving path launches K2 without the lse, as before.  ``kmax`` is
  reduced without a gradient: the bound cancels from the output.

For a CPU tensor each wrapper computes its plain twin; for a CUDA tensor it
launches the hand-written kernel (``mjvideo_tpu_torch/kernels.py``) or
raises.  The twins keep the kernels' arithmetic: fp32 scores, the bound,
``p`` rounded to the value dtype before the product with v, the floor and
the dead-row rule; the backward twins round p to the dO dtype before
``p^T dO`` and dS to the q dtype before ``dS^T Q`` and ``dS K``, as the TPU
kernels do.
"""

from __future__ import annotations

from typing import Optional

import torch

DEAD_FLOOR = 1e-30
DEAD_LSE = 1e30  # lse of a row that sees no key (flash_attention.DEAD_LSE)


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


def _bound_attention_plain(q, k, v, allowed, kmax, scale, floor,
                           return_lse=False):
    """Shared twin arithmetic.  allowed: bool, broadcastable to (B, Q, K).
    With ``return_lse`` also the (B, Hq, Q) fp32 lse."""
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
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Q, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0.0, m + torch.log(l.clamp_min(DEAD_FLOOR)),
                      DEAD_LSE)
    return out, lse.reshape(B, Hq, Q)


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of K1.  q/k/v: (B, S, H, D) -> (B, S, H, D)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    allowed = torch.ones((1, 1, 1), dtype=torch.bool, device=q.device)
    return _bound_attention_plain(q, k, v, allowed, key_norm_max(k), scale,
                                  floor=True)


def _decoder_allowed(q, k, attention_mask, q_offset) -> torch.Tensor:
    """(B, Q, K) bool: key j is causally visible to q row i and not masked."""
    B, Q = q.shape[:2]
    K = k.shape[1]
    dev = q.device
    off = (torch.zeros(B, dtype=torch.long, device=dev) if q_offset is None
           else q_offset.long())
    q_pos = off[:, None] + torch.arange(Q, device=dev)[None]  # (B, Q)
    allowed = q_pos[:, :, None] >= torch.arange(K, device=dev)[None, None]
    if attention_mask is not None:
        allowed = allowed & (attention_mask != 0)[:, None, :]
    return allowed


def decoder_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain twin of K2.  q: (B, Q, Hq, D); k/v: (B, K, Hkv, D);
    attention_mask: (B, K); q_offset: (B,) global position of q row 0.
    With ``return_lse``: ``(out, lse)``, lse (B, Hq, Q) fp32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    allowed = _decoder_allowed(q, k, attention_mask, q_offset)
    return _bound_attention_plain(q, k, v, allowed,
                                  key_norm_max(k, attention_mask), scale,
                                  floor=False, return_lse=return_lse)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, Q, Hq, D) -> (B, Hq, Q)
    (``_bwd_impl``, ``flash_attention.py:727-729``)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def decoder_attention_bwd_plain(q, k, v, dout, lse, delta,
                                attention_mask=None, q_offset=None,
                                scale=None, want_dq=True, want_dkdv=True):
    """Plain twin of K4b (dq, (B, Q, Hq, D)) and K4a (dk and dv, each
    (B, K, Hkv, D), group-summed) from the kernels' operands: (dq, dk, dv),
    with None for a part not asked for."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Q, Hkv, G, D)
    dof = dout.float().reshape(B, Q, Hkv, G, D)
    kf, vf = k.float(), v.float()
    allowed = _decoder_allowed(q, k, attention_mask, q_offset)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    lse_ = lse.reshape(B, Hkv, G, Q)[..., None]
    p = torch.where(allowed[:, None, None], torch.exp(s - lse_), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    delta_ = delta.reshape(B, Hkv, G, Q)[..., None]
    ds = (p * (dp - delta_) * scale).to(q.dtype).float()
    dq = dk = dv = None
    if want_dq:
        dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
        dq = dq.reshape(B, Q, Hq, D).to(q.dtype)
    if want_dkdv:
        dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf).to(k.dtype)
        dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype).float(),
                          dof).to(v.dtype)
    return dq, dk, dv


def decoder_attention_backward_plain(q, k, v, attention_mask, q_offset, out,
                                     lse, dout, scale=None):
    """Plain twin of ``decoder_attention_backward``: (dq, dk, dv)."""
    dout = dout.to(q.dtype)
    return decoder_attention_bwd_plain(q, k, v, dout, lse,
                                       attention_delta(out, dout),
                                       attention_mask, q_offset, scale)


def decoder_attention_backward(q, k, v, attention_mask, q_offset, out, lse,
                               dout, scale=None):
    """Gradient of ``decoder_attention`` from its output and lse: (dq, dk,
    dv).  K4a and K4b on a CUDA tensor, the twin on a CPU tensor."""
    if q.device.type == "cpu":
        return decoder_attention_backward_plain(q, k, v, attention_mask,
                                                q_offset, out, lse, dout,
                                                scale)
    from .. import kernels

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dout = dout.to(q.dtype).contiguous()
    delta = attention_delta(out, dout)
    attention_mask, q_offset = _int32_operands(attention_mask, q_offset)
    dk, dv = kernels.decoder_attention_bwd_dkdv(q, k, v, dout, lse, delta,
                                                attention_mask, q_offset,
                                                scale)
    dq = kernels.decoder_attention_bwd_dq(q, k, v, dout, lse, delta,
                                          attention_mask, q_offset, scale)
    return dq, dk, dv


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, scale)
    from .. import kernels

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return kernels.vit_attention(q, k, v, key_norm_max(k), scale)


def _int32_operands(attention_mask, q_offset):
    if attention_mask is not None:
        attention_mask = attention_mask.to(torch.int32).contiguous()
    if q_offset is not None:
        q_offset = q_offset.to(torch.int32).contiguous()
    return attention_mask, q_offset


def _decoder_attention_fwd(q, k, v, attention_mask, q_offset, scale,
                           with_lse):
    """K2 (with or without the lse) on a CUDA tensor, its twin on a CPU
    tensor."""
    if q.device.type == "cpu":
        return decoder_attention_plain(q, k, v, attention_mask, q_offset,
                                       scale, return_lse=with_lse)
    from .. import kernels

    kmax = key_norm_max(k, attention_mask)
    attention_mask, q_offset = _int32_operands(attention_mask, q_offset)
    return kernels.decoder_attention(q, k, v, attention_mask, kmax, q_offset,
                                     scale, with_lse=with_lse)


class _DecoderAttention(torch.autograd.Function):
    """K2 with the lse forward, K4a and K4b backward."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask, q_offset, scale):
        out, lse = _decoder_attention_fwd(q, k, v, attention_mask, q_offset,
                                          scale, with_lse=True)
        ctx.save_for_backward(q, k, v, attention_mask, q_offset, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, attention_mask, q_offset, out, lse = ctx.saved_tensors
        dq, dk, dv = decoder_attention_backward(q, k, v, attention_mask,
                                                q_offset, out, lse, dout,
                                                ctx.scale)
        return dq, dk, dv, None, None, None


def decoder_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain twin on a CPU tensor; differentiable
    in q, k and v through K4a and K4b (their twin on the CPU)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _DecoderAttention.apply(q, k, v, attention_mask, q_offset,
                                       scale)
    return _decoder_attention_fwd(q, k, v, attention_mask, q_offset, scale,
                                  with_lse=False)
