"""The attention kernels, each beside its plain twin, and the decoder
attention's gradient.

Counterpart of ``mjvideo_tpu/ops/flash_attention.py``:

* ``vit_attention`` replaces ``_fwd_nc_kernel`` (K1): non-causal, maskless
  MHA over one tile's tokens, with the Cauchy-Schwarz softmax shift
  ``m_i = |scale| * |q_i| * max_j |k_j|`` and the denominator floored at
  1e-30.  The JAX caller pre-pads 1025 -> 1032 and subtracts the pad mass
  analytically; here the kernel takes S as it is and masks its own tail.
  When autograd needs it, it goes through ``_VitAttention``, the ViT's
  ``custom_vjp``: forward K1 with the lse (``_fwd_nc_kernel(with_lse=
  True)``), backward ``vit_attention_backward``, the non-causal, maskless
  D = 64 instantiation of ``_bwd_impl``'s two kernels (K4 nc).  K1 also
  takes the Qwen2-VL vision tower's head dim of 80 and SigLIP-so400m's 72,
  without a gradient: K4 nc at D = 80 and 72 is not built
  (``K4NC_D80_NEXT``, ``K4NC_D72_NEXT``).
* ``vit_attention_masked`` replaces ``_fwd_bound_kernel`` with
  ``causal=False`` (K1m): SigLIP's variable-aspect tower, non-causal MHA
  under a (B, S) key mask (the patch mask of images padded bottom/right),
  with K2's bound (kmax the largest *live* key norm) and K2's dead-row rule
  (a row that sees no live key gives 0, no floor).  On the card the op is
  one C call: the pre-pass's masked partials, then the kernel at D = 72.
* ``decoder_attention`` replaces ``_fwd_bound_kernel`` (K2): causal
  attention with a (B, K) key mask and GQA (q head h reads kv head h // G),
  under the same bound with ``kmax`` the largest *masked* key norm per
  (b, kv head).  Because the shift is constant along a row, the kernel keeps
  plain sums of ``exp(s - m) v`` and ``exp(s - m)`` with no running max.
  A row whose sum is 0 (every key masked) gives 0.  On the card both
  take ``kmax`` from the pre-pass kernel ``kernels.key_norm_max`` (its
  twin ``key_norm_max``; one C call launches its partial pass and the
  attention kernel, which folds the partials).  On the training path
  its instantiation with the lse (``_fwd_bound_kernel(with_lse=True)``)
  also returns the true log-sum-exp ``m + log(l)``, or ``DEAD_LSE`` where
  ``l == 0``, in the natural ``(B, Hq, Q)`` layout.
* ``decoder_attention_backward`` replaces ``_bwd_impl`` with its two
  kernels, ``_bwd_dkdv_kernel`` (K4a) and ``_bwd_dq_kernel`` (K4b): the
  exact softmax-attention gradient recomputed from the saved lse, with
  ``delta = rowsum(dO * O)`` reduced here in fp32.  K4a sums each GQA group
  inside the kernel.  On the card both run on the Hopper backward template
  (``csrc/attention_bwd_sm90.cuh``, D = 128), as K4 nc does at D = 64.
* ``_DecoderAttention`` is the ``custom_vjp`` of ``_flash_attention``
  (``flash_attention.py:848-901``): forward K2 with the lse, backward K4a
  and K4b.  ``decoder_attention`` takes it only when autograd will need it,
  so the serving path launches K2 without the lse, as before.  ``kmax`` is
  reduced without a gradient: the bound cancels from the output.
* ``exact_attention`` replaces ``_fwd_kernel`` (K3): the exact online
  softmax, causal with a per-row ``q_offset`` (negative for a later
  shard's ring chunk) or non-causal, under a (B, K) key mask, with GQA; a
  row that sees no key gives 0.  Its twin takes the exact row max over the
  allowed keys.  When autograd needs it, it goes through
  ``_ExactAttention``, the ``custom_vjp`` of ``_flash_attention`` with a
  ``q_offset`` (``flash_attention.py:857-898``): forward K3 with the lse
  (``_fwd_kernel(with_lse=True)``, K3 lse), backward K4a and K4b.
  ``exact_attention_with_lse`` is ``flash_attention_with_lse``: K3 lse
  alone, the per-step call of ring sequence parallelism
  (``parallel/sequence.py``), with the lse in the natural (B, Hq, Q)
  layout.
* ``decoder_attention_rows`` replaces ``_fwd_bound_kernel(row_bound=True)``
  (K2r): K2 with a per-row bound, ``|scale| |q_i| kcum[b, h, pos_i]``,
  where ``kcum`` is the running max of masked key norms over slots <= j
  (``key_norm_cummax``; on the card K2r's pre-pass, chunk partials and a
  scan, whose twin is ``key_norm_cummax_chunked``, and K2r behind it, one
  C call) and ``pos_i = clip(q_offset + i, 0, K - 1)`` (``row_key_bound``
  on the CPU).  A row's bound depends on the tokens at or before it
  only.
* ``flash_attention`` is the JAX entry of the same name: it picks K1, K2,
  K2r or K3 from ``causal``, the mask and ``norm_bound``.

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
NEG_INF = -1e30  # masked score (flash_attention.NEG_INF)


def key_norm_max(k: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Hkv) fp32: the largest norm of a key the mask lets through.

    k: (B, K, Hkv, D); attention_mask: (B, K), 1 = real.  ``_fwd_impl``'s
    reduce (``flash_attention.py:484-511``; ``_fwd_nc_kernel`` takes the
    same max inside the kernel, :131-135).  Plain twin of the pre-pass of
    K1 and K2 (``kernels.key_norm_max``).
    """
    kn2 = k.float().square().sum(-1)  # (B, K, Hkv)
    if attention_mask is not None:
        kn2 = kn2 * (attention_mask != 0)[:, :, None].float()
    return kn2.amax(dim=1).sqrt().contiguous()


def key_norm_partials(k: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None,
                      parts: int = 1) -> torch.Tensor:
    """(B, parts, Hkv) fp32: the largest masked key norm of each chunk of
    ceil(K / parts) keys, 0 for a chunk with no live key (or none at all).
    Plain twin of the pre-pass kernel's partial pass; ``key_norm_fold`` of
    it is ``key_norm_max`` to the bit (max is exact and sqrt monotone)."""
    kn2 = k.float().square().sum(-1)  # (B, K, Hkv)
    if attention_mask is not None:
        kn2 = kn2 * (attention_mask != 0)[:, :, None].float()
    B, K, Hkv = kn2.shape
    chunk = -(-K // parts)
    kn2 = torch.nn.functional.pad(kn2, (0, 0, 0, chunk * parts - K))
    return kn2.reshape(B, parts, chunk, Hkv).amax(2).sqrt().contiguous()


def key_norm_fold(partials: torch.Tensor) -> torch.Tensor:
    """(B, Hkv) fp32 kmax from ``key_norm_partials``: the fold that the
    attention kernels (and the standalone pre-pass) take."""
    return partials.amax(1).contiguous()


def key_norm_cummax(k: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(B, Hkv, K) fp32: the running max along K of the masked key norms,
    ``kcum`` of ``_fwd_impl`` (``flash_attention.py:489-497``).  Plain twin
    of K2r's pre-pass (``kernels.key_norm_cummax``)."""
    kn2 = k.float().square().sum(-1)  # (B, K, Hkv)
    if attention_mask is not None:
        kn2 = kn2 * (attention_mask != 0)[:, :, None].float()
    return torch.cummax(kn2.sqrt(), dim=1).values.transpose(1, 2).contiguous()


def key_norm_cummax_chunked(k: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None,
                            parts: int = 1) -> torch.Tensor:
    """``key_norm_cummax`` by the pre-pass kernel's decomposition: the
    masked key norms and the largest of each chunk of ceil(K / parts) keys
    (``key_norm_partials``'s), then the scan: each chunk's running max
    starts from the largest norm of the chunks before it.  Max is exact, so
    it equals ``key_norm_cummax`` to the bit at every ``parts``."""
    kn2 = k.float().square().sum(-1)  # (B, K, Hkv)
    if attention_mask is not None:
        kn2 = kn2 * (attention_mask != 0)[:, :, None].float()
    B, K, Hkv = kn2.shape
    chunk = -(-K // parts)
    norms = torch.nn.functional.pad(kn2.sqrt(), (0, 0, 0, chunk * parts - K))
    norms = norms.reshape(B, parts, chunk, Hkv)
    part = norms.amax(2)  # (B, parts, Hkv)
    before = torch.cat([torch.zeros_like(part[:, :1]),
                        torch.cummax(part, dim=1).values[:, :-1]], dim=1)
    run = torch.maximum(torch.cummax(norms, dim=2).values, before[:, :, None])
    run = run.reshape(B, parts * chunk, Hkv)[:, :K]
    return run.transpose(1, 2).contiguous()


def row_key_bound(k: torch.Tensor, attention_mask: Optional[torch.Tensor],
                  q_offset: Optional[torch.Tensor], q_len: int,
                  q_heads: int) -> torch.Tensor:
    """(B, Hq, Q) fp32: K2r's per-row key-norm bound.  ``key_norm_cummax``
    gathered at each row's global position ``clip(q_offset + i, 0, K - 1)``
    and repeated over each GQA group, as ``_fwd_impl`` computes it outside
    the kernel (``flash_attention.py:489-508``)."""
    B, K, Hkv = k.shape[:3]
    kcum = key_norm_cummax(k, attention_mask)
    off = (torch.zeros(B, dtype=torch.long, device=k.device)
           if q_offset is None else q_offset.long().reshape(-1).expand(B))
    pos = (off[:, None] + torch.arange(q_len, device=k.device)).clamp(0, K - 1)
    rows = kcum.gather(2, pos[:, None, :].expand(B, Hkv, q_len))
    return rows.repeat_interleave(q_heads // Hkv, dim=1).contiguous()


def _bound_attention_plain(q, k, v, allowed, kmax, scale, floor,
                           return_lse=False):
    """Shared twin arithmetic.  allowed: bool, broadcastable to (B, Q, K);
    kmax: (B, Hkv), or K2r's per-row (B, Hq, Q).  With ``return_lse`` also
    the (B, Hq, Q) fp32 lse."""
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Q, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qn = qf.square().sum(-1).sqrt().permute(0, 2, 3, 1)  # (B, Hkv, G, Q)
    if kmax.dim() == 2:
        m = qn * (kmax * abs(scale))[:, :, None, None]
    else:
        m = qn * kmax.reshape(B, Hkv, G, Q) * abs(scale)
    m = m[..., None]
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
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """Plain twin of K1.  q/k/v: (B, S, H, D) -> (B, S, H, D); with
    ``return_lse`` ``(out, lse)``, lse (B, H, S) fp32, ``DEAD_LSE`` where a
    row's sum underflowed to 0 (the kernel's rule; the TPU kernel writes
    ``m + log(1e-30)`` there, and either gives p = 0 in the backward)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    allowed = torch.ones((1, 1, 1), dtype=torch.bool, device=q.device)
    return _bound_attention_plain(q, k, v, allowed, key_norm_max(k), scale,
                                  floor=True, return_lse=return_lse)


def vit_attention_masked_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, attention_mask: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of K1m.  q/k/v: (B, S, H, D); attention_mask: (B, S),
    1 = live key.  K2's arithmetic without the causal mask: the bound on
    ``key_norm_max(k, attention_mask)``, masked keys give p = 0, a row whose
    sum is 0 gives 0."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    allowed = (attention_mask != 0)[:, None, :]
    return _bound_attention_plain(q, k, v, allowed,
                                  key_norm_max(k, attention_mask), scale,
                                  floor=False)


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


def decoder_attention_rows_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain twin of K2r: K2's arithmetic under the per-row bound."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    allowed = _decoder_allowed(q, k, attention_mask, q_offset)
    bound = row_key_bound(k, attention_mask, q_offset, q.shape[1], q.shape[2])
    return _bound_attention_plain(q, k, v, allowed, bound, scale, floor=False)


def _allowed(q, k, attention_mask, q_offset, causal) -> torch.Tensor:
    """(B|1, Q|1, K) bool: the keys each q row may see."""
    if causal:
        return _decoder_allowed(q, k, attention_mask, q_offset)
    if attention_mask is None:
        return torch.ones((1, 1, k.shape[1]), dtype=torch.bool,
                          device=q.device)
    return (attention_mask != 0)[:, None, :]


def exact_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = True,
    return_lse: bool = False,
):
    """Plain twin of K3: fp32 scores, the exact softmax over the allowed
    keys with p rounded to the value dtype before p @ v, and 0 on a row
    that sees no key.  Shapes as ``decoder_attention_plain``; ``q_offset``
    is read only when causal.  With ``return_lse`` (the twin of K3 lse):
    ``(out, lse)``, lse (B, Hq, Q) fp32, the exact ``m + log(l)`` and
    ``DEAD_LSE`` on a row that sees no key."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, Q, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    allowed = _allowed(q, k, attention_mask, q_offset, causal)[:, None, None]
    qf = q.float().reshape(B, Q, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    live = l > 0.0
    out = torch.where(live, acc / torch.where(live, l, 1.0), 0.0)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Q, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(live, m + torch.log(l.clamp_min(DEAD_FLOOR)), DEAD_LSE)
    return out, lse.reshape(B, Hq, Q)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, Q, Hq, D) -> (B, Hq, Q)
    (``_bwd_impl``, ``flash_attention.py:727-729``)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def decoder_attention_bwd_plain(q, k, v, dout, lse, delta,
                                attention_mask=None, q_offset=None,
                                scale=None, want_dq=True, want_dkdv=True,
                                causal=True):
    """Plain twin of K4b (dq, (B, Q, Hq, D)) and K4a (dk and dv, each
    (B, K, Hkv, D), group-summed) from the kernels' operands: (dq, dk, dv),
    with None for a part not asked for.  ``causal=False`` (no mask, G = 1)
    is the twin of K4 nc (``vit_attention_bwd_plain``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Q, Hkv, G, D)
    dof = dout.float().reshape(B, Q, Hkv, G, D)
    kf, vf = k.float(), v.float()
    allowed = _allowed(q, k, attention_mask, q_offset, causal)
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
                                     lse, dout, scale=None, causal=True):
    """Plain twin of ``decoder_attention_backward``: (dq, dk, dv)."""
    dout = dout.to(q.dtype)
    return decoder_attention_bwd_plain(q, k, v, dout, lse,
                                       attention_delta(out, dout),
                                       attention_mask, q_offset, scale,
                                       causal=causal)


def attention_backward_from_delta(q, k, v, dout, lse, delta, attention_mask,
                                  q_offset, scale=None, causal=True):
    """(dq, dk, dv) of exact attention from dO (in q's dtype), the lse and
    delta: K4a and K4b on a CUDA tensor, their twin on a CPU tensor.  The
    ring's backward calls it once per chunk with one delta per shard, as
    ``_bwd_impl`` runs per ring step (``sequence.py:224``)."""
    if q.device.type == "cpu":
        return decoder_attention_bwd_plain(q, k, v, dout, lse, delta,
                                           attention_mask, q_offset, scale,
                                           causal=causal)
    from .. import kernels

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dout = dout.contiguous()
    attention_mask, q_offset = _int32_operands(
        attention_mask, q_offset if causal else None)
    dk, dv = kernels.decoder_attention_bwd_dkdv(q, k, v, dout, lse, delta,
                                                attention_mask, q_offset,
                                                scale, causal)
    dq = kernels.decoder_attention_bwd_dq(q, k, v, dout, lse, delta,
                                          attention_mask, q_offset, scale,
                                          causal)
    return dq, dk, dv


def decoder_attention_backward(q, k, v, attention_mask, q_offset, out, lse,
                               dout, scale=None, causal=True):
    """Gradient of ``decoder_attention`` (and of ``exact_attention``) from
    its output and lse: (dq, dk, dv).  K4a and K4b on a CUDA tensor, the
    twin on a CPU tensor."""
    if q.device.type == "cpu":
        return decoder_attention_backward_plain(q, k, v, attention_mask,
                                                q_offset, out, lse, dout,
                                                scale, causal)
    dout = dout.to(q.dtype).contiguous()
    return attention_backward_from_delta(q, k, v, dout, lse,
                                         attention_delta(out, dout),
                                         attention_mask, q_offset, scale,
                                         causal)


def vit_attention_bwd_plain(q, k, v, dout, lse, delta, scale=None,
                            want_dq=True, want_dkdv=True):
    """Plain twin of K4 nc: K4a/K4b's arithmetic without the causal mask,
    key mask or groups.  q/k/v/dout: (B, S, H, D); lse, delta: (B, H, S).
    Returns (dq, dk, dv), None for a part not asked for."""
    return decoder_attention_bwd_plain(q, k, v, dout, lse, delta, scale=scale,
                                       want_dq=want_dq, want_dkdv=want_dkdv,
                                       causal=False)


def vit_attention_backward_plain(q, k, v, out, lse, dout, scale=None):
    """Plain twin of ``vit_attention_backward``: (dq, dk, dv)."""
    dout = dout.to(q.dtype)
    return vit_attention_bwd_plain(q, k, v, dout, lse,
                                   attention_delta(out, dout), scale)


def vit_attention_backward(q, k, v, out, lse, dout, scale=None):
    """Gradient of ``vit_attention`` from its output and lse: (dq, dk, dv),
    each dense (B, S, H, D).  K4 nc on a CUDA tensor, the twin on a CPU
    tensor."""
    if q.device.type == "cpu":
        return vit_attention_backward_plain(q, k, v, out, lse, dout, scale)
    from .. import kernels

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dout = dout.to(q.dtype).contiguous()
    delta = attention_delta(out, dout)
    dk, dv = kernels.vit_attention_bwd_dkdv(q, k, v, dout, lse, delta, scale)
    dq = kernels.vit_attention_bwd_dq(q, k, v, dout, lse, delta, scale)
    return dq, dk, dv


def _vit_attention_fwd(q, k, v, scale, with_lse):
    """K1 (with or without the lse) on a CUDA tensor, its twin on a CPU
    tensor.  On the card the op is one C call: the pre-pass's partial
    maxima of the key norms, then K1, which folds them into kmax."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, scale, return_lse=with_lse)
    from .. import kernels

    return kernels.vit_attention_op(q, k, v, scale, with_lse=with_lse)


# The ViT backward at the Qwen2-VL vision tower's, SigLIP's and
# InternViT-6B's head dims: K1 runs there (the judges), its lse form and
# K4 nc do not.
K4NC_D80_NEXT = ("ROADMAP Queue 2 item 2: K1 lse and K4 nc (the ViT "
                 "attention's gradient) at the Qwen2-VL vision tower's head "
                 "dim of 80")
K4NC_D72_NEXT = ("ROADMAP Queue 2 item 2: K1 lse and K4 nc (the ViT "
                 "attention's gradient) at SigLIP-so400m's head dim of 72")
K4NC_D128_NEXT = ("ROADMAP Queue 2 item 2: K1 lse and K4 nc (the ViT "
                  "attention's gradient) at InternViT-6B's head dim of 128")
_K4NC_NEXT = {80: K4NC_D80_NEXT, 72: K4NC_D72_NEXT, 128: K4NC_D128_NEXT}


class _VitAttention(torch.autograd.Function):
    """K1 with the lse forward, K4 nc dK/dV and dQ backward: the ViT's
    ``_flash_attention`` custom VJP (``flash_attention.py:857-898``).  The
    forward runs without autograd, so ``kmax`` is reduced without a
    gradient: the bound cancels from the output."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.shape[-1] in _K4NC_NEXT:
            raise NotImplementedError(
                f"ViT attention has no gradient at head dim {q.shape[-1]} "
                f"({_K4NC_NEXT[q.shape[-1]]})")
        out, lse = _vit_attention_fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = vit_attention_backward(q, k, v, out, lse, dout,
                                            ctx.scale)
        return dq, dk, dv, None


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain twin on a CPU tensor; differentiable
    in q, k and v through K1 with the lse and K4 nc (their twins on the
    CPU), which it takes only when autograd will need them.  At head dim 80
    (the Qwen2-VL vision tower), 72 (SigLIP) and 128 (InternViT-6B) it runs
    forward only: under autograd it raises ``NotImplementedError`` on any
    device."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _VitAttention.apply(q, k, v, scale)
    return _vit_attention_fwd(q, k, v, scale, with_lse=False)


def vit_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention_mask: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """K1m on a CUDA tensor (the op: the masked pre-pass and the kernel,
    built at D = 72), its plain twin on a CPU tensor.  Forward only: under
    autograd it raises on any device."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the masked ViT attention (K1m) has no gradient; call it under "
            f"torch.no_grad() ({K4NC_D72_NEXT})")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return vit_attention_masked_plain(q, k, v, attention_mask, scale)
    from .. import kernels

    attention_mask = attention_mask.to(torch.int32).contiguous()
    return kernels.vit_attention_masked_op(q, k, v, attention_mask, scale)


def _int32_operands(attention_mask, q_offset):
    if attention_mask is not None:
        attention_mask = attention_mask.to(torch.int32).contiguous()
    if q_offset is not None:
        q_offset = q_offset.to(torch.int32).contiguous()
    return attention_mask, q_offset


def _decoder_attention_fwd(q, k, v, attention_mask, q_offset, scale,
                           with_lse):
    """K2 (with or without the lse) on a CUDA tensor, its twin on a CPU
    tensor.  On the card the op is one C call: the pre-pass's partial
    maxima of the masked key norms, then K2, which folds them into kmax."""
    if q.device.type == "cpu":
        return decoder_attention_plain(q, k, v, attention_mask, q_offset,
                                       scale, return_lse=with_lse)
    from .. import kernels

    attention_mask, q_offset = _int32_operands(attention_mask, q_offset)
    return kernels.decoder_attention_op(q, k, v, attention_mask, q_offset,
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


def _exact_attention_fwd(q, k, v, attention_mask, q_offset, scale, causal,
                         with_lse):
    """K3 (with or without the lse) on a CUDA tensor, its twin on a CPU
    tensor."""
    if q.device.type == "cpu":
        return exact_attention_plain(q, k, v, attention_mask, q_offset, scale,
                                     causal, return_lse=with_lse)
    from .. import kernels

    attention_mask, q_offset = _int32_operands(
        attention_mask, q_offset if causal else None)
    return kernels.exact_attention(q, k, v, attention_mask, q_offset, scale,
                                   causal=causal, with_lse=with_lse)


class _ExactAttention(torch.autograd.Function):
    """K3 with the lse forward, K4a and K4b backward: ``_vjp_fwd`` /
    ``_vjp_bwd`` with a ``q_offset`` (``flash_attention.py:857-898``), the
    path of all-gather sequence parallelism under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask, q_offset, scale, causal):
        out, lse = _exact_attention_fwd(q, k, v, attention_mask, q_offset,
                                        scale, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, attention_mask, q_offset, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, attention_mask, q_offset, out, lse = ctx.saved_tensors
        dq, dk, dv = decoder_attention_backward(q, k, v, attention_mask,
                                                q_offset, out, lse, dout,
                                                ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None, None


def exact_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = True,
) -> torch.Tensor:
    """K3 on a CUDA tensor, its plain twin on a CPU tensor; differentiable
    in q, k and v through K3 with the lse and K4a/K4b (their twins on the
    CPU), which it takes only when autograd will need them."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _ExactAttention.apply(q, k, v, attention_mask, q_offset, scale,
                                     causal)
    return _exact_attention_fwd(q, k, v, attention_mask, q_offset, scale,
                                causal, with_lse=False)


def exact_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = True,
):
    """``flash_attention_with_lse`` (``flash_attention.py:945``): (out, lse
    (B, Hq, Q) fp32, ``DEAD_LSE`` on a row that sees no key).  K3 lse on a
    CUDA tensor, its twin on a CPU tensor.  Not differentiable: the ring
    has its own backward (``parallel/sequence.py``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type != "cpu":
        from .. import kernels

        kernels.forward_only("exact_attention_with_lse", q, k, v)
    return _exact_attention_fwd(q, k, v, attention_mask, q_offset, scale,
                                causal, with_lse=True)


def decoder_attention_rows(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K2r on a CUDA tensor, its plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return decoder_attention_rows_plain(q, k, v, attention_mask, q_offset,
                                            scale)
    from .. import kernels

    kernels.forward_only("decoder_attention_rows", q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    attention_mask, q_offset = _int32_operands(attention_mask, q_offset)
    return kernels.decoder_attention_rows_op(q, k, v, attention_mask,
                                             q_offset, scale)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: Optional[torch.Tensor] = None,
    norm_bound=False,
) -> torch.Tensor:
    """The kernel entry (``flash_attention.py:904-942``).  q: (B, Q, Hq, D);
    k/v: (B, K, Hkv, D); attention_mask: (B, K), 1 = real; q_offset: (B,)
    or a scalar, the global position of q row 0 (causal only).

    ``norm_bound``: ``False`` takes the exact softmax (K3); ``True`` the
    Cauchy-Schwarz bound, K2 when causal, and for non-causal multi-head
    attention without an offset K1 without a mask, K1m with one;
    ``"rows"`` the causal per-row bound (K2r).  JAX takes its maskless
    kernel only while ``round_up(K, 8) <= 4096`` and the bound kernel with
    an all-ones mask past it (``flash_attention.py:440-441``); here every
    maskless call takes K1: the function is the same, softmax being
    shift-invariant."""
    if q_offset is not None:
        q_offset = torch.as_tensor(q_offset, device=q.device).reshape(-1)
        q_offset = q_offset.expand(q.shape[0])
    if norm_bound == "rows":
        if not causal:
            raise ValueError("norm_bound='rows' requires causal attention")
        return decoder_attention_rows(q, k, v, attention_mask, q_offset, scale)
    if not norm_bound:
        return exact_attention(q, k, v, attention_mask, q_offset, scale,
                               causal)
    if causal:
        return decoder_attention(q, k, v, attention_mask, q_offset, scale)
    mha = q.shape[2] == k.shape[2]
    if q_offset is None and mha:
        if attention_mask is None:
            return vit_attention(q, k, v, scale)
        return vit_attention_masked(q, k, v, attention_mask, scale)
    raise NotImplementedError(
        "no bound kernel for non-causal grouped attention or one with an "
        "offset; pass norm_bound=False for the exact kernel (K3)")
