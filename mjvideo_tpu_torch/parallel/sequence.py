"""Sequence parallelism for long-video attention.

Counterpart of ``mjvideo_tpu/parallel/sequence.py``.  The query sequence of
the decoder's attention is cut into n shards of S/n rows, two ways:

* ``sp_flash_attention``: K/V (and the key mask) gathered whole, then each
  shard's queries through K3 with ``q_offset = rank * S/n``; differentiable
  through ``_ExactAttention`` (K3 with the lse, K4a, K4b) and the gather.
* ``ring_flash_attention``: the K/V chunks travel around the ring; every
  step each shard attends its queries to the chunk it holds with K3 lse at
  the relative offset ``(my - src) * S/n``, and the chunks' (out, lse) pairs
  merge by log-sum-exp.  Its backward (``_RingAttention``) is the second
  ring of ``_ring_vjp_bwd``: with the merged global lse, K4a and K4b apply
  per chunk; dQ accumulates on its shard, and each chunk's dK/dV partials
  travel with the chunk and arrive home after n hops.

Both run JAX's schedule: every shard, every step, chunks wholly above the
diagonal included (their K3 lse and K4 launches return at once, every row
dead).  ``SequenceGroup`` stands where JAX passes ``(mesh, axis)``; the
per-step arithmetic is written once and shared by its two forms.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.flash_attention import (
    DEAD_LSE,
    attention_backward_from_delta,
    attention_delta,
    exact_attention,
    exact_attention_with_lse,
)

# lse of a row that saw no key in any chunk: finite, so that the backward's
# exp(s - lse) is exactly 0 instead of a NaN from (-inf) - (-inf)
# (sequence.py:190-194).
NO_MASS_LSE = 1e9


class SequenceGroup:
    """The n shards of a sequence, where JAX passes ``(mesh, axis)``.

    * ``SequenceGroup.local(n)``: all n shards live in this process, on one
      device.  A tensor given to the functions here holds the whole
      sequence; they cut it into n chunks, run every shard's work of a ring
      step in turn, then rotate the chunk list.
    * ``SequenceGroup.distributed(process_group)``: one shard per process of
      a ``torch.distributed`` group (rank r holds rows [r S/n, (r+1) S/n)).
      A tensor holds this rank's rows; a ring hop is ``batch_isend_irecv``
      (``ppermute``), a gather ``all_gather`` (``all_gather(tiled=True)``).
    """

    def __init__(self, size: int, rank: Optional[int] = None,
                 process_group=None):
        if size < 1:
            raise ValueError(f"a sequence group needs at least 1 shard, got "
                             f"{size}")
        self.size = size
        self.rank = rank
        self.process_group = process_group

    @classmethod
    def local(cls, n: int) -> "SequenceGroup":
        return cls(n)

    @classmethod
    def distributed(cls, process_group=None) -> "SequenceGroup":
        import torch.distributed as dist

        return cls(dist.get_world_size(process_group),
                   dist.get_rank(process_group), process_group)

    @property
    def is_local(self) -> bool:
        return self.rank is None

    @property
    def ranks(self) -> Sequence[int]:
        """The shards this process holds, in order."""
        return range(self.size) if self.is_local else (self.rank,)

    def held_rows(self, held: int) -> Tuple[int, int]:
        """(first row, total rows) of the sequence for a tensor of ``held``
        rows in this process."""
        if self.is_local:
            return 0, held
        return self.rank * held, self.size * held

    def split(self, x: torch.Tensor, dim: int = 1) -> List[torch.Tensor]:
        """One chunk of ``x`` per held shard."""
        return list(x.chunk(self.size, dim)) if self.is_local else [x]

    def join(self, parts: Sequence[torch.Tensor], dim: int = 1):
        return torch.cat(list(parts), dim) if self.is_local else parts[0]

    def shift(self, held: List[tuple]) -> List[tuple]:
        """One ring hop: shard r's tensors go to shard r + 1 (mod n), as
        ``ppermute`` with ``_ring_perm``.  ``held``: one tuple of tensors
        per held shard; returns what each held shard holds after the hop."""
        if self.is_local:
            return held[-1:] + held[:-1]
        import torch.distributed as dist

        (sent,) = held
        sent = tuple(t.contiguous() for t in sent)
        got = tuple(torch.empty_like(t) for t in sent)
        nxt = dist.get_global_rank(self.process_group,
                                   (self.rank + 1) % self.size) \
            if self.process_group is not None else (self.rank + 1) % self.size
        prv = dist.get_global_rank(self.process_group,
                                   (self.rank - 1) % self.size) \
            if self.process_group is not None else (self.rank - 1) % self.size
        ops = [dist.P2POp(dist.isend, t, nxt, self.process_group)
               for t in sent]
        ops += [dist.P2POp(dist.irecv, t, prv, self.process_group)
                for t in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [got]

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence along ``dim`` from every shard's rows; in the
        local form ``x`` already is it.  Differentiable: the backward sums
        every shard's gradient of the gathered tensor and keeps this
        shard's rows."""
        if self.is_local:
            return x
        return _Gather.apply(x, dim, self)

    def sum_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the shards, for rows that exactly one shard
        holds (the others pass zeros).  The backward passes the gradient
        through unchanged: whatever consumes the sum runs alike on every
        shard, so each holds the whole gradient already."""
        if self.is_local:
            return x
        return _SumReplicated.apply(x, self)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(group.size)]
        dist.all_gather(parts, x.contiguous(), group=group.process_group)
        ctx.dim, ctx.group, ctx.rows = dim, group, x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group.process_group)
        mine = grad.narrow(ctx.dim, ctx.group.rank * ctx.rows, ctx.rows)
        return mine.contiguous(), None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group.process_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _offset(q: torch.Tensor, off: int) -> torch.Tensor:
    return torch.full((q.shape[0],), off, dtype=torch.int32, device=q.device)


def _check_shards(group: SequenceGroup, q: torch.Tensor) -> int:
    """Rows per shard; the held rows must divide into whole shards."""
    held = q.shape[1]
    n = group.size if group.is_local else 1
    if held % n:
        raise ValueError(f"seq {held} not divisible by {group.size} shards")
    return held // n


def _safe_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp(a - b), 0 where both are -inf (sequence.py:170-171)."""
    both = torch.isneginf(a) & torch.isneginf(b)
    return torch.where(both, 0.0, torch.exp(torch.where(both, 0.0, a - b)))


def _merge(state, out_c: torch.Tensor, lse_c: torch.Tensor):
    """Fold one chunk's (out (B, L, Hq, D), lse (B, Hq, L)) into a shard's
    running (acc, m, l), in fp32 (sequence.py:165-176).  A chunk's dead
    rows (``DEAD_LSE``) enter with weight 0."""
    acc, m_run, l_run = state
    lse_c = lse_c.transpose(1, 2)
    lse_c = torch.where(lse_c >= DEAD_LSE * 0.5, -torch.inf, lse_c)
    m_new = torch.maximum(m_run, lse_c)
    alpha = _safe_exp(m_run, m_new)
    beta = _safe_exp(lse_c, m_new)
    acc = acc * alpha[..., None] + out_c.float() * beta[..., None]
    return acc, m_new, l_run * alpha + beta


def _finish(state, dtype):
    """(out in ``dtype``, the global lse (B, Hq, L) fp32, ``NO_MASS_LSE`` on
    a row with no mass) of a merged shard (sequence.py:189-195)."""
    acc, m_run, l_run = state
    out = acc / torch.where(l_run == 0.0, 1.0, l_run)[..., None]
    lse = torch.where(l_run > 0.0,
                      m_run + torch.log(l_run.clamp_min(1e-38)), NO_MASS_LSE)
    return out.to(dtype), lse.transpose(1, 2).contiguous()


def _ring_forward(group: SequenceGroup, q, k, v, mask, causal, scale):
    """The forward ring (``_ring_fwd_scan``): (out (B, S_held, Hq, D) in q's
    dtype, one global lse (B, Hq, L) per held shard)."""
    n, L = group.size, _check_shards(group, q)
    qs = group.split(q)
    held = list(zip(group.split(k), group.split(v), group.split(mask)))
    B, _, Hq, D = q.shape
    states = [(torch.zeros((B, L, Hq, D), dtype=torch.float32,
                           device=q.device),
               torch.full((B, L, Hq), -torch.inf, device=q.device),
               torch.zeros((B, L, Hq), device=q.device)) for _ in qs]
    for s in range(n):
        for i, my in enumerate(group.ranks):
            src = (my - s) % n  # the shard this chunk started on
            k_c, v_c, m_c = held[i]
            out_c, lse_c = exact_attention_with_lse(
                qs[i], k_c, v_c, m_c, _offset(q, (my - src) * L), scale,
                causal)
            states[i] = _merge(states[i], out_c, lse_c)
        if s < n - 1:  # the last hop would only bring the chunks home
            held = group.shift(held)
    outs, lses = zip(*(_finish(st, q.dtype) for st in states))
    return group.join(outs), list(lses)


def _ring_backward(group: SequenceGroup, q, k, v, mask, out, lses, dout,
                   causal, scale):
    """The second ring (``_ring_vjp_bwd``): (dq, dk, dv) of the held
    shards."""
    n, L = group.size, _check_shards(group, q)
    qs, outs = group.split(q), group.split(out)
    douts = group.split(dout.to(q.dtype))
    deltas = [attention_delta(o, d) for o, d in zip(outs, douts)]
    dqs = [torch.zeros(qc.shape, dtype=torch.float32, device=q.device)
           for qc in qs]
    held = [(k_c, v_c, m_c, torch.zeros(k_c.shape, dtype=torch.float32,
                                        device=k.device),
             torch.zeros(v_c.shape, dtype=torch.float32, device=v.device))
            for k_c, v_c, m_c in zip(group.split(k), group.split(v),
                                     group.split(mask))]
    for s in range(n):
        for i, my in enumerate(group.ranks):
            src = (my - s) % n
            k_c, v_c, m_c, dk_c, dv_c = held[i]
            dq_p, dk_p, dv_p = attention_backward_from_delta(
                qs[i], k_c, v_c, douts[i], lses[i], deltas[i], m_c,
                _offset(q, (my - src) * L), scale, causal)
            dqs[i] += dq_p.float()
            dk_c += dk_p.float()
            dv_c += dv_p.float()
        # The chunk and its gradient partials hop together; after n hops
        # both are back on their shard with every shard's contribution.
        held = group.shift(held)
    dk = group.join([h[3] for h in held]).to(k.dtype)
    dv = group.join([h[4] for h in held]).to(v.dtype)
    return group.join(dqs).to(q.dtype), dk, dv


class _RingAttention(torch.autograd.Function):
    """``_ring_local``'s custom VJP: the forward ring, then the second."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal, scale):
        out, lses = _ring_forward(group, q, k, v, mask, causal, scale)
        ctx.save_for_backward(q, k, v, mask, out, *lses)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, *lses = ctx.saved_tensors
        dq, dk, dv = _ring_backward(ctx.group, q, k, v, mask, out, lses, dout,
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def ring_flash_attention(
    q: torch.Tensor,  # (B, S_held, Hq, D)
    k: torch.Tensor,  # (B, S_held, Hkv, D)
    v: torch.Tensor,
    group: SequenceGroup,
    attention_mask: Optional[torch.Tensor] = None,  # (B, S_held), 1 = real
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention over ``group``; returns (B, S_held, Hq, D).  Each ring
    step launches K3 lse once per held shard; under autograd the backward
    ring launches K4a and K4b once per held shard and step."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if attention_mask is None:
        attention_mask = torch.ones(q.shape[:2], dtype=torch.int32,
                                    device=q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, attention_mask, group, causal,
                                    scale)
    return _ring_forward(group, q, k, v, attention_mask, causal, scale)[0]


def sp_flash_attention(
    q: torch.Tensor,  # (B, S_held, Hq, D)
    k: torch.Tensor,  # (B, S_held, Hkv, D)
    v: torch.Tensor,
    group: SequenceGroup,
    attention_mask: Optional[torch.Tensor] = None,  # (B, S_held), 1 = real
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """All-gather attention over ``group``: K/V and the mask gathered whole,
    then each held shard's S/n queries through K3 over all S keys at
    ``q_offset = rank * S/n`` (K3 lse and K4a/K4b under autograd)."""
    L = _check_shards(group, q)
    k_full, v_full = group.gather(k), group.gather(v)
    mask_full = (None if attention_mask is None
                 else group.gather(attention_mask))
    outs = [exact_attention(q_i, k_full, v_full, mask_full,
                            _offset(q, my * L), scale, causal)
            for q_i, my in zip(group.split(q), group.ranks)]
    return group.join(outs)


def shard_sequence(x: torch.Tensor, group: SequenceGroup,
                   dim: int = 1) -> torch.Tensor:
    """The rows of ``x`` along ``dim`` that this process holds: all of them
    in the local form, this rank's S/n in the distributed one."""
    if group.is_local:
        return x
    if x.shape[dim] % group.size:
        raise ValueError(f"seq {x.shape[dim]} not divisible by {group.size} "
                         "shards")
    return x.chunk(group.size, dim)[group.rank].contiguous()
