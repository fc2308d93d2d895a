"""Serving quantization: the int8 weight nodes, their products, the named
modes, and the int8 KV cache's quantizer.

Counterpart of ``mjvideo_tpu/ops/quant.py``.  Modes (``quantize_params_mode``):

* ``"int8"``: w8a8, per-output-column int8 weights (``QuantKernel``) and
  dynamic per-row int8 activations; the int8 x int8 -> int32 product is
  ``torch._int_mm`` on the card (an XLA ``dot_general`` in JAX, not Pallas).
* ``-vit`` / ``-noattn``: the vision towers only / all but the decoder's
  attention projections.
* ``-gN``: group-N contraction scales for weights and activations.  On the
  card every grouped product is the hand-written K6
  (``q8g_matmul_fused``, ``csrc/q8g_matmul.cu``), whatever M, N and g (a
  multiple of 32); K7 (``q8g_matmul``) is its unfused oracle.
* ``-olN``: the runtime activation-outlier decomposition
  (``OutlierQuantKernel``), plain PyTorch.
* ``"int8-wo"``: weight-only w8a16 (``WOQuantKernel``), plain PyTorch.
* ``"int4-wo"``: weight-only int4 with group scales (``ops/quant4.py``, K5).

The nodes are plain dataclasses of tensors in the JAX layout, ``(..., K,
N)`` with leading layer axes, so ``utils.bridge.map_state`` slices stacked
layers through them.  Every int8 weight (``q`` of ``QuantKernel`` and
``OutlierQuantKernel``, ``qw`` of ``WOQuantKernel``) is stored k-major: the
``(..., K, N)`` tensor is a view of an ``(..., N, K)`` contiguous one
(``k_major``), the operand layout of the card's int8 products (K6 and K7
read 8-bit operands only K-major; ``torch._int_mm`` wants the second
operand column-major).  Values and shapes are the JAX package's.
``impl`` follows the attention's: "auto" launches the kernels for CUDA
tensors (their plain twins for CPU tensors), "plain" runs the twins
everywhere.  The twins sum int8 products exactly in int32
(``int8_matmul``); fp32 is exact only to 2^24, and K reaches 8,192 * 127^2.

The HF checkpoint loader (``utils/checkpoint.py``) reads unquantized
states, which ``quantize_params_mode`` quantizes where they lie.  A saved
quantized state (``utils.checkpoint.save_state`` writes each node as a
plain dict of its tensor fields) is rebuilt by ``revive_quant_kernels``
(``quant.py:777-815``), its int8 fields k-major again.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels


@dataclass
class QuantKernel:
    """int8 kernel ``q`` (..., K, N) and fp32 scale (..., G, N): row group
    j dequantizes as ``q[j*g:(j+1)*g] * scale[j]`` with g = K / G; G = 1
    is per output column."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:
        # The logical dtype: what dequantization produces.
        return self.scale.dtype


@dataclass
class RowsQuantKernel(QuantKernel):
    """A model rank's rows of a per-column w8a8 row member: ``q`` cut by
    rows, the per-column ``scale`` whole (``parallel.mesh.shard_params``
    makes it, ``gather_params`` makes the ``QuantKernel`` back).  Its
    product quantizes each activation row at the amax over every rank's
    slice of K (``dot_q8_rows_over_model``), where a grouped row member's
    piece, whole groups, needs no other rank's statistic."""


@dataclass
class WOQuantKernel:
    """Weight-only int8 kernel (w8a16): ``qw`` (..., K, N), ``scale``
    (..., G, N); the product runs at the activation dtype."""

    qw: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.qw.shape

    @property
    def ndim(self) -> int:
        return self.qw.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.scale.dtype


@dataclass
class OutlierQuantKernel:
    """Per-column int8 kernel whose product routes the ``n_outliers``
    activation channels of largest amax through full precision."""

    q: torch.Tensor
    scale: torch.Tensor
    n_outliers: int = 32

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.scale.dtype


# ------------------------------------------------------------ quantizers

def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, as IEEE division rounds, on every device: the
    card's division by a Python number multiplies by its reciprocal, which
    can land an ulp away and move a scale, and with it the int8 values."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def k_major(q: torch.Tensor) -> torch.Tensor:
    """``q`` (..., K, N) as a view of an (..., N, K) contiguous tensor: the
    same values, transposed strides; no copy if it is one already."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def is_k_major(q: torch.Tensor) -> bool:
    """Whether the (K, N) ``q`` is a view of an (N, K) contiguous tensor."""
    return (q.dim() == 2 and q.stride(0) == 1
            and (q.shape[1] == 1 or q.stride(1) == q.shape[0]))


def _stack_like(t: torch.Tensor, n: int) -> torch.Tensor:
    """An empty (n, *t.shape) tensor whose slices have t's layout (k-major
    for a k-major t)."""
    if is_k_major(t) and t.shape[1] > 1:
        return t.new_empty((n, t.shape[1], t.shape[0])).transpose(1, 2)
    return t.new_empty((n, *t.shape))


def _quantize_stacked(w: torch.Tensor, one):
    """Apply ``one`` (a 2-D quantizer returning a tuple of tensors) to each
    (K, N) slice of a stacked kernel, into preallocated outputs of each
    slice's layout: the fp32 transients stay one layer's worth."""
    if w.dim() == 2:
        return one(w)
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    first = one(flat[0])
    outs = [_stack_like(t, flat.shape[0]) for t in first]
    for i in range(flat.shape[0]):
        for o, t in zip(outs, first if i == 0 else one(flat[i])):
            o[i] = t
    return tuple(o.reshape(*lead, *o.shape[1:]) for o in outs)


def _int8_k_major(q: torch.Tensor) -> torch.Tensor:
    """Integral fp32 (K, N) values as a k-major int8 tensor: one cast and
    transpose, no other transient."""
    K, N = q.shape
    out = torch.empty((N, K), dtype=torch.int8, device=q.device).t()
    return out.copy_(q)


def _quantize_2d(w: torch.Tensor, dtype, group_size: Optional[int]):
    w32 = w.float()
    K, N = w32.shape
    if group_size is not None and group_size < K:
        assert K % group_size == 0, (K, group_size)
        grouped = w32.reshape(K // group_size, group_size, N)
        scale = div(grouped.abs().amax(-2, keepdim=True), 127.0)
        scale = scale.clamp_min(1e-12)
        q = torch.round(grouped / scale).clamp(-127, 127)
        return (_int8_k_major(q.reshape(K, N)),
                scale.reshape(K // group_size, N).to(dtype))
    scale = div(w32.abs().amax(-2, keepdim=True), 127.0).clamp_min(1e-12)
    q = torch.round(w32 / scale).clamp(-127, 127)
    return _int8_k_major(q), scale.to(dtype)


def quantize_kernel(w: torch.Tensor, dtype: torch.dtype = torch.float32,
                    group_size: Optional[int] = None) -> QuantKernel:
    """Symmetric int8 quantization of a dense kernel (..., K, N), per
    output column or per ``group_size`` rows of each column: scale =
    max(amax / 127, 1e-12), q = clip(round(w / scale), -127, 127), round
    half to even, all in fp32 (bit-equal to the JAX package's); q k-major
    (``k_major``)."""
    q, scale = _quantize_stacked(
        w, lambda s: _quantize_2d(s, dtype, group_size))
    return QuantKernel(q=q, scale=scale)


def dequantize_kernel(k: QuantKernel,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    G = k.scale.shape[-2]
    if G > 1:
        lead = k.q.shape[:-2]
        K, N = k.q.shape[-2:]
        grouped = k.q.reshape(*lead, G, K // G, N).float()
        w = grouped * k.scale[..., :, None, :].float()
        return w.reshape(*lead, K, N).to(dtype)
    return (k.q.float() * k.scale).to(dtype)


def _scale_rows(amax: torch.Tensor) -> torch.Tensor:
    """The dynamic activation scale of a row amax: max(amax / 127,
    1e-12)."""
    return div(amax, 127.0).clamp_min(1e-12)


def _quantize_rows(x32: torch.Tensor):
    """Dynamic per-row symmetric int8 of fp32 (..., K)."""
    a_scale = _scale_rows(x32.abs().amax(-1, keepdim=True))
    xq = torch.round(x32 / a_scale).clamp(-127, 127).to(torch.int8)
    return xq, a_scale


def _quantize_rows_grouped(x32: torch.Tensor, G: int, g: int):
    """Per-(row, group) symmetric int8 of fp32 (M, K), K = G * g: (xq int8
    (M, K), a_scale fp32 (M, G))."""
    M = x32.shape[0]
    xg = x32.reshape(M, G, g)
    a_scale = div(xg.abs().amax(-1, keepdim=True), 127.0).clamp_min(1e-12)
    xq = torch.round(xg / a_scale).clamp(-127, 127).to(torch.int8)
    return xq.reshape(M, G * g), a_scale[..., 0]


# ------------------------------------------------------ int8 products

def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (K, N) -> int32 (M, N).  On the card
    ``torch._int_mm``, with M padded to 17 or more and K and N to multiples
    of 8 where it asks for that (decode rows, the LM head's N = 92,553),
    and b column-major; on the CPU an int64 product."""
    if not a.is_cuda:
        return (a.long() @ b.long()).to(torch.int32)
    M, K = a.shape
    N = b.shape[1]
    pm, pk, pn = max(17 - M, 0), -K % 8, -N % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    # cuBLASLt's int8 product takes the second operand column-major: b^T
    # row-major, which a k-major weight is already (no copy); the padding,
    # where asked, is taken on b^T so that it stays so.
    bt = b.t()
    if pk or pn:
        bt = F.pad(bt, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return out[:M, :N] if pm or pn else out


def q8g_matmul_plain(xq: torch.Tensor, a_scale: torch.Tensor,
                     wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """K7's twin (``_q8g_matmul_xla``): per group an exact int32 partial,
    dequantized by ``a_scale * w_scale`` and summed in fp32, groups in
    order."""
    M, K = xq.shape
    G, N = w_scale.shape
    g = K // G
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    for i in range(G):
        p = int8_matmul(xq[:, i * g:(i + 1) * g], wq[i * g:(i + 1) * g])
        acc = acc + p.float() * a_scale[:, i:i + 1] * w_scale[i][None, :]
    return acc


def q8g_matmul_fused_plain(x: torch.Tensor, wq: torch.Tensor,
                           w_scale: torch.Tensor,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """K6's twin: ``_quantize_rows_grouped`` of x in fp32, then K7's twin,
    cast to ``out_dtype``."""
    K = x.shape[1]
    G = w_scale.shape[0]
    xq, a_scale = _quantize_rows_grouped(x.float(), G, K // G)
    return q8g_matmul_plain(xq, a_scale, wq, w_scale).to(out_dtype)


def q8g_matmul(xq, a_scale, wq, w_scale) -> torch.Tensor:
    """K7: the twin for a CPU tensor, the kernel for a CUDA tensor."""
    if xq.device.type == "cpu":
        return q8g_matmul_plain(xq, a_scale, wq, w_scale)
    kernels.forward_only("q8g_matmul", a_scale, w_scale)
    return kernels.q8g_matmul(xq, a_scale, wq, w_scale)


def q8g_matmul_fused(x, wq, w_scale, out_dtype) -> torch.Tensor:
    """K6: the twin for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return q8g_matmul_fused_plain(x, wq, w_scale, out_dtype)
    kernels.forward_only("q8g_matmul_fused", x, w_scale)
    if x.data_ptr() % 16:
        x = x.clone()
    return kernels.q8g_matmul_fused(x, wq, w_scale, out_dtype)


def _dot_q8_grouped(x: torch.Tensor, kernel: QuantKernel,
                    out_dtype: torch.dtype, impl: str) -> torch.Tensor:
    """Group-scaled w8a8: K6 (or its twin), output written at
    ``out_dtype``."""
    K, N = kernel.q.shape
    x2 = x.reshape(-1, K).contiguous()
    w_scale = kernel.scale.float()
    if impl == "plain":
        out = q8g_matmul_fused_plain(x2, kernel.q, w_scale, out_dtype)
    else:
        out = q8g_matmul_fused(x2, kernel.q, w_scale, out_dtype)
    return out.reshape(*x.shape[:-1], N)


def dot_q8_f32(x: torch.Tensor, kernel: QuantKernel,
               impl: str = "auto") -> torch.Tensor:
    """x @ dequant(kernel) as int8 x int8 -> int32, dequantized in fp32;
    kernel.q is one layer's (K, N).  Grouped kernels (G > 1) go to K6;
    per-column ones are ``dot_q8_rows_over_model`` on one rank."""
    assert kernel.q.dim() == 2, (
        f"dot_q8 expects a per-layer (K, N) kernel, got {kernel.q.shape}")
    if kernel.scale.shape[-2] > 1:
        return _dot_q8_grouped(x, kernel, torch.float32, impl)
    return dot_q8_rows_over_model(_one_rank(), [x], [kernel])


def dot_q8(x: torch.Tensor, kernel: QuantKernel,
           impl: str = "auto") -> torch.Tensor:
    if kernel.scale.shape[-2] > 1:
        # K6 writes the output once at x's dtype.
        return _dot_q8_grouped(x, kernel, x.dtype, impl)
    return dot_q8_f32(x, kernel, impl).to(x.dtype)


@dataclass
class GroupedOutlierQuantKernel(OutlierQuantKernel):
    """An ``OutlierQuantKernel`` held by a process with one data shard of
    the batch: its column amax is max-reduced over ``amax_group``, the
    ``torch.distributed`` group of the data axis."""

    amax_group: Any = None


def with_amax_group(params: Any, group) -> Any:
    """``params`` with every ``-olN`` node grouped over ``group`` (the
    data axis of a distributed mesh), so that a data-parallel forward
    picks the channels the unsharded batch picks."""
    if isinstance(params, dict):
        return {k: with_amax_group(v, group) for k, v in params.items()}
    if isinstance(params, OutlierQuantKernel):
        return GroupedOutlierQuantKernel(params.q, params.scale,
                                         params.n_outliers, group)
    return params


def dot_q8_ol_f32(x: torch.Tensor, kernel: OutlierQuantKernel) -> torch.Tensor:
    """x @ dequant(kernel) with the top-``n_outliers`` activation channels
    in full precision: ``dot_q8_ol_rows_over_model`` on one rank."""
    assert kernel.q.dim() == 2, (
        f"dot_q8_ol expects a per-layer (K, N) kernel, got {kernel.q.shape}")
    return dot_q8_ol_rows_over_model(_one_rank(), [x], [kernel])


def dot_q8_ol(x: torch.Tensor, kernel: OutlierQuantKernel) -> torch.Tensor:
    return dot_q8_ol_f32(x, kernel).to(x.dtype)


# ------------------------------------- row members split over the model axis

def _one_rank():
    """The model axis of a product that is not split: one rank, held in
    this process (``parallel.mesh.Mesh.local(1, 1)``)."""
    from ..parallel.mesh import Mesh

    return Mesh.local(1, 1)


def _q8_rows_sum(tp, x32s, a_scale, kernels) -> torch.Tensor:
    """Each held rank's int8 x int8 partial at the shared row scale,
    summed over the model axis in int32 (exact), dequantized once: what
    the unsharded product computes over the whole K."""
    accs = []
    for x32, k in zip(x32s, kernels):
        xq = torch.round(x32 / a_scale).clamp(-127, 127).to(torch.int8)
        accs.append(int8_matmul(xq, k.q))
    acc = tp.reduce_from_model(accs)
    return acc.float() * a_scale * kernels[0].scale.reshape(1, -1)


def dot_q8_rows_over_model(tp, xs: Sequence[torch.Tensor],
                           kernels: Sequence[QuantKernel]) -> torch.Tensor:
    """Per-column w8a8 over a K split across the model axis (``tp``, a
    ``parallel.mesh.Mesh``; one rank for a product that is not split):
    ``xs`` the held ranks' inputs, each its slice of K, ``kernels`` their
    rows of ``q`` with the whole per-column scale.  Each activation row's
    amax is max-reduced over the model axis before it quantizes
    (``_quantize_rows``), and the int32 partials are summed before they
    dequantize, so every split gives the one-rank product to the bit (JAX
    pins the same of its sharded int8 product)."""
    N = kernels[0].q.shape[1]
    lead = xs[0].shape[:-1]
    x32s = [x.reshape(-1, x.shape[-1]).float() for x in xs]
    a_scale = _scale_rows(tp.max_over_model(
        [x.abs().amax(-1, keepdim=True) for x in x32s]))
    return _q8_rows_sum(tp, x32s, a_scale, kernels).reshape(*lead, N)


def dot_q8_ol_rows_over_model(tp, xs: Sequence[torch.Tensor],
                              kernels: Sequence[OutlierQuantKernel]
                              ) -> torch.Tensor:
    """``-olN`` w8a8 over a K split across the model axis (one rank for a
    product that is not split): the top-``n_outliers`` activation channels
    by column amax over the rows (max-reduced over ``amax_group`` first,
    the data axis of a distributed mesh; every rank's gathered in channel
    order) go through full precision, ties to the lower global index as
    ``jax.lax.top_k`` breaks them (a stable descending sort), each rank
    keeping the chosen channels of its slice; the masked rows' amax is
    max-reduced over the model axis and the int32 partials summed as in
    ``dot_q8_rows_over_model``.  Each rank's outlier product is summed
    over the model axis in fp32, a few ulps from one rank's single
    product."""
    k0 = kernels[0]
    Kj, N = k0.q.shape
    lead = xs[0].shape[:-1]
    x32s = [x.reshape(-1, x.shape[-1]).float() for x in xs]
    colmaxes = [x.abs().amax(0) for x in x32s]
    group = getattr(k0, "amax_group", None)
    if group is not None:
        import torch.distributed as dist

        for c in colmaxes:
            dist.all_reduce(c, op=dist.ReduceOp.MAX, group=group)
    colmax = tp.join_model(colmaxes, -1)
    K = colmax.shape[0]
    idx = torch.sort(colmax, descending=True,
                     stable=True).indices[:min(k0.n_outliers, K)]
    mask = torch.zeros(K, dtype=torch.float32, device=colmax.device)
    mask[idx] = 1.0
    masked, outs = [], []
    for j, x32, k in zip(tp.model_ranks, x32s, kernels):
        keep = 1.0 - mask[j * Kj:(j + 1) * Kj]
        masked.append(x32 * keep)
        mine = idx[(idx >= j * Kj) & (idx < (j + 1) * Kj)] - j * Kj
        outs.append(x32[:, mine] @ (k.q[mine].float() * k.scale))
    a_scale = _scale_rows(tp.max_over_model(
        [m.abs().amax(-1, keepdim=True) for m in masked]))
    acc = _q8_rows_sum(tp, masked, a_scale, kernels)
    return (acc + tp.reduce_from_model(outs)).reshape(*lead, N)


def dot_wo_f32(x: torch.Tensor, kernel: WOQuantKernel) -> torch.Tensor:
    """x @ dequant(kernel) at the activation dtype with an fp32 result; a
    per-column scale applies after the product, group scales dequantize
    first (each group at fp32, then rounded to x's dtype)."""
    from .matmul import dot_f32

    assert kernel.qw.dim() == 2, (
        f"dot_wo expects a per-layer (K, N) kernel, got {kernel.qw.shape}")
    G = kernel.scale.shape[-2]
    if G > 1:
        K, N = kernel.qw.shape
        w = (kernel.qw.reshape(G, K // G, N).float()
             * kernel.scale.float()[:, None, :])
        return dot_f32(x, w.reshape(K, N).to(x.dtype))
    acc = dot_f32(x, kernel.qw.to(x.dtype))
    return acc * kernel.scale.float().reshape(1, -1)


def dot_wo(x: torch.Tensor, kernel: WOQuantKernel) -> torch.Tensor:
    return dot_wo_f32(x, kernel).to(x.dtype)


# ------------------------------------------------------------ tree walk

# Never quantized: embeddings are gathers; the patch embedding is the first
# touch of the pixels; the reward heads are small; ``in_proj`` is a packed
# kernel of another family (``quant.py:569-583``).
_EXCLUDE_DEFAULT = (
    r"tok_embeddings",
    r"embeddings",
    r"patch_embed",
    r"position",
    r"gating",
    r"regression",
    r"in_proj",
)

# Vision-tower paths (InternViT "vision_model", Qwen2-VL "visual",
# MiniCPM-V "vpm", CogVLM2 "vision" anchored at the root).
_VIT_INCLUDE = re.compile(r"vision_model|visual|vpm|^vision(/|$)")

# Decoder attention projections, which ``scope="noattn"`` leaves full
# precision; the ViT's "attn/qkv" does not match.
_DEC_ATTN = re.compile(r"attention/(wqkv|wo|wq|wk|wv|qkv_proj|o_proj)")


def _kernel_leaf_eligible(path: str, leaf, exc, min_elements: int) -> bool:
    """The shared selection policy (int8 here, int4 in ``quant4.py``): the
    path ends in ``kernel``, no exclude pattern matches, ndim >= 2, and at
    least ``min_elements`` elements per layer slice."""
    if not path.endswith("kernel") or any(r.search(path) for r in exc):
        return False
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
        return False
    per_layer = leaf.numel() // (leaf.shape[0] if leaf.dim() == 3 else 1)
    return per_layer >= min_elements


def map_with_path(fn, state, path: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths joined by "/" as
    ``jax.tree_util`` key paths print them."""
    if isinstance(state, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in state.items()}
    return fn(path, state)


def quantize_params_int8(
    params: Any,
    exclude: Sequence[str] = _EXCLUDE_DEFAULT,
    min_elements: int = 1 << 16,
    scope: str = "all",
    weight_only: bool = False,
    group_size: Optional[int] = None,
    outliers: Optional[int] = None,
    device: Any = None,
) -> Any:
    """Replace every large dense ``.../kernel`` leaf with an int8 node.

    ``scope``: "all", "vit" (vision towers only) or "noattn" (all but the
    decoder attention projections).  ``group_size``: group scales along
    the contraction axis; a leaf whose K it does not divide gets the group
    halved until it does (floor 32), else stays per column.
    ``weight_only``: ``WOQuantKernel`` nodes.  ``outliers``: per-column
    nodes become ``OutlierQuantKernel`` (not with groups).  ``device``:
    each leaf is moved there first and quantized there, one at a time, so
    device memory holds the quantized tree, one source leaf and one layer's
    fp32 transients."""
    if scope not in ("all", "vit", "noattn"):
        raise ValueError(f"unknown quant scope {scope!r}")
    exc = [re.compile(p) for p in exclude]

    def one(path, leaf):
        eligible = (
            _kernel_leaf_eligible(path, leaf, exc, min_elements)
            and not (scope == "vit" and not _VIT_INCLUDE.search(path))
            and not (scope == "noattn" and _DEC_ATTN.search(path))
        )
        if device is not None and isinstance(leaf, torch.Tensor):
            leaf = leaf.to(device)
        if not eligible:
            return leaf
        gs = group_size
        if gs is not None:
            K = leaf.shape[-2]
            while gs >= 32 and K % gs:
                gs //= 2
            if gs < 32:
                gs = None
        qk = quantize_kernel(leaf, group_size=gs)
        if weight_only:
            return WOQuantKernel(qw=qk.q, scale=qk.scale)
        if outliers and gs is None:
            return OutlierQuantKernel(q=qk.q, scale=qk.scale,
                                      n_outliers=outliers)
        return qk

    return map_with_path(one, params)


def quantize_params_mode(params: Any, mode: str, min_elements: int = 1 << 16,
                         device: Any = None) -> Any:
    """Apply a named serving mode: ``"int8"`` with the suffixes ``-vit`` or
    ``-noattn``, ``-wo``, ``-gN`` and ``-olN`` in any order, or
    ``"int4-wo"``."""
    if mode == "int4-wo":
        from .quant4 import quantize_params_int4

        return quantize_params_int4(params, min_elements=min_elements,
                                    device=device)
    parts = mode.split("-")
    if parts[0] == "int8":
        scope, weight_only, group_size, outliers = "all", False, None, None
        for p in parts[1:]:
            if p == "vit":
                scope = "vit"
            elif p == "noattn":
                scope = "noattn"
            elif p == "wo":
                weight_only = True
            elif re.fullmatch(r"g\d+", p):
                group_size = int(p[1:])
            elif re.fullmatch(r"ol\d+", p):
                outliers = int(p[2:])
            else:
                raise ValueError(f"unknown int8 mode suffix {p!r} in "
                                 f"{mode!r}")
        return quantize_params_int8(
            params, min_elements=min_elements, scope=scope,
            weight_only=weight_only, group_size=group_size,
            outliers=outliers, device=device)
    raise ValueError(f"unknown quant mode {mode!r}; expected 'int8[-vit|"
                     "-noattn][-wo][-gN][-olN]' or 'int4-wo'")


def is_qnode(x) -> bool:
    from .quant4 import Q4Kernel

    return isinstance(x, (QuantKernel, WOQuantKernel, OutlierQuantKernel,
                          Q4Kernel))


def quant_nodes(params: Any):
    """Every quantized node of a nested dict, depth first, inside other
    kernel nodes too (a LoRA node's base, ``ops/lora.py``)."""
    from ..utils.bridge import is_node, node_fields

    if isinstance(params, dict):
        return [n for v in params.values() for n in quant_nodes(v)]
    if is_qnode(params):
        return [params]
    if is_node(params):
        return [n for _, v in node_fields(params) for n in quant_nodes(v)]
    return []


def is_quantized(params: Any) -> bool:
    return bool(quant_nodes(params))


def _revived(n: dict):
    """The quantized node a plain dict of tensor fields stands for, or
    None: exactly ``{q, scale}``, ``{qw, scale}`` or ``{packed, scale}``
    with an int8 first field (no model family uses these names for
    anything else)."""
    from .quant4 import Q4Kernel

    for name, node in (("q", QuantKernel), ("qw", WOQuantKernel),
                       ("packed", Q4Kernel)):
        if (set(n) == {name, "scale"} and torch.is_tensor(n[name])
                and n[name].dtype == torch.int8):
            return node(k_major(n[name]), n["scale"])
    return None


def revive_quant_kernels(tree: Any) -> Any:
    """Rebuild the quantized nodes of a state read back as plain dicts
    (``utils.checkpoint.load_state``), by JAX's rules
    (``quant.py:777-815``): ``{q, scale}`` -> ``QuantKernel``, ``{qw,
    scale}`` -> ``WOQuantKernel``, ``{packed, scale}`` -> ``Q4Kernel``,
    each with an int8 first field, stored k-major again (``k_major``: the
    card's wrappers take no other layout; no copy where it is so already).
    An ``OutlierQuantKernel`` is saved with the same fields (its
    ``n_outliers`` is no tensor), so it comes back as a ``QuantKernel``, as
    in JAX."""
    if isinstance(tree, dict):
        node = _revived(tree)
        if node is not None:
            return node
        return {k: revive_quant_kernels(v) for k, v in tree.items()}
    return tree


# --------------------------------------------------------- the KV cache

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(slot, head) symmetric int8: one scale per head vector (the last
    axis).  Returns ``(q int8 (..., H, D), scale fp32 (..., H))`` with
    ``q * scale[..., None] ~= x``; ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    x32 = x.float()
    scale = div(x32.abs().amax(-1), 127.0).clamp_min(1e-12)
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`."""
    return (q.float() * scale[..., None]).to(dtype)
