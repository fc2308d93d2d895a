"""Device mesh and sharding rules: data and tensor parallelism, ZeRO-1.

Counterpart of ``mjvideo_tpu/parallel/mesh.py``.  The JAX package hands its
``PartitionSpec``s to GSPMD, which keeps global semantics and emits every
collective.  Here each collective is written out:

* ``Mesh`` has JAX's two axes, ``data`` and ``model``.  ``Mesh.local(data,
  model)`` holds every shard in this process on one device and runs the
  shards' work in turn; a reduction is a sum in shard order.
  ``Mesh.distributed(data, model)`` holds one shard per process of the
  default group, rank ``d * model + m`` (JAX's ``reshape(data, model)``,
  ``mesh.py:40``), with a ``torch.distributed`` group per axis; a
  reduction is ``all_reduce`` or ``all_gather``.
* ``TP_RULES``, ``param_pspec``, ``param_shardings`` and
  ``zero1_opt_shardings`` are JAX's, giving a spec (a tuple of axis names
  or None per dim, ``()`` replicated) per path string.
* ``shard_params`` cuts a whole state into the tensors of the held model
  ranks, one tree per rank (replicated leaves shared), following the rules
  where an explicit head split can, and departing where it cannot: a
  packed ``qkv`` (InternViT, EVA, the Qwen2-VL tower) gives each rank its
  own heads of each of q, k and v (JAX's contiguous cut of 3C would give
  rank 0 all of q); an int4 row member is repacked so that each rank's
  half-split holds its own rows; the LM head splits by vocabulary
  columns; and a Megatron pair (its column members and its row member,
  in any judge family's tree) is split only when every member divides,
  heads included, else the whole pair stays replicated.
* ``Mesh.copy_to_model`` and ``Mesh.reduce_from_model`` are Megatron's f
  and g: identity forward and gradient summed over the model axis, summed
  forward and identity backward.  In a local mesh the sums run in rank
  order, each rank's own part first, as the processes' ``all_reduce``
  sums them.  ``sum_over_model`` (a statistic every rank goes on to use,
  summed both ways) and ``join_model`` (a split LM head's logits
  gathered) serve the judges.

The model code (``models/vit.py``, ``models/decoder.py``) runs a split pair
column-parallel into the rank's heads or columns and row-parallel out of
them: partial products in fp32, summed in fp32 over the model axis, rounded
once, then the bias.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# A partition spec: one axis name (or None) per dim; () is replicated.
Spec = Tuple[Optional[str], ...]


class Mesh:
    """A (data, model) mesh of shards, where JAX has a ``jax.sharding.Mesh``.

    ``rank`` is None for a local mesh (every shard in this process);
    otherwise this process's rank, ``d * model + m``."""

    def __init__(self, data: int, model: int, rank: Optional[int] = None,
                 data_group=None, model_group=None):
        if data < 1 or model < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={data} "
                             f"model={model}")
        self.data, self.model, self.rank = data, model, rank
        self.data_group, self.model_group = data_group, model_group

    @classmethod
    def local(cls, data: int = 1, model: int = 1) -> "Mesh":
        return cls(data, model)

    @classmethod
    def distributed(cls, data: int, model: int) -> "Mesh":
        """One shard per process of the default group (world size data *
        model).  Every process must call this, in the same order: it makes
        one group per data row and per model column."""
        import torch.distributed as dist

        world = dist.get_world_size()
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} processes")
        rank = dist.get_rank()
        data_group = model_group = None
        for m in range(model):  # the processes that share a model rank
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
        for d in range(data):  # the processes of one data rank
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = g
        return cls(data, model, rank, data_group, model_group)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def is_local(self) -> bool:
        return self.rank is None

    @property
    def data_rank(self) -> Optional[int]:
        return None if self.is_local else self.rank // self.model

    @property
    def model_rank(self) -> Optional[int]:
        return None if self.is_local else self.rank % self.model

    @property
    def data_ranks(self) -> Sequence[int]:
        """The data shards this process holds, in order."""
        return range(self.data) if self.is_local else (self.data_rank,)

    @property
    def model_ranks(self) -> Sequence[int]:
        """The model shards this process holds, in order."""
        return range(self.model) if self.is_local else (self.model_rank,)

    def __repr__(self) -> str:
        kind = "local" if self.is_local else f"rank {self.rank}"
        return f"Mesh(data={self.data}, model={self.model}, {kind})"

    def sequence_group(self):
        """The data axis as a ``parallel.sequence.SequenceGroup``: under
        sequence parallelism it carries the sequence, not the batch."""
        from .sequence import SequenceGroup

        if self.is_local:
            return SequenceGroup.local(self.data)
        return SequenceGroup(self.data, self.data_rank, self.data_group)

    # --- the model axis ----------------------------------------------

    def copy_to_model(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Megatron's f: ``x`` once per held model rank; the backward sums
        the ranks' gradients, each rank's own uses summed first (in rank
        order locally, an ``all_reduce`` across processes), so that both
        forms sum alike."""
        if self.model == 1:
            return [x]
        if self.is_local:
            return list(_CopyLocal.apply(x, self.model))
        return [_CopyToModel.apply(x, self.model_group)]

    def reduce_from_model(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Megatron's g: the sum of the held ranks' partials over the model
        axis (in rank order in a local mesh); the backward passes the
        gradient to every rank unchanged."""
        if self.is_local or self.model == 1:
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        return _ReduceFromModel.apply(parts[0], self.model_group)

    # --- the data axis -------------------------------------------------

    def sum_over_data(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Sum of the held data shards' tensors over the data axis (no
        autograd): in shard order locally, ``all_reduce`` across
        processes."""
        if self.is_local:
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        out = parts[0].clone()
        if self.data > 1:
            import torch.distributed as dist

            dist.all_reduce(out, group=self.data_group)
        return out

    def gather_data(self, parts: List[torch.Tensor],
                    dim: int = 0) -> torch.Tensor:
        """Every data shard's rows along ``dim``, in shard order."""
        if self.is_local:
            return torch.cat(list(parts), dim)
        if self.data == 1:
            return parts[0]
        import torch.distributed as dist

        x = parts[0].contiguous()
        got = [torch.empty_like(x) for _ in range(self.data)]
        dist.all_gather(got, x, group=self.data_group)
        return torch.cat(got, dim)

    def gather_model(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every model rank's ``x`` (this process's only, in a distributed
        mesh), in rank order (no autograd)."""
        import torch.distributed as dist

        x = x.contiguous()
        got = [torch.empty_like(x) for _ in range(self.model)]
        dist.all_gather(got, x, group=self.model_group)
        return got

    def join_model(self, parts: List[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
        """Every model rank's part concatenated along ``dim``, in rank
        order (no autograd): the held parts in a local mesh, all-gathered
        across processes."""
        if self.is_local or self.model == 1:
            return torch.cat(list(parts), dim)
        return torch.cat(self.gather_model(parts[0]), dim)

    def sum_over_model(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The sum of the held ranks' partials over the model axis where
        every rank goes on to use the sum in work of its own (a norm's
        statistics): its gradient is summed over the model axis too, so
        each rank's partial receives every rank's share.  In rank order
        locally, ``all_reduce`` across processes."""
        if self.is_local or self.model == 1:
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        return _AllReduceSum.apply(parts[0], self.model_group)

    def all_reduce_world(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every process (in place; a local mesh holds
        them all already)."""
        if not self.is_local and self.data * self.model > 1:
            import torch.distributed as dist

            dist.all_reduce(x)
        return x


class _CopyLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        out = None
        for g in grads:
            if g is not None:
                out = g if out is None else out + g
        return out, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """A (data, model) mesh with JAX's signature (``mesh.py:30``): under a
    launched process group, ``Mesh.distributed`` over the world (data=-1:
    world // model); in one process ``Mesh.local``, where -1 means 1."""
    from .distributed import process_info

    _, n = process_info()
    if n > 1:
        if data == -1:
            if n % model:
                raise ValueError(f"{n} processes not divisible by "
                                 f"model={model}")
            data = n // model
        return Mesh.distributed(data, model)
    return Mesh.local(1 if data == -1 else data, model)


# (path regex, partition spec for that param). First match wins.  Layer-
# stacked params have a leading L axis, so specs start with None.
TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    # LLM attention: column-parallel qkv, row-parallel output proj.
    (r"attention/w[qkv]/kernel", (None, None, "model")),
    (r"attention/wo/kernel", (None, "model", None)),
    (r"attention/w[qkv]/bias", (None, "model")),
    # LLM MLP: column-parallel w1/w3, row-parallel w2.
    (r"feed_forward/w[13]/kernel", (None, None, "model")),
    (r"feed_forward/w2/kernel", (None, "model", None)),
    # ViT attention/MLP, same megatron pattern.
    (r"attn/qkv/kernel", (None, None, "model")),
    (r"attn/qkv/bias", (None, "model")),
    (r"attn/proj/kernel", (None, "model", None)),
    (r"mlp/fc1/kernel", (None, None, "model")),
    (r"mlp/fc1/bias", (None, "model")),
    (r"mlp/fc2/kernel", (None, "model", None)),
    # SigLIP-style towers (videoscore / MiniCPM-V vpm) and the CogVLM2 EVA
    # tower keep separate per-layer q/k/v/o (or packed qkv + dense) directly
    # under 'layers/': same megatron pattern.
    (r"layers/[qkv]/kernel", (None, None, "model")),
    (r"layers/[qkv]/bias", (None, "model")),
    (r"layers/o/kernel", (None, "model", None)),
    (r"layers/qkv/kernel", (None, None, "model")),
    (r"layers/qkv/bias", (None, "model")),
    (r"layers/dense/kernel", (None, "model", None)),
    (r"layers/fc1/kernel", (None, None, "model")),
    (r"layers/fc1/bias", (None, "model")),
    (r"layers/fc2/kernel", (None, "model", None)),
    # CogVLM2 dual-expert decoder: shard both experts' MLPs and output
    # projections; the packed vision/language qkv stays replicated (its
    # [q;k;v] layout doesn't column-split cleanly across heads).
    (r"mlp/(vision|language)/w[13]/kernel", (None, None, "model")),
    (r"mlp/(vision|language)/w2/kernel", (None, "model", None)),
    (r"(vision|language)_dense/kernel", (None, "model", None)),
    # Embedding + LM head sharded over vocab.
    (r"tok_embeddings$", ("model", None)),
    (r"output/kernel", (None, "model")),
)


def param_pspec(path: str, tp: bool) -> Spec:
    """The spec of one parameter path (``()`` = fully replicated)."""
    if tp:
        for pattern, spec in TP_RULES:
            if re.search(pattern, path):
                return spec
    return ()


def _guarded(shape, spec: Spec, sizes: Dict[str, int]) -> Spec:
    """``spec``, or ``()`` if an axis does not divide its dim
    (``mesh.py:110-115``)."""
    if any(ax is not None and shape[i] % sizes[ax]
           for i, ax in enumerate(spec)):
        return ()
    return spec


def param_shardings(params: Any, mesh: Mesh, tp: bool = True
                    ) -> Dict[str, Spec]:
    """{path: spec} of every leaf of ``params`` (a node's fields by their
    JAX path strings), specs that do not divide dropped."""
    from ..utils.bridge import flatten_state

    on = tp and mesh.shape["model"] > 1
    return {path: _guarded(t.shape, param_pspec(path, on), mesh.shape)
            for path, t in flatten_state(params).items()}


def zero1_opt_shardings(opt_state: Any, params: Any, mesh: Mesh,
                        tp: bool = True) -> Dict[str, Spec]:
    """ZeRO-1 specs of an optimizer state's leaves (``mesh.py:140-192``):
    a leaf whose path ends with a parameter's path and whose shape is that
    parameter's takes the parameter's spec plus ``data`` on its largest
    dim that is not yet sharded and that the data size divides; every
    other leaf (counts, Adafactor's factored statistics) is replicated."""
    from ..utils.bridge import flatten_state

    data_size = mesh.shape["data"]
    base = param_shardings(params, mesh, tp)
    flat = flatten_state(params)
    # Longest param path first so e.g. 'mlp1/2/kernel' wins over '2/kernel'.
    by_path = sorted(((p, tuple(flat[p].shape), s) for p, s in base.items()),
                     key=lambda t: -len(t[0]))

    def extend(shape, spec) -> Spec:
        full = list(spec) + [None] * (len(shape) - len(spec))
        best = -1
        for i, (dim, ax) in enumerate(zip(shape, full)):
            if ax is None and dim % data_size == 0 and (
                    best < 0 or dim > shape[best]):
                best = i
        if best >= 0:
            full[best] = "data"
        return tuple(full)

    def one(path, leaf) -> Spec:
        if data_size > 1 and torch.is_tensor(leaf):
            for ppath, pshape, pspec in by_path:
                if (path == ppath or path.endswith("/" + ppath)) \
                        and tuple(leaf.shape) == pshape:
                    return extend(leaf.shape, pspec)
        return ()

    return {path: one(path, leaf)
            for path, leaf in flatten_state(opt_state).items()}


def zero1_dim(spec: Spec) -> Optional[int]:
    """The dim a ZeRO-1 spec puts ``data`` on, or None."""
    return spec.index("data") if "data" in spec else None


# --- tensor-parallel placement ----------------------------------------

# A split pair: the leaves that split together, keyed by the path of the
# block they make up.  InternViT, Qwen2-VL's tower, the decoders and
# CogVLM2's experts keep each block under ``layers/`` (or ``blocks/``); the
# SigLIP towers (q, k, v, o), the EVA tower (qkv, dense) and the perceiver
# keep their members directly under ``layers/``, keyed as its ``attn`` or
# ``mlp``; the LM head is a pair of its own.
_PAIR = re.compile(
    r"^(.*/(?:layers|blocks)/(?:attn|mlp|attention|feed_forward))/")
_FLAT_ATTN = re.compile(r"^(.*/layers)/(?:q|k|v|o|qkv|dense)/")
_FLAT_MLP = re.compile(r"^(.*/layers)/(?:fc1|fc2)/")
_HEAD = re.compile(r"^((?:.*/)?output/kernel)(?:/|$)")


def _pair_key(path: str) -> Optional[str]:
    """The pair a leaf belongs to, or None where it splits on its own (the
    embedding) or not at all."""
    m = _PAIR.match(path)
    if m:
        return m.group(1)
    m = _FLAT_ATTN.match(path)
    if m:
        return m.group(1) + "/attn"
    m = _FLAT_MLP.match(path)
    if m:
        return m.group(1) + "/mlp"
    m = _HEAD.match(path)
    return m.group(1) if m else None


class Split:
    """How one leaf (or node field) splits over the model axis: ``kind``
    "cols" (the last dim), "rows" (the one before it), "vocab" (the
    embedding's rows, dim 0), "logits" (the LM head's vocabulary columns,
    the last dim), "qkv" (a packed q|k|v last dim, by heads) or "q4rows"
    (an int4 ``packed`` field's logical rows, repacked)."""

    __slots__ = ("kind", "dim")

    def __init__(self, kind: str, dim: int):
        self.kind, self.dim = kind, dim

    def __repr__(self) -> str:
        return f"Split({self.kind!r}, {self.dim})"


def _heads(cfg, key: str) -> Tuple[int, ...]:
    """The head counts a pair must split by: a tower's heads (the
    perceiver's query and kv heads), a decoder's kv heads (each with its
    query group, CogVLM2's packed qkv sliced so); none for an MLP or the
    LM head.  ``cfg``: a ``RewardConfig`` or ``ChatConfig``, or the
    ``*Config`` of MiniCPM-V, VideoScore, CogVLM2 or Qwen2-VL."""
    chat = getattr(cfg, "chat", cfg)
    if key.split("/")[0] == "connector" and key.endswith("/attn"):
        pc = chat.perceiver
        return (pc.n_heads, pc.num_key_value_heads)
    if key.endswith("/attention"):
        text = getattr(chat, "llm", None) or chat.text
        return (text.num_key_value_heads,)
    if key.endswith("/attn"):
        vision = chat.vision
        return (getattr(vision, "num_attention_heads", None)
                or vision.num_heads,)
    return ()


def _q4_group(plan_leaves, field_path: str) -> int:
    """The group size of the Q4 node whose ``packed`` field is at
    ``field_path``: 2 * packed rows / scale rows."""
    packed = plan_leaves[field_path]
    scale = plan_leaves[field_path[:-len(".packed")] + ".scale"]
    return 2 * packed.shape[-2] // scale.shape[-2]


def split_plan(params: Any, model: int, cfg=None) -> Dict[str, Split]:
    """{leaf path: Split} of the leaves that split over ``model`` ranks.
    Raises ``NotImplementedError`` (ROADMAP Queue 1 item 12) where the
    state holds what the port does not split yet: LoRA nodes and w8a8
    nodes.  The QK-norm ViT splits: its norms' statistics are summed over
    the model axis (``models/vit.py``)."""
    from ..ops.quant import OutlierQuantKernel, QuantKernel
    from ..ops.lora import LoraKernel
    from ..utils.bridge import flatten_state

    if model == 1:
        return {}
    if cfg is None:
        raise ValueError("shard_params over a model axis needs the config "
                         "(the head counts the pairs split by)")

    def refuse(what):
        raise NotImplementedError(
            f"{what} under tensor parallelism (model={model}) is not ported "
            "yet: ROADMAP Queue 1 item 12")

    def walk(tree):
        from ..utils.bridge import is_node, node_fields

        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, LoraKernel):
            refuse("LoRA")
        elif isinstance(tree, (QuantKernel, OutlierQuantKernel)):
            refuse("a w8a8 quantized state (each activation row's amax "
                   "would have to be max-reduced over the model axis)")
        elif is_node(tree):
            for _, v in node_fields(tree):
                walk(v)

    walk(params)
    flat = flatten_state(params)
    pairs: Dict[str, Dict[str, Split]] = {}
    ok: Dict[str, bool] = {}
    for path, t in flat.items():
        spec = param_pspec(path, True)
        key = _pair_key(path)
        if "model" not in spec or not (key or path.endswith("tok_embeddings")):
            continue
        key = key or path
        axis = spec.index("model")
        field = path.rsplit("/", 1)[-1]
        nd = t.dim()
        if path.endswith("tok_embeddings"):
            split = Split("vocab", 0)
        elif _HEAD.match(path):
            split = Split("logits", nd - 1)
        elif re.search(r"(attn|layers)/qkv/(kernel|bias)", path):
            split = Split("qkv", nd - 1)
        elif field == ".scale":
            # A per-column scale splits with a column member and stays
            # whole under a row member; a grouped scale splits with K.
            if axis == len(spec) - 1:
                split = Split("cols", nd - 1)
            elif t.shape[-2] == 1:
                continue
            else:
                split = Split("rows", nd - 2)
        elif axis == len(spec) - 1:
            split = Split("cols", nd - 1)
        elif field == ".packed":
            split = Split("q4rows", nd - 2)
        else:
            split = Split("rows", nd - 2)
        size = t.shape[split.dim]
        if split.kind == "qkv":
            fits = size % 3 == 0 and (size // 3) % model == 0
        elif split.kind == "q4rows":
            # Each rank's half-split holds whole groups in each half.
            fits = (2 * size) % (2 * _q4_group(flat, path) * model) == 0
        else:
            fits = size % model == 0
        if any(h % model for h in _heads(cfg, key)):
            fits = False
        pairs.setdefault(key, {})[path] = split
        ok[key] = ok.get(key, True) and fits
    return {path: s for key, members in pairs.items() if ok[key]
            for path, s in members.items()}


def _unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """A half-split packed (..., K/2, N) field -> its biased nibbles (...,
    K, N) uint8 in logical row order."""
    b = packed.view(torch.uint8)
    return torch.cat([b & 0xF, b >> 4], dim=-2)


def _pack_q4(vals: torch.Tensor) -> torch.Tensor:
    """Biased nibbles (..., K, N) -> the half-split packed (..., K/2, N)
    int8, k-major."""
    from ..ops.quant import k_major

    K = vals.shape[-2]
    packed = (vals[..., :K // 2, :] | (vals[..., K // 2:, :] << 4))
    return k_major(packed.view(torch.int8))


def cut(t: torch.Tensor, split: Split, j: int, m: int) -> torch.Tensor:
    """Rank ``j``'s piece of ``t`` among ``m``, a tensor of its own (an
    int8 field k-major again)."""
    from ..ops.quant import k_major

    if split.kind == "q4rows":
        vals = _unpack_q4(t)
        n = vals.shape[-2] // m
        return _pack_q4(vals.narrow(-2, j * n, n))
    if split.kind == "qkv":
        third = t.shape[-1] // 3
        n = third // m
        piece = torch.cat([t.narrow(-1, i * third + j * n, n)
                           for i in range(3)], -1)
    else:
        n = t.shape[split.dim] // m
        piece = t.narrow(split.dim, j * n, n)
    piece = piece.detach().clone(memory_format=torch.contiguous_format)
    return k_major(piece) if piece.dtype == torch.int8 else piece


def join(pieces: Sequence[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from every rank's piece, in rank order: ``cut``'s
    inverse."""
    from ..ops.quant import k_major

    if split.kind == "q4rows":
        return _pack_q4(torch.cat([_unpack_q4(p) for p in pieces], -2))
    if split.kind == "qkv":
        n = pieces[0].shape[-1] // 3
        whole = torch.cat([p.narrow(-1, i * n, n) for i in range(3)
                           for p in pieces], -1)
    else:
        whole = torch.cat(list(pieces), split.dim)
    return k_major(whole) if whole.dtype == torch.int8 else whole


def _map_leaves(fn, state, prefix: str = ""):
    """``fn(path, leaf)`` over a state (dicts and kernel nodes, a node's
    fields by their JAX path strings), rebuilding its structure."""
    import dataclasses

    from ..utils.bridge import is_node, node_fields

    if isinstance(state, dict):
        return {k: _map_leaves(fn, v, f"{prefix}{k}/")
                for k, v in state.items()}
    if is_node(state):
        return dataclasses.replace(state, **{
            name: _map_leaves(fn, v, f"{prefix}.{name}/")
            for name, v in node_fields(state)})
    return fn(prefix[:-1], state)


def shard_params(params: Any, mesh: Mesh, tp: bool = True, cfg=None
                 ) -> List[Any]:
    """The state of each model rank this process holds, in rank order (all
    ``model`` of them in a local mesh, this rank's in a distributed one):
    the split leaves cut (``split_plan``), every other leaf the same tensor
    in every tree.  ``cfg`` (the ``RewardConfig`` or ``ChatConfig``) gives
    the head counts; it is needed when the model axis is above 1.  The data
    axis replicates the parameters, as in JAX."""
    m = mesh.model if tp else 1
    plan = split_plan(params, m, cfg)
    if not plan:
        return [params] * len(mesh.model_ranks) if m > 1 else [params]
    return [_map_leaves(lambda p, t: cut(t, plan[p], j, m) if p in plan
                        else t, params) for j in mesh.model_ranks]


def gather_params(shards: List[Any], mesh: Mesh, plan: Dict[str, Split]
                  ) -> Any:
    """The whole state from the held model ranks' trees (``shard_params``'
    inverse): the split leaves joined, all-gathered over the model axis
    across processes."""
    if not plan:
        return shards[0]
    from ..utils.bridge import flatten_state

    if mesh.is_local:
        flats = [flatten_state(s) for s in shards]

        def pieces(p):
            return [f[p] for f in flats]
    else:
        def pieces(p, flat=flatten_state(shards[0])):
            return mesh.gather_model(flat[p])
    return _map_leaves(lambda p, t: join(pieces(p), plan[p]) if p in plan
                       else t, shards[0])


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> List[Dict[str, Any]]:
    """Each held data shard's rows of every array of ``batch`` along its
    leading axis (all ``data`` shards in a local mesh, this rank's in a
    distributed one).  A batch that ``data`` does not divide raises
    ``ValueError``, as ``jax.device_put`` does."""
    n = mesh.data
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch key {k!r} has {v.shape[0]} rows, not "
                             f"divisible by the data axis ({n})")
    return [{k: v[d * (v.shape[0] // n):(d + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for d in mesh.data_ranks]


def sub(params, key: str):
    """``params[key]`` of a whole state, or of each held model rank's."""
    if isinstance(params, list):
        return [p[key] for p in params]
    return params[key]


def held(params) -> List[Any]:
    """The held model ranks' trees: ``params`` itself as the one tree when
    it is a whole state."""
    return params if isinstance(params, list) else [params]


def held_layers(params, mesh: Optional[Mesh]) -> List[Any]:
    """The held model ranks' trees where ``mesh`` has a model axis above 1,
    else the first alone (the unsplit path needs one)."""
    ps = held(params)
    return ps if model_axis(mesh) is not None else ps[:1]


def model_axis(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when its model axis is above 1, else None (the unsplit
    path)."""
    return mesh if mesh is not None and mesh.model > 1 else None


def pair_forward(mesh: Optional[Mesh], ps, h: torch.Tensor, split: bool,
                 body) -> torch.Tensor:
    """A Megatron pair over the held model ranks' states ``ps``:
    ``body(p, x, split)`` runs one rank's column members and its row member
    on ``x``.  Split, each rank's body returns its fp32 partial, summed over
    the model axis and rounded once to ``h``'s dtype (the row member's bias
    is the caller's); else rank 0's body alone, on ``h``."""
    if not split:
        return body(ps[0], h, False)
    tp = model_axis(mesh)
    outs = [body(p, x, True) for p, x in zip(ps, tp.copy_to_model(h))]
    return tp.reduce_from_model(outs).to(h.dtype)


def row_dot(x: torch.Tensor, kernel, split: bool,
            impl: str = "auto") -> torch.Tensor:
    """A row member's product: an fp32 partial where its pair is split
    (``pair_forward`` sums and rounds it), else ``dot``."""
    from ..ops.matmul import dot, dot_f32

    return dot_f32(x, kernel, impl) if split else dot(x, kernel, impl)
