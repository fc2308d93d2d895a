"""Decoder LLM, InternLM2 / Llama path; Phi-3 (MJ-VIDEO-4B) runs the same
layer, only its checkpoint layout differs (``utils/checkpoint.py``).

Counterpart of ``mjvideo_tpu/models/decoder.py`` (reference
``modeling_internlm2.py``) for reward scoring and training: separate q/k/v
kernels (the packed ``wqkv`` is unpacked at import), GQA without repeated kv
heads, fp32 RMSNorm statistics, RoPE tables built per call, each layer
rematerialised per ``remat`` (``ops/remat.py``).  The LM head (``output``)
and ``lm_logits`` serve generation; the cached layers live in
``models/generate.py``.  Under ``sp`` (sequence parallelism,
``parallel/sequence.py``) the attention runs as ring or all-gather
attention over the group, exact (K3), as the JAX decoder runs it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs import LLMConfig

from ..ops.attention import multi_head_attention
from ..ops.matmul import dot, dot_f32
from ..ops.norms import rms_norm
from ..ops.remat import remat_wrap
from ..ops.rope import apply_rope, rope_tables
from ..parallel.mesh import held, model_axis, sub
from ..utils.bridge import map_state


def init_decoder_params(cfg: LLMConfig, *, generator: torch.Generator,
                        device: torch.device, dtype: torch.dtype,
                        with_lm_head: bool = False):
    """Random decoder state (stacked layers); ``with_lm_head`` adds the
    ``output`` kernel (C, V), drawn last, which generation needs and the
    reward path does not."""
    C, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device) * 0.02
        return w.to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    attn = {
        "wq": {"kernel": dense(L, C, Hq * D)},
        "wk": {"kernel": dense(L, C, Hkv * D)},
        "wv": {"kernel": dense(L, C, Hkv * D)},
        "wo": {"kernel": dense(L, Hq * D, C)},
    }
    if cfg.bias:
        for name, n in (("wq", Hq * D), ("wk", Hkv * D), ("wv", Hkv * D),
                        ("wo", C)):
            attn[name]["bias"] = torch.zeros((L, n), dtype=dtype, device=device)
    params = {
        "tok_embeddings": dense(cfg.vocab_size, C),
        "layers": {
            "attention_norm": {"weight": ones(L, C)},
            "attention": attn,
            "ffn_norm": {"weight": ones(L, C)},
            "feed_forward": {
                "w1": {"kernel": dense(L, C, I)},
                "w3": {"kernel": dense(L, C, I)},
                "w2": {"kernel": dense(L, I, C)},
            },
        },
        "norm": {"weight": ones(C)},
    }
    if with_lm_head:
        params["output"] = {"kernel": dense(C, cfg.vocab_size)}
    return params


def _dense(p, x, impl: str = "auto"):
    y = dot(x, p["kernel"], impl)
    if "bias" in p:
        y = y + p["bias"]
    return y


def _row_parallel(tp, outs, p, x_dtype):
    """The row-parallel product's end: the fp32 partials summed over the
    model axis, rounded once to the activation dtype, then the bias."""
    y = tp.reduce_from_model(outs).to(x_dtype)
    return y + p["bias"] if "bias" in p else y


def attention_block(cfg: LLMConfig, ps, h, tp, attend, impl: str = "auto"):
    """The attention branch of a layer after its norm: q, k and v, then
    ``attend(i, q, k, v)`` of the i-th held rank (RoPE, the cache, the
    kernel; (B, S, hq, D) in, (B, S, hq, D) or (B, S, hq * D) out), then the
    output projection with its bias.  ``ps``: the held model ranks' layer
    states.  A split pair (``tp`` a model axis above 1 and wq cut) runs
    column-parallel into each rank's whole kv heads and their query groups
    and row-parallel out of them (``_row_parallel``)."""
    B, S, _ = h.shape
    D = cfg.head_dim
    split = (tp is not None and ps[0]["attention"]["wq"]["kernel"].shape[-1]
             != cfg.num_attention_heads * D)
    outs = []
    for i, (pj, hj) in enumerate(zip(ps, tp.copy_to_model(h) if split
                                     else [h])):
        a = pj["attention"]
        q = _dense(a["wq"], hj, impl)
        k = _dense(a["wk"], hj, impl)
        v = _dense(a["wv"], hj, impl)
        hq = q.shape[-1] // D
        attn = attend(i, q.reshape(B, S, hq, D),
                      k.reshape(B, S, k.shape[-1] // D, D),
                      v.reshape(B, S, v.shape[-1] // D, D))
        attn = attn.reshape(B, S, hq * D)
        outs.append(dot_f32(attn, a["wo"]["kernel"], impl) if split
                    else _dense(a["wo"], attn, impl))
    if split:
        return _row_parallel(tp, outs, ps[0]["attention"]["wo"], h.dtype)
    return outs[0]


def mlp_block(cfg: LLMConfig, ps, h, tp, impl: str = "auto"):
    """The SwiGLU MLP after its norm: w1 and w3 column-parallel, w2
    row-parallel where the pair was split."""
    split = (tp is not None and ps[0]["feed_forward"]["w1"]["kernel"].shape[-1]
             != cfg.intermediate_size)
    outs = []
    for pj, hj in zip(ps, tp.copy_to_model(h) if split else [h]):
        f = pj["feed_forward"]
        y = F.silu(_dense(f["w1"], hj, impl)) * _dense(f["w3"], hj, impl)
        outs.append(dot_f32(y, f["w2"]["kernel"], impl) if split
                    else _dense(f["w2"], y, impl))
    if split:
        return _row_parallel(tp, outs, ps[0]["feed_forward"]["w2"], h.dtype)
    return outs[0]


def _decoder_layer(cfg: LLMConfig, p, x, attention_mask, cos, sin, impl,
                   sp=None, mesh=None):
    """One layer (``modeling_internlm2.py:610-681``).  ``mesh`` with a
    model axis above 1: ``p`` is the list of the held model ranks' layer
    states, and a split pair runs column-parallel (wq/wk/wv on the rank's
    whole kv heads and their query groups, w1/w3 on its columns) and
    row-parallel (wo, w2: fp32 partials summed over the model axis,
    rounded once, then the bias)."""
    ps = held(p)
    tp = model_axis(mesh)

    def attend(i, q, k, v):
        q, k = apply_rope(q, k, cos, sin)
        if sp is not None:
            # Exact (K3) whatever ``impl`` says, as the JAX decoder's
            # shard_map runs the flash kernel without the bound.
            from ..parallel.sequence import (
                ring_flash_attention,
                sp_flash_attention,
            )

            sp_fn = (ring_flash_attention if sp.get("kind", "ring") == "ring"
                     else sp_flash_attention)
            return sp_fn(q, k, v, sp["group"], attention_mask=attention_mask,
                         causal=True)
        # The global bound kernel K2, as the JAX decoder takes it by
        # default (decoder.py _LLM_BOUND); the cached paths keep the exact
        # K3.
        return multi_head_attention(q, k, v, attention_mask=attention_mask,
                                    causal=True, impl=impl, norm_bound=True)

    h = rms_norm(x, ps[0]["attention_norm"]["weight"], eps=cfg.rms_norm_eps)
    x = x + attention_block(cfg, ps, h, tp, attend, impl)
    h = rms_norm(x, ps[0]["ffn_norm"]["weight"], eps=cfg.rms_norm_eps)
    return x + mlp_block(cfg, ps, h, tp, impl)


def decoder_forward(
    params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, S, C)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) 1 = real
    impl: str = "auto",
    remat=True,
    sp=None,
    rope_override=None,
    mesh=None,
) -> torch.Tensor:
    """All layers + the final norm: hidden states (B, S, C).

    The stacked ``[L, ...]`` layer tensors are unbound once, so their
    gradient is one stack of the per-layer gradients.

    ``sp={"group": SequenceGroup, "kind": "ring" | "allgather"}`` runs the
    attention sequence-parallel.  ``inputs_embeds`` and ``attention_mask``
    hold the rows this process holds (all of them in a local group, one
    shard's S/n in a distributed one); RoPE rotates each row by its global
    position.

    ``rope_override=(cos, sin)``, each (B, S, head_dim), rotates each token
    by its own values instead (Qwen2-VL's 3-channel M-RoPE,
    ``decoder.py:156``, :169-175).

    ``mesh``: ``params`` is the list of the held model ranks' states
    (``parallel.mesh.shard_params``) and each layer runs split
    (``_decoder_layer``); under ``sp`` too, the ring then running on each
    rank's heads."""
    S = inputs_embeds.shape[1]
    if rope_override is not None:
        if sp is not None:
            raise ValueError("rope_override with sp: the rows' tables would "
                             "have to be cut to the shard")
        cos, sin = rope_override
    else:
        first, total = (0, S) if sp is None else sp["group"].held_rows(S)
        cos, sin = rope_tables(
            total, cfg.head_dim, base=cfg.rope_theta,
            scaling_type=cfg.rope_scaling_type,
            scaling_factor=cfg.rope_scaling_factor,
            max_position_embeddings=cfg.max_position_embeddings,
            device=inputs_embeds.device,
        )
        cos, sin = cos[first:first + S], sin[first:first + S]
    block = remat_wrap(
        lambda layer, x: _decoder_layer(cfg, layer, x, attention_mask, cos,
                                        sin, impl, sp, mesh), remat)
    layers = [map_state(lambda a: a.unbind(0), t)
              for t in held(sub(params, "layers"))]
    x = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        layer = [map_state(lambda a: a[i], t) for t in layers]
        x = block(layer if isinstance(params, list) else layer[0], x)
    return rms_norm(x, held(params)[0]["norm"]["weight"],
                    eps=cfg.rms_norm_eps)


def embed_tokens(params, input_ids: torch.Tensor, mesh=None,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Token embedding lookup (``tok_embeddings``).  Under a model axis
    whose ranks hold the table's rows split (``vocab_size`` rows whole),
    each rank looks up the ids in its rows, zeros elsewhere, and the
    lookups are summed over the model axis: exact, each row having one
    nonzero term."""
    ps = held(params)
    tp = model_axis(mesh)
    table = ps[0]["tok_embeddings"]
    if tp is None or vocab_size is None or table.shape[0] == vocab_size:
        return F.embedding(input_ids, table)
    n = table.shape[0]
    parts = []
    for j, pj in zip(tp.model_ranks, ps):
        local = input_ids - j * n
        inside = (local >= 0) & (local < n)
        e = F.embedding(local.clamp(0, n - 1), pj["tok_embeddings"])
        parts.append(torch.where(inside[..., None], e, 0.0).to(e.dtype))
    return tp.reduce_from_model(parts)


def vocab_logits(ps, head, hidden: torch.Tensor, impl: str = "auto",
                 mesh=None, vocab_size: Optional[int] = None) -> torch.Tensor:
    """fp32 logits by the LM head ``head(p)`` ((C, N) of a held rank's
    state ``p``).  Under a model axis whose ranks hold its vocabulary
    columns split (fewer than ``vocab_size``), each rank's columns,
    gathered in rank order, so that a greedy pick is ``argmax`` of the
    whole row (its first index on a tie); else rank 0's head alone."""
    tp = model_axis(mesh)
    ps = held(ps)
    if tp is None or vocab_size is None or head(ps[0]).shape[-1] == vocab_size:
        return dot_f32(hidden, head(ps[0]), impl)
    return tp.join_model([dot_f32(hidden, head(p), impl) for p in ps], -1)


def lm_logits(params, hidden: torch.Tensor, impl: str = "auto", mesh=None,
              vocab_size: Optional[int] = None) -> torch.Tensor:
    """LM head projection with fp32 logits (``decoder.py:208-210``).
    ``mesh``: ``params`` is the list of the held model ranks' states, the
    head split by vocabulary columns or whole (``vocab_logits``)."""
    return vocab_logits(params, lambda p: p["output"]["kernel"], hidden,
                        impl, mesh, vocab_size)
