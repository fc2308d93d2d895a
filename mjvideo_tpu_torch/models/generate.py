"""Autoregressive generation with a static KV cache, and the chat API.

Counterpart of ``mjvideo_tpu/models/generate.py`` (reference
``modeling_internlm2.py:988-1292``, ``modeling_internvl_chat.py:264-415``)
for the InternVL judges.  What differs from the JAX package:

* The functions run eagerly; the ``*_jitted`` names have no counterpart.
  The decode loop (``lax.while_loop`` there) is a Python loop that stops
  when every row has emitted EOS or the budget is spent, at the cost of one
  host read per step.  Capturing the step in a CUDA graph is later work.
* JAX caches are values; these are tensors.  ``decoder_forward_cached``
  writes into the cache it is given, in place, with set semantics
  (``scatter_kv``), so a decode step copies nothing.  ``generate`` and
  ``prefill_prefix`` build their own caches; ``generate_from_prefix`` and
  ``stack_prefix_states`` never change a ``PrefixState`` they are given
  (the judge reuses one per video for every question): the first copies
  the state before writing, the second concatenates into new buffers.
* Draws come from an explicit ``torch.Generator`` (``generator`` in place
  of ``rng``); a sampled token cannot match ``jax.random.categorical``'s,
  while the kept support (top-k, nucleus) follows ``_sample``'s rules.
* Attention: ``impl="auto"`` runs the kernels of ``ops/flash_attention.py``
  (their twins on the CPU) for every multi-token call: the exact K3 (or
  K2r under ``MJV_CACHE_NORM_BOUND=1``) over the fresh tokens of an
  empty-cache prefill, and over the whole cache with ``q_offset`` = the
  prefix length for a suffix continuation.  Decode steps (S = 1) and
  ``impl="plain"`` take the grouped einsum over the cache with the slot
  bias, as the JAX package computes them in XLA.
* ``teacher_tokens``: ``generate`` and ``generate_from_prefix`` can feed
  given tokens instead of their own draws and return each step's fp32
  logits, which the tests and ``chip_smoke.py`` hold against a reference.

The scaffolding of the other judge families (``models/qwen2vl.py``):
``rope_override`` (per-token cos/sin, M-RoPE) in ``decoder_forward_cached``;
``greedy_decode_batch`` and ``greedy_decode``, whose ``lax.while_loop`` is a
Python loop with the same early exit (every row has emitted EOS) and the
same skipped last forward; ``pad_prompt_batch``, ``prefill_slot_mask``,
``step_slot_mask`` and ``last_real_token``, the slot arithmetic of a
right-padded prompt at slots [0, n_real) whose token i decodes at slot
n_real + i.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import ChatConfig, LLMConfig

from ..ops.attention import NEG_INF, attention_plain, multi_head_attention
from ..ops.flash_attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.quant import dequantize_kv, quantize_kv
from ..ops.rope import apply_rope, rope_tables
from ..utils.bridge import first_tensor, map_state
from . import decoder as dec
from .internvl import embed_prompt, extract_feature, scatter_image_embeds

# The softmax shift of the cached prefill paths: the exact online softmax
# (K3) by default, as in the JAX package, where the row-causal bound (K2r)
# measured below its adoption bar on the TPU; MJV_CACHE_NORM_BOUND=1 opts
# in to K2r, whose rows are bit-identical between a prefix-only and a
# full-prompt prefill.
_CACHE_BOUND = ("rows" if os.environ.get("MJV_CACHE_NORM_BOUND", "0") == "1"
                else False)


class KVCache(NamedTuple):
    """Static KV cache; int8 with per-(slot, head) fp32 scales when
    quantized (``kv_quant``), else in the activation dtype."""

    k: torch.Tensor  # (L, B, max_len, Hkv, D)
    v: torch.Tensor  # (L, B, max_len, Hkv, D)
    k_scale: Optional[torch.Tensor] = None  # (L, B, max_len, Hkv) if int8
    v_scale: Optional[torch.Tensor] = None

    def clone(self) -> "KVCache":
        return KVCache(*(None if t is None else t.clone() for t in self))


def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int, *,
                  device: torch.device, dtype: torch.dtype = torch.bfloat16,
                  quant: bool = False) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads, cfg.head_dim)
    if quant:
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def scatter_kv(k_cache, v_cache, k_scale, v_scale, k, v, position_ids,
               cache_mask) -> torch.Tensor:
    """Write new K/V (B, S, Hkv, D) into their cache slots, in place.

    ``position_ids`` (B, S) are the slots.  A slot the mask marks valid
    receives the new vector; any other keeps what it held, so pad tokens
    never land in the cache.  The JAX scatter adds into slots it assumes
    are zero, which gives the same result on the caches it writes.  An int8
    cache quantizes the new vectors per (slot, head) first.  Returns
    ``write_ok`` (B, S), each new token's slot validity."""
    write_ok = torch.gather(cache_mask, 1, position_ids)
    rows = torch.arange(k.shape[0], device=k.device)[:, None].expand_as(
        position_ids)
    ok = write_ok != 0

    def put(cache, new):
        keep = ok.reshape(ok.shape + (1,) * (new.dim() - 2))
        cache[rows, position_ids] = torch.where(
            keep, new.to(cache.dtype), cache[rows, position_ids])

    if k_scale is not None:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        for cache, new in ((k_cache, kq), (v_cache, vq), (k_scale, ks),
                           (v_scale, vs)):
            put(cache, new)
    else:
        put(k_cache, k)
        put(v_cache, v)
    return write_ok


def read_kv(k_cache, v_cache, k_scale, v_scale, dtype):
    """Cache slices as attention operands; an int8 cache dequantizes."""
    if k_scale is None:
        return k_cache.to(dtype), v_cache.to(dtype)
    return (dequantize_kv(k_cache, k_scale, dtype),
            dequantize_kv(v_cache, v_scale, dtype))


def _layer_with_cache(cfg: LLMConfig, lp, x, k_cache, v_cache, k_scale,
                      v_scale, cos, sin, position_ids, cache_mask,
                      impl: str = "auto", q_offset=None):
    """One decoder layer writing its fresh K/V into the cache slice.

    ``x``: (B, S, C) new tokens; ``k_cache``/``v_cache``: (B, max_len, Hkv,
    D); ``cache_mask``: (B, max_len) int32, 1 = valid slot (the new tokens'
    included).  Attention routes (``generate.py:193-228``): a multi-token
    call with ``q_offset`` (a suffix continuation) runs the kernel over the
    whole cache with each row's queries at slots ``q_offset + i``; one
    without it (a prompt into an empty cache) runs the kernel over the
    fresh tokens, masked by ``write_ok``; a decode step (S = 1) or
    ``impl="plain"`` attends over the whole cache through the slot bias."""
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    h = rms_norm(x, lp["attention_norm"]["weight"], eps=cfg.rms_norm_eps)
    q = dec._dense(lp["attention"]["wq"], h, impl).reshape(B, S, Hq, D)
    k = dec._dense(lp["attention"]["wk"], h, impl).reshape(B, S, Hkv, D)
    v = dec._dense(lp["attention"]["wv"], h, impl).reshape(B, S, Hkv, D)
    q, k = apply_rope(q, k, cos, sin, position_ids)

    write_ok = scatter_kv(k_cache, v_cache, k_scale, v_scale, k, v,
                          position_ids, cache_mask)
    if S > 1 and impl != "plain" and q_offset is not None:
        k_op, v_op = read_kv(k_cache, v_cache, k_scale, v_scale, q.dtype)
        attn = flash_attention(q, k_op, v_op, attention_mask=cache_mask,
                               causal=True, q_offset=q_offset,
                               norm_bound=_CACHE_BOUND)
    elif S > 1 and impl != "plain":
        attn = multi_head_attention(q, k, v, attention_mask=write_ok,
                                    causal=True, impl=impl,
                                    norm_bound=_CACHE_BOUND)
    else:
        k_pos = torch.arange(k_cache.shape[1], device=x.device)
        valid = ((position_ids[:, :, None] >= k_pos[None, None])
                 & (cache_mask[:, None, :] != 0))
        bias = torch.where(valid, 0.0, NEG_INF)[:, None]  # (B, 1, S, max_len)
        k_op, v_op = read_kv(k_cache, v_cache, k_scale, v_scale, q.dtype)
        attn = attention_plain(q, k_op, v_op, bias=bias)
    x = x + dec._dense(lp["attention"]["wo"], attn.reshape(B, S, Hq * D),
                       impl)

    h = rms_norm(x, lp["ffn_norm"]["weight"], eps=cfg.rms_norm_eps)
    gate = dec._dense(lp["feed_forward"]["w1"], h, impl)
    up = dec._dense(lp["feed_forward"]["w3"], h, impl)
    return x + dec._dense(lp["feed_forward"]["w2"], F.silu(gate) * up, impl)


def decoder_forward_cached(
    params, cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, S, C)
    cache: KVCache,  # written in place
    position_ids: torch.Tensor,  # (B, S) slot indices of the new tokens
    cache_mask: torch.Tensor,  # (B, max_len) valid slots incl. new tokens
    impl: str = "auto",
    q_offset: Optional[torch.Tensor] = None,  # (B,) suffix continuation
    rope_override=None,  # (cos, sin), each (B, S, D): the new tokens' own
) -> Tuple[torch.Tensor, KVCache]:
    """All layers over the new tokens, reading and writing ``cache``;
    returns the final-normed hidden states (B, S, C) and the cache.

    ``rope_override`` serves the models whose rotary positions are not the
    cache slots (Qwen2-VL's M-RoPE, ``generate.py:238-271``): each new
    token is rotated by its given cos/sin row."""
    max_len = cache.k.shape[2]
    if rope_override is not None:
        cos, sin = rope_override
    else:
        cos, sin = rope_tables(
            max_len, cfg.head_dim, base=cfg.rope_theta,
            scaling_type=cfg.rope_scaling_type,
            scaling_factor=cfg.rope_scaling_factor,
            max_position_embeddings=cfg.max_position_embeddings,
            device=inputs_embeds.device,
        )
    position_ids = position_ids.long()
    x = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        lp = map_state(lambda a: a[i], params["layers"])
        ks = None if cache.k_scale is None else cache.k_scale[i]
        vs = None if cache.v_scale is None else cache.v_scale[i]
        x = _layer_with_cache(cfg, lp, x, cache.k[i], cache.v[i], ks, vs,
                              cos, sin, position_ids, cache_mask, impl=impl,
                              q_offset=q_offset)
    return rms_norm(x, params["norm"]["weight"], eps=cfg.rms_norm_eps), cache


class GenerationConfig(NamedTuple):
    max_new_tokens: int = 256
    eos_token_id: int = 2
    temperature: float = 0.0  # 0 = greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 = off
    pad_token_id: int = 2
    kv_quant: bool = False  # int8 KV cache with per-(slot, head) scales


def filter_logits(logits: torch.Tensor, gc: GenerationConfig) -> torch.Tensor:
    """Temperature, then top-k, then the nucleus, as ``_sample`` applies
    them (``generate.py:407-425``): dropped entries become -1e30.  Ties
    with the k-th logit, or with the smallest logit inside the nucleus,
    are kept."""
    logits = logits / gc.temperature
    if gc.top_k > 0:
        kth = torch.topk(logits, gc.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if gc.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        k = (cum - probs < gc.top_p).sum(-1) - 1
        cutoff = sorted_logits.gather(-1, k[:, None])
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def _sample(logits: torch.Tensor, gc: GenerationConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids: greedy, or one draw from the
    filtered softmax."""
    if gc.temperature <= 0.0:
        return logits.argmax(-1)
    probs = torch.softmax(filter_logits(logits, gc), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _embed(params, cfg: ChatConfig, input_ids, pixel_values, vision_embeds,
           impl):
    """Token embeds with the vision embeds scattered at ``<IMG_CONTEXT>``."""
    embeds = embed_prompt(params["language_model"], input_ids,
                          cfg.img_context_token_id)
    if vision_embeds is None and pixel_values is not None:
        pix = torch.as_tensor(pixel_values).to(embeds.device, embeds.dtype)
        vision_embeds = extract_feature(params, cfg, pix, impl=impl)
    if vision_embeds is not None:
        embeds = scatter_image_embeds(embeds, input_ids, vision_embeds,
                                      cfg.img_context_token_id)
    return embeds


def _prefill(params, cfg: ChatConfig, input_ids, attention_mask,
             max_new_tokens, pixel_values, vision_embeds, impl, kv_quant):
    """A (left- or right-padded) prompt into a fresh cache sized for
    ``max_new_tokens`` more: (logits of each row's last real token, cache,
    cache mask, first free slot per row)."""
    lm = params["language_model"]
    input_ids = input_ids.long()
    B, T = input_ids.shape
    dev = input_ids.device
    embeds = _embed(params, cfg, input_ids, pixel_values, vision_embeds, impl)
    cache = init_kv_cache(cfg.llm, B, T + max_new_tokens, device=dev,
                          dtype=embeds.dtype, quant=kv_quant)
    cache_mask = F.pad(attention_mask.to(torch.int32), (0, max_new_tokens))
    slots = torch.arange(T, device=dev)[None].expand(B, T)
    hidden, cache = decoder_forward_cached(lm, cfg.llm, embeds, cache, slots,
                                           cache_mask, impl=impl)
    # The last real token per row: the largest masked index (right or left
    # padding alike).
    last_idx = torch.where(attention_mask != 0,
                           torch.arange(T, device=dev)[None], -1).amax(-1)
    logits = dec.lm_logits(lm, hidden[torch.arange(B, device=dev), last_idx],
                           impl)
    return logits, cache, cache_mask, last_idx + 1


def _step(lm, llm_cfg: LLMConfig, tok, cache, cache_mask, slot, impl):
    """Feed one token per row at ``slot`` (B,); returns the next logits.
    Marks the slot valid in ``cache_mask`` in place."""
    B = tok.shape[0]
    cache_mask[torch.arange(B, device=tok.device), slot] = 1
    emb = dec.embed_tokens(lm, tok.long()[:, None])
    hidden, _ = decoder_forward_cached(lm, llm_cfg, emb, cache,
                                       slot[:, None], cache_mask, impl=impl)
    return dec.lm_logits(lm, hidden[:, 0], impl)


def _decode_from_logits(lm, llm_cfg: LLMConfig, gc: GenerationConfig,
                        logits, cache, cache_mask, start, generator,
                        impl: str = "auto", return_state: bool = False,
                        teacher_tokens: Optional[torch.Tensor] = None):
    """Sample-and-extend loop shared by ``generate`` and
    ``generate_from_prefix``: ``logits`` (B, V) of each row's last prompt
    token, ``start`` (B,) its first free slot.  Writes into ``cache`` and
    ``cache_mask``.

    Returns (B, max_new_tokens) tokens, with ``return_state`` also the final
    (cache, cache_mask); rows that finish early pad and keep writing pad
    K/V into marked slots until all finish, so sessions are B = 1.  With
    ``teacher_tokens`` (B, n): feeds them instead of drawing and returns the
    (B, n, V) fp32 logits of each step."""
    if teacher_tokens is not None:
        steps = [logits]
        for i in range(teacher_tokens.shape[1] - 1):
            steps.append(_step(lm, llm_cfg, teacher_tokens[:, i], cache,
                               cache_mask, start + i, impl))
        return torch.stack(steps, dim=1)
    B = logits.shape[0]
    if gc.temperature > 0.0 and generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    tok = _sample(logits, gc, generator)
    out = torch.full((B, gc.max_new_tokens), gc.pad_token_id,
                     dtype=torch.long, device=logits.device)
    out[:, 0] = tok
    finished = tok == gc.eos_token_id
    for step in range(gc.max_new_tokens - 1):
        if bool(finished.all()):  # one host read per step
            break
        logits = _step(lm, llm_cfg, out[:, step], cache, cache_mask,
                       start + step, impl)
        nxt = _sample(logits, gc, generator)
        nxt = torch.where(finished, gc.pad_token_id, nxt)
        out[:, step + 1] = nxt
        finished = finished | (nxt == gc.eos_token_id)
    return (out, cache, cache_mask) if return_state else out


@torch.no_grad()
def generate(
    params,  # chat state with the LM head
    cfg: ChatConfig,
    input_ids: torch.Tensor,  # (B, T) right- or left-padded prompt
    attention_mask: torch.Tensor,  # (B, T)
    pixel_values=None,  # (P, H, W, 3)
    generation_config: GenerationConfig = GenerationConfig(),
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
    vision_embeds: Optional[torch.Tensor] = None,  # (P, n_tok, C)
    teacher_tokens: Optional[torch.Tensor] = None,  # (B, n)
) -> torch.Tensor:
    """Multimodal generation: (B, max_new_tokens) tokens, or with
    ``teacher_tokens`` the (B, n, V) logits of each step.  Cache slots are
    the sequence indices and RoPE positions are the slots; generated token
    i of a row sits at its slot ``last real index + 1 + i``."""
    gc = generation_config
    logits, cache, cache_mask, start = _prefill(
        params, cfg, input_ids, attention_mask, gc.max_new_tokens,
        pixel_values, vision_embeds, impl, gc.kv_quant)
    return _decode_from_logits(params["language_model"], cfg.llm, gc, logits,
                               cache, cache_mask, start, generator, impl,
                               teacher_tokens=teacher_tokens)


class PrefixState(NamedTuple):
    """A prompt prefix prefilled once, continued by many suffixes: ``cache``
    with slots [0, n_prefix) filled, ``cache_mask`` (B, max_len) marking
    them, ``n_prefix`` (B,) the real prefix lengths (prefixes are
    right-padded).  Functions that take a state never change it."""

    cache: KVCache
    cache_mask: torch.Tensor
    n_prefix: torch.Tensor


@torch.no_grad()
def prefill_prefix(
    params, cfg: ChatConfig,
    input_ids: torch.Tensor,  # (B, P) right-padded prefix tokens
    attention_mask: torch.Tensor,  # (B, P)
    max_len: int,  # P + longest-suffix bucket + max_new_tokens
    pixel_values=None,
    vision_embeds: Optional[torch.Tensor] = None,
    impl: str = "auto",
    kv_quant: bool = False,
) -> PrefixState:
    """Prefill a shared prompt prefix into a fresh cache (no logits: a
    prefix never ends a prompt)."""
    lm = params["language_model"]
    input_ids = input_ids.long()
    B, P = input_ids.shape
    dev = input_ids.device
    embeds = _embed(params, cfg, input_ids, pixel_values, vision_embeds, impl)
    cache = init_kv_cache(cfg.llm, B, max_len, device=dev, dtype=embeds.dtype,
                          quant=kv_quant)
    cache_mask = F.pad(attention_mask.to(torch.int32), (0, max_len - P))
    slots = torch.arange(P, device=dev)[None].expand(B, P)
    decoder_forward_cached(lm, cfg.llm, embeds, cache, slots, cache_mask,
                           impl=impl)
    return PrefixState(cache, cache_mask,
                       attention_mask.sum(-1).to(torch.int32))


@torch.no_grad()
def generate_from_prefix(
    params, cfg: ChatConfig,
    state: PrefixState,
    suffix_ids: torch.Tensor,  # (B, S) right-padded suffix tokens
    suffix_mask: torch.Tensor,  # (B, S)
    generation_config: GenerationConfig = GenerationConfig(),
    generator: Optional[torch.Generator] = None,
    return_state: bool = False,
    impl: str = "auto",
    teacher_tokens: Optional[torch.Tensor] = None,
):
    """Continue a cached prefix with a per-question suffix, then decode.

    The suffix takes slots [n_prefix, n_prefix + s_real), contiguous with
    the prefix, so RoPE positions and causality equal those of the whole
    prompt prefilled at once; its attention runs the same kernel as a
    full-prompt prefill, over the whole cache with ``q_offset = n_prefix``.
    Works on a copy of ``state``.  ``return_state`` also returns the final
    (cache, cache_mask) (B = 1); ``teacher_tokens`` as in ``generate``."""
    gc = generation_config
    lm = params["language_model"]
    suffix_ids = suffix_ids.long()
    B, S = suffix_ids.shape
    dev = suffix_ids.device
    cache = state.cache.clone()
    cache_mask = state.cache_mask.clone()
    slots = state.n_prefix.long()[:, None] + torch.arange(S, device=dev)[None]
    rows = torch.arange(B, device=dev)[:, None].expand(B, S)
    # The suffix's slots are free in the state, so setting them is JAX's add.
    cache_mask[rows, slots] = suffix_mask.to(cache_mask.dtype)
    emb = dec.embed_tokens(lm, suffix_ids)
    hidden, cache = decoder_forward_cached(lm, cfg.llm, emb, cache, slots,
                                           cache_mask, impl=impl,
                                           q_offset=state.n_prefix)
    s_real = suffix_mask.long().sum(-1)
    logits = dec.lm_logits(lm, hidden[torch.arange(B, device=dev), s_real - 1],
                           impl)
    return _decode_from_logits(lm, cfg.llm, gc, logits, cache, cache_mask,
                               state.n_prefix.long() + s_real, generator, impl,
                               return_state=return_state,
                               teacher_tokens=teacher_tokens)


def stack_prefix_states(states):
    """Batch B = 1 prefix states into one (a preference pair's two videos)
    in new buffers; all must share max_len.  Any family's state tuple
    (``PrefixState``, ``qwen2vl.PrefixCache``, ``minicpmv.PrefixCache``):
    its ``KVCache`` concatenated on the batch axis, its tensors on their
    first, its ints (the shared prefix length and max_len) kept."""
    def stack(vals):
        if isinstance(vals[0], KVCache):
            return KVCache(*(None if ts[0] is None else torch.cat(ts, dim=1)
                             for ts in zip(*vals)))
        if isinstance(vals[0], torch.Tensor):
            return torch.cat(vals)
        return vals[0]

    return type(states[0])(*(stack(vals) for vals in zip(*states)))


def round_up_bucket(n: int, bucket: int = 64) -> int:
    """Prompt-length bucketing (keeps the set of shapes small)."""
    return (n + bucket - 1) // bucket * bucket


def greedy_decode_batch(step_fn, params, logits0: torch.Tensor, cache,
                        max_new_tokens: int, eos: int):
    """The batched greedy loop (``generate.py:289-328``).

    ``step_fn(params, tok (B,) int32, i, cache) -> (logits (B, V), cache)``
    is the caller's cached step over one new token per row.  Stops once
    every row has emitted ``eos`` (one host read per step) or the budget is
    spent; finished rows keep feeding ``eos``.  The forward after the token
    that ends the generation (every row done, or the last slot) is
    skipped, as its logits would never be read.  Returns (toks (B,
    max_new_tokens) int32, eos-filled past each row's end; n (B,) int32,
    the tokens each row emitted, its eos included)."""
    B = logits0.shape[0]
    dev = logits0.device
    toks = torch.full((B, max_new_tokens), eos, dtype=torch.int32,
                      device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    logits, i, finished = logits0, 0, False
    while i < max_new_tokens and not finished:
        tok = torch.where(done, eos, logits.argmax(-1).to(torch.int32))
        toks[:, i] = tok
        n += (~done).to(torch.int32)
        done = done | (tok == eos)
        finished = bool(done.all())
        if not finished and i + 1 < max_new_tokens:
            logits, cache = step_fn(params, tok, i, cache)
        i += 1
    return toks, n


def decode_batch(step_fn, params, logits0: torch.Tensor, cache,
                 max_new_tokens: int, eos: int,
                 teacher_tokens: Optional[torch.Tensor] = None):
    """``greedy_decode_batch``, or with ``teacher_tokens`` (B, n) the
    steps' logits (``teacher_forced_logits``): the tail of the judge
    families' generation (Qwen2-VL, MiniCPM-V)."""
    if teacher_tokens is not None:
        return teacher_forced_logits(step_fn, params, logits0, cache,
                                     teacher_tokens)
    return greedy_decode_batch(step_fn, params, logits0, cache,
                               max_new_tokens, eos)


def greedy_decode(step_fn, params, logits0: torch.Tensor, cache,
                  max_new_tokens: int, eos: int):
    """The B = 1 loop (``generate.py:331-340``): ``step_fn`` takes a scalar
    token; returns (toks (max_new_tokens,) int32, count)."""
    toks, n = greedy_decode_batch(
        lambda p, tok, i, c: step_fn(p, tok[0], i, c),
        params, logits0, cache, max_new_tokens, eos)
    return toks[0], n[0]


def teacher_forced_logits(step_fn, params, logits0: torch.Tensor, cache,
                          teacher_tokens: torch.Tensor) -> torch.Tensor:
    """``greedy_decode_batch``'s steps fed ``teacher_tokens`` (B, n) in
    place of its own picks: the (B, n, V) fp32 logits of each step, the
    first ``logits0``."""
    steps = [logits0]
    for i in range(teacher_tokens.shape[1] - 1):
        logits, cache = step_fn(params, teacher_tokens[:, i].to(torch.int32),
                                i, cache)
        steps.append(logits)
    return torch.stack(steps, dim=1)


def pad_prompt_batch(ids_list, pad_id: int, bucket: int = 64):
    """[(1, T_i) prompts] -> ((B, Tb) right-padded int32 ids, (B,) int32
    n_real, Tb), every row bucketed to the same width
    (``generate.py:353-361``)."""
    n_real = np.asarray([ids.shape[1] for ids in ids_list], np.int32)
    Tb = round_up_bucket(int(n_real.max()), bucket)
    out = np.full((len(ids_list), Tb), pad_id, np.int32)
    for b, ids in enumerate(ids_list):
        out[b, : ids.shape[1]] = np.asarray(ids)[0]
    return out, n_real, Tb


def _rows(n_real, device=None) -> torch.Tensor:
    """n_real (an int or (B,)) -> a (B, 1) int64 column."""
    return torch.as_tensor(n_real, device=device).reshape(-1, 1).long()


def prefill_slot_mask(Tb: int, max_len: int, n_real, device=None):
    """Cache slots and validity mask of a right-padded prompt's prefill
    (``generate.py:369-377``): ((B, Tb) int64 slots 0..Tb-1, (B, max_len)
    int32 mask of the slots below each row's ``n_real``)."""
    nr = _rows(n_real, device)
    dev = nr.device
    slots = torch.arange(Tb, device=dev)[None].expand(nr.shape[0], Tb)
    mask = (torch.arange(max_len, device=dev)[None] < nr).to(torch.int32)
    return slots, mask


def step_slot_mask(max_len: int, n_real, i: int, device=None):
    """Cache slot and validity mask of each row's i-th generated token
    (``generate.py:380-385``): ((B, 1) slots n_real + i, (B, max_len)
    int32 mask of the slots up to it)."""
    nr = _rows(n_real, device)
    slots = nr + i
    mask = (torch.arange(max_len, device=nr.device)[None]
            < nr + i + 1).to(torch.int32)
    return slots, mask


def last_real_token(hidden: torch.Tensor, n_real) -> torch.Tensor:
    """(B, T, C) -> (B, 1, C) at each row's last real prompt position
    (``generate.py:388-393``)."""
    idx = _rows(n_real, hidden.device) - 1
    idx = idx.expand(hidden.shape[0], 1)[:, :, None].expand(
        hidden.shape[0], 1, hidden.shape[2])
    return torch.gather(hidden, 1, idx)


def _eos_pad(cfg: ChatConfig, tokenizer) -> Tuple[int, int]:
    from ..data.conversation import get_template

    template = get_template(cfg.template)
    eos = tokenizer.convert_tokens_to_ids(template.sep.strip())
    pad = getattr(tokenizer, "pad_token_id", None) or cfg.llm.pad_token_id
    return eos, pad


def _decode_text(tokenizer, toks: List[int], eos: int):
    if eos in toks:
        toks = toks[: toks.index(eos)]
    return tokenizer.decode(toks) if hasattr(tokenizer, "decode") else toks


def batch_chat_inputs(
    cfg: ChatConfig, tokenizer, questions, num_patches_lists=None,
    has_image: bool = True,
    generation_config: GenerationConfig = GenerationConfig(),
):
    """``batch_chat``'s prompts, left-padded to one bucket: (ids (B, T)
    int64, mask (B, T) int32, the generation config with the template's
    EOS and the tokenizer's pad)."""
    from ..data.prompts import prepare_chat_input

    chats = [prepare_chat_input(
        cfg, tokenizer, q,
        num_patches_list=num_patches_lists[i] if num_patches_lists else None,
        has_image=has_image, require_gating=False)
        for i, q in enumerate(questions)]
    T = round_up_bucket(max(c.input_ids.shape[1] for c in chats))
    eos, pad = _eos_pad(cfg, tokenizer)
    ids = np.full((len(chats), T), pad, np.int64)
    mask = np.zeros((len(chats), T), np.int32)
    for i, c in enumerate(chats):
        L = c.input_ids.shape[1]
        ids[i, T - L:] = c.input_ids[0]
        mask[i, T - L:] = c.attention_mask[0]
    gc = generation_config._replace(eos_token_id=eos, pad_token_id=pad)
    return torch.from_numpy(ids), torch.from_numpy(mask), gc


def batch_chat(
    params, cfg: ChatConfig, tokenizer, questions,
    pixel_values=None, num_patches_lists=None,
    generation_config: GenerationConfig = GenerationConfig(),
    impl: str = "auto",
    vision_embeds=None,
):
    """Batched single-turn chat (``modeling_internvl_chat.py:336-367``):
    prompts left-padded to one bucket and decoded together."""
    ids, mask, gc = batch_chat_inputs(
        cfg, tokenizer, questions, num_patches_lists,
        pixel_values is not None or vision_embeds is not None,
        generation_config)
    dev = first_tensor(params).device
    out = generate(params, cfg, ids.to(dev), mask.to(dev),
                   pixel_values=pixel_values, generation_config=gc,
                   impl=impl, vision_embeds=vision_embeds)
    return [_decode_text(tokenizer, row, gc.eos_token_id)
            for row in out.tolist()]


def chat(
    params, cfg: ChatConfig, tokenizer, question: str,
    pixel_values=None, num_patches_list=None,
    history=None, generation_config: GenerationConfig = GenerationConfig(),
    impl: str = "auto",
    vision_embeds=None,
) -> Tuple[str, list]:
    """Single-turn chat (``modeling_internvl_chat.py:264-334``): the prompt
    right-padded to its bucket; returns (response, new history)."""
    from ..data.prompts import prepare_chat_input

    if num_patches_list is None and pixel_values is not None:
        num_patches_list = [pixel_values.shape[0]]
    if num_patches_list is None and vision_embeds is not None:
        num_patches_list = [vision_embeds.shape[0]]
    chat_in = prepare_chat_input(
        cfg, tokenizer, question, num_patches_list=num_patches_list,
        history=history, require_gating=False)
    eos, pad = _eos_pad(cfg, tokenizer)
    gc = generation_config._replace(eos_token_id=eos, pad_token_id=pad)
    ids = np.asarray(chat_in.input_ids, np.int64)
    mask = np.asarray(chat_in.attention_mask, np.int32)
    T = ids.shape[1]
    Tb = round_up_bucket(T)
    ids = np.pad(ids, ((0, 0), (0, Tb - T)), constant_values=gc.pad_token_id)
    mask = np.pad(mask, ((0, 0), (0, Tb - T)))
    dev = first_tensor(params).device
    out = generate(params, cfg, torch.from_numpy(ids).to(dev),
                   torch.from_numpy(mask).to(dev), pixel_values=pixel_values,
                   generation_config=gc, impl=impl,
                   vision_embeds=vision_embeds)
    response = _decode_text(tokenizer, out[0].tolist(), eos)
    return response, (history or []) + [(question, response)]


@torch.no_grad()
def stream_generate(
    params, cfg: ChatConfig,
    input_ids: torch.Tensor,  # (1, T)
    attention_mask: torch.Tensor,
    pixel_values=None,
    generation_config: GenerationConfig = GenerationConfig(),
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
):
    """Token-by-token generation as a Python generator (B = 1), the
    counterpart of ``InternLM2ForCausalLM.stream_chat``'s streamer
    (``modeling_internlm2.py:1270-1292``); the prompt is right-padded to
    its bucket."""
    gc = generation_config
    B, T = input_ids.shape
    assert B == 1, "streaming is a single-conversation surface"
    Tb = round_up_bucket(T)
    input_ids = F.pad(input_ids.long(), (0, Tb - T), value=gc.pad_token_id)
    attention_mask = F.pad(attention_mask, (0, Tb - T))
    logits, cache, cache_mask, start = _prefill(
        params, cfg, input_ids, attention_mask, gc.max_new_tokens,
        pixel_values, None, impl, gc.kv_quant)
    if gc.temperature > 0.0 and generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    tok = _sample(logits, gc, generator)
    for step in range(gc.max_new_tokens):
        t = int(tok[0])
        if t == gc.eos_token_id:
            return
        yield t
        if step == gc.max_new_tokens - 1:
            return
        logits = _step(params["language_model"], cfg.llm, tok, cache,
                       cache_mask, start + step, impl)
        tok = _sample(logits, gc, generator)


def stream_chat(
    params, cfg: ChatConfig, tokenizer, question: str,
    pixel_values=None, num_patches_list=None, history=None,
    generation_config: GenerationConfig = GenerationConfig(),
    impl: str = "auto",
):
    """Streaming single-turn chat: yields the growing response string; the
    last value is the whole response."""
    from ..data.prompts import prepare_chat_input

    if num_patches_list is None and pixel_values is not None:
        num_patches_list = [pixel_values.shape[0]]
    chat_in = prepare_chat_input(
        cfg, tokenizer, question, num_patches_list=num_patches_list,
        history=history, require_gating=False)
    eos, _ = _eos_pad(cfg, tokenizer)
    gc = generation_config._replace(eos_token_id=eos)
    dev = first_tensor(params).device
    toks: list = []
    for t in stream_generate(
            params, cfg, torch.as_tensor(chat_in.input_ids).to(dev),
            torch.as_tensor(chat_in.attention_mask).to(dev),
            pixel_values=pixel_values, generation_config=gc, impl=impl):
        toks.append(t)
        yield (tokenizer.decode(toks) if hasattr(tokenizer, "decode")
               else list(toks))


class ChatSession:
    """Multi-turn chat that keeps the conversation's KV across turns
    (``generate.py:925-1050``): each turn continues the cached
    conversation as a suffix (the new user turn plus the previous answer's
    last token, whose K/V decode never wrote), and the decode's own cache
    writes persist for the next turn.  Each turn re-renders the whole
    conversation and compares its token prefix with what the cache holds;
    if the tokenizer merged across a turn boundary, the session prefills
    from scratch.  B = 1; vision enters on the first turn."""

    def __init__(self, params, cfg: ChatConfig, tokenizer,
                 max_len: int = 2048,
                 generation_config: GenerationConfig = GenerationConfig(),
                 impl: str = "auto", kv_quant: bool = False,
                 suffix_bucket: int = 128):
        self.params, self.cfg, self.tokenizer = params, cfg, tokenizer
        eos, pad = _eos_pad(cfg, tokenizer)
        self.gc = generation_config._replace(eos_token_id=eos,
                                             pad_token_id=pad)
        self.max_len = max_len
        self.impl = impl
        self.kv_quant = kv_quant
        self.suffix_bucket = suffix_bucket
        self.device = first_tensor(params).device
        self.history: list = []
        self._state: Optional[PrefixState] = None
        self._cached: list = []   # token ids whose K/V are in the cache
        self._pending: list = []  # generated tail whose K/V is not yet

    def _render(self, question, num_patches_list):
        from ..data.prompts import prepare_chat_input

        chat_in = prepare_chat_input(
            self.cfg, self.tokenizer, question,
            num_patches_list=num_patches_list, history=self.history,
            require_gating=False)
        return [int(t) for t in chat_in.input_ids[0]]

    def _row(self, toks, width):
        """(1, width) right-padded ids and mask on the session's device."""
        ids = torch.full((1, width), self.gc.pad_token_id, dtype=torch.long)
        ids[0, : len(toks)] = torch.tensor(toks, dtype=torch.long)
        mask = torch.zeros((1, width), dtype=torch.int32)
        mask[0, : len(toks)] = 1
        return ids.to(self.device), mask.to(self.device)

    def _fresh_prefill(self, full_ids, pixel_values, vision_embeds):
        """(Re)build the session cache from everything but the last prompt
        token, which leads the first suffix."""
        P = len(full_ids) - 1
        Pb = round_up_bucket(max(P, 1))
        if Pb + self.suffix_bucket + self.gc.max_new_tokens > self.max_len:
            raise ValueError(
                f"conversation ({P} tokens) exceeds the session max_len "
                f"{self.max_len}; raise max_len at session start")
        ids, mask = self._row(full_ids[:P], Pb)
        self._state = prefill_prefix(
            self.params, self.cfg, ids, mask, max_len=self.max_len,
            pixel_values=pixel_values, vision_embeds=vision_embeds,
            impl=self.impl, kv_quant=self.kv_quant)
        self._cached = list(full_ids[:P])
        self._pending = [full_ids[P]]

    def ask(self, question: str, pixel_values=None, vision_embeds=None,
            num_patches_list=None) -> str:
        if num_patches_list is None and pixel_values is not None:
            num_patches_list = [pixel_values.shape[0]]
        if num_patches_list is None and vision_embeds is not None:
            num_patches_list = [vision_embeds.shape[0]]
        if self.history and num_patches_list is not None:
            raise ValueError("vision enters on the FIRST turn only")

        full_ids = self._render(question, num_patches_list)
        known = self._cached + self._pending
        if self._state is None or full_ids[: len(known)] != known:
            self._fresh_prefill(full_ids, pixel_values, vision_embeds)
            known = self._cached + self._pending
        suffix = self._pending + full_ids[len(known):]
        Sb = round_up_bucket(len(suffix), self.suffix_bucket)
        if len(self._cached) + Sb + self.gc.max_new_tokens > self.max_len:
            raise ValueError(
                f"turn needs {len(self._cached) + Sb} prompt slots "
                f"+ {self.gc.max_new_tokens} decode slots; raise max_len")
        sids, smask = self._row(suffix, Sb)
        out, cache, mask = generate_from_prefix(
            self.params, self.cfg, self._state, sids, smask,
            generation_config=self.gc, return_state=True, impl=self.impl)
        toks = out[0].tolist()
        if self.gc.eos_token_id in toks:
            toks = toks[: toks.index(self.gc.eos_token_id) + 1]
        # K/V now present for the suffix and every generated token but the
        # last (drawn, never fed back); it leads the next suffix.
        self._cached += suffix + toks[:-1]
        self._pending = toks[-1:]
        self._state = PrefixState(
            cache, mask, torch.tensor([len(self._cached)], dtype=torch.int32,
                                      device=self.device))
        answer = toks[:-1] if toks[-1] == self.gc.eos_token_id else toks
        response = (self.tokenizer.decode(answer)
                    if hasattr(self.tokenizer, "decode") else answer)
        self.history.append((question, response))
        return response
