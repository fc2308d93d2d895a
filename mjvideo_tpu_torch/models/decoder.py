"""Decoder LLM, InternLM2 / Llama path.

Counterpart of ``mjvideo_tpu/models/decoder.py`` (reference
``modeling_internlm2.py``) for reward scoring and training: separate q/k/v
kernels (the packed ``wqkv`` is unpacked at import), GQA without repeated kv
heads, fp32 RMSNorm statistics, RoPE tables built per call, each layer
rematerialised per ``remat`` (``ops/remat.py``).  The LM head (``output``)
and ``lm_logits`` serve generation; the cached layers live in
``models/generate.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mjvideo_tpu.configs import LLMConfig

from ..ops.attention import multi_head_attention
from ..ops.matmul import dot, dot_f32
from ..ops.norms import rms_norm
from ..ops.remat import remat_wrap
from ..ops.rope import apply_rope, rope_tables
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


def _dense(p, x):
    y = dot(x, p["kernel"])
    if "bias" in p:
        y = y + p["bias"]
    return y


def _decoder_layer(cfg: LLMConfig, p, x, attention_mask, cos, sin, impl):
    """One layer (``modeling_internlm2.py:610-681``)."""
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    h = rms_norm(x, p["attention_norm"]["weight"], eps=cfg.rms_norm_eps)
    q = _dense(p["attention"]["wq"], h).reshape(B, S, Hq, D)
    k = _dense(p["attention"]["wk"], h).reshape(B, S, Hkv, D)
    v = _dense(p["attention"]["wv"], h).reshape(B, S, Hkv, D)
    q, k = apply_rope(q, k, cos, sin)
    # The global bound kernel K2, as the JAX decoder takes it by default
    # (decoder.py _LLM_BOUND); the cached paths keep the exact K3.
    attn = multi_head_attention(q, k, v, attention_mask=attention_mask,
                                causal=True, impl=impl, norm_bound=True)
    x = x + _dense(p["attention"]["wo"], attn.reshape(B, S, Hq * D))

    h = rms_norm(x, p["ffn_norm"]["weight"], eps=cfg.rms_norm_eps)
    gate = _dense(p["feed_forward"]["w1"], h)
    up = _dense(p["feed_forward"]["w3"], h)
    return x + _dense(p["feed_forward"]["w2"], F.silu(gate) * up)


def decoder_forward(
    params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, S, C)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) 1 = real
    impl: str = "auto",
    remat=True,
) -> torch.Tensor:
    """All layers + the final norm: hidden states (B, S, C).

    The stacked ``[L, ...]`` layer tensors are unbound once, so their
    gradient is one stack of the per-layer gradients."""
    S = inputs_embeds.shape[1]
    cos, sin = rope_tables(
        S, cfg.head_dim, base=cfg.rope_theta,
        scaling_type=cfg.rope_scaling_type,
        scaling_factor=cfg.rope_scaling_factor,
        max_position_embeddings=cfg.max_position_embeddings,
        device=inputs_embeds.device,
    )
    block = remat_wrap(
        lambda layer, x: _decoder_layer(cfg, layer, x, attention_mask, cos,
                                        sin, impl), remat)
    layers = map_state(lambda a: a.unbind(0), params["layers"])
    x = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        x = block(map_state(lambda a: a[i], layers), x)
    return rms_norm(x, params["norm"]["weight"], eps=cfg.rms_norm_eps)


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (``tok_embeddings``)."""
    return F.embedding(input_ids, params["tok_embeddings"])


def lm_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    """LM head projection with fp32 logits (``decoder.py:208-210``)."""
    return dot_f32(hidden, params["output"]["kernel"])
