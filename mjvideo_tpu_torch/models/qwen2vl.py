"""Qwen2-VL: the second local judge family (2B and 7B).

Counterpart of ``mjvideo_tpu/models/qwen2vl.py`` (the reference runs
Qwen2-VL through ms-swift, ``eval_overall_qwen2_2b.py:119-129``): a
windowless ViT with 2D rotary embeddings and a 2x2 patch merger, and a Qwen2
text model (the port's Llama-family decoder, ``models/decoder.py``) with
3-channel multimodal RoPE (M-RoPE).  What differs from the JAX package:

* The vision tower's attention is K1 at the tower's head dim of 80
  (``flash_attention(norm_bound=True)``, 16 heads over each temporal slab's
  h w patches, non-causal and maskless; its plain twin on the CPU), forward
  only: the judge takes no gradient, and under autograd the attention
  raises (``ops.flash_attention.K4NC_D80_NEXT``).
* The functions run eagerly: ``_jit_vision``, ``_generate_fn``,
  ``_prefix_fn`` and ``_suffix_fn`` become ``vision_forward``,
  ``greedy_generate_batch``, ``prefill_prefix`` and ``continue_prefix``;
  the decode loop is ``generate.greedy_decode_batch``'s Python loop.  The
  cached prefill and a suffix continuation run the kernels of
  ``generate._layer_with_cache`` (K3 over the fresh tokens, and over the
  whole cache with ``q_offset`` = the prefix length; K2r under
  ``MJV_CACHE_NORM_BOUND=1``), so a prefix-cached answer runs the same
  kernel as the full prompt; decode steps take the grouped einsum over the
  cache.
* ``continue_prefix`` works on a copy of the prefix cache (the judge reuses
  one per video); ``greedy_generate_batch`` and ``continue_prefix`` can feed
  ``teacher_tokens`` and return each step's fp32 logits.
* Weights come from an explicit ``torch.Generator``
  (``init_qwen2vl_params``) or an HF state (``import_qwen2vl_params``;
  ``export_qwen2vl_state`` writes one back, which the JAX package lacks).
* M-RoPE positions (``get_rope_index``) and the preprocessing
  (``smart_resize``, ``preprocess_video_frames``) are host numpy, copied as
  they are.
* ``mesh=`` (a ``parallel.mesh.Mesh``; JAX takes sharded ``params``): the
  held model ranks' states (``shard_params``) run the tower (each rank's
  heads of the packed qkv, the rotary on them, ``proj`` and ``fc2``
  row-parallel), the text decoder, its caches and the LM head (tied: the
  embedding's vocabulary rows) split over the model axis; the prompt rows
  split over the data axis (``generate.over_data``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import LLMConfig
from ..data.video import CLIP_MEAN, CLIP_STD
from ..ops.attention import multi_head_attention
from ..ops.matmul import dot, gelu
from ..ops.norms import layer_norm
from ..ops.rope import rotate_half
from ..parallel.mesh import (
    held,
    held_layers,
    model_axis,
    pair_forward,
    row_dot,
    sub,
)
from ..utils.bridge import first_tensor, map_state
from . import decoder as dec
from .generate import (
    KVCache,
    decode_batch,
    decoder_forward_cached,
    init_kv_cache,
    last_real_token,
    over_data,
    pad_prompt_batch,
    prefill_slot_mask,
    slice_state,
    step_slot_mask,
)
from .internvl import scatter_image_embeds


@dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    in_channels: int = 3
    hidden_size: int = 1536  # the LLM hidden the merger projects into
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def merge_dim(self) -> int:
        return self.embed_dim * self.spatial_merge_size**2


@dataclass(frozen=True)
class Qwen2VLConfig:
    vision: Qwen2VLVisionConfig = field(default_factory=Qwen2VLVisionConfig)
    # Qwen2-VL-2B's text model (Qwen/Qwen2-VL-2B-Instruct config.json).
    text: LLMConfig = field(default_factory=lambda: LLMConfig(
        architecture="llama", vocab_size=151936, hidden_size=1536,
        intermediate_size=8960, num_hidden_layers=28,
        num_attention_heads=12, num_key_value_heads=2,
        rope_theta=1e6, rms_norm_eps=1e-6, pad_token_id=151643,
        max_position_embeddings=32768, bias=True,
    ))
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    tie_word_embeddings: bool = True  # the 2B ties; the 7B does not
    # Special token ids (the Qwen2-VL tokenizer's).
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645


def qwen2vl_config_from_hf(d: Dict[str, Any]) -> Qwen2VLConfig:
    """A ``Qwen2VLConfig`` from an HF Qwen2-VL ``config.json`` dict
    (``qwen2vl.py:94-130``)."""
    v = d.get("vision_config", {})
    rope_scaling = d.get("rope_scaling") or {}
    return Qwen2VLConfig(
        vision=Qwen2VLVisionConfig(
            depth=v.get("depth", 32),
            embed_dim=v.get("embed_dim", 1280),
            num_heads=v.get("num_heads", 16),
            mlp_ratio=v.get("mlp_ratio", 4),
            patch_size=v.get("patch_size", 14),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            in_channels=v.get("in_channels", 3),
            hidden_size=v.get("hidden_size", d.get("hidden_size", 1536)),
        ),
        text=LLMConfig(
            architecture="llama",
            vocab_size=d.get("vocab_size", 151936),
            hidden_size=d.get("hidden_size", 1536),
            intermediate_size=d.get("intermediate_size", 8960),
            num_hidden_layers=d.get("num_hidden_layers", 28),
            num_attention_heads=d.get("num_attention_heads", 12),
            num_key_value_heads=d.get("num_key_value_heads", 2),
            rope_theta=d.get("rope_theta", 1e6),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            pad_token_id=d.get("pad_token_id", 151643) or 151643,
            max_position_embeddings=d.get("max_position_embeddings", 32768),
            bias=True,
        ),
        mrope_section=tuple(rope_scaling.get("mrope_section", (16, 24, 24))),
        tie_word_embeddings=d.get("tie_word_embeddings", True),
        image_token_id=d.get("image_token_id", 151655),
        video_token_id=d.get("video_token_id", 151656),
        vision_start_token_id=d.get("vision_start_token_id", 151652),
        vision_end_token_id=d.get("vision_end_token_id", 151653),
    )


def qwen2vl_config_to_hf(cfg: Qwen2VLConfig) -> Dict[str, Any]:
    """The HF ``config.json`` dict that ``qwen2vl_config_from_hf`` reads
    back as ``cfg`` (its im_start / im_end ids are the tokenizer's, not the
    config's: they keep their defaults)."""
    v, t = cfg.vision, cfg.text
    return {
        "architectures": ["Qwen2VLForConditionalGeneration"],
        "model_type": "qwen2_vl",
        "vision_config": {
            "depth": v.depth, "embed_dim": v.embed_dim,
            "num_heads": v.num_heads, "mlp_ratio": v.mlp_ratio,
            "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "in_channels": v.in_channels, "hidden_size": v.hidden_size},
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "rope_theta": t.rope_theta, "rms_norm_eps": t.rms_norm_eps,
        "pad_token_id": t.pad_token_id,
        "max_position_embeddings": t.max_position_embeddings,
        "rope_scaling": {"type": "mrope",
                         "mrope_section": list(cfg.mrope_section)},
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_end_token_id": cfg.vision_end_token_id,
    }


def qwen2vl_7b_config() -> Qwen2VLConfig:
    """Qwen2-VL-7B-Instruct's dims (Qwen/Qwen2-VL-7B-Instruct config.json,
    ``qwen2vl.py:133-155``): the 2B's ViT; the text model at 3584 with
    28/4 heads and an untied LM head."""
    return Qwen2VLConfig(
        vision=Qwen2VLVisionConfig(hidden_size=3584),
        text=LLMConfig(
            architecture="llama", vocab_size=152064, hidden_size=3584,
            intermediate_size=18944, num_hidden_layers=28,
            num_attention_heads=28, num_key_value_heads=4, rope_theta=1e6,
            rms_norm_eps=1e-6, pad_token_id=151643,
            max_position_embeddings=32768, bias=True,
        ),
        tie_word_embeddings=False,
    )


# ------------------------------------------------------------------ params

def init_qwen2vl_params(cfg: Qwen2VLConfig, *, generator: torch.Generator,
                        device, dtype: torch.dtype = torch.float32):
    """Random state in the JAX package's layout (``qwen2vl.py:160-202``):
    dense kernels N(0, 0.02) (in, out), norms 1 and biases 0, the ViT's
    blocks stacked on a leading axis; the text model's ``output`` kernel
    only where the config unties it."""
    vc = cfg.vision
    E, I, L, M = vc.embed_dim, vc.embed_dim * vc.mlp_ratio, vc.depth, \
        vc.merge_dim

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device) * 0.02
        return w.to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    vision = {
        "patch_embed": {"kernel": dense(vc.patch_dim, E)},
        "blocks": {
            "norm1": {"weight": ones(L, E), "bias": zeros(L, E)},
            "norm2": {"weight": ones(L, E), "bias": zeros(L, E)},
            "attn": {
                "qkv": {"kernel": dense(L, E, 3 * E), "bias": zeros(L, 3 * E)},
                "proj": {"kernel": dense(L, E, E), "bias": zeros(L, E)},
            },
            "mlp": {
                "fc1": {"kernel": dense(L, E, I), "bias": zeros(L, I)},
                "fc2": {"kernel": dense(L, I, E), "bias": zeros(L, E)},
            },
        },
        "merger": {
            "ln_q": {"weight": ones(E), "bias": zeros(E)},
            "mlp0": {"kernel": dense(M, M), "bias": zeros(M)},
            "mlp2": {"kernel": dense(M, vc.hidden_size),
                     "bias": zeros(vc.hidden_size)},
        },
    }
    text = dec.init_decoder_params(
        cfg.text, generator=generator, device=device, dtype=dtype,
        with_lm_head=not cfg.tie_word_embeddings)
    return {"visual": vision, "language_model": text}


# HF names of the ViT's per-block leaves (JAX path, HF suffix, transposed).
_VISION_BLOCK = (
    (("norm1", "weight"), "norm1.weight", False),
    (("norm1", "bias"), "norm1.bias", False),
    (("norm2", "weight"), "norm2.weight", False),
    (("norm2", "bias"), "norm2.bias", False),
    (("attn", "qkv", "kernel"), "attn.qkv.weight", True),
    (("attn", "qkv", "bias"), "attn.qkv.bias", False),
    (("attn", "proj", "kernel"), "attn.proj.weight", True),
    (("attn", "proj", "bias"), "attn.proj.bias", False),
    (("mlp", "fc1", "kernel"), "mlp.fc1.weight", True),
    (("mlp", "fc1", "bias"), "mlp.fc1.bias", False),
    (("mlp", "fc2", "kernel"), "mlp.fc2.weight", True),
    (("mlp", "fc2", "bias"), "mlp.fc2.bias", False),
)
_MERGER = (
    (("ln_q", "weight"), "merger.ln_q.weight", False),
    (("ln_q", "bias"), "merger.ln_q.bias", False),
    (("mlp0", "kernel"), "merger.mlp.0.weight", True),
    (("mlp0", "bias"), "merger.mlp.0.bias", False),
    (("mlp2", "kernel"), "merger.mlp.2.weight", True),
    (("mlp2", "bias"), "merger.mlp.2.bias", False),
)
# The text model's per-layer leaves; o_proj has no bias in Qwen2.
_TEXT_LAYER = (
    (("attention_norm", "weight"), "input_layernorm.weight", False),
    (("ffn_norm", "weight"), "post_attention_layernorm.weight", False),
    (("attention", "wq", "kernel"), "self_attn.q_proj.weight", True),
    (("attention", "wq", "bias"), "self_attn.q_proj.bias", False),
    (("attention", "wk", "kernel"), "self_attn.k_proj.weight", True),
    (("attention", "wk", "bias"), "self_attn.k_proj.bias", False),
    (("attention", "wv", "kernel"), "self_attn.v_proj.weight", True),
    (("attention", "wv", "bias"), "self_attn.v_proj.bias", False),
    (("attention", "wo", "kernel"), "self_attn.o_proj.weight", True),
    (("attention", "wo", "bias"), "self_attn.o_proj.bias", False),
    (("feed_forward", "w1", "kernel"), "mlp.gate_proj.weight", True),
    (("feed_forward", "w3", "kernel"), "mlp.up_proj.weight", True),
    (("feed_forward", "w2", "kernel"), "mlp.down_proj.weight", True),
)


def _put(tree: dict, path, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def import_qwen2vl_params(state, cfg: Qwen2VLConfig,
                          dtype: torch.dtype = torch.float32,
                          device="cuda"):
    """An HF ``Qwen2VLForConditionalGeneration`` state (name -> tensor or
    array, e.g. ``utils.checkpoint.load_safetensors_dir``) -> the state
    ``qwen2vl_forward`` takes, on ``device`` (the card unless the caller
    asks for another) in ``dtype`` (``qwen2vl.py:205-312``).  Names may
    carry a ``model.`` or ``model.model.`` prefix; the text model sits
    under ``language_model.`` or, in older layouts, ``model.``.  A missing
    ``o_proj`` bias is zero (Qwen2 has none)."""
    vc, tc = cfg.vision, cfg.text

    def g(name):
        for prefix in ("", "model.", "model.model."):
            if prefix + name in state:
                w = state[prefix + name]
                return (w if isinstance(w, torch.Tensor)
                        else torch.from_numpy(np.asarray(w)))
        raise KeyError(name)

    def leaf(t):
        return t.to(device=device, dtype=dtype).contiguous()

    def stack(fmt, n, transpose, zeros_like=None):
        ws = []
        for i in range(n):
            try:
                w = g(fmt.format(i=i)).float()
            except KeyError:
                if zeros_like is None:
                    raise
                w = torch.zeros(zeros_like)
            ws.append(w.t() if transpose else w)
        return leaf(torch.stack(ws))

    vis = "visual."
    vision: Dict[str, Any] = {"patch_embed": {"kernel": leaf(
        g(vis + "patch_embed.proj.weight").float()
        .reshape(vc.embed_dim, -1).t())}}
    for path, name, t in _VISION_BLOCK:
        _put(vision, ("blocks",) + path,
             stack(vis + "blocks.{i}." + name, vc.depth, t))
    for path, name, t in _MERGER:
        w = g(vis + name).float()
        _put(vision, ("merger",) + path, leaf(w.t() if t else w))

    lm = "language_model."
    try:
        g(lm + "embed_tokens.weight")
    except KeyError:
        lm = "model."  # older HF layouts keep the text model under 'model.'
    text: Dict[str, Any] = {
        "tok_embeddings": leaf(g(lm + "embed_tokens.weight").float()),
        "norm": {"weight": leaf(g(lm + "norm.weight").float())}}
    for path, name, t in _TEXT_LAYER:
        zeros = (tc.hidden_size,) if name == "self_attn.o_proj.bias" else None
        _put(text, ("layers",) + path,
             stack(lm + "layers.{i}." + name, tc.num_hidden_layers, t,
                   zeros))
    if not cfg.tie_word_embeddings:
        text["output"] = {"kernel": leaf(g("lm_head.weight").float().t())}
    return {"visual": vision, "language_model": text}


def export_qwen2vl_state(params, cfg: Qwen2VLConfig) -> Dict[str, torch.Tensor]:
    """The HF-named state of ``params`` that ``import_qwen2vl_params``
    reads back leaf for leaf (``model.visual.*``,
    ``model.language_model.*``, ``lm_head.weight`` where untied): the
    inverse of its transposes and stacks, as views of the state."""
    vc, tc = cfg.vision, cfg.text
    vis, lm = params["visual"], params["language_model"]
    out = {"model.visual.patch_embed.proj.weight":
           vis["patch_embed"]["kernel"].t().reshape(
               vc.embed_dim, vc.in_channels, vc.temporal_patch_size,
               vc.patch_size, vc.patch_size)}
    for path, name, t in _VISION_BLOCK:
        stacked = _get(vis["blocks"], path)
        for i in range(vc.depth):
            w = stacked[i]
            out[f"model.visual.blocks.{i}.{name}"] = w.t() if t else w
    for path, name, t in _MERGER:
        w = _get(vis["merger"], path)
        out[f"model.visual.{name}"] = w.t() if t else w
    out["model.language_model.embed_tokens.weight"] = lm["tok_embeddings"]
    out["model.language_model.norm.weight"] = lm["norm"]["weight"]
    for path, name, t in _TEXT_LAYER:
        stacked = _get(lm["layers"], path)
        for i in range(tc.num_hidden_layers):
            w = stacked[i]
            out[f"model.language_model.layers.{i}.{name}"] = w.t() if t else w
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = lm["output"]["kernel"].t()
    return out


# ------------------------------------------------------------ vision tower

def vision_rot_pos_emb(grid: Tuple[int, int, int], cfg: Qwen2VLVisionConfig
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin), each (t h w, head_dim) fp32, of the 2D vision RoPE in the
    processor's merged patch order (t, h/m, w/m, m, m)
    (``qwen2vl.py:317-343``, ``rot_pos_emb`` of the reference)."""
    t, h, w = grid
    m = cfg.spatial_merge_size
    hpos = np.arange(h)[:, None].repeat(w, 1)
    wpos = np.arange(w)[None, :].repeat(h, 0)

    def merged(x):
        return (x.reshape(h // m, m, w // m, m)
                .transpose(0, 2, 1, 3).reshape(-1))

    hpos, wpos = merged(hpos), merged(wpos)  # (h w,)
    dim = cfg.head_dim // 2  # rope acts on half the head dim
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64)
                                  / dim))
    freqs = np.concatenate(
        [hpos[:, None] * inv_freq[None], wpos[:, None] * inv_freq[None]],
        axis=-1)  # (h w, dim)
    emb = np.concatenate([freqs, freqs], axis=-1)  # (h w, head_dim)
    emb = np.tile(emb, (t, 1))
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _vision_block(cfg: Qwen2VLVisionConfig, p, x: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor, impl: str,
                  mesh=None):
    """One ViT block on x (grid_t, S, E) (``qwen2vl.py:350-379``): attention
    batched per temporal slab in place of the reference's cu_seqlens
    varlen path, rope in fp32 as the reference upcasts.  ``mesh`` with a
    model axis above 1: ``p`` is the held model ranks' block states, a
    split pair running on each rank's heads or columns."""
    ps = held(p)
    p = ps[0]
    T, S, E = x.shape
    D = cfg.head_dim
    tp = model_axis(mesh)

    def attn_body(pj, h, split):
        qkv = dot(h, pj["attn"]["qkv"]["kernel"], impl) \
            + pj["attn"]["qkv"]["bias"]
        H = qkv.shape[-1] // (3 * D)
        qkv = qkv.reshape(T, S, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        qf, kf = q.float(), k.float()
        q = (qf * c + rotate_half(qf) * s).to(x.dtype)
        k = (kf * c + rotate_half(kf) * s).to(x.dtype)
        # A pre-LN block and a norm-preserving rotary keep q and k bounded:
        # the Cauchy-Schwarz shift of K1 (models/vit.py) holds.
        attn = multi_head_attention(q, k, v, causal=False, impl=impl,
                                    norm_bound=True)
        return row_dot(attn.reshape(T, S, H * D), pj["attn"]["proj"]["kernel"],
                       split, impl)

    def mlp_body(pj, h, split):
        h = _quick_gelu(dot(h, pj["mlp"]["fc1"]["kernel"], impl)
                        + pj["mlp"]["fc1"]["bias"])
        return row_dot(h, pj["mlp"]["fc2"]["kernel"], split, impl)

    h = layer_norm(x, p["norm1"]["weight"], p["norm1"]["bias"],
                   eps=cfg.layer_norm_eps)
    split = tp is not None and p["attn"]["qkv"]["kernel"].shape[-1] != 3 * E
    x = x + (pair_forward(tp, ps, h, split, attn_body)
             + p["attn"]["proj"]["bias"])
    h = layer_norm(x, p["norm2"]["weight"], p["norm2"]["bias"],
                   eps=cfg.layer_norm_eps)
    split = (tp is not None and p["mlp"]["fc1"]["kernel"].shape[-1]
             != E * cfg.mlp_ratio)
    return x + (pair_forward(tp, ps, h, split, mlp_body)
                + p["mlp"]["fc2"]["bias"])


def vision_dtype(params) -> torch.dtype:
    """The vision tower's activation dtype: its weights' (norms are never
    quantized).  The JAX judge feeds fp32 patches whatever the weights'
    dtype, so its tower runs fp32 activations on bf16 weights; the port
    runs the weights' dtype, bf16 on the card, which K1 takes."""
    return first_tensor(held(params)[0]["visual"]["blocks"]["norm1"]).dtype


def vision_forward(params, cfg: Qwen2VLVisionConfig, patches: torch.Tensor,
                   grid: Tuple[int, int, int],
                   impl: str = "auto", mesh=None) -> torch.Tensor:
    """Patches (t h w, patch_dim) in the processor's layout -> merged visual
    embeds (t h w / m^2, LLM hidden) (``qwen2vl.py:382-414``).  The
    activations take ``patches``' dtype; on the card, K1 at D = 80 wants
    bf16.  ``mesh``: ``params`` is the held model ranks' tower states and
    each block runs split (``_vision_block``); the merger is whole."""
    p0 = held(params)[0]
    t, h, w = grid
    x = dot(patches, p0["patch_embed"]["kernel"], impl)
    x = x.reshape(t, h * w, cfg.embed_dim)
    cos, sin = (torch.from_numpy(a).to(x.device)
                for a in vision_rot_pos_emb((1, h, w), cfg))  # every slab
    blocks = [t_["blocks"] for t_ in held_layers(params, mesh)]
    for i in range(cfg.depth):
        x = _vision_block(cfg, [map_state(lambda a: a[i], b) for b in blocks],
                          x, cos, sin, impl, mesh)
    x = x.reshape(t * h * w, cfg.embed_dim)
    mg = p0["merger"]
    x = layer_norm(x, mg["ln_q"]["weight"], mg["ln_q"]["bias"], eps=1e-6)
    x = x.reshape(-1, cfg.merge_dim)  # merged order: 4 consecutive patches
    x = gelu(dot(x, mg["mlp0"]["kernel"], impl) + mg["mlp0"]["bias"])
    return dot(x, mg["mlp2"]["kernel"], impl) + mg["mlp2"]["bias"]


# ----------------------------------------------------------------- M-RoPE

def get_rope_index(
    input_ids: np.ndarray,  # (B, T)
    video_grid_thw: Optional[Sequence[Tuple[int, int, int]]],
    cfg: Qwen2VLConfig,
    attention_mask: Optional[np.ndarray] = None,
    image_grid_thw: Optional[Sequence[Tuple[int, int, int]]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """3-channel (t, h, w) M-RoPE position ids, host numpy: a copy of
    ``qwen2vl.py:419-486`` (``Qwen2VLModel.get_rope_index``).  Text tokens
    advance all three channels together; each vision span takes its (t, h,
    w) grid coordinates offset by the running position.  Returns
    (position_ids (3, B, T), deltas (B, 1))."""
    input_ids = np.asarray(input_ids)
    B, T = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    m = cfg.vision.spatial_merge_size
    pos = np.ones((3, B, T), np.int64)
    deltas = np.zeros((B, 1), np.int64)
    img_i = vid_i = 0
    images = list(image_grid_thw or [])
    videos = list(video_grid_thw or [])
    for b in range(B):
        ids = input_ids[b][attention_mask[b] == 1]
        toks = ids.tolist()
        starts = np.nonzero(ids == cfg.vision_start_token_id)[0]
        vis_kinds = ids[starts + 1] if len(starts) else np.asarray([])
        n_img = int((vis_kinds == cfg.image_token_id).sum())
        n_vid = int((vis_kinds == cfg.video_token_id).sum())
        chunks: List[np.ndarray] = []
        st = 0
        rem_i, rem_v = n_img, n_vid
        for _ in range(n_img + n_vid):
            ed_i = toks.index(cfg.image_token_id, st) \
                if (rem_i and cfg.image_token_id in toks[st:]) else len(toks) + 1
            ed_v = toks.index(cfg.video_token_id, st) \
                if (rem_v and cfg.video_token_id in toks[st:]) else len(toks) + 1
            if ed_i < ed_v:
                t, h, w = images[img_i]
                img_i += 1
                rem_i -= 1
                ed = ed_i
            else:
                t, h, w = videos[vid_i]
                vid_i += 1
                rem_v -= 1
                ed = ed_v
            gt, gh, gw = int(t), int(h) // m, int(w) // m
            text_len = ed - st
            st_idx = chunks[-1].max() + 1 if chunks else 0
            chunks.append(np.broadcast_to(
                np.arange(text_len), (3, text_len)) + st_idx)
            ti = np.repeat(np.arange(gt), gh * gw)
            hi = np.tile(np.repeat(np.arange(gh), gw), gt)
            wi = np.tile(np.arange(gw), gt * gh)
            chunks.append(np.stack([ti, hi, wi]) + text_len + st_idx)
            st = ed + gt * gh * gw
        if st < len(toks):
            st_idx = chunks[-1].max() + 1 if chunks else 0
            n = len(toks) - st
            chunks.append(np.broadcast_to(np.arange(n), (3, n)) + st_idx)
        row = np.concatenate(chunks, axis=1) if chunks else np.zeros((3, 0),
                                                                     np.int64)
        pos[:, b, attention_mask[b] == 1] = row
        deltas[b, 0] = (row.max() + 1 - T) if row.size else -T
    return pos, deltas


def mrope_cos_sin(position_ids, cfg: Qwen2VLConfig, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (cos, sin), each (B, T, head_dim) fp32, from 3-channel ids
    (3, B, T), sectioned by ``mrope_section``
    (``apply_multimodal_rotary_pos_emb``, ``qwen2vl.py:489-509``)."""
    pos = torch.as_tensor(position_ids, device=device)
    D = cfg.text.head_dim
    inv_freq = 1.0 / (cfg.text.rope_theta ** (
        torch.arange(0, D, 2, dtype=torch.float32, device=pos.device) / D))
    freqs = pos[..., None].float() * inv_freq  # (3, B, T, D / 2)
    emb = torch.cat([freqs, freqs], dim=-1)  # (3, B, T, D)
    cos3, sin3 = emb.cos(), emb.sin()
    out_c, out_s, off = [], [], 0
    for i, size in enumerate(list(cfg.mrope_section) * 2):
        out_c.append(cos3[i % 3, :, :, off:off + size])
        out_s.append(sin3[i % 3, :, :, off:off + size])
        off += size
    return torch.cat(out_c, -1), torch.cat(out_s, -1)


# ------------------------------------------------------------ full forward

def _embed(params, cfg: Qwen2VLConfig, input_ids: torch.Tensor,
           vision_embeds: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """Token embeds with the flat vision embeds (N, C) scattered, in row
    order, at both ``<|image_pad|>`` and ``<|video_pad|>`` slots."""
    embeds = dec.embed_tokens(sub(params, "language_model"),
                              input_ids.long(), mesh, cfg.text.vocab_size)
    if vision_embeds is None:
        return embeds
    marker = ((input_ids == cfg.image_token_id)
              | (input_ids == cfg.video_token_id))
    ids = torch.where(marker, cfg.video_token_id, 0)
    return scatter_image_embeds(embeds, ids, vision_embeds[None],
                                cfg.video_token_id)


def qwen2vl_forward(
    params, cfg: Qwen2VLConfig,
    input_ids: torch.Tensor,  # (B, T)
    attention_mask: Optional[torch.Tensor],
    position_ids,  # (3, B, T) from get_rope_index
    pixel_patches: Optional[torch.Tensor] = None,  # (N, patch_dim)
    grid: Optional[Tuple[int, int, int]] = None,
    impl: str = "auto",
    vision_embeds: Optional[torch.Tensor] = None,  # (N_tok, C)
    mesh=None,
) -> torch.Tensor:
    """The multimodal forward -> final hidden states (B, T, C)
    (``qwen2vl.py:514-549``); ``vision_embeds`` skips the vision tower."""
    if vision_embeds is None and pixel_patches is not None:
        vision_embeds = vision_forward(sub(params, "visual"), cfg.vision,
                                       pixel_patches, grid, impl=impl,
                                       mesh=mesh)
    embeds = _embed(params, cfg, input_ids, vision_embeds, mesh)
    cos, sin = mrope_cos_sin(position_ids, cfg, device=embeds.device)
    return dec.decoder_forward(
        sub(params, "language_model"), cfg.text, embeds,
        attention_mask=attention_mask, impl=impl, remat=False,
        rope_override=(cos, sin), mesh=mesh)


def lm_logits(params, cfg: Qwen2VLConfig, hidden: torch.Tensor,
              impl: str = "auto", mesh=None) -> torch.Tensor:
    """fp32 logits by the LM head tied to ``tok_embeddings`` (2B) or by its
    own ``output`` kernel (7B) (``qwen2vl.py:552-556``); under ``mesh``
    each rank's vocabulary columns (tied: the embedding's rows), gathered
    (``decoder.vocab_logits``)."""
    lm = sub(params, "language_model")
    if cfg.tie_word_embeddings:
        return dec.vocab_logits(lm, lambda p: p["tok_embeddings"].t(),
                                hidden, impl, mesh, cfg.text.vocab_size)
    return dec.lm_logits(lm, hidden, impl, mesh, cfg.text.vocab_size)


# ------------------------------------------------------------- generation

def _gather_rows(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """(B, max_len, D) tables read at (B, S) slots -> (B, S, D)."""
    idx = slots.long()[:, :, None].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx)


def _step_fn(cfg: Qwen2VLConfig, max_len: int, n_start: torch.Tensor,
             cos_all: torch.Tensor, sin_all: torch.Tensor, impl: str,
             mesh=None):
    """The cached decode step of a row whose generated token i sits at slot
    ``n_start + i``, rotated by that slot's M-RoPE row."""
    def step(params, tok, i, cache):
        lm = sub(params, "language_model")
        e = dec.embed_tokens(lm, tok.long()[:, None], mesh,
                             cfg.text.vocab_size)
        s, m = step_slot_mask(max_len, n_start, i)
        h, cache = decoder_forward_cached(
            lm, cfg.text, e, cache, s, m, impl=impl,
            rope_override=(_gather_rows(cos_all, s),
                           _gather_rows(sin_all, s)), mesh=mesh)
        return lm_logits(params, cfg, h, impl, mesh)[:, 0], cache
    return step


def _tables(pos0: np.ndarray, cfg: Qwen2VLConfig, device):
    return mrope_cos_sin(torch.from_numpy(pos0), cfg, device=device)


def _prefill_rows(params, cfg: Qwen2VLConfig, embeds, n_real, Tb, max_len,
                  cos_all, sin_all, max_new_tokens, eos, impl, kv_quant,
                  teacher_tokens, mesh):
    """Right-padded prompt rows' ``embeds`` into a fresh cache, then the
    greedy loop: ``decode_batch``'s output."""
    lm = sub(params, "language_model")
    cache = init_kv_cache(cfg.text, embeds.shape[0], max_len,
                          device=embeds.device, dtype=embeds.dtype,
                          quant=kv_quant, mesh=mesh, lm=lm)
    slots, mask = prefill_slot_mask(Tb, max_len, n_real)
    hidden, cache = decoder_forward_cached(
        lm, cfg.text, embeds, cache, slots, mask, impl=impl,
        rope_override=(cos_all[:, :Tb], sin_all[:, :Tb]), mesh=mesh)
    logits0 = lm_logits(params, cfg, last_real_token(hidden, n_real), impl,
                        mesh)[:, 0]
    step = _step_fn(cfg, max_len, n_real, cos_all, sin_all, impl, mesh)
    return decode_batch(step, params, logits0, cache, max_new_tokens,
                        int(eos), teacher_tokens)


@torch.no_grad()
def greedy_generate_batch(
    params, cfg: Qwen2VLConfig,
    items,  # per row (input_ids (1, T), position_ids (3, 1, T), patches, grid)
    max_new_tokens: int = 16,
    eos_token_id: int = 151645,  # <|im_end|>
    impl: str = "auto",  # the vision tower's and the cached prefill's
    vision_embeds=None,  # per row, precomputed vision embeds
    kv_quant: bool = False,  # int8 KV cache
    teacher_tokens: Optional[torch.Tensor] = None,  # (B, n)
    mesh=None,
):
    """Batched greedy decode with a static KV cache
    (``qwen2vl.py:714-771``): each row's vision tower runs once (frames of
    different videos never attend to each other), the right-padded prompt
    batch prefills once, and the rows decode together.  M-RoPE tables are
    built per row for every slot (generated token i continues at the
    prompt's max position + 1 + i on all three channels) and read per step.
    Returns the rows' tokens up to and including each one's EOS, or with
    ``teacher_tokens`` the (B, n, V) fp32 logits of each step.  ``mesh``:
    the held model ranks' ``params`` split over its model axis, the rows
    over its data axis."""
    B = len(items)
    has_vision = items[0][2] is not None or vision_embeds is not None
    ids, n_real, Tb = pad_prompt_batch([it[0] for it in items],
                                       cfg.text.pad_token_id)
    max_len = Tb + max_new_tokens
    pos0 = np.zeros((3, B, max_len), np.int64)
    for b, (_, position_ids, _, _) in enumerate(items):
        nr = int(n_real[b])
        pos0[:, b, :nr] = position_ids[:, 0]
        # Pad and decode slots continue on all three channels (the pads
        # never enter the cache; decode slot n_real + i reads entry
        # n_real + i).
        pos0[:, b, nr:] = position_ids.max() + 1 + np.arange(max_len - nr)
    dev = held(params)[0]["language_model"]["tok_embeddings"].device
    cos_all, sin_all = _tables(pos0, cfg, dev)
    vis = None
    if has_vision:
        if vision_embeds is None:
            dtype = vision_dtype(params)
            vis = torch.cat([
                vision_forward(sub(params, "visual"), cfg.vision,
                               torch.as_tensor(patches).to(dev, dtype), grid,
                               impl=impl, mesh=mesh)
                for _, _, patches, grid in items])
        else:
            vis = torch.cat([v.reshape(-1, v.shape[-1])
                             for v in vision_embeds])
    n_t = torch.from_numpy(n_real).to(dev)
    embeds = _embed(params, cfg, torch.from_numpy(ids).to(dev), vis, mesh)
    out = over_data(mesh, B, lambda rows: _prefill_rows(
        params, cfg, embeds[rows], n_t[rows], Tb, max_len, cos_all[rows],
        sin_all[rows], max_new_tokens, eos_token_id, impl, kv_quant,
        None if teacher_tokens is None else teacher_tokens[rows], mesh))
    if teacher_tokens is not None:
        return out
    toks, n = (t.tolist() for t in out)
    return [[int(t) for t in toks[b][: n[b]]] for b in range(B)]


def greedy_generate(params, cfg: Qwen2VLConfig, input_ids, position_ids,
                    pixel_patches=None, grid=None, max_new_tokens: int = 16,
                    eos_token_id: int = 151645, impl: str = "auto",
                    kv_quant: bool = False, mesh=None) -> List[int]:
    """A single prompt's greedy decode (``greedy_generate_batch``)."""
    return greedy_generate_batch(
        params, cfg, [(input_ids, position_ids, pixel_patches, grid)],
        max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
        impl=impl, kv_quant=kv_quant, mesh=mesh)[0]


class PrefixCache(NamedTuple):
    """A prompt prefix prefilled once (``qwen2vl.py:621-651`` and the
    judge's ``_prefix_state``).  Functions that take one never change
    it."""

    cache: KVCache  # slots [0, P) filled (RankCaches under a model axis)
    mask: torch.Tensor  # (B, max_len) int32
    P: int
    max_len: int
    cos_all: torch.Tensor  # (B, max_len, D): every slot's M-RoPE rows
    sin_all: torch.Tensor


@torch.no_grad()
def prefill_prefix(params, cfg: Qwen2VLConfig, prefix: Sequence[int],
                   grid: Tuple[int, int, int], vision_embeds: torch.Tensor,
                   max_len: int, bucket: int, impl: str = "auto",
                   kv_quant: bool = False, mesh=None) -> PrefixCache:
    """The vision block and the headers (``build_video_prompt_prefix_suffix``'s
    prefix) into an empty cache, the prefix right-padded to its ``bucket``
    (no logits: a prefix never ends a prompt).  The M-RoPE tables cover
    every slot: the prefix's from ``get_rope_index``, the slots after it
    continuing at its max position + 1, as a text-only suffix does."""
    P = len(prefix)
    lm = sub(params, "language_model")
    dev = held(lm)[0]["tok_embeddings"].device
    ids = np.full((1, bucket), cfg.text.pad_token_id, np.int64)
    ids[0, :P] = prefix
    pos_p, _ = get_rope_index(ids[:, :P], [grid], cfg)  # (3, 1, P)
    pos_all = np.zeros((3, 1, max_len), np.int64)
    pos_all[:, 0, :P] = pos_p[:, 0]
    pos_all[:, 0, P:] = pos_p.max() + 1 + np.arange(max_len - P)
    cos_all, sin_all = _tables(pos_all, cfg, dev)
    embeds = _embed(params, cfg, torch.from_numpy(ids).to(dev),
                    vision_embeds.reshape(-1, vision_embeds.shape[-1]), mesh)
    cache = init_kv_cache(cfg.text, 1, max_len, device=dev,
                          dtype=embeds.dtype, quant=kv_quant, mesh=mesh,
                          lm=lm)
    slots, mask = prefill_slot_mask(bucket, max_len, P, device=dev)
    decoder_forward_cached(lm, cfg.text, embeds, cache, slots, mask,
                           impl=impl,
                           rope_override=(cos_all[:, :bucket],
                                          sin_all[:, :bucket]), mesh=mesh)
    return PrefixCache(cache, mask, P, max_len, cos_all, sin_all)


def _continue_rows(params, cfg: Qwen2VLConfig, state: PrefixCache,
                   suffix: Sequence[int], bucket: int, max_new_tokens: int,
                   eos_token_id: int, impl: str, teacher_tokens, mesh):
    cache, pmask, P, max_len, cos_all, sin_all = state
    cache = cache.clone()
    lm = sub(params, "language_model")
    dev = pmask.device
    B = pmask.shape[0]
    sids = torch.full((B, bucket), cfg.text.pad_token_id, dtype=torch.long,
                      device=dev)
    sids[:, : len(suffix)] = torch.tensor(list(suffix), device=dev)
    n_prefix = torch.full((B,), P, dtype=torch.int32, device=dev)
    s_real = torch.full((B,), len(suffix), dtype=torch.int32, device=dev)
    slots = n_prefix.long()[:, None] + torch.arange(bucket, device=dev)[None]
    span = torch.arange(max_len, device=dev)[None]
    valid = (span >= P) & (span < P + len(suffix))
    mask = torch.maximum(pmask, valid.to(pmask.dtype))
    hidden, cache = decoder_forward_cached(
        lm, cfg.text, dec.embed_tokens(lm, sids, mesh, cfg.text.vocab_size),
        cache, slots, mask, impl=impl, q_offset=n_prefix,
        rope_override=(_gather_rows(cos_all, slots),
                       _gather_rows(sin_all, slots)), mesh=mesh)
    logits0 = lm_logits(params, cfg, last_real_token(hidden, s_real),
                        impl, mesh)[:, 0]
    step = _step_fn(cfg, max_len, n_prefix + s_real, cos_all, sin_all, impl,
                    mesh)
    return decode_batch(step, params, logits0, cache, max_new_tokens,
                        int(eos_token_id), teacher_tokens)


@torch.no_grad()
def continue_prefix(params, cfg: Qwen2VLConfig, state: PrefixCache,
                    suffix: Sequence[int], bucket: int, max_new_tokens: int,
                    eos_token_id: int, impl: str = "auto",
                    teacher_tokens: Optional[torch.Tensor] = None,
                    mesh=None):
    """A question suffix on a copy of a cached prefix, then greedy decode
    (``qwen2vl.py:655-711``).  The suffix, right-padded to ``bucket``,
    takes slots [P, P + len(suffix)), contiguous with the prefix, so its
    M-RoPE positions and causality are the full prompt's; its attention
    runs over the whole cache with ``q_offset`` = P, the same kernel as a
    full-prompt prefill.  Returns (toks (B, max_new_tokens) int32, n (B,)),
    or with ``teacher_tokens`` the (B, n, V) fp32 logits of each step;
    ``mesh`` as in ``greedy_generate_batch``."""
    return over_data(mesh, state.mask.shape[0], lambda rows: _continue_rows(
        params, cfg, slice_state(state, rows), suffix, bucket,
        max_new_tokens, eos_token_id, impl,
        None if teacher_tokens is None else teacher_tokens[rows], mesh))


# ------------------------------------------------------------ preprocessing

def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """Qwen2-VL's resize rule: sides divisible by ``factor``, the pixel
    count in [min_pixels, max_pixels], the aspect ratio kept
    (``qwen2vl.py:802-822``, ``image_processing_qwen2_vl.py``)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_video_frames(
    frames: Sequence[np.ndarray],  # uint8 RGB (H, W, 3)
    cfg: Qwen2VLVisionConfig,
    max_pixels: int = 360 * 420,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Frames -> (patches (t h w, patch_dim) fp32, grid (t, h, w))
    (``qwen2vl.py:825-856``, ``Qwen2VLImageProcessor._preprocess``): smart
    resize (PIL bicubic), CLIP normalisation, temporal groups of
    ``temporal_patch_size`` (an odd count repeats the last frame), and the
    merged patch order (t, h/m, w/m, m, m) x (c, tp, p, p)."""
    from PIL import Image

    P, TP, m = cfg.patch_size, cfg.temporal_patch_size, cfg.spatial_merge_size
    H0, W0 = frames[0].shape[:2]
    H, W = smart_resize(H0, W0, factor=P * m, max_pixels=max_pixels)
    mean = np.asarray(CLIP_MEAN, np.float32).reshape(3, 1, 1)
    std = np.asarray(CLIP_STD, np.float32).reshape(3, 1, 1)
    proc = []
    for f in frames:
        img = Image.fromarray(f).convert("RGB").resize(
            (W, H), Image.Resampling.BICUBIC)
        x = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
        proc.append((x - mean) / std)
    arr = np.stack(proc)  # (F, 3, H, W)
    if arr.shape[0] % TP:
        arr = np.concatenate(
            [arr, arr[-1:].repeat(TP - arr.shape[0] % TP, 0)], axis=0)
    gt, gh, gw = arr.shape[0] // TP, H // P, W // P
    patches = arr.reshape(gt, TP, 3, gh // m, m, P, gw // m, m, P)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return patches.reshape(gt * gh * gw, cfg.patch_dim), (gt, gh, gw)


def build_video_prompt_prefix_suffix(
    tokenizer, cfg: Qwen2VLConfig, grid: Tuple[int, int, int], prompt: str,
) -> Tuple[list, list]:
    """The ChatML video prompt split at the question
    (``qwen2vl.py:859-891``).  The prefix (system, the user header and the
    whole vision block) is the same for every question about a video of
    this grid, and the pieces are encoded apart before they are joined, so
    the split is exact by construction."""
    from ..data.prompts import encode_text

    n_video = (grid[0] * grid[1] * grid[2]) // cfg.vision.spatial_merge_size**2

    def enc(s):
        return encode_text(tokenizer, s)

    nl = enc("\n")
    prefix = (
        [cfg.im_start_token_id] + enc("system") + nl
        + enc("You are a helpful assistant.") + [cfg.im_end_token_id] + nl
        + [cfg.im_start_token_id] + enc("user") + nl
        + [cfg.vision_start_token_id]
        + [cfg.video_token_id] * n_video
        + [cfg.vision_end_token_id]
    )
    suffix = (
        enc(prompt) + [cfg.im_end_token_id] + nl
        + [cfg.im_start_token_id] + enc("assistant") + nl
    )
    return prefix, suffix


def build_video_prompt_ids(tokenizer, cfg: Qwen2VLConfig,
                           grid: Tuple[int, int, int],
                           prompt: str) -> np.ndarray:
    """The ChatML ids (1, T) int32 of one video and a question
    (``qwen2vl.py:894-902``): the prefix and the suffix joined."""
    prefix, suffix = build_video_prompt_prefix_suffix(tokenizer, cfg, grid,
                                                      prompt)
    return np.asarray([prefix + suffix], np.int32)
