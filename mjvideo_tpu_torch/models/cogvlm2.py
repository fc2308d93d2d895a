"""CogVLM2-Video: the fourth local judge family.

Counterpart of ``mjvideo_tpu/models/cogvlm2.py`` (the reference runs
CogVLM2-Video through ms-swift, ``eval_overall_cogvlm2.py:119-129``,
``ModelType.cogvlm2_video_13b_chat``): the EVA2-CLIP-E tower, whose blocks
apply each sublayer's LayerNorm to the sublayer's *output* before the
residual add (post-norm); a conv-2x2 downsample and a GLU adapter with
learned ``boi``/``eoi`` embeddings a frame; and a Llama-3-8B text model
whose every layer carries two experts, separate QKV, dense and MLP weights
for vision and language positions, with every interior vision token of a
run at one shared RoPE position (``build_position_ids``).  What differs
from the JAX package:

* The tower's attention is K3 not causal at its head dim of 112 (16 heads
  over each frame's 257 tokens): exact, without the Cauchy-Schwarz bound,
  as JAX calls it (``cogvlm2.py:366-367``: no ``norm_bound``).  Post-norm
  blocks feed the qkv product the un-normalised residual stream, so the
  bound that K1 uses for the pre-norm towers has no guarantee here.  The
  decoder's attention is K3 at Llama-3's 32/8 heads of 128, causal, for
  the uncached forward, every prefill into an empty cache and, with
  ``q_offset`` = the prefix length, every suffix continuation over the
  whole cache; a decode step takes the grouped einsum over the cache.
* Both experts run and a per-position mask selects, as in JAX, where a
  call holds vision tokens.  Where the host knows every token of a call is
  language (every decode step, every question suffix, a text-only prompt)
  only the language expert runs: the same values as the select, and half
  the weight bytes a decode step reads.
* The functions run eagerly: ``_jit_vision``, ``_generate_fn``,
  ``_prefix_fn`` and ``_suffix_fn`` become ``get_vision_embedding``,
  ``greedy_generate_batch``, ``prefill_prefix`` and ``continue_prefix`` on
  ``models/generate.py``'s decode loop and slot masks.  The rotary position
  of a cached token (``rope_pos``, the shared-vision scheme) is decoupled
  from its cache slot, which governs writes and causality; the per-row
  position table runs on from ``pos.max() + 1`` past the prompt.
* ``dtype`` names the decoder's activation dtype and the dtype of every
  product's and K3's inputs in the tower and the adapter (the weights' by
  default).  The tower and the adapter keep fp32 activations whatever it
  is, as the JAX judge's fp32 pixels keep them there (its ``dot`` casts
  each product back to fp32 on bf16 weights): the residual stream, the
  LayerNorms, GELU and the biases are fp32.  On a bf16 state each product
  and K3 take bf16 inputs with fp32 accumulation, as JAX's products at
  DEFAULT precision do on the TPU; JAX on the CPU multiplies the fp32
  inputs as they are, which the port does with fp32 ``dtype``.  That on
  a bf16 state promotes each product one weight at a time
  (``ops.matmul.dot_f32``): the fp32 reference of a state too large to
  copy.
* ``greedy_generate_batch`` and ``continue_prefix`` can feed
  ``teacher_tokens`` and return each step's fp32 logits.
* ``mesh=`` (a ``parallel.mesh.Mesh``; JAX takes sharded ``params``): the
  held model ranks' states (``shard_params``) run the EVA tower on each
  rank's heads (qkv by heads, ``dense`` and ``fc2`` row-parallel), both
  experts' MLPs and ``dense`` rows split, and the LM head's vocabulary
  columns.  The packed expert qkv stays whole (JAX's rule): every rank
  computes it and slices its own query heads with their kv group, which
  K3 and its cache take, so each rank's attention output is its rows of
  ``dense``.  The prompt rows split over the data axis
  (``generate.over_data``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import LLMConfig
from ..ops.attention import multi_head_attention
from ..ops.matmul import dot, dot_f32
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import apply_rope, rope_tables
from ..parallel.mesh import (
    held,
    held_layers,
    model_axis,
    pair_forward,
    sub,
)
from ..utils.bridge import map_state
from . import decoder as dec
from .generate import (
    KVCache,
    attend_cache,
    decode_batch,
    init_kv_cache,
    last_real_token,
    layer_caches,
    over_data,
    pad_prompt_batch,
    prefill_slot_mask,
    slice_state,
    step_slot_mask,
)
from .internvl import scatter_image_embeds
from .vit import patch_embed

LANGUAGE_TOKEN_TYPE = 0
VISION_TOKEN_TYPE = 1


@dataclass(frozen=True)
class CogVLM2VisionConfig:
    """The EVA2-CLIP-E tower (cogvlm2-video-llama3-chat's
    ``vision_config``)."""

    hidden_size: int = 1792
    intermediate_size: int = 15360
    num_hidden_layers: int = 63
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    layer_norm_eps: float = 1e-6
    scaling_factor: float = 8.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_frame(self) -> int:
        """(grid / 2)^2 downsampled tokens and boi/eoi: 66 at 224 px."""
        return (self.grid // 2) ** 2 + 2


@dataclass(frozen=True)
class CogVLM2Config:
    vision: CogVLM2VisionConfig = field(default_factory=CogVLM2VisionConfig)
    # Llama-3-8B (cogvlm2-video-llama3-chat's config.json);
    # num_multi_query_heads = 8 is the GQA kv head count.
    text: LLMConfig = field(default_factory=lambda: LLMConfig(
        architecture="llama", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        rope_theta=500000.0, rms_norm_eps=1e-5, pad_token_id=128002,
        max_position_embeddings=8192,
    ))
    bos_token_id: int = 128000
    eos_token_id: int = 128001
    pad_token_id: int = 128002


def cogvlm2_config_from_hf(d: Dict[str, Any]) -> CogVLM2Config:
    """A ``CogVLM2Config`` from an HF cogvlm2 ``config.json`` dict
    (``cogvlm2.py:102-132``)."""
    v = d.get("vision_config", {})
    pad = d.get("pad_token_id", 128002) or 128002
    return CogVLM2Config(
        vision=CogVLM2VisionConfig(
            hidden_size=v.get("hidden_size", 1792),
            intermediate_size=v.get("intermediate_size", 15360),
            num_hidden_layers=v.get("num_hidden_layers", 63),
            num_heads=v.get("num_heads", 16),
            patch_size=v.get("patch_size", 14),
            image_size=v.get("image_size", 224),
            layer_norm_eps=v.get("layer_norm_eps", 1e-6),
            scaling_factor=v.get("scaling_factor", 8.0),
        ),
        text=LLMConfig(
            architecture="llama",
            vocab_size=d.get("vocab_size", 128256),
            hidden_size=d.get("hidden_size", 4096),
            intermediate_size=d.get("intermediate_size", 14336),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=d.get("num_attention_heads", 32),
            num_key_value_heads=d.get("num_multi_query_heads", 8),
            rope_theta=d.get("rope_theta", 500000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            pad_token_id=pad,
            max_position_embeddings=d.get("max_position_embeddings", 8192),
        ),
        bos_token_id=d.get("bos_token_id", 128000),
        eos_token_id=d.get("eos_token_id", 128001),
        pad_token_id=pad,
    )


def cogvlm2_config_to_hf(cfg: CogVLM2Config) -> Dict[str, Any]:
    """The HF ``config.json`` dict that ``cogvlm2_config_from_hf`` reads
    back as ``cfg`` (the JAX package has no writer; the tests and
    ``chip_smoke.py`` write checkpoint directories with it)."""
    v, t = cfg.vision, cfg.text
    return {
        "architectures": ["CogVLMVideoForCausalLM"], "model_type": "cogvlm2",
        "vision_config": {
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_hidden_layers,
            "num_heads": v.num_heads, "patch_size": v.patch_size,
            "image_size": v.image_size, "layer_norm_eps": v.layer_norm_eps,
            "scaling_factor": v.scaling_factor},
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_multi_query_heads": t.num_key_value_heads,
        "rope_theta": t.rope_theta, "rms_norm_eps": t.rms_norm_eps,
        "max_position_embeddings": t.max_position_embeddings,
        "bos_token_id": cfg.bos_token_id, "eos_token_id": cfg.eos_token_id,
        "pad_token_id": cfg.pad_token_id,
    }


# -------------------------------------------------------------------- params

def init_cogvlm2_params(cfg: CogVLM2Config, *, generator: torch.Generator,
                        device, dtype: torch.dtype = torch.float32):
    """Random state in ``import_cogvlm2_params``'s tree
    (``cogvlm2.py:137-213``): dense kernels N(0, 0.02), norms 1, biases 0,
    the text model with its untied LM head.  A stacked kernel is drawn a
    layer at a time into its ``dtype`` tensor, so no fp32 copy of a whole
    stack is made (a (32, 4096, 14336) MLP stack would be 7.5 GB)."""
    vc, tc = cfg.vision, cfg.text
    C, I, L = vc.hidden_size, vc.intermediate_size, vc.num_hidden_layers
    D, TI, Lt = tc.hidden_size, tc.intermediate_size, tc.num_hidden_layers
    Hq, Hkv, hd = (tc.num_attention_heads, tc.num_key_value_heads,
                   tc.head_dim)
    qkv_size = Hq * hd + 2 * Hkv * hd
    P = vc.patch_size

    def dense(*shape):
        if len(shape) < 3:
            return (torch.randn(shape, generator=generator, device=device)
                    * 0.02).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=generator,
                                 device=device) * 0.02
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ln(*shape):
        return {"weight": ones(*shape), "bias": zeros(*shape)}

    vision = {
        "patch_embedding": {"kernel": dense(P * P * 3, C), "bias": zeros(C)},
        "cls_embedding": dense(C),
        "position_embedding": dense(vc.grid ** 2 + 1, C),
        "layers": {
            "ln1": ln(L, C), "ln2": ln(L, C),
            "qkv": {"kernel": dense(L, C, 3 * C), "bias": zeros(L, 3 * C)},
            "dense": {"kernel": dense(L, C, C), "bias": zeros(L, C)},
            "fc1": {"kernel": dense(L, C, I), "bias": zeros(L, I)},
            "fc2": {"kernel": dense(L, I, C), "bias": zeros(L, C)},
        },
    }
    adapter = {
        "conv": {"kernel": dense(4 * C, C), "bias": zeros(C)},
        "linear_proj": {"kernel": dense(C, D)},
        "norm1": ln(D),
        "gate_proj": {"kernel": dense(D, TI)},
        "dense_h_to_4h": {"kernel": dense(D, TI)},
        "dense_4h_to_h": {"kernel": dense(TI, D)},
        "boi": dense(1, 1, D),
        "eoi": dense(1, 1, D),
    }

    def swiglu():
        return {"w1": {"kernel": dense(Lt, D, TI)},
                "w3": {"kernel": dense(Lt, D, TI)},
                "w2": {"kernel": dense(Lt, TI, D)}}

    text = {
        "tok_embeddings": dense(tc.vocab_size, D),
        "layers": {
            "attention_norm": {"weight": ones(Lt, D)},
            "ffn_norm": {"weight": ones(Lt, D)},
            "attention": {
                # Only the vision expert's QKV carries a bias
                # (modeling_cogvlm.py VisionExpertAttention.__init__).
                "vision_qkv": {"kernel": dense(Lt, D, qkv_size),
                               "bias": zeros(Lt, qkv_size)},
                "language_qkv": {"kernel": dense(Lt, D, qkv_size)},
                "vision_dense": {"kernel": dense(Lt, Hq * hd, D)},
                "language_dense": {"kernel": dense(Lt, Hq * hd, D)},
            },
            "mlp": {"vision": swiglu(), "language": swiglu()},
        },
        "norm": {"weight": ones(D)},
        "output": {"kernel": dense(D, tc.vocab_size)},
    }
    return {"vision": vision, "adapter": adapter, "language_model": text}


def import_cogvlm2_params(state, cfg: CogVLM2Config,
                          dtype: torch.dtype = torch.float32,
                          device="cuda"):
    """An HF CogVLM2 state (THUDM layout; name -> tensor, e.g.
    ``utils.checkpoint.load_safetensors_dir``) -> the port's tree on
    ``device`` (the card unless the caller asks for another) in ``dtype``
    (``cogvlm2.py:216-335``): ``model.vision.*`` (the patch embedding, the
    transformer layers, ``conv``, ``linear_proj``, ``boi``/``eoi``),
    ``model.layers.{i}.*`` with the two experts' projections,
    ``model.norm``, ``model.embed_tokens`` and ``lm_head``; each name is
    looked up as it is, then under ``model.``.  The patch conv (C, 3, P, P)
    becomes the (P P 3, C) kernel of the (ph, pw, channel) flattening, the
    2x2 ``vision.conv`` (C, C, 2, 2) the (kh kw C_in, C) kernel of the
    adapter's patch order."""
    from ..utils.checkpoint import _Importer

    vc, tc = cfg.vision, cfg.text
    L, Lt, P, C = (vc.num_hidden_layers, tc.num_hidden_layers, vc.patch_size,
                   vc.hidden_size)
    im = _Importer(state, "", dtype, device)

    def n(name):
        for p in ("", "model."):
            if p + name in state:
                return p + name
        raise KeyError(name)

    def leaf(name):
        return im.leaf(n(name))

    def kernel(name):
        return im.kernel(n(name))

    def stack(fmt, count, transpose=False):
        return im.stacked([n(fmt.format(i=i)) for i in range(count)],
                          (lambda t: t.T) if transpose else (lambda t: t))

    patch = im.get(n("vision.patch_embedding.proj.weight"))
    vb = "vision.transformer.layers.{i}."

    def linear(hf):
        return {"kernel": stack(vb + hf + ".weight", L, True),
                "bias": stack(vb + hf + ".bias", L)}

    vision = {
        "patch_embedding": {
            "kernel": patch.permute(2, 3, 1, 0).reshape(P * P * 3, -1)
            .to(dtype),
            "bias": leaf("vision.patch_embedding.proj.bias")},
        "cls_embedding": leaf(
            "vision.patch_embedding.cls_embedding").reshape(-1),
        "position_embedding": leaf(
            "vision.patch_embedding.position_embedding.weight"),
        "layers": {
            "ln1": {"weight": stack(vb + "input_layernorm.weight", L),
                    "bias": stack(vb + "input_layernorm.bias", L)},
            "ln2": {"weight": stack(vb + "post_attention_layernorm.weight",
                                    L),
                    "bias": stack(vb + "post_attention_layernorm.bias", L)},
            "qkv": linear("attention.query_key_value"),
            "dense": linear("attention.dense"),
            "fc1": linear("mlp.fc1"),
            "fc2": linear("mlp.fc2"),
        },
    }
    conv = im.get(n("vision.conv.weight"))
    lp = "vision.linear_proj."
    adapter = {
        "conv": {"kernel": conv.permute(2, 3, 1, 0).reshape(4 * C, -1)
                 .to(dtype),
                 "bias": leaf("vision.conv.bias")},
        "linear_proj": {"kernel": kernel(lp + "linear_proj.weight")},
        "norm1": {"weight": leaf(lp + "norm1.weight"),
                  "bias": leaf(lp + "norm1.bias")},
        "gate_proj": {"kernel": kernel(lp + "gate_proj.weight")},
        "dense_h_to_4h": {"kernel": kernel(lp + "dense_h_to_4h.weight")},
        "dense_4h_to_h": {"kernel": kernel(lp + "dense_4h_to_h.weight")},
        "boi": leaf("vision.boi"),
        "eoi": leaf("vision.eoi"),
    }
    lb = "layers.{i}."
    sa = lb + "self_attn."

    def mlp(expert):
        return {ours: {"kernel": stack(f"{lb}mlp.{expert}_mlp.{hf}.weight",
                                       Lt, True)}
                for ours, hf in (("w1", "gate_proj"), ("w3", "up_proj"),
                                 ("w2", "down_proj"))}

    text = {
        "tok_embeddings": leaf("embed_tokens.weight"),
        "layers": {
            "attention_norm": {"weight": stack(lb + "input_layernorm.weight",
                                               Lt)},
            "ffn_norm": {"weight": stack(
                lb + "post_attention_layernorm.weight", Lt)},
            "attention": {
                "vision_qkv": {
                    "kernel": stack(sa + "vision_expert_query_key_value"
                                    ".weight", Lt, True),
                    "bias": stack(sa + "vision_expert_query_key_value.bias",
                                  Lt)},
                "language_qkv": {"kernel": stack(
                    sa + "language_expert_query_key_value.weight", Lt,
                    True)},
                "vision_dense": {"kernel": stack(
                    sa + "vision_expert_dense.weight", Lt, True)},
                "language_dense": {"kernel": stack(
                    sa + "language_expert_dense.weight", Lt, True)},
            },
            "mlp": {"vision": mlp("vision"), "language": mlp("language")},
        },
        "norm": {"weight": leaf("norm.weight")},
        "output": {"kernel": kernel("lm_head.weight")},
    }
    return {"vision": vision, "adapter": adapter, "language_model": text}


def compute_dtype(params) -> torch.dtype:
    """The default activation dtype: the weights' (norms are never
    quantized)."""
    return held(params)[0]["language_model"]["norm"]["weight"].dtype


# ------------------------------------------------------------ vision tower

def _vdot(x, kernel, dtype, impl):
    """A tower or adapter product: its input in ``dtype``, an fp32 result
    (JAX's ``dot`` on fp32 activations)."""
    return dot_f32(x.to(dtype), kernel, impl)


def vision_forward(p, cfg: CogVLM2VisionConfig, pixel_values: torch.Tensor,
                   impl: str = "auto",
                   dtype: Optional[torch.dtype] = None,
                   mesh=None) -> torch.Tensor:
    """The EVA2-CLIP tower (``cogvlm2.py:340-382``): NHWC pixels (F, H, W,
    3) at the native grid -> fp32 (F, 1 + grid^2, C).  The cls token and
    the position table need no interpolation.  Each post-norm block adds
    ``LN(attn(x))`` and then ``LN(mlp(x))`` (exact GELU) to the
    un-normalised fp32 residual; the products and K3 take their inputs in
    ``dtype`` (the weights' by default).  q, k and v are strided views into
    the (F, S, 3, H, D) product in ``dtype`` (head stride D, token stride
    3 C: 16-byte multiples at D = 112), which K3 reads as they are.
    ``mesh``: ``p`` is the held model ranks' tower states; a split block
    runs each rank's heads of qkv and its rows of ``dense`` (and its
    columns of fc1, rows of fc2), the fp32 partials summed over the model
    axis."""
    p0 = held(p)[0]
    tp = model_axis(mesh)
    dtype = dtype or p0["layers"]["ln1"]["weight"].dtype
    # The pixels rounded to ``dtype``; the product then runs in fp32.
    x = patch_embed(p0["patch_embedding"], pixel_values.to(dtype).float(),
                    cfg.patch_size)
    N = x.shape[0]
    cls = p0["cls_embedding"].float().expand(N, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + p0["position_embedding"][None].float()
    D, eps = cfg.head_dim, cfg.layer_norm_eps
    S, C = x.shape[1], cfg.hidden_size

    def attn_body(lp, x, split):
        qkv = _vdot(x, lp["qkv"]["kernel"], dtype, impl) + lp["qkv"]["bias"]
        H = qkv.shape[-1] // (3 * D)
        q, k, v = qkv.to(dtype).reshape(N, S, 3, H, D).unbind(2)
        attn = multi_head_attention(q, k, v, causal=False, impl=impl)
        return _vdot(attn.reshape(N, S, H * D), lp["dense"]["kernel"], dtype,
                     impl)

    def mlp_body(lp, x, split):
        h = _vdot(x, lp["fc1"]["kernel"], dtype, impl) + lp["fc1"]["bias"]
        return _vdot(F.gelu(h), lp["fc2"]["kernel"], dtype, impl)

    layers = [t["layers"] for t in held_layers(p, mesh)]
    for i in range(cfg.num_hidden_layers):
        lps = [map_state(lambda a: a[i], t) for t in layers]
        lp = lps[0]
        split = (tp is not None
                 and lp["qkv"]["kernel"].shape[-1] != 3 * C)
        attn = pair_forward(tp, lps, x, split, attn_body) + lp["dense"]["bias"]
        x = x + layer_norm(attn, lp["ln1"]["weight"], lp["ln1"]["bias"],
                           eps=eps)
        split = (tp is not None
                 and lp["fc1"]["kernel"].shape[-1] != cfg.intermediate_size)
        h = pair_forward(tp, lps, x, split, mlp_body) + lp["fc2"]["bias"]
        x = x + layer_norm(h, lp["ln2"]["weight"], lp["ln2"]["bias"],
                           eps=eps)
    return x


def adapter_forward(p, cfg: CogVLM2Config, vision_out: torch.Tensor,
                    impl: str = "auto",
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Drop cls, the 2x2 stride-2 conv as a matmul over the (kh, kw, C)
    patch order, ``linear_proj``, LayerNorm at eps 1e-5 (nn.LayerNorm's
    default, not the tower's), exact GELU, the SwiGLU ``silu(gate) h_to_4h
    -> 4h_to_h``, boi/eoi a frame, then / ``scaling_factor``
    (``cogvlm2.py:385-415``), at fp32 activations with each product's
    input in ``dtype`` (the weights' by default).  Returns fp32 (F,
    tokens_per_frame, llm hidden)."""
    vc = cfg.vision
    dtype = dtype or p["norm1"]["weight"].dtype
    x = vision_out[:, 1:].float()
    n, g, C = x.shape[0], vc.grid, vc.hidden_size
    x = x.reshape(n, g // 2, 2, g // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, (g // 2) ** 2, 4 * C)
    x = _vdot(x, p["conv"]["kernel"], dtype, impl) + p["conv"]["bias"]
    x = _vdot(x, p["linear_proj"]["kernel"], dtype, impl)
    x = layer_norm(x, p["norm1"]["weight"], p["norm1"]["bias"], eps=1e-5)
    x = F.gelu(x)
    x = F.silu(_vdot(x, p["gate_proj"]["kernel"], dtype, impl)) \
        * _vdot(x, p["dense_h_to_4h"]["kernel"], dtype, impl)
    x = _vdot(x, p["dense_4h_to_h"]["kernel"], dtype, impl)
    Dt = x.shape[-1]
    boi = p["boi"].float().expand(n, 1, Dt)
    eoi = p["eoi"].float().expand(n, 1, Dt)
    return torch.cat([boi, x, eoi], dim=1) / vc.scaling_factor


def get_vision_embedding(params, cfg: CogVLM2Config,
                         pixel_values: torch.Tensor, impl: str = "auto",
                         dtype: Optional[torch.dtype] = None,
                         mesh=None) -> torch.Tensor:
    """Frames (F, H, W, 3) -> fp32 (F, tokens_per_frame, llm hidden): the
    tower and the adapter (``cogvlm2.py:836-844``, ``_jit_vision``), each
    product's input in ``dtype`` (the weights' by default); the adapter
    matches no rule and runs whole."""
    dtype = dtype or compute_dtype(params)
    vis = vision_forward(sub(params, "vision"), cfg.vision, pixel_values,
                         impl, dtype, mesh)
    return adapter_forward(held(params)[0]["adapter"], cfg, vis, impl, dtype)


# ----------------------------------------------------------- position ids

def build_position_ids(token_type_ids: np.ndarray) -> np.ndarray:
    """CogVLM's shared-vision-position scheme on the host
    (``cogvlm2.py:420-441``, ``modeling_cogvlm.build_position_ids``): the
    first and last vision token of each run count as language for the
    increments; the interior vision tokens of a run share one position."""
    x = np.asarray(token_type_ids)
    tmp = x.copy()
    is_boi_eoi = np.zeros_like(x, dtype=bool)
    is_boi_eoi[:, 1:] |= (tmp[:, 1:] == VISION_TOKEN_TYPE) & (
        tmp[:, :-1] == LANGUAGE_TOKEN_TYPE)
    is_boi_eoi[:, 0] |= tmp[:, 0] == VISION_TOKEN_TYPE
    is_boi_eoi[:, :-1] |= (tmp[:, :-1] == VISION_TOKEN_TYPE) & (
        tmp[:, 1:] == LANGUAGE_TOKEN_TYPE)
    is_boi_eoi[:, -1] |= tmp[:, -1] == VISION_TOKEN_TYPE
    tmp[is_boi_eoi] = LANGUAGE_TOKEN_TYPE
    y = np.zeros_like(x)
    y[:, 1:] = (tmp[:, 1:] == LANGUAGE_TOKEN_TYPE) | (
        (tmp[:, 1:] == VISION_TOKEN_TYPE)
        & (tmp[:, :-1] == LANGUAGE_TOKEN_TYPE))
    return np.cumsum(y, axis=-1)


# ------------------------------------------------------------ text decoder

def _qkv_split(cfg: LLMConfig, qkv: torch.Tensor, rank: int = 0,
               ranks: int = 1):
    """q, k and v of the packed [q; k; v] product; of ``ranks`` model
    ranks, rank ``rank``'s query heads and their kv group (its heads are
    contiguous, so its attention output is its rows of ``dense``)."""
    B, S, _ = qkv.shape
    Hq, Hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    hq, hkv = Hq // ranks, Hkv // ranks
    q0, k0, v0 = rank * hq * hd, (Hq + rank * hkv) * hd, \
        (Hq + Hkv + rank * hkv) * hd
    q = qkv[..., q0:q0 + hq * hd].reshape(B, S, hq, hd)
    k = qkv[..., k0:k0 + hkv * hd].reshape(B, S, hkv, hd)
    v = qkv[..., v0:v0 + hkv * hd].reshape(B, S, hkv, hd)
    return q, k, v


def _select(vis_mask: Optional[torch.Tensor], vision_fn, language_fn):
    """The expert of each position: both run and ``vis_mask`` (B, S, 1)
    bool selects, as JAX's ``jnp.where`` does; None (every position
    language) runs the language expert alone, the select's value there."""
    if vis_mask is None:
        return language_fn()
    return torch.where(vis_mask, vision_fn(), language_fn())


def _swiglu(mp, h, impl, split=False):
    y = F.silu(dot(h, mp["w1"]["kernel"], impl)) * dot(h, mp["w3"]["kernel"],
                                                        impl)
    return (dot_f32 if split else dot)(y, mp["w2"]["kernel"], impl)


def _qkv(lp, h, vis_mask, impl):
    a = lp["attention"]
    return _select(
        vis_mask,
        lambda: dot(h, a["vision_qkv"]["kernel"], impl)
        + a["vision_qkv"]["bias"],
        lambda: dot(h, a["language_qkv"]["kernel"], impl))


def _dense_split(cfg: LLMConfig, lp, mesh) -> bool:
    """Whether the layer's ``dense`` rows are split over the model axis."""
    return (model_axis(mesh) is not None
            and lp["attention"]["language_dense"]["kernel"].shape[-2]
            != cfg.num_attention_heads * cfg.head_dim)


def _attention(cfg: LLMConfig, lps, h, vis_mask, impl, mesh, attend):
    """The dual-expert attention branch after its norm, to the residual:
    the packed qkv once, ``attend(i, q, k, v)`` on each held rank's heads
    (where ``dense`` is split) and each expert's ``dense`` of its
    output."""
    B, S, _ = h.shape
    tp = model_axis(mesh)
    split = _dense_split(cfg, lps[0], mesh)
    qkv = _qkv(lps[0], h, vis_mask, impl)
    n = tp.model if split else 1

    def body(lp, i, split):
        q, k, v = _qkv_split(cfg, qkv, tp.model_ranks[i] if split else 0, n)
        attn = attend(i, q, k, v).reshape(B, S, -1)
        a = lp["attention"]
        prod = dot_f32 if split else dot
        return _select(vis_mask,
                       lambda: prod(attn, a["vision_dense"]["kernel"], impl),
                       lambda: prod(attn, a["language_dense"]["kernel"],
                                    impl))

    if not split:
        return body(lps[0], 0, False)
    return tp.reduce_from_model([body(lp, i, True)
                                 for i, lp in enumerate(lps)]).to(h.dtype)


def _mlp(cfg: LLMConfig, lps, h, vis_mask, impl, mesh):
    """Both experts' SwiGLU MLPs after the norm, by position: w1/w3
    column- and w2 row-parallel where the pair is split."""
    tp = model_axis(mesh)
    split = (tp is not None
             and lps[0]["mlp"]["language"]["w1"]["kernel"].shape[-1]
             != cfg.intermediate_size)

    def body(lp, x, split):
        return _select(vis_mask,
                       lambda: _swiglu(lp["mlp"]["vision"], x, impl, split),
                       lambda: _swiglu(lp["mlp"]["language"], x, impl, split))

    return pair_forward(tp, lps, h, split, body)


def _expert_layer(cfg: LLMConfig, lp, x, vis_mask, attention_mask, cos, sin,
                  position_ids, impl, mesh=None):
    """One dual-expert decoder layer (``VisionExpertAttention`` and
    ``VisionExpertMLP``, ``cogvlm2.py:446-479``); causal K3 at
    ``impl="auto"``.  ``mesh``: ``lp`` is the held model ranks' layer
    states."""
    lps = held(lp)

    def attend(i, q, k, v):
        q, k = apply_rope(q, k, cos, sin, position_ids)
        return multi_head_attention(q, k, v, attention_mask=attention_mask,
                                    causal=True, impl=impl)

    h = rms_norm(x, lps[0]["attention_norm"]["weight"], eps=cfg.rms_norm_eps)
    x = x + _attention(cfg, lps, h, vis_mask, impl, mesh, attend)
    h = rms_norm(x, lps[0]["ffn_norm"]["weight"], eps=cfg.rms_norm_eps)
    return x + _mlp(cfg, lps, h, vis_mask, impl, mesh)


def _vis_mask(token_type_ids: torch.Tensor) -> Optional[torch.Tensor]:
    """(B, T, 1) bool of the vision positions, or None where there are
    none (the language expert alone)."""
    m = (token_type_ids == VISION_TOKEN_TYPE)[..., None]
    return m if bool(m.any()) else None


def _embed(params, input_ids: torch.Tensor,
           token_type_ids: Optional[torch.Tensor],
           vision_embeds: Optional[torch.Tensor],
           dtype: torch.dtype, mesh=None,
           vocab_size: Optional[int] = None) -> torch.Tensor:
    """Token embeds in ``dtype`` with the vision embeds scattered at the
    vision positions (``token_type == VISION``)."""
    embeds = dec.embed_tokens(sub(params, "language_model"),
                              input_ids.long(), mesh, vocab_size).to(dtype)
    if vision_embeds is None:
        return embeds
    marker = (token_type_ids == VISION_TOKEN_TYPE).to(torch.int32)
    return scatter_image_embeds(embeds, marker, vision_embeds, 1)


def cogvlm2_forward(
    params, cfg: CogVLM2Config,
    input_ids: torch.Tensor,  # (B, T), pad_token_id at the vision slots
    token_type_ids: torch.Tensor,  # (B, T) 0 = language, 1 = vision
    attention_mask: Optional[torch.Tensor],
    position_ids: torch.Tensor,  # (B, T) from build_position_ids
    pixel_values: Optional[torch.Tensor] = None,  # (F, H, W, 3) NHWC
    impl: str = "auto",
    vision_embeds: Optional[torch.Tensor] = None,  # (F, n_tok, C)
    dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> torch.Tensor:
    """The multimodal forward -> final hidden states (B, T, C)
    (``cogvlm2.py:482-527``); ``vision_embeds`` skips the tower."""
    lm, tc = sub(params, "language_model"), cfg.text
    lm0 = held(lm)[0]
    dtype = dtype or compute_dtype(params)
    if vision_embeds is None and pixel_values is not None:
        vision_embeds = get_vision_embedding(
            params, cfg, torch.as_tensor(pixel_values).to(
                lm0["norm"]["weight"].device), impl, dtype, mesh)
    embeds = _embed(params, input_ids, token_type_ids, vision_embeds, dtype,
                    mesh, tc.vocab_size)
    S = input_ids.shape[1]
    cos, sin = rope_tables(max(S, 1), tc.head_dim, base=tc.rope_theta,
                           max_position_embeddings=tc.max_position_embeddings,
                           device=embeds.device)
    vis_mask = _vis_mask(token_type_ids)
    position_ids = torch.as_tensor(position_ids).to(embeds.device).long()
    layers = [t["layers"] for t in held_layers(lm, mesh)]
    x = embeds
    for i in range(tc.num_hidden_layers):
        x = _expert_layer(tc, [map_state(lambda a: a[i], t) for t in layers],
                          x, vis_mask, attention_mask, cos, sin, position_ids,
                          impl, mesh)
    return rms_norm(x, lm0["norm"]["weight"], eps=tc.rms_norm_eps)


def lm_logits(params, hidden: torch.Tensor, impl: str = "auto", mesh=None,
              vocab_size: Optional[int] = None) -> torch.Tensor:
    """fp32 logits by the untied LM head (``cogvlm2.py:530-531``); under
    ``mesh`` each rank's vocabulary columns, gathered
    (``decoder.lm_logits``)."""
    return dec.lm_logits(sub(params, "language_model"), hidden, impl, mesh,
                         vocab_size)


# ------------------------------------------------------------ cached decoder

def _expert_layer_cached(cfg: LLMConfig, lp, x, caches, cos, sin, slots,
                         rope_pos, cache_mask, vis_mask, impl: str = "auto",
                         q_offset=None, mesh=None):
    """``generate._layer_with_cache`` with the expert select and the rotary
    position ``rope_pos`` decoupled from the cache slot ``slots``
    (``cogvlm2.py:534-605``).  Causality is token order, which is slot
    order, so the kernels' slot causality holds: a multi-token call with
    ``q_offset`` (a suffix continuation) runs K3 over the whole cache, one
    without it (a prompt into an empty cache) K3 over the fresh tokens
    masked by ``write_ok``; a decode step (S = 1) or ``impl="plain"``
    attends over the cache through the slot bias
    (``generate.attend_cache``).  ``caches``: each held rank's (k, v,
    k_scale, v_scale) of this layer, its own kv heads where ``dense`` is
    split."""
    lps = held(lp)

    def attend(i, q, k, v):
        q, k = apply_rope(q, k, cos, sin, rope_pos)
        return attend_cache(q, k, v, *caches[i], slots, cache_mask, impl,
                            q_offset)

    h = rms_norm(x, lps[0]["attention_norm"]["weight"], eps=cfg.rms_norm_eps)
    x = x + _attention(cfg, lps, h, vis_mask, impl, mesh, attend)
    h = rms_norm(x, lps[0]["ffn_norm"]["weight"], eps=cfg.rms_norm_eps)
    return x + _mlp(cfg, lps, h, vis_mask, impl, mesh)


def _new_cache(cfg: CogVLM2Config, lm, batch: int, max_len: int, device,
               dtype, kv_quant: bool, mesh):
    """A zeroed cache: one per held rank, each of its kv heads, where the
    layers' ``dense`` is split (``generate.init_kv_cache``)."""
    tc = cfg.text
    lp0 = map_state(lambda a: a[0], held(lm)[0]["layers"])
    heads = (tc.num_key_value_heads // mesh.model
             if _dense_split(tc, lp0, mesh) else None)
    return init_kv_cache(tc, batch, max_len, device=device, dtype=dtype,
                         quant=kv_quant, mesh=mesh, kv_heads=heads)


def forward_cached(params, cfg: CogVLM2Config, embeds: torch.Tensor,
                   cache, slots: torch.Tensor,
                   rope_pos: torch.Tensor, cache_mask: torch.Tensor,
                   vis_mask: Optional[torch.Tensor], impl: str = "auto",
                   q_offset: Optional[torch.Tensor] = None, mesh=None):
    """Every layer over the new tokens, writing ``cache`` in place
    (``cogvlm2.py:608-629``): (final-normed hidden (B, S, C), cache)."""
    lm, tc = sub(params, "language_model"), cfg.text
    cos, sin = rope_tables(cache.max_len, tc.head_dim, base=tc.rope_theta,
                           max_position_embeddings=tc.max_position_embeddings,
                           device=embeds.device)
    slots, rope_pos = slots.long(), rope_pos.long()
    layers = [t["layers"] for t in held_layers(lm, mesh)]
    x = embeds
    for i in range(tc.num_hidden_layers):
        x = _expert_layer_cached(
            tc, [map_state(lambda a: a[i], t) for t in layers], x,
            layer_caches(cache, i), cos, sin, slots, rope_pos, cache_mask,
            vis_mask, impl=impl, q_offset=q_offset, mesh=mesh)
    return rms_norm(x, held(lm)[0]["norm"]["weight"],
                    eps=tc.rms_norm_eps), cache


def _step_fn(cfg: CogVLM2Config, max_len: int, n_start: torch.Tensor,
             pos_all: torch.Tensor, impl: str, dtype: torch.dtype, mesh=None):
    """The cached decode step of a row whose generated token i sits at slot
    ``n_start + i`` and rotates by ``pos_all[n_start + i]``; a generated
    token is language, so the language expert runs alone."""
    V = cfg.text.vocab_size

    def step(params, tok, i, cache):
        e = dec.embed_tokens(sub(params, "language_model"),
                             tok.long()[:, None], mesh, V).to(dtype)
        s, m = step_slot_mask(max_len, n_start, i)
        h, cache = forward_cached(params, cfg, e, cache, s,
                                  torch.gather(pos_all, 1, s), m, None,
                                  impl=impl, mesh=mesh)
        return lm_logits(params, h, impl, mesh, V)[:, 0], cache
    return step


def _position_table(token_type_ids: np.ndarray, n_real: int,
                    max_len: int) -> np.ndarray:
    """(max_len,) int64 rotary positions of a row: the prompt's
    ``build_position_ids``, then ``max + 1`` onwards for every later slot
    (``cogvlm2.py:794-801``)."""
    out = np.zeros((max_len,), np.int64)
    pos = build_position_ids(np.asarray(token_type_ids).reshape(1, -1))[0]
    out[:n_real] = pos
    out[n_real:] = pos.max() + 1 + np.arange(max_len - n_real)
    return out


def _prefill_rows(params, cfg: CogVLM2Config, embeds, tt, n_real, pos_t, Tb,
                  max_len, max_new_tokens, eos, impl, kv_quant, dtype,
                  teacher_tokens, mesh):
    """Right-padded prompt rows' ``embeds`` into a fresh cache, then the
    greedy loop: ``decode_batch``'s output."""
    lm = sub(params, "language_model")
    cache = _new_cache(cfg, lm, embeds.shape[0], max_len, embeds.device,
                       embeds.dtype, kv_quant, mesh)
    slots, mask = prefill_slot_mask(Tb, max_len, n_real)
    hidden, cache = forward_cached(params, cfg, embeds, cache, slots,
                                   pos_t[:, :Tb], mask, _vis_mask(tt), impl,
                                   mesh=mesh)
    logits0 = lm_logits(params, last_real_token(hidden, n_real), impl, mesh,
                        cfg.text.vocab_size)[:, 0]
    step = _step_fn(cfg, max_len, n_real, pos_t, impl, dtype, mesh)
    return decode_batch(step, params, logits0, cache, max_new_tokens,
                        int(eos), teacher_tokens)


@torch.no_grad()
def greedy_generate_batch(
    params, cfg: CogVLM2Config,
    items,  # per row (input_ids (1, T), token_type_ids (1, T), pixels)
    max_new_tokens: int = 16,
    eos_token_id: Optional[int] = None,
    impl: str = "auto",  # the vision tower's and the cached prefill's
    vision_embeds=None,  # per row, precomputed (F, n_tok, C) embeds
    kv_quant: bool = False,  # int8 KV cache
    teacher_tokens: Optional[torch.Tensor] = None,  # (B, n)
    dtype: Optional[torch.dtype] = None,
    mesh=None,
):
    """Batched greedy decode with a static KV cache
    (``cogvlm2.py:766-816``): each row's frames encode once, the
    right-padded prompt batch (64-token buckets; pads of language type)
    prefills once, and the rows decode together, generated tokens through
    the language expert while RoPE keeps the shared-vision scheme.
    Returns each row's tokens up to and including its EOS, or with
    ``teacher_tokens`` the (B, n, V) fp32 logits of each step.  ``mesh``:
    the held model ranks' ``params`` split over its model axis, the rows
    over its data axis."""
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
    dtype = dtype or compute_dtype(params)
    B = len(items)
    has_vision = items[0][2] is not None or vision_embeds is not None
    ids, n_real, Tb = pad_prompt_batch([it[0] for it in items],
                                       cfg.pad_token_id)
    max_len = Tb + max_new_tokens
    tt = np.zeros((B, Tb), np.int32)
    pos_all = np.zeros((B, max_len), np.int64)
    for b, (_, token_type_ids, _) in enumerate(items):
        nr = int(n_real[b])
        tt[b, :nr] = np.asarray(token_type_ids)[0]
        pos_all[b] = _position_table(token_type_ids, nr, max_len)
    dev = held(params)[0]["language_model"]["norm"]["weight"].device
    vis = None
    if has_vision:
        if vision_embeds is None:
            vis = torch.cat([
                get_vision_embedding(params, cfg,
                                     torch.as_tensor(pv).to(dev), impl, dtype,
                                     mesh)
                for _, _, pv in items])
        else:
            vis = torch.cat([v.reshape(-1, v.shape[-1])
                             for v in vision_embeds])
    tt_t = torch.from_numpy(tt).to(dev)
    n_t = torch.from_numpy(n_real).to(dev)
    pos_t = torch.from_numpy(pos_all).to(dev)
    embeds = _embed(params, torch.from_numpy(ids).to(dev), tt_t, vis, dtype,
                    mesh, cfg.text.vocab_size)
    out = over_data(mesh, B, lambda rows: _prefill_rows(
        params, cfg, embeds[rows], tt_t[rows], n_t[rows], pos_t[rows], Tb,
        max_len, max_new_tokens, eos, impl, kv_quant, dtype,
        None if teacher_tokens is None else teacher_tokens[rows], mesh))
    if teacher_tokens is not None:
        return out
    toks, n = (t.tolist() for t in out)
    return [[int(t) for t in toks[b][: n[b]]] for b in range(B)]


def greedy_generate(params, cfg: CogVLM2Config, input_ids, token_type_ids,
                    pixel_values=None, max_new_tokens: int = 16,
                    eos_token_id: Optional[int] = None, impl: str = "auto",
                    kv_quant: bool = False, mesh=None) -> List[int]:
    """A single prompt's greedy decode (``cogvlm2.py:819-833``)."""
    return greedy_generate_batch(
        params, cfg, [(input_ids, token_type_ids, pixel_values)],
        max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
        impl=impl, kv_quant=kv_quant, mesh=mesh)[0]


class PrefixCache(NamedTuple):
    """[bos] and a video's vision block prefilled once (``cogvlm2.py:
    687-712`` and the judge's ``_prefix_state``, whose ``n_extras=1`` table
    is ``pos_all``).  Functions that take one never change it."""

    cache: KVCache  # slots [0, P) filled (RankCaches under a model axis)
    mask: torch.Tensor  # (B, max_len) int32
    P: int
    max_len: int
    pos_all: torch.Tensor  # (B, max_len) int64 rotary positions by slot


@torch.no_grad()
def prefill_prefix(params, cfg: CogVLM2Config, prefix: Sequence[int],
                   vision_embeds: torch.Tensor, max_len: int, bucket: int,
                   impl: str = "auto", kv_quant: bool = False,
                   dtype: Optional[torch.dtype] = None,
                   mesh=None) -> PrefixCache:
    """[bos] + the vision block (``build_video_prompt_prefix_suffix``'s
    prefix) into an empty cache, right-padded to ``bucket``, with the
    shared-vision positions of its slots and the table that runs on past
    them; no logits: a prefix never ends a prompt."""
    dtype = dtype or compute_dtype(params)
    P = len(prefix)
    lm = sub(params, "language_model")
    dev = held(lm)[0]["norm"]["weight"].device
    ids = np.full((1, bucket), cfg.pad_token_id, np.int64)
    ids[0, :P] = prefix
    tt = np.full((1, bucket), LANGUAGE_TOKEN_TYPE, np.int32)
    tt[0, 1:P] = VISION_TOKEN_TYPE
    pos_all = torch.from_numpy(_position_table(tt[:, :P], P, max_len)[None]
                               ).to(dev)
    tt_t = torch.from_numpy(tt).to(dev)
    embeds = _embed(params, torch.from_numpy(ids).to(dev), tt_t,
                    vision_embeds, dtype, mesh, cfg.text.vocab_size)
    cache = _new_cache(cfg, lm, 1, max_len, dev, embeds.dtype, kv_quant, mesh)
    slots, mask = prefill_slot_mask(bucket, max_len, P, device=dev)
    forward_cached(params, cfg, embeds, cache, slots, pos_all[:, :bucket],
                   mask, _vis_mask(tt_t), impl, mesh=mesh)
    return PrefixCache(cache, mask, P, max_len, pos_all)


def _continue_rows(params, cfg: CogVLM2Config, state: PrefixCache,
                   suffix: Sequence[int], bucket: int, max_new_tokens: int,
                   eos_token_id: int, impl: str, teacher_tokens, dtype,
                   mesh):
    cache, pmask, P, max_len, pos_all = state
    cache = cache.clone()
    dev = pmask.device
    B = pmask.shape[0]
    sids = torch.full((B, bucket), cfg.pad_token_id, dtype=torch.long,
                      device=dev)
    sids[:, : len(suffix)] = torch.tensor(list(suffix), device=dev)
    n_prefix = torch.full((B,), P, dtype=torch.int32, device=dev)
    s_real = torch.full((B,), len(suffix), dtype=torch.int32, device=dev)
    slots = n_prefix.long()[:, None] + torch.arange(bucket, device=dev)[None]
    span = torch.arange(max_len, device=dev)[None]
    valid = (span >= P) & (span < P + len(suffix))
    mask = torch.maximum(pmask, valid.to(pmask.dtype))
    hidden, cache = forward_cached(
        params, cfg, _embed(params, sids, None, None, dtype, mesh,
                            cfg.text.vocab_size), cache, slots,
        torch.gather(pos_all, 1, slots), mask, None, impl=impl,
        q_offset=n_prefix, mesh=mesh)
    logits0 = lm_logits(params, last_real_token(hidden, s_real), impl, mesh,
                        cfg.text.vocab_size)[:, 0]
    step = _step_fn(cfg, max_len, n_prefix + s_real, pos_all, impl, dtype,
                    mesh)
    return decode_batch(step, params, logits0, cache, max_new_tokens,
                        int(eos_token_id), teacher_tokens)


@torch.no_grad()
def continue_prefix(params, cfg: CogVLM2Config, state: PrefixCache,
                    suffix: Sequence[int], bucket: int, max_new_tokens: int,
                    eos_token_id: int, impl: str = "auto",
                    teacher_tokens: Optional[torch.Tensor] = None,
                    dtype: Optional[torch.dtype] = None, mesh=None):
    """A question suffix on a copy of a cached prefix, then greedy decode
    (``cogvlm2.py:715-763``).  The suffix, right-padded to ``bucket``,
    takes slots [P, P + len(suffix)) and rotates by the state's table; it
    is language, so the language expert runs alone, and its attention runs
    over the whole cache with ``q_offset`` = P.  Returns (toks (B,
    max_new_tokens) int32, n (B,)), or with ``teacher_tokens`` the (B, n,
    V) fp32 logits of each step; ``mesh`` as in
    ``greedy_generate_batch``."""
    dtype = dtype or compute_dtype(params)
    return over_data(mesh, state.mask.shape[0], lambda rows: _continue_rows(
        params, cfg, slice_state(state, rows), suffix, bucket,
        max_new_tokens, eos_token_id, impl,
        None if teacher_tokens is None else teacher_tokens[rows], dtype,
        mesh))


# ------------------------------------------------------------ preprocessing

def preprocess_video_frames(frames: Sequence[np.ndarray],
                            cfg: CogVLM2VisionConfig) -> np.ndarray:
    """uint8 RGB frames (H, W, 3) -> (F, image_size, image_size, 3) fp32:
    the cogvlm2-video processor's square resize (PIL bicubic) and CLIP
    normalisation (``cogvlm2.py:852-866``)."""
    from ..data.video import CLIP_MEAN, CLIP_STD, _pil_resize

    size = cfg.image_size
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    return np.stack([(_pil_resize(f, (size, size)).astype(np.float32)
                      / 255.0 - mean) / std for f in frames])


def build_video_prompt_ids(
    tokenizer, cfg: CogVLM2Config, n_frames: int, prompt: str,
    history=None, template_version: str = "chat",
) -> Tuple[np.ndarray, np.ndarray]:
    """(input_ids, token_type_ids), each (1, T) int32, of an n-frame video
    and a question (``cogvlm2.py:869-895``, the published
    ``build_conversation_input_ids``): [bos], one vision block of
    ``n_frames * tokens_per_frame`` pad placeholders (boi, the frame's
    tokens and eoi each; vision type), then the templated question
    (``data/judge_templates.cogvlm2_history_to_prompt``)."""
    from ..data.judge_templates import cogvlm2_history_to_prompt
    from ..data.prompts import encode_text

    n_vis = n_frames * cfg.vision.tokens_per_frame
    text_ids = encode_text(tokenizer, cogvlm2_history_to_prompt(
        prompt, history, template_version))
    ids = [cfg.bos_token_id] + [cfg.pad_token_id] * n_vis + text_ids
    tt = ([LANGUAGE_TOKEN_TYPE] + [VISION_TOKEN_TYPE] * n_vis
          + [LANGUAGE_TOKEN_TYPE] * len(text_ids))
    return np.asarray([ids], np.int32), np.asarray([tt], np.int32)


def build_video_prompt_prefix_suffix(
    tokenizer, cfg: CogVLM2Config, n_frames: int, prompt: str,
    template_version: str = "chat",
) -> Tuple[List[int], List[int]]:
    """The prompt split at the vision/text boundary, exactly
    (``cogvlm2.py:898-917``): the prefix is [bos] and the vision block
    (``tokens_per_frame`` slots a frame, 66 at 224 px; it does not depend
    on the question: the judge prefills it once per video), the suffix the
    whole templated question, encoded on its own as
    ``build_video_prompt_ids`` encodes it, so prefix + suffix is the whole
    prompt's ids.  Token types are implied: [language] + vision x n, then
    all language."""
    from ..data.judge_templates import cogvlm2_history_to_prompt
    from ..data.prompts import encode_text

    n_vis = n_frames * cfg.vision.tokens_per_frame
    prefix = [cfg.bos_token_id] + [cfg.pad_token_id] * n_vis
    suffix = encode_text(tokenizer, cogvlm2_history_to_prompt(
        prompt, None, template_version))
    return prefix, suffix
