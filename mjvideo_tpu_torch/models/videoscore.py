"""VideoScore (Mantis Idefics2): the SigLIP vision tower, the perceiver
connector, the Mistral text model and a last-token regression head.

Counterpart of ``mjvideo_tpu/models/videoscore.py`` (the reference runs
VideoScore's ``Idefics2ForSequenceClassification`` in torch,
``eval_genai_videoScore.py:41-129``).  The SigLIP tower is also
MiniCPM-V-2.6's (``models/minicpmv.py``).  What differs from the JAX
package:

* The tower's attention is K1 at SigLIP-so400m's head dim of 72
  (``flash_attention(norm_bound=True)``: 16 heads over each frame's
  patches, non-causal and maskless), or, on the variable-aspect path (a
  patch mask: ``do_image_splitting`` or frames of mixed sizes padded
  bottom/right), K1m, the masked non-causal form of the bound kernel, with
  the patch mask as the key mask.  Both forward only: the judges take no
  gradient.  Their plain twins run on the CPU.
* The perceiver's grouped attention (16/4 heads of 96) is plain torch, as
  JAX runs it with ``impl="xla"``; the text model is the port's decoder
  (``models/decoder.py``, K2 at Mistral's 32/8 heads of 128).  Mistral's
  sliding window (4,096) is ignored, as JAX ignores it: VideoScore's
  prompts stay below it.
* The layers run in a Python loop over the stacked state; weights come
  from an explicit ``torch.Generator`` (``init_videoscore_params``) or an
  HF state (``import_videoscore_params``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import LLMConfig
from ..ops.attention import multi_head_attention
from ..ops.matmul import dot, dot_f32
from ..ops.norms import layer_norm, rms_norm
from ..utils.bridge import map_state
from . import decoder as dec
from .internvl import scatter_image_embeds
from .vit import patch_embed

VIDEOSCORE_DIMS = ("visual quality", "temporal consistency", "dynamic degree",
                   "text-to-video alignment", "factual consistency")


@dataclass(frozen=True)
class PerceiverConfig:
    depth: int = 3
    n_heads: int = 16
    head_dim: int = 96
    num_key_value_heads: int = 4
    n_latents: int = 64
    rms_norm_eps: float = 1e-6


@dataclass(frozen=True)
class SigLIPVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    patch_size: int = 14
    image_size: int = 980
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class VideoScoreConfig:
    vision: SigLIPVisionConfig = field(default_factory=SigLIPVisionConfig)
    perceiver: PerceiverConfig = field(default_factory=PerceiverConfig)
    text: LLMConfig = field(default_factory=lambda: LLMConfig(
        architecture="llama", vocab_size=32003, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        rope_theta=10000.0, rms_norm_eps=1e-5, pad_token_id=0,
    ))
    image_token_id: int = 32001
    num_labels: int = 1


def videoscore_config_from_hf(d: Dict[str, Any]) -> VideoScoreConfig:
    """A ``VideoScoreConfig`` from an HF Idefics2 ``config.json`` dict
    (``videoscore.py:75-120``)."""
    v = d.get("vision_config", {})
    p = d.get("perceiver_config", {})
    t = d.get("text_config", {})
    return VideoScoreConfig(
        vision=SigLIPVisionConfig(
            hidden_size=v.get("hidden_size", 1152),
            intermediate_size=v.get("intermediate_size", 4304),
            num_hidden_layers=v.get("num_hidden_layers", 27),
            num_attention_heads=v.get("num_attention_heads", 16),
            patch_size=v.get("patch_size", 14),
            image_size=v.get("image_size", 980),
            layer_norm_eps=v.get("layer_norm_eps", 1e-6),
        ),
        perceiver=PerceiverConfig(
            depth=p.get("resampler_depth", 3),
            n_heads=p.get("resampler_n_heads", 16),
            head_dim=p.get("resampler_head_dim", 96),
            num_key_value_heads=p.get("num_key_value_heads", 4),
            n_latents=p.get("resampler_n_latents", 64),
            rms_norm_eps=p.get("rms_norm_eps", 1e-6),
        ),
        text=LLMConfig(
            architecture="llama",
            vocab_size=t.get("vocab_size", 32003),
            hidden_size=t.get("hidden_size", 4096),
            intermediate_size=t.get("intermediate_size", 14336),
            num_hidden_layers=t.get("num_hidden_layers", 32),
            num_attention_heads=t.get("num_attention_heads", 32),
            num_key_value_heads=t.get("num_key_value_heads", 8),
            rope_theta=t.get("rope_theta", 10000.0),
            rms_norm_eps=t.get("rms_norm_eps", 1e-5),
            max_position_embeddings=t.get("max_position_embeddings", 32768),
            pad_token_id=t.get("pad_token_id", 0) or 0,
        ),
        image_token_id=d.get("image_token_id", 32001),
        num_labels=d.get("num_labels", len(VIDEOSCORE_DIMS)),
    )


def videoscore_config_to_hf(cfg: VideoScoreConfig) -> Dict[str, Any]:
    """The HF Idefics2 ``config.json`` dict that
    ``videoscore_config_from_hf`` reads back as ``cfg`` (the JAX package
    has no writer; the tests and ``chip_smoke.py`` write checkpoint
    directories with it)."""
    v, p, t = cfg.vision, cfg.perceiver, cfg.text
    return {
        "architectures": ["Idefics2ForSequenceClassification"],
        "model_type": "idefics2",
        "vision_config": {
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_hidden_layers,
            "num_attention_heads": v.num_attention_heads,
            "patch_size": v.patch_size, "image_size": v.image_size,
            "layer_norm_eps": v.layer_norm_eps},
        "perceiver_config": {
            "resampler_depth": p.depth, "resampler_n_heads": p.n_heads,
            "resampler_head_dim": p.head_dim,
            "num_key_value_heads": p.num_key_value_heads,
            "resampler_n_latents": p.n_latents,
            "rms_norm_eps": p.rms_norm_eps},
        "text_config": {
            "model_type": "mistral", "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_hidden_layers,
            "num_attention_heads": t.num_attention_heads,
            "num_key_value_heads": t.num_key_value_heads,
            "rope_theta": t.rope_theta, "rms_norm_eps": t.rms_norm_eps,
            "max_position_embeddings": t.max_position_embeddings,
            "pad_token_id": t.pad_token_id},
        "image_token_id": cfg.image_token_id,
        "num_labels": cfg.num_labels,
    }


# ------------------------------------------------------------------ params

def import_videoscore_params(state, cfg: VideoScoreConfig,
                             dtype: torch.dtype = torch.float32,
                             prefix: str = "", device="cuda"):
    """An HF Idefics2 state (name -> tensor, e.g.
    ``utils.checkpoint.load_safetensors_dir``) -> the state
    ``videoscore_forward`` takes, layers stacked, on ``device`` (the card
    unless the caller asks for another) in ``dtype``
    (``videoscore.py:130-196``): ``vision_model.*`` (SigLIP),
    ``connector.*`` (the modality projection and the perceiver),
    ``text_model.*`` (Mistral, no LM head) and ``score.weight`` where the
    state has it."""
    from ..utils.checkpoint import (
        _Importer,
        import_decoder_params,
        import_siglip_vision,
    )

    vision = import_siglip_vision(state, cfg.vision, dtype,
                                  prefix=prefix + "vision_model.",
                                  device=device)
    im = _Importer(state, prefix + "connector.", dtype, device)
    d = cfg.perceiver.depth

    def p_stack(name, transpose=False):
        return im.per_layer(d, "perceiver_resampler.layers.{}." + name,
                            transpose)

    mp = "modality_projection."
    connector = {
        "modality_projection": {
            name: {"kernel": im.kernel(f"{mp}{name}_proj.weight")}
            for name in ("gate", "up", "down")},
        "latents": im.leaf("perceiver_resampler.latents"),
        "layers": {
            "ln_latents": {"weight": p_stack("input_latents_norm.weight")},
            "ln_context": {"weight": p_stack("input_context_norm.weight")},
            **{n: {"kernel": p_stack(f"self_attn.{n}_proj.weight", True)}
               for n in ("q", "k", "v", "o")},
            "ln_post": {"weight": p_stack("post_attention_layernorm.weight")},
            **{n: {"kernel": p_stack(f"mlp.{n}_proj.weight", True)}
               for n in ("gate", "up", "down")},
        },
        "norm": {"weight": im.leaf("perceiver_resampler.norm.weight")},
    }
    # The text model's names, text_model.* read as the decoder's model.*.
    tp = prefix + "text_model."
    text_state = {"model." + k[len(tp):]: v for k, v in state.items()
                  if k.startswith(tp)}
    text = import_decoder_params(text_state, cfg.text, dtype, prefix="",
                                 with_lm_head=False, device=device)
    params = {"vision_model": vision, "connector": connector, "text": text}
    if prefix + "score.weight" in state:
        params["score"] = {"kernel": _Importer(
            state, prefix, dtype, device).kernel("score.weight")}
    return params


def init_siglip_vision_params(vc: SigLIPVisionConfig, dense, ones, zeros):
    """A random SigLIP tower in ``import_siglip_vision``'s layout: dense
    kernels from ``dense``, norms 1, biases 0."""
    C, I, L = vc.hidden_size, vc.intermediate_size, vc.num_hidden_layers
    side = vc.image_size // vc.patch_size

    def linear(n_in, n_out):
        return {"kernel": dense(L, n_in, n_out), "bias": zeros(L, n_out)}

    return {
        "patch_embedding": {"kernel": dense(vc.patch_size ** 2 * 3, C),
                            "bias": zeros(C)},
        "position_embedding": dense(side * side, C),
        "layers": {
            "ln1": {"weight": ones(L, C), "bias": zeros(L, C)},
            "ln2": {"weight": ones(L, C), "bias": zeros(L, C)},
            "q": linear(C, C), "k": linear(C, C), "v": linear(C, C),
            "o": linear(C, C), "fc1": linear(C, I), "fc2": linear(I, C),
        },
        "post_layernorm": {"weight": ones(C), "bias": zeros(C)},
    }


def _initializers(generator: torch.Generator, device, dtype):
    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device) * 0.02
        return w.to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dense, ones, zeros


def init_videoscore_params(cfg: VideoScoreConfig, *,
                           generator: torch.Generator, device,
                           dtype: torch.dtype = torch.float32,
                           num_labels: Optional[int] = None,
                           subset: Optional[tuple] = None):
    """Random state in ``import_videoscore_params``'s tree
    (``videoscore.py:199-286``): dense kernels N(0, 0.02), norms 1, biases
    0.  The modality projection runs vision width -> text intermediate ->
    text width, each perceiver layer's MLP at 4x the text width (as in
    transformers' Idefics2).  ``subset``: the top-level keys to build."""
    vc, pc, tc = cfg.vision, cfg.perceiver, cfg.text
    dense, ones, zeros = _initializers(generator, device, dtype)
    C, Ct, It, d = vc.hidden_size, tc.hidden_size, tc.intermediate_size, \
        pc.depth
    Ip = 4 * Ct
    want = subset or ("vision_model", "connector", "text", "score")

    def connector():
        return {
            "modality_projection": {
                "gate": {"kernel": dense(C, It)},
                "up": {"kernel": dense(C, It)},
                "down": {"kernel": dense(It, Ct)},
            },
            "latents": dense(pc.n_latents, Ct),
            "layers": {
                "ln_latents": {"weight": ones(d, Ct)},
                "ln_context": {"weight": ones(d, Ct)},
                "q": {"kernel": dense(d, Ct, pc.n_heads * pc.head_dim)},
                "k": {"kernel": dense(
                    d, Ct, pc.num_key_value_heads * pc.head_dim)},
                "v": {"kernel": dense(
                    d, Ct, pc.num_key_value_heads * pc.head_dim)},
                "o": {"kernel": dense(d, pc.n_heads * pc.head_dim, Ct)},
                "ln_post": {"weight": ones(d, Ct)},
                "gate": {"kernel": dense(d, Ct, Ip)},
                "up": {"kernel": dense(d, Ct, Ip)},
                "down": {"kernel": dense(d, Ip, Ct)},
            },
            "norm": {"weight": ones(Ct)},
        }

    builders = {
        "vision_model": lambda: init_siglip_vision_params(vc, dense, ones,
                                                          zeros),
        "connector": connector,
        "text": lambda: dec.init_decoder_params(
            tc, generator=generator, device=device, dtype=dtype),
        "score": lambda: {"kernel": dense(Ct, num_labels or cfg.num_labels)},
    }
    return {k: builders[k]() for k in builders if k in want}


# ------------------------------------------------------------ vision tower

def _mlp_silu(p, x, impl: str = "auto"):
    return dot(F.silu(dot(x, p["gate"]["kernel"], impl))
               * dot(x, p["up"]["kernel"], impl), p["down"]["kernel"], impl)


def _bucket_position_ids(gh: int, gw: int, side: int) -> np.ndarray:
    """Idefics2's resolution-bucketised position ids for a full (gh, gw)
    patch grid (``videoscore.py:293-306``): fractional coordinates scaled
    by (1 - 1e-6), bucketised against ``side`` equal bins.  For gh == gw ==
    side this is max(i - 1, 0), not arange."""
    def buckets(n):
        frac = np.arange(n) / n * (1 - 1e-6)
        boundaries = np.arange(1, side) / side
        return np.searchsorted(boundaries, frac, side="right")

    bh, bw = buckets(gh), buckets(gw)
    return (bh[:, None] * side + bw[None, :]).reshape(-1)


def masked_position_ids(patch_mask: torch.Tensor, side: int) -> torch.Tensor:
    """(N, gh gw) int64 per-image bucketised position ids of images padded
    bottom/right (``videoscore.py:309-327``): image i's live (nb_h, nb_w)
    grid maps through ``floor(j / nb * (1 - 1e-6) * side)`` in fp32, the
    JAX package's arithmetic step for step, so the ids are the same; a
    padded patch reads embedding 0."""
    N, gh, gw = patch_mask.shape
    pm = patch_mask.to(torch.int32)
    nb_h = pm[:, :, 0].sum(dim=1, dtype=torch.int32)
    nb_w = pm[:, 0, :].sum(dim=1, dtype=torch.int32)
    hi = torch.arange(gh, dtype=torch.float32, device=pm.device)
    wi = torch.arange(gw, dtype=torch.float32, device=pm.device)
    bh = torch.floor(hi[None] / nb_h.clamp_min(1)[:, None]
                     * (1 - 1e-6) * side).to(torch.int64)
    bw = torch.floor(wi[None] / nb_w.clamp_min(1)[:, None]
                     * (1 - 1e-6) * side).to(torch.int64)
    pos = bh[:, :, None] * side + bw[:, None, :]
    return torch.where(pm != 0, pos, 0).reshape(N, gh * gw)


def _siglip_block(lp, x: torch.Tensor, cfg: SigLIPVisionConfig,
                  kv_mask: Optional[torch.Tensor], impl: str) -> torch.Tensor:
    """One pre-LN SigLIP block (``videoscore.py:361-381``)."""
    B, S, C = x.shape
    H, D, eps = cfg.num_attention_heads, cfg.head_dim, cfg.layer_norm_eps
    h = layer_norm(x, lp["ln1"]["weight"], lp["ln1"]["bias"], eps=eps)
    q, k, v = ((dot(h, lp[n]["kernel"], impl) + lp[n]["bias"])
               .reshape(B, S, H, D) for n in ("q", "k", "v"))
    # A pre-LN block keeps q and k bounded: the Cauchy-Schwarz shift holds
    # (models/vit.py).  K1 without a mask, K1m with the patch mask.
    attn = multi_head_attention(q, k, v, attention_mask=kv_mask,
                                causal=False, impl=impl, norm_bound=True)
    x = x + dot(attn.reshape(B, S, C), lp["o"]["kernel"], impl) \
        + lp["o"]["bias"]
    h = layer_norm(x, lp["ln2"]["weight"], lp["ln2"]["bias"], eps=eps)
    h = dot(h, lp["fc1"]["kernel"], impl) + lp["fc1"]["bias"]
    h = F.gelu(h, approximate="tanh")  # gelu_pytorch_tanh
    return x + dot(h, lp["fc2"]["kernel"], impl) + lp["fc2"]["bias"]


def vision_forward(p, cfg: SigLIPVisionConfig, pixel_values: torch.Tensor,
                   impl: str = "auto",
                   patch_attention_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The SigLIP tower (``videoscore.py:330-397``): NHWC pixels (N, H, W, 3)
    -> (N, gh gw, C).  The pixels are cropped to whole patches (a torch
    Conv2d with kernel = stride = P drops the remainder), patch-embedded,
    given the bucketised position embeddings, run through the pre-LN blocks
    (``gelu_pytorch_tanh``) and ``post_layernorm``.

    ``patch_attention_mask``: (N, gh, gw), 1 = a real patch: the
    variable-aspect path (per-image position ids, and the attention's key
    mask, K1m on the card).  None: every patch is real (K1).  Hidden states
    at padded patches are garbage by construction, as in transformers; the
    connector's context mask discards them."""
    P = cfg.patch_size
    gh, gw = pixel_values.shape[1] // P, pixel_values.shape[2] // P
    pixel_values = pixel_values[:, :gh * P, :gw * P]
    x = patch_embed(p["patch_embedding"], pixel_values, P)
    side = cfg.image_size // P
    kv_mask = None
    table = p["position_embedding"]
    if patch_attention_mask is not None:
        pos = masked_position_ids(patch_attention_mask, side)
        x = x + table[pos].to(x.dtype)
        kv_mask = patch_attention_mask.reshape(
            patch_attention_mask.shape[0], gh * gw).to(torch.int32)
    else:
        pos = torch.from_numpy(_bucket_position_ids(gh, gw, side)).to(
            x.device)
        x = x + table[pos][None].to(x.dtype)
    for i in range(cfg.num_hidden_layers):
        x = _siglip_block(map_state(lambda a: a[i], p["layers"]), x, cfg,
                          kv_mask, impl)
    return layer_norm(x, p["post_layernorm"]["weight"],
                      p["post_layernorm"]["bias"], eps=cfg.layer_norm_eps)


# --------------------------------------------------------------- connector

def connector_forward(p, cfg: PerceiverConfig, vision_hidden: torch.Tensor,
                      eps_override: Optional[float] = None,
                      context_mask: Optional[torch.Tensor] = None,
                      impl: str = "auto") -> torch.Tensor:
    """The modality projection (a SiLU MLP to the text width) and the
    perceiver resampler (``videoscore.py:400-445``): (N, S, C_vision) ->
    (N, n_latents, C_text).  Each layer's latents attend to the context and
    to themselves (16/4 heads of 96, plain torch, as JAX's ``impl="xla"``);
    ``context_mask`` (N, S), 1 = a real patch, keeps padded patches out."""
    eps = eps_override or cfg.rms_norm_eps
    x = _mlp_silu(p["modality_projection"], vision_hidden, impl)
    B = x.shape[0]
    n_lat = p["latents"].shape[0]
    latents = p["latents"][None].expand(B, -1, -1).to(x.dtype)
    Hq, Hkv, D = cfg.n_heads, cfg.num_key_value_heads, cfg.head_dim
    kv_mask = None
    if context_mask is not None:
        kv_mask = torch.cat([context_mask.to(torch.int32),
                             torch.ones((B, n_lat), dtype=torch.int32,
                                        device=x.device)], dim=1)
    for i in range(cfg.depth):
        lp = map_state(lambda a: a[i], p["layers"])
        ln_lat = rms_norm(latents, lp["ln_latents"]["weight"], eps=eps)
        ln_ctx = rms_norm(x, lp["ln_context"]["weight"], eps=eps)
        kv_in = torch.cat([ln_ctx, ln_lat], dim=1)
        nq, nkv = ln_lat.shape[1], kv_in.shape[1]
        q = dot(ln_lat, lp["q"]["kernel"], impl).reshape(B, nq, Hq, D)
        k = dot(kv_in, lp["k"]["kernel"], impl).reshape(B, nkv, Hkv, D)
        v = dot(kv_in, lp["v"]["kernel"], impl).reshape(B, nkv, Hkv, D)
        attn = multi_head_attention(q, k, v, attention_mask=kv_mask,
                                    causal=False, impl="plain")
        latents = latents + dot(attn.reshape(B, nq, Hq * D),
                                lp["o"]["kernel"], impl)
        h = rms_norm(latents, lp["ln_post"]["weight"], eps=eps)
        latents = latents + _mlp_silu(lp, h, impl)
    return rms_norm(latents, p["norm"]["weight"], eps=eps)


# ------------------------------------------------------------ full forward

def patch_mask_from_pixels(pixel_attention_mask: torch.Tensor,
                           patch_size: int) -> torch.Tensor:
    """(N, H, W) pixel mask -> (N, gh, gw) bool patch mask: a patch is real
    where any of its pixels is (transformers ``Idefics2Model.forward``'s
    unfold and sum > 0), cropped to whole patches as the tower crops the
    pixels (``videoscore.py:467-476``)."""
    P = patch_size
    N, Hp, Wp = pixel_attention_mask.shape
    gh, gw = Hp // P, Wp // P
    grid = pixel_attention_mask[:, :gh * P, :gw * P].reshape(N, gh, P, gw, P)
    return grid.to(torch.int32).sum(dim=(2, 4)) > 0


def videoscore_forward(
    params, cfg: VideoScoreConfig,
    pixel_values: torch.Tensor,  # (N_images, H, W, 3) NHWC, preprocessed
    input_ids: torch.Tensor,  # (B, T) with image_token_id runs
    attention_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
    pixel_attention_mask: Optional[torch.Tensor] = None,  # (N, H, W)
) -> torch.Tensor:
    """The Idefics2 forward -> (B, num_labels) fp32 regression logits
    (``videoscore.py:448-498``).  The image tokens are scattered at the
    ``image_token_id`` positions; the pooled row is the last token before
    the first pad id (the last token where there is none).
    ``pixel_attention_mask`` (1 = a real pixel, bottom/right zero padding)
    takes the variable-aspect path: its patch any-pool masks the tower's
    attention and position ids and the perceiver's context."""
    patch_mask = ctx_mask = None
    if pixel_attention_mask is not None:
        patch_mask = patch_mask_from_pixels(pixel_attention_mask,
                                            cfg.vision.patch_size)
        ctx_mask = patch_mask.reshape(patch_mask.shape[0], -1)
    vis = vision_forward(params["vision_model"], cfg.vision, pixel_values,
                         impl=impl, patch_attention_mask=patch_mask)
    img_tokens = connector_forward(params["connector"], cfg.perceiver, vis,
                                   context_mask=ctx_mask, impl=impl)
    text = params["text"]
    ids = input_ids.long()
    embeds = dec.embed_tokens(text, ids)
    embeds = scatter_image_embeds(embeds, ids, img_tokens, cfg.image_token_id)
    hidden = dec.decoder_forward(text, cfg.text, embeds,
                                 attention_mask=attention_mask, impl=impl,
                                 remat=False)
    T = ids.shape[-1]
    is_pad = (ids == cfg.text.pad_token_id).to(torch.int32)
    idx = (is_pad.argmax(dim=-1) - 1) % T
    pooled = hidden[torch.arange(ids.shape[0], device=ids.device), idx]
    return dot_f32(pooled, params["score"]["kernel"], impl)
