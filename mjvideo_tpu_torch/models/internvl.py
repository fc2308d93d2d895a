"""InternVL fusion: ViT -> pixel-shuffle -> projector -> decoder.

Counterpart of ``mjvideo_tpu/models/internvl.py`` (reference
``modeling_internvl_chat.py``) on the scoring path.  The ``<IMG_CONTEXT>``
scatter is a cumsum-indexed gather plus ``where``: static shapes and no
host-device synchronisation, unlike a boolean-indexed assignment.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs import ChatConfig

from ..ops.matmul import dot, gelu
from ..ops.norms import layer_norm
from ..ops.pixel_shuffle import pixel_shuffle
from . import decoder as dec
from .vit import init_vit_params, vit_forward


def init_projector_params(cfg: ChatConfig, *, generator: torch.Generator,
                          device: torch.device, dtype: torch.dtype):
    """mlp1: LayerNorm -> Linear -> GELU -> Linear
    (``modeling_internvl_chat.py:135-140``)."""
    vit_h = cfg.vision.hidden_size * int(1 / cfg.downsample_ratio) ** 2
    llm_h = cfg.llm.hidden_size

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device) * 0.02
        return w.to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    return {
        "norm": {"weight": full(vit_h, 1.0), "bias": full(vit_h, 0.0)},
        "fc1": {"kernel": dense(vit_h, llm_h), "bias": full(llm_h, 0.0)},
        "fc2": {"kernel": dense(llm_h, llm_h), "bias": full(llm_h, 0.0)},
    }


def init_chat_params(cfg: ChatConfig, *, generator: torch.Generator,
                     device: torch.device, dtype: torch.dtype,
                     with_lm_head: bool = False):
    """Random chat state; ``with_lm_head`` for generation (the judge)."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "vision_model": init_vit_params(cfg.vision, **kw),
        "mlp1": init_projector_params(cfg, **kw),
        "language_model": dec.init_decoder_params(
            cfg.llm, with_lm_head=with_lm_head, **kw),
    }


def apply_projector(p, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    h = layer_norm(x, p["norm"]["weight"], p["norm"]["bias"], eps=1e-5)
    h = dot(h, p["fc1"]["kernel"], impl) + p["fc1"]["bias"]
    h = gelu(h)
    return dot(h, p["fc2"]["kernel"], impl) + p["fc2"]["bias"]


def extract_feature(params, cfg: ChatConfig, pixel_values: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """ViT -> drop cls -> grid -> pixel_shuffle -> projector
    (``modeling_internvl_chat.py:244-262``); (tiles, num_image_token, C)."""
    vit_out = vit_forward(params["vision_model"], cfg.vision, pixel_values,
                          select_layer=cfg.select_layer, impl=impl)
    vit_embeds = vit_out[:, 1:, :]  # drop cls
    n, s, c = vit_embeds.shape
    hw = int(s**0.5)
    vit_embeds = pixel_shuffle(vit_embeds.reshape(n, hw, hw, c),
                               scale_factor=cfg.downsample_ratio,
                               ps_version=cfg.ps_version)
    vit_embeds = vit_embeds.reshape(n, -1, vit_embeds.shape[-1])
    return apply_projector(params["mlp1"], vit_embeds, impl)


def scatter_image_embeds(
    input_embeds: torch.Tensor,  # (B, T, C)
    input_ids: torch.Tensor,  # (B, T)
    vit_embeds: torch.Tensor,  # (P, n_tok, C)
    img_context_token_id: int,
) -> torch.Tensor:
    """The k-th ``<IMG_CONTEXT>`` position (row-major over B*T) receives the
    k-th ViT token, as ``input_embeds[selected] = vit_embeds`` does at
    ``modeling_internvl_chat.py:176-186``."""
    B, T, C = input_embeds.shape
    selected = input_ids.reshape(B * T) == img_context_token_id
    vit_flat = vit_embeds.reshape(-1, C).to(input_embeds.dtype)
    idx = torch.cumsum(selected.to(torch.int32), dim=0) - 1
    idx = idx.clamp(0, vit_flat.shape[0] - 1)
    gathered = vit_flat[idx]
    out = torch.where(selected[:, None], gathered,
                      input_embeds.reshape(B * T, C))
    return out.reshape(B, T, C)


def chat_forward(
    params,
    cfg: ChatConfig,
    pixel_values: torch.Tensor,  # (P, H, W, 3)
    input_ids: torch.Tensor,  # (B, T)
    attention_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
    img_context_token_id: Optional[int] = None,
    remat=True,
) -> torch.Tensor:
    """Final decoder hidden states (B, T, C); the LM head is skipped, since
    the reward path reads hidden states only.  ``remat`` applies to the
    decoder layers; the ViT and projector are frozen in every training stage
    and build no autograd graph, so they have nothing to rematerialise."""
    input_embeds = dec.embed_tokens(params["language_model"], input_ids)
    vit_embeds = extract_feature(params, cfg, pixel_values, impl=impl)
    if img_context_token_id is None:
        img_context_token_id = cfg.img_context_token_id
    input_embeds = scatter_image_embeds(input_embeds, input_ids, vit_embeds,
                                        img_context_token_id)
    return dec.decoder_forward(params["language_model"], cfg.llm,
                               input_embeds, attention_mask=attention_mask,
                               impl=impl, remat=remat)
