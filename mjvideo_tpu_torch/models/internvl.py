"""InternVL fusion: ViT -> pixel-shuffle -> projector -> decoder.

Counterpart of ``mjvideo_tpu/models/internvl.py`` (reference
``modeling_internvl_chat.py``) on the scoring path.  The ``<IMG_CONTEXT>``
scatter is a cumsum-indexed gather plus ``where``: static shapes and no
host-device synchronisation, unlike a boolean-indexed assignment.  Under
``sp`` (sequence parallelism) the ViT encodes each shard's slice of the
tiles and the embeds are gathered before the scatter; in a distributed
group each process then scatters and decodes its own rows only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs import ChatConfig

from ..ops.matmul import dot, gelu
from ..ops.norms import layer_norm
from ..ops.pixel_shuffle import pixel_shuffle
from ..parallel.mesh import held, model_axis, sub
from ..parallel.sequence import shard_sequence
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
                    impl: str = "auto", remat=True, sp=None,
                    vit_rng=None, mesh=None) -> torch.Tensor:
    """ViT -> drop cls -> grid -> pixel_shuffle -> projector
    (``modeling_internvl_chat.py:244-262``); (tiles, num_image_token, C).
    ``remat`` applies to the ViT blocks.  ``sp``: the tiles shard over the
    sequence group (``_sp_extract_feature``).  ``vit_rng`` (a
    ``vit.NoiseKey``): the ViT's training noise, each tile's keyed by its
    global index, so the sharded tower draws the whole tower's masks (the
    JAX package falls back to the whole tower there,
    ``internvl.py:97-100``).  ``mesh``: ``params`` is the list of the held
    model ranks' states and the ViT runs split (``vit_forward``); the
    projector ``mlp1`` is replicated (no rule matches it)."""
    if sp is not None and sp["group"].size > 1:
        return _sp_extract_feature(params, cfg, pixel_values, impl, remat,
                                   sp["group"], vit_rng, mesh)
    return _tile_features(params, cfg, pixel_values, impl, remat, vit_rng,
                          mesh)


def _sp_extract_feature(params, cfg: ChatConfig, pixel_values, impl, remat,
                        group, vit_rng=None, mesh=None):
    """The tile-sharded vision tower (JAX ``internvl.py:102-136``): the
    tile axis padded with zero tiles to a multiple of n, each shard's slice
    encoded (K1 on its own tiles), the embeds gathered and the pad
    dropped.  Tiles attend only within themselves, so this splits the
    tower's work n ways."""
    n, n_tiles = group.size, pixel_values.shape[0]
    pad = (-n_tiles) % n
    if pad:
        pixel_values = torch.cat([pixel_values, pixel_values.new_zeros(
            (pad,) + tuple(pixel_values.shape[1:]))])
    held = shard_sequence(pixel_values, group, dim=0)
    first = group.held_rows(held.shape[0])[0]
    parts = []
    for pix in group.split(held, dim=0):
        key = None if vit_rng is None else vit_rng.starting_at(first)
        parts.append(_tile_features(params, cfg, pix, impl, remat, key,
                                    mesh))
        first += pix.shape[0]
    emb = group.join(parts, dim=0)
    return group.gather(emb, dim=0)[:n_tiles]


def _tile_features(params, cfg: ChatConfig, pixel_values, impl, remat,
                   rng=None, mesh=None):
    """The per-tile pipeline shared by the plain and the sharded tower."""
    vit_out = vit_forward(sub(params, "vision_model"), cfg.vision,
                          pixel_values, select_layer=cfg.select_layer,
                          impl=impl, remat=remat, rng=rng, mesh=mesh)
    vit_embeds = vit_out[:, 1:, :]  # drop cls
    n, s, c = vit_embeds.shape
    hw = int(s**0.5)
    vit_embeds = pixel_shuffle(vit_embeds.reshape(n, hw, hw, c),
                               scale_factor=cfg.downsample_ratio,
                               ps_version=cfg.ps_version)
    vit_embeds = vit_embeds.reshape(n, -1, vit_embeds.shape[-1])
    return apply_projector(held(params)[0]["mlp1"], vit_embeds, impl)


def scatter_image_embeds(
    input_embeds: torch.Tensor,  # (B, T, C)
    input_ids: torch.Tensor,  # (B, T)
    vit_embeds: torch.Tensor,  # (P, n_tok, C)
    img_context_token_id: int,
    first_row: int = 0,
) -> torch.Tensor:
    """The k-th ``<IMG_CONTEXT>`` position (row-major over B*T) receives the
    k-th ViT token, as ``input_embeds[selected] = vit_embeds`` does at
    ``modeling_internvl_chat.py:176-186``.  ``input_embeds`` may hold only
    the rows [first_row, first_row + S) of the whole prompt ``input_ids``
    (B, T) (one shard's rows): the count runs over the whole prompt, and
    only those rows are written."""
    B, S, C = input_embeds.shape
    T = input_ids.shape[1]
    selected = input_ids.reshape(B * T) == img_context_token_id
    vit_flat = vit_embeds.reshape(-1, C).to(input_embeds.dtype)
    idx = torch.cumsum(selected.to(torch.int32), dim=0) - 1
    idx = idx.clamp(0, vit_flat.shape[0] - 1)
    rows = slice(first_row, first_row + S)
    idx = idx.reshape(B, T)[:, rows].reshape(B * S)
    selected = selected.reshape(B, T)[:, rows].reshape(B * S)
    gathered = vit_flat[idx]
    out = torch.where(selected[:, None], gathered,
                      input_embeds.reshape(B * S, C))
    return out.reshape(B, S, C)


def embed_prompt(lm, input_ids: torch.Tensor,
                 img_context_token_id: int, mesh=None,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Token embeds of a prompt whose ``<IMG_CONTEXT>`` slots the vision
    embeds then overwrite.  A config's IMG_CONTEXT id may lie past the
    decoder's vocabulary (the 4B preset keeps 92546 against Phi-3's 32,064
    rows); JAX's gather clamps it to the last row, and so does this, for
    those slots only: any other id out of range still raises.  Under a
    model axis the table's rows may be split (``vocab_size`` whole,
    ``decoder.embed_tokens``)."""
    V = held(lm)[0]["tok_embeddings"].shape[0]
    if model_axis(mesh) is not None and vocab_size is not None:
        V = vocab_size
    if img_context_token_id >= V:
        input_ids = torch.where(input_ids == img_context_token_id, V - 1,
                                input_ids)
    return dec.embed_tokens(lm, input_ids, mesh, vocab_size)


def chat_forward(
    params,
    cfg: ChatConfig,
    pixel_values: torch.Tensor,  # (P, H, W, 3)
    input_ids: torch.Tensor,  # (B, T)
    attention_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
    img_context_token_id: Optional[int] = None,
    remat=True,
    sp=None,
    vit_rng=None,
    mesh=None,
) -> torch.Tensor:
    """Final decoder hidden states (B, T, C); the LM head is skipped, since
    the reward path reads hidden states only.  ``remat`` applies to the ViT
    blocks and the decoder layers.  The ViT and projector are frozen in every
    training stage, so there they build no autograd graph and nothing is
    rematerialised; with pixels that need a gradient (``score_fn``) the
    whole stack records one, back to the pixels.

    ``sp={"group": SequenceGroup, "kind": "ring" | "allgather"}`` (JAX
    ``internvl.py:215-222``): the tiles shard over the group and the
    decoder runs sequence-parallel.  ``input_ids`` and ``attention_mask``
    are the whole prompt's (B, T) in either form of the group; in a
    distributed group the result holds this rank's T/n rows.  ``vit_rng``:
    the ViT's training noise (``extract_feature``).  ``mesh`` (a
    ``parallel.mesh.Mesh``): ``params`` is the list of the held model
    ranks' states, the ViT and the decoder run their split pairs over the
    model axis."""
    held_ids, first = input_ids, 0
    if sp is not None:
        held_ids = shard_sequence(input_ids, sp["group"])
        first = sp["group"].held_rows(held_ids.shape[1])[0]
        if attention_mask is not None:
            attention_mask = shard_sequence(attention_mask, sp["group"])
    if img_context_token_id is None:
        img_context_token_id = cfg.img_context_token_id
    lm = sub(params, "language_model")
    input_embeds = embed_prompt(lm, held_ids, img_context_token_id, mesh,
                                cfg.llm.vocab_size)
    vit_embeds = extract_feature(params, cfg, pixel_values, impl=impl,
                                 remat=remat, sp=sp, vit_rng=vit_rng,
                                 mesh=mesh)
    input_embeds = scatter_image_embeds(input_embeds, input_ids, vit_embeds,
                                        img_context_token_id, first)
    return dec.decoder_forward(lm, cfg.llm, input_embeds,
                               attention_mask=attention_mask, impl=impl,
                               remat=remat, sp=sp, mesh=mesh)
