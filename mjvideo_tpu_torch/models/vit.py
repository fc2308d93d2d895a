"""InternViT encoder.

Counterpart of ``mjvideo_tpu/models/vit.py`` (reference
``modeling_intern_vit.py``) in eval mode (no dropout or DropPath).
Parameters keep the JAX layout: dense kernels ``(in, out)``, layers stacked
on a leading ``L`` axis, the patch kernel ``(P*P*3, C)`` in ``(ph, pw,
channel)`` order.  The patch embed is a reshape plus matmul over NHWC
pixels, not a convolution (a float32 convolution on the card would run in
TF32).  The token axis is not pre-padded: the attention kernel takes S =
1025 and masks its own tail.  The encoder is differentiable (the reward
gradient to the pixels, ``RewardScorer.score_fn``): each block is
rematerialised per ``remat`` (``ops/remat.py``), and its attention takes K1
with the lse and K4 nc when autograd needs them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..configs import VisionConfig

from ..ops.attention import multi_head_attention
from ..ops.matmul import dot, gelu
from ..ops.norms import layer_norm
from ..ops.remat import remat_wrap
from ..utils.bridge import map_state


def _check_supported(cfg: VisionConfig) -> None:
    """The port covers the InternViT-300M family (LayerNorm, no QK norm);
    the 6B family (RMSNorm + QK-RMSNorm) comes with the 26B judge."""
    if cfg.norm_type != "layer_norm" or cfg.qk_normalization:
        raise NotImplementedError(
            "InternViT-6B (rms_norm / qk_normalization) is not ported yet")


def init_vit_params(cfg: VisionConfig, *, generator: torch.Generator,
                    device: torch.device, dtype: torch.dtype):
    """Random ViT state with the JAX package's structure and scales."""
    _check_supported(cfg)
    C, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    P = cfg.patch_size
    n_pos = cfg.num_patches_per_side**2 + 1

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device) * 0.02
        return w.to(dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm_p():
        return {"weight": full((L, C), 1.0), "bias": full((L, C), 0.0)}

    qkv = {"kernel": dense(L, C, 3 * C)}
    if cfg.qkv_bias:
        qkv["bias"] = full((L, 3 * C), 0.0)
    attn = {"qkv": qkv,
            "proj": {"kernel": dense(L, C, C), "bias": full((L, C), 0.0)}}
    return {
        "embeddings": {
            "class_embedding": dense(1, 1, C),
            "patch_embedding": {"kernel": dense(P * P * 3, C),
                                "bias": full((C,), 0.0)},
            "position_embedding": dense(1, n_pos, C),
        },
        "layers": {
            "norm1": norm_p(),
            "norm2": norm_p(),
            "attn": attn,
            "mlp": {
                "fc1": {"kernel": dense(L, C, I), "bias": full((L, I), 0.0)},
                "fc2": {"kernel": dense(L, I, C), "bias": full((L, C), 0.0)},
            },
            "ls1": full((L, C), cfg.initializer_factor),
            "ls2": full((L, C), cfg.initializer_factor),
        },
    }


def patch_embed(p, pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NHWC pixels -> (N, gh*gw, C): the exact equivalent of Conv2d(k=s=P)."""
    N, H, W, _ = pixel_values.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = pixel_values.reshape(N, gh, P, gw, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(N, gh * gw, P * P * 3)
    return dot(x, p["kernel"]) + p["bias"]


def embeddings(p, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """Patch embed + cls token + position embeddings.

    Off the native grid the position grid is resized as the reference does
    (``modeling_intern_vit.py:133-174``): ``F.interpolate(mode="bicubic",
    align_corners=False)`` in fp32.  The JAX package uses
    ``jax.image.resize`` there instead (ROADMAP Queue 3, F1).
    """
    N, H, W, _ = pixel_values.shape
    patches = patch_embed(p["patch_embedding"], pixel_values, cfg.patch_size)
    cls = p["class_embedding"].to(patches.dtype).expand(N, 1, cfg.hidden_size)
    x = torch.cat([cls, patches], dim=1)

    pos = p["position_embedding"]
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    side = cfg.num_patches_per_side
    if (gh, gw) != (side, side):
        grid = pos[:, 1:, :].float().reshape(1, side, side, -1)
        grid = F.interpolate(grid.permute(0, 3, 1, 2), size=(gh, gw),
                             mode="bicubic", align_corners=False)
        grid = grid.reshape(1, -1, gh * gw).permute(0, 2, 1)
        pos = torch.cat([pos[:, :1, :].float(), grid], dim=1)
    return x + pos.to(x.dtype)


def _block(cfg: VisionConfig, p, x: torch.Tensor, impl: str,
           attention: Optional[Callable] = None) -> torch.Tensor:
    """One pre-norm block with LayerScale (``modeling_intern_vit.py:266-295``).

    ``attention(q, k, v)``, given the (B, S, H, D) views of the qkv product,
    returns (B, S, H, D) or (B, S, H * D); None takes the production
    attention, K1 through ``multi_head_attention(norm_bound=True)``.  The
    A/B harness (``tools/vit_layout_ab_torch.py``) swaps it to time this
    block with another kernel, as the JAX package's ``make_block_fn``
    (``benchmarks/vit_layout_ab.py:121``) does with a copy of the block."""
    B, S, C = x.shape
    H, D = cfg.num_attention_heads, cfg.head_dim

    eps = cfg.layer_norm_eps
    h = layer_norm(x, p["norm1"]["weight"], p["norm1"]["bias"], eps=eps)
    qkv = dot(h, p["attn"]["qkv"]["kernel"], impl)
    if "bias" in p["attn"]["qkv"]:
        qkv = qkv + p["attn"]["qkv"]["bias"]
    # Views into qkv: the kernel takes the token stride as it is.
    q, k, v = (t.view(B, S, H, D) for t in qkv.split(C, dim=-1))
    if attention is None:
        # The bound kernel K1, as the JAX ViT takes it (vit.py _NC_BOUND).
        attn = multi_head_attention(q, k, v, causal=False, impl=impl,
                                    norm_bound=True)
    else:
        attn = attention(q, k, v)
    attn = dot(attn.reshape(B, S, C), p["attn"]["proj"]["kernel"], impl)
    x = x + (attn + p["attn"]["proj"]["bias"]) * p["ls1"]

    h = layer_norm(x, p["norm2"]["weight"], p["norm2"]["bias"], eps=eps)
    h = dot(h, p["mlp"]["fc1"]["kernel"], impl) + p["mlp"]["fc1"]["bias"]
    h = gelu(h)
    h = dot(h, p["mlp"]["fc2"]["kernel"], impl) + p["mlp"]["fc2"]["bias"]
    return x + h * p["ls2"]


def vit_forward(params, cfg: VisionConfig, pixel_values: torch.Tensor,
                select_layer: int = -1, impl: str = "auto",
                remat=True) -> torch.Tensor:
    """Hidden states (N, S, C) after ``select_layer``; layers past it are
    never computed (``vit.py:257-261``).  ``remat`` as in the JAX
    ``vit_forward`` (``vit.py:288-291``): each block is checkpointed when
    autograd records it.  The stacked ``[L, ...]`` layer tensors are unbound
    once, so their gradient is one stack of the per-layer gradients."""
    _check_supported(cfg)
    x = embeddings(params["embeddings"], cfg, pixel_values)
    L = cfg.num_hidden_layers
    n_run = L if select_layer == -1 else L + select_layer + 1
    block = remat_wrap(lambda layer, x: _block(cfg, layer, x, impl), remat)
    layers = map_state(lambda a: a.unbind(0), params["layers"])
    for i in range(n_run):
        x = block(map_state(lambda a: a[i], layers), x)
    return x
