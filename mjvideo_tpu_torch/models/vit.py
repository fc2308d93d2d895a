"""InternViT encoder.

Counterpart of ``mjvideo_tpu/models/vit.py`` (reference
``modeling_intern_vit.py``), for both checkpoint families: InternViT-300M (LayerNorm, no QK norm, heads of
64) and InternViT-6B (RMSNorm and QK-RMSNorm over the whole width, 25
heads of 128), chosen by ``norm_type`` and ``qk_normalization``.
Parameters keep the JAX layout: dense kernels ``(in, out)``, layers stacked
on a leading ``L`` axis, the patch kernel ``(P*P*3, C)`` in ``(ph, pw,
channel)`` order.  The patch embed is a reshape plus matmul over NHWC
pixels, not a convolution (a float32 convolution on the card would run in
TF32).  The token axis is not pre-padded: the attention kernel takes S =
1025 and masks its own tail.  The encoder is differentiable (the reward
gradient to the pixels, ``RewardScorer.score_fn``): each block is
rematerialised per ``remat`` (``ops/remat.py``), and its attention takes K1
with the lse and K4 nc when autograd needs them (at D = 64; the 6B's heads
of 128 run forward only).

Training noise (``vit_forward(rng=)``): DropPath on both residual branches
at the per-layer rates ``linspace(0, drop_path_rate, L)`` and dropout on
the attention projection's output (JAX ``vit.py:143-220``).  The port
cannot draw JAX's threefry bits, so a ``NoiseKey`` stands in for JAX's
keys: each tile's mask is drawn from a generator seeded afresh from (base
seed, step, video, layer, branch, global tile index), a pure function of
them.  So the tile-sharded tower draws the whole tower's masks, a resumed
run draws an unbroken one's, and a rematerialised layer's recompute draws
its first forward's (``torch.utils.checkpoint`` restores the global RNG
state, not an explicit generator's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import VisionConfig

from ..ops.attention import multi_head_attention
from ..ops.matmul import dot, gelu
from ..ops.norms import layer_norm, rms_norm
from ..ops.remat import remat_wrap
from ..parallel.mesh import (
    held,
    model_axis,
    pair_forward,
    row_dot,
    row_dot_over_model,
    sub,
)
from ..utils.bridge import map_state


def _norm(cfg: VisionConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The block's pre-norm: RMSNorm (weight only) for the 6B family,
    LayerNorm for the 300M (``vit.py:37-40``)."""
    if cfg.norm_type == "rms_norm":
        return rms_norm(x, p["weight"], eps=cfg.layer_norm_eps)
    return layer_norm(x, p["weight"], p["bias"], eps=cfg.layer_norm_eps)


def init_vit_params(cfg: VisionConfig, *, generator: torch.Generator,
                    device: torch.device, dtype: torch.dtype):
    """Random ViT state with the JAX package's structure and scales: under
    ``rms_norm`` the norms have no bias, under ``qk_normalization`` the
    attention has ``q_norm`` and ``k_norm`` weights, and without
    ``qkv_bias`` the qkv product has no bias (``vit.py:43-93``).  The
    random draws are the same for either family."""
    C, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    P = cfg.patch_size
    n_pos = cfg.num_patches_per_side**2 + 1

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device) * 0.02
        return w.to(dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm_p():
        if cfg.norm_type == "rms_norm":
            return {"weight": full((L, C), 1.0)}
        return {"weight": full((L, C), 1.0), "bias": full((L, C), 0.0)}

    qkv = {"kernel": dense(L, C, 3 * C)}
    if cfg.qkv_bias:
        qkv["bias"] = full((L, 3 * C), 0.0)
    attn = {"qkv": qkv,
            "proj": {"kernel": dense(L, C, C), "bias": full((L, C), 0.0)}}
    if cfg.qk_normalization:
        attn["q_norm"] = {"weight": full((L, C), 1.0)}
        attn["k_norm"] = {"weight": full((L, C), 1.0)}
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


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


@dataclass(frozen=True)
class NoiseKey:
    """The key of the ViT's training noise: a base seed, a path of ints
    folded into it (the port's ``jax.random.fold_in``: the step, the video,
    the layer, the branch) and the global index of the first tile of the
    batch it draws for.  ``generator(device, b)`` is a generator seeded
    from all of them and tile ``tile0 + b``: a pure function of the key,
    made afresh at each draw."""

    seed: int = 0
    path: Tuple[int, ...] = ()
    tile0: int = 0

    def fold_in(self, *ids: int) -> "NoiseKey":
        return NoiseKey(self.seed, self.path + tuple(int(i) for i in ids),
                        self.tile0)

    def starting_at(self, tile0: int) -> "NoiseKey":
        """The same key for a batch whose first tile is global ``tile0``."""
        return NoiseKey(self.seed, self.path, int(tile0))

    def generator(self, device, b: int) -> torch.Generator:
        h = 0
        for i in (self.seed,) + self.path + (self.tile0 + b,):
            h = _splitmix64(h ^ (i & _M64))
        return torch.Generator(device=device).manual_seed(h >> 1)


def _bernoulli(key: NoiseKey, keep: float, shape, device) -> torch.Tensor:
    """(B, ...) bools, True with probability ``keep``; tile b's from its own
    generator (``jax.random.bernoulli``: uniform < p)."""
    return torch.stack([
        torch.rand(tuple(shape[1:]), generator=key.generator(device, b),
                   device=device) < keep for b in range(shape[0])])


def _scaled(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """x / keep where ``mask``, else 0, in fp32 (a true division: a CUDA
    division by a Python number multiplies by its reciprocal)."""
    keep_t = x.new_full((), keep, dtype=torch.float32)
    return torch.where(mask, x.float() / keep_t, 0.0).to(x.dtype)


def _drop_path(x: torch.Tensor, rate: float, key: NoiseKey) -> torch.Tensor:
    """Stochastic depth on a residual branch (timm DropPath,
    ``modeling_intern_vit.py:280-281``; JAX ``vit.py:143-149``): each tile
    kept with probability 1 - rate and scaled by 1 / (1 - rate) in fp32."""
    keep = float(np.float32(1.0) - np.float32(rate))
    return _scaled(x, _bernoulli(key, keep, (x.shape[0], 1, 1), x.device),
                   keep)


def _dropout(x: torch.Tensor, rate: float, key: NoiseKey) -> torch.Tensor:
    """Elementwise dropout (JAX ``vit.py:152-155``)."""
    keep = float(np.float32(1.0) - np.float32(rate))
    return _scaled(x, _bernoulli(key, keep, tuple(x.shape), x.device), keep)


def drop_path_rates(rate: float, L: int) -> np.ndarray:
    """The per-layer DropPath rates of the full depth in fp32, as the
    reference computes them: ``torch.linspace(0, rate, L)``
    (``modeling_intern_vit.py:312``).  JAX's ``jnp.linspace`` agrees to
    an ulp (tests/test_torch_vit_noise.py)."""
    return torch.linspace(0.0, rate, L, dtype=torch.float32).numpy()


def split_rms_norm(tp, xs, weights, eps: float, width: int):
    """``rms_norm`` over a width whose columns the held model ranks hold
    in parts: each rank's sum of squares in fp32, summed over the model
    axis (``Mesh.sum_over_model``), then each rank's columns scaled by its
    slice of the whole ``weight`` (rank j of n holds columns [j w / n,
    (j + 1) w / n)).  ``xs``: the held ranks' parts, in rank order."""
    ss = [x.float().square().sum(-1, keepdim=True) for x in xs]
    inv = torch.rsqrt(tp.sum_over_model(ss) / width + eps)
    out = []
    for j, x, w in zip(tp.model_ranks, xs, weights):
        n = x.shape[-1]
        wj = w[..., j * n:(j + 1) * n]
        out.append((wj * (x.float() * inv).to(x.dtype)).to(x.dtype))
    return out


def _attention(cfg: VisionConfig, ps, h: torch.Tensor, impl: str,
               attention: Optional[Callable], mesh) -> torch.Tensor:
    """The attention branch before the projection's bias: qkv, the
    attention, the projection.  ``ps``: the held model ranks' layer states.
    Split over the model axis (``parallel/mesh.py``), each rank runs its
    own heads of q, k and v (column-parallel), then every held rank's rows
    of the projection at once (row-parallel, ``row_dot_over_model``): the
    partials summed over the model axis, rounded once.  The QK-norm (the
    6B family) normalises q and k over the whole width: split, its
    statistics are summed over the model axis (``split_rms_norm``)."""
    B, S, C = h.shape
    D = cfg.head_dim
    tp = model_axis(mesh)
    split = tp is not None and ps[0]["attn"]["qkv"]["kernel"].shape[-1] != 3 * C
    qkvs = []
    for pj, hj in zip(ps, tp.copy_to_model(h) if split else [h]):
        a = pj["attn"]
        qkv = dot(hj, a["qkv"]["kernel"], impl)
        if "bias" in a["qkv"]:
            qkv = qkv + a["qkv"]["bias"]
        qkvs.append(list(qkv.split(qkv.shape[-1] // 3, dim=-1)))
    if cfg.qk_normalization:
        eps = cfg.layer_norm_eps
        for i, name in ((0, "q_norm"), (1, "k_norm")):
            ws = [pj["attn"][name]["weight"] for pj in ps]
            if split:
                normed = split_rms_norm(tp, [t[i] for t in qkvs], ws, eps, C)
            else:
                normed = [rms_norm(qkvs[0][i], ws[0], eps=eps)]
            for t, n in zip(qkvs, normed):
                t[i] = n
    outs = []
    for pj, (q, k, v) in zip(ps, qkvs):
        Cj = q.shape[-1]
        # Views: the kernel takes the token stride as it is.
        q, k, v = (t.view(B, S, Cj // D, D) for t in (q, k, v))
        if attention is None:
            # The bound kernel K1, as the JAX ViT takes it (vit.py
            # _NC_BOUND).
            o = multi_head_attention(q, k, v, causal=False, impl=impl,
                                     norm_bound=True)
        else:
            o = attention(q, k, v)
        outs.append(o.reshape(B, S, Cj))
    if not split:
        return dot(outs[0], ps[0]["attn"]["proj"]["kernel"], impl)
    return row_dot_over_model(tp, outs, [pj["attn"]["proj"]["kernel"]
                                         for pj in ps], impl).to(h.dtype)


def _mlp(cfg: VisionConfig, ps, h: torch.Tensor, impl: str,
         mesh) -> torch.Tensor:
    """fc1 -> GELU -> fc2 before fc2's bias; split over the model axis,
    fc1 column-parallel and fc2 row-parallel as in ``_attention``."""
    tp = model_axis(mesh)
    split = (tp is not None and ps[0]["mlp"]["fc1"]["kernel"].shape[-1]
             != cfg.intermediate_size)

    def body(pj, x, split):
        m = pj["mlp"]
        y = gelu(dot(x, m["fc1"]["kernel"], impl) + m["fc1"]["bias"])
        return row_dot(y, m["fc2"]["kernel"], split, impl)

    return pair_forward(tp, ps, h, split, body)


def _block(cfg: VisionConfig, p, x: torch.Tensor, impl: str,
           attention: Optional[Callable] = None,
           noise: Optional[Tuple[float, NoiseKey]] = None,
           mesh=None) -> torch.Tensor:
    """One pre-norm block with LayerScale (``modeling_intern_vit.py:266-295``).

    ``attention(q, k, v)``, given the (B, S, H, D) views of the qkv product,
    returns (B, S, H, D) or (B, S, H * D); None takes the production
    attention, K1 through ``multi_head_attention(norm_bound=True)``.  The
    A/B harness (``tools/vit_layout_ab_torch.py``) swaps it to time this
    block with another kernel, as the JAX package's ``make_block_fn``
    (``benchmarks/vit_layout_ab.py:121``) does with a copy of the block.
    Under ``qk_normalization`` (the 6B family) q and k are RMS-normalised
    over the whole (B, S, C) width before the head split
    (``modeling_intern_vit.py:215-218``): they are then dense, and v stays
    a view into qkv.  ``noise=(dp_rate, key)``: training mode, dropout on
    the attention projection's output (``cfg.dropout``,
    ``modeling_intern_vit.py:198``) before LayerScale, and DropPath at this
    layer's ``dp_rate`` on both residual branches; None: eval.

    ``mesh`` (``parallel.mesh.Mesh``) with a model axis above 1: ``p`` is
    the list of the held model ranks' layer states (``shard_params``), and
    the attention and the MLP run split where their pair was split; the
    norms, biases, LayerScale and noise act on the whole width after the
    reduction."""
    ps = held(p)
    p = ps[0]
    h = _norm(cfg, p["norm1"], x)
    attn = _attention(cfg, ps, h, impl, attention, mesh)
    attn = attn + p["attn"]["proj"]["bias"]
    if noise is not None:
        rate, key = noise
        if cfg.dropout > 0.0:
            attn = _dropout(attn, cfg.dropout, key.fold_in(2))
        x = x + _drop_path(attn * p["ls1"], rate, key.fold_in(0))
    else:
        x = x + attn * p["ls1"]

    h = _norm(cfg, p["norm2"], x)
    h = _mlp(cfg, ps, h, impl, mesh) + p["mlp"]["fc2"]["bias"]
    if noise is not None:
        return x + _drop_path(h * p["ls2"], rate, key.fold_in(1))
    return x + h * p["ls2"]


def vit_forward(params, cfg: VisionConfig, pixel_values: torch.Tensor,
                select_layer: int = -1, impl: str = "auto",
                remat=True, rng: Optional[NoiseKey] = None,
                mesh=None) -> torch.Tensor:
    """Hidden states (N, S, C) after ``select_layer``; layers past it are
    never computed (``vit.py:257-261``).  ``remat`` as in the JAX
    ``vit_forward`` (``vit.py:288-291``): each block is checkpointed when
    autograd records it.  The stacked ``[L, ...]`` layer tensors are unbound
    once, so their gradient is one stack of the per-layer gradients.

    ``rng`` set (a ``NoiseKey``) with a DropPath or dropout rate above 0:
    training mode, layer i drawing from ``rng.fold_in(i)`` at its rate from
    the full depth's schedule (so a cut tower keeps each layer's rate);
    ``attention_dropout`` above 0 raises, as in JAX (the fused kernels
    have no dropout on the probabilities).  None: eval.

    ``mesh``: ``params`` is the list of the held model ranks' states
    (``parallel.mesh.shard_params``) and each block runs split
    (``_block``)."""
    x = embeddings(held(params)[0]["embeddings"], cfg, pixel_values)
    L = cfg.num_hidden_layers
    n_run = L if select_layer == -1 else L + select_layer + 1
    rates = None
    if rng is not None and (cfg.drop_path_rate > 0.0 or cfg.dropout > 0.0):
        if cfg.attention_dropout > 0.0:
            raise ValueError(
                "attention_dropout > 0 is not supported by the fused "
                "attention kernels; published InternViT configs use 0.0")
        rates = drop_path_rates(cfg.drop_path_rate, L)
    block = remat_wrap(
        lambda layer, x, noise: _block(cfg, layer, x, impl, noise=noise,
                                       mesh=mesh), remat)
    layers = [map_state(lambda a: a.unbind(0), t)
              for t in held(sub(params, "layers"))]
    for i in range(n_run):
        noise = None if rates is None else (float(rates[i]), rng.fold_in(i))
        layer = [map_state(lambda a: a[i], t) for t in layers]
        x = block(layer if isinstance(params, list) else layer[0], x, noise)
    return x
