"""MoE-structured video reward model.

Counterpart of ``mjvideo_tpu/models/reward.py`` (reference
``scripts/model/moe_reward.py``): last-non-pad pooling, the 28-criteria
regression, both gating MLPs and the per-aspect grouped softmax.  The head
runs in fp32 whatever the backbone dtype.  The gating position comes from
the host (``data.prompts.find_gating_position``).  Both gather indices are
brought into range first, as JAX's gathers do (a negative index counts from
the end, then ``mode="clip"``): an index out of range on the card would be
a device-side assert.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from mjvideo_tpu.configs import RewardConfig

from ..ops.matmul import dot, dot_f32
from ..utils.bridge import map_state
from .internvl import chat_forward, init_chat_params


class RewardOutput(NamedTuple):
    """Functional equivalent of ``CustomOutput`` (``moe_reward.py:60-89``)."""

    rewards: torch.Tensor  # (B, num_objectives)
    hidden_state: torch.Tensor  # (B, hidden) pooled last-non-pad hidden
    prompt_embedding: torch.Tensor  # (B, hidden) at the gating token
    criteria_gating_output: torch.Tensor  # (B, num_objectives) pre-softmax
    aspect_gating_output: torch.Tensor  # (B, num_aspects) softmaxed gate
    aspect_weights: torch.Tensor  # (B, num_objectives) grouped-softmax weights
    aspect_scores: torch.Tensor  # (B, num_aspects)
    score: torch.Tensor  # (B,)


def init_gating_params(in_features: int, out_features: int, hidden_dim: int,
                       n_hidden: int, *, generator: torch.Generator,
                       device: torch.device, dtype: torch.dtype):
    """n_hidden ReLU layers + a linear head + ``logit_scale``
    (``moe_reward.py:16-27``)."""
    layers = {}
    fan_in = in_features
    for i in range(n_hidden + 1):
        fan_out = hidden_dim if i < n_hidden else out_features
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=device) * 0.02
        layers[f"layer_{i}"] = {
            "kernel": w.to(dtype),
            "bias": torch.zeros((fan_out,), dtype=dtype, device=device),
        }
        fan_in = fan_out
    layers["logit_scale"] = torch.ones((1,), dtype=dtype, device=device)
    return layers


def init_reward_params(cfg: RewardConfig, *, generator: torch.Generator,
                       device: torch.device, dtype: torch.dtype):
    """Random reward-model state, built directly on ``device``."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    C = cfg.hidden_size
    reg = torch.randn((C, cfg.num_objectives), generator=generator,
                      device=device) * 0.02
    return {
        "model": init_chat_params(cfg.chat, **kw),
        "regression_layer": {"kernel": reg.to(dtype)},
        # Frozen identity, kept for checkpoint parity (moe_reward.py:163-166).
        "reward_transform_matrix": torch.eye(cfg.num_objectives, dtype=dtype,
                                             device=device),
        "aspect_gating": init_gating_params(
            C, cfg.num_aspects, cfg.gating_hidden_dim, cfg.gating_n_hidden,
            **kw),
        "criteria_gating": init_gating_params(
            C, cfg.num_objectives, cfg.gating_hidden_dim,
            cfg.gating_n_hidden, **kw),
    }


def gating_mlp(p, x: torch.Tensor, n_hidden: int) -> torch.Tensor:
    """ReLU on all but the last layer (``forward_wo_softmax``)."""
    for i in range(n_hidden + 1):
        lp = p[f"layer_{i}"]
        x = dot(x, lp["kernel"]) + lp["bias"]
        if i < n_hidden:
            x = torch.relu(x)
    return x


def gating_forward(p, x: torch.Tensor, temperature: float,
                   n_hidden: int) -> torch.Tensor:
    """MLP -> softmax(x / T) * logit_scale (``moe_reward.py:29-35``)."""
    logits = gating_mlp(p, x, n_hidden)
    return torch.softmax(logits / temperature, dim=-1) * p["logit_scale"][0]


def pool_last_non_pad(hidden: torch.Tensor, input_ids: torch.Tensor,
                      pad_token_id: int) -> torch.Tensor:
    """Hidden state of the last non-pad token: ``argmax(ids == pad) - 1
    (mod T)``.  argmax returns the first maximal index, so a row with no pad
    wraps to T - 1, as in the reference (``moe_reward.py:224-237``)."""
    B, T = input_ids.shape
    first_pad = torch.argmax((input_ids == pad_token_id).to(torch.int32), -1)
    idx = ((first_pad - 1) % T).clamp(0, T - 1)
    return hidden[torch.arange(B, device=hidden.device), idx]


def _columns(x: torch.Tensor, cols: Sequence[int]) -> torch.Tensor:
    """x[:, cols] as a slice when ``cols`` is a contiguous run (the
    published routing table), so no index tensor is copied to the device."""
    lo = cols[0]
    if tuple(cols) == tuple(range(lo, lo + len(cols))):
        return x[:, lo:lo + len(cols)]
    return x[:, torch.tensor(cols, device=x.device)]


def reward_head(
    params, cfg: RewardConfig,
    hidden: torch.Tensor,  # (B, T, C) final backbone hidden states
    input_ids: torch.Tensor,  # (B, T)
    gating_pos: torch.Tensor,  # (B,) host-computed gating-token index
) -> RewardOutput:
    """The reward head (``moe_reward.py:211-297``), in fp32."""
    B, T = input_ids.shape
    pooled = pool_last_non_pad(hidden, input_ids,
                               cfg.chat.llm.pad_token_id).float()
    rewards = dot_f32(pooled, params["regression_layer"]["kernel"])
    rewards = dot_f32(rewards, params["reward_transform_matrix"])

    gpos = gating_pos.long()
    gpos = torch.where(gpos < 0, gpos + T, gpos).clamp(0, T - 1)
    prompt_embedding = hidden[torch.arange(B, device=hidden.device),
                              gpos].float()

    ag = map_state(lambda a: a.float(), params["aspect_gating"])
    cg = map_state(lambda a: a.float(), params["criteria_gating"])
    aspect_gate = gating_forward(ag, prompt_embedding, cfg.gating_temperature,
                                 cfg.gating_n_hidden)
    criteria_logits = gating_mlp(cg, prompt_embedding, cfg.gating_n_hidden)

    # Per-aspect grouped softmax over each aspect's criteria, sharing the
    # criteria gate's temperature and logit_scale (moe_reward.py:249-258).
    logit_scale = cg["logit_scale"][0]
    temp = cfg.gating_temperature
    weights_groups = []
    score_groups = []
    for criteria in cfg.aspect2criteria:
        grp = torch.softmax(_columns(criteria_logits, criteria) / temp,
                            dim=-1) * logit_scale
        weights_groups.append(grp)
        score_groups.append((_columns(rewards, criteria) * grp).sum(-1))
    aspect_weights = torch.cat(weights_groups, dim=-1)
    aspect_scores = torch.stack(score_groups, dim=-1)
    score = (aspect_scores * aspect_gate).sum(-1)
    return RewardOutput(
        rewards=rewards,
        hidden_state=pooled,
        prompt_embedding=prompt_embedding,
        criteria_gating_output=criteria_logits,
        aspect_gating_output=aspect_gate,
        aspect_weights=aspect_weights,
        aspect_scores=aspect_scores,
        score=score,
    )


def reward_forward(
    params,
    cfg: RewardConfig,
    pixel_values: torch.Tensor,  # (P, H, W, 3)
    input_ids: torch.Tensor,  # (B, T)
    attention_mask: Optional[torch.Tensor],  # (B, T)
    gating_pos: torch.Tensor,  # (B,)
    impl: str = "auto",
    img_context_token_id: Optional[int] = None,
    remat=True,
) -> RewardOutput:
    """Backbone forward + reward head: the scoring and training path."""
    hidden = chat_forward(params["model"], cfg.chat, pixel_values, input_ids,
                          attention_mask=attention_mask, impl=impl,
                          img_context_token_id=img_context_token_id,
                          remat=remat)
    return reward_head(params, cfg, hidden, input_ids, gating_pos)
