"""Configuration tree: the port's own copy of ``mjvideo_tpu/configs.py``.

Frozen dataclasses for the InternViT encoder, the decoder LLM, the InternVL
chat model and the MoE reward model, with the presets the port drives
(MJ-VIDEO-2B, the InternVL2-2B judge backbone, the tiny test config), and
the readers and writer of an HF checkpoint's ``config.json`` (InternLM2,
Llama and Phi-3 decoders).  The port imports nothing of the JAX package;
``tests/test_torch_quant.py`` holds each preset equal to the JAX package's
field for field, ``tests/test_torch_checkpoint.py`` the HF dicts.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

@dataclass(frozen=True)
class VisionConfig:
    """InternViT encoder config.

    Reference: ``configuration_intern_vit.py:62-105``.  The vendored default
    there describes the 6B ViT (48 layers / 3200 hidden / rms_norm / qk_norm);
    the InternVL2-2B checkpoint actually serves InternViT-300M (24 layers /
    1024 hidden / layer_norm / no qk_norm).  Both variants are supported via
    ``norm_type`` and ``qk_normalization``.
    """

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    qkv_bias: bool = True
    qk_normalization: bool = False
    norm_type: str = "layer_norm"  # 'layer_norm' (300M) | 'rms_norm' (6B)
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu"
    initializer_factor: float = 0.1  # LayerScale init value (ls1/ls2)
    drop_path_rate: float = 0.0
    attention_dropout: float = 0.0
    dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        """Tokens per tile including the cls token (e.g. 32*32 + 1 = 1025)."""
        return self.num_patches_per_side**2 + 1


@dataclass(frozen=True)
class LLMConfig:
    """Decoder LLM config covering InternLM2 and Llama-family architectures.

    Reference: ``configuration_internlm2.py:77-129`` (+ rope validation
    ``:131-157``).  ``architecture`` selects the weight layout: InternLM2 packs
    QKV into one ``wqkv`` with interleaved grouped layout
    (``modeling_internlm2.py:301-305,361-371``); Llama keeps separate
    q/k/v projections.
    """

    architecture: str = "internlm2"  # 'internlm2' | 'llama' | 'phi3'
    vocab_size: int = 92553
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    rope_scaling_type: Optional[str] = None  # None | 'linear' | 'dynamic'
    rope_scaling_factor: float = 1.0
    bias: bool = False  # attention qkv/o bias (InternLM2-20B uses True)
    pad_token_id: int = 2
    bos_token_id: int = 1
    eos_token_id: int = 2
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.rope_scaling_type is not None:
            if self.rope_scaling_type not in ("linear", "dynamic"):
                raise ValueError(
                    f"rope_scaling_type must be 'linear' or 'dynamic', got "
                    f"{self.rope_scaling_type!r}"
                )
            if self.rope_scaling_factor < 1.0:
                raise ValueError("rope_scaling_factor must be >= 1")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclass(frozen=True)
class ChatConfig:
    """InternVL chat (fusion) model config.

    Reference: ``configuration_internvl_chat.py:19-96``.
    """

    vision: VisionConfig = field(default_factory=VisionConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    select_layer: int = -1
    downsample_ratio: float = 0.5
    template: str = "Hermes-2"
    ps_version: str = "v2"
    min_dynamic_patch: int = 1
    max_dynamic_patch: int = 12
    use_thumbnail: bool = True
    force_image_size: Optional[int] = None
    # Special token ids (InternVL2 tokenizer additions).
    img_context_token_id: int = 92546
    img_start_token_id: int = 92544
    img_end_token_id: int = 92545

    @property
    def image_size(self) -> int:
        return self.force_image_size or self.vision.image_size

    @property
    def num_image_token(self) -> int:
        """Image tokens per tile after pixel-shuffle downsampling.

        Reference: ``modeling_internvl_chat.py:109`` — (448/14)^2 * 0.5^2 = 256.
        """
        return int(
            (self.image_size // self.vision.patch_size) ** 2
            * (self.downsample_ratio**2)
        )


# The canonical aspect -> criteria routing table.
# Reference: ``scripts/train/overall_train.py:48-54`` — Alignment(5), Safety(6),
# Fineness(5), Coherence&Consistency(7), Bias&Fairness(5).
ASPECT2CRITERIA: Dict[int, Tuple[int, ...]] = {
    0: (0, 1, 2, 3, 4),
    1: (5, 6, 7, 8, 9, 10),
    2: (11, 12, 13, 14, 15),
    3: (16, 17, 18, 19, 20, 21, 22),
    4: (23, 24, 25, 26, 27),
}

ASPECT_NAMES: Tuple[str, ...] = (
    "Alignment",
    "Safety",
    "Fineness",
    "Coherence and Consistency",
    "Bias and Fairness",
)

# Criteria names in routing order (keys of the per-video label dicts in
# ``datas/test.json``; grouping per SURVEY.md section 0).
CRITERIA_NAMES: Tuple[str, ...] = (
    # Alignment
    "object", "attribute", "actions", "count", "location",
    # Safety
    "Crime", "Shocking", "Disgust", "NSFW Evasive", "NSFW Subtle",
    "Political Sensitivity",
    # Fineness
    "Human Face Distortion", "Human Limb Distortion", "Object Distortion",
    "De-focused Blurred", "Motion Blurred",
    # Coherence and Consistency
    "Spatial Consistency", "Action Continuity", "Object Disappearance",
    "Abrupt Background Changes", "Inconsistent Lighting Shadows",
    "Frame Flickering", "Object Drift",
    # Bias and Fairness
    "Race", "Age", "Education", "Job", "Gender",
)


@dataclass(frozen=True)
class RewardConfig:
    """MoE reward model config.

    Reference: ``moe_reward.py:92-133`` (config) and ``:137-181`` (head init).
    """

    chat: ChatConfig = field(default_factory=ChatConfig)
    num_objectives: int = 28
    num_aspects: int = 5
    # Stored as a tuple-of-tuples so the config stays hashable; index = aspect.
    aspect2criteria: Tuple[Tuple[int, ...], ...] = tuple(
        ASPECT2CRITERIA[a] for a in range(5)
    )
    gating_temperature: float = 1.0
    gating_hidden_dim: int = 1024
    gating_n_hidden: int = 3
    # Tokenized '<|im_end|><|im_start|>assistant\n' — the last occurrence marks
    # the prompt embedding fed to both gates (``moe_reward.py:45-57``).
    gating_token_pattern: Tuple[int, ...] = (92542, 92543, 525, 11353, 364)

    def __post_init__(self):
        # Routing-table sanity checks mirroring ``moe_reward.py:153-157``.
        assert len(self.aspect2criteria) == self.num_aspects
        flat = [c for grp in self.aspect2criteria for c in grp]
        assert len(flat) == self.num_objectives
        assert len(set(flat)) == len(flat), "criteria must not repeat"

    @property
    def hidden_size(self) -> int:
        return self.chat.llm.hidden_size


def vision_config_from_hf(d: Dict[str, Any]) -> VisionConfig:
    """Build a VisionConfig from an HF checkpoint's vision_config dict."""
    return VisionConfig(
        hidden_size=d.get("hidden_size", 1024),
        intermediate_size=d.get("intermediate_size", 4096),
        num_hidden_layers=d.get("num_hidden_layers", 24),
        num_attention_heads=d.get("num_attention_heads", 16),
        image_size=d.get("image_size", 448),
        patch_size=d.get("patch_size", 14),
        qkv_bias=d.get("qkv_bias", True),
        qk_normalization=d.get("qk_normalization", False),
        norm_type=d.get("norm_type", "layer_norm"),
        layer_norm_eps=d.get("layer_norm_eps", 1e-6),
        hidden_act=d.get("hidden_act", "gelu"),
        initializer_factor=d.get("initializer_factor", 0.1),
        drop_path_rate=d.get("drop_path_rate", 0.0),
        attention_dropout=d.get("attention_dropout", 0.0),
        dropout=d.get("dropout", 0.0),
    )


def llm_config_from_hf(d: Dict[str, Any]) -> LLMConfig:
    """Build an LLMConfig from an HF llm_config dict (InternLM2 or Llama)."""
    archs = d.get("architectures") or ["InternLM2ForCausalLM"]
    if archs[0] == "InternLM2ForCausalLM":
        architecture = "internlm2"
    elif archs[0] == "LlamaForCausalLM":
        architecture = "llama"
    elif archs[0] == "Phi3ForCausalLM":
        # InternVL2-4B's LLM (phi3-chat template, conversation.py:368-379).
        # Within the reward path's <=3,072-token sequences Phi-3's longrope
        # scaling never activates, so standard RoPE is exact.
        architecture = "phi3"
    else:
        raise ValueError(f"Unsupported LLM architecture: {archs[0]}")
    scaling = d.get("rope_scaling") or None
    return LLMConfig(
        architecture=architecture,
        vocab_size=d.get("vocab_size", 92553),
        hidden_size=d.get("hidden_size", 2048),
        intermediate_size=d.get("intermediate_size", 8192),
        num_hidden_layers=d.get("num_hidden_layers", 24),
        num_attention_heads=d.get("num_attention_heads", 16),
        num_key_value_heads=d.get(
            "num_key_value_heads", d.get("num_attention_heads", 16)
        ),
        hidden_act=d.get("hidden_act", "silu"),
        max_position_embeddings=d.get("max_position_embeddings", 32768),
        rms_norm_eps=d.get("rms_norm_eps", 1e-5),
        rope_theta=d.get("rope_theta", 1e6),
        rope_scaling_type=(scaling or {}).get("type"),
        rope_scaling_factor=float((scaling or {}).get("factor", 1.0)),
        bias=d.get("bias", d.get("attention_bias", False)),
        pad_token_id=d.get("pad_token_id", 2),
        bos_token_id=d.get("bos_token_id", 1),
        eos_token_id=d.get("eos_token_id", 2),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
    )


def chat_config_from_hf(d: Dict[str, Any]) -> ChatConfig:
    """Build a ChatConfig from an InternVLChat HF config dict."""
    return ChatConfig(
        vision=vision_config_from_hf(d.get("vision_config", {})),
        llm=llm_config_from_hf(d.get("llm_config", {})),
        select_layer=d.get("select_layer", -1),
        downsample_ratio=d.get("downsample_ratio", 0.5),
        template=d.get("template", "Hermes-2"),
        ps_version=d.get("ps_version", "v2"),
        min_dynamic_patch=d.get("min_dynamic_patch", 1),
        max_dynamic_patch=d.get("max_dynamic_patch", 12),
        use_thumbnail=d.get("use_thumbnail", True),
        force_image_size=d.get("force_image_size"),
    )


def reward_config_from_hf(d: Dict[str, Any]) -> RewardConfig:
    """Build a RewardConfig from the reward-model HF config dict.

    Round-trips the custom fields the reference adds in
    ``moe_reward.py:109-133`` (num_objectives/num_aspects/aspect2criteria).
    """
    a2c = d.get("aspect2criteria") or ASPECT2CRITERIA
    # JSON round-trips dict keys as strings.
    a2c = {int(k): tuple(v) for k, v in a2c.items()}
    num_aspects = d.get("num_aspects", 5) or 5
    return RewardConfig(
        chat=chat_config_from_hf(d),
        num_objectives=d.get("num_objectives", 28) or 28,
        num_aspects=num_aspects,
        aspect2criteria=tuple(a2c[a] for a in sorted(a2c)),
        gating_temperature=d.get("gating_temperature", 1.0),
        gating_hidden_dim=d.get("gating_hidden_dim", 1024),
        gating_n_hidden=d.get("gating_n_hidden", 3),
    )


def load_config(path: str) -> RewardConfig:
    """Load a RewardConfig from a config.json file (HF-format)."""
    with open(path) as f:
        return reward_config_from_hf(json.load(f))


def to_json(cfg) -> str:
    """Serialize any config dataclass to JSON."""
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=list)


def mjvideo_2b_config() -> RewardConfig:
    """MJ-VIDEO-2B: InternViT-300M + InternLM2-chat-1.8B + 28/5 reward head."""
    return RewardConfig()


def internvl2_2b_chat_config() -> ChatConfig:
    """InternVL2-2B judge backbone — the same InternViT-300M + InternLM2-1.8B
    stack the reward model builds on (``eval_overall_internvl2_2b.py:119-129``
    loads ``internvl2-2b`` via swift)."""
    return ChatConfig()


def tiny_test_config(
    vocab_size: int = 272,
    hidden_size: int = 64,
    num_layers: int = 2,
    image_size: int = 56,
    patch_size: int = 14,
) -> RewardConfig:
    """A scaled-down config for fast CPU tests; same structure as 2B.

    The special-token ids follow ``data.prompts.ByteTokenizer`` (byte vocab
    256 + specials: im_start 256, im_end 257, <img> 258, </img> 259,
    <IMG_CONTEXT> 260) so hermetic pipelines built through the ByteTokenizer
    scatter image embeds at the SAME id the model looks for — exactly how
    real checkpoints assign ``img_context_token_id`` from their tokenizer.
    """
    if vocab_size < 261:
        raise ValueError(
            "tiny_test_config needs vocab_size >= 261 to cover the "
            "ByteTokenizer special-token ids (<IMG_CONTEXT> = 260); "
            f"got {vocab_size}")
    return RewardConfig(
        chat=ChatConfig(
            vision=VisionConfig(
                hidden_size=hidden_size,
                intermediate_size=hidden_size * 4,
                num_hidden_layers=num_layers,
                num_attention_heads=4,
                image_size=image_size,
                patch_size=patch_size,
            ),
            llm=LLMConfig(
                vocab_size=vocab_size,
                hidden_size=hidden_size,
                intermediate_size=hidden_size * 2,
                num_hidden_layers=num_layers,
                num_attention_heads=4,
                num_key_value_heads=2,
                pad_token_id=0,
            ),
            img_context_token_id=260,
            img_start_token_id=258,
            img_end_token_id=259,
        ),
        gating_hidden_dim=32,
        gating_token_pattern=(7, 8, 9),
    )


_HF_ARCH_NAMES = {
    "internlm2": "InternLM2ForCausalLM",
    "llama": "LlamaForCausalLM",
    "phi3": "Phi3ForCausalLM",
}


def reward_config_to_hf(cfg: RewardConfig) -> Dict[str, Any]:
    """RewardConfig -> the HF-format config dict ``reward_config_from_hf``
    (and the reference's ``InternVLChatRewardModelingConfig.from_pretrained``,
    ``moe_reward.py:109-133``) reads back — so checkpoints trained here
    export to a directory the reference can load."""
    c, v, l = cfg.chat, cfg.chat.vision, cfg.chat.llm
    rope_scaling = None
    if l.rope_scaling_type is not None:
        rope_scaling = {"type": l.rope_scaling_type,
                        "factor": l.rope_scaling_factor}
    return {
        "model_type": "internvl_chat_reward",
        "vision_config": {
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_hidden_layers,
            "num_attention_heads": v.num_attention_heads,
            "image_size": v.image_size,
            "patch_size": v.patch_size,
            "qkv_bias": v.qkv_bias,
            "qk_normalization": v.qk_normalization,
            "norm_type": v.norm_type,
            "layer_norm_eps": v.layer_norm_eps,
            "hidden_act": v.hidden_act,
            "initializer_factor": v.initializer_factor,
            "drop_path_rate": v.drop_path_rate,
            "attention_dropout": v.attention_dropout,
            "dropout": v.dropout,
        },
        "llm_config": {
            "architectures": [_HF_ARCH_NAMES[l.architecture]],
            "vocab_size": l.vocab_size,
            "hidden_size": l.hidden_size,
            "intermediate_size": l.intermediate_size,
            "num_hidden_layers": l.num_hidden_layers,
            "num_attention_heads": l.num_attention_heads,
            "num_key_value_heads": l.num_key_value_heads,
            "hidden_act": l.hidden_act,
            "max_position_embeddings": l.max_position_embeddings,
            "rms_norm_eps": l.rms_norm_eps,
            "rope_theta": l.rope_theta,
            "rope_scaling": rope_scaling,
            "bias": l.bias,
            "pad_token_id": l.pad_token_id,
            "bos_token_id": l.bos_token_id,
            "eos_token_id": l.eos_token_id,
            "tie_word_embeddings": l.tie_word_embeddings,
        },
        "select_layer": c.select_layer,
        "downsample_ratio": c.downsample_ratio,
        "template": c.template,
        "ps_version": c.ps_version,
        "min_dynamic_patch": c.min_dynamic_patch,
        "max_dynamic_patch": c.max_dynamic_patch,
        "use_thumbnail": c.use_thumbnail,
        "force_image_size": c.force_image_size,
        "num_objectives": cfg.num_objectives,
        "num_aspects": cfg.num_aspects,
        "aspect2criteria": {
            str(i): list(v) for i, v in enumerate(cfg.aspect2criteria)
        },
        "gating_temperature": cfg.gating_temperature,
        "gating_hidden_dim": cfg.gating_hidden_dim,
        "gating_n_hidden": cfg.gating_n_hidden,
    }
