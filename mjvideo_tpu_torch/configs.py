"""Configuration tree: the port's own copy of ``mjvideo_tpu/configs.py``.

Frozen dataclasses for the InternViT encoder, the decoder LLM, the InternVL
chat model and the MoE reward model, with the presets the port drives
(MJ-VIDEO-2B, the InternVL2-2B judge backbone, the tiny test config).  The
port imports nothing of the JAX package; ``tests/test_torch_quant.py``
holds each preset equal to the JAX package's field for field.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

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
