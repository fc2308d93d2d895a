"""Prompt construction and tokenization: the port's own copy of
``mjvideo_tpu/data/prompts.py``.

Replaces ``prepare_chat_input`` (``modeling_internvl_chat.py:36-89``,
duplicated at ``dataset.py:114-167``) and the gating-token locator
(``moe_reward.py:45-57``).  The gating-token position (the last occurrence
of the tokenized ``'<|im_end|><|im_start|>assistant\\n'`` pattern) is found
here, on the host, at tokenization time, so the model indexes with a plain
integer.  Outputs are numpy; nothing touches the device in this module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .conversation import get_template

IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"
IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"

# Tokenized '<|im_end|><|im_start|>assistant\n' under the InternLM2 tokenizer
# (``moe_reward.py:48``).
GATING_TOKEN_PATTERN = (92542, 92543, 525, 11353, 364)

# The turn boundary before the assistant's reply, whose last token is the
# gating position, by chat template: InternLM2's ChatML
# (``moe_reward.py:48``) and Phi-3's markers (MJ-VIDEO-4B, ``phi3-chat``).
GATING_TEXT = {"internlm2-chat": "<|im_end|><|im_start|>assistant\n",
               "phi3-chat": "<|end|><|assistant|>\n"}


@dataclass
class ChatInputs:
    input_ids: np.ndarray  # (1, T) int32
    attention_mask: np.ndarray  # (1, T) int32
    gating_pos: int  # index of the pattern's last token occurrence
    prompt: str


def build_video_question(caption: str, num_frames: int) -> str:
    """'Frame{i}: <image>\\n' x F + caption (``dataset.py:361-364``)."""
    prefix = "".join(f"Frame{i + 1}: <image>\n" for i in range(num_frames))
    return prefix + caption


def expand_image_tokens(
    query: str, num_patches_list: Sequence[int], num_image_token: int
) -> str:
    """Each '<image>' -> <img> + <IMG_CONTEXT>*n*patches + </img>
    (``modeling_internvl_chat.py:74-76``)."""
    for num_patches in num_patches_list:
        tokens = (
            IMG_START_TOKEN
            + IMG_CONTEXT_TOKEN * (num_image_token * num_patches)
            + IMG_END_TOKEN
        )
        query = query.replace("<image>", tokens, 1)
    return query


def find_gating_position(
    input_ids: Sequence[int], pattern: Sequence[int] = GATING_TOKEN_PATTERN
) -> int:
    """START index of the LAST occurrence of ``pattern``.

    Host-side equivalent of ``find_token_for_gating`` (``moe_reward.py:50-57``)
    — which returns the start index of the last occurrence; the reference then
    pools hidden[:, that index] via
    ``hidden_states[torch.arange(...), gating_token_positions]``.
    """
    ids = list(input_ids)
    n = len(pattern)
    for start in range(len(ids) - n, -1, -1):
        if ids[start:start + n] == list(pattern):
            return start
    raise ValueError("gating token pattern not found in input_ids")


def _tokenizer_token_id(tokenizer, token: str) -> Optional[int]:
    """The tokenizer's id for ``token``, or None if it can't say."""
    tid = getattr(tokenizer, "img_context_token_id", None) \
        if token == IMG_CONTEXT_TOKEN else None
    if tid is None and hasattr(tokenizer, "convert_tokens_to_ids"):
        try:
            t = tokenizer.convert_tokens_to_ids(token)
        except (KeyError, ValueError):
            return None
        unk = getattr(tokenizer, "unk_token_id", None)
        if isinstance(t, int) and t >= 0 and t != unk:
            tid = t
    return tid


def rebase_img_context_id(cfg, tokenizer):
    """RewardConfig/ChatConfig with ``img_context_token_id`` taken from the
    tokenizer — the reference's load-time assignment
    (``model.img_context_token_id = tokenizer.convert_tokens_to_ids(
    IMG_CONTEXT_TOKEN)``).  Returns cfg unchanged when the tokenizer can't
    resolve the token or already agrees."""
    from dataclasses import replace

    tid = _tokenizer_token_id(tokenizer, IMG_CONTEXT_TOKEN)
    chat = getattr(cfg, "chat", cfg)
    if tid is None or tid == chat.img_context_token_id:
        return cfg
    new_chat = replace(chat, img_context_token_id=tid)
    if chat is cfg:
        return new_chat
    return replace(cfg, chat=new_chat)


def prepare_chat_input(
    cfg,  # ChatConfig
    tokenizer,
    question: str,
    num_patches_list: Optional[Sequence[int]] = None,
    history: Optional[List[Tuple[str, str]]] = None,
    has_image: bool = True,
    gating_pattern: Sequence[int] = GATING_TOKEN_PATTERN,
    require_gating: bool = True,
) -> ChatInputs:
    """Build the full ChatML prompt and tokenize it.

    Mirrors ``prepare_chat_input`` (``modeling_internvl_chat.py:36-89``):
    template fill -> '<image>' expansion -> tokenize.  Additionally locates
    the gating-token position so the model never searches on-device.
    """
    if has_image and "<image>" not in question and history is None:
        question = "<image>\n" + question

    template = get_template(cfg.template)
    for old_q, old_a in history or []:
        template.append_message(template.roles[0], old_q)
        template.append_message(template.roles[1], old_a)
    template.append_message(template.roles[0], question)
    template.append_message(template.roles[1], None)
    query = template.get_prompt()

    if num_patches_list:
        query = expand_image_tokens(
            query, num_patches_list, cfg.num_image_token
        )

    enc = tokenizer(query)
    ids = list(enc["input_ids"])
    mask = list(enc.get("attention_mask", [1] * len(ids)))
    if num_patches_list:
        # The scatter id is the TOKENIZER's (the reference assigns
        # ``model.img_context_token_id`` from it at load time); a config
        # that disagrees would silently drop every image embedding, so
        # fail loudly here instead.
        tok_img = _tokenizer_token_id(tokenizer, IMG_CONTEXT_TOKEN)
        if tok_img is not None and tok_img != cfg.img_context_token_id:
            raise ValueError(
                f"tokenizer maps {IMG_CONTEXT_TOKEN!r} to id {tok_img} but "
                f"cfg.img_context_token_id is {cfg.img_context_token_id}; "
                "the image-embed scatter would miss every position. Set "
                "the config id from the tokenizer (as the reference does: "
                "model.img_context_token_id = tokenizer."
                "convert_tokens_to_ids(IMG_CONTEXT_TOKEN))."
            )
    try:
        gating_pos = find_gating_position(ids, gating_pattern)
    except ValueError:
        # The reference raises here too (``moe_reward.py:57``): a missing
        # pattern means the template/tokenizer combo is wrong for reward
        # scoring, and pooling a fallback token would yield quietly-wrong
        # scores.  Generation callers that never read gating_pos opt out.
        if require_gating:
            raise ValueError(
                f"gating token pattern {list(gating_pattern)} not found in "
                "input_ids — conversation template and tokenizer do not "
                "match the reward model's gating pattern. Pass "
                "require_gating=False only if gating_pos is unused "
                "(pure generation)."
            )
        gating_pos = len(ids) - 1
    return ChatInputs(
        input_ids=np.asarray([ids], dtype=np.int32),
        attention_mask=np.asarray([mask], dtype=np.int32),
        gating_pos=gating_pos,
        prompt=query,
    )


class ByteTokenizer:
    """A dependency-free tokenizer for tests and offline smoke runs.

    Maps the InternVL special tokens to dedicated ids and everything else to
    byte values.  NOT the InternLM2 tokenizer — real checkpoints must use the
    HF tokenizer shipped with the model; this exists so the full pipeline is
    exercisable hermetically (the reference cannot run at all without the HF
    hub).
    """

    SPECIALS = (
        "<|im_start|>", "<|im_end|>", IMG_START_TOKEN, IMG_END_TOKEN,
        IMG_CONTEXT_TOKEN, "<|endoftext|>", "<|system|>", "<|user|>",
        "<|assistant|>", "<|end|>",
    )

    def __init__(self, pad_token_id: int = 0,
                 extra_specials: Optional[Dict[str, int]] = None):
        self.pad_token_id = pad_token_id
        base = 256
        self._special_ids = {s: base + i for i, s in enumerate(self.SPECIALS)}
        self.vocab_size = base + len(self.SPECIALS)
        if extra_specials:
            # A judge's own markers at its config's ids (VideoScore's
            # <image> and <fake_token_around_image>).
            self._special_ids.update(extra_specials)
            self.vocab_size = max(self.vocab_size,
                                  max(extra_specials.values()) + 1)

    @property
    def img_context_token_id(self) -> int:
        return self._special_ids[IMG_CONTEXT_TOKEN]

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._special_ids[token]

    def __call__(self, text: str):
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            for s, sid in self._special_ids.items():
                if text.startswith(s, i):
                    ids.append(sid)
                    i += len(s)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8", errors="replace"))
                i += 1
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def gating_pattern(self, template: str = "internlm2-chat"
                       ) -> Tuple[int, ...]:
        """The byte-level encoding of the template's ``GATING_TEXT``:
        '<|end|><|assistant|>\\n' for ``phi3-chat``, otherwise
        '<|im_end|><|im_start|>assistant\\n', the pattern of JAX's
        ``ByteTokenizer``."""
        text = GATING_TEXT.get(template, GATING_TEXT["internlm2-chat"])
        ids = self(text)["input_ids"]
        return tuple(ids)

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self._special_ids.items()}
        out = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t in inv:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                out.append(inv[t])
            elif t < 256:
                buf.append(t)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


def encode_text(tokenizer, s: str):
    """Plain text to ids with an HF tokenizer (no special tokens added) or a
    callable one (``ByteTokenizer``): the judge prompt builders' adapter
    (``prompts.py:258-265``)."""
    if hasattr(tokenizer, "encode"):
        return list(tokenizer.encode(s, add_special_tokens=False))
    ids = tokenizer(s)
    return ids["input_ids"] if isinstance(ids, dict) else list(ids)


def load_tokenizer(path):
    """The HF tokenizer of ``path``, or the ``ByteTokenizer`` (hermetic
    mode) where no path is given: (tokenizer, its gating pattern or None
    for the config's)."""
    if path:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(
            path, trust_remote_code=True, use_fast=False), None
    tok = ByteTokenizer()
    return tok, tok.gating_pattern()
