"""Pinned chat-template constants for the MiniCPM-V-2.6 and CogVLM2-Video
baseline judges: a copy of ``mjvideo_tpu/data/judge_templates.py``
(``tests/test_torch_minicpmv.py`` holds it equal to the JAX package's).

The reference runs these judges through ms-swift templates
(``eval_overall_minicpm.py:120-128`` -> ``ModelType.minicpm_v_v2_6_chat``,
``eval_overall_cogvlm2.py:120-128`` -> ``ModelType.cogvlm2_video_13b_chat``),
which in turn delegate to the published model processors.  The template
strings below are transcribed from the published upstream sources and are
the single source of truth for both the string rendering and the id-level
prompt builders of ``models/minicpmv.py`` and ``models/cogvlm2.py``.

MiniCPM-V-2.6 (openbmb/MiniCPM-V-2_6):
 * ``chat.py``: every image in a user turn renders as the literal
   ``(<image>./</image>)``; content items are joined with ``"\n"``.
 * ``processing_minicpmv.py``: each ``(<image>./</image>)`` expands to
   ``<image>`` + ``<unk>`` x query_num + ``</image>`` (video mode:
   ``use_image_id=False``, ``max_slice_nums=1`` -> no ``<slice>`` blocks,
   no ``<image_id>``).
 * tokenizer chat template: ChatML
   (``<|im_start|>user\n...<|im_end|>\n<|im_start|>assistant\n``); swift
   passes no system turn.

CogVLM2-Video (THUDM/cogvlm2-video-llama3-chat):
 * ``modeling_cogvlm.py: _history_to_prompt`` — 'chat' formats
   ``Question: {q} Answer:`` turns; 'vqa' uses ``Short answer:``; 'base'
   is the bare query.  swift uses ``template_version='chat'``.
 * ``build_conversation_input_ids``: ``[bos]`` + vision placeholder slots
   + the templated text encoded with ``add_special_tokens=False``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# --- MiniCPM-V-2.6 ----------------------------------------------------------

MINICPM_IMAGE_PATTERN = "(<image>./</image>)"
MINICPM_IM_START = "<image>"
MINICPM_IM_END = "</image>"
MINICPM_SLICE_START = "<slice>"
MINICPM_SLICE_END = "</slice>"
MINICPM_UNK = "<unk>"
MINICPM_CHAT_PREFIX = "<|im_start|>user\n"
MINICPM_CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"


def minicpm_video_content(n_frames: int, query: str) -> str:
    """Pre-expansion user content: frame patterns + query, '\n'-joined
    (``chat.py``'s ``"\n".join(cur_msgs)``)."""
    return "\n".join([MINICPM_IMAGE_PATTERN] * n_frames + [query])


def minicpm_expand_images(content: str, query_num: int) -> str:
    """``processing_minicpmv``'s placeholder expansion for unsliced images
    (video mode)."""
    placeholder = MINICPM_IM_START + MINICPM_UNK * query_num + MINICPM_IM_END
    return content.replace(MINICPM_IMAGE_PATTERN, placeholder)


def minicpm_video_prompt(n_frames: int, query: str, query_num: int) -> str:
    """The exact rendered string the reference's swift pipeline tokenizes
    for an n-frame video question (no system turn)."""
    return (
        MINICPM_CHAT_PREFIX
        + minicpm_expand_images(minicpm_video_content(n_frames, query),
                                query_num)
        + MINICPM_CHAT_SUFFIX
    )


def minicpm_video_segments(
    n_frames: int, query: str, query_num: int,
) -> List[Tuple[str, str]]:
    """The prompt as (kind, value) segments, split exactly where an HF
    tokenizer splits on special tokens — so encoding each 'text' segment
    independently and mapping each 'special' segment to its id reproduces
    the whole-string tokenization bit-for-bit.

    kinds: 'special' (one marker token) / 'text' (BPE-encoded run).
    """
    segs: List[Tuple[str, str]] = [
        ("special", "<|im_start|>"),
        ("text", "user\n"),
    ]
    for f in range(n_frames):
        segs.append(("special", MINICPM_IM_START))
        for _ in range(query_num):
            segs.append(("special", MINICPM_UNK))
        segs.append(("special", MINICPM_IM_END))
        # '\n' joins successive frames; the final join binds to the query
        # text (same BPE run — encode together).
        if f < n_frames - 1:
            segs.append(("text", "\n"))
    segs.append(("text", ("\n" + query) if n_frames else query))
    segs.append(("special", "<|im_end|>"))
    segs.append(("text", "\n"))
    segs.append(("special", "<|im_start|>"))
    segs.append(("text", "assistant\n"))
    return segs


# --- CogVLM2-Video ----------------------------------------------------------

COGVLM2_ANSWER_FORMAT = {"chat": "Answer:", "vqa": "Short answer:"}


def cogvlm2_history_to_prompt(
    query: str,
    history: Optional[Sequence[Tuple[str, str]]] = None,
    template_version: str = "chat",
) -> str:
    """Exact port of ``modeling_cogvlm.py: _history_to_prompt``."""
    if template_version == "base":
        return query
    if template_version not in COGVLM2_ANSWER_FORMAT:
        raise ValueError(f"Unknown signal type {template_version}")
    answer_format = COGVLM2_ANSWER_FORMAT[template_version]
    prompt = ""
    for old_query, response in history or []:
        prompt += ("Question: " + old_query + " {} ".format(answer_format)
                   + response + "\n")
    prompt += "Question: {} {}".format(query, answer_format)
    return prompt
