"""Chat prompt templates: the port's own copy of
``mjvideo_tpu/data/conversation.py``.

Replaces the FastChat-derived registry the reference vendors
(``scripts/model/internvl2/conversation.py``).  Only the MPT separator style
is ever used by InternVL2 (``conversation.py:240-249``), so the whole class
hierarchy collapses to one dataclass that renders

    <system_prefix>{system}<sep><role_user>{msg}<sep><role_asst>...

The four registered templates match ``conversation.py:339-391``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# The reference system message (shared by Hermes-2 / internlm2-chat /
# phi3-chat, ``conversation.py:339-379``).
_INTERNVL_SYSTEM = (
    "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
    "英文名叫InternVL, 是一个有用无害的人工智能助手。"
)
_INTERNVL25_SYSTEM = (
    "你是书生·万象，英文名是InternVL，是由上海人工智能实验室、清华大学及"
    "多家合作单位联合开发的多模态大语言模型。"
)


@dataclass
class ChatTemplate:
    """An MPT-style (ChatML-like) chat template."""

    name: str
    system_template: str  # e.g. '<|im_start|>system\n{system_message}'
    system_message: str
    roles: Tuple[str, str]  # (user prefix, assistant prefix)
    sep: str  # message terminator, e.g. '<|im_end|>'
    stop_str: Optional[str] = None
    messages: List[List[Optional[str]]] = field(default_factory=list)

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        """MPT sep-style rendering (``conversation.py:240-249``)."""
        out = self.system_template.format(system_message=self.system_message)
        out += self.sep
        for role, message in self.messages:
            if message:
                out += role + message + self.sep
            else:
                out += role
        return out

    def copy(self) -> "ChatTemplate":
        return ChatTemplate(
            name=self.name,
            system_template=self.system_template,
            system_message=self.system_message,
            roles=self.roles,
            sep=self.sep,
            stop_str=self.stop_str,
            messages=[list(m) for m in self.messages],
        )


_TEMPLATES: Dict[str, ChatTemplate] = {}


def register_template(t: ChatTemplate, override: bool = False) -> None:
    if not override and t.name in _TEMPLATES:
        raise ValueError(f"template {t.name!r} already registered")
    _TEMPLATES[t.name] = t


def get_template(name: str) -> ChatTemplate:
    """Fresh copy of a registered template (``get_conv_template``)."""
    return _TEMPLATES[name].copy()


register_template(ChatTemplate(
    name="Hermes-2",
    system_template="<|im_start|>system\n{system_message}",
    system_message=_INTERNVL_SYSTEM,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep="<|im_end|>",
    stop_str="<|endoftext|>",
))

register_template(ChatTemplate(
    name="internlm2-chat",
    system_template="<|im_start|>system\n{system_message}",
    system_message=_INTERNVL_SYSTEM,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep="<|im_end|>",
))

register_template(ChatTemplate(
    name="phi3-chat",
    system_template="<|system|>\n{system_message}",
    system_message=_INTERNVL_SYSTEM,
    roles=("<|user|>\n", "<|assistant|>\n"),
    sep="<|end|>",
))

register_template(ChatTemplate(
    name="internvl2_5",
    system_template="<|im_start|>system\n{system_message}",
    system_message=_INTERNVL25_SYSTEM,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep="<|im_end|>\n",
))
