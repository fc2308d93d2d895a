"""Parallelism: sequence parallelism (``sequence.py``) and multi-process
initialization (``distributed.py``)."""

from .distributed import maybe_initialize, process_info  # noqa: F401
from .sequence import (  # noqa: F401
    SequenceGroup,
    ring_flash_attention,
    shard_sequence,
    sp_flash_attention,
)
