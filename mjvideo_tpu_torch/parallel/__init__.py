"""Parallelism: the (data, model) mesh (``mesh.py``), sequence parallelism
(``sequence.py``) and multi-process initialization (``distributed.py``)."""

from .distributed import maybe_initialize, process_info  # noqa: F401
from .mesh import (  # noqa: F401
    TP_RULES,
    Mesh,
    make_mesh,
    param_pspec,
    param_shardings,
    shard_batch,
    shard_params,
    zero1_opt_shardings,
)
from .sequence import (  # noqa: F401
    SequenceGroup,
    ring_flash_attention,
    shard_sequence,
    sp_flash_attention,
)
