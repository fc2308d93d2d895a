"""Multi-process initialization.

Counterpart of ``mjvideo_tpu/parallel/distributed.py``.  A single process
needs nothing.  Under ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR``), call ``maybe_initialize()`` once at
program start: it joins the default process group, with NCCL when this
process sees a CUDA card and gloo otherwise, and is a no-op everywhere
else, so the same entry point runs on one process and on many.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def maybe_initialize() -> bool:
    """``torch.distributed.init_process_group`` iff a multi-process launch
    is detected (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` set, world
    size above 1).  Returns True if the default group was (or already is)
    initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    if not all(os.environ.get(k) for k in _LAUNCHER_VARS):
        return False
    if int(os.environ["WORLD_SIZE"]) <= 1 or not dist.is_available():
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend=backend)
    return True


def process_info() -> Tuple[int, int]:
    """(process index, process count): (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
