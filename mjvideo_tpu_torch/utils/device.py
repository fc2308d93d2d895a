"""The torch device that a command line asks for."""

import torch


def resolve_device(name: str) -> torch.device:
    """The torch device of ``--device``; a CUDA device on a machine
    without CUDA raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    return device
