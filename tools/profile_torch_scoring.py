"""Where the time of one 2B scoring request goes on a CUDA card.

    python3 tools/profile_torch_scoring.py [--out FILE]

Builds the MJ-VIDEO-2B ``RewardScorer`` and the pair request of
``chip_smoke.py`` (random bf16 weights made on the card, two 8-frame clips),
warms up, then traces three requests with ``torch.profiler``.  Prints the
card, the wall time per request, the device busy share (kernel time over
wall time) and the device time by kernel group and by kernel; ``--out`` also
writes the per-kernel list and the profiler's table to FILE.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
STEPS = 3


def _group(name: str) -> str:
    n = name.lower()
    if "bound_attention" in n:
        return "attention kernels (K1/K2/K2r/K3)"
    if "bwd_dkdv" in n or "bwd_dq" in n:
        return "attention backward kernels (K4a/K4b)"
    if "gemm" in n or "nvjet" in n or "xmma" in n or "cutlass" in n:
        return "matmul (cuBLAS)"
    if "reduce" in n or "norm" in n:
        return "reductions / norms"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    if "copy" in n or "cat" in n or "index" in n or "gather" in n:
        return "copies / gathers"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_scoring: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import SEED, make_requests, make_scorer

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    scorer = make_scorer(torch.Generator(device=dev).manual_seed(SEED), dev)
    pix, ids, gpos = make_requests(scorer, np.random.default_rng(SEED))[1]

    for _ in range(2):
        scorer.score_batch(pix, ids, gpos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            scorer.score_batch(pix, ids, gpos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, STEPS, f"requests of {len(ids)} clips", "request",
           smi, args.out)
    return 0


def report(prof, wall: float, steps: int, what: str, unit: str, smi: str,
           out, unprofiled: Optional[float] = None) -> None:
    """Print wall time, busy share and device time by group and by kernel
    per ``unit``; write the per-kernel list and the table to ``out``.
    ``unprofiled``: seconds per ``unit`` of the same work without the
    profiler, against which the busy share is also taken."""
    import torch

    kernels = {}
    for ev in prof.key_averages():
        t = ev.self_device_time_total
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + t
    dev_us = sum(kernels.values())
    wall_us = wall * 1e6
    print(f"{steps} {what}: wall {wall * 1e3 / steps:.2f} ms/{unit}, device "
          f"kernel time {dev_us / 1e3 / steps:.2f} ms/{unit}, busy share "
          f"{dev_us / wall_us:.3f}")
    if unprofiled is not None:
        print(f"without the profiler: wall {unprofiled * 1e3:.2f} ms/{unit}, "
              f"busy share {dev_us / steps / (unprofiled * 1e6):.3f}")
    groups = {}
    for name, t in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + t
    for name, t in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  {t / 1e3 / steps:9.2f} ms/{unit} {t / dev_us:6.1%}  {name}")
    lines = [f"{t / 1e3 / steps:9.3f} ms/{unit} {t / dev_us:6.1%}  {n}"
             for n, t in sorted(kernels.items(), key=lambda x: -x[1])]
    print("top kernels:")
    for line in lines[:15]:
        print("  " + line[:160])
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(
            f"card: {smi}\n" + "\n".join(lines) + "\n\n" +
            prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=60))


if __name__ == "__main__":
    sys.exit(main())
