"""Where the time of one 2B reward value-and-gradient goes on a CUDA card.

    python3 tools/profile_torch_reward_grad.py [--out FILE]

Builds the MJ-VIDEO-2B ``RewardScorer`` and the single 8-frame clip of
``chip_smoke.py`` (random bf16 weights made on the card), takes two
value-and-gradients of ``score_fn`` to the pixels as warm-up, times three
more without the profiler, then traces two with ``torch.profiler``
recording device activity only.  Prints the card, the wall time per
value-and-gradient with and without the profiler, the device busy share
against each and the device time by kernel group and by kernel; ``--out``
also writes the per-kernel list and the profiler's table to FILE.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
STEPS = 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_reward_grad: CUDA is not available",
              file=sys.stderr)
        return 1
    from chip_smoke import SEED, make_requests, make_scorer
    from tools.profile_torch_scoring import report

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    scorer = make_scorer(torch.Generator(device=dev).manual_seed(SEED), dev)
    pix, ids, gpos = make_requests(scorer, np.random.default_rng(SEED))[0]
    f = scorer.score_fn(ids[0], gpos[0])
    frames = torch.from_numpy(pix).to(dev).requires_grad_()

    def value_and_grad():
        torch.autograd.grad(f(frames), frames)

    for _ in range(2):
        value_and_grad()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value_and_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            value_and_grad()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, STEPS, f"value-and-gradients of one {pix.shape[0]}-"
           "frame clip", "step", smi, args.out, statistics.median(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
