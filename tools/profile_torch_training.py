"""Where the time of one 2B training micro-step goes on a CUDA card.

    python3 tools/profile_torch_training.py [--out FILE]

Builds the stage-3 MJ-VIDEO-2B ``Trainer`` of ``chip_smoke.py`` (random
bf16 weights made on the card, accumulation 2, remat, micro-batches of one
pair of 2-frame clips), takes two micro-steps as warm-up, times
``chip_smoke.TRAIN_TIMED_STEPS`` more without the profiler, then traces two
(one that accumulates, one that also steps the optimizer) with
``torch.profiler`` recording device activity only.  Prints the card, the
wall time per micro-step with and without the profiler, the device busy
share against each and the device time by kernel group and by kernel;
``--out`` also writes the per-kernel list and the profiler's table to FILE.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_training: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import SEED, make_trainer, time_training
    from tools.profile_torch_scoring import report

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer, batches = make_trainer(
            torch.Generator(device=dev).manual_seed(SEED), dev, ckpt_dir)
        trainer.train(batches[:2])
        # One accumulating and one optimizer micro-step, averaged.
        unprofiled = sum(time_training(trainer, batches).values()) / 2e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train(batches[2:4])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report(prof, wall, 2, "micro-steps (one pair of 2-frame clips each)",
           "micro-step", smi, args.out, unprofiled)
    return 0


if __name__ == "__main__":
    sys.exit(main())
