"""The judge's teacher-forced logits bar over weight seeds, on a CUDA card.

    python3 tools/judge_logit_survey.py [--seeds 0 1 2 3]

Runs ``chip_smoke.py``'s judge phase (the 2B InternVL2 judge with random
bf16 weights from each seed, the full-prompt and the prefix path, launch
counts checked) without its timing, and prints each path's teacher-forced
logits error relative to max|plain logit| against fp32 plain, without
holding it to ``LOGITS_REL_TOL``: the readings that bar is set from.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("judge_logit_survey: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    bar = chip_smoke.LOGITS_REL_TOL
    chip_smoke.LOGITS_REL_TOL = float("inf")  # report, do not hold
    dev = torch.device("cuda:0")
    rows = []
    for seed in args.seeds:
        out, _ = chip_smoke.judge_phase(dev, seed=seed, timing=False)
        rows.append({"seed": seed, **{k: out[k] for k in (
            "full_rel", "prefix_rel", "prefix_vs_full_step0",
            "prefix_vs_full_agree")}})
        print(json.dumps(rows[-1]))
        torch.cuda.empty_cache()
    worst = max(max(r["full_rel"], r["prefix_rel"]) for r in rows)
    print(f"largest reading {worst:.4e} over seeds {args.seeds}; "
          f"LOGITS_REL_TOL {bar:.1e} is {bar / worst:.1f}x it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
