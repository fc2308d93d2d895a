"""The reward gradient's bars over weight seeds, on a CUDA card.

    python3 tools/reward_grad_survey.py [--seeds 0 1 2 3] [--kernels]

For each seed, builds ``chip_smoke.py``'s 2B scorer (random bf16 weights
from that seed) and runs its reward-gradient phase on the single 8-frame
clip (launch counts, score against ``score_batch``, the gradient finite and
nonzero on every tile), printing the pixel gradient's relative L2 error and
cosine against fp32 plain autograd without holding them to
``REWARD_GRAD_REL_L2`` and ``REWARD_GRAD_COS``: the readings those bars are
set from.  Beside them, the same bf16 weights through the plain attention
path (no kernel) against fp32 plain: the share of the error that bf16
itself makes.  ``--kernels`` first runs phase 13's per-kernel checks of K1
with the lse and K4 nc, reporting a breach instead of stopping, so that a
copy of the tree with a planted fault shows which checks it fails.
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
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("reward_grad_survey: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda:0")
    failed = []
    if args.kernels:
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)

        def randn(*shape):
            return torch.randn(shape, generator=g,
                               device=dev).to(torch.bfloat16)

        for shape in chip_smoke.K1_SHAPES:
            try:
                chip_smoke.check_vit_backward(randn, shape)
            except RuntimeError as err:
                failed.append(f"kernels {shape}")
                print(f"FAILED: {err}")
    bars = chip_smoke.REWARD_GRAD_REL_L2, chip_smoke.REWARD_GRAD_COS
    chip_smoke.REWARD_GRAD_REL_L2 = float("inf")  # report, do not hold
    chip_smoke.REWARD_GRAD_COS = -1.0
    rows = []
    for seed in args.seeds:
        scorer = chip_smoke.make_scorer(
            torch.Generator(device=dev).manual_seed(seed), dev)
        request = chip_smoke.make_requests(
            scorer, np.random.default_rng(chip_smoke.SEED))[0]
        out, _ = chip_smoke.reward_gradient_phase(scorer, request, dev,
                                                  timing=False)
        _, g16 = chip_smoke.plain_pixel_grad(scorer, request, dev,
                                             torch.bfloat16)
        _, g32 = chip_smoke.plain_pixel_grad(scorer, request, dev,
                                             torch.float32)
        out["bf16_plain_rel_l2"], out["bf16_plain_cos"] = (
            chip_smoke._compare_grads(g16, g32))
        del g16, g32
        rows.append({"seed": seed, **out})
        print(json.dumps(rows[-1]))
        if not (out["rel_l2"] <= bars[0] and out["cos"] >= bars[1]):
            failed.append(f"gradient seed {seed}")
        del scorer
        torch.cuda.empty_cache()
    worst = max(r["rel_l2"] for r in rows)
    low = min(r["cos"] for r in rows)
    plain16 = max(r["bf16_plain_rel_l2"] for r in rows)
    print(f"bf16 through the plain path against fp32 plain: largest relative "
          f"L2 {plain16:.4e}")
    print(f"largest relative L2 {worst:.4e}, lowest cosine {low:.6f} over "
          f"seeds {args.seeds}; bars {bars[0]} ({bars[0] / worst:.1f}x) and "
          f"{bars[1]}; breaches: {failed or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
