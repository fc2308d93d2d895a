"""``chip_smoke.py``'s build and phase 29 (K1 at InternViT-6B's D = 128,
the InternVL2-26B and -8B judges and the CLI) alone on a CUDA card.

    python3 tools/phase29_torch.py [--seeds 0,1,2,3] [--out FILE]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (a spill or a missing
instantiation is printed, not raised, so that the phase still runs),
then runs ``chip_smoke.internvl_phase``: K1 at D = 128 with 25 heads
against its twin at a video's (8, 1025) and at (2, 1025), timed in turns
with SDPA and the twin; ``InternVLJudge`` on InternVL2-26B at full width,
its decoder ``chip_smoke.IVL_26B_LLM_DEPTH`` of 48 layers deep, by both
paths and under the per-row bound, the tower and the teacher-forced logits
against fp32 plain on the same state; phase 9's checks and times on
InternVL2-8B, its decoder ``IVL_8B_LLM_DEPTH`` of 32 layers deep
(``chip_smoke.py`` skips its times); and the judge's CLI on a small-depth
26B-layout directory, each failure raising as in ``chip_smoke.py``.
``--seeds`` first reads ``chip_smoke.ivl_fidelity`` of the 26B judge at
each seed given, the weights drawn from it, and holds nothing there (seed
0 is the phase's own draw).  ``--out`` writes the readings and the launch
counts as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def fidelity_survey(dev, seeds):
    """``ivl_fidelity`` of the bf16 26B judge at full dims (all 48 decoder
    layers) for each seed: {seed: readings}, and one line of each reading
    over the seeds."""
    import gc

    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch import internvl2_26b_chat_config

    base, out = internvl2_26b_chat_config(), {}
    for seed in seeds:
        print(f"internvl26b fidelity at seed {seed}:")
        state = cs.init_chat_params_by_layer(
            base, torch.Generator(device=dev).manual_seed(seed), dev)
        judge = cs.make_judge(state=state, base=base)
        out[seed] = cs.ivl_fidelity(judge, base)[0]
        del judge, state
        gc.collect()
        torch.cuda.empty_cache()
    for key in out[seeds[0]]:
        print(f"internvl26b {key} over seeds {list(seeds)}: "
              + ", ".join(f"{out[s][key]:.4e}" for s in seeds))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default=None,
                   help="comma-separated seeds to read the 26B judge's "
                        "fidelity at before the phase")
    p.add_argument("--out", default=None, help="write the readings here")
    args = p.parse_args()
    import chip_smoke as cs

    setup = cs.phase_alone_setup("phase29")
    if setup is None:
        return 1
    dev, generator, drawer, ptxas = setup
    survey = None
    if args.seeds:
        survey = fidelity_survey(dev, [int(x) for x in args.seeds.split(",")])
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"survey": survey}, f)
    out, k29, launches = cs.internvl_phase(dev, generator, drawer,
                                           time_8b=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"phase29": out, "launches": launches, "ptxas": ptxas,
                       "survey": survey,
                       "kernels": {"K1 D128": {str(s): r for s, r in
                                               k29["K1"].items()}}},
                      f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
