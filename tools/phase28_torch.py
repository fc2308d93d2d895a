"""``chip_smoke.py``'s build and phase 28 (K3 at the EVA2-CLIP-E tower's
D = 112, the CogVLM2-Video judge and its CLI) alone on a CUDA card.

    python3 tools/phase28_torch.py [--seeds 0,1,2,3] [--out FILE]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (a spill or a missing
instantiation is printed, not raised, so that the phase still runs),
then runs ``chip_smoke.cogvlm2_phase``: K3 not causal at D = 112 against
its twin at a video's (8, 257, 16, 112) and at whole tiles, timed in turns
with SDPA and the twin; ``CogVLM2Judge`` at full width, its decoder
``chip_smoke.COG_LLM_DEPTH`` of 32 layers deep, by both paths, the tower
and the teacher-forced logits against fp32 plain on the same state; and
the judge's CLI on a small-depth directory, each failure raising as in
``chip_smoke.py``.  ``--seeds`` first reads ``chip_smoke.cogvlm2_fidelity``
at full dims (all 32 decoder layers, 19.49 B parameters in bf16) at each
seed given, the weights and the videos drawn from it, and holds nothing
there.  ``--out`` writes the readings and the launch
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
    """``cogvlm2_fidelity`` of the bf16 judge at full dims for each seed:
    {seed: readings}, and one line of each reading over the seeds."""
    import gc

    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.models.cogvlm2 import (
        CogVLM2Config,
        init_cogvlm2_params,
    )

    cfg, tok, out = CogVLM2Config(), ByteTokenizer(), {}
    for seed in seeds:
        print(f"cogvlm2 fidelity at seed {seed}:")
        state = init_cogvlm2_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev, dtype=torch.bfloat16)
        judge = cs.make_cog_judge(cfg, state, tok, seed=seed)
        out[seed] = cs.cogvlm2_fidelity(cfg, state, tok, judge,
                                        ("video_0", "video_1"), seed)
        del judge, state
        gc.collect()
        torch.cuda.empty_cache()
    for key in out[seeds[0]]:
        print(f"cogvlm2 {key} over seeds {list(seeds)}: "
              + ", ".join(f"{out[s][key]:.4e}" for s in seeds))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default=None,
                   help="comma-separated seeds to read the judge's "
                        "fidelity at before the phase")
    p.add_argument("--out", default=None, help="write the readings here")
    args = p.parse_args()
    import chip_smoke as cs

    setup = cs.phase_alone_setup("phase28")
    if setup is None:
        return 1
    dev, generator, drawer, ptxas = setup
    survey = None
    if args.seeds:
        survey = fidelity_survey(dev, [int(x) for x in args.seeds.split(",")])
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"survey": survey}, f)
    out, k28, launches = cs.cogvlm2_phase(dev, generator, drawer)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"phase28": out, "launches": launches, "ptxas": ptxas,
                       "survey": survey,
                       "kernels": {"K3 D112": {str(s): r for s, r in
                                               k28["K3"].items()}}},
                      f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
