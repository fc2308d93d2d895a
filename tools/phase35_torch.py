"""``chip_smoke.py``'s build and phase 35 (the w8a8 serving modes and LoRA
under the model axis) alone on a CUDA card.

    python3 tools/phase35_torch.py [--out FILE] [--only PART ...]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (printed, not raised, so that
the phase still runs), then runs phase 35: (a) K6 at a model rank's
shapes against its twin and phase 4's pair scored in each
``chip_smoke.SCORE_QUANT_MODES`` mode at ``local(1, 2)`` and ``(2, 2)``
(``chip_smoke.w8a8_mesh_scoring_phase``; the unsharded quantized scores
and the fp32 plain ones that phase 11 gives the script come from
``chip_smoke.w8a8_scoring_refs`` here, and the bf16 delta of phase 33 (a)
is not printed); (b) LoRA at ``local(2, 2)`` with ZeRO-1, QLoRA at
``(1, 2)`` and a save resumed unsharded (``chip_smoke.lora_mesh_phase``);
(c) the 2B judge under ``int8`` at ``(1, 2)``
(``chip_smoke.w8a8_judge_mesh_phase``), each failure raising as in
``chip_smoke.py``.  ``--only`` runs the named parts (``scoring``,
``lora``, ``judge``) alone.  ``--out`` writes the readings and the launch
counts as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PARTS = ("scoring", "lora", "judge")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the readings here")
    p.add_argument("--only", nargs="*", choices=PARTS, default=PARTS,
                   help="the parts to run (default: all)")
    args = p.parse_args()
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs

    setup = cs.phase_alone_setup("phase35")
    if setup is None:
        return 1
    dev, generator, drawer, ptxas = setup
    out, launches, k6 = {}, {}, {}
    t_all = time.perf_counter()
    if "scoring" in args.only:
        t0 = time.perf_counter()
        scorer = cs.make_scorer(generator(), dev)
        pair = cs.make_requests(scorer, np.random.default_rng(cs.SEED))[1]
        refs = cs.w8a8_scoring_refs(scorer, pair)
        got, k6, more = cs.w8a8_mesh_scoring_phase(scorer, pair, refs,
                                                   drawer(generator()))
        out["scoring"], out["scoring_s"] = got, time.perf_counter() - t0
        launches.update(more)
        print(f"phase 35 (a): {out['scoring_s']:.1f} s")
        del scorer
        gc.collect()
        torch.cuda.empty_cache()
    if "lora" in args.only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            out["lora"], more = cs.lora_mesh_phase(dev, generator, d)
        out["lora_s"] = time.perf_counter() - t0
        launches.update(more)
        print(f"phase 35 (b): {out['lora_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    if "judge" in args.only:
        t0 = time.perf_counter()
        out["judge"], more = cs.w8a8_judge_mesh_phase(dev, generator)
        out["judge_s"] = time.perf_counter() - t0
        launches.update(more)
        print(f"phase 35 (c): {out['judge_s']:.1f} s")
    out["command_s"] = time.perf_counter() - t_all
    print(f"phase 35 command time {out['command_s']:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**out, "ptxas": ptxas, "launches": launches,
                       "k6_rank_shapes": {str(s): r for s, r in k6.items()}},
                      f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
