"""``chip_smoke.py``'s build and phase 31 (LoRA and QLoRA training at the 2B
widths) alone on a CUDA card, and with ``--serving`` phase 32 (the serving
example) too.

    python3 tools/phase31_torch.py [--serving] [--out FILE]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (a spill or a missing
instantiation is printed, not raised, so that the phase still runs),
then runs ``chip_smoke.lora_phase``: the wrapped forward bit-equal to the
unwrapped one, four LoRA micro-steps with phase 5's checks and launches,
the merged state's score, a LoRA micro-step timed against a full stage-3
one, the adapters' gradient against fp32 plain, QLoRA over ``int8-wo`` and
``int4-wo`` and the async save and resume of the int4 run, each failure
raising as in ``chip_smoke.py``.  ``--serving`` first writes phase 4's 2B
state (``chip_smoke.make_scorer``) as an F32 checkpoint directory under a
temporary directory, as phase 22 does, and runs
``chip_smoke.serving_example_phase`` on it.  ``--out`` writes the readings
and the launch counts as JSON.
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--serving", action="store_true",
                   help="run phase 32 on a checkpoint directory first")
    p.add_argument("--out", default=None, help="write the readings here")
    args = p.parse_args()
    import chip_smoke as cs

    setup = cs.phase_alone_setup("phase31")
    if setup is None:
        return 1
    dev, generator, _, ptxas = setup
    out, launches = {"ptxas": ptxas}, {}
    if args.serving:
        import torch

        from mjvideo_tpu_torch.utils.export import save_reward_checkpoint_dir

        scorer = cs.make_scorer(generator(), dev)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            save_reward_checkpoint_dir(d, scorer.params, scorer.cfg)
            print(f"phase 32: the 2B written in "
                  f"{time.perf_counter() - t0:.1f} s")
            out["phase32"], launches["serving_example"] = (
                cs.serving_example_phase(scorer, d, dev))
        del scorer
        torch.cuda.empty_cache()
    out["phase31"], more = cs.lora_phase(dev, generator, timing=True)
    launches.update(more)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**out, "launches": launches}, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
