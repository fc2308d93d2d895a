"""``chip_smoke.py``'s build and phase 25 (MJ-VIDEO-4B's gradients and
training) alone on a CUDA card.

    python3 tools/phase25_torch.py [--out FILE]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (a spill or a missing
instantiation is printed, not raised, so that the phase still runs),
then runs ``chip_smoke.mjvideo_4b_grad_phase``: K2 lse, K3 lse, K4a and
K4b at D = 96 against their twins, the 4B's reward gradient and VADER
loop, its training gradient against fp32 plain with S1's split, the ring
micro-batch and a stage-3 ``Trainer``, each failure raising as in
``chip_smoke.py``.  ``--out`` writes the readings as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the readings here")
    args = p.parse_args()
    import chip_smoke as cs

    setup = cs.phase_alone_setup("phase25")
    if setup is None:
        return 1
    dev, generator, drawer, ptxas = setup
    out, grad96, launches = cs.mjvideo_4b_grad_phase(dev, generator, drawer)
    if args.out:
        kernel_readings = {
            "dec": {str(s): r for s, r in grad96["dec"].items()},
            "ring": {f"{n} {o}": r for (n, o), r in grad96["ring"].items()},
            **{k: grad96[k] for k in ("k4_turns", "k2_lse_turns",
                                      "k3_lse_turns")}}
        with open(args.out, "w") as f:
            json.dump({"phase25": out, "launches": launches, "ptxas": ptxas,
                       "kernels": kernel_readings}, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
