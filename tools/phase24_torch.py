"""``chip_smoke.py``'s build and phase 24 (MJ-VIDEO-4B) alone on a CUDA card.

    python3 tools/phase24_torch.py [--out FILE]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (a spill or a missing
instantiation is printed, not raised, so that the phase still runs),
then runs ``chip_smoke.mjvideo_4b_phase``: K2, its pre-pass and K3 at
D = 96 against their twins, the 4B scorer against fp32 plain, its
checkpoint round trip, the CLI on it and the 4B judge, each failure
raising as in ``chip_smoke.py``.  ``--out`` writes the readings as JSON.
About 2.5 minutes of command time on an H100.
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

    setup = cs.phase_alone_setup("phase24")
    if setup is None:
        return 1
    dev, generator, drawer, ptxas = setup
    out, d96, launches = cs.mjvideo_4b_phase(dev, generator, drawer)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"phase24": out, "launches": launches, "ptxas": ptxas,
                       "kernels": {k: {str(s): r for s, r in v.items()}
                                   for k, v in d96.items()}}, f,
                      default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
