"""``chip_smoke.py``'s build and phase 27 (SigLIP's attention at D = 72,
VideoScore and MiniCPM-V-2.6) alone on a CUDA card.

    python3 tools/phase27_torch.py [--out FILE]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (a spill or a missing
instantiation is printed, not raised, so that the phase still runs),
then runs ``chip_smoke.siglip_phase``: K1, K1m and their pre-pass at
D = 72 against their twins, VideoScore at full dims against fp32 plain
with S1's split (a 16-frame clip and the split-frames path), the
MiniCPM-V-2.6 judge at full dims by both paths against fp32 plain, and
the two judges' CLI on small-depth directories, each failure raising as in
``chip_smoke.py``.  ``--out`` writes the readings and the launch counts as
JSON.
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

    setup = cs.phase_alone_setup("phase27")
    if setup is None:
        return 1
    dev, generator, drawer, ptxas = setup
    out, k27, launches = cs.siglip_phase(dev, generator, drawer)
    if args.out:
        kernel_readings = {
            "K1": {str(s): r for s, r in k27["K1"].items()},
            "K1m": k27["K1m"]}
        with open(args.out, "w") as f:
            json.dump({"phase27": out, "launches": launches, "ptxas": ptxas,
                       "kernels": kernel_readings}, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
