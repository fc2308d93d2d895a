"""``chip_smoke.py``'s build and phase 30 (the training options at the 2B
widths) alone on a CUDA card.

    python3 tools/phase30_torch.py [--out FILE]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (a spill or a missing
instantiation is printed, not raised, so that the phase still runs),
then runs ``chip_smoke.training_options_phase``: one value-and-gradient
under ``remat`` False, True and "dots" (bit-equal, each one's peak memory
and time), the ViT's DropPath and dropout (the recompute's masks, the
sharded tower's), four ``Trainer`` micro-steps of AdamW, AdamW with bf16
mu and Adafactor against fp32 plain, and async checkpoints against
blocking ones, each failure raising as in ``chip_smoke.py``.  ``--out``
writes the readings and the launch counts as JSON.
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

    setup = cs.phase_alone_setup("phase30")
    if setup is None:
        return 1
    dev, generator, _, ptxas = setup
    out, launches = cs.training_options_phase(dev, generator)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"phase30": out, "launches": launches, "ptxas": ptxas},
                      f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
