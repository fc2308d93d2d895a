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
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the readings here")
    args = p.parse_args()
    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("phase24: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    try:
        ptxas = cs.sm90_ptxas(lib)
    except RuntimeError as e:
        print(f"ptxas check failed: {e}")
        ptxas = None

    def generator():
        return torch.Generator(device=dev).manual_seed(cs.SEED)

    def drawer(g):
        return lambda *shape: torch.randn(shape, generator=g,
                                          device=dev).to(torch.bfloat16)

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
