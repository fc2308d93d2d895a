"""``chip_smoke.py``'s build and phase 34 (the judges on a (data, model)
mesh) alone on a CUDA card.

    python3 tools/phase34_torch.py [--out FILE] [--only PART ...]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (printed, not raised, so that
the phase still runs), then runs phase 34: the kernels at a model rank's
head counts against their twins (``chip_smoke.check_judge_mesh_kernels``),
the InternVL2-2B judge at ``local(1, 2)`` and ``(2, 2)`` with the dense and
the int8 KV cache and ``int4-wo`` at ``(1, 2)``
(``chip_smoke.internvl2b_mesh_phase``), the MiniCPM-V-2.6, CogVLM2-Video,
Qwen2-VL-2B and VideoScore judges at ``(1, 2)``
(``chip_smoke.families_mesh_phase``) and the InternVL2-26B judge with its
tower at ``local(1, 5)`` and its decoder at ``(1, 2)``
(``chip_smoke.internvl26b_mesh_phase``), each failure raising as in
``chip_smoke.py``.  ``--only`` runs the named parts (``kernels``,
``internvl2b``, ``families``, ``internvl26b``) alone.  ``--out`` writes the
readings and the launch counts as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PARTS = ("kernels", "internvl2b", "families", "internvl26b")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the readings here")
    p.add_argument("--only", nargs="*", choices=PARTS, default=PARTS,
                   help="the parts to run (default: all)")
    args = p.parse_args()
    import gc

    import torch

    import chip_smoke as cs

    setup = cs.phase_alone_setup("phase34")
    if setup is None:
        return 1
    dev, generator, drawer, ptxas = setup
    out, launches, k34 = {}, {}, {}
    t_all = time.perf_counter()
    if "kernels" in args.only:
        t0 = time.perf_counter()
        k34 = cs.check_judge_mesh_kernels(drawer(generator()))
        out["kernel_checks_s"] = time.perf_counter() - t0
    for part, fn in (("internvl2b", cs.internvl2b_mesh_phase),
                     ("families", cs.families_mesh_phase),
                     ("internvl26b", cs.internvl26b_mesh_phase)):
        if part not in args.only:
            continue
        t0 = time.perf_counter()
        got, more = fn(dev, generator)
        out.update(got)
        launches.update(more)
        out[f"{part}_s"] = time.perf_counter() - t0
        print(f"phase 34 {part}: {out[f'{part}_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    out["command_s"] = time.perf_counter() - t_all
    print(f"phase 34 command time {out['command_s']:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**out, "ptxas": ptxas, "launches": launches,
                       "kernels": {f"{n} {s}": r for (n, s), r in
                                   k34.items()}}, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
