"""``chip_smoke.py``'s build and phase 33 (the (data, model) mesh) alone on
a CUDA card.

    python3 tools/phase33_torch.py [--out FILE]

Prints the card, builds the kernels and reports the Hopper
instantiations' ptxas registers and spills (printed, not raised, so that
the phase still runs), makes phase 4's 2B scorer and scores phase 4's
requests, then runs phase 33: the kernels at a model rank's head counts
(``chip_smoke.check_mesh_kernels``), the pair request through
``RewardScorer(mesh=)`` at ``local(2, 1)``, ``local(1, 2)`` and
``local(2, 2)`` and the weight-only quantized trees at ``local(1, 2)``
(``chip_smoke.mesh_scoring_phase``), stage-3 training at ``local(2, 2)``
with and without ZeRO-1, a save and resume at 2 + 2 layers, and the dry
run (``chip_smoke.mesh_phase_tail``), each failure raising as in
``chip_smoke.py``.  ``--out`` writes the readings and the launch counts as
JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the readings here")
    args = p.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs

    setup = cs.phase_alone_setup("phase33")
    if setup is None:
        return 1
    dev, generator, drawer, ptxas = setup
    scorer = cs.make_scorer(generator(), dev)
    requests = cs.make_requests(scorer, np.random.default_rng(cs.SEED))
    scores = torch.cat([scorer.score_batch(*r).score
                        for r in requests]).float().cpu()
    t0 = time.perf_counter()
    mesh_k = cs.check_mesh_kernels(drawer(generator()),
                                   cs.mesh_train_data()[1], scorer.cfg)
    out, launches = cs.mesh_scoring_phase(scorer, requests, scores[-2:], dev)
    scoring_s = time.perf_counter() - t0
    del scorer, requests
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tail, more = cs.mesh_phase_tail(dev, generator)
    out.update(tail)
    launches.update(more)
    out["command_s"] = scoring_s + time.perf_counter() - t0
    print(f"phase 33 command time {out['command_s']:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**out, "ptxas": ptxas, "launches": launches,
                       "kernels": {f"{n} {s}": r for (n, s), r in
                                   mesh_k.items()}}, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
