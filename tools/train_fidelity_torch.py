"""Phase 6's training-gradient fidelity of ``chip_smoke.py`` for several
checkouts on one card, from one saved state, to tell a kernel's effect on
the gradient from the weights' (ROADMAP Queue 3, S2).

    python3 tools/train_fidelity_torch.py --root CHECKOUT --root OTHER ...

Each checkout runs in its own process with its own ``chip_smoke.py`` and
kernels (unpack another commit with ``git archive`` into the git-ignored
``build/``).  Each reads the gradient fidelity (bf16 with the kernels
against fp32 plain autograd, the same weights and micro-batch: relative L2
and cosine of the trainable gradient) twice: at the seed-0 weights
(``make_trainer``), and at the weights after phase 5's micro-batches (two
optimizer steps).  The first checkout takes those steps and saves the
trainable tensors to ``--state`` (default ``build/train_fidelity_state.pt``,
git-ignored); the others load them, so every checkout reads the same
stepped weights.  Prints one JSON line per checkout and a table.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _fidelity(gradient_fidelity, trainer, batch) -> dict:
    try:
        loss_delta, rel_l2, cos, _ = gradient_fidelity(trainer, batch)
        return {"rel_l2": rel_l2, "cosine": cos, "loss_delta": loss_delta}
    except RuntimeError as e:  # beyond chip_smoke's bars: keep the reading
        return {"raised": str(e)}


def run(root: str, state: Path, make: bool) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch.train.trainer import flatten_state

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"root": root, "chip_smoke": cs.__file__}
    with tempfile.TemporaryDirectory() as ckpt:
        trainer, batches = cs.make_trainer(
            torch.Generator(device=dev).manual_seed(cs.SEED), dev, ckpt,
            cs.train_data())
        out["seed0"] = _fidelity(cs.gradient_fidelity, trainer, batches[0])
        flat = flatten_state(trainer.params)
        paths = trainer.optimizer.paths
        if make:
            for batch in batches:
                trainer.train([batch])
            torch.save({p: flat[p].detach().cpu() for p in paths}, state)
            out["steps"] = trainer.opt_state["gradient_step"]
        else:
            saved = torch.load(state)
            with torch.no_grad():
                for p in paths:
                    flat[p].copy_(saved[p].to(dev))
            del saved
        out["stepped"] = _fidelity(cs.gradient_fidelity, trainer, batches[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--state", type=Path,
                    default=REPO / "build" / "train_fidelity_state.pt")
    ap.add_argument("--make", action="store_true",
                    help="(one checkout) take the steps and save the state")
    args = ap.parse_args()
    if len(args.root) == 1:
        print(json.dumps(run(args.root[0], args.state, args.make)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    args.state.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, root in enumerate(args.root):
        cmd = [sys.executable, __file__, "--root", root, "--state",
               str(args.state)] + (["--make"] if i == 0 else [])
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    args.state.unlink()
    for r in runs:
        cells = [f"{w}: " + (f"rel L2 {r[w]['rel_l2']:.4e}, cosine "
                             f"{r[w]['cosine']:.6f}" if "rel_l2" in r[w]
                             else r[w]["raised"])
                 for w in ("seed0", "stepped")]
        print(f"{r['root']}: " + "; ".join(cells))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
