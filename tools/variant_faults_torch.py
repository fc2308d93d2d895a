"""Fault controls for B1 and B2 on a CUDA card: each fault planted in a
copy of the tree, and the card tests of the variants run there.

    python3 tools/variant_faults_torch.py [--out FILE]

For each of FAULTS, copies ``mjvideo_tpu_torch/``, ``tests/`` and
``pytest.ini`` under ``build/variant_faults/<name>/`` (git-ignored),
applies its one edit (as ``sed`` would: the text must occur exactly once),
and runs ``tests/test_torch_kernels_variants_sm90.py`` there with its own
kernel build (``--noconftest -m cuda``).  Prints the card, and for each
fault the tests that failed; exits non-zero if a fault leaves every test
passing.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
HEADER = "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh"
TESTS = "tests/test_torch_kernels_variants_sm90.py"

# (name, file, text, replacement).
FAULTS = (
    # B1's exp2 modes: the second warpgroup of each CTA leaves its q rows
    # unfolded (and skips its barrier: no other warpgroup waits on it).
    ("fold skips a warpgroup", HEADER,
     "if (VAR == Variant::kFoldQ) {",
     "if (VAR == Variant::kFoldQ && wq != 1) {"),
    # kExact's rescale of o by alpha is skipped (B1 exp2 and bf16s, B2).
    ("rescale skipped", HEADER, "      if (!kFixed) {",
     "      if (false) {"),
)


def run_fault(name: str, source: str, old: str, new: str) -> dict:
    root = REPO / "build" / "variant_faults" / re.sub(r"\W+", "_", name)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shutil.copytree(REPO / "mjvideo_tpu_torch", root / "mjvideo_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(REPO / "tests", root / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "pytest.ini", root / "pytest.ini")
    path = root / source
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: {old!r} not found once in {source}")
    path.write_text(text.replace(old, new))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", TESTS, "--noconftest", "-m", "cuda",
         "-q", "-rf", "-p", "no:cacheprovider"], cwd=root,
        capture_output=True, text=True)
    failed = re.findall(r"^FAILED (\S+)", res.stdout, re.M)
    return {"rc": res.returncode, "failed": failed,
            "summary": res.stdout.strip().splitlines()[-1:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    out = {}
    for name, source, old, new in FAULTS:
        out[name] = run_fault(name, source, old, new)
        print(f"fault {name!r}: {len(out[name]['failed'])} tests failed "
              f"{out[name]['failed']}; {out[name]['summary']}")
    line = json.dumps({"card": smi, "faults": out})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(smi)
    print(line)
    return 0 if all(r["failed"] for r in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
