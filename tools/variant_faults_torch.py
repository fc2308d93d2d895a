"""Fault controls for B1-B3, K2r's pre-pass, the D = 96 forms of K2 lse,
K3 lse, K4a, K4b and K2r's pre-pass, K1 at D = 80, K1 and K1m at D = 72,
K3 at D = 112 and K1 at D = 128, on a CUDA card: each fault planted in a copy of the
tree, and the card tests of its kernel run there.

    python3 tools/variant_faults_torch.py [--out FILE] [--only NAME ...]

For each of FAULTS (or those named by ``--only``), copies
``mjvideo_tpu_torch/``, ``tests/`` and ``pytest.ini`` under
``build/variant_faults/<name>/`` (git-ignored), applies its one edit (as
``sed`` would: the text must occur exactly once), and runs the fault's card
tests there with its own kernel build (``--noconftest -m cuda``).  Prints
the card, and for each fault the tests that failed; exits non-zero if a
fault leaves every test passing.
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
CSRC = "mjvideo_tpu_torch/csrc/"
HEADER = CSRC + "decoder_attention_sm90.cuh"
BWD = CSRC + "attention_bwd_sm90.cuh"
VARIANTS = "tests/test_torch_kernels_variants_sm90.py"
ROWS_BSHD = "tests/test_torch_kernels_rows_bshd_sm90.py"
D96 = "tests/test_torch_kernels_d96_sm90.py"
D80 = "tests/test_torch_kernels_d80_sm90.py"
D72 = "tests/test_torch_kernels_d72_sm90.py"
D112 = "tests/test_torch_kernels_d112_sm90.py"
D128VIT = "tests/test_torch_kernels_d128vit_sm90.py"
# The backward's row store at the layout's 128-column stride where D = 96
# (64 * kBoxes: the same as kD at 64 and 128), for dK/dV's Config (32-row
# streamed tiles) or dQ's (64): rows overlap and the last runs past the
# tensor.
STORE = "* C::kD + 2 * c;"

# (name, file, text, replacement, the card tests that must catch it).
FAULTS = (
    # B1's exp2 modes: the second warpgroup of each CTA leaves its q rows
    # unfolded (and skips its barrier: no other warpgroup waits on it).
    ("fold skips a warpgroup", HEADER,
     "if (VAR == Variant::kFoldQ) {",
     "if (VAR == Variant::kFoldQ && wq != 1) {", VARIANTS),
    # kExact's rescale of o by alpha is skipped (B1 exp2 and bf16s, B2).
    ("rescale skipped", HEADER, "      if (!kFixed) {",
     "      if (false) {", VARIANTS),
    # K2r's scan starts each chunk from 0, not from the earlier chunks'
    # largest partial.
    ("scan skips the earlier chunks", CSRC + "decoder_attention.cu",
     "for (int i = lane; i < c; i += 32)",
     "for (int i = lane; i < 0; i += 32)", ROWS_BSHD),
    # B3 walks all S keys, the ones past kv_valid included.
    ("B3 launches with K = S", CSRC + "vit_attention_variants.cu",
     "out, B, S, kv_valid, H,", "out, B, S, S, H,", ROWS_BSHD),
    # K4a at D = 96 stores dK and dV rows 128 columns apart.
    ("K4a D96 store at the 128-column stride", BWD, STORE,
     "* (C::kBlockN == 32 ? 64 * C::kBoxes : C::kD) + 2 * c;", D96),
    # K4b at D = 96 stores dQ rows 128 columns apart.
    ("K4b D96 store at the 128-column stride", BWD, STORE,
     "* (C::kBlockN == 64 ? 64 * C::kBoxes : C::kD) + 2 * c;", D96),
    # K2 lse at D = 96 writes log(l) without the bound m.
    ("K2 lse D96 drops the row max", HEADER,
     "v = m[r] + logf(fmaxf(l[r], 1e-30f));",
     "v = (C::kD == 96 ? 0.f : m[r]) + logf(fmaxf(l[r], 1e-30f));", D96),
    # K3 lse at D = 96 writes log(l) without the row max.
    ("K3 lse D96 drops the row max", HEADER,
     "v = fmaf(m[r], kLn2, m[r] * kLn2Lo) + logf(l[r]);",
     "v = (C::kD == 96 ? 0.f : fmaf(m[r], kLn2, m[r] * kLn2Lo)) + "
     "logf(l[r]);", D96),
    # K1 at D = 80 stores its output rows 96 columns apart: rows overlap
    # and the last runs past the tensor.
    ("K1 D80 store at the 96-column stride", HEADER,
     "* C::kD + 2 * c;", "* (C::kD == 80 ? 96 : C::kD) + 2 * c;", D80),
    # K2r's pre-pass at D = 96 sums 128 columns a key: its 4 idle lanes add
    # the key's last 16-byte piece again, into the norms and the partials.
    ("K2r D96 norms over 128 columns", CSRC + "decoder_attention.cu",
     "if (kSpare && piece >= kPieces) s = 0.0;",
     "if (kSpare && piece >= kPieces && !NORMS) s = 0.0;", D96),
    # K1 (and K1m) at D = 72 store output rows 80 columns apart: rows
    # overlap and the last runs past the tensor.
    ("K1 D72 store at the 80-column stride", HEADER,
     "* C::kD + 2 * c;", "* (C::kD == 72 ? 80 : C::kD) + 2 * c;", D72),
    # The non-causal masked form (K1m) reads every key as live: its
    # producer's liveness bits ignore the mask (kmax still skips the
    # masked keys).
    ("K1m reads every key as live", HEADER,
     "(mask == nullptr || mask[(long long)b * K + j] != 0)",
     "(mask == nullptr || !CAUSAL || mask[(long long)b * K + j] != 0)",
     D72),
    # K3 at D = 112 stores its output rows 96 columns apart: rows overlap,
    # each row's last 16 columns overwritten by the next row's first.
    ("K3 D112 store at the 96-column stride", HEADER,
     "* C::kD + 2 * c;", "* (C::kD == 112 ? 96 : C::kD) + 2 * c;", D112),
    # K1 at D = 128 (the floored form; K2, K3 and K2r share the Config)
    # stores its output rows 64 columns apart: each row's second box lands
    # on the next row's first.
    ("K1 D128 store at the 64-column stride", HEADER,
     "* C::kD + 2 * c;", "* (C::kD == 128 && FLOOR ? 64 : C::kD) + 2 * c;",
     D128VIT),
)


def run_fault(name: str, source: str, old: str, new: str,
              tests: str) -> dict:
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
        [sys.executable, "-m", "pytest", tests, "--noconftest", "-m", "cuda",
         "-q", "-rf", "-p", "no:cacheprovider"], cwd=root,
        capture_output=True, text=True)
    failed = re.findall(r"^FAILED (\S+)", res.stdout, re.M)
    return {"rc": res.returncode, "failed": failed,
            "summary": res.stdout.strip().splitlines()[-1:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None,
                    help="the names of the faults to plant (default: all)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    out = {}
    for name, source, old, new, tests in FAULTS:
        if args.only is not None and name not in args.only:
            continue
        out[name] = run_fault(name, source, old, new, tests)
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
