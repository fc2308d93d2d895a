"""A/B of K1's D = 64 Config on a CUDA card: consumer warpgroups and kv
stages of the wgmma/TMA template.

    python3 tools/d64_config_ab_torch.py [--rounds 10]

For each (warpgroups, stages) of CONFIGS, copies ``mjvideo_tpu_torch/csrc``
into ``build/d64_ab/wg<W>_st<S>/`` (git-ignored), rewrites the one line
``using D64 = Config<64, 3, 3>;`` of the copy's
``decoder_attention_sm90.cuh`` and builds the copy's ``vit_attention.cu``
into a library of its own, all configurations at once with the port's
nvcc flags; the registers follow the warpgroups (``Regs``).  Each is then
held against K1's twin at chip_smoke's K1_SHAPES on qkv views (to
KERNEL_REL_TOL of max|plain|) and timed in turns with the others and
``F.scaled_dot_product_attention`` by CUDA events around one launch of its
C entry on the pre-pass's kmax (the kernel alone).  Prints the card, each
configuration's ptxas line, the medians, their share of the bound, and one
JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CONFIGS = ((2, 3), (2, 4), (3, 2), (3, 3), (3, 4))
PRODUCTION = "using D64 = Config<64, 3, 3>;"


def build_config(wg: int, stages: int) -> Path:
    """The library of ``vit_attention.cu`` with D64 = Config<64, wg,
    stages>; its ptxas report beside it."""
    from mjvideo_tpu_torch import kernels

    src = REPO / "build" / "d64_ab" / f"wg{wg}_st{stages}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    header = src / "decoder_attention_sm90.cuh"
    text = header.read_text()
    if text.count(PRODUCTION) != 1:
        raise RuntimeError(f"{PRODUCTION!r} not found once in {header}")
    header.write_text(text.replace(
        PRODUCTION, f"using D64 = Config<64, {wg}, {stages}>;"))
    lib = src / "libk1.so"
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src / "vit_attention.cu")], capture_output=True, text=True)
    (src / "ptxas.txt").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc wg={wg} stages={stages}:\n{res.stderr}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("d64_config_ab_torch: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import (K1_SHAPES, KERNEL_REL_TOL, SEED, _attention_work,
                            _bound, _in_turns, _rel_err, _sdpa)
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    with concurrent.futures.ThreadPoolExecutor(len(CONFIGS)) as pool:
        paths = list(pool.map(lambda c: build_config(*c), CONFIGS))
    libs = {}
    for (wg, st), path in zip(CONFIGS, paths):
        report = (path.parent / "ptxas.txt").read_text().splitlines()
        for i, line in enumerate(report):
            if "Function properties for" in line and "attention_sm90" in line:
                print(f"ptxas wg={wg} stages={st}: " + "; ".join(
                    x.split(":", 1)[-1].strip() for x in report[i + 1:i + 3]))
        lib = ctypes.CDLL(str(path))
        lib.mjv_vit_attention.argtypes = kernels.ARGTYPES["mjv_vit_attention"]
        lib.mjv_vit_attention.restype = ctypes.c_int
        libs[f"wg={wg} stages={st}"] = lib

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for shape in K1_SHAPES:
        B, S, H, D = shape
        q, k, v = (t.view(B, S, H, D) for t in torch.randn(
            (B, S, 3 * H * D), generator=g, device=dev).to(
                torch.bfloat16).split(H * D, dim=-1))
        kmax = kernels.key_norm_max(k)
        ref = fa.vit_attention_plain(q, k, v)
        stream = torch.cuda.current_stream().cuda_stream
        dst = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)

        def launcher(lib):
            def run():
                err = lib.mjv_vit_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kmax.data_ptr(), dst.data_ptr(), None, B, S, H, D,
                    q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                    v.stride(0), v.stride(1), D ** -0.5, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")
            return run

        runs = {name: launcher(lib) for name, lib in libs.items()}
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            rel = _rel_err(dst, ref)[1]
            print(f"K1 {name} {shape}: {rel:.3e} of max|plain| (bound "
                  f"{KERNEL_REL_TOL:.2e})")
            if not rel <= KERNEL_REL_TOL:
                raise RuntimeError(f"K1 {name} {shape}: beyond its bound")
        runs["SDPA"] = _sdpa(q, k, v, causal=False)
        med = _in_turns(runs, list(runs) + list(runs)[::-1], args.rounds)
        bound = _bound(*_attention_work(q, k, v, None, causal=False))
        print(f"K1 D = 64 A/B at {shape}, in turns (median of "
              f"{2 * args.rounds}; bound {bound['bound_ms']:.4f} ms by "
              f"{bound['bound_by']}): " + ", ".join(
                  f"{n} {t:.4f} ms ({100 * bound['bound_ms'] / t:.1f}%)"
                  for n, t in med.items()))
        out[str(shape)] = med
    print(smi)
    print(json.dumps({"d64_ab": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
