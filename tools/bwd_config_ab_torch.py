"""A/B of K4 nc's Configs on a CUDA card: the tiles, consumer warpgroups
and stages of the dK/dV and dQ kernels of the wgmma/TMA backward template.

    python3 tools/bwd_config_ab_torch.py [--rounds 10] [--parent ROOT]

For each pair of CONFIGS (a dK/dV Config and a dQ Config), copies
``mjvideo_tpu_torch/csrc`` into ``build/bwd_ab/<name>/`` (git-ignored),
rewrites the two lines ``using DkdvD64 = ...;`` and ``using DqD64 = ...;``
of the copy's ``attention_bwd_sm90.cuh`` and builds the copy's
``vit_attention_bwd.cu`` into a library of its own, all at once with the
port's nvcc flags; the registers follow the warpgroups (``Regs``).
``--parent ROOT`` also builds ROOT's ``vit_attention_bwd.cu`` (another
checkout, e.g. a ``git archive`` of the parent commit) as ``parent``.
Each library is held against the twin at chip_smoke's K1_SHAPES on qkv
views (to KERNEL_REL_TOL of max|plain|), then each kernel is timed in turns
with its alternatives and ``F.scaled_dot_product_attention``'s backward
(dQ, dK and dV in one call) by CUDA events around one launch of its C
entry.  Prints the card, each build's ptxas lines (registers, spills), the
medians with their share of the bound, and one JSON line.
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

# (name, dK/dV Config, dQ Config): Config<D, warpgroups, stages, streamed
# rows>, named kv<warpgroups>.<stages>.<rows>_q<...>.  The first pair is
# the production one.  dK/dV with 3 warpgroups (160 registers a consumer
# thread) or 128-row q tiles spills: 64 fp32 scores and 64 fp32 outputs a
# thread, with the packed scores of the tile before.
CONFIGS = (
    ("kv2.3.64_q3.4.64", "Config<64, 2, 3, 64>", "Config<64, 3, 4, 64>"),
    ("kv2.2.64_q3.3.64", "Config<64, 2, 2, 64>", "Config<64, 3, 3, 64>"),
    ("kv2.4.64_q3.2.64", "Config<64, 2, 4, 64>", "Config<64, 3, 2, 64>"),
    ("kv3.3.64_q2.3.128", "Config<64, 3, 3, 64>", "Config<64, 2, 3, 128>"),
    ("kv2.3.128_q2.3.64", "Config<64, 2, 3, 128>", "Config<64, 2, 3, 64>"),
)
PRODUCTION = ("using DkdvD64 = Config<64, 2, 3, 64>;",
              "using DqD64 = Config<64, 3, 4, 64>;")


def _nvcc_lib(src: Path, out: Path, label: str) -> Path:
    from mjvideo_tpu_torch import kernels

    lib = out / "libk4nc.so"
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src / "vit_attention_bwd.cu")], capture_output=True, text=True)
    (out / "ptxas.txt").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {label}:\n{res.stderr}")
    return lib


def build_config(name: str, dkdv: str, dq: str) -> Path:
    """The library of ``vit_attention_bwd.cu`` with the two Configs."""
    from mjvideo_tpu_torch import kernels

    src = REPO / "build" / "bwd_ab" / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    header = src / "attention_bwd_sm90.cuh"
    text = header.read_text()
    for line in PRODUCTION:
        if text.count(line) != 1:
            raise RuntimeError(f"{line!r} not found once in {header}")
    text = text.replace(PRODUCTION[0], f"using DkdvD64 = {dkdv};")
    text = text.replace(PRODUCTION[1], f"using DqD64 = {dq};")
    header.write_text(text)
    return _nvcc_lib(src, src, name)


def build_parent(root: Path) -> Path:
    out = REPO / "build" / "bwd_ab" / "parent"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    return _nvcc_lib(root / "mjvideo_tpu_torch" / "csrc", out, "parent")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bwd_config_ab_torch: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import (K1_SHAPES, KERNEL_REL_TOL, SEED, _attention_work,
                            _bound, _in_turns, _rel_err, _sdpa)
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    jobs = {name: (build_config, (name, dkdv, dq))
            for name, dkdv, dq in CONFIGS}
    if args.parent is not None:
        jobs["parent"] = (build_parent, (args.parent.resolve(),))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {n: pool.submit(fn, *a) for n, (fn, a) in jobs.items()}
        paths = {n: f.result() for n, f in futures.items()}
    libs, ptxas = {}, {}
    for name, path in paths.items():
        report = (path.parent / "ptxas.txt").read_text().splitlines()
        for i, line in enumerate(report):
            if "Function properties for" in line and (
                    "dkdv" in line or "dq" in line):
                kind = "dkdv" if "dkdv" in line else "dq"
                props = "; ".join(x.split(":", 1)[-1].strip()
                                  for x in report[i + 1:i + 3])
                ptxas[f"{name} {kind}"] = props
                print(f"ptxas {name} {kind}: {props}")
        lib = ctypes.CDLL(str(path))
        for entry in ("mjv_vit_attention_bwd_dkdv", "mjv_vit_attention_bwd_dq"):
            fn = getattr(lib, entry)
            fn.argtypes = kernels.ARGTYPES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for shape in K1_SHAPES:
        B, S, H, D = shape
        q, k, v = (t.view(B, S, H, D) for t in torch.randn(
            (B, S, 3 * H * D), generator=g, device=dev).to(
                torch.bfloat16).split(H * D, dim=-1))
        dout = torch.randn((B, S, H, D), generator=g, device=dev).to(
            torch.bfloat16)
        ref, lse = fa.vit_attention_plain(q, k, v, return_lse=True)
        delta = fa.attention_delta(ref, dout)
        rdq, rdk, rdv = fa.vit_attention_bwd_plain(q, k, v, dout, lse, delta)
        del ref
        stream = torch.cuda.current_stream().cuda_stream
        dk, dv, dq = (torch.empty_like(dout) for _ in range(3))
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr())
        tail = (B, S, H, D, q.stride(0), q.stride(1), k.stride(0),
                k.stride(1), v.stride(0), v.stride(1), dout.stride(0),
                dout.stride(1), D ** -0.5, stream)

        def launcher(lib, kind):
            def run():
                if kind == "dkdv":
                    err = lib.mjv_vit_attention_bwd_dkdv(
                        *head, dk.data_ptr(), dv.data_ptr(), *tail)
                else:
                    err = lib.mjv_vit_attention_bwd_dq(
                        *head, dq.data_ptr(), *tail)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")
            return run

        readings = {}
        for kind, outs in (("dkdv", ((dk, rdk), (dv, rdv))),
                           ("dq", ((dq, rdq),))):
            runs = {name: launcher(lib, kind) for name, lib in libs.items()}
            for name, run in runs.items():
                run()
                torch.cuda.synchronize()
                rel = max(_rel_err(got, want)[1] for got, want in outs)
                print(f"K4 nc {kind} {name} {shape}: {rel:.3e} of "
                      f"max|plain| (bound {KERNEL_REL_TOL:.2e})")
                if not rel <= KERNEL_REL_TOL:
                    raise RuntimeError(f"K4 nc {kind} {name} {shape}: beyond "
                                       "its bound")
            runs["SDPA backward"] = _sdpa(q, k, v, causal=False,
                                          backward=True)
            med = _in_turns(runs, list(runs) + list(runs)[::-1], args.rounds)
            matmuls, outputs = (4, (k, v)) if kind == "dkdv" else (3, None)
            bound = _bound(*_attention_work(
                q, k, v, None, causal=False, matmuls=matmuls,
                inputs=(dout, lse, delta), outputs=outputs))
            print(f"K4 nc {kind} A/B at {shape}, in turns (median of "
                  f"{2 * args.rounds}; bound {bound['bound_ms']:.4f} ms by "
                  f"{bound['bound_by']}): " + ", ".join(
                      f"{n} {t:.4f} ms ({100 * bound['bound_ms'] / t:.1f}%)"
                      for n, t in med.items()))
            readings[kind] = {"ms": med, "bound_ms": bound["bound_ms"]}
        out[str(shape)] = readings
    print(smi)
    print(json.dumps({"k4nc_ab": out, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
