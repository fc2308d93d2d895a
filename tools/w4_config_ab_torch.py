"""A/B of K5's Configs on a CUDA card: the columns per CTA, the warps along
K, the k-blocks in flight (stages), the largest cluster (the K split) and
the CTAs wanted before K is split, of the int4 GEMV in
``csrc/w4_matmul.cu``, and the parent's K5.

    python3 tools/w4_config_ab_torch.py [--rounds 10] [--parent ROOT]

For each of CONFIGS, copies ``mjvideo_tpu_torch/csrc`` into
``build/w4_ab/<name>/`` (git-ignored), rewrites the copy's two
production Configs (``using W4 = ...;`` for M <= 16 and ``using W4Wide =
...;`` above) to the entry's (or, for a PROBE, some lines of the source)
and builds the copy's ``w4_matmul.cu`` into a library of its own, all at
once with the port's nvcc flags.  ``--parent ROOT`` also builds ROOT's
``w4_matmul.cu`` (another checkout, e.g. a ``git archive`` of the parent commit, whose K5
takes the packed weight row-major and adds into a zeroed output) as
``parent``: the CUDA-core FMA design, so its rows are also the A/B of a
CUDA-core path against the tensor-core one at each M.

At each of chip_smoke's W4_SHAPES (g 128) and W4_ROWS, each library's K5
(through its C entry) is held to KERNEL_REL_TOL of the twin, a second
launch bit-identical (but the PROBES, timing-only edits whose outputs are
not held, and the parent, whose atomics are not); then
- the device time a launch with the L2 cold (``chip_smoke.cold_l2_ms``:
  a CUDA graph of launches over weight copies past 100 MB; the parent's
  launches each behind the memset of its output, which it needs);
- the C entries in turns (CUDA events around one call from the host, the
  weight hot in the L2), with bf16 ``torch.matmul`` at the same (M, K, N)
  (a labelled reference, not the same function);
- the library yardstick, ``torch._weight_int4pack_mm`` on the same
  nibbles and scales (``chip_smoke.int4pack_library``, converted once
  outside the timed region; N a multiple of 8, so not the LM head), held
  to KERNEL_REL_TOL of the twin, timed cold as above and hot in turns.
Prints the card, each build's ptxas lines (registers, spills), the times
with their share of the bytes bound, for each M the fastest build, and
one JSON line.
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

# (name, Config<BN, KW, STAGES, CLUSTER_MAX, WAVES>): each replaces both
# production Configs (W4 for M <= 16, W4Wide above); "production" keeps
# them.
CONFIGS = (
    ("production", None),
    ("bn128.kw2.s2.cl8.w1", "Config<128, 2, 2, 8, 1>"),
    ("bn256.kw1.s2.cl8.w1", "Config<256, 1, 2, 8, 1>"),
    ("bn64.kw1.s2.cl8.w1", "Config<64, 1, 2, 8, 1>"),
    ("bn32.kw4.s2.cl8.w1", "Config<32, 4, 2, 8, 1>"),
    ("bn64.kw2.s1.cl8.w1", "Config<64, 2, 1, 8, 1>"),
    ("bn64.kw2.s3.cl8.w1", "Config<64, 2, 3, 8, 1>"),
    ("bn64.kw2.s2.cl4.w1", "Config<64, 2, 2, 4, 1>"),
    ("bn64.kw2.s2.cl8.w2", "Config<64, 2, 2, 8, 2>"),
)
PRODUCTION = ("using W4 = Config<64, 2, 2, 8, 1>;",
              "using W4Wide = Config<128, 2, 1, 8, 1>;")
MMA = """\
          mma_bf16(acc[j][0], a[0], b.x, b.y);
          mma_bf16(acc[j][1], a[1], b.x, b.y);"""
PRODUCTS = "        products(ring[i], b);"
CLUSTER = "  cg::cluster_group cluster = cg::this_cluster();\n"
# Probes of the production Configs, timed but not the function (their
# outputs are not held), each (name, [(source text, its replacement)]):
# the loads and dequantization with no products, the loads alone, and a
# kernel that returns at once (the launch alone).
PROBES = (
    ("probe: no products", [(MMA, """\
          acc[j][0][0] += __uint_as_float(a[0][0] ^ a[0][3] ^ b.x);
          acc[j][1][0] += __uint_as_float(a[1][0] ^ a[1][3] ^ b.y);""")]),
    ("probe: loads only", [(PRODUCTS, """\
        acc[0][0][0] += __uint_as_float(ring[i].w[0].x ^ ring[i].w[1].y ^
                                        ring[i].w[2].z ^ ring[i].w[3].w ^
                                        ring[i].s[0][0] ^ ring[i].s[1][3]);""")]),
    ("probe: empty", [(CLUSTER, "  if (M > 0) return;\n" + CLUSTER)]),
)
TIMING_ONLY = ("probe: no products", "probe: loads only", "probe: empty")


def _nvcc_lib(src: Path, out: Path, label: str) -> Path:
    from mjvideo_tpu_torch import kernels

    lib = out / "libw4.so"
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src / "w4_matmul.cu")], capture_output=True, text=True)
    (out / "ptxas.txt").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {label}:\n{res.stderr[-4000:]}")
    return lib


def build_config(name: str, config, edits=()) -> Path:
    from mjvideo_tpu_torch import kernels

    src = REPO / "build" / "w4_ab" / name.replace(" ", "_").replace(
        ":", "").replace(",", "")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    source = src / "w4_matmul.cu"
    text = source.read_text()
    lines = [] if config is None else [
        (PRODUCTION[0], f"using W4 = {config};"),
        (PRODUCTION[1], f"using W4Wide = {config};")]
    for old, new in [*lines, *edits]:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} not found once in {source}")
        text = text.replace(old, new)
    source.write_text(text)
    return _nvcc_lib(src, src, name)


def build_parent(root: Path) -> Path:
    out = REPO / "build" / "w4_ab" / "parent"
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
        print("w4_config_ab_torch: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import (BF16_OPS_PER_S, KERNEL_REL_TOL, SEED, W4_GROUP,
                            W4_ROWS, W4_SHAPES, _bound, _in_turns, _nbytes,
                            _rel_err, cold_l2_ms, int4pack_library,
                            weight_copies)
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import quant4 as q4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    jobs = {name: (build_config, (name, config)) for name, config in CONFIGS}
    for name, edits in PROBES:
        jobs[name] = (build_config, (name, CONFIGS[0][1], edits))
    if args.parent is not None:
        jobs["parent"] = (build_parent, (args.parent.resolve(),))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {n: pool.submit(fn, *a) for n, (fn, a) in jobs.items()}
        paths = {n: f.result() for n, f in futures.items()}
    libs, ptxas = {}, {}
    for name, path in paths.items():
        report = (path.parent / "ptxas.txt").read_text().splitlines()
        for i, line in enumerate(report):
            if "Function properties for" in line and "w4_" in line:
                props = "; ".join(x.split(":", 1)[-1].strip()
                                  for x in report[i + 1:i + 3])
                ptxas.setdefault(name, []).append(props)
                print(f"ptxas {name}: {line.split('for', 1)[-1].strip()}: "
                      f"{props}")
        fn = ctypes.CDLL(str(path)).mjv_w4_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = kernels.ARGTYPES["mjv_w4_matmul"]
        libs[name] = fn

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for K, N in W4_SHAPES:
        G = K // W4_GROUP
        k4 = q4.quantize_kernel_q4(
            torch.randn((K, N), generator=g, device=dev) * 0.02,
            group_size=W4_GROUP)
        copies = weight_copies((k4.packed, k4.scale))
        lib = int4pack_library(k4.packed, k4.scale, W4_GROUP)
        lib_copies = None if lib is None else weight_copies(lib[::2])
        rows = None
        if "parent" in libs:
            rows = (k4.packed.contiguous(),)
            row_copies = [(p.contiguous(), s) for p, s in copies]
        for M in W4_ROWS:
            x = torch.randn((M, K), generator=g, device=dev).to(
                torch.bfloat16)
            want = q4.w4_matmul_plain(x, k4.packed, k4.scale)
            o = torch.empty((M, N), dtype=torch.float32, device=dev)

            def launcher(name, fn, x=x, o=o, M=M):
                parent = name == "parent"

                def run(packed, scale):
                    if parent:
                        o.zero_()
                    err = fn(x.data_ptr(), packed.data_ptr(),
                             scale.data_ptr(), o.data_ptr(), M, N, K, G,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                return run

            runs = {name: launcher(name, fn) for name, fn in libs.items()}
            held = {}
            for name, run in runs.items():
                operands = (rows[0] if name == "parent" else k4.packed,
                            k4.scale)
                o.fill_(float("nan"))
                run(*operands)
                first = o.clone()
                run(*operands)
                torch.cuda.synchronize()
                if name in TIMING_ONLY:
                    continue
                rel = _rel_err(first, want)[1]
                same = torch.equal(first, o)
                held[name] = {"rel_err": rel, "bit_identical": same}
                if not rel <= KERNEL_REL_TOL or (name != "parent"
                                                 and not same):
                    raise RuntimeError(
                        f"K5 {name} {(M, K, N)}: {rel:.3e} of max|plain|, "
                        f"a second launch bit-identical {same}")
            cold = {name: cold_l2_ms(run, row_copies if name == "parent"
                                     else copies)
                    for name, run in runs.items()}
            hot_runs = {name: (lambda run=run, name=name: run(
                rows[0] if name == "parent" else k4.packed, k4.scale))
                for name, run in runs.items()}
            w16 = torch.randn((K, N), generator=g, device=dev).to(
                torch.bfloat16)
            hot_runs["bf16 matmul"] = lambda x=x, w16=w16: torch.matmul(x, w16)
            library = {}
            if lib is not None:
                rel = _rel_err(torch._weight_int4pack_mm(x, *lib), want)[1]
                if not rel <= KERNEL_REL_TOL:
                    raise RuntimeError(
                        f"_weight_int4pack_mm {(M, K, N)}: {rel:.3e} of "
                        "max|plain|: the repacked weight is not K5's")
                library = {"rel_err": rel, "cold_ms": cold_l2_ms(
                    lambda w, sz, x=x: torch._weight_int4pack_mm(
                        x, w, W4_GROUP, sz), lib_copies)}
                hot_runs["library"] = (
                    lambda x=x: torch._weight_int4pack_mm(x, *lib))
            hot = _in_turns(hot_runs, list(hot_runs) + list(hot_runs)[::-1],
                            args.rounds)
            bound = _bound(_nbytes(x, k4.packed, k4.scale, o), 2 * M * K * N,
                           BF16_OPS_PER_S)["bound_ms"]
            fastest = min((n for n in cold if n not in TIMING_ONLY),
                          key=cold.get)
            print(f"K5 A/B {(M, K, N)} g {W4_GROUP} (bound {bound:.4f} ms by "
                  f"bytes): cold device ms a launch: " + ", ".join(
                      f"{n} {t:.4f} ({100 * bound / t:.1f}%)"
                      for n, t in cold.items())
                  + f"; fastest {fastest}; C entry in turns, hot (median of "
                  f"{2 * args.rounds}): " + ", ".join(
                      f"{n} {t:.4f}" for n, t in hot.items())
                  + " (bf16 torch.matmul: a reference)" + (
                      "" if not library else
                      "; library torch._weight_int4pack_mm cold "
                      f"{library['cold_ms']:.4f} "
                      f"({100 * bound / library['cold_ms']:.1f}%)"))
            out[str((M, K, N))] = {"cold_ms": cold, "hot_ms": hot,
                                   "bound_ms": bound, "fastest": fastest,
                                   "held": held, "library": library}
            del x, want, o, w16
        del k4, copies, rows, lib, lib_copies
        if "parent" in libs:
            del row_copies
        torch.cuda.empty_cache()
    for M in W4_ROWS:
        wins = {}
        for key, r in out.items():
            if key.startswith(f"({M},"):
                wins[r["fastest"]] = wins.get(r["fastest"], 0) + 1
        print(f"M = {M}: fastest by cold device time at {wins}")
    print(smi)
    print(json.dumps({"w4_ab": out, "ptxas": ptxas, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
