"""A/B of K6/K7's Configs on a CUDA card: the consumer warpgroups (64 rows
each) and the stages of the int8 wgmma GEMM of ``csrc/q8g_matmul.cu``.

    python3 tools/q8g_config_ab_torch.py [--rounds 10] [--parent ROOT]

For each of CONFIGS, copies ``mjvideo_tpu_torch/csrc`` into
``build/q8g_ab/<name>/`` (git-ignored), rewrites the copy's ``using Q8G =
Config<2, 4>;`` and builds the copy's ``q8g_matmul.cu`` into a library of
its own, all at once with the port's nvcc flags; the registers follow the
warpgroups (``Regs``).  ``--parent ROOT`` also builds ROOT's
``q8g_matmul.cu`` (another checkout, e.g. a ``git archive`` of the parent
commit, whose K6 takes the (K, N) weight row-major) as ``parent``.  At
each of chip_smoke's Q8G_SHAPES (g 128), each library's K6 (the pre-pass
and the GEMM, through its C entry) is held bit-equal to the twin (but the
PROBES, two timing-only edits of the production source), then
timed in turns with the others, bf16 ``torch.matmul`` of the same (M, K)
by (K, N) (a labelled reference, not the same function) and
``torch._int_mm`` on the same int8 operands (the per-column int8 product,
where it takes the shape) by CUDA events around one call.  Prints the
card, each build's ptxas lines (registers, spills), the medians with their
share of the bound, and one JSON line.
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

# (name, Config<consumer warpgroups, stages>); the first is the production
# one.  At g = 128 a warpgroup holds two int32 accumulators and one fp32 of
# 64 each a thread: two warpgroups' 232 registers hold them, three
# warpgroups' 160 do not.
CONFIGS = (
    ("wg2.s4", "Config<2, 4>"),
    ("wg2.s6", "Config<2, 6>"),
    ("wg2.s3", "Config<2, 3>"),
    ("wg3.s4", "Config<3, 4>"),
)
PRODUCTION = "using Q8G = Config<2, 4>;"
# Probes of the production Config, timed but not the function (their
# outputs are not held): the products with the promotion cut to one add per
# element, and the promotion with no products.  Each is (name, [(source
# text, its replacement)]).
PROMOTE = ("""        sum[4 * j + e] = __fadd_rn(
            sum[4 * j + e],
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]), as0),
                      ws[e]));
        sum[4 * j + 2 + e] = __fadd_rn(
            sum[4 * j + 2 + e],
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 + e]), as8),
                      ws[e]));""",
           """        sum[4 * j + e] += __int_as_float(acc[4 * j + e]);
        sum[4 * j + 2 + e] += __int_as_float(acc[4 * j + 2 + e]);""")
PRODUCTS = ("        wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kk > 0);"
            "  // 32 bytes a step", "        (void)kk;")
PROBES = (("probe: products, one add", [PROMOTE]),
          ("probe: promotion, no products", [PRODUCTS]),
          ("probe: loads only", [PROMOTE, PRODUCTS]))


def _nvcc_lib(src: Path, out: Path, label: str) -> Path:
    from mjvideo_tpu_torch import kernels

    lib = out / "libq8g.so"
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src / "q8g_matmul.cu")], capture_output=True, text=True)
    (out / "ptxas.txt").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {label}:\n{res.stderr[-4000:]}")
    return lib


def build_config(name: str, config: str, edits=()) -> Path:
    from mjvideo_tpu_torch import kernels

    src = REPO / "build" / "q8g_ab" / name.replace(" ", "_").replace(
        ":", "").replace(",", "")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    source = src / "q8g_matmul.cu"
    text = source.read_text()
    for old, new in [(PRODUCTION, f"using Q8G = {config};"), *edits]:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} not found once in {source}")
        text = text.replace(old, new)
    source.write_text(text)
    return _nvcc_lib(src, src, name)


def build_parent(root: Path) -> Path:
    out = REPO / "build" / "q8g_ab" / "parent"
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
        print("q8g_config_ab_torch: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import (INT8_OPS_PER_S, Q8G_GROUP, Q8G_SHAPES, SEED,
                            _bound, _in_turns, _nbytes)
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import quant as q8

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
    _P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs, ptxas = {}, {}
    for name, path in paths.items():
        report = (path.parent / "ptxas.txt").read_text().splitlines()
        for i, line in enumerate(report):
            if "Function properties for" in line and "q8g_gemm" in line:
                props = "; ".join(x.split(":", 1)[-1].strip()
                                  for x in report[i + 1:i + 3])
                ptxas.setdefault(name, []).append(props)
                print(f"ptxas {name}: {props}")
        fn = ctypes.CDLL(str(path)).mjv_q8g_matmul_fused
        fn.restype = _I
        fn.argtypes = ([_P] * 4 + [_I] * 5 + [_P] if name == "parent"
                       else kernels.ARGTYPES["mjv_q8g_matmul_fused"])
        libs[name] = fn

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for M, K, N in Q8G_SHAPES:
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        qk = q8.quantize_kernel(
            torch.randn((K, N), generator=g, device=dev) * 0.02,
            group_size=Q8G_GROUP)
        G = K // Q8G_GROUP
        ws = qk.scale
        odt = torch.float32 if N > 50000 else torch.bfloat16
        want = q8.q8g_matmul_fused_plain(x, qk.q, ws, odt)
        row_major = qk.q.contiguous() if "parent" in libs else None
        xq = torch.empty((M, K), dtype=torch.int8, device=dev)
        a_s = torch.empty((M, G), dtype=torch.float32, device=dev)
        got = torch.empty((M, N), dtype=odt, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        bf = int(odt == torch.bfloat16)

        def launcher(name, fn):
            if name == "parent":
                args_ = (x.data_ptr(), row_major.data_ptr(), ws.data_ptr(),
                         got.data_ptr(), bf, M, N, K, G, stream)
            else:
                args_ = (x.data_ptr(), qk.q.data_ptr(), ws.data_ptr(),
                         xq.data_ptr(), a_s.data_ptr(), got.data_ptr(), bf, M,
                         N, K, G, K, stream)

            def run():
                err = fn(*args_)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err} at launch")
            return run

        runs = {name: launcher(name, fn) for name, fn in libs.items()}
        for name, run in runs.items():
            got.zero_()
            run()
            torch.cuda.synchronize()
            if name.startswith("probe"):
                continue
            same = torch.equal(got, want)
            print(f"K6 {name} {(M, K, N)}: bit-equal to the twin {same}")
            if not same:
                raise RuntimeError(f"K6 {name} {(M, K, N)} differs from its "
                                   "twin")
        w16 = torch.randn((K, N), generator=g, device=dev).to(torch.bfloat16)
        runs["bf16 matmul"] = lambda: torch.matmul(x, w16)
        xq8, _ = q8._quantize_rows_grouped(x.float(), G, Q8G_GROUP)
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            # The k-major weight is the column-major operand _int_mm takes.
            runs["_int_mm"] = lambda: torch._int_mm(xq8, qk.q)
        med = _in_turns(runs, list(runs) + list(runs)[::-1], args.rounds)
        bound = _bound(_nbytes(x, qk.q, ws, got), 2 * M * K * N,
                       INT8_OPS_PER_S)
        print(f"K6 A/B at {(M, K, N)} g {Q8G_GROUP}, in turns (median of "
              f"{2 * args.rounds}; bound {bound['bound_ms']:.4f} ms by "
              f"{bound['bound_by']}): " + ", ".join(
                  f"{n} {t:.4f} ms ({100 * bound['bound_ms'] / t:.1f}%)"
                  for n, t in med.items()))
        out[str((M, K, N))] = {"ms": med, "bound_ms": bound["bound_ms"]}
        del x, qk, ws, want, row_major, xq, a_s, got, w16, xq8
    print(smi)
    print(json.dumps({"q8g_ab": out, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
