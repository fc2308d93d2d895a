"""A/B of the backward template's Configs on a CUDA card: the tiles,
consumer warpgroups and stages of the dK/dV and dQ kernels of
``csrc/attention_bwd_sm90.cuh``, at D = 64 (K4 nc, the ViT's) and D = 128
(K4a/K4b, the decoder's).

    python3 tools/bwd_config_ab_torch.py [--head-dim 64|128] [--rounds 10]
                                         [--parent ROOT]

For each pair of CONFIGS[D] (a dK/dV Config and a dQ Config), copies
``mjvideo_tpu_torch/csrc`` into ``build/bwd_ab/d<D>_<name>/`` (git-ignored),
rewrites the two lines ``using Dkdv<D> = ...;`` and ``using Dq<D> = ...;``
of the copy's ``attention_bwd_sm90.cuh`` and builds the copy's entry
(``vit_attention_bwd.cu`` at 64, ``decoder_attention_bwd.cu`` at 128) into
a library of its own, all at once with the port's nvcc flags; the
registers follow the warpgroups (``Regs``).  ``--parent ROOT`` also builds
ROOT's entry (another checkout, e.g. a ``git archive`` of the parent
commit) as ``parent``.  Each library is held against the twin (to
KERNEL_REL_TOL of max|plain|) at its shapes: D = 64 at chip_smoke's
K1_SHAPES on qkv views; D = 128 at training's (1, 799, 16/8, 128) with
every key live and the reward gradient's (1, 3072, 16/8, 128) with the
single clip's 2,362 keys live, causal, lse and delta from the twin.  Then
each kernel is timed in turns with its alternatives and
``F.scaled_dot_product_attention``'s backward (dQ, dK and dV in one call;
GQA by repeated k and v) by CUDA events around one launch of its C entry.
Without ``--head-dim`` both are run.  Prints the card, each build's ptxas
lines (registers, spills), the medians with their share of the bound, and
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

# D -> (name, dK/dV Config, dQ Config): Config<D, warpgroups, stages,
# streamed rows>, named kv<warpgroups>.<stages>.<rows>_q<...>.  The first
# pair is the production one.  The kernels issue tile t + 1's score
# products beside tile t's accumulating ones, so a thread holds the packed
# scores of t and the scores of t + 1 together with its outputs: at D = 64
# dK/dV with 3 warpgroups (160 registers a consumer thread) or 128-row q
# tiles spills (64 fp32 scores and 64 fp32 outputs a thread); at D = 128
# dK/dV holds 128 fp32 outputs a thread (dK and dV) and fits only 32-row q
# tiles, and dQ spills at 128-key tiles (the last pair, kept as the record).
CONFIGS = {
    64: (
        ("kv2.3.64_q3.4.64", "Config<64, 2, 3, 64>", "Config<64, 3, 4, 64>"),
        ("kv2.2.64_q3.3.64", "Config<64, 2, 2, 64>", "Config<64, 3, 3, 64>"),
        ("kv2.4.64_q3.2.64", "Config<64, 2, 4, 64>", "Config<64, 3, 2, 64>"),
        ("kv3.3.64_q2.3.128", "Config<64, 3, 3, 64>",
         "Config<64, 2, 3, 128>"),
        ("kv2.3.128_q2.3.64", "Config<64, 2, 3, 128>",
         "Config<64, 2, 3, 64>"),
    ),
    128: (
        ("kv2.4.32_q2.3.64", "Config<128, 2, 4, 32>", "Config<128, 2, 3, 64>"),
        ("kv2.3.32_q2.4.64", "Config<128, 2, 3, 32>", "Config<128, 2, 4, 64>"),
        ("kv2.6.32_q2.2.64", "Config<128, 2, 6, 32>", "Config<128, 2, 2, 64>"),
        ("kv2.3.64_q2.2.128", "Config<128, 2, 3, 64>",
         "Config<128, 2, 2, 128>"),
    ),
}
PRODUCTION = {
    64: ("using DkdvD64 = Config<64, 2, 3, 64>;",
         "using DqD64 = Config<64, 3, 4, 64>;"),
    128: ("using DkdvD128 = Config<128, 2, 4, 32>;",
          "using DqD128 = Config<128, 2, 3, 64>;"),
}
ENTRY = {64: ("vit_attention_bwd.cu", "mjv_vit_attention_bwd_dkdv",
              "mjv_vit_attention_bwd_dq"),
         128: ("decoder_attention_bwd.cu", "mjv_decoder_attention_bwd_dkdv",
               "mjv_decoder_attention_bwd_dq")}
# D = 128: (B, T, Hq, Hkv, live keys) of training and the reward gradient.
DECODER_SHAPES = ((1, 799, 16, 8, 799), (1, 3072, 16, 8, 2362))


def _nvcc_lib(src: Path, out: Path, label: str, D: int) -> Path:
    from mjvideo_tpu_torch import kernels

    lib = out / "libk4.so"
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(src / ENTRY[D][0])], capture_output=True, text=True)
    (out / "ptxas.txt").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {label}:\n{res.stderr[-4000:]}")
    return lib


def build_config(D: int, name: str, dkdv: str, dq: str) -> Path:
    """The library of the D entry with the two Configs."""
    from mjvideo_tpu_torch import kernels

    src = REPO / "build" / "bwd_ab" / f"d{D}_{name}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    header = src / "attention_bwd_sm90.cuh"
    text = header.read_text()
    for line in PRODUCTION[D]:
        if text.count(line) != 1:
            raise RuntimeError(f"{line!r} not found once in {header}")
    text = text.replace(PRODUCTION[D][0], f"using DkdvD{D} = {dkdv};")
    text = text.replace(PRODUCTION[D][1], f"using DqD{D} = {dq};")
    header.write_text(text)
    return _nvcc_lib(src, src, name, D)


def build_parent(root: Path, D: int) -> Path:
    out = REPO / "build" / "bwd_ab" / f"d{D}_parent"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    return _nvcc_lib(root / "mjvideo_tpu_torch" / "csrc", out, "parent", D)


def _operands(D, shape, g, dev):
    """(q, k, v, dout, lse, delta, mask, causal, the twin's (dq, dk, dv))."""
    import torch

    from mjvideo_tpu_torch.ops import flash_attention as fa

    def randn(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    if D == 64:
        B, S, H, _ = shape
        q, k, v = (t.view(B, S, H, D) for t in
                   randn(B, S, 3 * H * D).split(H * D, dim=-1))
        dout = randn(B, S, H, D)
        ref, lse = fa.vit_attention_plain(q, k, v, return_lse=True)
        mask, causal = None, False
    else:
        B, T, Hq, Hkv, live = shape
        q, k, v = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
        dout = randn(B, T, Hq, D)
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        mask[:, live:] = 0
        ref, lse = fa.decoder_attention_plain(q, k, v, mask, return_lse=True)
        causal = True
    delta = fa.attention_delta(ref, dout)
    grads = fa.decoder_attention_bwd_plain(q, k, v, dout, lse, delta, mask,
                                           causal=causal)
    return q, k, v, dout, lse, delta, mask, causal, grads


def run_head_dim(D, args, dev):
    import torch

    from chip_smoke import (K1_SHAPES, KERNEL_REL_TOL, SEED, _attention_work,
                            _bound, _in_turns, _rel_err, _sdpa)
    from mjvideo_tpu_torch import kernels

    jobs = {name: (build_config, (D, name, dkdv, dq))
            for name, dkdv, dq in CONFIGS[D]}
    if args.parent is not None:
        jobs["parent"] = (build_parent, (args.parent.resolve(), D))
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
                ptxas.setdefault(f"d{D} {name} {kind}", []).append(props)
                print(f"ptxas d{D} {name} {kind}: {props}")
        lib = ctypes.CDLL(str(path))
        for entry in ENTRY[D][1:]:
            fn = getattr(lib, entry)
            fn.argtypes = kernels.ARGTYPES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for shape in (K1_SHAPES if D == 64 else DECODER_SHAPES):
        q, k, v, dout, lse, delta, mask, causal, (rdq, rdk, rdv) = _operands(
            D, shape, g, dev)
        B, Q, Hq, _ = q.shape
        K, Hkv = k.shape[1], k.shape[2]
        stream = torch.cuda.current_stream().cuda_stream
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        dq = torch.empty_like(q)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr())
        strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                   v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
                   D ** -0.5)
        if D == 64:
            dims, more, tail = (B, Q, Hq, D), (), (stream,)
        else:
            dims = (B, Q, K, Hq, Hkv, D)
            more = (None if mask is None else mask.data_ptr(), None)
            tail = (int(causal), stream)

        def launcher(lib, kind):
            def run():
                if kind == "dkdv":
                    err = getattr(lib, ENTRY[D][1])(
                        *head, *more, dk.data_ptr(), dv.data_ptr(), *dims,
                        *strides, *tail)
                else:
                    err = getattr(lib, ENTRY[D][2])(
                        *head, *more, dq.data_ptr(), *dims, *strides, *tail)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")
            return run

        label = "K4 nc" if D == 64 else "K4a/K4b"
        readings = {}
        for kind, outs in (("dkdv", ((dk, rdk), (dv, rdv))),
                           ("dq", ((dq, rdq),))):
            runs = {name: launcher(lib, kind) for name, lib in libs.items()}
            for name, run in runs.items():
                run()
                torch.cuda.synchronize()
                rel = max(_rel_err(got, want)[1] for got, want in outs)
                print(f"{label} {kind} {name} {shape}: {rel:.3e} of "
                      f"max|plain| (bound {KERNEL_REL_TOL:.2e})")
                if not rel <= KERNEL_REL_TOL:
                    raise RuntimeError(f"{label} {kind} {name} {shape}: "
                                       "beyond its bound")
            runs["SDPA backward"] = _sdpa(q, k, v, causal=causal,
                                          backward=True)
            med = _in_turns(runs, list(runs) + list(runs)[::-1], args.rounds)
            matmuls, outputs = (4, (k, v)) if kind == "dkdv" else (3, None)
            bound = _bound(*_attention_work(
                q, k, v, mask, causal=causal, matmuls=matmuls,
                inputs=(dout, lse, delta), outputs=outputs))
            print(f"{label} {kind} A/B at {shape}, in turns (median of "
                  f"{2 * args.rounds}; bound {bound['bound_ms']:.4f} ms by "
                  f"{bound['bound_by']}): " + ", ".join(
                      f"{n} {t:.4f} ms ({100 * bound['bound_ms'] / t:.1f}%)"
                      for n, t in med.items()))
            readings[kind] = {"ms": med, "bound_ms": bound["bound_ms"]}
        out[str(shape)] = readings
    return out, ptxas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--head-dim", type=int, choices=sorted(CONFIGS),
                    default=None)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bwd_config_ab_torch: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda:0")
    result = {}
    for D in ([args.head_dim] if args.head_dim else sorted(CONFIGS)):
        result[f"d{D}"] = run_head_dim(D, args, dev)
    print(smi)
    print(json.dumps({"bwd_ab": {d: r[0] for d, r in result.items()},
                      "ptxas": {d: r[1] for d, r in result.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
