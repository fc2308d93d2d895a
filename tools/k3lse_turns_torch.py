"""K3 lse against another checkout's K3 lse and SDPA, in turns, on a CUDA
card: the ring's chunk forward at the 768-token chunk of chip_smoke's
phase 17 and at the long clip's 13,440-token chunk.

    python3 tools/k3lse_turns_torch.py --parent ROOT [--rounds 10]

Builds ROOT's ``csrc/exact_attention.cu`` alone (another checkout, e.g. a
``git archive`` of the parent commit, unpacked into the git-ignored
``build/``) into ``build/k3lse_turns/``, and calls its ``mjv_exact_attention``
and this checkout's through the same C signature on the same bf16 inputs:
an earlier shard's chunk (rel_off = L, every key seen), B = 1, 16/8 heads
of 128, and the ragged chunk of phase 17 at rel_off 0.  Holds both
against the twin on the first 256 rows (output to 2^-7 of max|plain|,
lse to 1e-5 nats), then
times them and ``F.scaled_dot_product_attention`` (non-causal; causal at
rel_off 0) in turns by CUDA events around one call.  Prints the card, the
medians with their share of the bound, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def build_parent(root: Path) -> Path:
    from mjvideo_tpu_torch import kernels

    out = REPO / "build" / "k3lse_turns"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libk3.so"
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(root / "mjvideo_tpu_torch" / "csrc" / "exact_attention.cu")],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc parent:\n{res.stderr[-4000:]}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3lse_turns_torch: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import (KERNEL_REL_TOL, LONG_CHUNK, LSE_TOL, SEED,
                            SP_SHARDS, SP_T, _attention_work, _bound,
                            _in_turns, _rel_err, _sdpa)
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    libs = {"this": ctypes.CDLL(str(kernels.build())),
            "parent": ctypes.CDLL(str(build_parent(args.parent.resolve())))}
    for lib in libs.values():
        lib.mjv_exact_attention.argtypes = kernels.ARGTYPES[
            "mjv_exact_attention"]
        lib.mjv_exact_attention.restype = ctypes.c_int
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    ring = SP_T // SP_SHARDS
    for L, rel, ragged in ((ring, ring, False), (ring, 0, True),
                           (LONG_CHUNK, LONG_CHUNK, False)):
        q, k, v = (torch.randn((1, L, h, 128), generator=g, device=dev).to(
            torch.bfloat16) for h in (16, 8, 8))
        mask = torch.ones((1, L), dtype=torch.int32, device=dev)
        if ragged:
            mask[:, :5] = 0
        off = torch.full((1,), rel, dtype=torch.int32, device=dev)
        o = torch.empty_like(q)
        lse = torch.empty((1, 16, L), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def launcher(lib):
            def run():
                err = lib.mjv_exact_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                    off.data_ptr(), o.data_ptr(), lse.data_ptr(), 1, L, L, 16,
                    8, 128, q.stride(0), q.stride(1), k.stride(0),
                    k.stride(1), v.stride(0), v.stride(1), 128 ** -0.5, 1,
                    stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")
            return run

        runs = {name: launcher(lib) for name, lib in libs.items()}
        # The twin on the first 256 rows (rows are independent; the whole
        # long chunk's fp32 scores would take 12 GB).
        n = min(L, 256)
        ref, ref_lse = fa.exact_attention_plain(q[:, :n], k, v, mask, off,
                                                return_lse=True)
        dead = ref_lse >= fa.DEAD_LSE * 0.5
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            rel_err = _rel_err(o[:, :n], ref)[1]
            lse_err = (lse[..., :n] - ref_lse)[~dead].abs().max().item()
            print(f"K3 lse {name} (1, {L}, {L}, 16/8, 128) rel_off {rel}: "
                  f"{rel_err:.3e} of max|plain|, lse {lse_err:.3e} nats")
            if not (rel_err <= KERNEL_REL_TOL and lse_err <= LSE_TOL
                    and bool((lse[..., :n][dead] == fa.DEAD_LSE).all())):
                raise RuntimeError(f"K3 lse {name}: beyond its bounds")
        del ref, ref_lse
        runs["SDPA"] = _sdpa(q, k, v, causal=rel == 0)
        med = _in_turns(runs, list(runs) + list(runs)[::-1], args.rounds)
        bound = _bound(*_attention_work(q, k, v, mask, off,
                                        outputs=(q, lse)))
        key = f"{L} rel_off {rel}"
        print(f"K3 lse in turns at (1, {L}, {L}, 16/8, 128) rel_off {rel} "
              f"(median of {2 * args.rounds}; bound {bound['bound_ms']:.4f} "
              f"ms by {bound['bound_by']}): " + ", ".join(
                  f"{n} {t:.4f} ms ({100 * bound['bound_ms'] / t:.1f}%)"
                  for n, t in med.items()))
        out[key] = {"ms": med, "bound_ms": bound["bound_ms"]}
        del q, k, v, o, lse, runs
    print(smi)
    print(json.dumps({"k3lse_turns": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
