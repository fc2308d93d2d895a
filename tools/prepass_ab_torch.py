"""A/B of the two pre-passes of the main paths, this tree against another
checkout (the parent, a ``git archive`` of it unpacked beside this tree),
on one CUDA card.

    python3 tools/prepass_ab_torch.py --parent ROOT [--turns PCCP]
        [--variants] [--out FILE]

The pre-passes: K1/K2's key-norm max (``kernels.key_norm_max``), K2r's
running max of the key norms (``kernels.key_norm_cummax``) and K6's
activation quantization (``kernels.q8g_quantize``).  Each turn runs one
tree (P: ROOT, C: this tree), in the order of ``--turns``, in processes of
its own with that tree's package first on ``sys.path`` and its kernels
built from its own sources into its own ``build/kernels``:

- ``--worker ROOT`` (this file, run by the turn): on inputs drawn from
  ``chip_smoke.SEED``, identical in both trees,
  - each pre-pass alone, device time a launch by kernel (``torch.profiler``):
    K1/K2's at the shapes below, K2r's at chip_smoke's JUDGE_SHAPES (their
    masks), K6's at chip_smoke's Q8G_SHAPES;
  - the K2r op (``ops.flash_attention.decoder_attention_rows``: in this
    tree one C call, pre-pass and kernel) and K2r alone on the twin's kcum
    (the same in both trees) at the judge's prefill, as the ops below;
  - the K1 and K2 ops, with the lse and without, and the kernels alone
    on the standalone kmax, at (8, 1025, 16, 64) on
    qkv views, (2, 3072, 16/8, 128) with serving's ragged mask, (1, 799,
    16/8, 128) with every key live and (1, 3072, 16/8, 128) with the
    single clip's 2,362 live keys, and K6 at Q8G_SHAPES (g 128): one call
    timed by CUDA events (host included, median of 10), calls back to back
    (device time per call where the host keeps ahead) with the host's time
    to issue each, and the device time by kernel; a sha256 of every
    output;
  - in a tree's first turn, phase 4's and phase 11's scores (chip_smoke's
    2B scorer and requests; ``int8-noattn-g128`` and ``int8``) as exact
    float32 hex, and the bf16 pair's wall time unprofiled (median of 5);
- ``tools/profile_torch_scoring.py`` (the bf16 pair) and
  ``tools/profile_torch_reward_grad.py`` (the value-and-gradient) from
  that tree's root: device time and wall per request or gradient (the
  latter also unprofiled).

With ``--variants``, first, in this process: copies this tree's
``csrc/`` under ``build/prepass_ab/<name>/`` for each of VARIANTS,
applies its edits, builds the copies of the three sources of the pre-passes
and ROOT's (a parent without the K2r op's entry: its pre-pass and kernel as
two C calls), all at once with the port's nvcc flags, and times through the C
entries, in turns: K6 (and K7) back to back with the host's time to issue
each call, and K6 one call at a time (CUDA events around it, median of 10),
at chip_smoke's Q8G_SHAPES, K6's pre-pass alone (device time), the K1/K2
ops both ways at the shapes above, K2r's pre-pass alone at chip_smoke's
JUDGE_SHAPES (device time by kernel), and at the judge's prefill the K2r
op (the parent's: its pre-pass and K2r as two C calls), K2r alone on a
kcum, the K2 op and K2 alone on a kmax, one call at a time and back to
back; every variant but the PROBES is held bit-equal to production
first.

Prints the card, each turn's readings, whether the two trees' outputs and
scores agree bit for bit (and the delta where they do not), and one JSON
line (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MARK = "PREPASS_AB_JSON "
SOURCES = ("decoder_attention.cu", "vit_attention.cu", "q8g_matmul.cu")

# The alternatives to production, each (name, [(source, text, replacement)]).
_Q8G = "q8g_matmul.cu"
_WAIT = """    attention_sm90::grid_dependency_wait();
    asm volatile("fence.proxy.async.global;" ::: "memory");
"""
_STAGE = """      if (lane == 0) {
        mbar_expect_tx(full_bar(t), C::kStageBytes);
        tma_load_2d(&ta, stage_a(t), full_bar(t), kBoxK * t, m0);
        tma_load_2d(&tb, stage_a(t) + C::kABytes, full_bar(t), kBoxK * t,
                    n0);
      }
"""
_SCAN = """  return int(sm90::launch_dependent(
      reinterpret_cast<const void*>(key_norm_scan_kernel), dim3(nparts, B),
      dim3(kScanThreads), 0, s, args));
"""
VARIANTS = (
    ("no PDL", [(f, "stream, true);", "stream, false);") for f in SOURCES[:2]]
     + [(_Q8G, "ldk, s, true);", "ldk, s, false);"),
        (SOURCES[0], _SCAN, _SCAN.replace("sm90::launch_dependent(",
                                          "cudaLaunchKernel(").replace(
            "0, s, args));", "args, 0, s));"))]),
    # K6's producer issues the first stages' weight boxes before its wait.
    ("weight boxes before the wait", [(_Q8G, _WAIT, """\
    const int first = min(kStages, n_tiles);
    if (lane == 0) {
      for (int t = 0; t < first; ++t) {
        mbar_expect_tx(full_bar(t), C::kStageBytes);
        tma_load_2d(&tb, stage_a(t) + C::kABytes, full_bar(t), kBoxK * t,
                    n0);
      }
    }
""" + _WAIT), (_Q8G, _STAGE, """\
      if (lane == 0) {
        if (t >= first) {
          mbar_expect_tx(full_bar(t), C::kStageBytes);
          tma_load_2d(&tb, stage_a(t) + C::kABytes, full_bar(t), kBoxK * t,
                      n0);
        }
        tma_load_2d(&ta, stage_a(t), full_bar(t), kBoxK * t, m0);
      }
""")]),
    ("no proxy fence", [(_Q8G, _WAIT, _WAIT.splitlines(True)[0])]),
    ("pre-pass 8 loads", [("decoder_attention.cu",
                           "constexpr int kPartLoads = 4;",
                           "constexpr int kPartLoads = 8;")]),
    ("K6 pre-pass 512 threads", [(_Q8G, "constexpr int kQuantThreads = 256;",
                                  "constexpr int kQuantThreads = 512;")]),
    # Timing only: a product in place of the quantizer's IEEE division.
    ("probe: no division", [(_Q8G, "__float2int_rn(__fdiv_rn(v, s))",
                             "__float2int_rn(__fmul_rn(v, s))")]),
)
PROBES = ("probe: no division",)


def _group(name: str) -> str:
    for part, short in (("key_norm_scan", "scan"), ("key_norm", "pre-pass"),
                        ("fold", "fold"),
                        ("emset", "memset"), ("quantize_rows", "pre-pass"),
                        ("q8g_gemm", "gemm"), ("attention_kernel",
                                               "attention")):
        if part in name:
            return short
    return name[:50]


def _device(fn, reps=20, tries=3):
    """Device time of one call of ``fn`` by kernel group, in ms; a trace
    that records no kernel is taken again, up to ``tries`` times (then the
    result is empty: not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            t = ev.self_device_time_total
            if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                name = _group(ev.key)
                out[name] = out.get(name, 0.0) + t / reps / 1e3
        if out:
            break
    return out


def _back_to_back(fn, calls=20):
    """(ms a call of ``calls`` issued back to back, by CUDA events around
    them all; ms the host takes to issue one, by its clock)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / calls
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, host


def _digest(out) -> str:
    import torch

    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        torch.cuda.synchronize()
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(root: Path, scores: bool) -> dict:
    """The readings of one turn, with ``root``'s package and helpers."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa
    from mjvideo_tpu_torch.ops import quant as q8

    loaded = Path(kernels.__file__).resolve()
    if root.resolve() not in loaded.parents:
        raise RuntimeError(f"loaded {loaded}, not {root}'s package")
    kernels.build()
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    out = {"root": str(root), "ops": {}, "pre-pass": {}, "k6": {}}

    def op_reading(label, fn):
        b2b, host = _back_to_back(fn)
        out["ops"][label] = {"ms": cs._median_ms(fn), "back_to_back_ms": b2b,
                             "host_ms": host, "device_ms": _device(fn),
                             "digest": _digest(fn())}

    B, S, H, D = 8, 1025, 16, 64
    q, k, v = (t.view(B, S, H, D)
               for t in randn(B, S, 3 * H * D).split(H * D, dim=-1))
    out["pre-pass"][str((B, S, H, D))] = _device(
        lambda: kernels.key_norm_max(k))
    kmax = kernels.key_norm_max(k)
    for lse in (False, True):
        op_reading(f"K1{' lse' if lse else ''} {(B, S, H, D)}",
                   lambda: fa._vit_attention_fwd(q, k, v, D ** -0.5, lse))
    op_reading(f"K1 alone {(B, S, H, D)}",
               lambda: kernels.vit_attention(q, k, v, kmax, D ** -0.5))
    del q, k, v
    for (B, T), kind in (((2, 3072), "ragged"), ((1, 799), None),
                         ((1, 3072), cs.single_clip_length())):
        q, k, v = randn(B, T, 16, 128), randn(B, T, 8, 128), randn(B, T, 8,
                                                                   128)
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        if kind == "ragged":
            mask[1, T - 600:] = 0
            mask[1, :5] = 0
        elif kind is not None:
            mask[:, kind:] = 0
        shape = (B, T, 16, 8, 128)
        out["pre-pass"][str(shape)] = _device(
            lambda: kernels.key_norm_max(k, mask))
        for lse in (False, True):
            op_reading(f"K2{' lse' if lse else ''} {shape}",
                       lambda: fa._decoder_attention_fwd(
                           q, k, v, mask, None, 128 ** -0.5, lse))
        kmax = kernels.key_norm_max(k, mask)
        op_reading(f"K2 alone {shape}", lambda: kernels.decoder_attention(
            q, k, v, mask, kmax, None, 128 ** -0.5))
        del q, k, v, mask
    # K2r: its pre-pass alone at the judge's shapes; at the prefill its op
    # and the kernel alone on the twin's kcum.
    out["K2r pre-pass"] = {}
    for name, shape in cs.JUDGE_SHAPES.items():
        q, k, v, mask, off, _ = cs._judge_inputs(randn, shape)
        out["K2r pre-pass"][str(shape[:6])] = _device(
            lambda: kernels.key_norm_cummax(k, mask))
        if name == "prefill":
            op_reading(f"K2r {shape[:6]}", lambda: fa.decoder_attention_rows(
                q, k, v, mask, off))
            kcum = fa.key_norm_cummax(k, mask)
            op_reading(f"K2r alone {shape[:6]}",
                       lambda: kernels.decoder_attention_rows(
                           q, k, v, mask, kcum, off, 128 ** -0.5))
        del q, k, v, mask
    for M, K, N in cs.Q8G_SHAPES:
        x = randn(M, K)
        qk = q8.quantize_kernel(randn(K, N).float() * 0.02,
                                group_size=cs.Q8G_GROUP)
        G = K // cs.Q8G_GROUP
        odt = torch.float32 if N > 50000 else torch.bfloat16
        xq, a_s = kernels.q8g_quantize(x, G)

        def k6():
            return kernels.q8g_matmul_fused(x, qk.q, qk.scale, odt)

        b2b, host = _back_to_back(k6)
        out["k6"][str((M, K, N))] = {
            "ms": cs._median_ms(k6), "back_to_back_ms": b2b, "host_ms": host,
            "device_ms": _device(k6), "digest": _digest(k6()),
            "pre_pass_device_ms": _device(
                lambda: kernels.q8g_quantize(x, G)).get("pre-pass"),
            "pre_pass_digest": _digest(kernels.q8g_quantize(x, G)),
            "k7_device_ms": _device(lambda: kernels.q8g_matmul(
                xq, a_s, qk.q, qk.scale)).get("gemm")}
        del x, qk, xq, a_s
        torch.cuda.empty_cache()
    if scores:
        from mjvideo_tpu_torch import RewardScorer

        scorer = cs.make_scorer(
            torch.Generator(device=dev).manual_seed(cs.SEED), dev)
        requests = cs.make_requests(scorer, np.random.default_rng(cs.SEED))

        def hexes(sc):
            return [[float(v).hex() for v in sc.score_batch(*r).score.float()
                     .cpu().tolist()] for r in requests]

        out["scores"] = {"bf16": hexes(scorer)}
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scorer.score_batch(*requests[1])
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        out["pair_wall_ms"] = sorted(times)[len(times) // 2]
        for mode in cs.SCORE_QUANT_MODES:
            qs = RewardScorer(scorer.cfg, scorer.params, scorer.tokenizer,
                              dtype=torch.bfloat16,
                              gating_pattern=scorer.gating_pattern,
                              quant=mode)
            out["scores"][mode] = hexes(qs)
            del qs
            torch.cuda.empty_cache()
    return out


def _build_variant(name, csrc, edits):
    """The three sources of ``csrc`` with ``edits``, built into one library
    under ``build/prepass_ab/``; returns it, its entries typed."""
    import ctypes
    import shutil

    sys.path.insert(0, str(REPO))
    from mjvideo_tpu_torch import kernels

    root = REPO / "build" / "prepass_ab" / re.sub(r"\W+", "_", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(csrc, root)
    for source, old, new in edits:
        text = (root / source).read_text()
        if text.count(old) < 1:
            raise RuntimeError(f"{name}: {old!r} not in {source}")
        (root / source).write_text(text.replace(old, new))
    objs = []
    for source in SOURCES:
        obj = root / f"{source}.o"
        _run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", "-o", str(obj),
              str(root / source)], root)
        objs.append(str(obj))
    _run([kernels._nvcc(), "-shared", "-o", str(root / "lib.so"), *objs],
         root)
    lib = ctypes.CDLL(str(root / "lib.so"))
    for entry in ("mjv_q8g_matmul_fused", "mjv_q8g_matmul",
                  "mjv_q8g_quantize", "mjv_vit_attention",
                  "mjv_decoder_attention", "mjv_key_norm_max",
                  "mjv_vit_attention_op", "mjv_decoder_attention_op",
                  "mjv_key_norm_cummax", "mjv_decoder_attention_rows",
                  "mjv_decoder_attention_rows_op"):
        if not hasattr(lib, entry):
            continue
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = kernels.ARGTYPES[entry]
    if not hasattr(lib, "mjv_decoder_attention_rows_op"):
        # K2r's one-CTA pre-pass took no scratch.
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mjv_key_norm_cummax.argtypes = [P] * 3 + [I] * 4 + [L] * 2 + [P]
    return lib


def variants(parent: Path, rounds: int) -> dict:
    """The ``--variants`` readings (see the module's docstring)."""
    import concurrent.futures

    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import quant as q8

    jobs = {"production": (kernels.CSRC, []),
            **{name: (kernels.CSRC, edits) for name, edits in VARIANTS},
            "parent": (parent / "mjvideo_tpu_torch" / "csrc", [])}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {n: pool.submit(_build_variant, n, *a)
                   for n, a in jobs.items()}
        libs = {n: f.result() for n, f in futures.items()}
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def checked(fn):
        def run():
            err = fn()
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return run

    def in_turns(runs):
        got = {n: [] for n in runs}
        for _ in range(rounds):
            for n in list(runs) + list(runs)[::-1]:
                got[n].append(runs[n]())
        def median(xs):
            xs = sorted(x for x in xs if x is not None)
            return xs[len(xs) // 2] if xs else None

        return {n: [median(x) for x in zip(*r)] if isinstance(r[0], tuple)
                else median(r) for n, r in got.items()}

    out = {"k6": {}, "k6 one call": {}, "k7": {}, "pre-pass": {}, "ops": {},
           "ops one call": {}}
    for M, K, N in cs.Q8G_SHAPES:
        x = randn(M, K)
        qk = q8.quantize_kernel(randn(K, N).float() * 0.02,
                                group_size=cs.Q8G_GROUP)
        G = K // cs.Q8G_GROUP
        xq = torch.empty((M, K), dtype=torch.int8, device=dev)
        a_s = torch.empty((M, G), dtype=torch.float32, device=dev)
        o = torch.empty((M, N), dtype=torch.float32, device=dev)
        ptrs = (x.data_ptr(), qk.q.data_ptr(), qk.scale.data_ptr(),
                xq.data_ptr(), a_s.data_ptr(), o.data_ptr())
        want = None
        for name, lib in libs.items():
            if name in PROBES:
                continue
            o.fill_(float("nan"))
            checked(lambda: lib.mjv_q8g_matmul_fused(
                *ptrs, 0, M, N, K, G, K, stream()))()
            got = (o.clone(), xq.clone(), a_s.clone())
            want = got if want is None else want
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"{name}: K6 not bit-equal at {(M, K, N)}")
        key = str((M, K, N))

        def k6(lib):
            return checked(lambda: lib.mjv_q8g_matmul_fused(
                *ptrs, 0, M, N, K, G, K, stream()))

        def k7(lib):
            return checked(lambda: lib.mjv_q8g_matmul(
                xq.data_ptr(), a_s.data_ptr(), *ptrs[1:3], o.data_ptr(), M, N,
                K, G, K, stream()))

        def quantize(lib):
            return checked(lambda: lib.mjv_q8g_quantize(
                x.data_ptr(), xq.data_ptr(), a_s.data_ptr(), M, K, G,
                stream()))

        out["k6"][key] = in_turns({n: (lambda f=k6(lib): _back_to_back(f))
                                   for n, lib in libs.items()})
        out["k6 one call"][key] = in_turns(
            {n: (lambda f=k6(lib): cs._median_ms(f)) for n, lib in libs.items()
             if n not in PROBES})
        out["k7"][key] = in_turns({n: (lambda f=k7(lib): _back_to_back(f))
                                   for n, lib in libs.items()})
        out["pre-pass"][key] = in_turns(
            {n: (lambda f=quantize(lib): _device(f).get("pre-pass"))
             for n, lib in libs.items()})
        del x, qk, xq, a_s, o
        torch.cuda.empty_cache()
    for B, T, H, D in ((8, 1025, 16, 64), (2, 3072, 8, 128),
                       (1, 799, 8, 128), (1, 3072, 8, 128)):
        vit = D == 64
        Hq = H if vit else 16
        if vit:
            q, k, v = (t.view(B, T, H, D) for t in randn(
                B, T, 3 * H * D).split(H * D, dim=-1))
            mask = None
        else:
            q, k, v = randn(B, T, Hq, D), randn(B, T, H, D), randn(B, T, H, D)
            mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        m = None if mask is None else mask.data_ptr()
        n = kernels.key_norm_parts(B, T, H, D)
        # The 8-load variant at its own plan: the chunks 8 loads fill.
        loads, kernels.KEY_NORM_LOADS = kernels.KEY_NORM_LOADS, 8
        n8 = kernels.key_norm_parts(B, T, H, D)
        kernels.KEY_NORM_LOADS = loads
        part = torch.empty((B, max(n, n8), H), dtype=torch.float32,
                           device=dev)
        o = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
        qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                   v.stride(0), v.stride(1))
        scale = D ** -0.5

        def op(name, lib):
            parts = n8 if name == "pre-pass 8 loads" else n
            if vit:
                return checked(lambda: lib.mjv_vit_attention_op(
                    *qkv, part.data_ptr(), o.data_ptr(), None, B, T, H, D,
                    *strides, parts, scale, stream()))
            return checked(lambda: lib.mjv_decoder_attention_op(
                *qkv, m, None, part.data_ptr(), o.data_ptr(), None, B, T, T,
                Hq, H, D, *strides, parts, scale, stream()))

        out["ops"][str((B, T, Hq, H, D))] = in_turns(
            {name: (lambda f=op(name, lib): _back_to_back(f))
             for name, lib in libs.items() if name not in PROBES})
        out["ops one call"][str((B, T, Hq, H, D))] = in_turns(
            {name: (lambda f=op(name, lib): cs._median_ms(f))
             for name, lib in libs.items() if name not in PROBES})
        del q, k, v, mask, part, o
    out.update(k2r_variants(libs, cs, randn, checked, stream, in_turns))
    return out


def k2r_variants(libs, cs, randn, checked, stream, in_turns) -> dict:
    """K2r's part of ``--variants``: its pre-pass alone at the judge's
    shapes (device time by kernel, each library once), and at the prefill
    the K2r op of each library (the parent's as two C calls) with
    production's K2r alone on its kcum, K2 op and K2 alone on its kmax,
    in turns; production's op held bit-equal to its kernel alone and each
    variant's op to production's first."""
    import torch

    from mjvideo_tpu_torch import kernels

    out = {"K2r pre-pass": {}, "K2r": {}, "K2r one call": {}}
    dev = torch.device("cuda:0")
    prod = libs["production"]
    for jname, shape in cs.JUDGE_SHAPES.items():
        B, Q, T, Hq, H, D, _ = shape
        q, k, v, mask, off, _ = cs._judge_inputs(randn, shape)
        n = kernels.key_norm_parts(B, T, H, D)
        f32 = dict(dtype=torch.float32, device=dev)
        part, kcum = torch.empty((B, n, H), **f32), torch.empty((B, H, T),
                                                                **f32)
        m, offp = mask.data_ptr(), None if off is None else off.data_ptr()
        qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                   v.stride(0), v.stride(1))
        kd = (B, T, H, D, k.stride(0), k.stride(1))

        def prepass(name, lib, kc=kcum):
            if not hasattr(lib, "mjv_decoder_attention_rows_op"):
                return checked(lambda: lib.mjv_key_norm_cummax(
                    k.data_ptr(), m, kc.data_ptr(), *kd, stream()))
            return checked(lambda: lib.mjv_key_norm_cummax(
                k.data_ptr(), m, part.data_ptr(), kc.data_ptr(), *kd, n,
                stream()))

        out["K2r pre-pass"][str(shape[:6])] = {
            name: _device(prepass(name, lib)) for name, lib in libs.items()
            if name not in PROBES}
        if jname != "prefill":
            continue
        o = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
        dims = (B, Q, T, Hq, H, D, *strides)
        scale = D ** -0.5

        def op(name, lib, out_=o):
            if not hasattr(lib, "mjv_decoder_attention_rows_op"):
                def two_calls():
                    prepass(name, lib)()
                    return lib.mjv_decoder_attention_rows(
                        *qkv, m, kcum.data_ptr(), offp, out_.data_ptr(),
                        *dims, scale, stream())
                return checked(two_calls)
            return checked(lambda: lib.mjv_decoder_attention_rows_op(
                *qkv, m, offp, part.data_ptr(), kcum.data_ptr(),
                out_.data_ptr(), *dims, n, scale, stream()))

        kc_alone, kmax = torch.empty_like(kcum), torch.empty((B, H), **f32)
        o2 = torch.empty_like(o)
        prepass("production", prod, kc_alone)()
        checked(lambda: prod.mjv_key_norm_max(
            k.data_ptr(), m, part.data_ptr(), kmax.data_ptr(), *kd, n,
            stream()))()
        runs = {f"{name} K2r op": op(name, lib) for name, lib in libs.items()
                if name not in PROBES}
        runs["K2r alone"] = checked(lambda: prod.mjv_decoder_attention_rows(
            *qkv, m, kc_alone.data_ptr(), offp, o2.data_ptr(), *dims, scale,
            stream()))
        runs["K2 op"] = checked(lambda: prod.mjv_decoder_attention_op(
            *qkv, m, offp, part.data_ptr(), o2.data_ptr(), None, *dims, n,
            scale, stream()))
        runs["K2 alone"] = checked(lambda: prod.mjv_decoder_attention(
            *qkv, m, kmax.data_ptr(), offp, o2.data_ptr(), None, *dims,
            scale, stream()))
        runs["production K2r op"]()
        want = o.clone()
        runs["K2r alone"]()
        if not torch.equal(o2, want):
            raise RuntimeError("K2r op: not the kernel alone's bits")
        for name in libs:
            if name not in PROBES + ("parent", "production"):
                runs[f"{name} K2r op"]()
                if not torch.equal(o, want):
                    raise RuntimeError(f"{name}: K2r op not bit-equal")
        out["K2r"][str(shape[:6])] = in_turns(
            {name: (lambda f=f: _back_to_back(f)) for name, f in runs.items()})
        out["K2r one call"][str(shape[:6])] = in_turns(
            {name: (lambda f=f: cs._median_ms(f)) for name, f in runs.items()})
        del q, k, v, mask, part, kcum, o, o2, kc_alone
    return out


def _run(cmd, cwd):
    res = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd} in {cwd} failed ({res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout


def _profile(root: Path, tool: str) -> dict:
    text = _run([sys.executable, f"tools/{tool}"], root)
    m = re.search(r": wall ([\d.]+) ms/\w+, device kernel time ([\d.]+) ms/"
                  r"\w+, busy share ([\d.]+)", text)
    reading = {"wall_ms": float(m.group(1)), "device_ms": float(m.group(2)),
               "busy": float(m.group(3))}
    m = re.search(r"without the profiler: wall ([\d.]+) ms/\w+, busy share "
                  r"([\d.]+)", text)
    if m:
        reading["unprofiled_wall_ms"] = float(m.group(1))
        reading["unprofiled_busy"] = float(m.group(2))
    groups = re.findall(r"^\s+([\d.]+) ms/\w+\s+[\d.]+%\s+(.+)$", text, re.M)
    reading["groups_ms"] = {name.strip(): float(t) for t, name in groups
                            if name.startswith(("attention", "quantized"))}
    return reading


def _compare(a, b, path=""):
    """The keys where two readings' digests or scores differ."""
    diffs = []
    if isinstance(a, dict):
        for key in a:
            if key in b:
                diffs += _compare(a[key], b[key], f"{path}/{key}")
    elif "digest" in path or "/scores/" in path:
        if a != b:
            diffs.append(path)
    return diffs


def _score_delta(a, b):
    out = {}
    for mode in a:
        got = [float.fromhex(x) for r in a[mode] for x in r]
        ref = [float.fromhex(x) for r in b[mode] for x in r]
        out[mode] = max(abs(x - y) for x, y in zip(got, ref))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--turns", default="PCCP")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None)
    ap.add_argument("--scores", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("prepass_ab_torch: CUDA is not available", file=sys.stderr)
        return 1
    if args.worker is not None:
        print(MARK + json.dumps(worker(args.worker, args.scores)))
        return 0
    if args.parent is None:
        ap.error("--parent ROOT is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    var = {}
    if args.variants:
        var = variants(args.parent.resolve(), args.rounds)
        for part, rows in var.items():
            what = ("device ms a launch" if "pre-pass" in part else
                    "ms of one call by CUDA events around it, host included"
                    if "one call" in part else
                    "ms a call back to back / the host's ms to issue it")
            for shape, by_name in rows.items():
                print(f"variants, {part} {shape}, {what} (median of "
                      f"{2 * args.rounds}): " + "; ".join(
                          f"{n} " + ("not measured" if not t and t != 0
                                     else ", ".join(f"{g} {x:.4f}" for g, x
                                                    in t.items())
                                     if isinstance(t, dict)
                                     else f"{t:.4f}" if not isinstance(t, list)
                                     else f"{t[0]:.4f} / {t[1]:.4f}")
                          for n, t in by_name.items()))
    roots = {"P": args.parent.resolve(), "C": REPO}
    turns, seen = [], set()
    for i, tree in enumerate(args.turns):
        root = roots[tree]
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root)] + ([] if tree in seen else ["--scores"])
        seen.add(tree)
        t0 = time.perf_counter()
        text = _run(cmd, root)
        reading = json.loads(text.split(MARK, 1)[1].splitlines()[0])
        reading["tree"] = tree
        reading["scoring"] = _profile(root, "profile_torch_scoring.py")
        reading["reward_grad"] = _profile(root, "profile_torch_reward_grad.py")
        reading["turn_s"] = time.perf_counter() - t0
        turns.append(reading)
        print(f"turn {i} ({tree}, {root}, {reading['turn_s']:.1f} s):")
        for label, r in reading["ops"].items():
            print(f"  op {label}: one call {r['ms']:.4f} ms, back to back "
                  f"{r['back_to_back_ms']:.4f} ms (host {r['host_ms']:.4f} "
                  "ms a call), device " + ", ".join(
                      f"{n} {t:.4f}" for n, t in r["device_ms"].items())
                  + f" ms; digest {r['digest']}")
        for shape, r in reading["pre-pass"].items():
            print(f"  K1/K2 pre-pass alone {shape}: device " + ", ".join(
                f"{n} {t:.4f}" for n, t in r.items()) + " ms")
        for shape, r in reading["K2r pre-pass"].items():
            print(f"  K2r pre-pass alone {shape}: device " + ", ".join(
                f"{n} {t:.4f}" for n, t in r.items())
                + f" ms (total {sum(r.values()):.4f})")
        for shape, r in reading["k6"].items():
            print(f"  K6 {shape}: one call {r['ms']:.4f} ms, back to back "
                  f"{r['back_to_back_ms']:.4f} ms (host {r['host_ms']:.4f} "
                  "ms a call), device " + ", ".join(
                      f"{n} {t:.4f}" for n, t in r["device_ms"].items())
                  + f" ms; the pre-pass alone {r['pre_pass_device_ms']} ms, "
                  f"K7 {r['k7_device_ms']} ms; digest {r['digest']}")
        for name in ("scoring", "reward_grad"):
            print(f"  {name}: {reading[name]}")
        if "pair_wall_ms" in reading:
            print(f"  bf16 pair unprofiled wall {reading['pair_wall_ms']:.2f}"
                  " ms")
    first = {}
    for t in turns:
        first.setdefault(t["tree"], t)
    verdict = {}
    if {"P", "C"} <= set(first):
        diffs = _compare(first["P"], first["C"])
        # K2r's op moves with its pre-pass's bits (kcum's sums in double).
        unexpected = [d for d in diffs if not d.startswith("/ops/K2r (")]
        verdict = {"bit_equal": not diffs, "differ": diffs,
                   "unexpected_differ": unexpected,
                   "score_delta": _score_delta(first["C"]["scores"],
                                               first["P"]["scores"])}
        print(f"parent against this tree: outputs and scores bit-equal "
              f"{not diffs}; differ at {diffs} (beyond the K2r op: "
              f"{unexpected}); max |score delta| by mode "
              f"{verdict['score_delta']}")
    print(smi)
    line = json.dumps({"card": smi, "variants": var, "turns": turns,
                       "verdict": verdict})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
