"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, at first use, into
``<checkout>/build/kernels/<hash of the sources>/`` (listed in
``.gitignore``), and loaded with ``ctypes``.  Nothing is compiled or loaded
at import time, so the CPU-only tests import this module freely.

Each wrapper checks device, dtype, shape and layout, allocates its output
with ``torch.empty``, launches on ``torch.cuda.current_stream()``, raises if
the C entry point reports a CUDA error, and adds one to its entry in
``launch_counts``.  The outputs carry no autograd graph: the
differentiable entries (``ops.flash_attention``) wrap a forward kernel and
its backward kernels in a ``torch.autograd.Function``, and the callers of a
kernel with no backward guard with ``forward_only``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("vit_attention.cu", "vit_attention_bwd.cu", "decoder_attention.cu",
           "decoder_attention_bwd.cu", "exact_attention.cu", "q8g_matmul.cu",
           "w4_matmul.cu", "vit_attention_variants.cu")
HEADERS = ("decoder_attention_sm90.cuh", "attention_bwd_sm90.cuh")
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset_launch_counts();
# "vit_attention", "decoder_attention" and "exact_attention" count K1, K2
# and K3 with and without the lse, "vit_attention_lse",
# "decoder_attention_lse" and "exact_attention_lse" the launches with it;
# "key_norm_max" counts the pre-pass of K1 and K2 (their kmax, with the lse
# or without: one per K1 or K2 op, or alone), "key_norm_cummax" K2r's (its
# bound column: one per K2r op, or alone); "q8g_quantize" the activation
# pre-pass of K6 (one per K6 launch, or alone); the names ending in
# "_d96" count the launches at Phi-3's head dim of 96 among those of the
# name without it: K2, K3, their lse forms, the pre-pass, K4a, K4b, K2r and
# its pre-pass; those ending in "_d80" the launches at the Qwen2-VL vision
# tower's head dim of 80: K1 and its pre-pass; "_d72" at SigLIP-so400m's 72:
# K1 and the pre-pass, masked or not.  "vit_attention_masked" counts K1m,
# the masked non-causal form (D = 72 only), and "key_norm_max_masked_d72"
# the pre-pass launches at 72 that read a mask (K1m's, or alone);
# "exact_attention_d112" the launches of K3 at the EVA2-CLIP-E tower's head
# dim of 112 (non-causal, without the lse: the only form built there);
# "vit_attention_d128" the launches of K1 at InternViT-6B's head dim of 128
# (without the lse; its pre-pass is counted with K2's under "key_norm_max").
launch_counts: Dict[str, int] = {
    "vit_attention": 0, "vit_attention_lse": 0, "vit_attention_bwd_dkdv": 0,
    "vit_attention_bwd_dq": 0, "decoder_attention": 0,
    "decoder_attention_lse": 0,
    "decoder_attention_bwd_dkdv": 0, "decoder_attention_bwd_dq": 0,
    "exact_attention": 0, "exact_attention_lse": 0,
    "decoder_attention_d96": 0, "exact_attention_d96": 0,
    "key_norm_max_d96": 0, "decoder_attention_lse_d96": 0,
    "exact_attention_lse_d96": 0, "decoder_attention_bwd_dkdv_d96": 0,
    "decoder_attention_bwd_dq_d96": 0, "decoder_attention_rows_d96": 0,
    "key_norm_cummax_d96": 0, "vit_attention_d80": 0, "key_norm_max_d80": 0,
    "vit_attention_d72": 0, "key_norm_max_d72": 0, "vit_attention_masked": 0,
    "key_norm_max_masked_d72": 0, "exact_attention_d112": 0,
    "vit_attention_d128": 0,
    "decoder_attention_rows": 0, "key_norm_cummax": 0, "key_norm_max": 0,
    "q8g_matmul_fused": 0, "q8g_matmul": 0, "q8g_quantize": 0,
    "w4_matmul": 0,
    "vit_attention_variant": 0, "vit_attention_tmajor": 0,
    "vit_attention_bshd": 0}

# B1's softmax modes, in the order of the C entry's ``mode`` argument, and
# the heads per CTA that B2 is built for.
VARIANT_MODES = ("exp2", "bf16s", "nomax", "exp2_nomax")
TMAJOR_HP = (1, 2, 4)
LOG2E = 1.4426950408889634  # log2(e)

# The plan of the K1/K2 pre-pass and of K2r's (``key_norm_partial_kernel`` of
# ``csrc/decoder_attention.cu``): its threads per CTA and 16-byte loads a
# thread per pass, the CTAs aimed at over the grid (about four per SM of
# the H100's 132) and the most partial maxima per (b, kv head).
KEY_NORM_THREADS = 256
KEY_NORM_LOADS = 4
KEY_NORM_CTAS = 528
KEY_NORM_PARTS_MAX = 256

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  Each source compiles in its own ``nvcc`` process,
    all at once; the objects are then linked.  The compilers' ``-Xptxas
    -v`` reports (registers, shared memory, spills) are kept beside the
    library as ``ptxas.txt``."""
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libmjv_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    jobs = []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}.{pid}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = [], []
    for name, _, proc in jobs:
        report = proc.communicate()[0]
        reports.append(f"== {name}\n{report}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{report}")
    (out_dir / "ptxas.txt").write_text("".join(reports))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"libmjv_kernels.{pid}.so"
    res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                          *(str(obj) for _, obj, _ in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib


_VIT_BWD = [_P] * 6 + [_I] * 4 + [_L] * 8 + [_F, _P]
_BWD = [_P] * 8 + [_I] * 6 + [_L] * 8 + [_F, _I, _P]
_VARIANT = [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F, _I, _P]
# Each C entry's argument types (every one returns a cudaError_t as int).
ARGTYPES = {
    "mjv_vit_attention": [_P] * 6 + [_I] * 4 + [_L] * 6 + [_F, _P],
    "mjv_vit_attention_op": [_P] * 6 + [_I] * 4 + [_L] * 6 + [_I, _F, _P],
    "mjv_vit_attention_bwd_dkdv": _VIT_BWD[:6] + [_P, _P] + _VIT_BWD[6:],
    "mjv_vit_attention_bwd_dq": _VIT_BWD[:6] + [_P] + _VIT_BWD[6:],
    "mjv_vit_attention_masked": [_P] * 6 + [_I] * 4 + [_L] * 6 + [_F, _P],
    "mjv_vit_attention_masked_op": [_P] * 6 + [_I] * 4 + [_L] * 6
    + [_I, _F, _P],
    "mjv_decoder_attention": [_P] * 8 + [_I] * 6 + [_L] * 6 + [_F, _P],
    "mjv_decoder_attention_op": [_P] * 8 + [_I] * 6 + [_L] * 6
    + [_I, _F, _P],
    "mjv_decoder_attention_rows": [_P] * 7 + [_I] * 6 + [_L] * 6 + [_F, _P],
    "mjv_decoder_attention_rows_op": [_P] * 8 + [_I] * 6 + [_L] * 6
    + [_I, _F, _P],
    "mjv_key_norm_cummax": [_P] * 4 + [_I] * 4 + [_L] * 2 + [_I, _P],
    "mjv_key_norm_max": [_P] * 4 + [_I] * 4 + [_L] * 2 + [_I, _P],
    "mjv_exact_attention": [_P] * 7 + [_I] * 6 + [_L] * 6 + [_F, _I, _P],
    "mjv_decoder_attention_bwd_dkdv": _BWD[:8] + [_P, _P] + _BWD[8:],
    "mjv_decoder_attention_bwd_dq": _BWD[:8] + [_P] + _BWD[8:],
    "mjv_q8g_matmul_fused": [_P] * 6 + [_I] * 5 + [_L, _P],
    "mjv_q8g_matmul": [_P] * 5 + [_I] * 4 + [_L, _P],
    "mjv_q8g_quantize": [_P] * 3 + [_I] * 3 + [_P],
    "mjv_w4_matmul": [_P] * 4 + [_I] * 4 + [_P],
    "mjv_w4_plan": [_I] * 4 + [_P],
    "mjv_vit_attention_variant": _VARIANT,
    "mjv_vit_attention_tmajor": _VARIANT,
    "mjv_vit_attention_bshd": _VARIANT,
}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        _lib = lib
    return _lib


def _check_qkv(name: str, head_dim, *ts: torch.Tensor) -> None:
    """Checks shared by every attention wrapper; ``head_dim`` is the head
    dim the kernel is built for, or a tuple of them."""
    dims = (head_dim,) if isinstance(head_dim, int) else tuple(head_dim)
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}, a CUDA "
                             f"device; got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: q/k/v must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected (B, S, H, D), got {tuple(t.shape)}")
        D = t.shape[-1]
        if t.stride(-1) != 1 or t.stride(-2) != D:
            raise ValueError(f"{name}: heads must be dense (strides (.., D, 1)), "
                             f"got {t.stride()}")
        if t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
        if t.shape[-1] not in dims:
            raise ValueError(f"{name}: built for head dim "
                             f"{' or '.join(map(str, dims))}, got "
                             f"{t.shape[-1]}")


def _check_aux(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _count(name: str, D: int) -> None:
    """One launch of ``name``, and of its form at head dim D where that has
    a counter of its own (D = 128 for K1, 112, 96, 80 or 72)."""
    launch_counts[name] += 1
    if f"{name}_d{D}" in launch_counts:
        launch_counts[f"{name}_d{D}"] += 1


def forward_only(name: str, *ts: torch.Tensor) -> None:
    """A kernel whose result autograd cannot differentiate (it writes into
    ``torch.empty`` and has no backward kernel) refuses a call that
    autograd would need to differentiate, instead of returning a detached
    result whose gradient would silently be missing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name} has no backward kernel; call it under torch.no_grad()")


def _check_vit(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, with_lse: bool) -> None:
    """K1's checks: InternViT-300M's head dim of 64, or the Qwen2-VL vision
    tower's 80, SigLIP-so400m's 72 or InternViT-6B's 128, which are built
    without the lse (the judges need no gradient)."""
    _check_qkv(name, (64,) if with_lse else (64, 72, 80, 128), q, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must share (B, S, H, D)")


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kmax: torch.Tensor, scale: float, with_lse: bool = False):
    """K1 alone on a given kmax.  q/k/v: (B, S, H, D) bf16 with D = 64 (72,
    80 or 128 without the lse) and dense heads (row strides free); kmax:
    (B, H) fp32 (``key_norm_max``).
    Returns a dense (B, S, H, D) bf16 tensor, and with ``with_lse`` also the
    (B, H, S) fp32 lse (1e30 on a row whose sum underflowed).  With the lse
    or without, it runs on the wgmma/TMA template
    (``decoder_attention_sm90.cuh``); ``vit_attention_op`` is the op."""
    name = "vit_attention"
    _check_vit(name, q, k, v, with_lse)
    B, S, H, D = q.shape
    _check_aux(f"{name} kmax", kmax, torch.float32, (B, H), q.device)
    lib = _load()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_vit_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, S, H,
            D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale), stream)
    _raise_on(name, err)
    _count(name, D)
    if with_lse:
        launch_counts["vit_attention_lse"] += 1
    return (out, lse) if with_lse else out


def vit_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, with_lse: bool = False):
    """The K1 op: its pre-pass's partial maxima of the key norms, then K1
    launched behind it as a programmatic dependent that folds them, from
    one C call.  Operands and results as for ``vit_attention`` without
    kmax; the output is bit-equal to ``vit_attention`` on
    ``key_norm_max(k)``.  Counts one ``key_norm_max`` and one
    ``vit_attention``."""
    name = "vit_attention"
    _check_vit(name, q, k, v, with_lse)
    B, S, H, D = q.shape
    parts = key_norm_parts(B, S, H, D)
    lib = _load()
    dev = q.device
    part = torch.empty((B, parts, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    with torch.cuda.device(dev):
        err = lib.mjv_vit_attention_op(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, S, H,
            D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), parts, float(scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    _count("key_norm_max", D)
    _count(name, D)
    if with_lse:
        launch_counts["vit_attention_lse"] += 1
    return (out, lse) if with_lse else out


def _check_vit_masked(name: str, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, attention_mask: torch.Tensor) -> None:
    """K1m's checks: SigLIP-so400m's head dim of 72, q, k and v of one
    (B, S, H, D) (self-attention, a kv head a q head), a (B, S) int32 key
    mask."""
    _check_qkv(name, 72, q, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must share (B, S, H, D)")
    B, S = q.shape[:2]
    if attention_mask is None:
        raise ValueError(f"{name}: needs a key mask (without one, K1)")
    _check_aux(f"{name} mask", attention_mask, torch.int32, (B, S), q.device)


def vit_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention_mask: torch.Tensor, kmax: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """K1m alone on a given kmax: non-causal attention under a (B, S) key
    mask (1 = live) with the bound of K2, kmax the largest live key norm;
    a row that sees no live key gives 0.  q/k/v: (B, S, H, 72) bf16 with
    dense heads (row strides free); kmax: (B, H) fp32 (``key_norm_max(k,
    attention_mask)``).  Returns a dense (B, S, H, 72) bf16 tensor;
    ``vit_attention_masked_op`` is the op."""
    name = "vit_attention_masked"
    _check_vit_masked(name, q, k, v, attention_mask)
    B, S, H, D = q.shape
    _check_aux(f"{name} kmax", kmax, torch.float32, (B, H), q.device)
    lib = _load()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mjv_vit_attention_masked(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            attention_mask.data_ptr(), kmax.data_ptr(), out.data_ptr(), B, S,
            H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return out


def vit_attention_masked_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, attention_mask: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """The K1m op: its pre-pass's partial maxima of the live key norms,
    then K1m launched behind it as a programmatic dependent that folds
    them, from one C call.  Operands and result as for
    ``vit_attention_masked`` without kmax; the output is bit-equal to
    ``vit_attention_masked`` on ``key_norm_max(k, attention_mask)``.
    Counts one ``key_norm_max`` (and ``key_norm_max_d72``,
    ``key_norm_max_masked_d72``) and one ``vit_attention_masked``."""
    name = "vit_attention_masked"
    _check_vit_masked(name, q, k, v, attention_mask)
    B, S, H, D = q.shape
    parts = key_norm_parts(B, S, H, D)
    lib = _load()
    dev = q.device
    part = torch.empty((B, parts, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.mjv_vit_attention_masked_op(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            attention_mask.data_ptr(), part.data_ptr(), out.data_ptr(), B, S,
            H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), parts, float(scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    _count("key_norm_max", D)
    launch_counts["key_norm_max_masked_d72"] += 1
    launch_counts[name] += 1
    return out


def _vit_bwd_operands(name, q, k, v, dout, lse, delta):
    """Checks shared by the two K4 nc wrappers; returns (pointers, sizes and
    strides)."""
    _check_qkv(name, 64, q, k, v, dout)
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: q, k, v and dout must share (B, S, H, D)")
    if not dout.is_contiguous():
        raise ValueError(f"{name}: dout must be dense")
    _check_aux(f"{name} lse", lse, torch.float32, (B, H, S), q.device)
    _check_aux(f"{name} delta", delta, torch.float32, (B, H, S), q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = (B, S, H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), dout.stride(0), dout.stride(1))
    return ptrs, tail


def vit_attention_bwd_dkdv(q, k, v, dout, lse, delta, scale: float):
    """K4 nc dK/dV.  q/k/v: (B, S, H, 64) bf16 with dense heads (row
    strides free, as K1 takes them); dout: dense (B, S, H, 64) bf16; lse,
    delta: (B, H, S) fp32.  Returns dense (B, S, H, D) bf16 dk and dv."""
    name = "vit_attention_bwd_dkdv"
    ptrs, tail = _vit_bwd_operands(name, q, k, v, dout, lse, delta)
    lib = _load()
    dk = torch.empty(q.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(q.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_vit_attention_bwd_dkdv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *tail, float(scale), stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return dk, dv


def vit_attention_bwd_dq(q, k, v, dout, lse, delta,
                         scale: float) -> torch.Tensor:
    """K4 nc dQ.  Operands as for ``vit_attention_bwd_dkdv``; returns a
    dense (B, S, H, D) bf16 dq."""
    name = "vit_attention_bwd_dq"
    ptrs, tail = _vit_bwd_operands(name, q, k, v, dout, lse, delta)
    lib = _load()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_vit_attention_bwd_dq(
            *ptrs, dq.data_ptr(), *tail, float(scale), stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return dq


def _check_decoder(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, attention_mask: Optional[torch.Tensor],
                   q_offset: Optional[torch.Tensor], *more: torch.Tensor,
                   dims=(128,)):
    """Checks shared by K2, K2r, K3 and K4 (``more``: K4's dout, checked
    like q; ``dims``: the head dims the kernel is built for); returns (mask
    pointer, offset pointer)."""
    _check_qkv(name, dims, q, k, v, *more)
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (B, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"{name}: k/v must be (B, K, Hkv, D) with Hkv "
                         "dividing Hq")
    mask_ptr = off_ptr = None
    if attention_mask is not None:
        _check_aux(f"{name} mask", attention_mask, torch.int32, (B, K),
                   q.device)
        mask_ptr = attention_mask.data_ptr()
    if q_offset is not None:
        _check_aux(f"{name} q_offset", q_offset, torch.int32, (B,), q.device)
        off_ptr = q_offset.data_ptr()
    return mask_ptr, off_ptr


def decoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      attention_mask: Optional[torch.Tensor],
                      kmax: torch.Tensor, q_offset: Optional[torch.Tensor],
                      scale: float, with_lse: bool = False):
    """K2 alone on a given kmax.  q: (B, Q, Hq, D), k/v: (B, K, Hkv, D)
    bf16 with D = 128 (InternLM2) or 96 (Phi-3), dense heads; attention_mask: (B, K) int32 or None; kmax: (B, Hkv) fp32
    (``key_norm_max``); q_offset: (B,) int32 or None (= 0).  Returns a
    dense (B, Q, Hq, D) bf16 tensor, and with ``with_lse`` also the (B, Hq,
    Q) fp32 lse (1e30 on dead rows).  With the lse or without, it runs on
    the wgmma/TMA template; ``decoder_attention_op`` is the op."""
    name = "decoder_attention"
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset, dims=(96, 128))
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    _check_aux(f"{name} kmax", kmax, torch.float32, (B, Hkv), q.device)
    lib = _load()
    out = torch.empty((B, Q, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Q), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_decoder_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            kmax.data_ptr(), off_ptr, out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Q, K, Hq, Hkv, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), float(scale), stream)
    _raise_on(name, err)
    _count(name, D)
    if with_lse:
        _count("decoder_attention_lse", D)
    return (out, lse) if with_lse else out


def decoder_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention_mask: Optional[torch.Tensor],
                         q_offset: Optional[torch.Tensor], scale: float,
                         with_lse: bool = False):
    """The K2 op: its pre-pass's partial maxima of the masked key norms,
    then K2 launched behind it as a programmatic dependent that folds them,
    from one C call.  Operands and results as for ``decoder_attention``
    without kmax; the output is bit-equal to ``decoder_attention`` on
    ``key_norm_max(k, attention_mask)``.  Counts one ``key_norm_max`` and
    one ``decoder_attention``."""
    name = "decoder_attention"
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset, dims=(96, 128))
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    parts = key_norm_parts(B, K, Hkv, D)
    lib = _load()
    dev = q.device
    part = torch.empty((B, parts, Hkv), dtype=torch.float32, device=dev)
    out = torch.empty((B, Q, Hq, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, Hq, Q), dtype=torch.float32, device=dev)
           if with_lse else None)
    with torch.cuda.device(dev):
        err = lib.mjv_decoder_attention_op(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, off_ptr,
            part.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Q, K, Hq, Hkv, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), parts, float(scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    _count("key_norm_max", D)
    _count(name, D)
    if with_lse:
        _count("decoder_attention_lse", D)
    return (out, lse) if with_lse else out


def _key_norm_operands(name: str, k: torch.Tensor,
                       attention_mask: Optional[torch.Tensor],
                       parts: Optional[int], dims=(64, 72, 80, 96, 128)):
    """Checks shared by the key-norm pre-passes (k: (B, K, Hkv, D) bf16 with
    D one of ``dims``, dense heads, free row strides; attention_mask: (B,
    K) int32 or None); returns (mask pointer, the chunk count: ``parts``,
    or the plan ``key_norm_parts`` when None)."""
    _check_qkv(name, dims, k)
    B, K, Hkv, D = k.shape
    mask_ptr = None
    if attention_mask is not None:
        _check_aux(f"{name} mask", attention_mask, torch.int32, (B, K),
                   k.device)
        mask_ptr = attention_mask.data_ptr()
    plan = key_norm_parts(B, K, Hkv, D)
    parts = plan if parts is None else int(parts)
    if not 1 <= parts <= K:
        raise ValueError(f"{name}: parts={parts} must lie in [1, {K}]")
    return mask_ptr, parts


def key_norm_cummax(k: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None,
                    parts: Optional[int] = None) -> torch.Tensor:
    """K2r's pre-pass alone, as the K2r op runs it: the partial pass over
    ``parts`` chunks of keys (the plan, ``key_norm_parts``, by default; 1 <=
    parts <= K), which also stores every key's norm, then the scan that
    runs the earlier chunks' max through each chunk, from one C call.  k:
    (B, K, Hkv, D) bf16 with D = 128 (InternLM2) or 96 (Phi-3) and dense
    heads (row strides free);
    attention_mask: (B, K) int32 or None.  Returns the (B, Hkv, K) fp32
    running max along K of the masked key norms, the same bits for every
    ``parts``; its last column is ``key_norm_max``'s."""
    name = "key_norm_cummax"
    mask_ptr, parts = _key_norm_operands(name, k, attention_mask, parts,
                                         dims=(96, 128))
    B, K, Hkv, D = k.shape
    lib = _load()
    part = torch.empty((B, parts, Hkv), dtype=torch.float32, device=k.device)
    out = torch.empty((B, Hkv, K), dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_key_norm_cummax(k.data_ptr(), mask_ptr, part.data_ptr(),
                                      out.data_ptr(), B, K, Hkv, D,
                                      k.stride(0), k.stride(1), parts, stream)
    _raise_on(name, err)
    _count(name, D)
    return out


def key_norm_lanes(D: int) -> int:
    """The pre-pass's lanes a key vector: its D / 8 16-byte pieces rounded
    up to a power of two (``key_norm_lanes`` of
    ``csrc/decoder_attention.cu``; D = 72's 9 pieces, D = 80's 10 and
    D = 96's 12 take 16 lanes)."""
    pieces = D // 8
    return pieces if pieces & (pieces - 1) == 0 else 1 << pieces.bit_length()


def key_norm_parts(B: int, K: int, Hkv: int, D: int) -> int:
    """How many partial maxima per (b, kv head) the K1/K2 pre-pass writes
    for k of shape (B, K, Hkv, D): about KEY_NORM_CTAS CTAs over the
    grid, each at least one pass of KEY_NORM_LOADS loads a thread (whole
    keys), at most KEY_NORM_PARTS_MAX.  Raises where one pass cannot hold a
    whole key (more than 64 heads of 128, 96, 80 or 72, or 128 of 64)."""
    # Key vectors a pass.
    heads = KEY_NORM_THREADS // key_norm_lanes(D) * KEY_NORM_LOADS
    if Hkv > heads:
        raise ValueError(f"key_norm_max: {Hkv} heads of {D} exceed one pass "
                         f"of the pre-pass ({heads} heads)")
    per = heads // Hkv  # whole keys a pass
    return max(1, min(-(-KEY_NORM_CTAS // B), KEY_NORM_PARTS_MAX,
                      -(-K // per)))


def key_norm_max(k: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None,
                 parts: Optional[int] = None) -> torch.Tensor:
    """The pre-pass of K1 and K2 (and of their lse forms) alone, as the ops
    run it: its partial maxima over ``parts`` chunks of keys (the plan,
    ``key_norm_parts``, by default; 1 <= parts <= K), then their fold, from
    one C call.  k: (B, K, Hkv, D) bf16 with D 64, 72, 80, 96 or 128, dense
    heads and free row strides (a view into the ViT's qkv tensor, or a
    cache's slots); attention_mask: (B, K) int32 or None.  Returns the (B, Hkv)
    fp32 largest norm of a live key of each (b, kv head), 0 where none is
    live."""
    name = "key_norm_max"
    # Built for the ViTs' 64 (InternViT), 80 (Qwen2-VL) and 72 (SigLIP) and
    # the decoders' 128 (InternLM2) and 96 (Phi-3).
    mask_ptr, parts = _key_norm_operands(name, k, attention_mask, parts)
    B, K, Hkv, D = k.shape
    lib = _load()
    part = torch.empty((B, parts, Hkv), dtype=torch.float32, device=k.device)
    out = torch.empty((B, Hkv), dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_key_norm_max(k.data_ptr(), mask_ptr, part.data_ptr(),
                                   out.data_ptr(), B, K, Hkv, D, k.stride(0),
                                   k.stride(1), parts, stream)
    _raise_on(name, err)
    _count(name, D)
    if D == 72 and attention_mask is not None:
        launch_counts["key_norm_max_masked_d72"] += 1
    return out


def decoder_attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           attention_mask: Optional[torch.Tensor],
                           kcum: torch.Tensor,
                           q_offset: Optional[torch.Tensor],
                           scale: float) -> torch.Tensor:
    """K2r alone on a given kcum.  Operands as for K2, with ``kcum`` the
    (B, Hkv, K) fp32 running max of masked key norms (``key_norm_cummax``)
    in place of kmax; the kernel reads it at each row's position
    ``clip(q_offset + i, 0, K - 1)``.  Returns a dense (B, Q, Hq, D) bf16
    tensor; ``decoder_attention_rows_op`` is the op."""
    name = "decoder_attention_rows"
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset, dims=(96, 128))
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    _check_aux(f"{name} kcum", kcum, torch.float32, (B, Hkv, K), q.device)
    lib = _load()
    out = torch.empty((B, Q, Hq, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_decoder_attention_rows(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            kcum.data_ptr(), off_ptr, out.data_ptr(), B, Q, K, Hq, Hkv, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), float(scale), stream)
    _raise_on(name, err)
    _count(name, D)
    return out


def decoder_attention_rows_op(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              attention_mask: Optional[torch.Tensor],
                              q_offset: Optional[torch.Tensor],
                              scale: float) -> torch.Tensor:
    """The K2r op: its pre-pass (the partial pass with every key's norm,
    then the scan as its programmatic dependent) and K2r launched behind
    the scan as its programmatic dependent, from one C call.  Operands and
    result as for ``decoder_attention_rows`` without kcum; the output is
    bit-equal to ``decoder_attention_rows`` on ``key_norm_cummax(k,
    attention_mask)``.  Counts one ``key_norm_cummax`` and one
    ``decoder_attention_rows``."""
    name = "decoder_attention_rows"
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset, dims=(96, 128))
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    parts = key_norm_parts(B, K, Hkv, D)
    lib = _load()
    dev = q.device
    part = torch.empty((B, parts, Hkv), dtype=torch.float32, device=dev)
    kcum = torch.empty((B, Hkv, K), dtype=torch.float32, device=dev)
    out = torch.empty((B, Q, Hq, D), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.mjv_decoder_attention_rows_op(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, off_ptr,
            part.data_ptr(), kcum.data_ptr(), out.data_ptr(), B, Q, K, Hq,
            Hkv, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), parts, float(scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    _count("key_norm_cummax", D)
    _count(name, D)
    return out


def k3_head_dims(causal: bool, with_lse: bool) -> tuple:
    """The head dims K3 is built for: 96 and 128 in every form, and 112
    (``Config D112``) only not causal and without the lse, as
    ``csrc/exact_attention.cu`` admits it."""
    return (96, 128) if causal or with_lse else (96, 112, 128)


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: Optional[torch.Tensor],
                    q_offset: Optional[torch.Tensor], scale: float,
                    causal: bool = True, with_lse: bool = False):
    """K3.  q: (B, Q, Hq, D), k/v: (B, K, Hkv, D) bf16 with D = 128
    (InternLM2, Llama-3) or 96 (Phi-3), or, not causal and without the lse,
    112 (the EVA2-CLIP-E tower); dense heads;
    attention_mask: (B, K) int32 or None; q_offset: (B,) int32 or None (=
    0; read only when causal; may be negative).  Returns a dense (B, Q, Hq,
    D) bf16 tensor, and with ``with_lse`` also the (B, Hq, Q) fp32 lse
    (1e30 on a row that sees no key)."""
    name = "exact_attention"
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset,
                                       dims=k3_head_dims(causal, with_lse))
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    lib = _load()
    out = torch.empty((B, Q, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Q), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_exact_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, off_ptr,
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, Q, K,
            Hq, Hkv, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale), int(causal), stream)
    _raise_on(name, err)
    _count(name, D)
    if with_lse:
        _count("exact_attention_lse", D)
    return (out, lse) if with_lse else out


def _bwd_operands(name, q, k, v, dout, lse, delta, attention_mask,
                  q_offset):
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset, dout, dims=(96, 128))
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout must have q's shape {tuple(q.shape)}")
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    _check_aux(f"{name} lse", lse, torch.float32, (B, Hq, Q), q.device)
    _check_aux(f"{name} delta", delta, torch.float32, (B, Hq, Q), q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), mask_ptr, off_ptr)
    tail = (B, Q, K, Hq, Hkv, D, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), dout.stride(0),
            dout.stride(1))
    return ptrs, tail


def decoder_attention_bwd_dkdv(q, k, v, dout, lse, delta,
                               attention_mask: Optional[torch.Tensor],
                               q_offset: Optional[torch.Tensor],
                               scale: float, causal: bool = True):
    """K4a.  q/dout: (B, Q, Hq, D), k/v: (B, K, Hkv, D) bf16 with D = 128
    (InternLM2) or 96 (Phi-3), dense heads; lse, delta: (B, Hq, Q) fp32;
    mask and q_offset as for K3 (the offset read only when causal; Q may
    differ from K).  Runs on the wgmma/TMA backward template
    (``attention_bwd_sm90.cuh``), whose tensor maps want 16-byte aligned
    bases and row and batch strides: another view raises here, as does
    another head dim.  Returns dense
    (B, K, Hkv, D) bf16 dk and dv, summed over each GQA group, exactly 0 on
    masked keys."""
    name = "decoder_attention_bwd_dkdv"
    ptrs, tail = _bwd_operands(name, q, k, v, dout, lse, delta,
                               attention_mask, q_offset)
    lib = _load()
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_decoder_attention_bwd_dkdv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *tail, float(scale),
            int(causal), stream)
    _raise_on(name, err)
    _count(name, q.shape[-1])
    return dk, dv


def decoder_attention_bwd_dq(q, k, v, dout, lse, delta,
                             attention_mask: Optional[torch.Tensor],
                             q_offset: Optional[torch.Tensor],
                             scale: float, causal: bool = True
                             ) -> torch.Tensor:
    """K4b.  Operands and their checks as for K4a; returns a dense (B, Q,
    Hq, D) bf16 dq, exactly 0 on a dead row (lse 1e30)."""
    name = "decoder_attention_bwd_dq"
    ptrs, tail = _bwd_operands(name, q, k, v, dout, lse, delta,
                               attention_mask, q_offset)
    lib = _load()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_decoder_attention_bwd_dq(
            *ptrs, dq.data_ptr(), *tail, float(scale), int(causal), stream)
    _raise_on(name, err)
    _count(name, q.shape[-1])
    return dq


def _check_dense(name: str, t: torch.Tensor, dtype, shape, dev,
                 align: int = 1) -> None:
    """A contiguous ``dtype`` tensor of ``shape`` on the CUDA device
    ``dev`` whose data starts at a multiple of ``align`` bytes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    _check_aux(name, t, dtype, shape, dev)
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned")


def _group_operands(name: str, wq: torch.Tensor, w_scale: torch.Tensor,
                    M: int, K: int, dev):
    """Checks shared by K6 and K7; returns (N, G).  wq must be stored
    k-major (``ops.quant.k_major``, as the port's quantizer stores every
    int8 weight): the kernels read it by TMA as an (N, K) array and would
    otherwise need a transposed copy of the weight at every call."""
    if wq.dim() != 2 or w_scale.dim() != 2 or wq.shape[0] != K:
        raise ValueError(f"{name}: wq must be (K, N) = ({K}, N) and w_scale "
                         f"(G, N); got {tuple(wq.shape)}, "
                         f"{tuple(w_scale.shape)}")
    N, G = wq.shape[1], w_scale.shape[0]
    if M < 1 or G < 1 or K % G or (K // G) % 32:
        raise ValueError(f"{name}: the group size K / G = {K} / {G} must be "
                         "a whole multiple of 32, and M >= 1")
    if wq.device != dev or wq.dtype != torch.int8:
        raise ValueError(f"{name}: wq must be int8 on {dev}, got {wq.dtype} "
                         f"on {wq.device}")
    if wq.stride(0) != 1 or (N > 1 and wq.stride(1) != K):
        raise ValueError(f"{name}: wq must be k-major, a (K, N) view of an "
                         f"(N, K) contiguous tensor (strides (1, {K})), got "
                         f"strides {wq.stride()}; store it so once "
                         "(ops.quant.k_major)")
    if wq.data_ptr() % 16:
        raise ValueError(f"{name}: wq must be 16-byte aligned")
    _check_dense(f"{name} w_scale", w_scale, torch.float32, (G, N), dev)
    return N, G


def q8g_quantize(x: torch.Tensor, G: int):
    """K6's pre-pass alone.  x: (M, K) bf16, contiguous and 16-byte
    aligned, K / G a multiple of 32.  Returns (xq (M, K) int8, a_s (M, G)
    fp32), bit-equal to ``ops.quant._quantize_rows_grouped``."""
    name = "q8g_quantize"
    M, K = x.shape
    _check_dense(f"{name} x", x, torch.bfloat16, (M, K), x.device, 16)
    if M < 1 or G < 1 or K % G or (K // G) % 32:
        raise ValueError(f"{name}: the group size K / G = {K} / {G} must be "
                         "a whole multiple of 32, and M >= 1")
    lib = _load()
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    a_s = torch.empty((M, G), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_q8g_quantize(x.data_ptr(), xq.data_ptr(),
                                   a_s.data_ptr(), M, K, G, stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return xq, a_s


def q8g_matmul_fused(x: torch.Tensor, wq: torch.Tensor,
                     w_scale: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """K6: its pre-pass (x quantized once per (row, group) into scratch)
    and K7's GEMM, from one C call.  x: (M, K) bf16, contiguous; wq: (K, N)
    int8 stored k-major; w_scale: (G, N) fp32 with K / G a multiple of 32.
    Returns a (M, N) tensor of ``out_dtype`` (bf16 or fp32)."""
    name = "q8g_matmul_fused"
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    _check_dense(f"{name} x", x, torch.bfloat16, (M, K), x.device, 16)
    N, G = _group_operands(name, wq, w_scale, M, K, x.device)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bf16 or fp32")
    lib = _load()
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    a_s = torch.empty((M, G), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_q8g_matmul_fused(
            x.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), xq.data_ptr(),
            a_s.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
            M, N, K, G, K, stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    launch_counts["q8g_quantize"] += 1
    return out


def q8g_matmul(xq: torch.Tensor, a_scale: torch.Tensor, wq: torch.Tensor,
               w_scale: torch.Tensor) -> torch.Tensor:
    """K7, K6's GEMM alone.  xq: (M, K) int8 and a_scale: (M, G) fp32,
    contiguous; wq: (K, N) int8 stored k-major; w_scale: (G, N) fp32 with
    K / G a multiple of 32.  Returns a (M, N) fp32 tensor."""
    name = "q8g_matmul"
    if xq.dim() != 2:
        raise ValueError(f"{name}: xq must be (M, K), got {tuple(xq.shape)}")
    M, K = xq.shape
    _check_dense(f"{name} xq", xq, torch.int8, (M, K), xq.device, 16)
    N, G = _group_operands(name, wq, w_scale, M, K, xq.device)
    _check_dense(f"{name} a_scale", a_scale, torch.float32, (M, G),
                 xq.device)
    lib = _load()
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_q8g_matmul(
            xq.data_ptr(), a_scale.data_ptr(), wq.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), M, N, K, G, K, stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return out


def _w4_operands(name: str, x: torch.Tensor, packed: torch.Tensor,
                 scale: torch.Tensor):
    """K5's checks; returns (M, N, K, G).  packed must be stored k-major
    (``ops.quant.k_major``, as the port's quantizer and bridge store every
    packed int4 weight): the kernel reads each column's packed bytes as one
    contiguous run and would otherwise need a transposed copy per call."""
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"{name}: x, packed and scale must be 2-D")
    M, K = x.shape
    N, G = packed.shape[1], scale.shape[0]
    if (not 1 <= M <= 32 or packed.shape[0] * 2 != K or G < 1 or K % G
            or (K // 2) % (K // G)):
        raise ValueError(f"{name}: need 1 <= M <= 32, packed (K/2, N) and "
                         "whole groups in each half; got x "
                         f"{tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if packed.device != x.device or packed.dtype != torch.int8:
        raise ValueError(f"{name}: packed must be int8 on {x.device}, got "
                         f"{packed.dtype} on {packed.device}")
    if packed.stride(0) != 1 or (N > 1 and packed.stride(1) != K // 2):
        raise ValueError(f"{name}: packed must be k-major, a (K/2, N) view "
                         "of an (N, K/2) contiguous tensor (strides (1, "
                         f"{K // 2})), got strides {packed.stride()}; store "
                         "it so once (ops.quant.k_major)")
    _check_dense(f"{name} x", x, torch.bfloat16, (M, K), x.device)
    _check_dense(f"{name} scale", scale, torch.bfloat16, (G, N), x.device)
    return M, N, K, G


def w4_plan(M: int, N: int, K: int, G: int) -> Dict[str, int]:
    """K5's plan of a call, read from the C side for operands aligned to 16
    bytes: its path (the tensor-core one, or the generic one for a g or K
    that does not fit it), columns per CTA, warps along K, the cluster's K
    split, packed rows per CTA and dynamic shared memory."""
    info = (ctypes.c_int * 6)()
    err = _load().mjv_w4_plan(M, N, K, G, info)
    _raise_on("w4_plan", err)
    return dict(zip(("fast", "bn", "kw", "cluster", "slice", "smem"), info))


def w4_matmul(x: torch.Tensor, packed: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """K5.  x: (M, K) bf16, contiguous, M <= 32; packed: (K/2, N) int8
    half-split nibbles stored k-major; scale: (G, N) bf16, contiguous, with
    K/2 a multiple of g = K / G.  Returns a (M, N) fp32 tensor, every
    element written by the one launch (no memset)."""
    name = "w4_matmul"
    M, N, K, G = _w4_operands(name, x, packed, scale)
    lib = _load()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_w4_matmul(x.data_ptr(), packed.data_ptr(),
                                scale.data_ptr(), out.data_ptr(), M, N, K, G,
                                stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return out


def _variant_launch(name: str, entry: str, q, k, v, scale: float,
                    last: int) -> torch.Tensor:
    """Checks and launch shared by B1, B2 and B3: q/k/v (B, S, H, 64) bf16
    of one shape with dense heads (row strides free); ``last`` is the
    entry's mode, hp or kv_valid.  Returns a dense (B, S, H, D) bf16
    tensor.  A launch the C entry refuses or that fails raises."""
    _check_qkv(name, 64, q, k, v)
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must share (B, S, H, D)")
    lib = _load()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale), int(last), stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return out


def vit_attention_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mode: str, scale: float) -> torch.Tensor:
    """B1 on the wgmma/TMA forward template (one walk over the keys, each
    mode a policy of it).  q/k/v: (B, S, H, 64) bf16 with dense heads (row
    strides free); ``mode`` one of VARIANT_MODES.  Returns a dense (B, S,
    H, D) bf16 tensor.  The unshifted modes (``nomax``, ``exp2_nomax``)
    overflow once |s * scale| passes 88 (exp) or 128 / log2(e) (exp2):
    they are for the harness only, on inputs whose logits stay far below
    that."""
    name = "vit_attention_variant"
    if mode not in VARIANT_MODES:
        raise ValueError(f"{name}: mode must be one of {VARIANT_MODES}, got "
                         f"{mode!r}")
    # The exp2 modes fold scale * log2(e) into q (rounded to fp32 once, as
    # the TPU harness's constant is); the others scale the scores.
    fold = scale * LOG2E if mode in ("exp2", "exp2_nomax") else scale
    return _variant_launch(name, "mjv_vit_attention_variant", q, k, v, fold,
                           VARIANT_MODES.index(mode))


def vit_attention_tmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         hp: int, scale: float) -> torch.Tensor:
    """B2: the exact online softmax of the wgmma/TMA forward template with
    ``hp`` adjacent heads per CTA (one of TMAJOR_HP, dividing H; one kv
    ring serves them).  Operands and result as for
    ``vit_attention_variant``."""
    name = "vit_attention_tmajor"
    if hp not in TMAJOR_HP or q.shape[2] % hp:
        raise ValueError(f"{name}: hp={hp} must be one of {TMAJOR_HP} and "
                         f"divide the {q.shape[2]} heads")
    return _variant_launch(name, "mjv_vit_attention_tmajor", q, k, v, scale,
                           hp)


def vit_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_valid: Optional[int], scale: float) -> torch.Tensor:
    """B3: the exact row max over the keys below ``kv_valid`` (None: all
    S), B2's hp 1 walk on the wgmma/TMA forward template with its k/v
    ending at ``kv_valid`` (never read past it).  Operands as for
    ``vit_attention_variant``; returns the dense output viewed as (B, S,
    H * D)."""
    name = "vit_attention_bshd"
    S = q.shape[1]
    kv_valid = S if kv_valid is None else int(kv_valid)
    if not 1 <= kv_valid <= S:
        raise ValueError(f"{name}: kv_valid={kv_valid} must lie in [1, {S}]")
    out = _variant_launch(name, "mjv_vit_attention_bshd", q, k, v, scale,
                          kv_valid)
    return out.view(out.shape[0], S, -1)
