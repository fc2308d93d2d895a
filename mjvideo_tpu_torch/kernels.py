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
``launch_counts``.
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
SOURCES = ("vit_attention.cu", "decoder_attention.cu",
           "decoder_attention_bwd.cu", "exact_attention.cu")
HEADERS = ("bound_attention.cuh",)
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset_launch_counts();
# "decoder_attention" counts K2 with and without the lse,
# "decoder_attention_lse" the launches of K2 with it.
launch_counts: Dict[str, int] = {
    "vit_attention": 0, "decoder_attention": 0, "decoder_attention_lse": 0,
    "decoder_attention_bwd_dkdv": 0, "decoder_attention_bwd_dq": 0,
    "exact_attention": 0, "decoder_attention_rows": 0}

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


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.mjv_vit_attention.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _P]
        lib.mjv_vit_attention.restype = _I
        lib.mjv_decoder_attention.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _L, _L, _L, _L, _L, _L, _F, _P]
        lib.mjv_decoder_attention.restype = _I
        lib.mjv_decoder_attention_rows.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _L, _L, _L, _L, _L, _L, _F, _P]
        lib.mjv_decoder_attention_rows.restype = _I
        lib.mjv_exact_attention.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _L, _L, _L, _L, _L, _L, _F, _I, _P]
        lib.mjv_exact_attention.restype = _I
        bwd_args = [_P] * 8 + [_I] * 6 + [_L] * 8 + [_F, _P]
        lib.mjv_decoder_attention_bwd_dkdv.argtypes = (
            bwd_args[:8] + [_P, _P] + bwd_args[8:])
        lib.mjv_decoder_attention_bwd_dkdv.restype = _I
        lib.mjv_decoder_attention_bwd_dq.argtypes = (
            bwd_args[:8] + [_P] + bwd_args[8:])
        lib.mjv_decoder_attention_bwd_dq.restype = _I
        _lib = lib
    return _lib


def _check_qkv(name: str, head_dim: int, *ts: torch.Tensor) -> None:
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
        if t.shape[-1] != head_dim:
            raise ValueError(f"{name}: built for head dim {head_dim}, got "
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


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kmax: torch.Tensor, scale: float) -> torch.Tensor:
    """K1.  q/k/v: (B, S, H, 64) bf16 with dense heads (row strides free);
    kmax: (B, H) fp32.  Returns a dense (B, S, H, D) bf16 tensor."""
    _check_qkv("vit_attention", 64, q, k, v)
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("vit_attention: q, k and v must share (B, S, H, D)")
    _check_aux("vit_attention kmax", kmax, torch.float32, (B, H), q.device)
    lib = _load()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_vit_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(),
            out.data_ptr(), B, S, H, D, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), float(scale), stream)
    _raise_on("vit_attention", err)
    launch_counts["vit_attention"] += 1
    return out


def _check_decoder(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, attention_mask: Optional[torch.Tensor],
                   q_offset: Optional[torch.Tensor], *more: torch.Tensor):
    """Checks shared by K2, K2r, K3 and K4 (``more``: K4's dout, checked
    like q); returns (mask pointer, offset pointer)."""
    _check_qkv(name, 128, q, k, v, *more)
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
    """K2.  q: (B, Q, Hq, 128), k/v: (B, K, Hkv, 128) bf16, dense heads;
    attention_mask: (B, K) int32 or None; kmax: (B, Hkv) fp32; q_offset:
    (B,) int32 or None (= 0).  Returns a dense (B, Q, Hq, D) bf16 tensor,
    and with ``with_lse`` also the (B, Hq, Q) fp32 lse (1e30 on dead rows).
    """
    name = "decoder_attention"
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset)
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
    launch_counts[name] += 1
    if with_lse:
        launch_counts["decoder_attention_lse"] += 1
    return (out, lse) if with_lse else out


def decoder_attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           attention_mask: Optional[torch.Tensor],
                           row_kmax: torch.Tensor,
                           q_offset: Optional[torch.Tensor],
                           scale: float) -> torch.Tensor:
    """K2r.  Operands as for K2, with ``row_kmax`` the (B, Hq, Q) fp32
    per-row bound column in place of kmax.  Returns a dense (B, Q, Hq, D)
    bf16 tensor."""
    name = "decoder_attention_rows"
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset)
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    _check_aux(f"{name} row_kmax", row_kmax, torch.float32, (B, Hq, Q),
               q.device)
    lib = _load()
    out = torch.empty((B, Q, Hq, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_decoder_attention_rows(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            row_kmax.data_ptr(), off_ptr, out.data_ptr(), B, Q, K, Hq, Hkv, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), float(scale), stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return out


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: Optional[torch.Tensor],
                    q_offset: Optional[torch.Tensor], scale: float,
                    causal: bool = True) -> torch.Tensor:
    """K3.  q: (B, Q, Hq, 128), k/v: (B, K, Hkv, 128) bf16, dense heads;
    attention_mask: (B, K) int32 or None; q_offset: (B,) int32 or None (=
    0; read only when causal).  Returns a dense (B, Q, Hq, D) bf16
    tensor."""
    name = "exact_attention"
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset)
    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    lib = _load()
    out = torch.empty((B, Q, Hq, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_exact_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, off_ptr,
            out.data_ptr(), B, Q, K, Hq, Hkv, D, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1), float(scale),
            int(causal), stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return out


def _bwd_operands(name, q, k, v, dout, lse, delta, attention_mask,
                  q_offset):
    mask_ptr, off_ptr = _check_decoder(name, q, k, v, attention_mask,
                                       q_offset, dout)
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
                               scale: float):
    """K4a.  q/dout: (B, Q, Hq, 128), k/v: (B, K, Hkv, 128) bf16, dense
    heads; lse, delta: (B, Hq, Q) fp32; mask and q_offset as for K2.
    Returns dense (B, K, Hkv, D) bf16 dk and dv, summed over each GQA
    group."""
    name = "decoder_attention_bwd_dkdv"
    ptrs, tail = _bwd_operands(name, q, k, v, dout, lse, delta,
                               attention_mask, q_offset)
    lib = _load()
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_decoder_attention_bwd_dkdv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *tail, float(scale), stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return dk, dv


def decoder_attention_bwd_dq(q, k, v, dout, lse, delta,
                             attention_mask: Optional[torch.Tensor],
                             q_offset: Optional[torch.Tensor],
                             scale: float) -> torch.Tensor:
    """K4b.  Operands as for K4a; returns a dense (B, Q, Hq, D) bf16 dq."""
    name = "decoder_attention_bwd_dq"
    ptrs, tail = _bwd_operands(name, q, k, v, dout, lse, delta,
                               attention_mask, q_offset)
    lib = _load()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mjv_decoder_attention_bwd_dq(
            *ptrs, dq.data_ptr(), *tail, float(scale), stream)
    _raise_on(name, err)
    launch_counts[name] += 1
    return dq
