"""The ViT attention kernels A/B on a CUDA card: K1 against B1 in its four
softmax modes, B2 at each hp it is built for, and B3.

    python3 tools/vit_attn_variants_torch.py [--tiles 8] [--launches 20]
        [--windows 7]

Counterpart of ``benchmarks/vit_attn_variants.py:226-291`` for the port's
hand-written kernels.  Seeded bf16 q, k and v of (tiles, 1025, 16, 64)
(one 448 px tile's 32 x 32 patches and the class token, InternViT-300M's
heads), made on the card.  Prints the card's name and power limit first,
then for each kernel the milliseconds per launch (CUDA events around
``--launches`` back-to-back launches; the median and the spread, min to
max, over ``--windows`` windows, the kernels timed in turns, forward then
reverse order), TF/s at 4 * B * H * S**2 * D operations (34.43 GFLOP at 8
tiles), max|kernel - K1| and max|kernel - its plain twin|.  ``K1`` is the
kernel alone on a precomputed key-norm bound; ``K1 + bound`` adds the
bound's reduction, as the ViT's ``vit_attention`` runs it.  The variants
need no bound.

    python3 tools/vit_attn_variants_torch.py --parent ROOT [--rounds 10]
        [--out FILE]

A/B against another checkout (the parent, a ``git archive`` of it unpacked
under the git-ignored ``build/``), in one process: each tree's kernels are
built from its own sources into its own ``build/kernels`` and loaded side
by side.  On (tiles, 1025, 16, 64) qkv views, B1's modes, B2's hp and B3
(and B3 on (tiles, 1032) with kv_valid 1025, the k/v rows past it zero, as
the JAX harness pads) are timed through the C entries (CUDA events around
one call, median of 2 x ``--rounds``) in turns P C C P, each with its
device time a launch (``torch.profiler``) and
``F.scaled_dot_product_attention`` beside them; each tree's B1/B2/B3
outputs are held against their twins, and the K1, K1 lse, K2, K2 lse, K2r
(alone, on the twin's kcum), K3 and K3 lse outputs (at (8, 1025, 16, 64)
and the judge's (2, 3072, 16/8, 128) with a ragged mask) and B1's and
B2's are digested in both trees and compared bit for bit, as are the
registers, spills and wgmma warnings of every Hopper instantiation the
parent's ptxas reports.  The outputs a change of B3's or K2r's pre-pass
may move (EXPECTED_TO_DIFFER: B3, kcum and the K2r op on it) are reported
by their largest difference between the trees instead.

    python3 tools/vit_attn_variants_torch.py --configs [--rounds 10]

The A/B that chose B1's Config and B2's for each hp (``using
VariantConfig = ...`` and ``using HpN = ...`` in
``csrc/vit_attention_variants.cu``; B3 takes Hp1's and is timed with it):
each of CONFIGS rewritten into a copy
of ``csrc/`` under ``build/variant_configs/`` and built alone, all at once;
each held against its twin, then timed through the C entries in turns with
``F.scaled_dot_product_attention``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

S, H, D = 1025, 16, 64


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_inputs(tiles: int, device, seed: int = 0):
    """Seeded bf16 q, k, v of (tiles, S, H, D) on ``device``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((tiles, S, H, D), generator=g, device=device)
                 .to(torch.bfloat16) for _ in range(3))


def kernel_runs(q, k, v) -> dict:
    """Name -> a call launching that kernel once on q, k, v."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    kmax = fa.key_norm_max(k)
    runs = {"K1": lambda: kernels.vit_attention(q, k, v, kmax, scale),
            "K1 + bound": lambda: fa.vit_attention(q, k, v)}
    for mode in kernels.VARIANT_MODES:
        runs[f"B1 {mode}"] = (lambda m=mode: kernels.vit_attention_variant(
            q, k, v, m, scale))
    for hp in kernels.TMAJOR_HP:
        runs[f"B2 hp={hp}"] = (lambda n=hp: kernels.vit_attention_tmajor(
            q, k, v, n, scale))
    runs["B3"] = lambda: kernels.vit_attention_bshd(q, k, v, None, scale)
    return runs


def twin(name: str, q, k, v):
    """The plain twin's output for the kernel ``name`` of kernel_runs."""
    from mjvideo_tpu_torch.ops import flash_attention as fa
    from mjvideo_tpu_torch.ops import vit_attention_variants as va

    if name.startswith("K1"):
        return fa.vit_attention_plain(q, k, v)
    if name.startswith("B1"):
        return va.variant_attention_plain(q, k, v, name.split()[1])
    if name.startswith("B2"):
        return va.tmajor_attention_plain(q, k, v)
    return va.bshd_attention_plain(q, k, v).view(q.shape)


def time_in_turns(runs: dict, launches: int, windows: int) -> dict:
    """Name -> ms per launch of each window: every window times each kernel
    over ``launches`` back-to-back launches by CUDA events, the kernels in
    turns (forward, then reverse order in the next window)."""
    import torch

    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    names = list(runs)
    times = {name: [] for name in names}
    for w in range(windows):
        for name in (names if w % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                runs[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / launches)
    return times


def flops(q) -> int:
    B, S_, H_, D_ = q.shape
    return 4 * B * H_ * S_ * S_ * D_


def errors(runs: dict, q, k, v) -> dict:
    """Name -> (max|kernel - K1|, max|kernel - its twin|)."""
    import torch

    base = runs["K1"]().float()
    out = {}
    for name, fn in runs.items():
        got = fn().float().view(q.shape)
        ref = twin(name, q, k, v).float()
        out[name] = ((got - base).abs().max().item(),
                     (got - ref).abs().max().item())
        del got, ref
        torch.cuda.empty_cache()
    return out


# The Configs tried by --configs: (the alias in vit_attention_variants.cu,
# its Config); the first of each alias is production's.  VariantConfig is
# B1's (its four modes timed), HpN B2's at hp N.
CONFIGS = (("VariantConfig", "sm90::D64"),
           ("VariantConfig", "sm90::Config<64, 3, 3, 1, 64>"),
           ("VariantConfig", "sm90::Config<64, 4, 3, 1, 64>"),
           ("VariantConfig", "sm90::Config<64, 2, 4>"),
           ("Hp1", "sm90::Config<64, 3, 3, 1, 64>"), ("Hp1", "sm90::D64"),
           ("Hp1", "sm90::Config<64, 4, 3, 1, 64>"),
           ("Hp2", "sm90::Config<64, 4, 4, 2, 64>"),
           ("Hp2", "sm90::Config<64, 4, 3, 2, 64>"),
           ("Hp2", "sm90::Config<64, 2, 3, 2, 64>"),
           ("Hp2", "sm90::Config<64, 2, 3, 2>"),
           ("Hp4", "sm90::Config<64, 4, 3, 4, 64>"),
           ("Hp4", "sm90::Config<64, 4, 2, 4, 64>"))
# The Hopper kernels whose ptxas lines --parent compares (chip_smoke's
# SM90_KERNELS, and the kernels that earlier trees had in their place).
PTXAS_KERNELS = ("attention_sm90", "attention_bwd_sm90", "q8g_sm90",
                 "key_norm_scan_kernel", "key_norm_partial_kernel",
                 "key_norm_fold_kernel", "key_norm_cummax_kernel",
                 "variant_attention_kernel")
# Kernels that a tree may have replaced (B3's WMMA kernel, K2r's one-CTA
# pre-pass): listed by tree, not compared.
REPLACED = ("variant_attention_kernel", "key_norm_cummax_kernel")
# --parent's outputs that B3's and K2r's pre-pass redesign may move.
EXPECTED_TO_DIFFER = ("B3", "B3 kv_valid 1025", "kcum", "K2r op")


def load_kernels(root: Path, tag: str):
    """``root``'s ``mjvideo_tpu_torch/kernels.py`` as a module of its own
    (it imports nothing else of its package), so that two trees' libraries
    load side by side; built and loaded."""
    path = root / "mjvideo_tpu_torch" / "kernels.py"
    spec = importlib.util.spec_from_file_location(f"_kernels_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._load()
    return mod


def entry_runs(lib, q, k, v, out) -> dict:
    """Name -> one call of a C entry of ``lib`` (B1's modes, B2's hp, B3)
    on q, k, v into ``out``; a CUDA error raises."""
    import torch

    from mjvideo_tpu_torch import kernels

    B, S_, H_, D_ = q.shape
    scale = D_ ** -0.5
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S_,
            H_, D_, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1))

    def call(fn, fold, last):
        def run():
            err = fn(*args, fold, last,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return run

    runs = {}
    for i, mode in enumerate(kernels.VARIANT_MODES):
        fold = scale * kernels.LOG2E if mode.startswith("exp2") else scale
        runs[f"B1 {mode}"] = call(lib.mjv_vit_attention_variant, fold, i)
    for hp in kernels.TMAJOR_HP:
        runs[f"B2 hp={hp}"] = call(lib.mjv_vit_attention_tmajor, scale, hp)
    runs["B3"] = call(lib.mjv_vit_attention_bshd, scale, S_)
    return runs


def padded_b3_run(lib, q, k, v, out, kv_valid):
    """One call of ``lib``'s B3 C entry on the (B, S, H, D) q, k, v with
    ``kv_valid`` keys, into ``out``."""
    import torch

    B, S_, H_, D_ = q.shape

    def run():
        err = lib.mjv_vit_attention_bshd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S_,
            H_, D_, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), D_ ** -0.5, kv_valid,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return run


def digest(t) -> str:
    import torch

    torch.cuda.synchronize()
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def main_path_digests(kern, dev, seed=0, keep=None) -> dict:
    """Digests of K1, K1 lse, K2, K2 lse, K2r, kcum, the K2r op, K3 and K3
    lse through the wrappers of ``kern`` (a tree's kernels module) on
    seeded inputs: the ViT's (8, 1025, 16, 64) qkv views and the judge's
    (2, 3072, 16/8, 128) with a ragged key mask.  ``keep`` (a dict), if
    given, receives the outputs named in EXPECTED_TO_DIFFER."""
    import torch

    from mjvideo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    out = {}
    B, T, H_, D_ = 8, 1025, 16, 64
    q, k, v = (t.view(B, T, H_, D_)
               for t in randn(B, T, 3 * H_ * D_).split(H_ * D_, dim=-1))
    kmax = kern.key_norm_max(k)
    out["K1"] = digest(kern.vit_attention(q, k, v, kmax, D_ ** -0.5))
    o, lse = kern.vit_attention(q, k, v, kmax, D_ ** -0.5, with_lse=True)
    out["K1 lse"] = digest(o) + digest(lse)
    out["K1 op"] = digest(kern.vit_attention_op(q, k, v, D_ ** -0.5))
    B, T = 2, 3072
    q, k, v = randn(B, T, 16, 128), randn(B, T, 8, 128), randn(B, T, 8, 128)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, T - 600:] = 0
    mask[1, :5] = 0
    scale = 128 ** -0.5
    kmax = kern.key_norm_max(k, mask)
    out["K2"] = digest(kern.decoder_attention(q, k, v, mask, kmax, None,
                                              scale))
    o, lse = kern.decoder_attention(q, k, v, mask, kmax, None, scale,
                                    with_lse=True)
    out["K2 lse"] = digest(o) + digest(lse)
    # K2r alone on the twin's kcum (the same in both trees), then the op's
    # form on each tree's own pre-pass.
    out["K2r"] = digest(kern.decoder_attention_rows(
        q, k, v, mask, fa.key_norm_cummax(k, mask), None, scale))
    kcum = kern.key_norm_cummax(k, mask)
    op = kern.decoder_attention_rows(q, k, v, mask, kcum, None, scale)
    out["kcum"], out["K2r op"] = digest(kcum), digest(op)
    if keep is not None:
        keep.update({"kcum": kcum, "K2r op": op})
    out["K3"] = digest(kern.exact_attention(q, k, v, mask, None, scale))
    o, lse = kern.exact_attention(q, k, v, mask, None, scale, with_lse=True)
    out["K3 lse"] = digest(o) + digest(lse)
    return out


def ptxas_lines(lib_path: Path) -> dict:
    """Name (the template arguments that this port's new defaults add taken
    out) -> registers, spill bytes and wgmma warnings, of the Hopper
    kernels in a build's ptxas report."""
    report = (lib_path.parent / "ptxas.txt").read_text().splitlines()
    out, name = {}, None

    def key(mangled):
        # Up to the end of the template arguments: the parameters' mangled
        # back-references shift with the new Variant argument.
        mangled = mangled.replace("ELi1ELi128EE", "EE")
        mangled = mangled.replace("ELNS0_7VariantE0E", "E")
        if "key_norm_partial_kernel" in mangled:  # the NORMS flag's default
            mangled = mangled.replace("ELb0EE", "EE")
        end = mangled.find("Ev")
        return mangled if end < 0 else mangled[:end + 2]

    for line in report:
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = key(m.group(1)) if any(
                k in m.group(1) for k in PTXAS_KERNELS) else None
            continue
        if name is None:
            continue
        row = out.setdefault(name, {"warnings": 0})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spills"] = tuple(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    for line in report:
        if "C7512" in line or "C7508" in line:
            m = re.search(r"function '(\S+)'", line)
            if m and key(m.group(1)) in out:
                out[key(m.group(1))]["warnings"] += 1
    return out


def parent_ab(parent: Path, tiles: int, rounds: int) -> dict:
    """The ``--parent`` readings (see the module's docstring)."""
    import torch

    from chip_smoke import (KERNEL_REL_TOL, _attention_work, _bound,
                            _in_turns, _rel_err, _sdpa, device_ms)
    from mjvideo_tpu_torch.ops import vit_attention_variants as va

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        trees = dict(zip("PC", pool.map(
            lambda a: load_kernels(*a), ((parent, "parent"), (REPO, "tree")))))
    dev = torch.device("cuda:0")
    out = {"ptxas": {}, "digests": {}, "errors": {}}
    ptx = {t: ptxas_lines(kern.build()) for t, kern in trees.items()}
    for name, row in ptx["P"].items():
        if not any(r in name for r in REPLACED):
            out["ptxas"][name] = {"P": row, "C": ptx["C"].get(name)}
    out["ptxas_changed"] = [n for n, r in out["ptxas"].items()
                            if r["C"] != r["P"]]
    # The kernels a tree replaced, and the new ones, by tree.
    out["ptxas_replaced"] = {f"{t} {n}": r for t in ptx for n, r in
                             ptx[t].items() if any(x in n for x in REPLACED)}
    out["ptxas_new"] = [n for n in ptx["C"] if n not in ptx["P"]]
    kept = {t: {} for t in trees}
    for t, kern in trees.items():
        out["digests"][t] = main_path_digests(kern, dev, keep=kept[t])
    q, k, v = make_inputs(tiles, dev)
    # The JAX harness's B3: the token axis pre-padded to 1032, k and v rows
    # zero past 1025 (kv_valid).
    qp, kp, vp = (torch.cat([t, torch.zeros_like(t[:, :7])], 1)
                  for t in (q, k, v))
    bufs = {t: torch.empty(q.shape, dtype=q.dtype, device=dev)
            for t in trees}
    pads = {t: torch.empty(qp.shape, dtype=q.dtype, device=dev)
            for t in trees}
    entries = {t: entry_runs(kern._lib, q, k, v, bufs[t])
               for t, kern in trees.items()}
    for t, kern in trees.items():
        entries[t]["B3 kv_valid 1025"] = padded_b3_run(kern._lib, qp, kp, vp,
                                                       pads[t], S)
    got = {t: {} for t in trees}
    for name in entries["C"]:
        padded = name == "B3 kv_valid 1025"
        for t in trees:
            entries[t][name]()
            got[t][name] = (pads if padded else bufs)[t].clone()
            want = (va.bshd_attention_plain(qp, kp, vp, S).view(qp.shape)
                    if padded else twin(name, q, k, v))
            out["errors"][f"{t} {name}"] = _rel_err(got[t][name], want)[1]
            out["digests"][t][name] = digest(got[t][name])
        if out["errors"][f"C {name}"] > KERNEL_REL_TOL:
            raise RuntimeError(f"{name}: beyond its bound "
                               f"{out['errors'][f'C {name}']:.3e}")
    # B3 is B2's hp 1 over its live keys, to the bit.
    c = got["C"]
    out["b3_is_b2_hp1"] = {
        "B3": bool(torch.equal(c["B3"], c["B2 hp=1"])),
        "B3 kv_valid 1025": bool(torch.equal(
            c["B3 kv_valid 1025"][:, :S], c["B2 hp=1"]))}
    for t in trees:
        kept[t].update({n: got[t][n] for n in EXPECTED_TO_DIFFER
                        if n in got[t]})
    out["max_abs_delta"] = {
        n: (kept["C"][n].float() - kept["P"][n].float()).abs().max().item()
        for n in EXPECTED_TO_DIFFER}
    runs = {"SDPA": _sdpa(q, k, v, causal=False)}
    order = ["SDPA"]
    for name in entries["C"]:
        runs[f"P {name}"], runs[f"C {name}"] = (entries["P"][name],
                                                entries["C"][name])
        order += [f"P {name}", f"C {name}", f"C {name}", f"P {name}"]
    out["ms"] = _in_turns(runs, order, rounds)
    out["device_ms"] = {n: sum(device_ms(fn).values()) or None
                        for n, fn in runs.items()}
    out["bound"] = _bound(*_attention_work(q, k, v, None, causal=False))
    out["bound_kv_valid_1025"] = _bound(*_attention_work(
        qp, k, v, None, causal=False))
    out["differ"] = [n for n, d in out["digests"]["C"].items()
                     if out["digests"]["P"].get(n) != d]
    out["unexpected_differ"] = [n for n in out["differ"]
                                if n not in EXPECTED_TO_DIFFER]
    return out


def build_config(alias: str, config: str) -> Path:
    """``csrc/vit_attention_variants.cu`` built alone from a copy of
    ``csrc/`` whose ``using <alias> = ...;`` is ``config``."""
    from mjvideo_tpu_torch import kernels

    tag = re.sub(r"\W+", "_", f"{alias}_{config}").strip("_")
    src = REPO / "build" / "variant_configs" / tag
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    path = src / "vit_attention_variants.cu"
    text, n = re.subn(rf"^using {alias} = .*;$", f"using {alias} = {config};",
                      path.read_text(), flags=re.M)
    if n != 1:
        raise RuntimeError(f"using {alias} not found once in {path}")
    path.write_text(text)
    lib = src / "libvariants.so"
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                          "-o", str(lib), str(path)], capture_output=True,
                         text=True)
    (src / "ptxas.txt").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {tag}:\n{res.stderr[-4000:]}")
    return lib


def config_ab(tiles: int, rounds: int) -> dict:
    """The ``--configs`` readings: each alias's candidates held and timed
    in turns."""
    import torch

    from chip_smoke import KERNEL_REL_TOL, _in_turns, _rel_err, _sdpa
    from mjvideo_tpu_torch import kernels

    with concurrent.futures.ThreadPoolExecutor(len(CONFIGS)) as pool:
        paths = list(pool.map(lambda c: build_config(*c), CONFIGS))
    dev = torch.device("cuda:0")
    q, k, v = make_inputs(tiles, dev)
    buf = torch.empty(q.shape, dtype=q.dtype, device=dev)
    out = {}
    for alias in dict(CONFIGS):
        runs = {"SDPA": _sdpa(q, k, v, causal=False)}
        names = ([f"B1 {m}" for m in kernels.VARIANT_MODES]
                 if alias == "VariantConfig" else [f"B2 hp={alias[2:]}"])
        if alias == "Hp1":  # B3 walks B2's hp 1 Config
            names.append("B3")
        for (cal, config), path in zip(CONFIGS, paths):
            if cal != alias:
                continue
            lib = ctypes.CDLL(str(path))
            for entry in ("mjv_vit_attention_variant",
                          "mjv_vit_attention_tmajor",
                          "mjv_vit_attention_bshd"):
                getattr(lib, entry).argtypes = kernels.ARGTYPES[entry]
                getattr(lib, entry).restype = ctypes.c_int
            report = (path.parent / "ptxas.txt").read_text()
            regs = re.findall(r"Used (\d+) registers", report)
            spills = re.findall(r"(\d+) bytes spill stores", report)
            print(f"config {alias} = {config}: ptxas registers {regs}, "
                  f"spill stores {spills}")
            calls = entry_runs(lib, q, k, v, buf)
            for name in names:
                calls[name]()
                rel = _rel_err(buf, twin(name, q, k, v))[1]
                print(f"  {name} {config}: {rel:.3e} of max|plain|")
                if rel > KERNEL_REL_TOL:
                    raise RuntimeError(f"{name} {config}: beyond its bound")
                runs[f"{name} {config}"] = calls[name]
        order = list(runs) + list(runs)[::-1]
        out[alias] = _in_turns(runs, order, rounds)
        print(f"{alias}, ms of one C call in turns (median of "
              f"{2 * rounds}): " + "; ".join(
                  f"{n} {t:.4f}" for n, t in out[alias].items()))
    return out


def report_parent(got: dict, rounds: int) -> None:
    """Print the ``--parent`` readings."""
    for name, row in got["ptxas"].items():
        print(f"ptxas {name[:90]}: parent {row['P']}, this tree {row['C']}")
    for name, row in got["ptxas_replaced"].items():
        print(f"ptxas (replaced) {name[:110]}: {row}")
    print(f"ptxas lines changed: {got['ptxas_changed']}; kernels new in "
          f"this tree: {got['ptxas_new']}")
    for tree in "PC":
        print(f"digests {tree}: {got['digests'][tree]}")
    print(f"outputs that differ between the trees: {got['differ']}; "
          f"beyond EXPECTED_TO_DIFFER: {got['unexpected_differ']}")
    print("max|this tree - parent| of the outputs expected to differ: "
          + ", ".join(f"{n} {d:.3e}" for n, d in got["max_abs_delta"].items()))
    print(f"B3 bit-equal to B2 hp=1 on its live keys: {got['b3_is_b2_hp1']}")
    b = got["bound"]
    print(f"ms of one C call in turns P C C P (median of {2 * rounds}); "
          f"device ms a launch; bound {b['bound_ms']:.4f} ms by "
          f"{b['bound_by']} (B3 kv_valid 1025: "
          f"{got['bound_kv_valid_1025']['bound_ms']:.4f} ms):")
    for name, ms in got["ms"].items():
        dev = got["device_ms"][name]
        err = got["errors"].get(name)
        print(f"  {name:16s} {ms:.4f} ms, device "
              + ("not measured" if dev is None else f"{dev:.4f} ms")
              + ("" if err is None else f", {err:.3e} of max|plain|"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=8)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--windows", type=int, default=7)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--configs", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("vit_attn_variants_torch: CUDA is not available",
              file=sys.stderr)
        return 1
    smi = card()
    print(f"card: {smi}")
    if args.parent is not None or args.configs:
        if args.parent is not None:
            got = parent_ab(args.parent.resolve(), args.tiles, args.rounds)
            report_parent(got, args.rounds)
        else:
            got = config_ab(args.tiles, args.rounds)
        line = json.dumps({"card": smi, **{str(k): v for k, v in
                                           got.items()}})
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(line + "\n")
        print(smi)
        print(line)
        return 0
    dev = torch.device("cuda:0")
    q, k, v = make_inputs(args.tiles, dev)
    n = flops(q)
    print(f"shape B{args.tiles} S{S} H{H} D{D} bf16 | {n / 1e9:.2f} GFLOP "
          f"per call | {args.launches} launches x {args.windows} windows")
    runs = kernel_runs(q, k, v)
    times = time_in_turns(runs, args.launches, args.windows)
    errs = errors(runs, q, k, v)
    k1 = statistics.median(times["K1"])
    for name, ts in times.items():
        ms = statistics.median(ts)
        print(f"{name:12s} {ms:8.4f} ms [{min(ts):.4f}, {max(ts):.4f}] "
              f"{n / ms / 1e9:7.1f} TF/s  {ms / k1:5.2f}x K1  max|- K1| "
              f"{errs[name][0]:.3e}  max|- twin| {errs[name][1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
