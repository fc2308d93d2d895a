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
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=8)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--windows", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("vit_attn_variants_torch: CUDA is not available",
              file=sys.stderr)
        return 1
    print(f"card: {card()}")
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
