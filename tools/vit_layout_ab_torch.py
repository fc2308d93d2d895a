"""One MJ-VIDEO-2B ViT block on a CUDA card with its attention swapped:
K1 (the production form), B3 at the JAX harness's pre-padded length and at
the tile's own, and B2 at its best hp.

    python3 tools/vit_layout_ab_torch.py [--tiles 8] [--chain 24]
        [--reps 5] [--hp N]

Counterpart of ``benchmarks/vit_layout_ab.py:195-257`` for the port.  The
block is the production ``models/vit.py`` ``_block`` with the attention
passed in, not a copy.  Weights: layer 0 of ``init_vit_params`` for
``mjvideo_2b_config().chat.vision`` (InternViT-300M: 1024 wide, 16 heads
of 64, MLP 4096) in bf16 from a generator seeded 0 on the card; input x of
(tiles, S, 1024) bf16, 0.02 * N(0, 1) from a generator seeded 1.  Each
variant runs one block as its warm-up (its output held against K1's),
then chains ``--chain`` blocks (x -> block(x)) under CUDA events
``--reps`` times, and prints the median ms per layer and the bound.  The
attention choices:

* ``K1 S=1025``: ``vit_attention`` (K1 with its key-norm bound), as the
  port's ViT runs it;
* ``B3 S=1032 kv_valid=1025``: the token axis pre-padded to a multiple of 8
  as the JAX ViT does, k and v rows past 1025 zeroed (two elementwise
  passes, as ``make_block_fn`` multiplies them by ``row_ok``) and B3 over
  the first 1025 keys;
* ``B3 S=1025``: B3 on the tile as it is;
* ``B2 hp=N S=1025``: B2 at ``--hp``, or else at the hp whose kernel alone
  is fastest on this block's q/k/v.

Then one ``torch.profiler`` pass over a chain of each variant splits the
block's device time between its attention kernel and the rest.  The
block's bound: 2 * B * S * (3 C^2 + C^2 + 2 C I) for the four products plus
4 * B * H * S^2 * D for the attention, 240.8 GFLOP at 8 tiles and S =
1025, 0.2435 ms at 989 TFLOP/s.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

S_TILE = 1025          # 32 x 32 patches of a 448 px tile and the class token
S_PADDED = 1032        # rounded up to a multiple of 8, as the JAX ViT pads
BF16_OPS_PER_S = 989e12


def layer0(cfg, device, seed: int = 0):
    """Layer 0 of the seeded bf16 ViT state."""
    import torch

    from mjvideo_tpu_torch.models.vit import init_vit_params
    from mjvideo_tpu_torch.utils.bridge import map_state

    state = init_vit_params(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        device=device, dtype=torch.bfloat16)
    return map_state(lambda a: a[0].clone(), state["layers"])


def block_flops(cfg, B: int, S: int) -> int:
    C, I = cfg.hidden_size, cfg.intermediate_size
    H, D = cfg.num_attention_heads, cfg.head_dim
    return 2 * B * S * (4 * C * C + 2 * C * I) + 4 * B * H * S * S * D


def best_hp(q, k, v, reps: int = 5) -> int:
    """The B2 hp whose kernel alone is fastest on q, k, v."""
    import torch

    from mjvideo_tpu_torch import kernels

    scale = q.shape[-1] ** -0.5
    ms = {}
    for hp in kernels.TMAJOR_HP:
        kernels.vit_attention_tmajor(q, k, v, hp, scale)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kernels.vit_attention_tmajor(q, k, v, hp, scale)
        end.record()
        end.synchronize()
        ms[hp] = start.elapsed_time(end) / reps
    return min(ms, key=ms.get)


def attentions(hp: int) -> dict:
    """Name -> (S, attention for ``_block``, None for its default K1)."""
    import torch

    from mjvideo_tpu_torch.ops import vit_attention_variants as va

    def b3_padded(q, k, v):
        ok = (torch.arange(q.shape[1], device=q.device) < S_TILE)
        ok = ok.to(q.dtype)[None, :, None, None]
        return va.bshd_attention(q, k * ok, v * ok, kv_valid=S_TILE)

    return {
        f"K1 S={S_TILE}": (S_TILE, None),
        f"B3 S={S_PADDED} kv_valid={S_TILE}": (S_PADDED, b3_padded),
        f"B3 S={S_TILE}": (S_TILE, lambda q, k, v: va.bshd_attention(q, k, v)),
        f"B2 hp={hp} S={S_TILE}": (
            S_TILE, lambda q, k, v: va.tmajor_attention(q, k, v, hp=hp)),
    }


def _chain(cfg, p, x, attention, n):
    from mjvideo_tpu_torch.models.vit import _block

    for _ in range(n):
        x = _block(cfg, p, x, "auto", attention=attention)
    return x


def _attention_share(prof) -> tuple:
    """(attention kernels' device us, every kernel's device us) of a
    profiler pass."""
    import torch

    att = total = 0.0
    for ev in prof.key_averages():
        t = ev.self_device_time_total
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            total += t
            if "attention_kernel" in ev.key:
                att += t
    return att, total


def run(tiles: int = 8, chain: int = 24, reps: int = 5, hp=None) -> dict:
    """Time the block with each attention on the first CUDA card; returns
    name -> {"S", "ms" (median per layer), "ms_all" (each rep's),
    "bound_ms", "finite" (the warm-up block's output), "max_abs_vs_first"
    (its first 1025 rows against the first variant's, K1's),
    "first_update_max" (max|K1's block(x) - x|), "attention_share",
    "attention_ms" and "rest_ms" (of the profiled block's device time)}.
    Each variant launches its attention 1 + reps * chain + 4 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mjvideo_tpu_torch.configs import mjvideo_2b_config

    cfg = mjvideo_2b_config().chat.vision
    dev = torch.device("cuda")
    p = layer0(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x_full = (torch.randn((tiles, S_PADDED, cfg.hidden_size), generator=g,
                          device=dev) * 0.02).to(torch.bfloat16)
    if hp is None:
        H, D = cfg.num_attention_heads, cfg.head_dim
        q, k, v = (torch.randn((tiles, S_TILE, H, D), generator=g,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        hp = best_hp(q, k, v)
        del q, k, v
    out, first = {}, None
    with torch.no_grad():
        for name, (S, attention) in attentions(hp).items():
            x = x_full[:, :S].contiguous()
            # One block as the warm-up; its first S_TILE rows against the
            # first variant's (K1's).
            y = _chain(cfg, p, x, attention, 1)[:, :S_TILE].float()
            if first is None:
                first = y
                update = (y - x[:, :S_TILE].float()).abs().max().item()
            err = (y - first).abs().max().item()
            finite = bool(torch.isfinite(y).all())
            del y
            ms = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _chain(cfg, p, x, attention, chain)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end) / chain)
            row = {"S": S, "ms": statistics.median(ms), "ms_all": ms,
                   "bound_ms": block_flops(cfg, tiles, S_TILE)
                   / BF16_OPS_PER_S * 1e3, "finite": finite,
                   "max_abs_vs_first": err, "first_update_max": update}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _chain(cfg, p, x, attention, 4)
                torch.cuda.synchronize()
            att, total = _attention_share(prof)
            row["attention_share"] = att / total
            row["attention_ms"] = att / 4e3
            row["rest_ms"] = (total - att) / 4e3
            out[name] = row
    return out


def report(rows: dict, tiles: int, chain: int) -> None:
    for name, r in rows.items():
        line = (f"{name:26s} {r['ms']:8.4f} ms/layer [{min(r['ms_all']):.4f}"
                f", {max(r['ms_all']):.4f}] ({tiles} tiles, chain {chain}; "
                f"bound {r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%})"
                f"; one block against K1's: max|delta| "
                f"{r['max_abs_vs_first']:.3e} (max|block(x) - x| "
                f"{r['first_update_max']:.3e}); profiler: attention "
                f"{r['attention_ms']:.4f} ms ({r['attention_share']:.1%}), "
                f"rest {r['rest_ms']:.4f} ms per layer")
        print(line, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=8)
    ap.add_argument("--chain", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--hp", type=int, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("vit_layout_ab_torch: CUDA is not available", file=sys.stderr)
        return 1
    from vit_attn_variants_torch import card

    print(f"card: {card()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = run(args.tiles, args.chain, args.reps, args.hp)
    report(rows, args.tiles, args.chain)
    return 0


if __name__ == "__main__":
    sys.exit(main())
