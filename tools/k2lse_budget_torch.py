"""F4's reading: K2 lse's exponent budget at training's decoder shapes, at
phase 5's stepped weights, for several checkouts' K2 lse on one card.

    python3 tools/train_fidelity_torch.py --root PARENT --make \\
        --state build/f4_state.pt
    python3 tools/k2lse_budget_torch.py --state build/f4_state.pt \\
        --root parent=PARENT --root other=OTHER [--rounds 10]

Loads the trainable tensors that ``train_fidelity_torch.py --make`` saved
after phase 5's micro-batches (two optimizer steps) into chip_smoke's
seed-0 stage-3 trainer, runs micro-batch 0's forward (phase 6's) through
this checkout's bf16 kernel path under ``torch.no_grad`` and keeps the
q, k, v and mask of every decoder attention call: 24 layers for each of
the pair's two prompts, (1, 759 | 799, 16/8, 128).  Then, for each call:

* from the inputs alone (fp32, the twin's arithmetic): the (row, head)
  pairs whose largest visible score lies more than 87.3 nats below the
  bound m = |scale| |q| kmax (where ``ex2.approx.ftz`` flushes every p of
  the row), the live keys whose p = exp(s scale - m) falls below 2^-126,
  the pairs whose sum l falls below 1e-30 (where the lse is floored), and
  the largest gap;
* for this checkout's K2 lse and each ``--root``'s (its
  ``csrc/decoder_attention.cu`` built alone into ``build/k2lse_budget/``,
  called through the same C entry on the same tensors) and the twin: the
  pairs it marks dead (lse = 1e30) against those the fp32 twin marks
  dead, max|out - twin| and max|lse - twin| on the pairs live in both,
  max|out - exact| against the exact fp32 softmax, and against an fp64
  softmax the output's relative L2 error, its mean signed error, the
  share of outputs that are not the fp64 value rounded once, and the
  lse's mean error.

Then times each K2 lse alone (its C entry, CUDA events around one launch)
in turns at the longer prompt's layer 0, and reads phase 6 (the trainable
gradient, bf16 against fp32 plain: relative L2 and cosine) at the
stepped weights with the bf16 side each way: this checkout's kernels;
the K2-lse twin in place of K2 lse; the K2-lse and K4a/K4b twins in place
of the three kernels (the twins compute in fp32 and round where the
kernels round); K2 lse's output with the twin's lse and the reverse; the
fp64 softmax rounded once to bf16 (the most accurate forward output
there is); and the bf16 plain path, no kernel.  Micro-batch 0 (phase
6's) takes every way, micro-batch 1 four of them.  The spread of those
readings is what the bf16 arithmetic alone gives at these weights.
Prints the card, a line per layer, the sums, and one JSON line.  Unpack
another commit with ``git archive`` into the git-ignored ``build/`` to
name it as a root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# ex2.approx.ftz flushes below 2^-126: 126 ln 2 nats.
FLUSH_NATS = 126 * 0.6931471805599453
LSE_FLOOR = 1e-30


def build_root(name: str, root: Path) -> Path:
    """nvcc of ROOT's decoder_attention.cu alone, with the port's flags."""
    from mjvideo_tpu_torch import kernels

    out = REPO / "build" / "k2lse_budget" / name
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libk2.so"
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(root / "mjvideo_tpu_torch" / "csrc" / "decoder_attention.cu")],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name}:\n{res.stderr[-4000:]}")
    return lib


def load_lib(path: Path):
    from mjvideo_tpu_torch import kernels

    lib = ctypes.CDLL(str(path))
    fn = lib.mjv_decoder_attention
    fn.argtypes = kernels.ARGTYPES["mjv_decoder_attention"]
    fn.restype = ctypes.c_int
    return fn


def k2_lse(fn, q, k, v, mask, kmax, scale):
    """One K2-lse launch through a library's C entry: (out, lse)."""
    import torch

    B, Q, Hq, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Q), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             kmax.data_ptr(), None, out.data_ptr(), lse.data_ptr(), B, Q, K,
             Hq, Hkv, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), float(scale),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mjv_decoder_attention: CUDA error {err}")
    return out, lse


def stepped_trainer(state: Path, dev):
    """chip_smoke's seed-0 stage-3 trainer with the saved trainable tensors
    (phase 5's stepped weights), and its micro-batches."""
    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch.train.trainer import flatten_state

    with tempfile.TemporaryDirectory() as ckpt:
        trainer, batches = cs.make_trainer(
            torch.Generator(device=dev).manual_seed(cs.SEED), dev, ckpt,
            cs.train_data())
    flat = flatten_state(trainer.params)
    saved = torch.load(state)
    with torch.no_grad():
        for p in trainer.optimizer.paths:
            flat[p].copy_(saved[p].to(dev))
    return trainer, batches


def capture_calls(trainer, batch):
    """The q, k, v, mask and scale of every decoder attention call of
    ``batch``'s forward through the bf16 kernel path, under no_grad."""
    import torch

    from mjvideo_tpu_torch.ops import flash_attention as fa
    from mjvideo_tpu_torch.train.trainer import make_loss_fn, place_batch

    calls = []
    inner = fa._decoder_attention_fwd

    def keep(q, k, v, attention_mask, q_offset, scale, with_lse):
        mask = (torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
                if attention_mask is None else attention_mask.to(torch.int32))
        calls.append(tuple(t.contiguous() for t in (q, k, v, mask))
                     + (scale,))
        return inner(q, k, v, attention_mask, q_offset, scale, with_lse)

    fa._decoder_attention_fwd = keep
    try:
        with torch.no_grad():
            make_loss_fn(trainer.cfg, trainer.tc)(
                trainer.params,
                place_batch(batch, trainer.device, torch.bfloat16))
    finally:
        fa._decoder_attention_fwd = inner
    return calls


def _grads(trainer, batch, impl, dtype):
    """Phase 6's loss and trainable gradient of ``batch`` through ``impl``
    at ``dtype`` (chip_smoke.gradient_fidelity's arithmetic)."""
    from dataclasses import replace

    import torch

    from mjvideo_tpu_torch import map_state
    from mjvideo_tpu_torch.train.trainer import (
        flatten_state,
        make_loss_fn,
        place_batch,
        set_trainable,
    )

    paths = trainer.optimizer.paths
    params = (trainer.params if dtype == torch.bfloat16 else
              map_state(lambda t: t.detach().float(), trainer.params))
    set_trainable(params, set(paths))
    flat = flatten_state(params)
    loss = make_loss_fn(trainer.cfg, replace(trainer.tc, attn_impl=impl))(
        params, place_batch(batch, trainer.device, dtype))
    return loss.item(), torch.autograd.grad(loss, [flat[p] for p in paths])


def phase6_spread(trainer, batch, names=None):
    """Phase 6 at the trainer's weights with the bf16 side each way of
    ``names`` (all by default): {name: (relative L2, cosine, loss)}."""
    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch.ops import flash_attention as fa

    _, ref = _grads(trainer, batch, "plain", torch.float32)
    fwd, bwd = fa._decoder_attention_fwd, fa.decoder_attention_backward

    def twin_fwd(q, k, v, attention_mask, q_offset, scale, with_lse):
        return fa.decoder_attention_plain(q, k, v, attention_mask, q_offset,
                                          scale, return_lse=with_lse)

    def fp64_fwd(q, k, v, attention_mask, q_offset, scale, with_lse):
        # The softmax in fp64, rounded once to bf16: the most accurate
        # output a bf16 forward can give.
        mask = (torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
                if attention_mask is None else attention_mask)
        o, lse = exact64(q, k, v, mask, scale)
        o = o.to(q.dtype)
        return (o, lse.float().contiguous()) if with_lse else o

    def twin_bwd(q, k, v, attention_mask, q_offset, out, lse, dout,
                 scale=None, causal=True):
        return fa.decoder_attention_backward_plain(
            q, k, v, attention_mask, q_offset, out, lse, dout, scale, causal)

    def mixed(out_of, lse_of):
        # The output of one form with the lse of the other.
        def fwd_(q, k, v, attention_mask, q_offset, scale, with_lse):
            a = fwd(q, k, v, attention_mask, q_offset, scale, with_lse)
            b = twin_fwd(q, k, v, attention_mask, q_offset, scale, with_lse)
            if not with_lse:
                return a if out_of == "kernel" else b
            return ((a if out_of == "kernel" else b)[0],
                    (a if lse_of == "kernel" else b)[1])
        return fwd_

    out = {}
    for name, impl, swap in (
            ("kernels", "auto", {}),
            ("K2 lse twin", "auto", {"fwd": twin_fwd}),
            ("K2 lse and K4 twins", "auto", {"fwd": twin_fwd,
                                             "bwd": twin_bwd}),
            ("K2 lse's output, the twin's lse", "auto",
             {"fwd": mixed("kernel", "twin")}),
            ("the twin's output, K2 lse's lse", "auto",
             {"fwd": mixed("twin", "kernel")}),
            ("the fp64 softmax rounded to bf16", "auto", {"fwd": fp64_fwd}),
            ("bf16 plain", "plain", {})):
        if names is not None and name not in names:
            continue
        if "fwd" in swap:
            fa._decoder_attention_fwd = swap["fwd"]
        if "bwd" in swap:
            fa.decoder_attention_backward = swap["bwd"]
        try:
            loss, got = _grads(trainer, batch, impl, torch.bfloat16)
        finally:
            fa._decoder_attention_fwd, fa.decoder_attention_backward = fwd, bwd
        rel, cos, _ = cs._agreement(got, ref)
        out[name] = (rel, cos, loss)
        print(f"phase 6 at the stepped weights, bf16 side {name}: relative "
              f"L2 {rel:.4e}, cosine {cos:.6f}, loss {loss:.6f}")
        del got
    return out


def budget_counts(q, k, v, mask, scale):
    """The input-side counts of one call (the twin's fp32 arithmetic)."""
    import torch

    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, Q, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Q, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qn = qf.square().sum(-1).sqrt().permute(0, 2, 3, 1)
    kmax = fa.key_norm_max(k, mask)
    m = (qn * (kmax * abs(scale))[:, :, None, None])[..., None]
    allowed = fa._decoder_allowed(q, k, mask, None)[:, None, None]
    x = torch.where(allowed, s - m, -torch.inf)
    top = x.amax(-1)  # (B, Hkv, G, Q): the largest visible score - m
    live = top > -torch.inf
    l = torch.where(allowed, torch.exp(x), 0.0).sum(-1)
    return {
        "pairs": int(live.sum()),
        "gap_over_87": int((live & (top < -FLUSH_NATS)).sum()),
        "flushed_keys": int((allowed & (x < -FLUSH_NATS)).sum()),
        "l_below_1e-30": int((live & (l < LSE_FLOOR)).sum()),
        "max_gap": float(-top[live].min()),
        "median_gap": float(-top[live].median()),
    }


def exact64(q, k, v, mask, scale):
    """The softmax attention in fp64, unrounded: (out, lse)."""
    import torch

    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, Q, Hq, D = q.shape
    Hkv = k.shape[2]
    qd = q.double().reshape(B, Q, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qd, k.double()) * scale
    s = torch.where(fa._decoder_allowed(q, k, mask, None)[:, None, None], s,
                    -torch.inf)
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", torch.exp(s - lse[..., None]),
                     v.double())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Q, Hq, D), lse.reshape(
        B, Hq, Q)


def compare(out, lse, ref, ref_lse, exact, ref64=None):
    dead = lse >= 5e29
    ref_dead = ref_lse >= 5e29
    both = ~dead & ~ref_dead
    r = {
        "dead": int(dead.sum()),
        "dead_twin": int(ref_dead.sum()),
        "out_err": float((out.float() - ref.float()).abs().max()),
        "lse_err": (float((lse - ref_lse)[both].abs().max())
                    if both.any() else 0.0),
        "out_err_exact": float((out.float() - exact.float()).abs().max()),
    }
    if ref64 is not None:
        # Against fp64: the relative L2 error of the output, its bias
        # (the mean error along the sign of the fp64 output, over the mean
        # magnitude) and the lse's mean and largest error in nats.
        o64, l64 = ref64
        d = out.double() - o64
        r["out_rel_l2_64"] = float(d.norm() / o64.norm())
        r["out_bias_64"] = float((d * o64.sign()).mean() / o64.abs().mean())
        r["lse_bias_64"] = float((lse.double() - l64).mean())
        # The share of outputs that are not the fp64 value rounded once.
        r["misrounded_64"] = float((out != o64.to(out.dtype)).float().mean())
        r["lse_err_64"] = float((lse.double() - l64).abs().max())
    return r


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", type=Path, required=True)
    ap.add_argument("--root", action="append", default=[],
                    help="NAME=CHECKOUT, another checkout's K2 lse")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = {"this": load_lib(kernels.build())}
    for spec in args.root:
        name, root = spec.split("=", 1)
        libs[name] = load_lib(build_root(name, Path(root).resolve()))

    trainer, batches = stepped_trainer(args.state, dev)
    calls = capture_calls(trainer, batches[0])
    print("phase 6, micro-batch 0 (phase 6's):")
    spread = {"batch 0": phase6_spread(trainer, batches[0])}
    # A second micro-batch: does the spread keep its order?
    print("phase 6, micro-batch 1:")
    spread["batch 1"] = phase6_spread(
        trainer, batches[1], ("kernels", "K2 lse twin",
                              "the fp64 softmax rounded to bf16",
                              "bf16 plain"))
    del trainer, batches
    print(f"card: {smi}; {len(calls)} decoder attention calls at "
          f"{sorted({tuple(c[0].shape) for c in calls})}")
    n_layers = len(calls) // 2
    rows, totals = [], {}
    for i, (q, k, v, mask, scale) in enumerate(calls):
        counts = budget_counts(q, k, v, mask, scale)
        ref, ref_lse = fa.decoder_attention_plain(q, k, v, mask,
                                                  return_lse=True)
        exact = fa.exact_attention_plain(q, k, v, mask)
        ref64 = exact64(q, k, v, mask, scale)
        kmax = kernels.key_norm_max(k, mask)
        row = {"video": i // n_layers, "layer": i % n_layers,
               "T": q.shape[1], **counts,
               "twin": compare(ref, ref_lse, ref, ref_lse, exact, ref64)}
        for name, fn in libs.items():
            row[name] = compare(*k2_lse(fn, q, k, v, mask, kmax, scale), ref,
                                ref_lse, exact, ref64)
        torch.cuda.synchronize()
        rows.append(row)
        for key in ("gap_over_87", "flushed_keys", "l_below_1e-30", "pairs"):
            totals[key] = totals.get(key, 0) + row[key]
        for name in ("twin", *libs):
            for key in ("out_rel_l2_64", "out_bias_64", "lse_bias_64",
                        "misrounded_64"):
                totals[f"{name} {key}"] = (totals.get(f"{name} {key}", 0.0)
                                           + row[name][key] / len(calls))
            totals[f"{name} lse_err_64"] = max(
                totals.get(f"{name} lse_err_64", 0.0), row[name]["lse_err_64"])
        for name in libs:
            for key in ("dead", "dead_twin"):
                totals[f"{name} {key}"] = (totals.get(f"{name} {key}", 0)
                                           + row[name][key])
            for key in ("out_err", "lse_err", "out_err_exact"):
                totals[f"{name} {key}"] = max(totals.get(f"{name} {key}", 0.0),
                                              row[name][key])
        print(f"video {row['video']} layer {row['layer']:2d} T {row['T']}: "
              f"gap > 87.3 nats {row['gap_over_87']}, flushed keys "
              f"{row['flushed_keys']}, l < 1e-30 {row['l_below_1e-30']}, "
              f"max gap {row['max_gap']:.2f} (median "
              f"{row['median_gap']:.2f}); "
              + "; ".join(f"{n} dead {row[n]['dead']} (twin "
                          f"{row[n]['dead_twin']}), out "
                          f"{row[n]['out_err']:.3e}"
                          f", lse {row[n]['lse_err']:.3e}, out-exact "
                          f"{row[n]['out_err_exact']:.3e}, against fp64: "
                          f"out rel L2 {row[n]['out_rel_l2_64']:.3e} bias "
                          f"{row[n]['out_bias_64']:.2e}, misrounded "
                          f"{row[n]['misrounded_64']:.2e}, lse bias "
                          f"{row[n]['lse_bias_64']:.2e}" for n in
                          ("twin", *libs)))

    # The longer prompt's layer 0, each K2 lse alone in turns.
    q, k, v, mask, scale = max(calls[::n_layers], key=lambda c: c[0].shape[1])
    kmax = kernels.key_norm_max(k, mask)
    runs = {n: (lambda fn=fn: k2_lse(fn, q, k, v, mask, kmax, scale))
            for n, fn in libs.items()}
    med = cs._in_turns(runs, list(runs) + list(runs)[::-1], args.rounds)
    print(f"K2 lse alone at {tuple(q.shape)}, in turns (median of "
          f"{2 * args.rounds}): "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in med.items()))
    print("totals: " + json.dumps(totals))
    print(smi)
    print(json.dumps({"card": smi, "totals": totals, "ms": med,
                      "phase6": spread, "layers": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
