"""Sequence parallelism with one shard per process, against the
one-process form on the same inputs.

    python3 tools/sp_multicard.py               # NCCL, one process per card
    python3 tools/sp_multicard.py --cpu         # gloo, 4 CPU processes, at
                                                # tiny_test_config (rehearsal)

Each of n processes (n = the cards it sees, or ``--procs`` with ``--cpu``)
joins a process group on a free localhost port and holds one shard
(``SequenceGroup.distributed()``); rank 0 also runs ``SequenceGroup.local(n)``
on its own card on the same inputs.  Four checks, each printed by rank 0:

1. Ring and all-gather attention at ``chip_smoke.SP_T`` tokens (B = 1, 16/8
   heads of 128, bf16, the first 5 and the last 600 keys masked), forward
   and backward: the gathered output and dq, dk, dv against ``local(n)``,
   which runs the same kernels at the same offsets in the same order, so
   they must be bit-identical, except the all-gather's dk and dv: there
   each card's bf16 partial over the whole sequence is summed by
   ``all_reduce`` in its own order, against autograd's order on one card,
   so they are held to 2**-7 of max|local| (``chip_smoke.KERNEL_REL_TOL``);
   the median of 10 forwards of each by CUDA events, across the cards and
   on one.
2. ``chip_smoke.py``'s 2B scorer (random bf16 weights from its seed) on its
   pair request with ``sp="ring"``: the scores against ``local(n)``, within
   ``chip_smoke.SCORE_TOL`` (the position-wise products run on n times
   fewer rows per card, so cuBLAS may round them differently); the median
   of 5 pair requests.
3. ``chip_smoke.py``'s long-context clip (16 frames x 13 tiles) with the
   ring: the score against ``local(n)``, ms for one call and each card's
   peak memory.
4. One stage-3 micro-batch (``chip_smoke.py``'s first training batch, its
   prompts padded to whole 64-row tiles of every shard) through
   ``Trainer(sp="ring")`` at accumulation 2, whose buffer then holds the
   gradient, with the backbone's gradients summed over the processes:
   against ``local(n)`` by relative L2 and cosine, held to
   ``chip_smoke.FIDELITY_REL_L2`` and ``FIDELITY_COS``; ms and each card's
   peak memory.

The last line is one JSON object of the readings; the exit code is non-zero
if a process fails or a check breaks its bound.
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gather(t, dim=1):
    """Every rank's ``t`` concatenated along ``dim`` (all ranks call)."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim)


def _events_ms(fn, reps, barrier=True):
    """Median ms of ``fn`` by CUDA events; ``barrier``: all ranks start each
    run together (every rank must then call this)."""
    import torch
    import torch.distributed as dist

    times = []
    for _ in range(reps):
        if barrier:
            dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, reps, sync, barrier=True):
    """Median ms of ``fn`` on the host clock after ``sync``; ``barrier`` as
    for ``_events_ms``."""
    import torch.distributed as dist

    times = []
    for _ in range(reps):
        if barrier:
            dist.barrier()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def attention_check(group, local, dev, cpu, out):
    """Check 1 (at a tiny shape on the CPU)."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from mjvideo_tpu_torch.parallel.sequence import (
        ring_flash_attention,
        shard_sequence,
        sp_flash_attention,
    )

    T, Hq, Hkv, D = (256, 4, 2, 16) if cpu else (cs.SP_T, 16, 8, 128)
    dtype = torch.float32 if cpu else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    q, k, v, dout = (torch.randn(s, generator=g, device=dev).to(dtype)
                     for s in ((1, T, Hq, D), (1, T, Hkv, D), (1, T, Hkv, D),
                               (1, T, Hq, D)))
    mask = torch.ones((1, T), dtype=torch.int32, device=dev)
    mask[:, :5] = 0
    mask[:, T - T // 5:] = 0
    rank = dist.get_rank()
    for kind, fn in (("ring", ring_flash_attention),
                     ("allgather", sp_flash_attention)):
        leaves = [shard_sequence(t, group).requires_grad_() for t in (q, k, v)]
        held_mask = shard_sequence(mask, group)
        res = fn(*leaves, group, attention_mask=held_mask)
        got = [_gather(t) for t in
               (res, *torch.autograd.grad(res, leaves,
                                          shard_sequence(dout, group)))]
        with torch.no_grad():
            held = [t.detach() for t in leaves]
            dist_ms = (None if cpu else _events_ms(
                lambda: fn(*held, group, attention_mask=held_mask), 10))
        if rank != 0:
            continue
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fn(*ref_leaves, local, attention_mask=mask)
        want = [ref, *torch.autograd.grad(ref, ref_leaves, dout)]
        diffs = {name: (a.float() - b.float()).abs().max().item() for name, a, b
                 in zip(("out", "dq", "dk", "dv"), got, want)}
        summed = ("dk", "dv") if kind == "allgather" else ()
        bounds = {name: cs.KERNEL_REL_TOL * b.float().abs().max().item()
                  if name in summed else 0.0
                  for name, b in zip(("out", "dq", "dk", "dv"), want)}
        with torch.no_grad():
            local_ms = (None if cpu else _events_ms(
                lambda: fn(q, k, v, local, attention_mask=mask), 10,
                barrier=False))
        out[f"attention_{kind}"] = {"max_abs_diff": diffs, "ms": dist_ms,
                                    "local_ms": local_ms}
        print(f"{kind} attention (1, {T}, {Hq}/{Hkv}, {D}) over "
              f"{group.size} processes against local({group.size}): max "
              f"|diff| {diffs} (bounds {bounds}); forward {dist_ms} ms "
              f"across, {local_ms} ms on one (median of 10)")
        out["ok"] = out["ok"] and all(diffs[n] <= bounds[n] for n in diffs)


def scorer_checks(group, local, dev, cpu, out):
    """Checks 2 and 3."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from mjvideo_tpu_torch import (
        ByteTokenizer,
        RewardScorer,
        init_reward_params,
        tiny_test_config,
    )

    rank = dist.get_rank()
    if cpu:
        cfg = tiny_test_config()
        state = init_reward_params(cfg, generator=torch.Generator()
                                   .manual_seed(cs.SEED), device=dev,
                                   dtype=torch.float32)
        tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
        base = RewardScorer(cfg, state, tok, dtype=torch.float32,
                            gating_pattern=tok.gating_pattern())
        sync = lambda: None  # noqa: E731
    else:
        base = cs.make_scorer(torch.Generator(device=dev).manual_seed(cs.SEED),
                              dev)
        sync = torch.cuda.synchronize

    def scorer(sp_group, buckets):
        return RewardScorer(base.cfg, base.params, base.tokenizer,
                            dtype=base.dtype, length_buckets=buckets,
                            gating_pattern=base.gating_pattern, sp="ring",
                            sp_group=sp_group)

    pair = cs.make_requests(base, np.random.default_rng(cs.SEED))[1]
    long_req, bucket = cs.long_request(base, dev)
    for label, request, buckets in (("pair", pair, base.buckets),
                                    ("long", long_req, (bucket,))):
        across = scorer(group, buckets)
        if not cpu:
            torch.cuda.reset_peak_memory_stats(dev)
        scores = across.score_batch(*request).score.float().cpu()
        reps = 5 if label == "pair" else 1
        ms = _host_ms(lambda: across.score_batch(*request), reps, sync)
        peak = 0 if cpu else torch.cuda.max_memory_allocated(dev) / 2**30
        peaks = [None] * group.size
        dist.all_gather_object(peaks, peak)
        del across
        if rank != 0:
            continue
        one = scorer(local, buckets)
        if not cpu:
            torch.cuda.reset_peak_memory_stats(dev)
        ref = one.score_batch(*request).score.float().cpu()
        local_ms = _host_ms(lambda: one.score_batch(*request), reps, sync,
                            barrier=False)
        local_peak = (0 if cpu else
                      torch.cuda.max_memory_allocated(dev) / 2**30)
        del one
        delta = (scores - ref).abs().max().item()
        out[label] = {"scores": scores.tolist(), "local_scores": ref.tolist(),
                      "delta": delta, "ms": ms, "local_ms": local_ms,
                      "peak_gib": peaks, "local_peak_gib": local_peak}
        print(f"{label}: ring over {group.size} processes scores "
              f"{scores.tolist()}, local({group.size}) {ref.tolist()} "
              f"(|delta| {delta:.3e}, bound {cs.SCORE_TOL:.0e}); {ms:.1f} ms "
              f"across (median of {reps}), {local_ms:.1f} ms on one; peak "
              f"memory per process {[round(p, 2) for p in peaks]} GiB, "
              f"{local_peak:.2f} GiB on one")
        out["ok"] = out["ok"] and delta < cs.SCORE_TOL


def training_check(group, local, dev, cpu, out):
    """Check 4."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from mjvideo_tpu_torch import ByteTokenizer, init_reward_params
    from mjvideo_tpu_torch.data.prompts import rebase_img_context_id
    from mjvideo_tpu_torch.train.trainer import TrainConfig, Trainer

    if cpu:
        from mjvideo_tpu_torch import tiny_test_config

        cfg = tiny_test_config()
        tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
        cfg = rebase_img_context_id(cfg, tok)
        batches = cs.make_train_batches(cfg, tok, np.random.default_rng(
            cs.SEED), 1)
    else:
        cfg, batches = cs.train_data()
    batch = cs._pad_batch(batches[0], group.size * 64,
                          cfg.chat.llm.pad_token_id)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = init_reward_params(cfg, generator=gen, device=dev,
                                dtype=torch.float32 if cpu
                                else torch.bfloat16)
    sync = (lambda: None) if cpu else torch.cuda.synchronize  # noqa: E731

    def micro_step(sp_group, ckpt):
        tc = TrainConfig(stage=3, learning_rate=1e-3,
                         gradient_accumulation_steps=2, remat=True,
                         log_every=1, checkpoint_every=10**9,
                         checkpoint_dir=ckpt, sp="ring")
        trainer = Trainer(cfg, params, tc, sp_group=sp_group)
        if not cpu:
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        trainer.train([batch])
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        peak = 0 if cpu else torch.cuda.max_memory_allocated(dev) / 2**30
        acc = trainer.opt_state["acc"]
        return [acc[p] for p in trainer.optimizer.paths], ms, peak

    with tempfile.TemporaryDirectory() as ckpt:
        grads, ms, peak = micro_step(group, ckpt)
        peaks = [None] * group.size
        dist.all_gather_object(peaks, peak)
        if dist.get_rank() == 0:
            ref, local_ms, local_peak = micro_step(local, ckpt)
            rel, cos, _ = cs._agreement(grads, ref)
            out["training"] = {"rel_l2": rel, "cos": cos, "ms": ms,
                               "local_ms": local_ms, "peak_gib": peaks,
                               "local_peak_gib": local_peak}
            print(f"training: one stage-3 micro-batch with the ring over "
                  f"{group.size} processes against local({group.size}): "
                  f"gradient relative L2 {rel:.4e} (bound "
                  f"{cs.FIDELITY_REL_L2}), cosine {cos:.6f} (bound "
                  f"{cs.FIDELITY_COS}); {ms:.1f} ms across, {local_ms:.1f} "
                  f"ms on one (the first micro-step each); peak memory per "
                  f"process {[round(p, 2) for p in peaks]} GiB, "
                  f"{local_peak:.2f} GiB on one")
            out["ok"] = (out["ok"] and rel <= cs.FIDELITY_REL_L2
                         and cos >= cs.FIDELITY_COS)
            del ref
    del grads, params
    if not cpu:
        torch.cuda.empty_cache()


def worker(rank: int, world: int, port: int, cpu: bool) -> int:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mjvideo_tpu_torch.parallel.sequence import SequenceGroup

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if not cpu:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    out = {"ok": True, "processes": world,
           "backend": dist.get_backend()}
    try:
        group, local = SequenceGroup.distributed(), SequenceGroup.local(world)
        attention_check(group, local, dev, cpu, out)
        training_check(group, local, dev, cpu, out)
        scorer_checks(group, local, dev, cpu, out)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out))
    return 0 if out["ok"] else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.worker, args.world, args.port, args.cpu)

    import torch

    if args.cpu:
        world = args.procs
    else:
        if not torch.cuda.is_available():
            print("sp_multicard: CUDA is not available", file=sys.stderr)
            return 1
        from mjvideo_tpu_torch import kernels

        world = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        print(f"cards: {smi}")
        kernels.build()  # once, before the processes load it
    port = _free_port()
    cmd = [sys.executable, __file__, "--world", str(world), "--port",
           str(port)] + (["--cpu"] if args.cpu else [])
    procs = [subprocess.Popen(cmd + ["--worker", str(r)],
                              stdout=subprocess.PIPE if r else None,
                              stderr=subprocess.PIPE if r else None, text=True)
             for r in range(world)]
    rcs = []
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=1500)
        rcs.append(p.returncode)
        if p.returncode and err:
            print(f"process {r}:\n{err[-4000:]}", file=sys.stderr)
    print(f"process exit codes {rcs}")
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
