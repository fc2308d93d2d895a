"""Data and tensor parallelism with one shard per process
(``Mesh.distributed``), against the one-process form (``Mesh.local``) on
the same inputs.

    python3 tools/mesh_multicard.py             # NCCL, one process per card
    python3 tools/mesh_multicard.py --cpu       # gloo, 4 CPU processes, at
                                                # tiny_test_config (rehearsal)
    python3 tools/mesh_multicard.py --checks judges   # check 3 alone
    python3 tools/mesh_multicard.py --checks w8a8_lora   # check 4 alone

n processes (n = the cards it sees, or ``--procs`` with ``--cpu``; n even)
join a process group on a free localhost port and form
``Mesh.distributed(n // 2, 2)``; rank 0 also runs ``Mesh.local(n // 2, 2)``
on its own card on the same inputs.  Four checks, each printed by rank 0:

1. ``chip_smoke.py``'s 2B scorer (random bf16 weights from its seed) on its
   pair request through ``RewardScorer(mesh=)``: the scores against the
   local mesh's, within ``chip_smoke.SCORE_TOL`` (bit-equality reported),
   the median of 3 pair requests, each card's peak memory.
2. Stage 3 (``chip_smoke.train_config``) on two of phase 33's batches of
   two pairs (one optimizer step at accumulation 2), without and with
   ZeRO-1: the parameters after the step against the local mesh's run
   (bit-equality reported; the relative L2 and cosine of the step's
   update held to ``chip_smoke.FIDELITY_REL_L2`` and ``FIDELITY_COS``),
   ZeRO-1 against the replicated run across the cards (bit-equal), each
   card's optimizer bytes and peak memory, and the seconds of the two
   micro-steps.

3. The judges on the mesh (``chip_smoke.py`` phase 34's): the InternVL2-2B
   judge at all 24 layers and the CogVLM2-Video judge at full width and
   ``chip_smoke.MESH_JUDGE_DEPTHS``, random bf16 weights from the seed,
   answering the pair of seeded videos by the prefix path: the answers'
   tokens and the teacher-forced logits over
   ``chip_smoke.MESH_FORCED_STEPS`` steps bit-equal to ``Mesh.local``'s,
   ms a pair (cold) and ms a decode step at B = 2 beside the judge
   unsharded on one card.  This check runs at ``Mesh.distributed(n // 2,
   2)`` with the others, then alone at ``Mesh.distributed(1, 2)`` in 2
   processes (cards 0 and 1).  ``--cpu`` takes tiny configs of both.
4. The w8a8 modes and LoRA under the model axis (``chip_smoke.py`` phase
   35's): check 1's pair request through ``RewardScorer`` on the scorer's
   state quantized by each of ``chip_smoke.SCORE_QUANT_MODES`` (per-row
   ``int8``: each row's amax max-reduced and the int32 partials summed
   over the model axis; ``int8-noattn-g128``: K6 on each rank's whole
   groups), then stage 3 with LoRA at ``chip_smoke.LORA_RANK`` and ZeRO-1
   on check 2's two batches (one optimizer step at accumulation 2; a
   column member's adapter ``a`` summed over the model axis): the scores
   and the parameters after the step bit-equal to ``Mesh.local``'s.  Like
   check 3 it runs at ``Mesh.distributed(n // 2, 2)``, then alone at
   ``(1, 2)`` in 2 processes (the scoring alone: ZeRO-1 needs the data
   axis).  ``--cpu`` takes ``tiny_test_config`` with
   every kernel above 1,024 elements quantized.

The last line of each launch is one JSON object of the readings; the exit
code is non-zero if a process fails or a check breaks its bound.
"""

from __future__ import annotations

import argparse
import json
import socket
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


def _peak_gib(dev, cpu):
    import torch

    return 0.0 if cpu else torch.cuda.max_memory_allocated(dev) / 2**30


def _reset_peak(dev, cpu):
    import torch

    if not cpu:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _all(obj):
    """Every rank's ``obj`` (all ranks call)."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def scoring_check(mesh, local, dev, cpu, out):
    """Check 1."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from mjvideo_tpu_torch import RewardScorer

    base = _base_scorer(dev, cpu)
    sync = (lambda: None) if cpu else torch.cuda.synchronize  # noqa: E731

    def scorer(m):
        return RewardScorer(base.cfg, base.params, base.tokenizer,
                            dtype=base.dtype, length_buckets=base.buckets,
                            gating_pattern=base.gating_pattern, mesh=m)

    pair = cs.make_requests(base, np.random.default_rng(cs.SEED))[1]
    across = scorer(mesh)
    _reset_peak(dev, cpu)
    scores = across.score_batch(*pair).score.float().cpu()
    times = []
    for _ in range(3):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        across.score_batch(*pair)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    peaks = _all(_peak_gib(dev, cpu))
    del across
    if dist.get_rank() == 0:
        one = scorer(local)
        _reset_peak(dev, cpu)
        ref = one.score_batch(*pair).score.float().cpu()
        local_peak = _peak_gib(dev, cpu)
        del one
        delta = (scores - ref).abs().max().item()
        ms = sorted(times)[1]
        out["scoring"] = {"scores": scores.tolist(),
                          "local_scores": ref.tolist(), "delta": delta,
                          "bit_equal": bool(torch.equal(scores, ref)),
                          "ms": ms, "peak_gib": peaks,
                          "local_peak_gib": local_peak}
        print(f"scoring: {mesh} pair scores {scores.tolist()}, local mesh "
              f"{ref.tolist()} (|delta| {delta:.3e}, bound "
              f"{cs.SCORE_TOL:.0e}, bit-equal {torch.equal(scores, ref)}); "
              f"{ms:.1f} ms a pair request (median of 3); peak memory per "
              f"card {[round(p, 2) for p in peaks]} GiB, "
              f"{local_peak:.2f} GiB on one holding every shard")
        out["ok"] = out["ok"] and delta < cs.SCORE_TOL
    del base
    if not cpu:
        torch.cuda.empty_cache()
    dist.barrier()


def _train_data(cpu):
    """(config, two batches of two pairs, dtype): phase 33's on the card,
    ``tiny_test_config``'s with ``--cpu``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch import ByteTokenizer
    from mjvideo_tpu_torch.data.prompts import rebase_img_context_id

    if cpu:
        from mjvideo_tpu_torch import tiny_test_config

        cfg = tiny_test_config()
        tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
        cfg = rebase_img_context_id(cfg, tok)
        pairs = cs.make_train_batches(cfg, tok, np.random.default_rng(
            cs.SEED), 4)
        batches = [cs._merge_pairs(pairs[i], pairs[i + 1],
                                   cfg.chat.llm.pad_token_id)
                   for i in (0, 2)]
        return cfg, batches, torch.float32
    cfg, batches = cs.mesh_train_data()
    return cfg, batches[:2], torch.bfloat16


def training_check(mesh, local, dev, cpu, out):
    """Check 2."""
    import tempfile

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from mjvideo_tpu_torch import init_reward_params
    from mjvideo_tpu_torch.train.trainer import (
        Trainer,
        flatten_state,
        state_bytes,
    )

    cfg, batches, dtype = _train_data(cpu)
    rank = dist.get_rank()

    def run(m, zero1, ckpt):
        params = init_reward_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(cs.SEED),
            device=dev, dtype=dtype)
        tc = cs.train_config(ckpt)
        tc.zero1 = zero1
        tr = Trainer(cfg, params, tc, mesh=m)
        del params
        _reset_peak(dev, cpu)
        if not cpu:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tr.train(batches)
        if not cpu:
            torch.cuda.synchronize(dev)
        s = time.perf_counter() - t0
        whole = {k: v.detach().cpu()
                 for k, v in flatten_state(tr.whole_params()).items()}
        reading = (state_bytes(tr.opt_state) / 2**30, _peak_gib(dev, cpu), s)
        del tr
        if not cpu:
            torch.cuda.empty_cache()
        return whole, reading

    initial = {k: v.detach().cpu() for k, v in flatten_state(
        init_reward_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(cs.SEED), device=dev,
                           dtype=dtype)).items()}
    if not cpu:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt:
        results = {}
        for zero1 in (False, True):
            whole, reading = run(mesh, zero1, ckpt)
            readings = _all(reading)
            results[zero1] = whole
            if rank == 0:
                ref, (lbytes, lpeak, ls) = run(local, zero1, ckpt)
                upd = [whole[k].double() - initial[k].double() for k in ref]
                ref_upd = [ref[k].double() - initial[k].double() for k in ref]
                rel, cos, _ = cs._agreement(upd, ref_upd)
                same = all(torch.equal(whole[k], ref[k]) for k in ref)
                label = "ZeRO-1" if zero1 else "replicated"
                out[f"training_{label}"] = {
                    "rel_l2_update": rel, "cos_update": cos,
                    "bit_equal": same,
                    "opt_gib": [r[0] for r in readings],
                    "peak_gib": [r[1] for r in readings],
                    "s": [r[2] for r in readings], "local_opt_gib": lbytes,
                    "local_peak_gib": lpeak, "local_s": ls}
                print(f"training {label}: {mesh} one optimizer step (2 "
                      f"micro-batches of 2 pairs) against the local mesh: "
                      f"the update's relative L2 {rel:.4e} (bound "
                      f"{cs.FIDELITY_REL_L2}), cosine {cos:.6f} (bound "
                      f"{cs.FIDELITY_COS}), parameters bit-equal {same}; "
                      f"optimizer GiB per card "
                      f"{[round(r[0], 3) for r in readings]}, peak GiB "
                      f"{[round(r[1], 2) for r in readings]}, s "
                      f"{[round(r[2], 2) for r in readings]}; local mesh "
                      f"{lbytes:.3f} GiB, peak {lpeak:.2f} GiB, {ls:.2f} s")
                out["ok"] = (out["ok"] and rel <= cs.FIDELITY_REL_L2
                             and cos >= cs.FIDELITY_COS)
                del ref
            dist.barrier()
    if rank == 0:
        same = all(torch.equal(results[True][k], results[False][k])
                   for k in results[False])
        out["zero1_bit_equal_across_cards"] = same
        print(f"training: ZeRO-1 against the replicated run across the "
              f"cards, parameters bit-equal: {same}")
        out["ok"] = out["ok"] and same


def _tiny_judge_configs():
    """The CPU rehearsal's configs: the 2B judge's at ``tiny_test_config``
    (4 ViT heads, 4/2 decoder heads, an odd vocabulary), a CogVLM2 of 2
    EVA heads and 4/2 decoder heads."""
    import dataclasses

    from mjvideo_tpu_torch import tiny_test_config
    from mjvideo_tpu_torch.configs import LLMConfig
    from mjvideo_tpu_torch.models import cogvlm2

    chat = dataclasses.replace(tiny_test_config(vocab_size=273).chat)
    cog = cogvlm2.CogVLM2Config(
        vision=cogvlm2.CogVLM2VisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_heads=2, patch_size=7, image_size=28),
        text=LLMConfig(architecture="llama", vocab_size=320, hidden_size=64,
                       intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2,
                       rope_theta=1e4, rms_norm_eps=1e-5, pad_token_id=0,
                       max_position_embeddings=4096),
        bos_token_id=1, eos_token_id=2, pad_token_id=0)
    return chat, cog


def judges_check(mesh, local, dev, cpu, out):
    """Check 3."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.models import cogvlm2
    from mjvideo_tpu_torch.models.generate import _eos_pad

    rank = dist.get_rank()
    videos = ("video_0", "video_1")
    sync = (lambda: None) if cpu else torch.cuda.synchronize  # noqa: E731
    tiny = _tiny_judge_configs() if cpu else None
    dtype = torch.float32 if cpu else torch.bfloat16

    def gen():
        return torch.Generator(device=dev).manual_seed(cs.SEED)

    def internvl(m):
        if cpu:
            from mjvideo_tpu_torch import init_chat_params

            state = init_chat_params(tiny[0], generator=gen(), device=dev,
                                     dtype=dtype, with_lm_head=True)
            j = cs.make_judge(state=state, base=tiny[0], impl="auto",
                              mesh=m)
        else:
            j = cs.make_judge(generator=gen(), device=dev, mesh=m)
        j.tokenizer = cs.RecordingTokenizer(j.tokenizer)
        return j, _eos_pad(j.cfg, j.tokenizer)[0]

    def cog(m):
        if cpu:
            cfg = tiny[1]
        else:
            depth = cs.MESH_JUDGE_DEPTHS["cogvlm2"]
            cfg = cs._cut_vision(cs.cut_text_depth(cogvlm2.CogVLM2Config(),
                                                   depth[1]), depth[0])
        state = cogvlm2.init_cogvlm2_params(cfg, generator=gen(),
                                            device=dev, dtype=dtype)
        j = cs.make_cog_judge(cfg, state,
                              cs.RecordingTokenizer(ByteTokenizer()), mesh=m)
        return j, cfg.eos_token_id

    for name, make in (("internvl2-2b", internvl), ("cogvlm2", cog)):
        judge, eos = make(mesh)
        _reset_peak(dev, cpu)
        dist.barrier()
        rows, secs = cs._answer(judge, videos)
        teacher = cs._teacher_of(rows, cs.MESH_FORCED_STEPS, eos, dev)
        logits, step_ms = cs._timed_teacher(judge, videos, teacher)
        sync()
        readings = _all((secs, step_ms, _peak_gib(dev, cpu)))
        del judge
        if rank == 0:
            one, _ = make(local)
            lrows, lsecs = cs._answer(one, videos)
            llogits, lstep = cs._timed_teacher(one, videos, teacher)
            del one
            card, _ = make(None)
            _, csecs = cs._answer(card, videos)
            _, cstep = cs._timed_teacher(card, videos, teacher)
            del card
            same_rows = rows == lrows
            same_logits = bool(torch.equal(logits, llogits))
            out[f"judge {name}"] = {
                "tokens_bit_equal": same_rows,
                "logits_bit_equal": same_logits,
                "pair_s": [r[0] for r in readings],
                "step_ms": [r[1] for r in readings],
                "peak_gib": [r[2] for r in readings],
                "local_pair_s": lsecs, "local_step_ms": lstep,
                "one_card_pair_s": csecs, "one_card_step_ms": cstep}
            print(f"judge {name}: {mesh} answers' tokens bit-equal to the "
                  f"local mesh's {same_rows}, teacher-forced logits over "
                  f"{teacher.shape[1]} steps bit-equal {same_logits}; a pair "
                  f"(cold) {[round(r[0], 3) for r in readings]} s a process, "
                  f"a decode step at B = 2 "
                  f"{[round(r[1], 2) for r in readings]} ms; the local mesh "
                  f"on one card {lsecs:.3f} s, {lstep:.2f} ms; unsharded on "
                  f"one card {csecs:.3f} s, {cstep:.2f} ms; peak GiB a card "
                  f"{[round(r[2], 2) for r in readings]}")
            out["ok"] = out["ok"] and same_rows and same_logits
        if not cpu:
            torch.cuda.empty_cache()
        dist.barrier()


def _base_scorer(dev, cpu):
    """Check 1's scorer: ``chip_smoke.make_scorer``'s 2B on the card, the
    tiny config in fp32 with ``--cpu``."""
    import torch

    import chip_smoke as cs
    from mjvideo_tpu_torch import (
        ByteTokenizer,
        RewardScorer,
        init_reward_params,
        tiny_test_config,
    )

    if not cpu:
        return cs.make_scorer(torch.Generator(device=dev).manual_seed(
            cs.SEED), dev)
    cfg = tiny_test_config()
    state = init_reward_params(cfg, generator=torch.Generator().manual_seed(
        cs.SEED), device=dev, dtype=torch.float32)
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    return RewardScorer(cfg, state, tok, dtype=torch.float32,
                        gating_pattern=tok.gating_pattern())


def w8a8_lora_check(mesh, local, dev, cpu, out):
    """Check 4."""
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from mjvideo_tpu_torch import RewardScorer, init_reward_params
    from mjvideo_tpu_torch.ops.quant import quantize_params_mode
    from mjvideo_tpu_torch.train.trainer import Trainer, flatten_state

    rank = dist.get_rank()
    label = f"{mesh.data}x{mesh.model}"
    base = _base_scorer(dev, cpu)
    pair = cs.make_requests(base, np.random.default_rng(cs.SEED))[1]
    for mode in cs.SCORE_QUANT_MODES:
        tree = quantize_params_mode(base.params, mode,
                                    min_elements=1024 if cpu else 1 << 16)

        def scorer(m, tree=tree, mode=mode):
            return RewardScorer(base.cfg, tree, base.tokenizer,
                                dtype=base.dtype, quant=mode,
                                length_buckets=base.buckets,
                                gating_pattern=base.gating_pattern, mesh=m)

        across = scorer(mesh)
        scores = across.score_batch(*pair).score.float().cpu()
        del across
        if rank == 0:
            ref = scorer(local).score_batch(*pair).score.float().cpu()
            same = bool(torch.equal(scores, ref))
            out[f"w8a8_{mode}_{label}"] = {"scores": scores.tolist(),
                                           "local_scores": ref.tolist(),
                                           "bit_equal": same}
            print(f"w8a8 {mode}: {mesh} pair scores {scores.tolist()}, "
                  f"local mesh {ref.tolist()}, bit-equal {same}")
            out["ok"] = out["ok"] and same
        del tree
        if not cpu:
            torch.cuda.empty_cache()
        dist.barrier()
    del base
    if mesh.data == 1:
        return  # ZeRO-1 slices over a data axis: LoRA runs where it has one

    cfg, batches, dtype = _train_data(cpu)

    def run(m, ckpt):
        params = init_reward_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(cs.SEED),
            device=dev, dtype=dtype)
        tc = replace(cs.train_config(ckpt), zero1=True,
                     lora_rank=cs.LORA_RANK)
        tr = Trainer(cfg, params, tc, mesh=m)
        del params
        _reset_peak(dev, cpu)
        t0 = time.perf_counter()
        tr.train(batches)
        if not cpu:
            torch.cuda.synchronize(dev)
        s = time.perf_counter() - t0
        whole = {k: v.detach().cpu()
                 for k, v in flatten_state(tr.whole_params()).items()}
        steps = tr.opt_state["gradient_step"]
        del tr
        if not cpu:
            torch.cuda.empty_cache()
        return whole, (s, _peak_gib(dev, cpu), steps)

    with tempfile.TemporaryDirectory() as ckpt:
        whole, reading = run(mesh, ckpt)
        readings = _all(reading)
        if rank == 0:
            ref, (ls, lpeak, _) = run(local, ckpt)
            same = all(torch.equal(whole[k], ref[k]) for k in ref)
            moved = sum(not torch.equal(whole[k], ref[k]) for k in ref)
            out[f"lora_zero1_{label}"] = {
                "bit_equal": same, "leaves_differing": moved,
                "s": [r[0] for r in readings],
                "peak_gib": [r[1] for r in readings],
                "optimizer_steps": readings[0][2], "local_s": ls,
                "local_peak_gib": lpeak}
            print(f"LoRA (rank {cs.LORA_RANK}) with ZeRO-1: {mesh} one "
                  f"optimizer step (2 micro-batches of 2 pairs), the whole "
                  f"parameters bit-equal to the local mesh's: {same}; s "
                  f"{[round(r[0], 2) for r in readings]}, peak GiB "
                  f"{[round(r[1], 2) for r in readings]}; local mesh "
                  f"{ls:.2f} s, peak {lpeak:.2f} GiB")
            out["ok"] = out["ok"] and same and readings[0][2] == 1
            del ref
        dist.barrier()


def worker(rank: int, world: int, port: int, cpu: bool,
           checks=("scoring", "training", "judges", "w8a8_lora")) -> int:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mjvideo_tpu_torch.parallel.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if not cpu:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=600))
    out = {"ok": True, "processes": world, "backend": dist.get_backend()}
    try:
        mesh = Mesh.distributed(world // 2, 2)
        local = Mesh.local(world // 2, 2)
        for check in checks:
            globals()[f"{check}_check"](mesh, local, dev, cpu, out)
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
    ap.add_argument("--checks",
                    default="scoring,training,judges,w8a8_lora")
    args = ap.parse_args()
    checks = tuple(args.checks.split(","))
    if args.worker is not None:
        return worker(args.worker, args.world, args.port, args.cpu, checks)

    import torch

    if args.cpu:
        world = args.procs
    else:
        if not torch.cuda.is_available():
            print("mesh_multicard: CUDA is not available", file=sys.stderr)
            return 1
        from mjvideo_tpu_torch import kernels

        world = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        print(f"cards: {smi}")
        kernels.build()  # once, before the processes load it
    if world < 2 or world % 2:
        print(f"mesh_multicard: needs an even number of processes, got "
              f"{world}", file=sys.stderr)
        return 1
    launches = [(world, checks)]
    pairs = tuple(c for c in ("judges", "w8a8_lora") if c in checks)
    if world > 2 and pairs:
        launches.append((2, pairs))
    rcs = []
    for n, which in launches:
        port = _free_port()
        cmd = [sys.executable, __file__, "--world", str(n), "--port",
               str(port), "--checks", ",".join(which)] + (
                   ["--cpu"] if args.cpu else [])
        procs = [subprocess.Popen(cmd + ["--worker", str(r)],
                                  stdout=subprocess.PIPE if r else None,
                                  stderr=subprocess.PIPE if r else None,
                                  text=True)
                 for r in range(n)]
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=1500)
            rcs.append(p.returncode)
            if p.returncode and err:
                print(f"process {r}:\n{err[-4000:]}", file=sys.stderr)
    print(f"process exit codes {rcs}")
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
