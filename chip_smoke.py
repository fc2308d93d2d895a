"""Drive the PyTorch port's MJ-VIDEO-2B scoring and training paths and its
InternVL2-2B judge once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Print the card (nvidia-smi name and power limit), torch and CUDA
   versions; build the CUDA kernels from ``mjvideo_tpu_torch/csrc``.
2. K1 (ViT attention) against its plain PyTorch twin at serving's (8, 1025,
   16, 64) and training's (2, 1025, 16, 64) bf16, q/k/v as strided views
   into one qkv tensor as the ViT makes them: the max-abs error relative to
   the largest output against the stated bound, and the median time of each.
3. The decoder kernels against their twins on the same inputs, at serving's
   (2, 2304, 16/8, 128) and (2, 3072, 16/8, 128) bf16 with a ragged mask and
   dead rows, and at training's (1, T, 16/8, 128) with every key live, T
   each prompt length of the training batches (so the last tile is partial):
   K2 without and with the lse (the output to the relative bound, the lse to
   LSE_TOL, dead rows' output exactly 0 and lse exactly 1e30), then K4a (dK,
   dV) and K4b (dQ) from the twin's output and lse (each gradient to the
   relative bound, dq exactly 0 on dead rows, dk and dv exactly 0 on masked
   keys); the median time of each kernel and twin.
4. Serving: a 2B ``RewardScorer`` with random bf16 weights made on the card
   from a seed answers a single clip and a pair of 8 frames of 448 px each.
   The launch counters must show 24 K1 and 24 K2 launches per request, every
   score must be finite, and the scores must agree within 1e-2 with the same
   weights in fp32 through the plain attention path (the delta is also
   printed relative to the largest score).  Prints clips/s and the peak
   device memory.
5. Training: a 2B stage-3 ``Trainer`` with random bf16 weights made on the
   card from the seed, ``TrainConfig(stage=3, learning_rate=1e-3,
   warmup_steps=0, gradient_accumulation_steps=2, remat=True)``, takes 4
   seeded micro-batches (one pair of 2-frame 448 px clips each, prompts from
   ``prepare_chat_input``): 2 optimizer steps.  Every loss and grad_norm
   must be finite, every frozen tensor bit-identical afterwards, some tensor
   of each trainable subtree changed, and the launch counters must equal
   what the layer counts give (per micro-batch and video: 24 K1, 48 K2 with
   the lse, since remat runs each decoder layer's forward twice, 24 K4a and
   24 K4b).  Prints the loss per step and peak memory.
6. Gradient fidelity: for one micro-batch, the trainable gradient of the
   bf16 kernel path against the same weights in fp32 through the plain
   attention path (pure autograd): loss delta, relative L2 error and cosine
   of the flattened gradient, held to FIDELITY_REL_L2 and FIDELITY_COS.
7. Training time: TRAIN_TIMED_STEPS more micro-steps; the median of those
   that only accumulate and of those that also step the optimizer.
8. (Run with phases 2 and 3, before the paths.)  K3 (the exact softmax)
   and K2r (the per-row bound) against their twins at the InternVL2-2B
   judge's shapes (JUDGE_SHAPES: the pair's left-padded
   full-prompt prefill with dead rows exactly 0, one video's prefix
   prefill, and the suffix continuation over the cache at q_offset 2,308),
   the kernels K2, K3 and K2r alone timed in turns at (2, 3072, 16/8, 128)
   (the wrappers' times include each bound's reduction), and K2r's prefix
   rows held bit-identical between a prefix-only and a full-prompt prefill
   of the same bf16 q/k/v.
9. The judge: an ``InternVLJudge`` on a 2B chat state with the LM head
   (random bf16 weights from a fresh generator at SEED, 64 new tokens,
   seeded 8-frame 448 px pixels in place of decoded videos) answers a pair
   through ``judge_pair`` with the overall prompt (the full-prompt path: its
   suffix exceeds the 128-token bucket) and a pair with a short question
   (the prefix path: two prefix prefills and one continuation), then the
   short question again under ``_CACHE_BOUND = "rows"``.  The launch
   counters must show 24 K1 per video encoded and 24 K3 (K2r under "rows")
   per prefill or continuation, none in decode steps and no K2.  Each
   path's teacher-forced per-step logits are held against the same weights
   in fp32 through ``impl="plain"`` on the kernel path's tokens, to
   LOGITS_REL_TOL of max|logit|.  Reports the prefix path's first-step
   logits against the full prompt's and the share of greedy tokens they
   agree on; prints prefill ms, ms per decode step at B = 2, answers/s for
   a pair and the peak memory.
10. Prints the kernel summary line and, last, the contract line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
# B, S, H, D: serving's 8 tiles x (32*32 + 1) tokens, then training's one
# 2-frame clip (2 tiles) per video.
K1_SHAPES = ((8, 1025, 16, 64), (2, 1025, 16, 64))
# B, T, Hq, Hkv, D: the 2,304 bucket of real 8-frame prompts, then the 3,072
# bucket the ByteTokenizer's longer prompts land in (the served requests).
# Training's (1, T, 16, 8, 128) come from its batches' prompt lengths.
K2_SHAPES = ((2, 2304, 16, 8, 128), (2, 3072, 16, 8, 128))
# Each kernel is held to max|kernel - plain| / max|plain| <= 2**-7, one bf16
# ulp of the largest output at worst: kernel and twin round p to bf16 alike
# and differ only in fp32 summation order and the final bf16 rounding.  The
# bound scales with each kernel's own outputs (K1's largest is about 0.7,
# K2's about 4 at these inputs) and is 4-6x each one's reading on an H100.
# A K1 that stages the 63 tail keys of S = 1025 as zeros but lets them into
# l reads about 3.5x the bound.  At random weights the score check below
# does not catch that fault, so these kernel checks are the guard.
KERNEL_REL_TOL = 2 ** -7
# BASELINE.json score-fidelity bar.  At random weights it depends on the
# draw: weight seeds 0-7 read 1.8e-3 to 1.33e-2 on an H100, seed 0 1.8e-3.
SCORE_TOL = 1e-2
FRAMES = 8
# K2's fp32 lse against its twin's, max |kernel - plain| in nats on live
# rows: about 10x the H100 reading (9.5e-7 at |lse| up to 8.8, one fp32 ulp).
LSE_TOL = 1e-5
TRAIN_FRAMES = 2                      # train CLI --num-segments default
TRAIN_MICRO_BATCHES = 4               # 2 optimizer steps at accumulation 2
TRAIN_TIMED_STEPS = 8                 # 4 that accumulate, 4 that also step
# Trainable gradient of one micro-batch, bf16 kernels against fp32 plain:
# about 2.5x the largest H100 reading of the relative L2 error over weight
# seeds 0-5 (7.2e-3 to 2.04e-2, cosine at least 0.99979).  A K4b planted to
# drop delta reads 0.47 (cosine 0.886), a K4a planted to skip the diagonal
# tile's causal mask 6.9e6: both fail this bar and their per-kernel checks
# alike (PERF.md section 6, PR 2).
FIDELITY_REL_L2 = 5e-2
FIDELITY_COS = 0.998
# K3 and K2r at the judge's shapes, (B, Q, K, Hq, Hkv, D, q_offset): the
# pair's full prompt in the 3,072 bucket (the overall prompt is 3,016
# ByteTokenizer tokens with 8 frames), one video's shared prefix (2,308
# tokens in the 2,368 bucket), and a suffix bucket of 128 over the prefix's
# cache of 2,368 + 128 + 64 slots.
JUDGE_SHAPES = {
    "prefill": (2, 3072, 3072, 16, 8, 128, None),
    "prefix": (1, 2368, 2368, 16, 8, 128, None),
    "continuation": (2, 128, 2560, 16, 8, 128, 2308),
}
JUDGE_PREFIX = 2308   # real tokens of the shared prefix (system + frames)
JUDGE_SUFFIX = 25     # real tokens of JUDGE_QUESTION's suffix
JUDGE_FRAMES = 8
JUDGE_NEW_TOKENS = 64
JUDGE_CAPTION = "A red fox runs through fresh snow at dawn."
JUDGE_QUESTION = "Which video is better?"
JUDGE_DECODE_STEPS = 16  # decode steps timed at B = 2
# Teacher-forced per-step logits of each judge path, bf16 kernels against
# fp32 plain on the same tokens: max|delta| / max|plain logit|.  Set from
# the seed survey (PERF.md section 6).
LOGITS_REL_TOL = 1.5e-1


def _median_ms(fn, reps=10, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rel_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def _check_kernel(label, kernel_fn, plain_fn, names=("out",), zero=None,
                  extra=None):
    """Run a kernel and its twin on the same inputs (each returns a tensor
    or a tuple) and hold the first ``len(names)`` outputs each to
    KERNEL_REL_TOL of max|plain|.  ``zero``: (where, predicate(got)), the
    outputs that must be exactly 0 and whether they are; ``extra(got, ref)``
    -> (text, ok, readings) holds a further output.  Prints the reading with
    the median time of each, raises on any breach, returns the reading."""
    import torch

    def run(fn):
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    got, ref = run(kernel_fn), run(plain_fn)
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in got):
        raise RuntimeError(f"{label}: non-finite kernel output")
    errs = {n: _rel_err(g, r) for n, g, r in zip(names, got, ref)}
    text = ", ".join(f"{n} max_abs_err {e:.3e} ({r:.3e} of max|plain|)"
                     for n, (e, r) in errs.items())
    ok = max(r for _, r in errs.values()) <= KERNEL_REL_TOL
    reading = {"max_abs_err": max(e for e, _ in errs.values())}
    if zero is not None:
        where, predicate = zero
        held = predicate(got)
        text += f"; exactly 0 on {where}: {held}"
        ok = ok and held
    if extra is not None:
        more, held, fields = extra(got, ref)
        text += f"; {more}"
        ok = ok and held
        reading.update(fields)
    del got, ref
    reading["ms"] = _median_ms(kernel_fn)
    reading["plain_ms"] = _median_ms(plain_fn)
    print(f"{label}: {text} (bound {KERNEL_REL_TOL:.2e}), kernel "
          f"{reading['ms']:.4f} ms, plain {reading['plain_ms']:.4f} ms "
          f"(median of 10)")
    if not ok:
        raise RuntimeError(f"{label}: beyond its bound: {text}")
    return reading


def check_vit_attention(randn, shape):
    """K1 on views into one (B, S, 3*H*D) tensor, as the ViT makes them."""
    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, S, H, D = shape
    q, k, v = (t.view(B, S, H, D)
               for t in randn(B, S, 3 * H * D).split(H * D, dim=-1))
    return _check_kernel(f"K1 vit_attention {shape}",
                         lambda: fa.vit_attention(q, k, v),
                         lambda: fa.vit_attention_plain(q, k, v))


def _decoder_inputs(randn, B, T, Hq, Hkv, D, ragged):
    """q, k, v, a (B, T) int32 mask and the (B, T) dead rows.  Ragged: row 1
    masks its last 600 keys and its first 5, so its first 5 queries see no
    key at all (dead rows); otherwise every key is live, as in training."""
    import torch

    q, k, v = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
    mask = torch.ones((B, T), dtype=torch.int32, device=q.device)
    if ragged:
        mask[1, T - 600:] = 0
        mask[1, :5] = 0
    dead = mask.cumsum(1) == 0  # causal from 0: row i sees keys 0..i
    return q, k, v, mask, dead


def check_decoder_kernels(randn, shape, ragged):
    """K2 without and with the lse, K4a and K4b against their twins on one
    set of inputs; returns each one's reading by label."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, dead = _decoder_inputs(randn, *shape, ragged)
    scale = shape[-1] ** -0.5
    kmax = fa.key_norm_max(k, mask)
    masked = mask == 0
    n_dead, n_masked = int(dead.sum()), int(masked.sum())
    dead_rows = (f"{n_dead} dead rows", lambda got: not got[0][dead].any())

    def lse_rule(got, ref):
        lse, ref_lse = got[1], ref[1]
        dead_l = dead[:, None, :].expand_as(lse)
        live_err = (lse - ref_lse)[~dead_l].abs().max().item()
        held = (live_err <= LSE_TOL and bool((lse[dead_l] == fa.DEAD_LSE).all())
                and bool((ref_lse[dead_l] == fa.DEAD_LSE).all()))
        top = ref_lse[~dead_l].abs().max().item()
        return (f"lse max_abs_err {live_err:.3e} on live rows (bound "
                f"{LSE_TOL:.0e}, |lse| up to {top:.2f}), {n_dead} dead rows "
                "at 1e30", held, {"lse_max_abs_err": live_err})

    readings = {
        "K2": _check_kernel(
            f"K2 decoder_attention {shape}",
            lambda: fa.decoder_attention(q, k, v, mask),
            lambda: fa.decoder_attention_plain(q, k, v, mask),
            zero=dead_rows),
        "K2 lse": _check_kernel(
            f"K2 lse decoder_attention {shape}",
            lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                              scale, with_lse=True),
            lambda: fa.decoder_attention_plain(q, k, v, mask,
                                               return_lse=True),
            zero=dead_rows, extra=lse_rule),
    }
    dout = randn(*q.shape)
    ref, lse = fa.decoder_attention_plain(q, k, v, mask, return_lse=True)
    args = (q, k, v, dout, lse, fa.attention_delta(ref, dout), mask)
    del ref
    readings["K4a"] = _check_kernel(
        f"K4a decoder_attention_bwd_dkdv {shape}",
        lambda: kernels.decoder_attention_bwd_dkdv(*args, None, scale),
        lambda: fa.decoder_attention_bwd_plain(*args, want_dq=False)[1:],
        names=("dk", "dv"),
        zero=(f"{n_masked} masked keys",
              lambda got: not any(g[masked].any() for g in got)))
    readings["K4b"] = _check_kernel(
        f"K4b decoder_attention_bwd_dq {shape}",
        lambda: kernels.decoder_attention_bwd_dq(*args, None, scale),
        lambda: fa.decoder_attention_bwd_plain(*args, want_dkdv=False)[0],
        names=("dq",), zero=dead_rows)
    return readings


def _judge_inputs(randn, shape):
    """q, k, v, the (B, K) int32 mask, q_offset and the (B, Q) dead rows of
    one JUDGE_SHAPES entry.  The prefill left-pads both rows (56 and 160
    pad keys, so their first queries see no key); the prefix masks its
    bucket's tail; the continuation marks each row's prefix and suffix
    slots valid."""
    import torch

    B, Q, K, Hq, Hkv, D, off = shape
    q, k, v = randn(B, Q, Hq, D), randn(B, K, Hkv, D), randn(B, K, Hkv, D)
    mask = torch.ones((B, K), dtype=torch.int32, device=q.device)
    if off is None and B == 2:
        mask[0, :56] = 0
        mask[1, :160] = 0
    elif off is None:
        mask[:, JUDGE_PREFIX:] = 0
    else:
        mask[:, off + JUDGE_SUFFIX:] = 0
        off = torch.full((B,), off, dtype=torch.int32, device=q.device)
    pos = torch.arange(Q, device=q.device)[None] + (0 if off is None
                                                     else off[:, None])
    pos = pos.expand(B, Q).clamp(max=K - 1).long()
    seen = torch.cumsum(mask, 1).gather(1, pos)
    return q, k, v, mask, off, seen == 0


def check_judge_kernels(randn, name, shape):
    """K3 and K2r against their twins on one set of inputs."""
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, off, dead = _judge_inputs(randn, shape)
    zero = (f"{int(dead.sum())} dead rows",
            lambda got: not got[0][dead].any())
    label = f"{shape[:6]} {name}"
    return {
        "K3": _check_kernel(
            f"K3 exact_attention {label}",
            lambda: fa.exact_attention(q, k, v, mask, off),
            lambda: fa.exact_attention_plain(q, k, v, mask, off), zero=zero),
        "K2r": _check_kernel(
            f"K2r decoder_attention_rows {label}",
            lambda: fa.decoder_attention_rows(q, k, v, mask, off),
            lambda: fa.decoder_attention_rows_plain(q, k, v, mask, off),
            zero=zero),
    }


def time_shifts_in_turns(randn, rounds=10):
    """The three causal forward kernels on the judge's prefill inputs, K2
    (global bound), K3 (exact) and K2r (per-row bound), launched directly
    with their bounds reduced beforehand, timed in turns (K2, K3, K2r, K2r,
    K3, K2) by CUDA events; returns the medians in ms."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, _, _ = _judge_inputs(randn, JUDGE_SHAPES["prefill"])
    scale = q.shape[-1] ** -0.5
    kmax = fa.key_norm_max(k, mask)
    rows = fa.row_key_bound(k, mask, None, q.shape[1], q.shape[2])
    runs = {
        "K2": lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                                scale),
        "K3": lambda: kernels.exact_attention(q, k, v, mask, None, scale),
        "K2r": lambda: kernels.decoder_attention_rows(q, k, v, mask, rows,
                                                      None, scale),
    }
    times = {name: [] for name in runs}
    for fn in runs.values():
        for _ in range(3):
            fn()
    for _ in range(rounds):
        for name in ("K2", "K3", "K2r", "K2r", "K3", "K2"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runs[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    med = {name: statistics.median(t) for name, t in times.items()}
    print(f"kernels alone at {JUDGE_SHAPES['prefill'][:6]}, in turns: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in med.items())
          + f" (median of {2 * rounds} each; K3/K2 {med['K3'] / med['K2']:.3f}"
          f", K2r/K2 {med['K2r'] / med['K2']:.3f})")
    return med


def check_k2r_prefix_rows(randn):
    """K2r on a full prompt (the short question's 2,333 tokens in the
    2,368 bucket) and on its prefix alone (2,308 tokens, the rest of the
    bucket pad) from the same bf16 q/k/v: the prefix rows must be
    bit-identical."""
    import torch

    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, T, _, Hq, Hkv, D, _ = JUDGE_SHAPES["prefix"]
    P = JUDGE_PREFIX
    q, k, v = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
    mask = torch.ones((B, T), dtype=torch.int32, device=q.device)
    mask[:, P + JUDGE_SUFFIX:] = 0
    pmask = mask.clone()
    pmask[:, P:] = 0
    pad = randn(B, T - P, Hq, D)
    qp = torch.cat([q[:, :P], pad], 1)
    kp = torch.cat([k[:, :P], pad[:, :, :Hkv]], 1)
    vp = torch.cat([v[:, :P], pad[:, :, Hkv:2 * Hkv]], 1)
    full = fa.decoder_attention_rows(q, k, v, mask)
    part = fa.decoder_attention_rows(qp, kp, vp, pmask)
    same = bool(torch.equal(full[:, :P], part[:, :P]))
    print(f"K2r prefix rows: {P} rows bit-identical between a prefix-only "
          f"and a full-prompt prefill: {same}")
    if not same:
        raise RuntimeError("K2r prefix rows differ between the prefix-only "
                           "and the full-prompt prefill")
    return same


def make_judge(state=None, generator=None, device=None):
    """An ``InternVLJudge`` on the 2B chat config rebased on the
    ``ByteTokenizer``, with random bf16 weights drawn on the card from
    ``generator`` (or ``state``, e.g. an fp32 copy, which then runs the
    plain path).  Its videos are seeded pixels: a video's name seeds its
    frames, so two judges see the same ones."""
    import numpy as np
    import torch

    from mjvideo_tpu.data.prompts import rebase_img_context_id
    from mjvideo_tpu_torch import (
        ByteTokenizer,
        InternVLJudge,
        extract_feature,
        init_chat_params,
        internvl2_2b_chat_config,
    )
    from mjvideo_tpu_torch.utils.bridge import first_tensor

    base = internvl2_2b_chat_config()
    tok = ByteTokenizer(pad_token_id=base.llm.pad_token_id)
    cfg = rebase_img_context_id(base, tok)
    impl = "auto"
    if state is None:
        state = init_chat_params(cfg, generator=generator, device=device,
                                 dtype=torch.bfloat16, with_lm_head=True)
    elif first_tensor(state).dtype == torch.float32:
        impl = "plain"

    class SeededVideoJudge(InternVLJudge):
        """Seeded pixels in place of a decoded video: the card's machine
        has no video decoder."""

        def _encode_video(self, video_path):
            rng = np.random.default_rng([SEED, sum(map(ord, video_path))])
            size = self.cfg.image_size
            pix = rng.normal(size=(JUDGE_FRAMES, size, size, 3))
            # bf16 pixels, as the judge feeds, in the weights' dtype.
            pix = torch.from_numpy(pix).to(self.device, torch.bfloat16)
            dtype = first_tensor(self.params["vision_model"]).dtype
            with torch.no_grad():
                vis = extract_feature(self.params, self.cfg, pix.to(dtype),
                                      impl=self.attn_impl)
            return vis, [1] * JUDGE_FRAMES

    return SeededVideoJudge(cfg, state, tok, num_segments=JUDGE_FRAMES,
                            max_new_tokens=JUDGE_NEW_TOKENS, attn_impl=impl)


def _full_inputs(judge, prompt, videos):
    """The full-prompt path's inputs: left-padded ids and mask, the
    generation config, and the videos' embeds."""
    import torch

    from mjvideo_tpu.data.prompts import build_video_question
    from mjvideo_tpu_torch.models.generate import batch_chat_inputs

    preps = [judge._prep(p) for p in videos]
    ids, mask, gc = batch_chat_inputs(
        judge.cfg, judge.tokenizer,
        [build_video_question(prompt, len(n)) for _, n in preps],
        [n for _, n in preps], generation_config=judge._gc())
    return (ids.to(judge.device), mask.to(judge.device), gc,
            torch.cat([v for v, _ in preps]))


def path_runner(judge, prompt, videos, prefix):
    """``run(**kw)``: the judge's generation for ``prompt`` by one path
    (tokens, or with ``teacher_tokens`` the per-step logits)."""
    from mjvideo_tpu_torch.models.generate import (
        generate,
        generate_from_prefix,
    )

    if prefix:
        state, sids, smask, gc = judge._prefix_inputs(prompt, videos)
        return lambda **kw: generate_from_prefix(
            judge.params, judge.cfg, state, sids, smask,
            generation_config=gc, impl=judge.attn_impl, **kw)
    ids, mask, gc, vis = _full_inputs(judge, prompt, videos)
    return lambda **kw: generate(judge.params, judge.cfg, ids, mask,
                                 generation_config=gc, vision_embeds=vis,
                                 impl=judge.attn_impl, **kw)


def logits_fidelity(judge, plain_judge, prompt, videos, prefix, label):
    """Teacher-forced per-step logits of one path, the kernel judge's
    against the fp32 plain judge's on the kernel path's greedy tokens:
    (max|delta|, max|delta| / max|plain|, tokens, kernel logits)."""
    toks = path_runner(judge, prompt, videos, prefix)()
    got = path_runner(judge, prompt, videos, prefix)(teacher_tokens=toks)
    ref = path_runner(plain_judge, prompt, videos, prefix)(
        teacher_tokens=toks)
    if not bool(got.isfinite().all()):
        raise RuntimeError(f"{label}: non-finite logits")
    err, rel = _rel_err(got, ref)
    print(f"judge {label}: greedy tokens of row 0 begin {toks[0, :8].tolist()}"
          f"; teacher-forced logits over {toks.shape[1]} steps, max|delta| "
          f"{err:.4e}, relative to max|plain logit| {rel:.4e} (bound "
          f"{LOGITS_REL_TOL:.1e})")
    return err, rel, toks, got


def _judge_launches(label, want):
    """Hold the launch counters to ``want`` (names not given: 0)."""
    from mjvideo_tpu_torch import kernels

    got = dict(kernels.launch_counts)
    print(f"judge {label} launches: {got}")
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise RuntimeError(f"judge {label}: launches {got}, want {full}")
    return got


def judge_phase(device, seed=SEED, timing=True):
    """Phase 9.  Returns the readings and the launch counts by path."""
    import gc

    import torch

    from mjvideo_tpu_torch import (
        judge_pair,
        kernels,
        map_state,
        overall_prompt,
    )
    from mjvideo_tpu_torch.models import generate as gen

    videos = ("video_0", "video_1")
    gc.collect()  # earlier phases' states (the judge's caches hold cycles)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    judge = make_judge(generator=torch.Generator(device=device)
                       .manual_seed(seed), device=device)
    L_vit = judge.cfg.vision.num_hidden_layers  # select_layer -1: all run
    L_llm = judge.cfg.llm.num_hidden_layers
    out = {}
    launches = {}

    # The full-prompt path (the overall prompt overflows the suffix bucket).
    kernels.reset_launch_counts()
    s0, s1, r0, r1 = judge_pair(judge, *videos, JUDGE_CAPTION)
    torch.cuda.synchronize()
    launches["judge_full"] = _judge_launches(
        "full prompt", {"vit_attention": 2 * L_vit, "exact_attention": L_llm})
    # At random weights the greedy ids lie above the ByteTokenizer's 261
    # (bytes and specials), which decode to nothing: answers are text,
    # often empty, and ratings 0.
    print(f"judge full prompt: ratings {s0}, {s1}; answers {r0!r:.60}, "
          f"{r1!r:.60}")
    # The prefix path: two prefix prefills and one continuation.
    kernels.reset_launch_counts()
    answers = judge.ask_batch(JUDGE_QUESTION, list(videos))
    torch.cuda.synchronize()
    launches["judge_prefix"] = _judge_launches(
        "prefix", {"exact_attention": 3 * L_llm})
    print(f"judge prefix: answers {[a[:60] for a in answers]!r}")
    if not all(isinstance(a, str) for a in (r0, r1, *answers)):
        raise RuntimeError("an answer did not decode to text")
    # The prefix path again under the per-row bound (fresh prefix states).
    judge._pstate.cache_clear()
    gen._CACHE_BOUND = "rows"
    try:
        kernels.reset_launch_counts()
        judge.ask_batch(JUDGE_QUESTION, list(videos))
        torch.cuda.synchronize()
        launches["judge_prefix_rows"] = _judge_launches(
            "prefix rows", {"decoder_attention_rows": 3 * L_llm})
    finally:
        gen._CACHE_BOUND = False
        judge._pstate.cache_clear()
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30

    # Teacher-forced logits against fp32 plain, both paths.
    plain = make_judge(state=map_state(lambda t: t.float(), judge.params))
    prompt = overall_prompt(JUDGE_CAPTION)
    _, out["full_rel"], otoks, _ = logits_fidelity(judge, plain, prompt,
                                                   videos, False, "full prompt")
    _, out["prefix_rel"], ptoks, plogits = logits_fidelity(
        judge, plain, JUDGE_QUESTION, videos, True, "prefix")
    del plain
    torch.cuda.empty_cache()
    # Reported, not required: the prefix path against the full prompt of
    # the same question.
    run_full = path_runner(judge, JUDGE_QUESTION, videos, False)
    ftoks = run_full()
    flogits = run_full(teacher_tokens=ftoks[:, :1])
    d0 = (plogits[:, 0] - flogits[:, 0]).abs().max().item()
    agree = (ptoks == ftoks).float().mean().item()
    print(f"judge prefix against full prompt (reported): first-step logits "
          f"max|delta| {d0:.4e}; greedy tokens agree on {agree:.4f} of "
          f"{ptoks.numel()}")
    out.update(prefix_vs_full_step0=d0, prefix_vs_full_agree=agree)
    for key in ("full_rel", "prefix_rel"):
        if not out[key] <= LOGITS_REL_TOL:
            raise RuntimeError(f"judge {key} {out[key]} > {LOGITS_REL_TOL}")
    if timing:
        out.update(time_judge(judge, videos, _drawn(judge, otoks),
                              _drawn(judge, ptoks)))
    print(f"judge: peak memory {out['peak_gib']:.2f} GiB (bf16, kernels)")
    return out, launches


def _host_ms(fn, reps=3):
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _drawn(judge, toks):
    """Tokens a pair's decode loop drew: it stops when every row has drawn
    EOS, or at the budget."""
    from mjvideo_tpu_torch.models import generate as gen

    hit = toks == gen._eos_pad(judge.cfg, judge.tokenizer)[0]
    n = hit.int().argmax(1) + 1
    return int(n.where(hit.any(1), toks.shape[1]).max())


def time_judge(judge, videos, drawn_full, drawn_prefix):
    """Prefill ms of the pair's full prompt and of one video's prefix, ms
    per decode step at B = 2 over each path's cache (warm, median of 3
    loops), and warm pair times of both paths (videos encoded, prefix
    states cached after the first call), whose loops draw ``drawn_full``
    and ``drawn_prefix`` tokens."""
    import torch

    from mjvideo_tpu_torch import judge_pair, overall_prompt
    from mjvideo_tpu_torch.models import generate as gen

    ids, mask, _, vis = _full_inputs(judge, overall_prompt(JUDGE_CAPTION),
                                     videos)
    lm, cfg = judge.params["language_model"], judge.cfg

    def prefill():
        return gen._prefill(judge.params, cfg, ids, mask, JUDGE_NEW_TOKENS,
                            None, vis, "auto", False)

    def continuation():
        state, sids, smask, gc = judge._prefix_inputs(JUDGE_QUESTION,
                                                      list(videos))
        _, cache, cmask = gen.generate_from_prefix(
            judge.params, cfg, state, sids, smask,
            generation_config=gc._replace(max_new_tokens=1),
            return_state=True)
        start = state.n_prefix.long() + smask.long().sum(-1)
        return None, cache, cmask, start

    def step_ms(made):
        _, cache, cmask, start = made
        tok = torch.zeros_like(start)

        def steps():
            for i in range(JUDGE_DECODE_STEPS):
                gen._step(lm, cfg.llm, tok, cache, cmask, start + i, "auto")

        steps()
        return _host_ms(steps) / JUDGE_DECODE_STEPS

    t = {"prefill_ms": _host_ms(prefill),
         # The judge's own prefix prefill, bypassing its cache of states.
         "prefix_prefill_ms": _host_ms(
             lambda: judge._prefix_state(videos[0])),
         "decode_step_ms": step_ms(prefill()),
         "prefix_decode_step_ms": step_ms(continuation()),
         "drawn_full": drawn_full, "drawn_prefix": drawn_prefix}
    t["pair_full_s"] = _host_ms(
        lambda: judge_pair(judge, *videos, JUDGE_CAPTION)) / 1e3
    judge.ask_batch(JUDGE_QUESTION, list(videos))
    t["pair_prefix_s"] = _host_ms(
        lambda: judge.ask_batch(JUDGE_QUESTION, list(videos))) / 1e3
    print(f"judge time: full-prompt prefill {tuple(ids.shape)} "
          f"{t['prefill_ms']:.1f} ms, one video's prefix prefill "
          f"{t['prefix_prefill_ms']:.1f} ms, decode step at B = 2 "
          f"{t['decode_step_ms']:.2f} ms over the full prompt's cache, "
          f"{t['prefix_decode_step_ms']:.2f} ms over the prefix path's; a "
          f"pair: full prompt {t['pair_full_s']:.3f} s "
          f"({2 / t['pair_full_s']:.2f} answers/s, {drawn_full} tokens "
          f"drawn), prefix path with cached prefixes {t['pair_prefix_s']:.3f}"
          f" s ({2 / t['pair_prefix_s']:.2f} answers/s, {drawn_prefix} "
          f"tokens drawn), at most {JUDGE_NEW_TOKENS} new tokens")
    return t


def make_train_batches(cfg, tok, rng, n):
    """``n`` micro-batches in ``PairCollator``'s layout, each one pair of
    TRAIN_FRAMES-frame clips (batch 1), with random labels."""
    import numpy as np

    from mjvideo_tpu_torch import build_video_question, prepare_chat_input

    size = cfg.chat.image_size
    captions = ("A dog catches a frisbee on a sunny beach.",
                "Rain falls on a quiet city street at night, neon signs "
                "reflecting in the puddles.")
    batches = []
    for i in range(n):
        batch = {}
        for v in (0, 1):
            chat = prepare_chat_input(
                cfg.chat, tok,
                build_video_question(captions[(i + v) % 2], TRAIN_FRAMES),
                num_patches_list=[1] * TRAIN_FRAMES,
                gating_pattern=tok.gating_pattern())
            T = chat.input_ids.shape[1]
            batch[f"video_{v}_pixel_values"] = rng.normal(
                size=(1, TRAIN_FRAMES, size, size, 3)).astype(np.float32)
            batch[f"video_{v}_input_ids"] = chat.input_ids
            batch[f"video_{v}_attention_mask"] = np.ones((1, T), np.int32)
            batch[f"video_{v}_gating_pos"] = np.array([chat.gating_pos],
                                                      np.int32)
            batch[f"video_{v}_criteria_score"] = rng.choice(
                [-1.0, 0.0, 1.0], size=(1, 28)).astype(np.float32)
            batch[f"video_{v}_criteria_related"] = rng.integers(
                0, 2, size=(1, 28)).astype(np.float32)
            batch[f"video_{v}_aspect_score"] = rng.choice(
                [-1.0, 0.0, 1.0], size=(1, 5)).astype(np.float32)
            batch[f"video_{v}_aspect_related"] = rng.integers(
                0, 2, size=(1, 5)).astype(np.float32)
            batch[f"video_{v}_overall_score"] = rng.choice(
                [-1.0, 1.0], size=(1, 1)).astype(np.float32)
            batch[f"video_{v}_overall_related"] = np.ones((1, 1), np.float32)
        batch["aspect_preference"] = rng.integers(0, 2, (1, 5)).astype(np.int32)
        batch["aspect_mask"] = rng.integers(0, 2, (1, 5)).astype(np.float32)
        batch["overall_preference"] = rng.integers(0, 2, (1, 1)).astype(np.int32)
        batch["overall_mask"] = np.ones((1, 1), np.float32)
        batches.append(batch)
    return batches


def train_data():
    """The 2B config rebased on the ``ByteTokenizer``, and
    TRAIN_MICRO_BATCHES seeded micro-batches for it."""
    import numpy as np

    from mjvideo_tpu.data.prompts import rebase_img_context_id
    from mjvideo_tpu_torch import ByteTokenizer, mjvideo_2b_config

    tok = ByteTokenizer(pad_token_id=mjvideo_2b_config().chat.llm.pad_token_id)
    cfg = rebase_img_context_id(mjvideo_2b_config(), tok)
    return cfg, make_train_batches(cfg, tok, np.random.default_rng(SEED),
                                   TRAIN_MICRO_BATCHES)


def train_decoder_shapes(cfg, batches):
    """(B, T, Hq, Hkv, D) at which training runs the decoder kernels: one
    per prompt length of ``batches`` (each video is its own batch of 1)."""
    llm = cfg.chat.llm
    lengths = sorted({b[f"video_{v}_input_ids"].shape[1]
                      for b in batches for v in (0, 1)})
    return tuple((1, T, llm.num_attention_heads, llm.num_key_value_heads,
                  llm.head_dim) for T in lengths)


def make_trainer(generator, device, checkpoint_dir, data=None):
    """A 2B stage-3 ``Trainer`` with random bf16 weights drawn on the card,
    and its micro-batches (``data``, or ``train_data()``)."""
    import torch

    from mjvideo_tpu_torch import init_reward_params
    from mjvideo_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg, batches = train_data() if data is None else data
    params = init_reward_params(cfg, generator=generator, device=device,
                                dtype=torch.bfloat16)
    tc = TrainConfig(stage=3, learning_rate=1e-3, warmup_steps=0,
                     gradient_accumulation_steps=2, remat=True, log_every=1,
                     checkpoint_every=10**9, checkpoint_dir=checkpoint_dir)
    return Trainer(cfg, params, tc), batches


def run_training(generator, device, checkpoint_dir, data):
    """Phase 5.  Returns the trainer, its batches, the launch counts and the
    peak memory in bytes."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.train.trainer import flatten_state

    trainer, batches = make_trainer(generator, device, checkpoint_dir, data)
    cfg = trainer.cfg
    before = {p: t.clone() for p, t in flatten_state(trainer.params).items()}
    print(f"training: {len(batches)} micro-batches, prompt lengths "
          f"{[[b[f'video_{v}_input_ids'].shape[1] for v in (0, 1)] for b in batches]}, "
          f"{len(trainer.optimizer.paths)} trainable tensors of "
          f"{len(before)}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    records = [trainer.train([batch]) for batch in batches]
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated(device)
    for r in records:
        print(f"  micro-step {r['step']}: loss {r['loss']:.6f}, grad_norm "
              f"{r['grad_norm']:.6f}")
    print(f"training: optimizer steps {trainer.opt_state['gradient_step']}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"launches over {len(batches)} micro-batches: {launches}")

    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in records):
        raise RuntimeError(f"non-finite loss or grad_norm: {records}")
    if trainer.opt_state["gradient_step"] != len(batches) // 2:
        raise RuntimeError("the optimizer did not step once per 2 micro-batches")
    after = flatten_state(trainer.params)
    trainable = set(trainer.optimizer.paths)
    for path, t in after.items():
        if path not in trainable and not torch.equal(t, before[path]):
            raise RuntimeError(f"frozen tensor {path} changed")
    for prefix in ("regression_layer", "criteria_gating", "aspect_gating",
                   "model/language_model"):
        if not any(not torch.equal(after[p], before[p])
                   for p in trainable if p.startswith(prefix)):
            raise RuntimeError(f"no tensor of {prefix} changed")
    del before
    # Per micro-batch and video: the ViT's layers once (no gradient), each
    # decoder layer's forward twice (remat, K2 with the lse) and its
    # backward once.
    per_video = {"vit_attention": cfg.chat.vision.num_hidden_layers,
                 "decoder_attention": 2 * cfg.chat.llm.num_hidden_layers,
                 "decoder_attention_lse": 2 * cfg.chat.llm.num_hidden_layers,
                 "decoder_attention_bwd_dkdv": cfg.chat.llm.num_hidden_layers,
                 "decoder_attention_bwd_dq": cfg.chat.llm.num_hidden_layers}
    want = {k: 2 * len(batches) * per_video.get(k, 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"training launches {launches}, want {want}")
    return trainer, batches, launches, peak


def time_training(trainer, batches):
    """Phase 7: TRAIN_TIMED_STEPS micro-steps after the checks, each timed
    on the host clock after ``synchronize``; returns the median ms of those
    that only accumulate and of those that also step the optimizer."""
    import torch

    times = {"accumulate": [], "optimizer": []}
    for i in range(TRAIN_TIMED_STEPS):
        steps = trainer.opt_state["gradient_step"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train([batches[i % len(batches)]])
        torch.cuda.synchronize()
        kind = ("optimizer" if trainer.opt_state["gradient_step"] > steps
                else "accumulate")
        times[kind].append((time.perf_counter() - t0) * 1e3)
    medians = {f"{kind}_ms": statistics.median(t) for kind, t in times.items()}
    print(f"training time: micro-steps that accumulate "
          f"{[round(t, 1) for t in times['accumulate']]} ms (median "
          f"{medians['accumulate_ms']:.1f}), that also step the optimizer "
          f"{[round(t, 1) for t in times['optimizer']]} ms (median "
          f"{medians['optimizer_ms']:.1f}); one optimizer step of 2 "
          f"micro-batches {sum(medians.values()):.1f} ms")
    return medians


def gradient_fidelity(trainer, batch):
    """Phase 6: (loss delta, relative L2 error, cosine) of the trainable
    gradient, bf16 kernels against fp32 plain, same weights and batch."""
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

    def grads(params, impl, dtype):
        set_trainable(params, set(paths))
        flat = flatten_state(params)
        loss = make_loss_fn(trainer.cfg, replace(trainer.tc, attn_impl=impl))(
            params, place_batch(batch, trainer.device, dtype))
        return loss.item(), torch.autograd.grad(loss, [flat[p] for p in paths])

    loss_k, g_k = grads(trainer.params, "auto", torch.bfloat16)
    p32 = map_state(lambda t: t.detach().float(), trainer.params)
    loss_p, g_p = grads(p32, "plain", torch.float32)
    del p32
    dot = na = nb = nd = 0.0
    for a, b in zip(g_k, g_p):
        a = a.float()
        dot += (a.double() * b.double()).sum().item()
        na += a.double().square().sum().item()
        nb += b.double().square().sum().item()
        nd += (a - b).double().square().sum().item()
    rel_l2 = math.sqrt(nd / nb)
    cos = dot / math.sqrt(na * nb)
    print(f"gradient fidelity: loss bf16+kernels {loss_k:.6f}, fp32 plain "
          f"{loss_p:.6f} (delta {abs(loss_k - loss_p):.3e}); gradient "
          f"relative L2 error {rel_l2:.4e} (bound {FIDELITY_REL_L2}), cosine "
          f"{cos:.6f} (bound {FIDELITY_COS}), |g| fp32 plain "
          f"{math.sqrt(nb):.4e}")
    if not (rel_l2 <= FIDELITY_REL_L2 and cos >= FIDELITY_COS):
        raise RuntimeError(f"gradient fidelity: relative L2 {rel_l2}, "
                           f"cosine {cos}")
    return abs(loss_k - loss_p), rel_l2, cos


def make_scorer(generator, device):
    """A 2B ``RewardScorer`` with random bf16 weights drawn on the card."""
    import torch

    from mjvideo_tpu_torch import (
        ByteTokenizer,
        RewardScorer,
        init_reward_params,
        mjvideo_2b_config,
    )

    cfg = mjvideo_2b_config()
    state = init_reward_params(cfg, generator=generator, device=device,
                               dtype=torch.bfloat16)
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    scorer = RewardScorer(cfg, state, tok, dtype=torch.bfloat16,
                          gating_pattern=tok.gating_pattern())
    if scorer.pad_token_id != cfg.chat.llm.pad_token_id:
        raise RuntimeError("scorer pads with another id than the config's")
    return scorer


def make_requests(scorer, rng):
    """One single clip and one pair: (pixels, ids list, gating positions)."""
    import numpy as np

    from mjvideo_tpu_torch import build_video_question, prepare_chat_input

    tok = scorer.tokenizer
    size = scorer.cfg.chat.image_size

    def clip(caption):
        chat = prepare_chat_input(
            scorer.cfg.chat, tok, build_video_question(caption, FRAMES),
            num_patches_list=[1] * FRAMES,
            gating_pattern=scorer.gating_pattern)
        pix = rng.normal(size=(FRAMES, size, size, 3)).astype(np.float32)
        return pix, chat.input_ids[0], chat.gating_pos

    single = [clip("A red fox runs through fresh snow at dawn.")]
    pair = [clip("Two kittens chase a ball of yarn across a wooden floor."),
            clip("A sailboat drifts past a lighthouse while gulls circle "
                 "overhead and waves break on the rocks below.")]
    out = []
    for clips in (single, pair):
        out.append((np.concatenate([c[0] for c in clips]),
                    [c[1] for c in clips], [c[2] for c in clips]))
    return out


def plain_score_delta(scorer, requests, scores):
    """Re-score with the same weights in fp32 through the plain attention
    path; returns (max |delta|, max |delta| / max |plain score|)."""
    import torch

    from mjvideo_tpu_torch import RewardScorer, map_state

    ref_scorer = RewardScorer(scorer.cfg, map_state(lambda t: t.float(),
                                                    scorer.params),
                              scorer.tokenizer, dtype=torch.float32,
                              gating_pattern=scorer.gating_pattern,
                              attn_impl="plain")
    ref = torch.cat([ref_scorer.score_batch(*r).score for r in requests])
    ref = ref.float().cpu()
    delta = (scores - ref).abs().max().item()
    rel = delta / ref.abs().max().item()
    print(f"scores bf16+kernels {scores.tolist()}")
    print(f"scores fp32 plain   {ref.tolist()}")
    print(f"max |score delta| {delta:.3e} (bound {SCORE_TOL:.0e}), "
          f"relative to max|plain score| {rel:.3e}")
    return delta, rel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    from mjvideo_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # Phase 1: build.
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"built {lib} in {time.perf_counter() - t0:.1f} s")
    for line in (lib.parent / "ptxas.txt").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    def generator():
        # Each phase draws from its own generator, so the weights do not
        # depend on how many inputs the kernel checks drew before them.
        return torch.Generator(device=dev).manual_seed(SEED)

    g = generator()

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    # Phases 2 and 3: each kernel against its plain twin, at serving's
    # shapes and at training's.
    train = train_data()
    train_shapes = train_decoder_shapes(*train)
    k1 = {s: check_vit_attention(randn, s) for s in K1_SHAPES}
    dec = {s: check_decoder_kernels(randn, s, ragged=True) for s in K2_SHAPES}
    dec.update({s: check_decoder_kernels(randn, s, ragged=False)
                for s in train_shapes})
    judge_k = {name: check_judge_kernels(randn, name, shape)
               for name, shape in JUDGE_SHAPES.items()}
    turns = time_shifts_in_turns(randn)
    check_k2r_prefix_rows(randn)

    # Phase 4: serving at the 2B widths and depths.
    t0 = time.perf_counter()
    scorer = make_scorer(generator(), dev)
    torch.cuda.synchronize()
    print(f"2B state (bf16) made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    requests = make_requests(scorer, np.random.default_rng(SEED))
    for pix, ids, _ in requests:
        print(f"request: {len(ids)} clip(s), {pix.shape[0]} tiles, prompt "
              f"lengths {[len(i) for i in ids]}")

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    scores = [scorer.score_batch(*r).score for r in requests]
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    print(f"launches over {len(requests)} requests: {launches}")
    for name, n in launches.items():
        # Serving runs K2 (without the lse) and no backward kernel.
        want = (24 * len(requests)
                if name in ("vit_attention", "decoder_attention") else 0)
        if n != want:
            raise RuntimeError(f"{name}: {n} launches, want {want}")
    scores = torch.cat(scores).float().cpu()
    if not torch.isfinite(scores).all():
        raise RuntimeError(f"non-finite scores {scores.tolist()}")
    peak = torch.cuda.max_memory_allocated(dev)

    pair = requests[1]
    times = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer.score_batch(*pair)
        torch.cuda.synchronize()
        if i >= 2:  # first two are warm-up
            times.append(time.perf_counter() - t0)
    pair_s = statistics.median(times)
    clips_per_s = len(pair[1]) / pair_s
    print(f"serving: pair request median {pair_s * 1e3:.1f} ms over "
          f"{len(times)} runs -> {clips_per_s:.2f} clips/s; peak memory "
          f"{peak / 2**30:.2f} GiB (bf16, kernels)")

    delta, _ = plain_score_delta(scorer, requests, scores)
    if not delta < SCORE_TOL:
        raise RuntimeError(f"score delta {delta} >= {SCORE_TOL}")
    del scorer, requests
    torch.cuda.empty_cache()

    # Phases 5-7: training, the gradient against fp32 plain, then timing.
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer, batches, train_launches, train_peak = run_training(
            generator(), dev, ckpt_dir, train)
        gradient_fidelity(trainer, batches[0])
        train_ms = time_training(trainer, batches)
    del trainer, batches
    torch.cuda.empty_cache()

    # Phase 9: the judge at the 2B widths and depths.
    judged_out, judge_launches = judge_phase(dev)
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")

    by_path = {"serving": launches, "training": train_launches,
               **judge_launches}

    def counts(name):
        paths = {path: n[name] for path, n in by_path.items()}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    served, trained = K2_SHAPES[-1], train_shapes[-1]
    lse = dec[trained]["K2 lse"]
    judged = JUDGE_SHAPES["prefill"][:6]
    summary = {"kernels": [
        {"name": "vit_attention", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/vit_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:99",
         **counts("vit_attention"), "shape": K1_SHAPES[0],
         **k1[K1_SHAPES[0]]},
        {"name": "decoder_attention", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:318",
         **counts("decoder_attention"), "shape": served, **dec[served]["K2"]},
        {"name": "decoder_attention_lse", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:407",
         **counts("decoder_attention_lse"), "shape": trained, **lse},
        {"name": "decoder_attention_bwd_dkdv", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_bwd.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:603",
         **counts("decoder_attention_bwd_dkdv"), "shape": trained,
         **dec[trained]["K4a"]},
        {"name": "decoder_attention_bwd_dq", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_bwd.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:656",
         **counts("decoder_attention_bwd_dq"), "shape": trained,
         **dec[trained]["K4b"]},
        {"name": "exact_attention", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/exact_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:260",
         **counts("exact_attention"), "shape": judged,
         **judge_k["prefill"]["K3"], "kernel_ms_in_turns": turns["K3"],
         "k2_kernel_ms_in_turns": turns["K2"]},
        {"name": "decoder_attention_rows", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:318",
         **counts("decoder_attention_rows"), "shape": judged,
         **judge_k["prefill"]["K2r"], "kernel_ms_in_turns": turns["K2r"]},
    ], "training": {**train_ms, "peak_gib": train_peak / 2**30},
        "judge": judged_out}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
