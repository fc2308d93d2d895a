"""Drive the PyTorch port's MJ-VIDEO-2B scoring and training paths, its
InternVL2-2B judge, quantized scoring and judging, the reward gradient
with its VADER loop, sequence-parallel scoring and training,
MJ-VIDEO-4B's serving with its InternVL2-4B judge, its reward gradient,
VADER loop and training, the Qwen2-VL, VideoScore, MiniCPM-V-2.6,
CogVLM2-Video, InternVL2-26B and InternVL2-8B judges, the training
options (remat policies, ViT DropPath and dropout, the optimizers, async
checkpoints), LoRA and QLoRA training and the serving example once on one
CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Print the card (nvidia-smi name and power limit), torch and CUDA
   versions; build the CUDA kernels from ``mjvideo_tpu_torch/csrc``.
2. K1 (ViT attention) against its plain PyTorch twin at serving's (8, 1025,
   16, 64) and training's (2, 1025, 16, 64) bf16, q/k/v as strided views
   into one qkv tensor as the ViT makes them: the op (one C call: its
   pre-pass's partial maxima of the key norms, then its kernel on the
   Hopper template, launched as a programmatic dependent that folds them),
   the kernel alone on the standalone pre-pass's kmax, and the pre-pass
   (``kernels.key_norm_max``: the partials and their fold) against its
   twin (to PREPASS_REL_TOL), with its device time a launch by
   ``torch.profiler``; the max-abs error relative to the largest output
   against the stated bound, and the median time of each; the op, with
   the lse and without, bit-equal to the kernel alone and a second launch
   of it bit-identical.  Then K1 alone, K1 with the lse, the K1 op, the
   K1-lse op, the pre-pass and ``F.scaled_dot_product_attention`` in turns
   at serving's shape, and the ops' device time by kernel and back to
   back.
3. The decoder kernels against their twins on the same inputs, at serving's
   (2, 2304, 16/8, 128) and (2, 3072, 16/8, 128) bf16 with a ragged mask and
   dead rows, at training's (1, T, 16/8, 128) with every key live, T
   each prompt length of the training batches (so the last tile is partial),
   and at the reward gradient's (1, 3072, 16/8, 128) with phase 14's
   single-clip mask (the prompt's keys live, the bucket's tail masked):
   K2 without the lse (the op, as K1's; the kernel alone; the pre-pass to
   PREPASS_REL_TOL, with its device time) and with it (the same template's
   lse epilogue; the output to the relative bound and bit-equal to K2's
   without the lse, the lse to LSE_TOL, dead rows' output exactly 0 and
   lse exactly 1e30), the op with the lse and without bit-equal to the
   kernel alone and a second launch bit-identical, then K4a (dK,
   dV) and K4b (dQ), on the Hopper backward template
   (``attention_bwd_sm90.cuh`` at D = 128), from the twin's output and lse
   (each gradient to the relative bound, dq exactly 0 on dead rows, dk and
   dv exactly 0 on masked keys, a second launch bit-identical to the
   first); the median time of each kernel and twin.  Then the K2 op at
   phase 20's no-SP decoder, (1, 53,760, 16/8, 128) with 53,722 live keys
   (LONG_KEYS): the pre-pass against its twin and the op, with the lse and
   without, bit-equal to the kernel alone.  Then K4a, K4b and
   SDPA's backward timed in turns at training's last shape and at the
   reward gradient's, with each one's share of its bound.
4. Serving: a 2B ``RewardScorer`` with random bf16 weights made on the card
   from a seed answers a single clip and a pair of 8 frames of 448 px each.
   The launch counters must show 24 K1, 24 K2 and 48 ``key_norm_max``
   (their pre-pass) launches per request, every
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
   Then F4's reading at these stepped weights
   (``tools/k2lse_budget_torch.py``): for every decoder attention call of
   the micro-batch's forward, the (row, head) pairs whose largest score
   lies more than 87.3 nats below the K2 bound, the live keys whose p falls
   below 2^-126, and K2 lse's dead pairs, held equal to the fp32 twin's.
7. Training time: TRAIN_TIMED_STEPS more micro-steps; the median of those
   that only accumulate and of those that also step the optimizer.
8. (Run with phases 2 and 3, before the paths.)  K3 (the exact softmax)
   and K2r (the per-row bound; the op: one C call of its pre-pass, chunk
   partials and a scan, and K2r behind them as programmatic dependents)
   against their twins at the InternVL2-2B judge's shapes (JUDGE_SHAPES:
   the pair's left-padded full-prompt prefill with dead rows exactly 0, one
   video's prefix prefill, and the suffix continuation over the cache at
   q_offset 2,308), then K2r's pre-pass against its twin (to
   PREPASS_REL_TOL, with its device time a launch by kernel), its last
   column bit-equal to ``key_norm_max`` and its first P columns to the
   pre-pass of the keys cut at P (JUDGE_PREFIX and K // 2 + 1, so other
   chunk plans than the whole one's), and K2r's kernel alone on the
   pre-pass's column, the op bit-equal to it and a second launch of the op
   bit-identical; each with the share of its bound reached.  The kernels
   K2, K3 and K2r alone,
   the K2 and K2r ops and ``F.scaled_dot_product_attention`` (the same-run
   yardstick), K2 with the lse alone and its op (the pre-pass and K2 with
   the lse) and K3 with the lse, timed in turns at (2, 3072, 16/8, 128),
   and K2r's prefix
   rows held
   bit-identical between a prefix-only and a full-prompt prefill of the
   same bf16 q/k/v.  Phase 1 also prints the registers and spills that
   ptxas reports for the Hopper templates' instantiations (attention
   forward and backward, the int8 GEMM and K6's pre-pass) and the 5
   kernels of the bound pre-passes, and fails if one spills or is
   missing.
9. The judge: an ``InternVLJudge`` on a 2B chat state with the LM head
   (random bf16 weights from a fresh generator at SEED, 64 new tokens,
   seeded 8-frame 448 px pixels in place of decoded videos) answers a pair
   through ``judge_pair`` with the overall prompt (the full-prompt path: its
   suffix exceeds the 128-token bucket) and a pair with a short question
   (the prefix path: two prefix prefills and one continuation), then the
   short question again under ``_CACHE_BOUND = "rows"``.  The launch
   counters must show 24 K1 (each after its pre-pass) per video encoded
   and 24 K3 (K2r and its pre-pass under "rows") per prefill or
   continuation, none in decode steps and no K2.  Each
   path's teacher-forced per-step logits (the prefix path also under
   "rows") are held against the same weights in fp32 through
   ``impl="plain"`` on the kernel path's tokens, to LOGITS_REL_TOL of
   max|logit|.  Reports the prefix path's first-step
   logits against the full prompt's and the share of greedy tokens they
   agree on; prints prefill ms, ms per decode step at B = 2, answers/s for
   a pair and the peak memory.
10. (Run with phases 2, 3 and 8.)  K6 (grouped w8a8: its pre-pass
   quantizes x once per (row, group), then the int8 wgmma GEMM on the
   k-major weight), the pre-pass alone and K7 (the GEMM from a
   pre-quantized x) against their twins at the 2B's grouped products
   (Q8G_SHAPES: ViT fc1, decoder w1 and w2, an M tail, the LM head's odd
   N), each bit for bit, K7 also against K6 on the same x, bit for bit
   (K6's GEMM is launched behind its pre-pass as a programmatic
   dependent, K7's is not); K6, K7 and the pre-pass timed in turns with
   bf16 ``torch.matmul`` at the same (M, K, N) and ``torch._int_mm`` on
   the same int8 operands (labelled references, not the same function),
   and each one's device time a launch by ``torch.profiler``; K5 (int4
   weight-only GEMV: tensor-core products on the k-major nibble layout, K
   split over a cluster where the columns are few) against its twin at a
   decode step's shapes (W4_SHAPES x W4_ROWS), a second launch
   bit-identical, its device time a launch with the L2 cold (a CUDA graph
   over weight copies past COLD_L2_BYTES) beside the op's time;
   ``torch._weight_int4pack_mm`` on the same nibbles and scales as its
   library yardstick (held to the same bar, timed hot and cold, where it
   takes the shape), bf16 ``torch.matmul`` as a labelled reference point.  Every
   kernel check (phases 2, 3, 8 and 10) also prints its bound, the least time of its work on the card (bytes at 3.35 TB/s or
   operations at the bf16 or int8 peak, from this run's shapes and masks),
   and for the attention kernels the time of
   ``F.scaled_dot_product_attention`` at the same shape.
11. Quantized scoring (after phase 4, on its bf16 state): ``RewardScorer(
   quant=m)`` for each of SCORE_QUANT_MODES quantizes the state on the card
   and answers both requests; the launch counters must show 170 K6
   launches per request under ``int8-noattn-g128`` (4 per ViT layer, 2 in
   the projector, 3 per decoder MLP) and none under ``int8``; the scores
   are held within QUANT_SCORE_TOL of the same quantized tree through the
   plain path in fp32, and their delta against the unquantized fp32 plain scores
   is reported.  Prints the quantization time and peak memory, clips/s and
   the serving peak.
12. The quantized judge (after phase 9): phase 9's judge in ``int4-wo``
   answers the pair through ``judge_pair``; the counters must show one K5
   launch for the prefill's LM head and 7 per decoder layer plus one per
   decode step, and K1 and K3 as in phase 9; the teacher-forced logits are
   held to LOGITS_REL_TOL against the same int4 tree through the plain path
   in fp32; then phase 9's timing, and the decode step against bf16's.
13. (Run with phases 2, 3, 8 and 10.)  K1 with the lse, K4 nc dK/dV and
   K4 nc dQ (the ViT attention backward, on the Hopper backward template
   ``attention_bwd_sm90.cuh``) against their twins at K1_SHAPES on qkv
   views with a random dO: outputs and gradients to the relative bound, a
   second launch of each K4 nc kernel bit-identical to the first, K1's
   output with the lse bit-equal to K1's without it, the lse to LSE_TOL;
   each with its bound and ``F.scaled_dot_product_attention`` (forward
   for K1, the whole backward for K4 nc) at the same shape.  Then K4 nc at
   (2, S, 16, 64) for S on each side of the template's tile edges
   (K4NC_EDGES), to the relative bound and bit-identical across two
   launches, and the pair timed in turns with SDPA's backward at serving's
   shape.
14. The reward gradient (after phase 11, on phase 4's bf16 scorer):
   ``score_fn`` of the single 8-frame clip and ``torch.autograd.grad`` to
   its pixels.  The score must equal ``score_batch``'s within SCORE_TOL,
   the gradient be finite and nonzero on every tile, and the launch
   counters show what remat gives: per ViT layer K1 with the lse twice
   (the forward, then the recompute) and K4 nc once; per decoder layer K2
   with the lse twice and K4a and K4b once.  The pixel gradient is held
   against fp32 plain autograd (the same weights through ``impl="plain"``)
   by relative L2 and cosine, to REWARD_GRAD_REL_L2 and REWARD_GRAD_COS.
   Prints ms per value-and-gradient and the peak memory.
15. The VADER loop (``mjvideo_tpu_torch/examples/vader_loop.py``) on the
   same weights: VADER_STEPS Adam steps of a 2-frame coarse field; the
   rewards must be finite and the launch counters as in phase 14 per step.
   Prints the reward per step, ms per step, the peak memory and the rise
   (reported, not held).
16. Fails if ``jax`` or any ``mjvideo_tpu`` module was imported, or a
   kernel of the main path never launched (phase 25's four D = 96 forms,
   phase 26's D = 80 and D = 96 forms and phase 27's D = 72 forms
   included; phases 31 and 32 count on the paths of K1, K2, K2 lse, K4a,
   K4b and the pre-pass); prints the card, the kernel summary line and, last, the
   contract line ``{"ok": true, "device": {...}}``.  Every phase that
   holds launch counts also holds one ``key_norm_max`` before each K1, K1m
   and K2 (with the lse or without).
17. (Run with phases 2, 3, 8, 10 and 13.)  The kernels of sequence
   parallelism at T = SP_T over SP_SHARDS shards (chunks of 768), B = 1,
   16/8 heads of 128, a ragged mask (the first 5 and the last 600 keys
   masked): K3 with the lse (the Hopper template's lse epilogue) on one
   shard's queries and one chunk's keys at each relative offset of
   SP_CHUNKS (-768: a later shard's chunk, every row dead; 0: the
   diagonal, its first 5 rows dead; 768 and 2,304: earlier shards'
   chunks), the output to the relative bound and bit-equal to K3's on the
   same inputs, the lse to LSE_TOL, dead rows exactly 0 and 1e30, and K3
   lse timed at the 768 chunk and at the long clip's 13,440-row chunk
   (LONG_CHUNK) with SDPA at each; K4a and K4b at the same offsets
   from the twin's merged (global) lse, masked keys' dk and dv and dead
   rows' dq exactly 0, a second launch bit-identical; K3 at the
   all-gather shape (768 queries over the 3,072 keys at q_offset 768 r, r
   in SP_GATHER_RANKS).  Each with its
   bound and ``F.scaled_dot_product_attention`` with an explicit boolean
   mask for the offset.
18. Sequence-parallel scoring (after phase 4, on its bf16 state):
   ``RewardScorer(sp="ring")`` and ``sp="allgather"`` with
   ``SequenceGroup.local(SP_SHARDS)`` answer phase 4's single clip and
   pair; the scores are held within SCORE_TOL of phase 4's and of its fp32
   plain scores, and the launches exactly: per request, per decoder layer
   SP_SHARDS**2 K3 with the lse under the ring and SP_SHARDS K3 under
   all-gather, no K2, and per ViT layer SP_SHARDS K1 (each shard's tiles).
   Prints ms per pair request and the peak memory beside phase 4's.
19. Sequence-parallel training (after phase 6, before phase 7): phase 6's
   micro-batch, its prompts padded to whole 64-row tiles of every shard,
   through a ``Trainer`` with ``sp="ring"`` and then ``"allgather"`` over
   ``SequenceGroup.local(SP_SHARDS)`` on phase 5's weights (accumulation
   2: the step only accumulates, and its buffer holds the gradient); the
   gradient is held against phase 6's fp32 plain gradient by
   FIDELITY_REL_L2 and FIDELITY_COS, the launches at what remat and the
   schedule give (per decoder layer and video the K3-lse forward twice,
   K4a and K4b once, for each of SP_SHARDS**2 ring steps or SP_SHARDS
   all-gather shards).
20. A long-context reading at full width (after phase 15): BASELINE
   config #4, LONG_FRAMES frames of LONG_TILES tiles (``max_num=12`` plus
   the thumbnail), seeded pixels made on the card, the ``ByteTokenizer``
   prompt (about 53.5k tokens) in a bucket of whole 64-row tiles per
   shard, scored once with ``sp="ring"`` over ``local(SP_SHARDS)`` and
   once without sequence parallelism; both scores finite and within
   SCORE_TOL of each other, launches exact; prints the ms and peak memory
   of each and the phase's command time on a line of its own.
21. (Run with phases 2, 3, 8, 10, 13 and 17, before the paths.)  The ViT
   attention variants of the JAX package's A/B harnesses at VARIANT_SHAPE
   bf16, q/k/v as strided views into one qkv tensor as in phase 2: B1 in
   each softmax mode, B2 at each hp it is built for and B3 (at 1025, and
   at VARIANT_PADDED with kv_valid 1025 and the k/v rows past it zero),
   each against its twin to KERNEL_REL_TOL of max|plain| with its bound
   and ``F.scaled_dot_product_attention`` at the same shape, and printed
   against K1's output (the Hopper template's); each, on that template
   too, with the device time of a launch (``torch.profiler``), and B3
   bit-equal to B2 at hp 1 on q, k and v cut at kv_valid.  Then the
   phase's path,
   the two harnesses, the
   counts set to 0 before each and held exactly after:
   ``tools/vit_attn_variants_torch.py`` (every kernel in turns,
   VARIANT_WINDOWS windows of VARIANT_LAUNCHES launches) and
   ``tools/vit_layout_ab_torch.py`` (one 2B ViT block, layer 0 of seeded
   bf16 weights, with K1, B3 at 1032 and at 1025, and B2 at the hp that
   checked fastest: one block held against K1's to BLOCK_REL_TOL, then
   BLOCK_CHAIN chained blocks BLOCK_REPS times and a profiler pass of 4).
   The summary line lists the three kernels with ``"on_main_path":
   false`` and their launches in this phase.
22. Serving from a checkpoint directory and from decoded frames (after
   phase 4, on its bf16 state; nothing in it is caught).  The checkpoint
   round trip: ``save_reward_checkpoint_dir`` writes the state (F32, as
   the JAX exporter writes it) into a temporary directory, printing the
   free disk space first and then the bytes and seconds written;
   ``load_reward_model`` reads it back to the card in bf16; every leaf is
   held bit-equal to phase 4's and phase 4's requests must score
   bit-equal to phase 4's scores; prints the load's seconds, its peak
   device memory above the state already held, and the process's host
   RSS before and after with its peak.  The frames path: FRAMES seeded
   uint8 frames of FRAME_HW per clip, ``RewardScorer(device_preprocess=
   True)`` at each ``device_max_num`` of FRAME_MAX_NUMS (8 and 72 tiles a
   clip: 1280x720 tiles as (4, 2) plus the thumbnail at 12), scoring one
   clip and a pair of ByteTokenizer prompts (at 12 in a bucket of whole
   1,024-token blocks, ~19.5k); per dispatch exactly 24 K1, 24 K2 and 48
   ``key_norm_max``; the scores held within SCORE_TOL of the same frames
   through the same preprocessing in fp32 with ``attn_impl="plain"``; the
   card's preprocessing (the resize, before the normalisation) within 1
   level of the CPU's on one clip, with the share of values that differ.
   Then the micro-batch sweep: SWEEP_CLIPS clips on the frames path at
   ``max_num`` 1 for each ``device_batch`` in SWEEP_BATCHES, clips/s (the
   median of SWEEP_REPS calls after the counted one), the launches per call
   and each setting's largest score difference from one forward.  Last,
   the bytes handed to the scorer and the ms per clip of the single clip
   on the frames path against phase 4's normalised pixels.  Phase 3 holds
   the K2 op at the frames path's largest decoder shape (the pre-pass
   against its twin, the op bit-equal to the kernel alone) and phase 2
   K1 at its largest ViT batch (FRAME_TILES_MAX tiles).
23. The benchmark harness and the two command-line entry points (after
   phase 22, on its checkpoint directory and phase 4's state; nothing in
   it is caught).  Prints whether cv2 and PIL import, then replaces the
   port's video decoding with a seeded source (``seeded_video_source``:
   the card's machine has neither): ``data.video``'s ``video_metadata``,
   ``decode_frames`` and ``load_video`` and ``data.dataset``'s
   ``load_video``, where they are looked up, restored at the phase's end;
   a video's frames are seeded from its path.  EVAL_PAIRS MJ-BENCH-VIDEO
   records (labels by the port's CRITERIA_NAMES and ASPECT_NAMES, overall
   preferences cycling through the four strings; FRAMES frames of
   FRAME_HW a clip).  ``eval/cli.main`` in bf16 with ``--byte-tokenizer
   --device-preprocess --max-num 1`` on phase 22's directory: the overall
   benchmark, the aspects benchmark, and the overall benchmark under
   ``--quant`` EVAL_QUANT; the results files' scores (and rewards and
   aspect scores) bit-equal to ``score_batch`` of phase 4's state on the
   same frames (quantized alike for the third), two pairs within SCORE_TOL
   of fp32 plain, exact launches per pair dispatch (24 K1, 24 K2, 48
   ``key_norm_max``; 170 K6 and 170 K6 pre-passes more when quantized),
   a resume from the overall results cut after EVAL_RESUME_CUT records and
   a torn line (24 K1 a remaining pair, the same metrics), pairs/s of the
   driver against ``score_pair`` on the same frames, the host's share of
   ``score_pair`` (the seeded decode and ``prepare_clip`` of a pair, timed
   alone), and each command's time.  ``evaluate_genai_bench`` on one row per vote type.  Phase 9's
   judge (``make_judge``) through ``run_overall_benchmark`` on
   JUDGE_DRIVER_PAIRS records and ``run_fine_grained_benchmark`` on one
   (the questions of FINE_GRAINED_CATEGORIES), exact launches, seconds.  ``train/cli.main`` at
   the 2B config from random init (stage 3, batch 1, 2 frames,
   TRAIN_CLI_STEPS micro-steps, ``--eval-json`` on the first
   TRAIN_CLI_EVAL_PAIRS records): finite losses, the eval record in
   ``metrics.jsonl``, ``Trainer.evaluate`` launching K1 and K2 and no lse
   form or backward, the free disk before the save and the bytes written.
24. MJ-VIDEO-4B (after phase 12, the earlier states freed): (a) K2 (the
   op, the kernel alone, its pre-pass to PREPASS_REL_TOL) at the 4B's
   D96_K2_SHAPES (32/32 heads of 96, phase 3's ragged mask and dead rows)
   and K3 at D96_K3_SHAPES (the pair's left-padded prefill, a decode step
   at an offset) and non-causal, each within KERNEL_REL_TOL of its twin,
   the op bit-equal to the kernel alone, two launches bit-identical, dead
   rows exactly 0, each with its bound; K2, the K2 op, K3 and the
   pre-pass in turns with SDPA.  (b) A 4B bf16 state drawn on the card
   from its own seeded generator; ``RewardScorer`` (the ``phi3-chat``
   gating pattern) on phase 4's requests with its own prompts: exact
   launches (24 K1, 32 K2 and 56 ``key_norm_max`` a forward), finite
   scores within SCORE_TOL of fp32 plain with S1's split (bf16 plain
   against fp32 plain, bf16 kernels against bf16 plain), a pair's time
   and the peak memory; the state written by the port's exporter as a
   Phi-3-layout F32 directory (the free disk checked first) and loaded
   back, leaves and scores bit-equal.  (c) ``eval/cli.main`` overall on
   that directory, EVAL_4B_PAIRS pairs of phase 23's seeded frames, the
   results bit-equal to ``score_batch`` of the same state; the directory
   is deleted.  (d) Phase 9's judge on ``internvl2_4b_chat_config`` with
   its decoder cut to JUDGE_4B_LLM_DEPTH layers (``judge_4b_config``;
   random bf16 weights with the 3072 x 32064 LM head): ``judge_pair``'s
   full prompt and the prefix path, exact launches (a K3 per decoder
   layer a forward),
   teacher-forced logits within LOGITS_REL_TOL of fp32 plain, its times.
25. MJ-VIDEO-4B's gradients and training (after phase 24, its states
   freed; the same 4B bf16 state from seed 0, on a generator of its own).
   (a) The D = 96 gradient forms at the 4B's shapes (32/32 heads of 96),
   on their own generator: K2 with the lse (the op and the kernel alone),
   K4a and K4b (from the twin's output and lse) at the training prompts'
   (1, T, 32/32, 96), every key live, and at the reward gradient's (1,
   3072) with the single clip's prompt live (``check_decoder_kernels``);
   K3 with the lse, K4a and K4b at phase 17's ring chunks (1, 768, 768,
   32/32, 96) at each relative offset of SP_CHUNKS, the first 5 keys
   masked (``check_ring_kernels``): each within KERNEL_REL_TOL of its
   twin, the lse within LSE_TOL, dead rows 0 and 1e30, dq 0 on dead rows,
   dk and dv 0 on masked keys, each lse form's output bit-equal to its
   form without the lse, two launches bit-identical; each with its bound
   and ``F.scaled_dot_product_attention`` (forward, or the whole
   backward); K4a/K4b with SDPA's backward, K2 lse (alone, the op) with K2
   and SDPA, and K3 lse at the 768 chunk with SDPA, in turns.  (b)
   ``score_fn`` of phase 24's single clip with ``torch.autograd.grad`` to
   its pixels (phase 14 at 4B): exact launches (per ViT layer K1 lse twice
   and K4 nc once; per decoder layer K2 lse twice, K4a and K4b once, at
   their D = 96 names too), the pixel gradient against fp32 plain autograd
   at REWARD_GRAD_REL_L2 and REWARD_GRAD_COS, ms per value-and-gradient
   and the peak memory.  (c) VADER_STEPS steps of the VADER loop on the
   4B scorer (phase 15): finite rewards, launches as in (b) per step, ms
   per step and the peak memory.  (d) Training on the same weights, the
   4B config rebased on the ``ByteTokenizer``, TRAIN_MICRO_BATCHES
   micro-batches of ``phi3-chat`` prompts: one micro-batch's trainable
   gradient, bf16 kernels against fp32 plain autograd at FIDELITY_REL_L2
   and FIDELITY_COS, with S1's split (bf16 plain against fp32 plain, the
   kernels against bf16 plain) printed first (a miss that bf16 plain
   alone shares is printed and recorded as a standing failure, ROADMAP
   Queue 3 F5, unless the kernels add more than the bars to bf16 plain's
   reading, which raises); the ring micro-batch (phase 19's
   ``sp="ring"`` over ``local(SP_SHARDS)``) against the same fp32
   gradient at the same bars and rule, launches exact (per decoder layer,
   video and ring step K3 lse at D = 96 twice, K4a and K4b once); the
   fp32 copy freed, a stage-3 ``Trainer`` with phase 5's ``TrainConfig``
   on the micro-batches (2 optimizer steps): finite losses and grad
   norms, frozen tensors bit-identical, each trainable subtree changed,
   per micro-batch and video 24 K1, 64 K2 lse, 32 K4a and 32 K4b; then as
   many micro-steps timed (medians of those that accumulate and of those
   that also step) and the peak memory.  Prints its command time.
26. The Qwen2-VL judge and the forms it and the 4B judge's per-row bound
   need (after phase 25, its states freed; nothing caught).  (a) On a
   generator of its own: K1 at the Qwen2-VL vision tower's D = 80
   (QWEN_K1_SHAPES, q/k/v views into one qkv tensor: the op, the kernel
   alone and the pre-pass ``key_norm_max`` at 16 lanes a key) against their
   twins, the op bit-equal to the kernel alone; K2r and its pre-pass
   ``key_norm_cummax`` at D = 96 on phase 3's ragged inputs at
   D96_K2_SHAPES (the op, the kernel alone, two launches bit-identical,
   dead rows 0, kcum's last column ``key_norm_max``'s) and at the judge's
   prefix and continuation shapes at 32/32 heads (``check_judge_kernels``);
   K3 and K2r at the Qwen2-VL 2B's 12/2 and the 7B's 28/4 decoder heads at
   the Qwen judge's shapes (its right-padded pair prefill, one video's
   prefix and the continuation at the prefix length; the lengths from its
   prompts).  Each within KERNEL_REL_TOL of its twin (the pre-passes
   within PREPASS_REL_TOL), each with its bound and SDPA.  (b) Phase 24's
   4B judge (its state from a fresh generator at SEED) under
   ``_CACHE_BOUND = "rows"`` (MJV_CACHE_NORM_BOUND=1): the short question
   by the prefix path, exact launches (per video 24 K1 after their
   pre-passes; JUDGE_4B_LLM_DEPTH K2r after theirs per prefix prefill or
   continuation, at their D = 96 names too; none in decode),
   teacher-forced logits within
   LOGITS_REL_TOL of fp32 plain.  (c) ``Qwen2VLJudge`` on Qwen2-VL-2B at
   full width (vision 32 x 1280, 16 heads of 80; text 1536 wide, 12/2
   heads of 128, cut to QWEN_LLM_DEPTH of its 28 layers; vocabulary
   151,936, tied), random bf16 weights from a
   fresh generator at SEED, seeded 8-frame patches of QWEN_GRID through a
   subclass's ``_encode_video`` (no cv2 or PIL needed): ``judge_pair``
   with the overall prompt (the full prompt) and the short question (the
   prefix path), exact launches (per video encoded 32 K1 after their
   pre-passes, at their D = 80 names too; a K3 per decoder layer and
   prefill or continuation; none in decode), teacher-forced logits of
   both paths within LOGITS_REL_TOL of the same weights in fp32 through
   ``impl="plain"``; vision ms a video, the pair's prefill ms, ms a decode
   step at B = 2, answers/s by each path and the peak memory.  (d) The 2B's
   widths at QWEN_CLI_DEPTH, written by the port's writer as an HF
   Qwen2-VL directory; ``eval/cli.main --judge qwen2-vl --byte-tokenizer``
   overall on QWEN_CLI_PAIRS pairs, every results row equal to (c)'s judge
   on the state read back (bit-equal), exact launches.  Prints its command
   time.
27. SigLIP-so400m's attention and the two judges built on it (after phase
   26, its states freed; nothing caught).  (a) On a generator of its own:
   K1 at D = 72 (SIGLIP_K1_SHAPES: VideoScore's 16 frames of 39 x 70
   patches, MiniCPM-V's 8 of 24 x 43, a 980 px frame's 70 x 70 past JAX's
   4,096-key nc limit; q/k/v views into one qkv tensor: the op, the kernel
   alone and the pre-pass at 16 lanes a key) against their twins, the op
   bit-equal to the kernel alone.  (b) K1m, the masked non-causal form, at
   (20, 2730, 16, 72) under the patch mask of 4 frames split into 5 images
   (4 quadrants at VS_QUADRANT_HW, the original at VS_HW, padded to VS_HW):
   the op, the kernel alone and the masked pre-pass against their twins,
   SDPA with the boolean key mask as the yardstick.  Each within
   KERNEL_REL_TOL (the pre-passes PREPASS_REL_TOL).  (c) VideoScore at full
   dims (SigLIP 27 x 1152, 16 heads of 72, MLP 4304; the perceiver 3
   layers of 64 latents, 16/4 heads of 96; Mistral-7B 32 x 4096, 32/8 of
   128, vocabulary 32,003; 5 labels), random bf16 weights from a fresh
   generator at SEED: a 16-frame clip of seeded pixels at VS_HW through
   ``VideoScoreJudge.score_frames`` with ``WordTokenizer``'s prompt (1,024
   image tokens, the 1,536 bucket): exact launches (27 K1, 32 K2, each
   after its pre-pass), the 5 logits within LOGITS_REL_TOL of max|logit| of
   fp32 plain, with S1's split (bf16 plain against fp32 plain, the kernels
   against bf16 plain), the aggregate, ms a clip and the peak; then
   ``do_image_splitting`` on 4 frames (27 K1m), held alike.  (d)
   ``MiniCPMVJudge`` on MiniCPM-V-2.6 at full dims (SigLIP at 980; the
   resampler of 64 queries, 28 heads of 128; Qwen2-7B 3584 wide, 28/4
   heads, MLP 18944, vocabulary 151,666, with biases, cut to
   MCPM_LLM_DEPTH of its 28 layers), bf16 from a fresh
   generator at SEED, a pair of seeded 8-frame videos at MCPM_HW (1,032
   patches, 64 tokens a frame): ``judge_pair`` with the overall prompt (the
   full prompt) and the short question (the prefix path), 64 greedy
   tokens, exact launches (per video 27 K1; a K3 per decoder layer and
   prefill or continuation; none in decode), teacher-forced logits of
   both paths within LOGITS_REL_TOL of fp32 plain; vision ms a video,
   prefill ms, ms a decode step at B = 2, answers/s and the peak.  (e)
   ``eval/cli.main --judge videoscore`` and ``--judge minicpm-v`` with
   ``--byte-tokenizer`` on small-depth directories at full width (VS_CLI_DEPTH, MCPM_CLI_DEPTH)
   of the published names (``write_hf_dir``), on ``seeded_video_source``'s
   1280 x 720 frames: every results row equal to the port's judge built as
   the CLI builds it, exact launches.  Prints its command time.
28. CogVLM2-Video (after phase 27, its states freed; nothing caught).
   (a) On a generator of its own: K3 not causal at the EVA2-CLIP-E tower's
   D = 112 (COG_K3_SHAPES: a video's 8 frames of 257 tokens, the last key
   tile one live key, and whole tiles; q/k/v views into one qkv tensor)
   against its twin within KERNEL_REL_TOL, two launches bit-identical,
   then the kernel, SDPA and the twin in turns by CUDA events and the
   kernel's device time.  (b) ``CogVLM2Judge`` at full dims (EVA2-CLIP-E
   63 x 1792, 16 heads of 112, MLP 15,360; the GLU adapter to 4096 /
   14,336; Llama-3-8B 4096 wide, 32/8 heads of 128, two experts a layer,
   vocabulary 128,256: 19.49 B parameters; the decoder cut to
   COG_LLM_DEPTH of its 32 layers), random bf16 weights drawn a
   layer at a time from a fresh generator at SEED, a pair of seeded
   8-frame videos at 224 px (66 tokens a frame) through a subclass's
   ``_encode_video``: ``judge_pair`` with the overall prompt (the full
   prompt) and the short question (the prefix path), 64 greedy tokens,
   exact launches (per video 63 K3 at D = 112; a K3 per decoder layer and
   prefill or continuation; none in decode); the tower and adapter's output (fp32
   activations, bf16 product inputs, as the JAX judge's fp32 pixels make
   them) and the teacher-forced logits of both paths, end to end and with
   the tower's output shared (the decoder alone), within LOGITS_REL_TOL of
   fp32 plain (``cogvlm2_fidelity``, ``cogvlm2_held``), taken at full depth on the bf16 state itself (fp32 activations
   through ``impl="plain"``: each product promotes one weight at a time,
   as an fp32 copy of the 36.3 GiB state would not fit beside it), with
   S1's split (bf16 plain against fp32 plain); the tower's ms a video, the
   pair's prefill ms, ms a decode step at B = 2, answers/s by each path and
   the peak.  (c) ``eval/cli.main --judge cogvlm2 --byte-tokenizer`` on a
   THUDM-named directory at full width and COG_CLI_DEPTH written by the
   port's exporter, on ``seeded_video_source``'s frames: every results row
   equal to the port's judge built as the CLI builds it, exact launches.
   Prints its command time.
29. InternVL2-26B and -8B (after phase 28, its states freed; nothing
   caught).  (a) On a generator of its own: K1 at InternViT-6B's D = 128
   with 25 heads (IVL_K1_SHAPES: a video's 8 tiles of 1025 tokens and 2;
   q and k dense, as QK-RMSNorm makes them, v a view into the qkv tensor):
   the op, the kernel alone and the pre-pass against their twins (within
   KERNEL_REL_TOL and PREPASS_REL_TOL), the op bit-equal to the kernel
   alone and a second launch bit-identical; the op, the kernel alone, SDPA
   and the twin in turns by CUDA events, and the device times.  (b)
   ``InternVLJudge`` on InternVL2-26B at full width (InternViT-6B 45 x
   3200, 25 heads of 128, RMSNorm and QK-RMSNorm, MLP 12,800; ``mlp1``
   12,800 -> 6144; InternLM2-chat-20B 6144 wide, 48/8 heads of 128, MLP
   16,384, vocabulary 92,553, cut to IVL_26B_LLM_DEPTH of its 48 layers:
   25.5 B parameters at full depth), random bf16 weights drawn a
   layer at a time from a fresh generator at SEED
   (``init_chat_params_by_layer``), a pair of seeded 8-frame videos at
   448 px through ``make_judge``'s subclass: ``judge_pair`` with the
   overall prompt (the full prompt), the short question by the prefix
   path, and again under ``_CACHE_BOUND = "rows"``, 64 greedy tokens,
   exact launches (per video 45 K1 at D = 128 after their pre-passes;
   IVL_26B_LLM_DEPTH K3 per prefill or continuation, K2r and its pre-pass
   in their place
   under "rows"; none in decode, no K2); the tower and ``mlp1``'s output
   and the teacher-forced logits of the three paths against fp32 plain on
   the bf16 state itself (fp32 pixels and token table through
   ``impl="plain"``: each product promotes one weight at a time), with
   S1's split (bf16 plain against fp32 plain), each within LOGITS_REL_TOL,
   or a standing failure where bf16 plain alone misses it and the kernels
   add no more than the bar (``ivl_held``; the rows path teacher-forced on
   the prefix path's tokens); the tower's ms a video, the pair's prefill
   ms, ms a decode step at B = 2, answers/s by each path and the peak.
   (c) Phase 9's checks on InternVL2-8B at full width (InternViT-300M;
   InternLM2.5-7B 4096 wide, 32/8 heads of 128, cut to IVL_8B_LLM_DEPTH
   of its 32 layers): ``judge_phase`` without its times, per video 24 K1
   at D = 64, IVL_8B_LLM_DEPTH K3 per prefill.  (d)
   ``eval/cli.main --judge internvl-chat --byte-tokenizer`` on an
   InternVL2-26B-layout directory at full width and IVL_CLI_DEPTH written
   by the port's exporter, on ``seeded_video_source``'s frames: every
   results row equal to the port's judge built as the CLI builds it, exact
   launches.  Prints its command time.
30. The training options (after phase 29, its states freed; nothing
   caught), on phase 5's 2B weights (a fresh generator at SEED) and
   micro-batches.  (a) One value-and-gradient of the first micro-batch
   over stage 3's trainable tensors and the ViT's layer stack (so the ViT
   is recorded: K1 with the lse, K4 nc) under ``remat`` False, True and
   "dots": the loss and every gradient bit-equal across the three, exact
   launches (the attention's forward twice under True and "dots"), the
   peak memory above the state, the time by CUDA events and the device
   time.  (b) DropPath and dropout at NOISE_DROP_PATH and NOISE_DROPOUT:
   the gradient under ``remat=True`` bit-equal to the one under
   ``remat=False`` at the same step's ``NoiseKey`` (the recompute drew the
   same masks), the next step's key another loss, and the tower sharded
   over a local 2-member group drawing the whole tower's masks, tile by
   global tile, its embeds within KERNEL_REL_TOL.  (c) OPT_STEPS
   ``Trainer`` micro-steps with AdamW, AdamW with bf16 mu and Adafactor on
   the kernel path (exact launches) and on the fp32 copy through the plain
   path: each step's loss within OPT_LOSS_REL_TOL, the update at cosine
   OPT_UPDATE_COS or more, frozen tensors unchanged, each state's bytes.
   (d) ``async_checkpoint=True`` with a save every micro-step, ASYNC_KEEP
   kept, at full width ASYNC_DEPTH deep: after ``train()`` returns each
   kept file reloads bit-equal to a blocking run's; the time a micro-step,
   async against blocking.  Prints its command time.
31. LoRA and QLoRA training (after phase 30, its states freed; nothing
   caught), on phase 5's 2B weights (a fresh generator at SEED) and
   micro-batches, ``TrainConfig(lora_rank=LORA_RANK)`` on phase 5's
   config: the decoder's attention and MLP kernels wrapped in LoRA nodes.
   (a) The wrapped forward bit-equal to the unwrapped one (``b`` = 0); the
   adapter and trainable parameter counts and the optimizer state's bytes.
   (b) 4 micro-steps under phase 5's checks (finite losses, 2 optimizer
   steps, every frozen tensor, each ``.w`` and the ViT's included,
   bit-identical, each trainable subtree moved, exact launches: per
   micro-batch and video 24 K1, 48 K2 lse, 24 K4a, 24 K4b, no K1 lse and
   no K4 nc), every layer's ``b`` moved and every layer's ``a`` by the
   second optimizer step.  (f) The single clip scored through the LoRA
   state (exact serving launches) and through ``merge_lora``'s, within
   SCORE_TOL.  (c) Every ``b`` drawn nonzero from a generator of its own
   (N(0, LORA_B_STD^2)), the adapters' and heads' gradient of one
   micro-batch, bf16 kernels against fp32 plain with S1's split, held to
   FIDELITY_REL_L2 and FIDELITY_COS under F5's rule (``gradient_split``);
   bf16 plain runs the adapters through the same ``product_f32`` as the
   kernels, so that product is held apart: at the first layer's base,
   ``a`` and ``b``, its output and both input gradients on bf16 operands
   against fp32 autograd of the upcast values, within
   PRODUCT_F32_FWD_REL and PRODUCT_F32_BWD_REL (``product_f32_check``).
   (d) For each of LORA_QUANT_MODES, fresh bf16 weights quantized on the
   card and wrapped: the loss against the same tree in fp32 plain within
   OPT_LOSS_REL_TOL, the decoder's frozen bases' bytes against bf16's, and
   2 micro-steps under phase 5's checks (the quantized fields
   bit-identical, no K5 under autograd).  (e) The ``int4-wo`` run: a third
   micro-step, an async save, a fourth micro-step while it is written,
   then a fresh trainer's ``resume_latest``: every tensor of the saved
   step bit-equal with its dtype and stride, the nodes kept (``Q4Kernel``
   bases, packed k-major), and the fourth micro-step bit-equal to the
   unbroken run's.  Prints its command time.  ``tools/phase31_torch.py``
   runs it alone and times a LoRA micro-step against a full stage-3 one
   on the same weights.
32. The serving example (after phase 23, on phase 22's checkpoint
   directory and phase 4's state; nothing caught): ``python -m
   mjvideo_tpu_torch.examples.serve --byte-tokenizer`` (its ``main``) over
   SERVE_CLIPS seeded clips (``seeded_video_source``, four decode
   workers), then with ``--trace-dir`` over SERVE_TRACED others (traced
   by ``utils.profiling.trace``): every JSONL score of both runs
   bit-equal to ``score_video`` of phase 4's state
   through a scorer built as the example builds it, exact launches (24 K1
   and 24 K2 a clip, each after its pre-pass), the trace naming K1 and K2
   (and the pre-pass) as often as the traced clips launched them, and
   ``Throughput``'s clips/s beside the command's wall time.
34. The judges on a (data, model) mesh on one card (after phase 33, on
   fresh states; nothing caught; ``tools/phase34_torch.py`` runs it
   alone).  (a) Each kernel at a model rank's head counts against its
   twin: K1 at D = 64, 72, 80 and 128 (8, 8, 8 and 5 heads), K1m at 8 of
   SigLIP's heads, K3 not causal at D = 112 (8 heads), K3 at the judge
   decoders' rank heads (8/4, 14/2, 24/4, 16/4) at the pair prefill and
   the suffix continuation, K2r with its pre-pass at 8/4 over a prefix,
   K5 at the 2B's projections cut over 2 ranks and its whole LM head.
   (b) The InternVL2-2B judge at all 24 layers at ``local(1, 2)`` and
   ``(2, 2)`` with the dense and the int8 KV cache, and ``int4-wo`` at
   ``(1, 2)``; (c) MiniCPM-V-2.6, CogVLM2-Video, Qwen2-VL-2B (each by the
   prefix path) and VideoScore (split frames, K1m) at ``(1, 2)``, at full
   width and MESH_JUDGE_DEPTHS; (d) InternVL2-26B with its tower on
   ``local(1, 5)`` (25 heads, 5 a rank, the QK-norm across ranks) and its
   decoder on ``(1, 2)``.  Each meshed judge answers the pair (launches
   exact), its tokens against the unsharded judge's (where they part,
   the unsharded top-two gap there beside the logit delta), its
   teacher-forced logits over MESH_FORCED_STEPS against fp32 plain
   (LOGITS_REL_TOL) and against the unsharded run, a pair's seconds and a
   decode step's ms beside the unsharded judge's.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

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
# Phase 14's single clip, whose prompt sets the reward gradient's K2-lse
# mask in phase 3.
SINGLE_CAPTION = "A red fox runs through fresh snow at dawn."
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
# At 4B (phase 25) the same bars hold; where bf16 arithmetic alone (bf16
# plain against fp32 plain, no kernel) misses them, a miss by the kernels
# is a standing failure (ROADMAP Queue 3 F5), printed and recorded, unless
# the kernels add more than the bars to bf16's own reading (relative L2
# over it by more than FIDELITY_REL_L2, or cosine under it by more than 1 -
# FIDELITY_COS): that is a kernel fault and raises.
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
# A judge's warm pair is timed once by each path: a pair takes seconds of
# host-bound decode steps (three a path would cost about 90 s of the
# script's time limit over its judges), and a decode step's own time is
# the median of its timed loops.
PAIR_REPS = 1
# Teacher-forced per-step logits of each judge path, bf16 kernels against
# fp32 plain on the same tokens: max|delta| / max|plain logit|.  Set from
# the seed survey (PERF.md section 6).
LOGITS_REL_TOL = 1.5e-1
# The card's published peaks at 700 W (NVIDIA's H100 SXM data sheet): the
# least time of a kernel's work is the larger of its bytes over the memory
# rate and its operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12     # outside the tensor cores
# The bound pre-passes against their twins, max|delta| over max|plain|:
# K1's and K2's (key_norm_max) and K2r's (key_norm_cummax, the running max
# of masked key norms) sum the squares exactly in double, which the twins'
# fp32 sums in torch's order lie within about an ulp of.
PREPASS_REL_TOL = 1e-6
# The kernels of the Hopper templates (decoder_attention_sm90.cuh, namespace
# mjv::attention_sm90; attention_bwd_sm90.cuh, mjv::attention_bwd_sm90;
# q8g_matmul.cu, mjv::q8g_sm90) and the bound pre-passes, as ptxas names
# them: their registers and spills are printed.  The forward template has 5
# instantiations (K3 causal and not, with the lse or without; K2r; K2 with
# the lse or without; K1 likewise), the backward 10 (K4 nc dK/dV and dQ
# at D = 64; K4a dK/dV and K4b dQ at D = 128 and at D = 96, each causal and
# non-causal),
# the key-norm partial pass 3 (key_norm_max's at D = 64 and 128, and
# key_norm_cummax's, which also stores each key's norm), key_norm_max's
# fold 1, key_norm_cummax's scan 1, the int8 GEMM 2 (bf16 or fp32 out) and
# K6's pre-pass 1.  Phase 26's forms add 4: K1 at D = 80, K2r at D = 96,
# and the partial pass at D = 80 and with the norms at D = 96.
SM90_KERNELS = ("attention_sm90", "attention_bwd_sm90", "q8g_sm90",
                "key_norm_scan_kernel", "key_norm_partial_kernel",
                "key_norm_fold_kernel")
# The forward template's 14 main-path instantiations (the 5 above; at
# Phi-3's D = 96 K2 and K3 causal and not, each with the lse or without,
# and K2r; at the Qwen2-VL tower's D = 80 K1; at SigLIP's D = 72 K1 and
# K1m; at the EVA2-CLIP-E tower's D = 112 K3 not causal; at InternViT-6B's
# D = 128 K1) and B1's 4 and B2's 3 (B3 is B2's hp 1), the backward
# template's 10, the pre-passes' 9 (the partial pass at D = 64, 72, 80, 96
# and 128 and with the norms at 128 and 96, the fold and the scan), the
# int8 GEMM's 2 and K6's pre-pass 1.
SM90_INSTANTIATIONS = 43
# Phase 13's K4 nc tile edges: S on each side of the 64-row q tiles and the
# 128 keys a dK/dV CTA holds, and of the 192 q rows a dQ CTA holds.
K4NC_EDGES = (63, 64, 65, 127, 128, 129, 191, 192, 193)
# K6 and K7 at the 2B's grouped w8a8 products, (M, K, N) with g = 128: the
# ViT's fc1 over a pair's 16 tiles of 1,025 tokens, the decoder's w1 and w2
# over a pair in the 3,072 bucket, a decoder wq over one 2,333-token prompt
# (an M tail), and the LM head's odd N at a pair's decode rows.
Q8G_SHAPES = ((16400, 1024, 4096), (6144, 2048, 8192), (6144, 8192, 2048),
              (2333, 2048, 2048), (2, 2048, 92553))
Q8G_GROUP = 128
# K5 at a decode step's (K, N): the decoder's wk/wv, wq/wo, w1/w3 and w2
# and the LM head, each at M = 1, 2 (the judge's pair), 8 and 32 rows.
# W4_OWN_SHAPES and W4_OWN_ROWS draw from a generator of their own, so that
# the other entries and the checks after them draw what they drew before.
W4_SHAPES = ((2048, 1024), (2048, 2048), (2048, 8192), (8192, 2048),
             (2048, 92553))
W4_ROWS = (1, 2, 8, 32)
W4_OWN_SHAPES = ((2048, 1024),)
W4_OWN_ROWS = (8,)
W4_GROUP = 128
# A GEMV's device time is timed over copies of its weight totalling more
# than this, so that every launch finds its weight out of the 50 MB L2, as
# in a decode step.
COLD_L2_BYTES = 100 * 2 ** 20
# Quantized serving: the scorer in the grouped mode whose score delta the
# JAX package states (0.0068 at full 2B dims, mjvideo_tpu/eval/scorer.py)
# and in per-column int8, and the judge in int4 weight-only.
SCORE_QUANT_MODES = ("int8-noattn-g128", "int8")
# Quantized scores, bf16 kernels against the same quantized tree through
# the plain path in fp32.  Each run-time activation quantization rounds a
# bf16 and an fp32 activation apart wherever they straddle a half step, so
# the two paths differ by the quantization noise itself, not by bf16
# noise: int8-noattn-g128 read 1.94e-2 on an H100 (and 7.65e-3 against the
# unquantized fp32 scores).  K6's check, bit-equal to its twin, is the
# guard of the kernel; this bar catches a wrong route or tree.
QUANT_SCORE_TOL = 5e-2
JUDGE_QUANT_MODE = "int4-wo"
# The reward gradient to the pixels of the single 8-frame clip (phase 14),
# bf16 kernels against fp32 plain autograd: relative L2 error and cosine.
# About 2.4x the largest H100 reading over weight seeds 0-3 (4.90e-2 to
# 5.36e-2, cosine at least 0.99857; tools/reward_grad_survey.py).  bf16
# through the plain path, with no kernel, reads 4.77e-2 to 5.26e-2: the
# error is bf16's own.  A K4 nc dQ planted to drop delta moves the reading
# by 1e-4 only; its per-kernel check (phase 13) fails at 0.37 of
# max|plain| (PERF.md section 6).
REWARD_GRAD_REL_L2 = 0.13
REWARD_GRAD_COS = 0.995
VADER_STEPS = 4
VADER_FRAMES = 2           # the example's defaults: 2 frames, a 16 x 16
VADER_COARSE = 16          # field, lr 0.05, one 4,096 bucket
VADER_LR = 0.05
VADER_CAPTION = "a bright colorful scene"
# Sequence parallelism: the shards of the local group, the ring kernels'
# sequence (the 3,072 bucket), the (my shard, the chunk's shard) pairs of
# phase 17 (relative offsets -768, 0, 768 and 2,304) and the all-gather
# shards it checks.
SP_SHARDS = 4
SP_T = 3072
SP_CHUNKS = ((0, 1), (0, 0), (1, 0), (3, 0))
SP_GATHER_RANKS = (1, 3)
# K3 lse at the ring chunk of phase 20's long clip: 53,760 tokens (its
# bucket) over SP_SHARDS shards, an earlier shard's chunk (every key seen).
LONG_CHUNK = 53760 // SP_SHARDS
# BASELINE.json config #4, high-res long context: 16 frames of
# max_num = 12 tiles plus the thumbnail.
LONG_FRAMES = 16
LONG_TILES = 13
# Phase 20's decoder without sequence parallelism: the clip's bucket and
# its prompt's live keys (phase 20 holds its prompt to this length), where
# phase 3 holds the K2 op to the kernel alone.
LONG_KEYS = (53760, 53722)
LONG_CAPTION = ("A hot-air balloon rises over a patchwork of green fields "
                "at sunrise while its shadow slides across a river.")
# Phase 21: the ViT attention variants at serving's ViT shape, B3 also
# pre-padded to a multiple of 8 as the JAX ViT pads; the attention A/B's
# windows and the block A/B's chain.
VARIANT_SHAPE = K1_SHAPES[0]
VARIANT_PADDED = 1032
VARIANT_LAUNCHES = 5
VARIANT_WINDOWS = 3
BLOCK_CHAIN = 24
BLOCK_REPS = 3
# One ViT block with a variant's attention against the block with K1, on
# the same x: max|delta| / max|block(x) - x|, about 4x the H100 reading
# (7.2e-3 for each variant).  The attention outputs differ in bf16 rounding
# only (each held to KERNEL_REL_TOL above); this bar catches a block that
# took a wrong route or lost rows.
BLOCK_REL_TOL = 2 ** -5
# Phase 22: decoded frames of 1280x720 (height, width), scored with the
# device's preprocessing at one tile a frame and at max_num 12 (a (4, 2)
# grid plus the thumbnail: 72 tiles a clip of FRAMES frames, 144 a pair);
# prompts past 3,072 tokens take a bucket of whole 1,024-token blocks.
FRAME_HW = (720, 1280)
FRAME_MAX_NUMS = (1, 12)
FRAME_TILES_MAX = 2 * FRAMES * 9
FRAME_BUCKET_UNIT = 1024
FRAME_CAPTIONS = ("A red fox runs through fresh snow at dawn.",
                  "Two kittens chase a ball of yarn across a wooden floor.",
                  "A sailboat drifts past a lighthouse while gulls circle "
                  "overhead and waves break on the rocks below.")
# The micro-batch sweep: clips a call, the device_batch settings, and the
# timed calls of each after the call whose launches are counted.
SWEEP_CLIPS = 8
SWEEP_BATCHES = (1, 2, 4, 8)
SWEEP_REPS = 3
# Phase 23: the seeded video source's frame count and rate, the records,
# the cut of the resumed results file, the quantized mode, the judge's
# records, and the training CLI's micro-steps and eval records.
SEEDED_VIDEO_FRAMES = 48
SEEDED_VIDEO_FPS = 8.0
EVAL_PAIRS = 8
EVAL_PREFERENCES = ("Video 1 better", "Video 2 better", "Same",
                    "Hard to judge")
EVAL_RESUME_CUT = 5
EVAL_QUANT = "int8-noattn-g128"
EVAL_PLAIN_PAIRS = 2
GENAI_VOTES = ("leftvote", "rightvote", "tievote", "bothbad_vote")
JUDGE_DRIVER_PAIRS = 2
# The fine-grained benchmark's rubric in phase 23: one category (its prompt
# and its 5 subcategories' prompts, 6 questions at about 3 s each) of the
# rubric's 33 questions, a cut of depth that keeps the whole script near
# half its time limit; every question takes the same full-prompt path.
FINE_GRAINED_CATEGORIES = ("Alignment",)
TRAIN_CLI_STEPS = 2
TRAIN_CLI_EVAL_PAIRS = 4

# Phase 24: MJ-VIDEO-4B (InternViT-300M and Phi-3-mini: 32 layers of 3072,
# 32/32 heads of 96).  K2 and its pre-pass at the 2,304 and 3,072 buckets
# with phase 3's ragged mask and dead rows; K3 at the judge's pair prefill
# (left-padded), at a decode step (one query at the cache's slot 3,000)
# and non-causal over the prefill's keys; the CLI's pairs.
D96_K2_SHAPES = ((2, 2304, 32, 32, 96), (2, 3072, 32, 32, 96))
D96_K3_SHAPES = {"prefill": (2, 3072, 3072, 32, 32, 96, None),
                 "decode step": (2, 1, 3072, 32, 32, 96, 3000)}
EVAL_4B_PAIRS = 2
# Phases 24 and 26 run the InternVL2-4B judge at its widths with its Phi-3
# decoder cut to 8 of 32 layers (16 before phase 33 was added), for the
# script's time limit (the 4B's scoring, reward gradient and training keep
# all 32).
JUDGE_4B_LLM_DEPTH = 8
# Phase 26: the Qwen2-VL judge.  Its vision tower's K1 at D = 80 over the
# temporal slabs of 8 frames at 364 px (a (4, 26, 26) grid: 676 patches a
# slab) and at 280 x 504 (720); K2r at D = 96 at the 4B's 32/32 heads on
# phase 3's ragged inputs and at the judge's shapes; K3 and K2r at the
# Qwen2-VL 2B's 12/2 decoder heads and the 7B's 28/4 (groups of 6 and 7)
# at the Qwen judge's own shapes (its right-padded pair prefill, one
# video's prefix and the suffix continuation; lengths from the prompts).
QWEN_GRID = (4, 26, 26)
QWEN_K1_SHAPES = ((4, 676, 16, 80), (4, 720, 16, 80))
QWEN_HEADS = {"2B": (12, 2), "7B": (28, 4)}
# The CLI's checkpoint: the 2B's widths at this depth (vision, text).
QWEN_CLI_DEPTH = (4, 4)
QWEN_CLI_PAIRS = 2
QWEN_DECODE_STEPS = 16  # decode steps timed at B = 2, by difference
# Phase 27: K1 at SigLIP-so400m's D = 72 at VideoScore's 16 frames of 39 x
# 70 patches (a 1280 x 720 frame resized to 551 x 980), MiniCPM-V's pair of
# 8 frames of 24 x 43 (602 x 336) and a 980 x 980 frame's 70 x 70 (past
# JAX's 4,096-key nc limit); K1m at 4 frames split into 5 images each.
SIGLIP_K1_SHAPES = ((16, 2730, 16, 72), (8, 1032, 16, 72), (1, 4900, 16, 72))
VS_FRAMES = 16
VS_HW = (551, 980)          # idefics2_resize_shape(720, 1280)
VS_QUADRANT_HW = (378, 640)  # idefics2_resize_shape(360, 640)
VS_SPLIT_FRAMES = 4
VS_TIMED = 3
MCPM_FRAMES = 8
MCPM_HW = (336, 602)        # find_best_resize(1280, 720), (H, W)
MCPM_DECODE_STEPS = 16      # decode steps timed at B = 2, by difference
# The CLI's small-depth directories: (SigLIP, perceiver, Mistral) layers of
# VideoScore, (SigLIP, Qwen2) of MiniCPM-V, at full width.
VS_CLI_DEPTH = (2, 1, 2)
MCPM_CLI_DEPTH = (2, 2)
SIGLIP_CLI_PAIRS = 1
# Phase 28: K3 not causal at the EVA2-CLIP-E tower's D = 112 at a video's 8
# frames of 257 tokens (224 px / 14, and cls) and at whole 128-row and
# 128-key tiles; the CogVLM2-Video judge on 8 frames a video, its CLI at
# full width and this (EVA, text) depth.
COG_K3_SHAPES = ((8, 257, 16, 112), (2, 1024, 16, 112))
COG_FRAMES = 8
COG_DECODE_STEPS = 16  # decode steps timed at B = 2, by difference
COG_CLI_DEPTH = (2, 2)
COG_CLI_PAIRS = 1
# For the 1200 s limit phase 34 cut the judge's Llama-3-8B decoder to
# COG_LLM_DEPTH of its 32 layers (its EVA tower stays whole): F7's
# readings at all 32 layers are PERF.md's (PRs 24 and 28).
COG_LLM_DEPTH = 16
# Phase 29: K1 at InternViT-6B's D = 128 with 25 heads at a video's 8 tiles
# of 1025 tokens and at 2 (q and k dense after QK-RMSNorm, v a view into
# qkv); the InternVL2-26B and -8B judges; the CLI on a 26B-layout directory
# at IVL_CLI_DEPTH (tower layers, LM layers).
IVL_K1_SHAPES = ((8, 1025, 25, 128), (2, 1025, 25, 128))
IVL_CLI_DEPTH = (2, 2)
IVL_CLI_PAIRS = 1
# For the 1200 s limit, phase 29 (b) runs the 26B judge with its
# InternLM2-chat-20B decoder cut to IVL_26B_LLM_DEPTH of its 48 layers (the
# InternViT-6B tower, K1 at D = 128, stays whole) and (c) the 8B judge's
# checks with its InternLM2.5-7B decoder cut to IVL_8B_LLM_DEPTH of 32 (the
# checks read K1 at D = 64 and K3 at the 8B's widths; depth only repeats
# them).  Phases 31 and 32 took the 26B from 24 layers to 16, phase 34
# both from 16 to 8.
IVL_26B_LLM_DEPTH = 8
IVL_8B_LLM_DEPTH = 8
# For the same limit, phases 31 and 32 also cut the decoders of phase 26's
# Qwen2-VL-2B judge (28 layers) and phase 27's MiniCPM-V-2.6 judge
# (Qwen2-7B, 28) to 14, and phase 34 to these depths; their vision towers
# stay whole, and the CLI phases keep their own depths.  Phase 28's
# CogVLM2-Video judge runs COG_LLM_DEPTH of its 32 layers.
QWEN_LLM_DEPTH = 8
MCPM_LLM_DEPTH = 8

# Phase 30: the training options at the 2B widths.  (b)'s rates; (c) runs
# OPT_STEPS Trainer micro-steps of each optimizer (phase 5's config:
# accumulation 2, so 2 optimizer steps) on the kernel path and on fp32
# plain; (d) runs ASYNC_STEPS micro-steps saving each, ASYNC_KEEP kept
# (so a rotation runs, once the pending save is waited for), at full
# width with the depth cut to ASYNC_DEPTH
# (ViT, decoder) layers, so that a checkpoint is about 2 GB, not 12.
NOISE_DROP_PATH = 0.1
NOISE_DROPOUT = 0.1
OPT_STEPS = 4
OPT_LOSS_REL_TOL = 2e-2    # each step's loss, kernel path against fp32 plain
OPT_UPDATE_COS = 0.95      # the steps' update, kernel path against plain
ASYNC_DEPTH = (2, 2)
ASYNC_STEPS = 2
ASYNC_KEEP = 1

# Phase 31: LoRA and QLoRA training; phase 32: the serving example.
LORA_RANK = 16
LORA_B_STD = 0.01          # (c)'s seeded nonzero b: a delta about the
#                            size of the weights' own spread
LORA_QUANT_MODES = ("int8-wo", "int4-wo")
LORA_TIMED_STEPS = 4       # 2 that accumulate, 2 that also step
PRODUCT_F32_FWD_REL = 2 ** -16   # (c)'s product_f32: fp32 summation order
PRODUCT_F32_BWD_REL = 2 ** -7    # bf16's epsilon: the cotangent and each
#                                  input gradient rounded to bf16 once
#                                  (about 2.4e-3 expected)
SERVE_CLIPS = 8
SERVE_TRACED = 2



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
    """(max|got - ref|, that over max|ref|); an all-zero reference (a ring
    chunk that every row is dead to) reads 0 when matched exactly."""
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return err, (err / top if top else (0.0 if err == 0.0 else math.inf))


def _bound(nbytes, ops, ops_per_s):
    """The least time of the work: bytes over the memory rate or operations
    over their peak, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _kernel_group(name):
    """A short name for a kernel as the profiler names it."""
    for part, short in (("key_norm_partial", "partial pass"),
                        ("key_norm_fold", "fold"), ("key_norm_scan", "scan"),
                        ("quantize_rows", "pre-pass"), ("q8g_gemm", "gemm"),
                        ("attention_kernel", "attention")):
        if part in name:
            return short
    return name[:60]


def device_ms(fn, reps=20, warmup=3, tries=3):
    """Device time of one call of ``fn`` by kernel (``_kernel_group``), in
    ms: ``torch.profiler`` over ``reps`` calls after a warm-up, the device
    activity only.  A trace that records no kernel (the profiler missed
    the window) is taken again, up to ``tries`` times; then the result is
    empty, and the readings built from it say "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
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
                name = _kernel_group(ev.key)
                out[name] = out.get(name, 0.0) + t / reps / 1e3
        if out:
            break
    return out


def _ms(t):
    """A reading in ms for a line of output, or "not measured"."""
    return "not measured" if t is None else f"{t:.4f} ms"


def _hold_op(label, op_fn, alone_fn, bound="kmax"):
    """A K1, K2 or K2r op (one C call: the pre-pass, then the attention
    kernel behind it as a programmatic dependent) against the kernel alone
    on the standalone pre-pass's ``bound`` (K1's and K2's kmax, K2r's
    kcum): every output bit-equal, and a second launch of the op
    bit-identical.  Prints the reading, raises on a difference, returns
    it."""
    import torch

    def run(fn):
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    got, again, alone = run(op_fn), run(op_fn), run(alone_fn)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, alone))
    twice = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"{label}: the op bit-equal to the kernel alone on the standalone "
          f"{bound}: {same}; a second launch of the op bit-identical: "
          f"{twice}")
    if not (same and twice):
        raise RuntimeError(f"{label}: op against the kernel alone {same}, "
                           f"a second launch {twice}")
    return {"bit_equal_to_kernel_alone": same, "bit_identical": twice}


def _with_prepass(want):
    """``want`` (launches by kernel) plus the pre-pass of K1, K1m and K2,
    ``key_norm_max``: one launch before every K1, K1m and K2 op, with the
    lse or without."""
    want = dict(want)
    want["key_norm_max"] = (want.get("vit_attention", 0)
                            + want.get("vit_attention_masked", 0)
                            + want.get("decoder_attention", 0))
    return want


# The decoder's kernels, each also counted under its D = 96 name at Phi-3's
# head dim (``kernels._count``).
D96_COUNTED = ("decoder_attention", "decoder_attention_lse", "exact_attention",
               "exact_attention_lse", "decoder_attention_bwd_dkdv",
               "decoder_attention_bwd_dq")


def _at_d96(cfg, want):
    """``want`` (launches by kernel) of the reward model ``cfg``, plus, where
    its decoder has Phi-3's head dim of 96, each decoder kernel's launches
    under its D = 96 name too, and the pre-pass of every K2 among them as
    ``key_norm_max_d96`` (the ViT's K1, its pre-pass and K4 nc stay at
    64)."""
    want = dict(want)
    if cfg.chat.llm.head_dim == 96:
        for name in D96_COUNTED:
            if want.get(name):
                want[f"{name}_d96"] = want[name]
        if want.get("decoder_attention"):
            want["key_norm_max_d96"] = want["decoder_attention"]
    return want


def _serving_launches(cfg, forwards):
    """The launches of ``forwards`` scoring forwards of the reward model
    ``cfg``: K1 per ViT layer and K2 per decoder layer, each after its
    pre-pass (``_at_d96``: their D = 96 names too at Phi-3's head dim)."""
    L_llm = cfg.chat.llm.num_hidden_layers * forwards
    return _at_d96(cfg, _with_prepass({
        "vit_attention": cfg.chat.vision.num_hidden_layers * forwards,
        "decoder_attention": L_llm}))


def _check_prepass(label, k, mask):
    """The pre-pass of K1 and K2 against its twin (to
    PREPASS_REL_TOL of max|plain|), its bound by bytes: the k read,
    the mask and the (B, Hkv) output."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    def rule(got, ref):
        rel = _rel_err(got[0], ref[0])[1]
        return (f"{rel:.3e} of max|plain| (bound {PREPASS_REL_TOL})",
                rel <= PREPASS_REL_TOL, {})

    kmax = fa.key_norm_max(k, mask)
    extra = () if mask is None else (mask,)
    reading = _check_kernel(
        f"pre-pass key_norm_max {label}",
        lambda: kernels.key_norm_max(k, mask),
        lambda: fa.key_norm_max(k, mask), names=("kmax",), extra=rule,
        work=(_nbytes(k, *extra, kmax), 2 * k.numel(), FP32_OPS_PER_S))
    # The partial pass is the op's pre-pass; the fold runs only here.
    dev = device_ms(lambda: kernels.key_norm_max(k, mask))
    B, K, Hkv, D = k.shape
    reading.update(device_ms=dev.get("partial pass"),
                   fold_device_ms=dev.get("fold"),
                   parts=kernels.key_norm_parts(B, K, Hkv, D))
    print(f"pre-pass key_norm_max {label}: device time a launch, partial "
          f"pass {_ms(reading['device_ms'])} ({reading['parts']} partials "
          f"per (b, kv head); bound {reading['bound_ms']:.4f} ms), fold "
          f"{_ms(reading['fold_device_ms'])} (standalone only)")
    return reading


def _check_kernel(label, kernel_fn, plain_fn, names=("out",), zero=None,
                  extra=None, work=None, library=None):
    """Run a kernel and its twin on the same inputs (each returns a tensor
    or a tuple) and hold the first ``len(names)`` outputs each to
    KERNEL_REL_TOL of max|plain|.  ``zero``: (where, predicate(got)), the
    outputs that must be exactly 0 and whether they are; ``extra(got, ref)``
    -> (text, ok, readings) holds a further output.  ``work``: (bytes, ops,
    peak ops/s) of the function, for its bound; ``library``: one PyTorch
    call computing the same function, timed as a yardstick.  Prints the
    reading with the median time of each, raises on any breach, returns the
    reading."""
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
    reading["library_ms"] = None if library is None else _median_ms(library)
    if work is not None:
        reading.update(_bound(*work))
        reading["bound_share"] = reading["bound_ms"] / reading["ms"]
    times = (f"kernel {reading['ms']:.4f} ms, plain {reading['plain_ms']:.4f}"
             " ms")
    if reading["library_ms"] is not None:
        times += f", library {reading['library_ms']:.4f} ms"
    if work is not None:
        times += (f", bound {reading['bound_ms']:.4f} ms by "
                  f"{reading['bound_by']} ({100 * reading['bound_share']:.1f}%"
                  " of it reached)")
    print(f"{label}: {text} (bound {KERNEL_REL_TOL:.2e}), {times} (median "
          "of 10)")
    if not ok:
        raise RuntimeError(f"{label}: beyond its bound: {text}")
    return reading


def _again(kernel_fn):
    """An ``extra`` rule of ``_check_kernel``: a second launch of the kernel
    is bit-identical to the first (no atomics)."""
    import torch

    def rule(got, ref):
        second = kernel_fn()
        second = second if isinstance(second, tuple) else (second,)
        same = all(torch.equal(a, b) for a, b in zip(got, second))
        return (f"a second launch bit-identical: {same}", same,
                {"bit_identical": same})
    return rule


def _attention_work(q, k, v, mask, q_offset=None, causal=True, matmuls=2,
                    inputs=(), outputs=None):
    """(bytes, ops, peak) of an attention function: ``matmuls`` products of
    2 * D operations per live (query, key) pair and head, counted from this
    run's mask and offsets (keys masked out, or past a query's position,
    need none); each input read and each output written once (``outputs``
    defaults to one tensor shaped as q)."""
    import torch

    B, Q, Hq, D = q.shape
    K = k.shape[1]
    if mask is None:
        mask = torch.ones((B, K), dtype=torch.int32, device=q.device)
    if causal:
        off = (torch.zeros(B, dtype=torch.long, device=q.device)
               if q_offset is None else q_offset.long())
        first_q = (torch.arange(K, device=q.device)[None] - off[:, None])
        n_q = (Q - first_q.clamp(min=0)).clamp(0, Q)
    else:
        n_q = torch.full((B, K), Q, device=q.device)
    pairs = int((mask.long() * n_q).sum()) * Hq
    outs = (q,) if outputs is None else outputs
    nbytes = _nbytes(q, k, v, mask, *inputs, *outs)
    return nbytes, 2 * matmuls * D * pairs, BF16_OPS_PER_S


def _sdpa(q, k, v, causal, backward=False, allowed=None):
    """``F.scaled_dot_product_attention`` on (B, H, S, D) copies of q, k and
    v made here, k and v repeated to q's heads (GQA), as a library
    yardstick: the forward, or with ``backward`` dQ, dK and dV together.  It
    takes no key mask (its flash path has none), so it does a little more
    work than a masked kernel.  ``allowed``: an explicit (B, Q, K) boolean
    mask in place of ``causal`` (a causal offset and the key mask, at a
    ring chunk or the all-gather shape); a row it leaves no key gives NaN
    there, and only the time is read."""
    import torch
    import torch.nn.functional as F

    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.repeat_interleave(rep, dim=2) if t is not q else t
                  for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qt, kt, vt))
    kw = ({"is_causal": causal} if allowed is None
          else {"attn_mask": allowed[:, None]})
    if not backward:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)
    leaves = [t.requires_grad_() for t in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, **kw)
    dout = torch.randn_like(out)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def _sdpa_at(q, k, v, mask, off):
    """SDPA as the yardstick of a causal call with a key mask: without an
    offset its causal flag (it takes no key mask: a little more work than
    the kernel); at a per-row offset (a decode step, a continuation over a
    prefix's cache), where its causal mask, aligned at the first query,
    cannot serve, an explicit boolean mask of the keys each row sees (the
    offset and the key mask: the same function)."""
    if off is None:
        return _sdpa(q, k, v, causal=True)
    from mjvideo_tpu_torch.ops import flash_attention as fa

    return _sdpa(q, k, v, causal=True,
                 allowed=fa._decoder_allowed(q, k, mask, off))


def check_vit_attention(randn, shape, dense_qk=False, turns=False):
    """K1 on views into one (B, S, 3*H*D) tensor, as the ViT makes them
    (with ``dense_qk`` q and k dense copies, as InternViT-6B's QK-RMSNorm
    makes them, and v the view): the op (the pre-pass and the kernel, one C
    call), the kernel alone on the pre-pass's kmax, and the pre-pass; the
    op, with the lse and without (at D = 64; the other head dims have no
    lse form), bit-equal to the kernel alone and a second launch
    bit-identical (``_hold_op``); with ``turns`` also the op, the kernel
    alone, SDPA and the twin in turns by CUDA events and the op's and the
    kernel's device times.  Returns each one's reading."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, S, H, D = shape
    q, k, v = (t.view(B, S, H, D)
               for t in randn(B, S, 3 * H * D).split(H * D, dim=-1))
    if dense_qk:
        q, k = q.contiguous(), k.contiguous()
    work = _attention_work(q, k, v, None, causal=False)
    library = _sdpa(q, k, v, causal=False)
    kmax = kernels.key_norm_max(k)
    for lse in (False, True) if D == 64 else (False,):
        _hold_op(f"K1{' lse' if lse else ''} op {shape}",
                 lambda: fa._vit_attention_fwd(q, k, v, D ** -0.5, lse),
                 lambda: kernels.vit_attention(q, k, v, kmax, D ** -0.5,
                                               with_lse=lse))
    runs = {"K1 op": lambda: fa.vit_attention(q, k, v),
            "K1": lambda: kernels.vit_attention(q, k, v, kmax, D ** -0.5),
            "SDPA": library,
            "plain": lambda: fa.vit_attention_plain(q, k, v)}
    out = {
        "K1": _check_kernel(
            f"K1 vit_attention (op: pre-pass and kernel) {shape}",
            runs["K1 op"], runs["plain"], work=work, library=library),
        "K1 kernel": _check_kernel(
            f"K1 vit_attention (kernel alone) {shape}", runs["K1"],
            runs["plain"], work=work, library=library),
        "K1 pre-pass": _check_prepass(str(shape), k, None)}
    if turns:
        med = _in_turns(runs, list(runs) + list(runs)[::-1], 10)
        print(f"K1 at {shape}, in turns: "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in med.items())
              + " (median of 20 each)")
        _op_device_times(med, runs, ("K1 op", "K1"), shape)
        out["turns"] = med
    return out


def check_vit_backward(randn, shape):
    """Phase 13: K1 with the lse, K4 nc dK/dV and K4 nc dQ against their
    twins on qkv views and a random dO; returns each one's reading."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, S, H, D = shape
    q, k, v = (t.view(B, S, H, D)
               for t in randn(B, S, 3 * H * D).split(H * D, dim=-1))
    scale = D ** -0.5
    kmax = kernels.key_norm_max(k)

    alone = kernels.vit_attention(q, k, v, kmax, scale)

    def lse_rule(got, ref):
        err = (got[1] - ref[1]).abs().max().item()
        top = ref[1].abs().max().item()
        same = bool(torch.equal(got[0], alone))
        return (f"lse max_abs_err {err:.3e} (bound {LSE_TOL:.0e}, |lse| up "
                f"to {top:.2f}), out bit-equal to K1's: {same}",
                err <= LSE_TOL and same, {"lse_max_abs_err": err})

    lse_out = q.new_empty((B, H, S), dtype=torch.float32)
    readings = {"K1 lse": _check_kernel(
        f"K1 lse vit_attention {shape}",
        lambda: kernels.vit_attention(q, k, v, kmax, scale, with_lse=True),
        lambda: fa.vit_attention_plain(q, k, v, return_lse=True),
        extra=lse_rule,
        work=_attention_work(q, k, v, None, causal=False,
                             outputs=(q, lse_out)),
        library=_sdpa(q, k, v, causal=False))}
    dout = randn(*q.shape)
    ref, lse = fa.vit_attention_plain(q, k, v, return_lse=True)
    args = (q, k, v, dout, lse, fa.attention_delta(ref, dout))
    del ref
    backward = _sdpa(q, k, v, causal=False, backward=True)

    dkdv = lambda: kernels.vit_attention_bwd_dkdv(*args, scale)  # noqa: E731
    dq = lambda: kernels.vit_attention_bwd_dq(*args, scale)  # noqa: E731
    readings["K4 nc dkdv"] = _check_kernel(
        f"K4 nc vit_attention_bwd_dkdv {shape}", dkdv,
        lambda: fa.vit_attention_bwd_plain(*args, want_dq=False)[1:],
        names=("dk", "dv"), extra=_again(dkdv),
        work=_attention_work(q, k, v, None, causal=False, matmuls=4,
                             inputs=args[3:6], outputs=(k, v)),
        library=backward)
    readings["K4 nc dq"] = _check_kernel(
        f"K4 nc vit_attention_bwd_dq {shape}", dq,
        lambda: fa.vit_attention_bwd_plain(*args, want_dkdv=False)[0],
        names=("dq",), extra=_again(dq),
        work=_attention_work(q, k, v, None, causal=False, matmuls=3,
                             inputs=args[3:6]),
        library=backward)
    return readings


def check_k4nc_edges(randn):
    """Phase 13 at the backward template's tile edges: K4 nc dK/dV and dQ
    at (2, S, 16, 64) for S in K4NC_EDGES on qkv views, against their twin
    to KERNEL_REL_TOL of max|plain|, a second launch bit-identical to the
    first.  Returns the largest relative error by S."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    worst = {}
    for S in K4NC_EDGES:
        B, H, D = 2, 16, 64
        q, k, v = (t.view(B, S, H, D)
                   for t in randn(B, S, 3 * H * D).split(H * D, dim=-1))
        dout = randn(B, S, H, D)
        ref, lse = fa.vit_attention_plain(q, k, v, return_lse=True)
        args = (q, k, v, dout, lse, fa.attention_delta(ref, dout))
        runs = [(*kernels.vit_attention_bwd_dkdv(*args, D ** -0.5),
                 kernels.vit_attention_bwd_dq(*args, D ** -0.5))
                for _ in range(2)]
        rdq, rdk, rdv = fa.vit_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = {n: _rel_err(g, r)[1] for n, g, r in
                zip(("dk", "dv", "dq"), runs[0], (rdk, rdv, rdq))}
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        finite = all(torch.isfinite(g).all() for g in runs[0])
        print(f"K4 nc at (2, {S}, 16, 64): " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items())
              + f" of max|plain| (bound {KERNEL_REL_TOL:.2e}); a second "
              f"launch bit-identical: {same}")
        if not (finite and same and max(errs.values()) <= KERNEL_REL_TOL):
            raise RuntimeError(f"K4 nc at S = {S}: errors {errs}, finite "
                               f"{finite}, bit-identical {same}")
        worst[S] = max(errs.values())
    return worst


def _decoder_inputs(randn, B, T, Hq, Hkv, D, ragged, live=None):
    """q, k, v, a (B, T) int32 mask and the (B, T) dead rows.  Ragged: row 1
    masks its last 600 keys and its first 5, so its first 5 queries see no
    key at all (dead rows); ``live``: the first ``live`` keys of each row
    live and the rest masked, as a prompt right-padded to its bucket;
    otherwise every key is live, as in training."""
    import torch

    q, k, v = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
    mask = torch.ones((B, T), dtype=torch.int32, device=q.device)
    if ragged:
        mask[1, T - 600:] = 0
        mask[1, :5] = 0
    if live is not None:
        mask[:, live:] = 0
    dead = mask.cumsum(1) == 0  # causal from 0: row i sees keys 0..i
    return q, k, v, mask, dead


def check_decoder_kernels(randn, shape, ragged, live=None):
    """K2 without the lse (the op: the pre-pass and the kernel, one C call;
    the kernel alone; the pre-pass) and with it, K4a and K4b against their
    twins on one set of inputs (``_decoder_inputs``), the op with the lse
    and without bit-equal to the kernel alone (``_hold_op``); returns each
    one's reading by label."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, dead = _decoder_inputs(randn, *shape, ragged, live)
    scale = shape[-1] ** -0.5
    kmax = kernels.key_norm_max(k, mask)
    masked = mask == 0
    n_dead, n_masked = int(dead.sum()), int(masked.sum())
    dead_rows = (f"{n_dead} dead rows", lambda got: not got[0][dead].any())

    alone = kernels.decoder_attention(q, k, v, mask, kmax, None, scale)
    for with_lse in (False, True):
        _hold_op(f"K2{' lse' if with_lse else ''} op {shape}",
                 lambda: fa._decoder_attention_fwd(q, k, v, mask, None, scale,
                                                   with_lse),
                 lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                                   scale, with_lse=with_lse))

    def lse_rule(got, ref):
        lse, ref_lse = got[1], ref[1]
        dead_l = dead[:, None, :].expand_as(lse)
        live_err = (lse - ref_lse)[~dead_l].abs().max().item()
        same = bool(torch.equal(got[0], alone))
        held = (live_err <= LSE_TOL and bool((lse[dead_l] == fa.DEAD_LSE).all())
                and bool((ref_lse[dead_l] == fa.DEAD_LSE).all()) and same)
        top = ref_lse[~dead_l].abs().max().item()
        return (f"lse max_abs_err {live_err:.3e} on live rows (bound "
                f"{LSE_TOL:.0e}, |lse| up to {top:.2f}), {n_dead} dead rows "
                f"at 1e30, out bit-equal to K2's: {same}", held,
                {"lse_max_abs_err": live_err})

    lse_out = q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=kmax.dtype)
    work = _attention_work(q, k, v, mask)
    library = _sdpa(q, k, v, causal=True)
    readings = {
        "K2": _check_kernel(
            f"K2 decoder_attention (op: pre-pass and kernel) {shape}",
            lambda: fa.decoder_attention(q, k, v, mask),
            lambda: fa.decoder_attention_plain(q, k, v, mask),
            zero=dead_rows, work=work, library=library),
        "K2 kernel": _check_kernel(
            f"K2 decoder_attention (kernel alone) {shape}",
            lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                              scale),
            lambda: fa.decoder_attention_plain(q, k, v, mask),
            zero=dead_rows, work=work, library=library),
        "K2 pre-pass": _check_prepass(str(shape), k, mask),
        "K2 lse": _check_kernel(
            f"K2 lse decoder_attention {shape}",
            lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                              scale, with_lse=True),
            lambda: fa.decoder_attention_plain(q, k, v, mask,
                                               return_lse=True),
            zero=dead_rows, extra=lse_rule,
            work=_attention_work(q, k, v, mask, outputs=(q, lse_out)),
            library=library),
    }
    del library
    dout = randn(*q.shape)
    ref, lse = fa.decoder_attention_plain(q, k, v, mask, return_lse=True)
    args = (q, k, v, dout, lse, fa.attention_delta(ref, dout), mask)
    del ref
    backward = _sdpa(q, k, v, causal=True, backward=True)
    dkdv = lambda: kernels.decoder_attention_bwd_dkdv(  # noqa: E731
        *args, None, scale)
    dq = lambda: kernels.decoder_attention_bwd_dq(  # noqa: E731
        *args, None, scale)
    readings["K4a"] = _check_kernel(
        f"K4a decoder_attention_bwd_dkdv {shape}", dkdv,
        lambda: fa.decoder_attention_bwd_plain(*args, want_dq=False)[1:],
        names=("dk", "dv"),
        zero=(f"{n_masked} masked keys",
              lambda got: not any(g[masked].any() for g in got)),
        extra=_again(dkdv),
        work=_attention_work(q, k, v, mask, matmuls=4, inputs=args[3:6],
                             outputs=(k, v)),
        library=backward)
    readings["K4b"] = _check_kernel(
        f"K4b decoder_attention_bwd_dq {shape}", dq,
        lambda: fa.decoder_attention_bwd_plain(*args, want_dkdv=False)[0],
        names=("dq",), zero=dead_rows, extra=_again(dq),
        work=_attention_work(q, k, v, mask, matmuls=3, inputs=args[3:6]),
        library=backward)
    return readings


def check_long_k2_op(randn, shape=(1, LONG_KEYS[0], 16, 8, 128),
                     live=LONG_KEYS[1]):
    """The K2 op at a long decoder shape with each row's first ``live``
    keys live: phase 20's no-SP (1, LONG_KEYS[0], 16/8, 128), or phase
    22's pair at max_num 12: the pre-pass (up to 256 partials per kv head)
    against its twin, and the op, with the lse and without, bit-equal to
    the kernel alone on the standalone kmax (``_hold_op``; the plain
    twin's (Q, K) scores would not fit).  Returns the readings."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, _ = _decoder_inputs(randn, *shape, False, live)
    scale = shape[-1] ** -0.5
    out = {"pre-pass": _check_prepass(str(shape), k, mask)}
    kmax = kernels.key_norm_max(k, mask)
    for with_lse in (False, True):
        out[f"op{' lse' if with_lse else ''}"] = _hold_op(
            f"K2{' lse' if with_lse else ''} op {shape}, {live} live keys",
            lambda: fa._decoder_attention_fwd(q, k, v, mask, None, scale,
                                              with_lse),
            lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                              scale, with_lse=with_lse))
    return out


def stream_ms(fn, calls=20, warmup=3):
    """Time of one call of ``fn`` among ``calls`` issued back to back, by
    CUDA events around them all: the device's time per call where the host
    keeps ahead (a kernel behind its pre-pass starts as soon as it may)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _judge_inputs(randn, shape, prefix=JUDGE_PREFIX, suffix=JUDGE_SUFFIX,
                  right_padded=None):
    """q, k, v, the (B, K) int32 mask, q_offset and the (B, Q) dead rows of
    one JUDGE_SHAPES entry.  The prefill left-pads both rows (56 and 160
    pad keys, so their first queries see no key), or with
    ``right_padded`` (the Qwen2-VL judge's batch) masks the keys from that
    length on; the prefix masks its bucket's tail past ``prefix`` keys; the
    continuation marks each row's prefix and ``suffix`` slots valid."""
    import torch

    B, Q, K, Hq, Hkv, D, off = shape
    q, k, v = randn(B, Q, Hq, D), randn(B, K, Hkv, D), randn(B, K, Hkv, D)
    mask = torch.ones((B, K), dtype=torch.int32, device=q.device)
    if off is None and B == 2 and right_padded is not None:
        mask[:, right_padded:] = 0
    elif off is None and B == 2:
        mask[0, :56] = 0
        mask[1, :160] = 0
    elif off is None:
        mask[:, prefix:] = 0
    else:
        mask[:, off + suffix:] = 0
        off = torch.full((B,), off, dtype=torch.int32, device=q.device)
    pos = torch.arange(Q, device=q.device)[None] + (0 if off is None
                                                     else off[:, None])
    pos = pos.expand(B, Q).clamp(max=K - 1).long()
    seen = torch.cumsum(mask, 1).gather(1, pos)
    return q, k, v, mask, off, seen == 0


def check_judge_kernels(randn, name, shape, prefix=JUDGE_PREFIX, **inputs):
    """K3 and K2r (the op: its pre-pass and its kernel, one C call) against
    their twins on one set of inputs, then K2r's parts apart: the pre-pass
    against its twin, with its device time a launch by kernel, its last
    column bit-equal to ``key_norm_max`` and its first P columns to the
    pre-pass of the keys cut at P (JUDGE_PREFIX, and K // 2 + 1: other
    chunk plans), and the kernel alone on the pre-pass's column, which the
    op must equal bit for bit.  ``prefix`` and ``inputs`` (``suffix``,
    ``right_padded``) shape another judge's inputs (``_judge_inputs``)."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, off, dead = _judge_inputs(randn, shape, prefix, **inputs)
    scale = shape[5] ** -0.5
    zero = (f"{int(dead.sum())} dead rows",
            lambda got: not got[0][dead].any())
    label = f"{shape[:6]} {name}"
    work = _attention_work(q, k, v, mask, off)
    library = _sdpa_at(q, k, v, mask, off)
    readings = {
        "K3": _check_kernel(
            f"K3 exact_attention {label}",
            lambda: fa.exact_attention(q, k, v, mask, off),
            lambda: fa.exact_attention_plain(q, k, v, mask, off), zero=zero,
            work=work, library=library),
        "K2r": _check_kernel(
            f"K2r decoder_attention_rows (op: pre-pass and kernel) {label}",
            lambda: fa.decoder_attention_rows(q, k, v, mask, off),
            lambda: fa.decoder_attention_rows_plain(q, k, v, mask, off),
            zero=zero, work=work, library=library),
    }

    def prepass_rule(got, ref):
        rel = _rel_err(got[0], ref[0])[1]
        return (f"{rel:.3e} of max|plain| (bound {PREPASS_REL_TOL:.0e})",
                rel <= PREPASS_REL_TOL, {})

    kcum = kernels.key_norm_cummax(k, mask)
    B, K, Hkv, D = k.shape
    reading = _check_kernel(
        f"K2r pre-pass key_norm_cummax {label}",
        lambda: kernels.key_norm_cummax(k, mask),
        lambda: fa.key_norm_cummax(k, mask), names=("kcum",),
        extra=prepass_rule,
        work=(_nbytes(k, mask, kcum), 2 * k.numel(), FP32_OPS_PER_S))
    dev = device_ms(lambda: kernels.key_norm_cummax(k, mask))
    reading.update(device_ms=sum(dev.values()) or None,
                   partial_device_ms=dev.get("partial pass"),
                   scan_device_ms=dev.get("scan"),
                   parts=kernels.key_norm_parts(B, K, Hkv, D))
    last = bool(torch.equal(kcum[..., -1], kernels.key_norm_max(k, mask)))
    prefixes = {}
    for P in (min(prefix, K), K // 2 + 1):
        cut = kernels.key_norm_cummax(k[:, :P], mask[:, :P].contiguous())
        prefixes[P] = bool(torch.equal(cut, kcum[..., :P]))
    reading.update(last_column_is_key_norm_max=last, prefix_bit_equal={
        str(P): same for P, same in prefixes.items()})
    print(f"K2r pre-pass key_norm_cummax {label}: device time a launch "
          f"{_ms(reading['device_ms'])} (partial pass "
          f"{_ms(reading['partial_device_ms'])}, scan "
          f"{_ms(reading['scan_device_ms'])}; {reading['parts']} chunks per "
          f"(b, kv head)); the last column bit-equal to key_norm_max: "
          f"{last}; the first P columns bit-equal to the pre-pass of k cut "
          "at P: " + ", ".join(
              f"P {P} ({kernels.key_norm_parts(B, P, Hkv, D)} chunks) {same}"
              for P, same in prefixes.items()))
    if not (last and all(prefixes.values())):
        raise RuntimeError(f"K2r pre-pass {label}: last column {last}, "
                           f"prefixes {prefixes}")
    readings["K2r pre-pass"] = reading
    readings["K2r kernel"] = _check_kernel(
        f"K2r decoder_attention_rows (kernel alone) {label}",
        lambda: kernels.decoder_attention_rows(q, k, v, mask, kcum, off,
                                               scale),
        lambda: fa.decoder_attention_rows_plain(q, k, v, mask, off),
        zero=zero, work=work, library=library)
    readings["K2r op"] = _hold_op(
        f"K2r op {label}",
        lambda: fa.decoder_attention_rows(q, k, v, mask, off),
        lambda: kernels.decoder_attention_rows(q, k, v, mask, kcum, off,
                                               scale), bound="kcum")
    return readings


def _in_turns(runs, order, rounds):
    """Each of ``runs`` (name -> a call) timed by CUDA events around one
    call, ``rounds`` times in ``order`` (each name twice, mirrored) after a
    warm-up; returns the medians in ms."""
    import torch

    times = {name: [] for name in runs}
    for fn in runs.values():
        for _ in range(3):
            fn()
    for _ in range(rounds):
        for name in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runs[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def time_shifts_in_turns(randn, rounds=10):
    """The three causal forward kernels of the Hopper template on the
    judge's prefill inputs, K2 (global bound), K3 (exact) and K2r (per-row
    bound), launched directly with their bounds reduced beforehand, the K2
    and K2r ops (each pre-pass and kernel), K2 with the lse alone and its
    op, K3 with the lse, the two pre-passes alone and
    ``F.scaled_dot_product_attention`` (the same-run yardstick), timed in
    turns (K2, K3, K2r, K2 op, K2r op, K2 lse, K2 lse op, K3 lse, the
    pre-passes, SDPA, then back) by CUDA events; returns the medians in
    ms, with the device times by kernel of the K2 and K2r ops, kernels and
    pre-passes."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, _, _ = _judge_inputs(randn, JUDGE_SHAPES["prefill"])
    scale = q.shape[-1] ** -0.5
    kmax = kernels.key_norm_max(k, mask)
    kcum = kernels.key_norm_cummax(k, mask)
    runs = {
        "K2": lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                                scale),
        "K3": lambda: kernels.exact_attention(q, k, v, mask, None, scale),
        "K2r": lambda: kernels.decoder_attention_rows(q, k, v, mask, kcum,
                                                      None, scale),
        "K2 op": lambda: fa.decoder_attention(q, k, v, mask),
        "K2r op": lambda: fa.decoder_attention_rows(q, k, v, mask),
        "K2 lse": lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                                    scale, with_lse=True),
        "K2 lse op": lambda: fa._decoder_attention_fwd(q, k, v, mask, None,
                                                       scale, with_lse=True),
        "K3 lse": lambda: kernels.exact_attention(q, k, v, mask, None, scale,
                                                  with_lse=True),
        "pre-pass": lambda: kernels.key_norm_max(k, mask),
        "K2r pre-pass": lambda: kernels.key_norm_cummax(k, mask),
        "SDPA": _sdpa(q, k, v, causal=True),
    }
    order = list(runs) + list(runs)[::-1]
    med = _in_turns(runs, order, rounds)
    print(f"kernels alone at {JUDGE_SHAPES['prefill'][:6]}, in turns: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in med.items())
          + f" (median of {2 * rounds} each; against SDPA: "
          + ", ".join(f"{n} {t / med['SDPA']:.3f}" for n, t in med.items()
                      if n != "SDPA")
          + f"; K2 lse/K2 {med['K2 lse'] / med['K2']:.3f}, K2 lse op/K2 op "
          f"{med['K2 lse op'] / med['K2 op']:.3f})")
    _op_device_times(med, runs, ("K2 op", "K2 lse op", "K2", "pre-pass",
                                 "K2r op", "K2r", "K2r pre-pass"),
                     JUDGE_SHAPES["prefill"][:6])
    return med


def _op_device_times(med, runs, names, shape):
    """Adds to ``med`` the device time by kernel of each of ``names``
    (``device_ms``) and its time back to back (``stream_ms``), and prints
    them."""
    for name in names:
        med[f"{name} device_ms"] = device_ms(runs[name])
        med[f"{name} back_to_back_ms"] = stream_ms(runs[name])
        print(f"{name} at {shape}: device time a call by kernel "
              + ", ".join(f"{n} {t:.4f} ms"
                          for n, t in med[f"{name} device_ms"].items())
              + f"; back to back {med[f'{name} back_to_back_ms']:.4f} ms a "
              "call")


def time_k1_in_turns(randn, rounds=10):
    """K1 and K1 with the lse, both launched directly on the pre-pass's
    kmax, the K1 op and the K1-lse op (each pre-pass and kernel) and
    ``F.scaled_dot_product_attention`` at serving's ViT shape on qkv views,
    timed in turns by CUDA events; returns the medians in ms."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, S, H, D = K1_SHAPES[0]
    q, k, v = (t.view(B, S, H, D)
               for t in randn(B, S, 3 * H * D).split(H * D, dim=-1))
    scale = D ** -0.5
    kmax = kernels.key_norm_max(k)
    runs = {
        "K1": lambda: kernels.vit_attention(q, k, v, kmax, scale),
        "K1 lse": lambda: kernels.vit_attention(q, k, v, kmax, scale,
                                                with_lse=True),
        "K1 op": lambda: fa.vit_attention(q, k, v),
        "K1 lse op": lambda: fa._vit_attention_fwd(q, k, v, scale,
                                                   with_lse=True),
        "pre-pass": lambda: kernels.key_norm_max(k),
        "SDPA": _sdpa(q, k, v, causal=False),
    }
    order = list(runs) + list(runs)[::-1]
    med = _in_turns(runs, order, rounds)
    print(f"K1 at {K1_SHAPES[0]}, in turns: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in med.items())
          + f" (median of {2 * rounds} each; against SDPA: "
          + ", ".join(f"{n} {t / med['SDPA']:.3f}" for n, t in med.items()
                      if n != "SDPA")
          + f"; K1 lse/K1 {med['K1 lse'] / med['K1']:.3f}, K1 lse op/K1 op "
          f"{med['K1 lse op'] / med['K1 op']:.3f})")
    _op_device_times(med, runs, ("K1 op", "K1 lse op", "K1", "pre-pass"),
                     K1_SHAPES[0])
    return med


def time_k4nc_in_turns(randn, rounds=10):
    """K4 nc dK/dV and dQ, launched directly at serving's ViT shape on qkv
    views, and ``F.scaled_dot_product_attention``'s backward (dQ, dK and dV
    in one call), timed in turns by CUDA events; returns the medians in ms
    and the pair's sum against SDPA's."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, S, H, D = K1_SHAPES[0]
    q, k, v = (t.view(B, S, H, D)
               for t in randn(B, S, 3 * H * D).split(H * D, dim=-1))
    dout = randn(B, S, H, D)
    ref, lse = fa.vit_attention_plain(q, k, v, return_lse=True)
    args = (q, k, v, dout, lse, fa.attention_delta(ref, dout), D ** -0.5)
    del ref
    runs = {
        "K4 nc dkdv": lambda: kernels.vit_attention_bwd_dkdv(*args),
        "K4 nc dq": lambda: kernels.vit_attention_bwd_dq(*args),
        "SDPA backward": _sdpa(q, k, v, causal=False, backward=True),
    }
    order = list(runs) + list(runs)[::-1]
    med = _in_turns(runs, order, rounds)
    med["pair / SDPA backward"] = ((med["K4 nc dkdv"] + med["K4 nc dq"])
                                   / med["SDPA backward"])
    print(f"K4 nc at {K1_SHAPES[0]}, in turns: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in list(med.items())[:3])
          + f" (median of {2 * rounds} each); the pair against SDPA's "
          f"backward {med['pair / SDPA backward']:.3f}")
    return med


def time_k4_in_turns(randn, shapes, rounds=10):
    """K4a dK/dV and K4b dQ, launched directly, and
    ``F.scaled_dot_product_attention``'s backward (dQ, dK and dV in one
    call, k and v repeated to the q heads), timed in turns by CUDA events
    at each of ``shapes`` ((B, T, Hq, Hkv, D), live keys or None: training's
    with every key live, the reward gradient's with the single clip's
    prompt live), causal from the twin's lse; prints each one's share of
    its bound (``_attention_work`` on this run's mask) and the pair's sum
    against SDPA's.  Returns the readings by shape."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    out = {}
    for shape, live in shapes:
        q, k, v, mask, _ = _decoder_inputs(randn, *shape, False, live)
        dout = randn(*q.shape)
        ref, lse = fa.decoder_attention_plain(q, k, v, mask, return_lse=True)
        args = (q, k, v, dout, lse, fa.attention_delta(ref, dout), mask,
                None, shape[-1] ** -0.5)
        del ref
        runs = {
            "K4a": lambda: kernels.decoder_attention_bwd_dkdv(*args),
            "K4b": lambda: kernels.decoder_attention_bwd_dq(*args),
            "SDPA backward": _sdpa(q, k, v, causal=True, backward=True),
        }
        order = list(runs) + list(runs)[::-1]
        med = _in_turns(runs, order, rounds)
        bounds = {
            "K4a": _bound(*_attention_work(q, k, v, mask, matmuls=4,
                                           inputs=args[3:6],
                                           outputs=(k, v)))["bound_ms"],
            "K4b": _bound(*_attention_work(q, k, v, mask, matmuls=3,
                                           inputs=args[3:6]))["bound_ms"]}
        bounds["pair"] = bounds["K4a"] + bounds["K4b"]
        med["pair"] = med["K4a"] + med["K4b"]
        reading = {"ms": med, "bound_ms": bounds,
                   "pair_over_sdpa_backward": med["pair"]
                   / med["SDPA backward"]}
        print(f"K4a/K4b at {shape[:5]}, {int(mask.sum())} live keys, in "
              f"turns (median of {2 * rounds} each): " + ", ".join(
                  f"{n} {med[n]:.4f} ms ({100 * bounds[n] / med[n]:.1f}% of "
                  f"its {bounds[n]:.4f} ms bound)" for n in bounds)
              + f", SDPA backward {med['SDPA backward']:.4f} ms; the pair "
              "against SDPA's backward "
              f"{reading['pair_over_sdpa_backward']:.3f}")
        out[str(shape[:5])] = reading
    return out


def sm90_ptxas(lib):
    """Registers, spill bytes and ptxas's wgmma warnings of the Hopper
    template's instantiations and the bound pre-passes, from the build's
    ptxas report; printed and returned by kernel.  Raises if one spills or
    one is missing."""
    import re

    report = (lib.parent / "ptxas.txt").read_text().splitlines()
    out, name = {}, None
    for line in report:
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if any(k in m.group(1)
                                     for k in SM90_KERNELS) else None
            continue
        if name is None:
            continue
        row = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_stores"], row["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    warned = [line.strip() for line in report
              if "C7512" in line or "C7508" in line]
    for name, row in out.items():
        print(f"ptxas {name}: {row}")
    for line in warned:
        print(f"ptxas warning: {line}")
    spilled = [n for n, row in out.items() if row.get("spill_stores", 0)
               or row.get("spill_loads", 0)]
    if spilled or len(out) != SM90_INSTANTIATIONS:
        raise RuntimeError(f"ptxas: spills in {spilled}, or not the "
                           f"{SM90_INSTANTIATIONS} kernels expected: "
                           f"{sorted(out)}")
    return {"kernels": out, "warnings": warned}


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


def check_ring_kernels(randn, heads=(16, 8), D=128,
                       gather_ranks=SP_GATHER_RANKS):
    """Phase 17: K3 with the lse, K4a and K4b at ring-chunk offsets and K3
    at the all-gather shape (at each of ``gather_ranks``) against their
    twins, at ``heads`` (Hq, Hkv) of ``D`` (phase 25: the 4B's 32/32 of
    96); returns each one's reading by (label, offset)."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa
    from mjvideo_tpu_torch.parallel.sequence import NO_MASS_LSE

    B, (Hq, Hkv) = 1, heads
    L, scale = SP_T // SP_SHARDS, D ** -0.5
    dims = f"{Hq}/{Hkv}, {D}"
    q, k, v = randn(B, SP_T, Hq, D), randn(B, SP_T, Hkv, D), randn(B, SP_T,
                                                                  Hkv, D)
    mask = torch.ones((B, SP_T), dtype=torch.int32, device=q.device)
    mask[:, :5] = 0
    mask[:, SP_T - 600:] = 0

    def chunk(t, r):
        return t[:, r * L:(r + 1) * L]

    def offset(o):
        return torch.full((B,), o, dtype=torch.int32, device=q.device)

    readings = {}
    for my, src in SP_CHUNKS:
        rel = (my - src) * L
        qc, kc, vc = chunk(q, my), chunk(k, src), chunk(v, src)
        mc, off = chunk(mask, src).contiguous(), offset(rel)
        ref_lse = fa.exact_attention_plain(qc, kc, vc, mc, off,
                                           return_lse=True)[1]
        dead = ref_lse >= fa.DEAD_LSE * 0.5  # (B, Hq, L): no key here
        n_dead = int(dead.sum())
        dead_rows = (f"{n_dead} dead (row, head) pairs",
                     lambda got: not got[0].transpose(1, 2)[dead].any())

        k3 = kernels.exact_attention(qc, kc, vc, mc, off, scale)

        def lse_rule(got, ref):
            lse, ref_l = got[1], ref[1]
            same = bool(torch.equal(got[0], k3))
            second = fa.exact_attention_with_lse(qc, kc, vc, mc, off)
            twice = all(torch.equal(a, b) for a, b in zip(got, second))
            held = (torch.equal(lse >= fa.DEAD_LSE * 0.5, dead)
                    and bool((lse[dead] == fa.DEAD_LSE).all()) and same
                    and twice)
            live_err = ((lse - ref_l)[~dead].abs().max().item()
                        if (~dead).any() else 0.0)
            return (f"lse max_abs_err {live_err:.3e} on live rows (bound "
                    f"{LSE_TOL:.0e}), {n_dead} dead at 1e30, out bit-equal "
                    f"to K3's: {same}, a second launch bit-identical: "
                    f"{twice}", held and live_err <= LSE_TOL,
                    {"lse_max_abs_err": live_err, "bit_equal_to_k3": same,
                     "bit_identical": twice})

        allowed = fa._decoder_allowed(qc, kc, mc, off)
        label = f"(1, {L}, {L}, {dims}) ring rel_off {rel}"
        lse_out = q.new_empty((B, Hq, L), dtype=torch.float32)
        readings["K3 lse", rel] = _check_kernel(
            f"K3 lse exact_attention {label}",
            lambda: fa.exact_attention_with_lse(qc, kc, vc, mc, off),
            lambda: fa.exact_attention_plain(qc, kc, vc, mc, off,
                                             return_lse=True),
            zero=dead_rows, extra=lse_rule,
            work=_attention_work(qc, kc, vc, mc, off, outputs=(qc, lse_out)),
            library=_sdpa(qc, kc, vc, False, allowed=allowed))
        del k3
        # The backward from the merged lse over every chunk (NO_MASS_LSE on
        # a row no chunk gives a key) and the merged output's delta.
        g_out, g_lse = fa.exact_attention_plain(qc, k, v, mask,
                                                offset(my * L),
                                                return_lse=True)
        g_lse = torch.where(g_lse >= fa.DEAD_LSE * 0.5, NO_MASS_LSE,
                            g_lse).contiguous()
        dout = randn(*qc.shape)
        args = (qc, kc, vc, dout, g_lse, fa.attention_delta(g_out, dout), mc,
                off)
        del g_out
        masked = mc == 0
        backward = _sdpa(qc, kc, vc, False, backward=True, allowed=allowed)
        dkdv = lambda: kernels.decoder_attention_bwd_dkdv(  # noqa: E731
            *args, scale)
        dq = lambda: kernels.decoder_attention_bwd_dq(  # noqa: E731
            *args, scale)
        readings["K4a", rel] = _check_kernel(
            f"K4a decoder_attention_bwd_dkdv {label}", dkdv,
            lambda: fa.decoder_attention_bwd_plain(*args, want_dq=False)[1:],
            names=("dk", "dv"),
            zero=(f"{int(masked.sum())} masked keys",
                  lambda got: not any(g[masked].any() for g in got)),
            extra=_again(dkdv),
            work=_attention_work(qc, kc, vc, mc, off, matmuls=4,
                                 inputs=args[3:6], outputs=(kc, vc)),
            library=backward)
        readings["K4b", rel] = _check_kernel(
            f"K4b decoder_attention_bwd_dq {label}", dq,
            lambda: fa.decoder_attention_bwd_plain(*args,
                                                   want_dkdv=False)[0],
            names=("dq",), zero=dead_rows, extra=_again(dq),
            work=_attention_work(qc, kc, vc, mc, off, matmuls=3,
                                 inputs=args[3:6]),
            library=backward)
        del backward
    for r in gather_ranks:
        qc, off = chunk(q, r), offset(r * L)
        readings["K3 all-gather", r * L] = _check_kernel(
            f"K3 exact_attention (1, {L}, {SP_T}, {dims}) all-gather "
            f"q_offset {r * L}",
            lambda: fa.exact_attention(qc, k, v, mask, off),
            lambda: fa.exact_attention_plain(qc, k, v, mask, off),
            work=_attention_work(qc, k, v, mask, off),
            library=_sdpa(qc, k, v, False,
                          allowed=fa._decoder_allowed(qc, k, mask, off)))
    return readings


def time_k3_lse_chunks(randn, lengths=(SP_T // SP_SHARDS, LONG_CHUNK),
                       heads=(16, 8), D=128):
    """K3 lse at an earlier shard's ring chunk (every key seen) of each of
    ``lengths`` (the 768 tokens of phase 17 and the long clip's LONG_CHUNK;
    phase 25: 768 at the 4B's 32/32 heads of 96), with
    ``F.scaled_dot_product_attention`` (non-causal, every key live) at
    each, timed in turns by CUDA events: whether the 768 chunk's 96 CTAs
    (one wave under the card's 132 SMs) cost more per unit of work.
    Returns the readings by chunk length."""
    import torch

    from mjvideo_tpu_torch import kernels

    Hq, Hkv = heads
    dims = f"{Hq}/{Hkv}, {D}"
    out = {}
    for L in lengths:
        q, k, v = randn(1, L, Hq, D), randn(1, L, Hkv, D), randn(1, L, Hkv, D)
        mask = torch.ones((1, L), dtype=torch.int32, device=q.device)
        off = torch.full((1,), L, dtype=torch.int32, device=q.device)
        runs = {"K3 lse": lambda: kernels.exact_attention(
                    q, k, v, mask, off, D ** -0.5, with_lse=True),
                "SDPA": _sdpa(q, k, v, causal=False)}
        med = _in_turns(runs, list(runs) + list(runs)[::-1], 10)
        work = _attention_work(q, k, v, mask, causal=False)
        bound = _bound(*work)
        out[L] = {**med, "bound_ms": bound["bound_ms"],
                  "gflop": work[1] / 1e9,
                  "tflops": work[1] / med["K3 lse"] / 1e9}
        print(f"K3 lse at the ring chunk (1, {L}, {L}, {dims}) rel_off {L}"
              f", in turns (median of 20): K3 lse {med['K3 lse']:.4f} ms, "
              f"SDPA {med['SDPA']:.4f} ms; {out[L]['tflops']:.1f} TFLOP/s, "
              f"{100 * bound['bound_ms'] / med['K3 lse']:.1f}% of the bound")
        del q, k, v, runs
    return out


def f4_budget_phase(trainer, batch):
    """F4's reading (phase 6, at phase 5's stepped weights): every decoder
    attention call of ``batch``'s forward (``tools/k2lse_budget_torch.py``'s
    capture and counts), K2 lse on its inputs against the fp32 twin and the
    exact softmax; K2 lse's dead (row, head) pairs held equal to the
    twin's.  Returns the totals."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    tool = _tool("k2lse_budget_torch")
    totals = {}
    for q, k, v, mask, scale in tool.capture_calls(trainer, batch):
        counts = tool.budget_counts(q, k, v, mask, scale)
        got = kernels.decoder_attention(q, k, v, mask,
                                        kernels.key_norm_max(k, mask), None,
                                        scale, with_lse=True)
        ref = fa.decoder_attention_plain(q, k, v, mask, return_lse=True)
        r = tool.compare(*got, *ref, fa.exact_attention_plain(q, k, v, mask))
        for key in ("pairs", "gap_over_87", "flushed_keys", "l_below_1e-30"):
            totals[key] = totals.get(key, 0) + counts[key]
        totals["max_gap"] = max(totals.get("max_gap", 0.0), counts["max_gap"])
        for key in ("dead", "dead_twin"):
            totals[key] = totals.get(key, 0) + r[key]
        for key in ("out_err_exact", "lse_err"):
            totals[key] = max(totals.get(key, 0.0), r[key])
    print(f"F4 reading at the stepped weights ({totals['pairs']} (row, head) "
          f"pairs): {totals['gap_over_87']} whose largest score lies over "
          f"87.3 nats below the bound (largest gap {totals['max_gap']:.2f}), "
          f"{totals['flushed_keys']} live keys with p below 2^-126, "
          f"{totals['l_below_1e-30']} with l below 1e-30; K2 lse dead "
          f"{totals['dead']} (twin {totals['dead_twin']}), max|out - exact| "
          f"{totals['out_err_exact']:.3e}, max|lse - twin| "
          f"{totals['lse_err']:.3e}")
    if totals["dead"] != totals["dead_twin"]:
        raise RuntimeError(f"F4: K2 lse marks {totals['dead']} pairs dead, "
                           f"the twin {totals['dead_twin']}")
    return totals


def _tool(name):
    """A script of ``tools/`` loaded by its path (``tools`` is no package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_variant_kernels(randn):
    """Phase 21's checks: B1 in each mode, B2 at each hp and B3 (at S, and
    pre-padded to VARIANT_PADDED with kv_valid S) against their twins on
    views into one qkv tensor; each also printed against K1's output on
    the same q/k/v, and B3 held bit-equal to B2 at hp 1 on its live keys.
    Returns each one's reading by ("B1", mode), ("B2", hp) and ("B3",
    S)."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa
    from mjvideo_tpu_torch.ops import vit_attention_variants as va

    B, S, H, D = VARIANT_SHAPE

    def views(n):
        return tuple(t.view(B, n, H, D)
                     for t in randn(B, n, 3 * H * D).split(H * D, dim=-1))

    q, k, v = views(S)
    work = _attention_work(q, k, v, None, causal=False)
    library = _sdpa(q, k, v, causal=False)

    def against_k1(label, got):
        # K1 on the same q and the first S keys, at the first S rows.
        k1 = fa.vit_attention(q[:, :S], k[:, :S], v[:, :S]).float()
        err = (got.float().view(B, -1, H, D)[:, :S] - k1).abs().max().item()
        print(f"  {label}: max|kernel - K1| {err:.3e} (K1's largest output "
              f"{k1.abs().max().item():.3f})")

    def launch_time(label, reading, fn):
        # B1-B3 on the Hopper template: the device time of a launch.
        reading["device_ms"] = device_ms(fn).get("attention")
        print(f"  {label}: device time a launch "
              f"{_ms(reading['device_ms'])} (the sm90 template)")

    def against_b2(label, reading, q, k, v, kv):
        # B3 is B2's hp 1 walk over the first kv keys: its rows below kv
        # equal B2 hp 1's on q, k and v cut there, bit for bit.
        got = va.bshd_attention(q, k, v, kv).view(q.shape)[:, :kv]
        want = va.tmajor_attention(q[:, :kv], k[:, :kv], v[:, :kv], hp=1)
        same = bool(torch.equal(got, want))
        reading["bit_equal_to_b2_hp1"] = same
        print(f"  {label}: rows below kv_valid bit-equal to B2 hp=1 on q, "
              f"k, v cut at {kv}: {same}")
        if not same:
            raise RuntimeError(f"{label}: not B2 hp=1's bits")

    readings = {}
    for mode in kernels.VARIANT_MODES:
        label = f"B1 vit_attention_variant {mode} {VARIANT_SHAPE}"
        readings["B1", mode] = _check_kernel(
            label, lambda: va.variant_attention(q, k, v, mode),
            lambda: va.variant_attention_plain(q, k, v, mode), work=work,
            library=library)
        against_k1(label, va.variant_attention(q, k, v, mode))
        launch_time(label, readings["B1", mode],
                    lambda: va.variant_attention(q, k, v, mode))
    for hp in kernels.TMAJOR_HP:
        label = f"B2 vit_attention_tmajor hp={hp} {VARIANT_SHAPE}"
        readings["B2", hp] = _check_kernel(
            label, lambda: va.tmajor_attention(q, k, v, hp=hp),
            lambda: va.tmajor_attention_plain(q, k, v), work=work,
            library=library)
        against_k1(label, va.tmajor_attention(q, k, v, hp=hp))
        launch_time(label, readings["B2", hp],
                    lambda: va.tmajor_attention(q, k, v, hp=hp))
    label = f"B3 vit_attention_bshd {VARIANT_SHAPE}"
    readings["B3", S] = _check_kernel(
        label, lambda: va.bshd_attention(q, k, v),
        lambda: va.bshd_attention_plain(q, k, v), work=work, library=library)
    against_k1(label, va.bshd_attention(q, k, v))
    against_b2(label, readings["B3", S], q, k, v, S)
    launch_time(label, readings["B3", S], lambda: va.bshd_attention(q, k, v))
    del q, k, v, library
    # The JAX harness's form: the token axis pre-padded to a multiple of 8,
    # k and v rows zero past S.
    q, k, v = views(VARIANT_PADDED)
    k[:, S:] = 0
    v[:, S:] = 0
    kl, vl = k[:, :S], v[:, :S]
    label = (f"B3 vit_attention_bshd {(B, VARIANT_PADDED, H, D)} kv_valid "
             f"{S}")
    readings["B3", VARIANT_PADDED] = _check_kernel(
        label, lambda: va.bshd_attention(q, k, v, S),
        lambda: va.bshd_attention_plain(q, k, v, S),
        work=_attention_work(q, kl, vl, None, causal=False),
        library=_sdpa(q, kl, vl, causal=False))
    against_k1(label, va.bshd_attention(q, k, v, S))
    against_b2(label, readings["B3", VARIANT_PADDED], q, k, v, S)
    launch_time(label, readings["B3", VARIANT_PADDED],
                lambda: va.bshd_attention(q, k, v, S))
    return readings


def variant_ab_phase(readings, dev):
    """Phase 21's path: the two A/B harnesses of the ViT attention
    (``tools/vit_attn_variants_torch.py`` and
    ``tools/vit_layout_ab_torch.py``) at the 2B ViT's width, the counts
    set to 0 before each and read after; the launches held exactly.  The
    block A/B takes the B2 hp whose kernel checked fastest.  Returns the
    readings and the launch counts by harness."""
    import torch

    from mjvideo_tpu_torch import kernels

    attn_ab, block_ab = _tool("vit_attn_variants_torch"), _tool(
        "vit_layout_ab_torch")
    hp = min(kernels.TMAJOR_HP, key=lambda n: readings["B2", n]["ms"])
    counts = {}
    kernels.reset_launch_counts()
    q, k, v = attn_ab.make_inputs(VARIANT_SHAPE[0], dev)
    runs = attn_ab.kernel_runs(q, k, v)
    times = attn_ab.time_in_turns(runs, VARIANT_LAUNCHES, VARIANT_WINDOWS)
    torch.cuda.synchronize()
    counts["vit_attention_ab"] = dict(kernels.launch_counts)
    del q, k, v, runs
    per = 1 + VARIANT_LAUNCHES * VARIANT_WINDOWS
    # K1 twice per round: alone and as the op (with its pre-pass).
    want = {"vit_attention": 2 * per, "key_norm_max": per,
            "vit_attention_variant": len(kernels.VARIANT_MODES) * per,
            "vit_attention_tmajor": len(kernels.TMAJOR_HP) * per,
            "vit_attention_bshd": per}
    _held_launches("vit attention A/B", want)
    ms = {name: statistics.median(t) for name, t in times.items()}
    print("vit attention A/B, ms per launch (median of "
          f"{VARIANT_WINDOWS} windows of {VARIANT_LAUNCHES}): "
          + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()))

    kernels.reset_launch_counts()
    rows = block_ab.run(tiles=VARIANT_SHAPE[0], chain=BLOCK_CHAIN,
                        reps=BLOCK_REPS, hp=hp)
    torch.cuda.synchronize()
    counts["vit_block_ab"] = dict(kernels.launch_counts)
    per = 1 + BLOCK_REPS * BLOCK_CHAIN + 4  # warm-up, timed, profiled
    _held_launches("vit block A/B", _with_prepass({
        "vit_attention": per, "vit_attention_bshd": 2 * per,
        "vit_attention_tmajor": per}))
    block_ab.report(rows, VARIANT_SHAPE[0], BLOCK_CHAIN)
    return {"attention_ab_ms": ms, "block_ab": rows, "block_hp": hp}, counts


def _bf16_matmul_ms(x, K, N):
    """bf16 ``torch.matmul`` of x's rows by a (K, N) bf16 weight: a
    labelled reference point, not the same function (no quantization)."""
    import torch

    w = torch.randn((K, N), device=x.device, dtype=torch.bfloat16)
    return _median_ms(lambda: torch.matmul(x, w))


def cold_l2_ms(run, copies, min_launches=16, replays=5):
    """Device time per launch with the L2 cold: ``run(*copy)`` for each of
    ``copies`` (operand copies totalling more than COLD_L2_BYTES), in order
    and round again until ``min_launches``, captured into one CUDA graph
    (no host time between launches) and replayed; CUDA events around each
    replay.  Returns the median replay over its launches, in ms."""
    import torch

    rounds = max(1, -(-min_launches // len(copies)))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for c in copies:
                run(*c)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times) / (rounds * len(copies))


def weight_copies(tensors, nbytes=COLD_L2_BYTES):
    """Copies of ``tensors`` (each with its strides), as many as it takes to
    pass ``nbytes`` together, and at least two."""
    size = _nbytes(*tensors)
    return [tuple(t.clone() for t in tensors)
            for _ in range(max(2, nbytes // size + 1))]


def int4pack_library(packed, scale, group):
    """PyTorch's int4 weight-only product on K5's operands, a yardstick the
    port never calls: the biased nibbles of the half-split ``packed``
    (k-major, (K/2, N)) repacked two consecutive k a byte, the even one
    high, and converted once to ``torch._weight_int4pack_mm``'s tiled
    layout; each scale beside a zero of 0, so it dequantizes (nibble - 8) *
    scale, sums in fp32 and returns x's dtype.  Returns the operands after
    x, or None where it does not take the shape (N not a multiple of 8, a
    group not in 32-256, K not a multiple of 128)."""
    import torch

    K2, N = packed.shape
    if N % 8 or group not in (32, 64, 128, 256) or (2 * K2) % 128:
        return None
    b = packed.t().view(torch.uint8)
    q = torch.cat([b & 15, b >> 4], dim=1)
    w = torch._convert_weight_to_int4pack(
        ((q[:, 0::2] << 4) | q[:, 1::2]).contiguous(), 8)
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).contiguous()
    return w, group, sz


def _bit_equal(names):
    """An ``extra`` rule of ``_check_kernel``: every output equal to the
    twin's to the bit."""
    import torch

    def rule(got, ref):
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        return (f"bit-equal to the twin ({', '.join(names)}): {same}", same,
                {"bit_equal": same})
    return rule


def time_q8g_in_turns(x, qk, xq, a_s, odt, rounds=10):
    """K6, K7 and K6's pre-pass launched directly, bf16 ``torch.matmul`` of
    the same (M, K) by (K, N) and ``torch._int_mm`` on the same int8
    operands (where it takes the shape: M > 16, K and N multiples of 8),
    timed in turns by CUDA events; the last two are labelled references,
    not the same function.  Returns the medians in ms."""
    import torch

    from mjvideo_tpu_torch import kernels

    K, N = qk.q.shape
    G = qk.scale.shape[0]
    w16 = torch.randn((K, N), device=x.device).to(torch.bfloat16)
    runs = {
        "K6": lambda: kernels.q8g_matmul_fused(x, qk.q, qk.scale, odt),
        "K7": lambda: kernels.q8g_matmul(xq, a_s, qk.q, qk.scale),
        "K6 pre-pass": lambda: kernels.q8g_quantize(x, G),
        "bf16 matmul": lambda: torch.matmul(x, w16),
    }
    if x.shape[0] > 16 and K % 8 == 0 and N % 8 == 0:
        # The k-major weight is the column-major operand _int_mm takes.
        runs["_int_mm"] = lambda: torch._int_mm(xq, qk.q)
    return _in_turns(runs, list(runs) + list(runs)[::-1], rounds)


def check_quant_kernels(randn, own):
    """K6, its pre-pass and K7 at Q8G_SHAPES and K5 at W4_SHAPES x W4_ROWS
    against their twins, random weights quantized by the port's own
    quantizers (every weight k-major); K6, the pre-pass and K7 bit for
    bit, and K7 against K6 on the same x; K6 and K7 in turns with bf16
    ``torch.matmul`` and ``torch._int_mm``; K5 to KERNEL_REL_TOL, a second
    launch bit-identical, and its device time a launch with the L2 cold
    (``cold_l2_ms``).  ``own`` draws W4_OWN_SHAPES and W4_OWN_ROWS.
    Returns the readings by (kernel, shape)."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import quant as q8
    from mjvideo_tpu_torch.ops import quant4 as q4

    out = {}
    for M, K, N in Q8G_SHAPES:
        x = randn(M, K)
        qk = q8.quantize_kernel(randn(K, N).float() * 0.02,
                                group_size=Q8G_GROUP)
        if not q8.is_k_major(qk.q):
            raise RuntimeError(f"quantize_kernel gave strides {qk.q.stride()}"
                               ", not k-major")
        ws, G = qk.scale, K // Q8G_GROUP
        # The model's products write x's dtype; the LM head's, fp32 logits.
        odt = torch.float32 if N > 50000 else torch.bfloat16
        o = torch.empty((M, N), dtype=odt, device=x.device)
        r6 = _check_kernel(
            f"K6 q8g_matmul_fused {(M, K, N)} g {Q8G_GROUP} -> {odt}",
            lambda: kernels.q8g_matmul_fused(x, qk.q, ws, odt),
            lambda: q8.q8g_matmul_fused_plain(x, qk.q, ws, odt),
            extra=_bit_equal(("out",)),
            work=(_nbytes(x, qk.q, ws, o), 2 * M * K * N, INT8_OPS_PER_S))
        xq, a_s = q8._quantize_rows_grouped(x.float(), G, Q8G_GROUP)
        rq = _check_kernel(
            f"K6 pre-pass q8g_quantize {(M, K)} g {Q8G_GROUP}",
            lambda: kernels.q8g_quantize(x, G),
            lambda: q8._quantize_rows_grouped(x.float(), G, Q8G_GROUP),
            names=("xq", "a_s"), extra=_bit_equal(("xq", "a_s")),
            work=(_nbytes(x, xq, a_s), 4 * M * K, FP32_OPS_PER_S))
        o32 = torch.empty((M, N), dtype=torch.float32, device=x.device)
        r7 = _check_kernel(
            f"K7 q8g_matmul {(M, K, N)} g {Q8G_GROUP}",
            lambda: kernels.q8g_matmul(xq, a_s, qk.q, ws),
            lambda: q8.q8g_matmul_plain(xq, a_s, qk.q, ws),
            extra=_bit_equal(("out",)),
            work=(_nbytes(xq, a_s, qk.q, ws, o32), 2 * M * K * N,
                  INT8_OPS_PER_S))
        same = torch.equal(kernels.q8g_matmul(xq, a_s, qk.q, ws),
                           kernels.q8g_matmul_fused(x, qk.q, ws,
                                                    torch.float32))
        med = time_q8g_in_turns(x, qk, xq, a_s, odt)
        print(f"K7 against K6 on the same x {(M, K, N)}: bit-equal {same}; in "
              "turns (median of 20): " + ", ".join(
                  f"{n} {t:.4f} ms" for n, t in med.items())
              + " (bf16 torch.matmul and torch._int_mm: references)")
        if not same:
            raise RuntimeError(f"K7 and K6 differ at {(M, K, N)}")
        for r in (r6, r7):
            r["bf16_matmul_ms_in_turns"] = med["bf16 matmul"]
            r["int_mm_ms_in_turns"] = med.get("_int_mm")
        r6["ms_in_turns"], r7["ms_in_turns"] = med["K6"], med["K7"]
        rq["ms_in_turns"] = med["K6 pre-pass"]
        # Device time a launch (the profiler): the pre-pass alone, K6's two
        # kernels (the GEMM starts behind the pre-pass) and K7; K6 back to
        # back, where the overlap shows.
        dev6 = device_ms(lambda: kernels.q8g_matmul_fused(x, qk.q, ws, odt))
        rq["device_ms"] = device_ms(
            lambda: kernels.q8g_quantize(x, G)).get("pre-pass")
        r7["device_ms"] = device_ms(lambda: kernels.q8g_matmul(
            xq, a_s, qk.q, ws)).get("gemm")
        r6["device_ms_by_kernel"] = dev6
        r6["back_to_back_ms"] = stream_ms(
            lambda: kernels.q8g_matmul_fused(x, qk.q, ws, odt))
        print(f"K6 {(M, K, N)}: device time a launch, the pre-pass alone "
              f"{_ms(rq['device_ms'])} (bound {rq['bound_ms']:.4f}), in K6 "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in dev6.items())
              + f"; K7 {_ms(r7['device_ms'])}; K6 back to back "
              f"{r6['back_to_back_ms']:.4f} ms a call")
        out["K6", (M, K, N)], out["K7", (M, K, N)] = r6, r7
        out["K6 pre-pass", (M, K, N)] = rq
        del x, qk, ws, xq, a_s, o, o32
    for K, N in W4_SHAPES:
        draw = own if (K, N) in W4_OWN_SHAPES else randn
        k4 = q4.quantize_kernel_q4(draw(K, N).float() * 0.02,
                                   group_size=W4_GROUP)
        if not q8.is_k_major(k4.packed):
            raise RuntimeError("quantize_kernel_q4 gave strides "
                               f"{k4.packed.stride()}, not k-major")
        copies = weight_copies((k4.packed, k4.scale))
        lib = int4pack_library(k4.packed, k4.scale, W4_GROUP)
        lib_copies = None if lib is None else weight_copies(lib[::2])
        for M in W4_ROWS:
            x = (own if draw is own or M in W4_OWN_ROWS else randn)(M, K)
            o = torch.empty((M, N), dtype=torch.float32, device=x.device)
            library = None if lib is None else (
                lambda: torch._weight_int4pack_mm(x, *lib))
            r5 = _check_kernel(
                f"K5 w4_matmul {(M, K, N)} g {W4_GROUP}",
                lambda: kernels.w4_matmul(x, k4.packed, k4.scale),
                lambda: q4.w4_matmul_plain(x, k4.packed, k4.scale),
                extra=_again(lambda: kernels.w4_matmul(x, k4.packed,
                                                       k4.scale)),
                work=(_nbytes(x, k4.packed, k4.scale, o), 2 * M * K * N,
                      BF16_OPS_PER_S), library=library)
            r5["bf16_matmul_ms"] = _bf16_matmul_ms(x, K, N)
            r5["device_ms_cold"] = cold_l2_ms(
                lambda p, sc: kernels.w4_matmul(x, p, sc), copies)
            r5["bound_share_cold"] = r5["bound_ms"] / r5["device_ms_cold"]
            r5["library_ms_cold"] = r5["library_rel_err"] = None
            if lib is not None:
                # The yardstick must compute K5's function: held to the
                # same bar (its bf16 output rounds once more).
                rel = _rel_err(library().float(), q4.w4_matmul_plain(
                    x, k4.packed, k4.scale))[1]
                if not rel <= KERNEL_REL_TOL:
                    raise RuntimeError(
                        f"_weight_int4pack_mm {(M, K, N)}: {rel:.3e} of "
                        "max|plain|: the repacked weight is not K5's")
                r5["library_rel_err"] = rel
                r5["library_ms_cold"] = cold_l2_ms(
                    lambda w, sz: torch._weight_int4pack_mm(
                        x, w, W4_GROUP, sz), lib_copies)
            r5["plan"] = kernels.w4_plan(M, N, K, K // W4_GROUP)
            lib_text = "" if lib is None else (
                "; torch._weight_int4pack_mm (library, "
                f"{r5['library_rel_err']:.3e} of max|plain|) cold "
                f"{r5['library_ms_cold']:.4f} ms, op "
                f"{r5['library_ms']:.4f} ms")
            print(f"K5 {(M, K, N)}: device time a launch with the L2 cold "
                  f"{r5['device_ms_cold']:.4f} ms ({len(copies)} weight "
                  f"copies; {100 * r5['bound_share_cold']:.1f}% of the bound"
                  f" {r5['bound_ms']:.4f} ms), the op {r5['ms']:.4f} ms "
                  f"(host included){lib_text}; plan {r5['plan']}; bf16 "
                  "torch.matmul at this shape (reference) "
                  f"{r5['bf16_matmul_ms']:.4f} ms")
            out["K5", (M, K, N)] = r5
        del copies, lib, lib_copies
    return out


def _node_counts(state):
    """Quantized nodes of a state by class name."""
    from mjvideo_tpu_torch.ops.quant import quant_nodes

    counts = {}
    for n in quant_nodes(state):
        counts[type(n).__name__] = counts.get(type(n).__name__, 0) + 1
    return counts


def quant_scoring_phase(scorer, requests, fp32_scores, dev):
    """Phase 11: the 2B scorer's bf16 state quantized on the card in each
    SCORE_QUANT_MODES mode through ``RewardScorer(quant=...)``; the single
    clip and the pair scored, exact launch counts (K6 per request: 4 per
    ViT layer, 2 in the projector, 3 per decoder MLP under -noattn; none
    per-column), the scores against the same quantized tree through the
    plain path in fp32 (its int8 weights and scales as they are, every
    other tensor in fp32) within QUANT_SCORE_TOL, the delta against the
    unquantized fp32 plain scores reported; clips/s, peak memory, and the
    peak while quantizing.  Returns the readings and the launch counts by mode."""
    import torch

    from mjvideo_tpu_torch import RewardScorer, kernels

    cfg = scorer.cfg
    L_vit = cfg.chat.vision.num_hidden_layers
    L_llm = cfg.chat.llm.num_hidden_layers
    readings, launches = {}, {}
    for mode in SCORE_QUANT_MODES:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        qs = RewardScorer(cfg, scorer.params, scorer.tokenizer,
                          dtype=torch.bfloat16,
                          gating_pattern=scorer.gating_pattern, quant=mode)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        quant_peak = torch.cuda.max_memory_allocated(dev)
        tree = torch.cuda.memory_allocated(dev) - base
        nodes = _node_counts(qs.params)
        print(f"quantized scoring {mode}: {nodes} nodes, quantized on the "
              f"card in {quant_s:.2f} s; the quantized tree {tree / 2**30:.2f}"
              f" GiB beside the bf16 state's {base / 2**30:.2f} GiB, peak while"
              f" quantizing {quant_peak / 2**30:.2f} GiB")

        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        scores = [qs.score_batch(*r).score for r in requests]
        torch.cuda.synchronize()
        got = dict(kernels.launch_counts)
        per_request = {"vit_attention": L_vit, "decoder_attention": L_llm}
        if "-g" in mode:
            per_request["q8g_matmul_fused"] = 4 * L_vit + 2 + 3 * L_llm
            # One pre-pass per K6 launch.
            per_request["q8g_quantize"] = per_request["q8g_matmul_fused"]
        per_request = _with_prepass(per_request)
        want = {n: len(requests) * per_request.get(n, 0) for n in got}
        print(f"quantized scoring {mode}: launches over {len(requests)} "
              f"requests {got}")
        if got != want:
            raise RuntimeError(f"{mode}: launches {got}, want {want}")
        scores = torch.cat(scores).float().cpu()
        if not torch.isfinite(scores).all():
            raise RuntimeError(f"{mode}: non-finite scores {scores.tolist()}")
        peak = torch.cuda.max_memory_allocated(dev)
        pair = requests[1]
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qs.score_batch(*pair)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t0)
        pair_s = statistics.median(times)

        plain = RewardScorer(cfg, _float_plain(qs.params), scorer.tokenizer,
                             dtype=torch.float32,
                             gating_pattern=scorer.gating_pattern,
                             attn_impl="plain")
        ref = torch.cat([plain.score_batch(*r).score for r in requests])
        ref = ref.float().cpu()
        delta = (scores - ref).abs().max().item()
        vs_fp32 = (scores - fp32_scores).abs().max().item()
        plain_vs_fp32 = (ref - fp32_scores).abs().max().item()
        print(f"quantized scoring {mode}: scores {scores.tolist()}; against "
              f"the same tree through the plain path in fp32 max|delta| "
              f"{delta:.3e} (bound {QUANT_SCORE_TOL:.0e}); against "
              f"unquantized fp32 plain max|delta| {vs_fp32:.3e}, relative to "
              f"max|fp32 score| {vs_fp32 / fp32_scores.abs().max().item():.3e}"
              f" (the plain path's {plain_vs_fp32:.3e}); pair request "
              f"median {pair_s * 1e3:.1f} ms over {len(times)} runs -> "
              f"{len(pair[1]) / pair_s:.2f} clips/s; peak memory "
              f"{peak / 2**30:.2f} GiB")
        if not delta < QUANT_SCORE_TOL:
            raise RuntimeError(f"{mode}: score delta {delta} >= "
                               f"{QUANT_SCORE_TOL}")
        readings[mode] = {
            "nodes": nodes, "quantize_s": quant_s,
            "quantize_peak_gib": quant_peak / 2**30,
            "tree_gib": tree / 2**30, "bf16_state_gib": base / 2**30,
            "delta_vs_plain": delta, "delta_vs_fp32": vs_fp32,
            "plain_delta_vs_fp32": plain_vs_fp32,
            "pair_ms": pair_s * 1e3, "clips_per_s": len(pair[1]) / pair_s,
            "peak_gib": peak / 2**30}
        launches[f"serving {mode}"] = got
        del qs, plain
        torch.cuda.empty_cache()
    return readings, launches


def _float_plain(state):
    """The plain tensors of a state in fp32, inside kernel nodes too (a
    LoRA node's adapters); quantized nodes (a LoRA node's frozen base
    included) as they are."""
    from dataclasses import replace

    from mjvideo_tpu_torch.ops.quant import is_qnode
    from mjvideo_tpu_torch.utils.bridge import is_node, node_fields

    if isinstance(state, dict):
        return {k: _float_plain(v) for k, v in state.items()}
    if is_qnode(state):
        return state
    if is_node(state):
        return replace(state, **{name: _float_plain(v)
                                 for name, v in node_fields(state)})
    return state.float()


def quant_judge_phase(dev, bf16_step_ms):
    """Phase 12: an ``InternVLJudge(quant=JUDGE_QUANT_MODE)`` made like
    phase 9's (the same seed: the same bf16 weights, quantized on the card)
    answers the pair through ``judge_pair`` (the full-prompt path); K5
    launches exact (one for the LM head at the end of the prefill, then per
    decode step 7 per decoder layer and the LM head: every product of B = 2
    rows), none of the others but K1 and K3; teacher-forced logits held to
    LOGITS_REL_TOL of max|logit| against the same int4 tree through the
    plain path in fp32; then phase 9's timing.  Returns the readings and
    the launch counts."""
    import gc

    import torch

    from mjvideo_tpu_torch import judge_pair, kernels, overall_prompt

    videos = ("video_0", "video_1")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    judge = make_judge(generator=torch.Generator(device=dev)
                       .manual_seed(SEED), device=dev, quant=JUDGE_QUANT_MODE)
    L_vit = judge.cfg.vision.num_hidden_layers
    L_llm = judge.cfg.llm.num_hidden_layers
    nodes = _node_counts(judge.params)
    print(f"quantized judge {JUDGE_QUANT_MODE}: {nodes} nodes; made and "
          f"quantized on the card, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    kernels.reset_launch_counts()
    s0, s1, r0, r1 = judge_pair(judge, *videos, JUDGE_CAPTION)
    torch.cuda.synchronize()
    got = dict(kernels.launch_counts)
    prompt = overall_prompt(JUDGE_CAPTION)
    toks = path_runner(judge, prompt, videos, False)()
    drawn = _drawn(judge, toks)
    per_step = 7 * L_llm + 1
    want = {n: 0 for n in got}
    want.update(vit_attention=2 * L_vit, exact_attention=L_llm,
                w4_matmul=1 + per_step * (drawn - 1))
    want = _with_prepass(want)
    print(f"quantized judge launches ({drawn} tokens drawn, {drawn - 1} "
          f"decode steps): {got}")
    if got != want:
        raise RuntimeError(f"quantized judge: launches {got}, want {want}")
    print(f"quantized judge: ratings {s0}, {s1}; answers {r0!r:.60}, "
          f"{r1!r:.60}")
    out = {"nodes": nodes}
    plain = make_judge(state=_float_plain(judge.params))
    _, out["full_rel"], _, _ = logits_fidelity(
        judge, plain, prompt, videos, False, f"{JUDGE_QUANT_MODE} full prompt")
    del plain
    torch.cuda.empty_cache()
    if not out["full_rel"] <= LOGITS_REL_TOL:
        raise RuntimeError(f"quantized judge logits {out['full_rel']} > "
                           f"{LOGITS_REL_TOL}")
    ptoks = path_runner(judge, JUDGE_QUESTION, videos, True)()
    torch.cuda.reset_peak_memory_stats(dev)
    out.update(time_judge(judge, videos, drawn, _drawn(judge, ptoks)))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"quantized judge: decode step at B = 2 {out['decode_step_ms']:.2f}"
          f" ms against {bf16_step_ms:.2f} ms in bf16 (phase 9); peak memory "
          f"{out['peak_gib']:.2f} GiB while timing")
    return out, {"judge int4": got}


def make_judge(state=None, generator=None, device=None, quant=None,
               base=None, impl=None, pixel_dtype=None, **kw):
    """An ``InternVLJudge`` on the chat config ``base`` (the 2B's by
    default) rebased on the ``ByteTokenizer``, with random bf16 weights
    drawn on the card from ``generator`` (or ``state``, e.g. an fp32 copy,
    which then runs the plain path), in the serving mode ``quant`` if one
    is given; ``impl`` in place of the one the state's dtype picks.  Its
    videos are seeded pixels: a video's name seeds its frames, so two
    judges see the same ones, rounded to bf16 as the judge feeds them and
    then given in ``pixel_dtype`` (the vision weights' dtype by default).
    ``kw``: the judge's other arguments (``kv_quant``, ``mesh``)."""
    import numpy as np
    import torch

    from mjvideo_tpu_torch.data.prompts import rebase_img_context_id
    from mjvideo_tpu_torch import (
        ByteTokenizer,
        InternVLJudge,
        extract_feature,
        init_chat_params,
        internvl2_2b_chat_config,
    )
    from mjvideo_tpu_torch.parallel.mesh import held
    from mjvideo_tpu_torch.utils.bridge import first_tensor

    base = internvl2_2b_chat_config() if base is None else base
    tok = ByteTokenizer(pad_token_id=base.llm.pad_token_id)
    cfg = rebase_img_context_id(base, tok)
    if state is None:
        state = init_chat_params(cfg, generator=generator, device=device,
                                 dtype=torch.bfloat16, with_lm_head=True)
    if impl is None:
        impl = ("plain" if first_tensor(state).dtype == torch.float32
                else "auto")

    class SeededVideoJudge(InternVLJudge):
        """Seeded pixels in place of a decoded video: the card's machine
        has no video decoder."""

        def _encode_video(self, video_path):
            rng = np.random.default_rng([SEED, sum(map(ord, video_path))])
            size = self.cfg.image_size
            pix = rng.normal(size=(JUDGE_FRAMES, size, size, 3))
            # bf16 pixels, as the judge feeds, in the weights' dtype.
            pix = torch.from_numpy(pix).to(self.device, torch.bfloat16)
            dtype = (pixel_dtype or first_tensor(
                held(self.params)[0]["vision_model"]).dtype)
            with torch.no_grad():
                vis = extract_feature(self.params, self.cfg, pix.to(dtype),
                                      impl=self.attn_impl, mesh=self.mesh)
            return vis, [1] * JUDGE_FRAMES

    return SeededVideoJudge(cfg, state, tok, num_segments=JUDGE_FRAMES,
                            max_new_tokens=JUDGE_NEW_TOKENS, attn_impl=impl,
                            quant=quant, **kw)


def _judge_launches(cfg, want):
    """``want`` with K3's launches also under its D = 96 name at Phi-3's
    head dim, and K1's under its D = 128 name at InternViT-6B's."""
    want = dict(want)
    if cfg.llm.head_dim == 96 and "exact_attention" in want:
        want["exact_attention_d96"] = want["exact_attention"]
    if cfg.vision.head_dim == 128 and "vit_attention" in want:
        want["vit_attention_d128"] = want["vit_attention"]
    return want


def _full_inputs(judge, prompt, videos):
    """The full-prompt path's inputs: left-padded ids and mask, the
    generation config, and the videos' embeds."""
    import torch

    from mjvideo_tpu_torch.data.prompts import build_video_question
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

    mesh = judge.mesh
    if prefix:
        state, sids, smask, gc = judge._prefix_inputs(prompt, videos)
        return lambda **kw: generate_from_prefix(
            judge.params, judge.cfg, state, sids, smask,
            generation_config=gc, impl=judge.attn_impl, mesh=mesh, **kw)
    ids, mask, gc, vis = _full_inputs(judge, prompt, videos)
    return lambda **kw: generate(judge.params, judge.cfg, ids, mask,
                                 generation_config=gc, vision_embeds=vis,
                                 impl=judge.attn_impl, mesh=mesh, **kw)


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


def judge_phase(device, seed=SEED, timing=True, base=None, name="judge"):
    """Phase 9 on the 2B chat config, or phase 24's judge on ``base`` (the
    4B's; its pass under the per-row bound is phase 26's).  Returns the
    readings and the launch counts by path, named ``name``_...."""
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
                       .manual_seed(seed), device=device, base=base)
    rows = judge.cfg.llm.head_dim != 96
    L_vit = judge.cfg.vision.num_hidden_layers  # select_layer -1: all run
    L_llm = judge.cfg.llm.num_hidden_layers
    out = {}
    launches = {}

    # The full-prompt path (the overall prompt overflows the suffix bucket).
    kernels.reset_launch_counts()
    s0, s1, r0, r1 = judge_pair(judge, *videos, JUDGE_CAPTION)
    torch.cuda.synchronize()
    launches[f"{name}_full"] = _held_launches(
        f"{name} full prompt", _judge_launches(judge.cfg, _with_prepass(
            {"vit_attention": 2 * L_vit, "exact_attention": L_llm})))
    # At random weights the greedy ids lie above the ByteTokenizer's 261
    # (bytes and specials), which decode to nothing: answers are text,
    # often empty, and ratings 0.
    print(f"judge full prompt: ratings {s0}, {s1}; answers {r0!r:.60}, "
          f"{r1!r:.60}")
    # The prefix path: two prefix prefills and one continuation.
    kernels.reset_launch_counts()
    answers = judge.ask_batch(JUDGE_QUESTION, list(videos))
    torch.cuda.synchronize()
    launches[f"{name}_prefix"] = _held_launches(
        f"{name} prefix", _judge_launches(judge.cfg,
                                          {"exact_attention": 3 * L_llm}))
    print(f"judge prefix: answers {[a[:60] for a in answers]!r}")
    if not all(isinstance(a, str) for a in (r0, r1, *answers)):
        raise RuntimeError("an answer did not decode to text")
    # The prefix path again under the per-row bound (fresh prefix states).
    judge._pstate.cache_clear()
    gen._CACHE_BOUND = "rows"
    try:
        if rows:
            kernels.reset_launch_counts()
            judge.ask_batch(JUDGE_QUESTION, list(videos))
            torch.cuda.synchronize()
            launches[f"{name}_prefix_rows"] = _held_launches(
                f"{name} prefix rows", {"decoder_attention_rows": 3 * L_llm,
                                        "key_norm_cummax": 3 * L_llm})
    finally:
        gen._CACHE_BOUND = False
        judge._pstate.cache_clear()
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30

    # Teacher-forced logits against fp32 plain, both paths.
    plain = make_judge(state=map_state(lambda t: t.float(), judge.params),
                       base=base)
    prompt = overall_prompt(JUDGE_CAPTION)
    _, out["full_rel"], otoks, _ = logits_fidelity(judge, plain, prompt,
                                                   videos, False, "full prompt")
    _, out["prefix_rel"], ptoks, plogits = logits_fidelity(
        judge, plain, JUDGE_QUESTION, videos, True, "prefix")
    # The prefix path under the per-row bound (K2r): the plain judge takes
    # the exact softmax, which the bound does not change.
    judge._pstate.cache_clear()
    gen._CACHE_BOUND = "rows"
    try:
        if rows:
            _, out["prefix_rows_rel"], _, _ = logits_fidelity(
                judge, plain, JUDGE_QUESTION, videos, True, "prefix (rows)")
    finally:
        gen._CACHE_BOUND = False
        judge._pstate.cache_clear()
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
    for key in ("full_rel", "prefix_rel") + (("prefix_rows_rel",) if rows
                                              else ()):
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
    states cached after the first call; PAIR_REPS each), whose loops draw
    ``drawn_full`` and ``drawn_prefix`` tokens."""
    import torch

    from mjvideo_tpu_torch import judge_pair, overall_prompt
    from mjvideo_tpu_torch.models import generate as gen

    ids, mask, _, vis = _full_inputs(judge, overall_prompt(JUDGE_CAPTION),
                                     videos)
    lm, cfg = judge.params["language_model"], judge.cfg

    def prefill():
        embeds = gen._embed(judge.params, cfg, ids, None, vis, "auto")
        return gen._prefill(judge.params, cfg, embeds, ids, mask,
                            JUDGE_NEW_TOKENS, "auto", False)

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
        lambda: judge_pair(judge, *videos, JUDGE_CAPTION), PAIR_REPS) / 1e3
    for video in videos:  # the prefix states, cached as a warm pair has them
        judge._pstate(video)
    t["pair_prefix_s"] = _host_ms(
        lambda: judge.ask_batch(JUDGE_QUESTION, list(videos)),
        PAIR_REPS) / 1e3
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
    TRAIN_FRAMES-frame clips (batch 1), with random labels; the prompts'
    gating pattern is that of ``cfg``'s chat template (the 2B's Hermes-2
    takes the InternLM2 pattern, the 4B's ``phi3-chat`` its own)."""
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
                gating_pattern=tok.gating_pattern(cfg.chat.template))
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


def train_data(cfg=None):
    """The 2B config (or ``cfg``) rebased on the ``ByteTokenizer``, and
    TRAIN_MICRO_BATCHES seeded micro-batches for it."""
    import numpy as np

    from mjvideo_tpu_torch.data.prompts import rebase_img_context_id
    from mjvideo_tpu_torch import ByteTokenizer, mjvideo_2b_config

    cfg = mjvideo_2b_config() if cfg is None else cfg
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    cfg = rebase_img_context_id(cfg, tok)
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


def train_config(checkpoint_dir):
    """Phase 5's ``TrainConfig``: stage 3, accumulation 2, remat."""
    from mjvideo_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(stage=3, learning_rate=1e-3, warmup_steps=0,
                       gradient_accumulation_steps=2, remat=True, log_every=1,
                       checkpoint_every=10**9, checkpoint_dir=checkpoint_dir)


def make_trainer(generator, device, checkpoint_dir, data=None):
    """A 2B stage-3 ``Trainer`` with random bf16 weights drawn on the card,
    and its micro-batches (``data``, or ``train_data()``)."""
    import torch

    from mjvideo_tpu_torch import init_reward_params
    from mjvideo_tpu_torch.train.trainer import Trainer

    cfg, batches = train_data() if data is None else data
    params = init_reward_params(cfg, generator=generator, device=device,
                                dtype=torch.bfloat16)
    return Trainer(cfg, params, train_config(checkpoint_dir)), batches


def run_training(generator, device, checkpoint_dir, data):
    """Phase 5.  Returns the trainer, its batches, the launch counts and the
    peak memory in bytes."""
    trainer, batches = make_trainer(generator, device, checkpoint_dir, data)
    launches, peak = check_training(trainer, batches, device)
    return trainer, batches, launches, peak


def check_training(trainer, batches, device, label="training"):
    """Phase 5's checks on ``trainer``: one micro-step per batch, finite
    losses and grad norms, an optimizer step per 2 micro-batches, frozen
    tensors bit-identical and each trainable subtree changed, the launches
    exact.  Returns the launch counts and the peak memory in bytes."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.train.trainer import flatten_state

    cfg = trainer.cfg
    before = {p: t.clone() for p, t in flatten_state(trainer.params).items()}
    print(f"{label}: {len(batches)} micro-batches, prompt lengths "
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
    print(f"{label}: optimizer steps {trainer.opt_state['gradient_step']}; "
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
    per_video = _at_d96(cfg, _with_prepass(per_video))
    want = {k: 2 * len(batches) * per_video.get(k, 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"{label} launches {launches}, want {want}")
    return launches, peak


def time_training(trainer, batches, steps=TRAIN_TIMED_STEPS):
    """Phase 7: ``steps`` micro-steps after the checks, each timed on the
    host clock after ``synchronize``; returns the median ms of those that
    only accumulate and of those that also step the optimizer."""
    import torch

    times = {"accumulate": [], "optimizer": []}
    for i in range(steps):
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
    """Phase 6: (loss delta, relative L2 error, cosine, the fp32 plain
    gradient) of the trainable gradient, bf16 kernels against fp32 plain,
    same weights and batch."""
    import torch

    from mjvideo_tpu_torch import map_state

    paths = trainer.optimizer.paths

    def grads(params, impl, dtype):
        return trainable_grads(trainer.cfg, trainer.tc, params, paths, batch,
                               impl, dtype, trainer.device)

    loss_k, g_k = grads(trainer.params, "auto", torch.bfloat16)
    p32 = map_state(lambda t: t.detach().float(), trainer.params)
    loss_p, g_p = grads(p32, "plain", torch.float32)
    del p32
    rel_l2, cos, norm = _agreement(g_k, g_p)
    del g_k
    print(f"gradient fidelity: loss bf16+kernels {loss_k:.6f}, fp32 plain "
          f"{loss_p:.6f} (delta {abs(loss_k - loss_p):.3e}); gradient "
          f"relative L2 error {rel_l2:.4e} (bound {FIDELITY_REL_L2}), cosine "
          f"{cos:.6f} (bound {FIDELITY_COS}), |g| fp32 plain "
          f"{norm:.4e}")
    if not (rel_l2 <= FIDELITY_REL_L2 and cos >= FIDELITY_COS):
        raise RuntimeError(f"gradient fidelity: relative L2 {rel_l2}, "
                           f"cosine {cos}")
    return abs(loss_k - loss_p), rel_l2, cos, g_p


def trainable_grads(cfg, tc, params, paths, batch, impl, dtype, device):
    """(loss, the gradients of ``paths``) of one micro-batch's loss under
    ``tc`` with ``attn_impl=impl``, the batch placed in ``dtype``."""
    from dataclasses import replace

    import torch

    from mjvideo_tpu_torch.train.trainer import (
        flatten_state,
        make_loss_fn,
        place_batch,
        set_trainable,
    )

    set_trainable(params, set(paths))
    flat = flatten_state(params)
    loss = make_loss_fn(cfg, replace(tc, attn_impl=impl))(
        params, place_batch(batch, device, dtype))
    return loss.item(), torch.autograd.grad(loss, [flat[p] for p in paths])


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


def clip_prompt(chat_cfg, tok, gating_pattern, caption):
    """The scoring prompt of one FRAMES-frame clip (``prepare_chat_input``)."""
    from mjvideo_tpu_torch import build_video_question, prepare_chat_input

    return prepare_chat_input(chat_cfg, tok,
                              build_video_question(caption, FRAMES),
                              num_patches_list=[1] * FRAMES,
                              gating_pattern=gating_pattern)


def single_clip_length(cfg=None):
    """The prompt length of phase 14's single clip (phase 25's with the 4B
    ``cfg``), as ``make_scorer``'s (``make_scorer_4b``'s) tokenizer and
    scorer (its config rebased on the tokenizer) and ``make_requests`` make
    it."""
    from mjvideo_tpu_torch import ByteTokenizer, mjvideo_2b_config
    from mjvideo_tpu_torch.data.prompts import rebase_img_context_id

    cfg = mjvideo_2b_config() if cfg is None else cfg
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    chat = clip_prompt(rebase_img_context_id(cfg, tok).chat, tok,
                       tok.gating_pattern(cfg.chat.template), SINGLE_CAPTION)
    return chat.input_ids.shape[1]


def make_requests(scorer, rng):
    """One single clip and one pair: (pixels, ids list, gating positions)."""
    import numpy as np

    size = scorer.cfg.chat.image_size

    def clip(caption):
        chat = clip_prompt(scorer.cfg.chat, scorer.tokenizer,
                           scorer.gating_pattern, caption)
        pix = rng.normal(size=(FRAMES, size, size, 3)).astype(np.float32)
        return pix, chat.input_ids[0], chat.gating_pos

    single = [clip(SINGLE_CAPTION)]
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
    path; returns (max |delta|, max |delta| / max |plain score|, the plain
    scores)."""
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
    return delta, rel, ref


def _grad_launches(cfg, steps=1, forwards=2):
    """The launch counts of ``steps`` value-and-gradients of the reward
    under remat: per ViT layer K1 with the lse twice (the forward, then the
    recompute; ``forwards=1`` without remat) and K4 nc once; per decoder
    layer K2 with the lse twice and K4a and K4b once; the pre-pass before
    each K1 and K2; nothing else (``_at_d96``: the decoder's at their D =
    96 names too)."""
    L_vit = cfg.chat.vision.num_hidden_layers
    L_llm = cfg.chat.llm.num_hidden_layers
    f = forwards
    per = {"vit_attention": f * L_vit, "vit_attention_lse": f * L_vit,
           "vit_attention_bwd_dkdv": L_vit, "vit_attention_bwd_dq": L_vit,
           "decoder_attention": f * L_llm, "decoder_attention_lse": f * L_llm,
           "decoder_attention_bwd_dkdv": L_llm,
           "decoder_attention_bwd_dq": L_llm}
    return {name: steps * n
            for name, n in _at_d96(cfg, _with_prepass(per)).items()}


def _hold(label, got, want):
    """Hold launch counts ``got`` to ``want`` (names not given: 0)."""
    print(f"{label} launches: {got}")
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise RuntimeError(f"{label}: launches {got}, want {full}")
    return got


def _held_launches(label, want):
    """Hold the launch counters to ``want`` (names not given: 0)."""
    from mjvideo_tpu_torch import kernels

    return _hold(label, dict(kernels.launch_counts), want)


def _compare_grads(got, ref):
    """(relative L2 error, cosine) of one gradient against a reference, in
    fp64."""
    a, b = got.double().flatten(), ref.double().flatten()
    rel = ((a - b).norm() / b.norm()).item()
    cos = (a @ b / (a.norm() * b.norm())).item()
    return rel, cos


def plain_pixel_grad(scorer, request, dev, dtype):
    """The score of a one-clip request and its gradient to the pixels with
    the scorer's weights in ``dtype`` through the plain attention path
    (pure autograd)."""
    import torch

    from mjvideo_tpu_torch import RewardScorer, map_state

    pixels, ids, gpos = request
    plain = RewardScorer(scorer.cfg, map_state(lambda t: t.to(dtype),
                                               scorer.params),
                         scorer.tokenizer, dtype=dtype,
                         length_buckets=scorer.buckets,
                         gating_pattern=scorer.gating_pattern,
                         attn_impl="plain")
    pix = torch.from_numpy(pixels).to(dev).requires_grad_()
    score = plain.score_fn(ids[0], gpos[0])(pix)
    (grad,) = torch.autograd.grad(score, pix)
    del plain
    torch.cuda.empty_cache()
    return score.float().item(), grad


def reward_gradient_phase(scorer, request, dev, timing=True):
    """Phase 14: ``score_fn`` of one clip and its gradient to the pixels on
    the bf16 kernel path, against ``score_batch`` and against fp32 plain
    autograd.  Returns the readings and the launch counts."""
    import torch

    from mjvideo_tpu_torch import kernels

    pixels, ids, gpos = request
    n_tiles = pixels.shape[0]
    batch_score = scorer.score_batch(*request).score[0].float().item()
    f = scorer.score_fn(ids[0], gpos[0])
    pix = torch.from_numpy(pixels).to(dev).requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    score = f(pix)
    (grad,) = torch.autograd.grad(score, pix)
    torch.cuda.synchronize()
    launches = _held_launches("reward gradient", _grad_launches(scorer.cfg))
    peak = torch.cuda.max_memory_allocated(dev)
    score = score.float().item()
    per_tile = grad.reshape(n_tiles, -1).abs().amax(1)
    finite = bool(torch.isfinite(grad).all()) and math.isfinite(score)
    print(f"reward gradient: score {score:.6f}, score_batch {batch_score:.6f} "
          f"(delta {abs(score - batch_score):.3e}, bound {SCORE_TOL:.0e}); "
          f"pixel gradient {tuple(grad.shape)} finite {finite}, max|g| per "
          f"tile {[f'{x:.3e}' for x in per_tile.tolist()]}; peak memory "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
          "state)")
    if not finite or not bool((per_tile > 0).all()):
        raise RuntimeError("reward gradient: non-finite, or zero on a tile")
    if not abs(score - batch_score) < SCORE_TOL:
        raise RuntimeError(f"reward gradient: score {score} against "
                           f"score_batch's {batch_score}")

    score32, grad32 = plain_pixel_grad(scorer, request, dev, torch.float32)
    rel, cos = _compare_grads(grad, grad32)
    print(f"reward gradient against fp32 plain autograd: score {score:.6f} "
          f"against {score32:.6f}; pixel gradient relative L2 error "
          f"{rel:.4e} (bound {REWARD_GRAD_REL_L2}), cosine {cos:.6f} (bound "
          f"{REWARD_GRAD_COS}), |g| fp32 plain {grad32.norm().item():.4e}")
    out = {"score": score, "batch_score": batch_score,
           "score32": score32, "rel_l2": rel, "cos": cos,
           "peak_gib": peak / 2**30, "tiles": n_tiles}
    if not (rel <= REWARD_GRAD_REL_L2 and cos >= REWARD_GRAD_COS):
        raise RuntimeError(f"reward gradient: relative L2 {rel}, cosine "
                           f"{cos}")
    if timing:
        def value_and_grad():
            torch.autograd.grad(f(pix), pix)

        value_and_grad()
        out["ms"] = _host_ms(value_and_grad)
        print(f"reward gradient: {out['ms']:.1f} ms per value-and-gradient of "
              f"one {n_tiles}-frame clip (median of 3)")
    return out, launches


def vader_phase(scorer, dev):
    """Phase 15: VADER_STEPS steps of the example's reward-feedback loop on
    the scorer's weights.  Returns the readings and the launch counts."""
    import torch

    from mjvideo_tpu_torch import RewardScorer, kernels
    from mjvideo_tpu_torch.examples import vader_loop

    # The example's scorer: the same weights, one 4,096 bucket.
    loop_scorer = RewardScorer(scorer.cfg, scorer.params, scorer.tokenizer,
                               dtype=scorer.dtype, length_buckets=(4096,),
                               gating_pattern=scorer.gating_pattern)
    field = vader_loop.make_field(
        VADER_FRAMES, VADER_COARSE, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    step = vader_loop.make_step(
        vader_loop.reward_fn(loop_scorer, VADER_FRAMES, VADER_CAPTION), field,
        scorer.cfg.chat.image_size, VADER_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    rewards, times = [], []
    for _ in range(VADER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rewards.append(step().float().item())
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _held_launches("VADER", _grad_launches(scorer.cfg,
                                                      VADER_STEPS))
    peak = torch.cuda.max_memory_allocated(dev)
    rise = rewards[-1] - rewards[0]
    print(f"VADER: rewards {[f'{r:+.6f}' for r in rewards]} over "
          f"{VADER_STEPS} steps (rise {rise:+.3e}, reported); ms per step "
          f"{[round(t, 1) for t in times]} (median of the last "
          f"{VADER_STEPS - 1}: {statistics.median(times[1:]):.1f}); peak "
          f"memory {peak / 2**30:.2f} GiB")
    if not all(math.isfinite(r) for r in rewards):
        raise RuntimeError(f"VADER: non-finite rewards {rewards}")
    return {"rewards": rewards, "rise": rise,
            "step_ms": statistics.median(times[1:]), "first_step_ms": times[0],
            "peak_gib": peak / 2**30}, launches


def _sp_launches(cfg, kind, training=False):
    """Launches of one reward forward (one video) under sequence
    parallelism over SP_SHARDS shards of the local group: per ViT layer K1
    once per shard; per decoder layer K3 with the lse once per ring step
    and shard (SP_SHARDS**2) under the ring, K3 once per shard under
    all-gather.  ``training``: under autograd, remat runs each decoder
    layer's forward twice (K3 with the lse each time), and the backward
    launches K4a and K4b once per ring step and shard, or per shard.  The
    pre-pass of K1 runs before each K1 (``_at_d96``: the decoder's kernels
    at their D = 96 names too)."""
    n = SP_SHARDS
    L_llm = cfg.chat.llm.num_hidden_layers
    calls = (n * n if kind == "ring" else n) * L_llm
    out = {"vit_attention": n * cfg.chat.vision.num_hidden_layers}
    if not training:
        out["exact_attention"] = calls
        if kind == "ring":
            out["exact_attention_lse"] = calls
        return _at_d96(cfg, _with_prepass(out))
    out.update(exact_attention=2 * calls, exact_attention_lse=2 * calls,
               decoder_attention_bwd_dkdv=calls,
               decoder_attention_bwd_dq=calls)
    return _at_d96(cfg, _with_prepass(out))


def sp_scoring_phase(scorer, requests, scores, fp32_scores, pair_ms,
                     serving_peak, dev):
    """Phase 18: ring and all-gather scoring over ``local(SP_SHARDS)`` on
    phase 4's state and requests.  Returns the readings and the launch
    counts by path."""
    import torch

    from mjvideo_tpu_torch import RewardScorer, kernels
    from mjvideo_tpu_torch.parallel.sequence import SequenceGroup

    out, launches = {}, {}
    for kind in ("ring", "allgather"):
        sp_scorer = RewardScorer(
            scorer.cfg, scorer.params, scorer.tokenizer, dtype=scorer.dtype,
            length_buckets=scorer.buckets,
            gating_pattern=scorer.gating_pattern, sp=kind,
            sp_group=SequenceGroup.local(SP_SHARDS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        got = torch.cat([sp_scorer.score_batch(*r).score for r in requests])
        torch.cuda.synchronize()
        want = {name: len(requests) * n for name, n in
                _sp_launches(scorer.cfg, kind).items()}
        launches[f"sp_scoring_{kind}"] = _held_launches(
            f"SP scoring ({kind})", want)
        peak = torch.cuda.max_memory_allocated(dev)
        got = got.float().cpu()
        d_bf16 = (got - scores).abs().max().item()
        d_fp32 = (got - fp32_scores).abs().max().item()
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp_scorer.score_batch(*requests[1])
            torch.cuda.synchronize()
            if i:  # the first is warm-up
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        print(f"SP scoring ({kind}, {SP_SHARDS} shards): scores "
              f"{got.tolist()}; max |delta| {d_bf16:.3e} against phase 4, "
              f"{d_fp32:.3e} against fp32 plain (bound {SCORE_TOL:.0e}); "
              f"pair {ms:.1f} ms (median of {len(times)}; phase 4 "
              f"{pair_ms:.1f} ms); peak memory {peak / 2**30:.2f} GiB "
              f"(phase 4 {serving_peak / 2**30:.2f} GiB)")
        if not (torch.isfinite(got).all() and d_bf16 < SCORE_TOL
                and d_fp32 < SCORE_TOL):
            raise RuntimeError(f"SP scoring ({kind}): scores {got.tolist()}")
        out[kind] = {"scores": got.tolist(), "delta": d_bf16,
                     "delta_fp32_plain": d_fp32, "pair_ms": ms,
                     "peak_gib": peak / 2**30}
        del sp_scorer
    return out, launches


def _pad_batch(batch, unit, pad_id):
    """The batch with each video's prompt padded to a multiple of ``unit``
    tokens (pad ids, mask 0): the pooled row, the gating row and every real
    row's attention stay what they were."""
    import numpy as np

    out = dict(batch)
    for v in (0, 1):
        ids = batch[f"video_{v}_input_ids"]
        pad = (-ids.shape[1]) % unit
        out[f"video_{v}_input_ids"] = np.pad(ids, ((0, 0), (0, pad)),
                                             constant_values=pad_id)
        out[f"video_{v}_attention_mask"] = np.pad(
            batch[f"video_{v}_attention_mask"], ((0, 0), (0, pad)))
    return out


def _agreement(got, ref):
    """(relative L2 error, cosine, the reference's L2 norm) of a list of
    gradients against a reference list, over all their elements, in
    fp64."""
    dot = na = nb = nd = 0.0
    for a, b in zip(got, ref):
        a, b = a.double(), b.double()
        dot += (a * b).sum().item()
        na += a.square().sum().item()
        nb += b.square().sum().item()
        nd += (a - b).square().sum().item()
    return math.sqrt(nd / nb), dot / math.sqrt(na * nb), math.sqrt(nb)


def sp_training_phase(cfg, params, tc, batch, plain_grads, dev,
                      kinds=("ring", "allgather"), name="sp_training",
                      floor=None):
    """Phase 19: one micro-batch through a ``Trainer`` under ``tc`` with
    ``sp="ring"`` and with ``"allgather"`` (``kinds``) on ``params``; the
    gradient its accumulation buffer holds against ``plain_grads`` (phase
    6; phase 25's ring at 4B, with bf16 plain's reading as the ``floor`` of
    ``_fidelity_held``).  Returns the readings and the launch counts by
    path."""
    from dataclasses import replace

    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.parallel.sequence import SequenceGroup
    from mjvideo_tpu_torch.train.trainer import Trainer

    padded = _pad_batch(batch, SP_SHARDS * 64, cfg.chat.llm.pad_token_id)
    lengths = [padded[f"video_{v}_input_ids"].shape[1] for v in (0, 1)]
    out, launches = {}, {}
    for kind in kinds:
        sp_trainer = Trainer(cfg, params, replace(tc, sp=kind),
                             sp_group=SequenceGroup.local(SP_SHARDS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        record = sp_trainer.train([padded])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = {name: 2 * n for name, n in
                _sp_launches(cfg, kind, training=True).items()}
        launches[f"{name}_{kind}"] = _held_launches(
            f"SP training ({kind})", want)
        peak = torch.cuda.max_memory_allocated(dev)
        if sp_trainer.opt_state["gradient_step"] != 0:
            raise RuntimeError("SP training: the optimizer stepped")
        acc = sp_trainer.opt_state["acc"]
        rel, cos, _ = _agreement([acc[p] for p in sp_trainer.optimizer.paths],
                                 plain_grads)
        print(f"SP training ({kind}, {SP_SHARDS} shards, prompts padded to "
              f"{lengths}): loss {record['loss']:.6f}, grad_norm "
              f"{record['grad_norm']:.6f}; gradient against fp32 plain "
              f"(phase 6) relative L2 {rel:.4e} (bound {FIDELITY_REL_L2}), "
              f"cosine {cos:.6f} (bound {FIDELITY_COS}); micro-step "
              f"{ms:.1f} ms (the first); peak memory {peak / 2**30:.2f} GiB")
        if not math.isfinite(record["loss"]):
            raise RuntimeError(f"SP training ({kind}): loss "
                               f"{record['loss']}")
        held = _fidelity_held(f"SP training ({kind})", rel, cos, floor)
        out[kind] = {"loss": record["loss"], "rel_l2": rel, "cos": cos,
                     "step_ms": ms, "peak_gib": peak / 2**30,
                     "lengths": lengths, **held}
        del sp_trainer, acc
        torch.cuda.empty_cache()
    return out, launches


def long_request(scorer, dev):
    """BASELINE config #4's clip for ``scorer``: (pixels made on the card
    from a seed, [ids], [gating position]) and the bucket of whole 64-row
    tiles per shard that holds its prompt."""
    import torch

    from mjvideo_tpu_torch import build_video_question, prepare_chat_input

    cfg = scorer.cfg
    chat = prepare_chat_input(
        cfg.chat, scorer.tokenizer,
        build_video_question(LONG_CAPTION, LONG_FRAMES),
        num_patches_list=[LONG_TILES] * LONG_FRAMES,
        gating_pattern=scorer.gating_pattern)
    ids = chat.input_ids[0]
    unit = SP_SHARDS * 64
    size = cfg.chat.image_size
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    pixels = torch.randn((LONG_FRAMES * LONG_TILES, size, size, 3),
                         generator=g, device=dev)
    return (pixels, [ids], [chat.gating_pos]), -(-len(ids) // unit) * unit


def long_context_phase(scorer, dev):
    """Phase 20: BASELINE config #4's long clip scored with the ring over
    ``local(SP_SHARDS)`` and without sequence parallelism.  Returns the
    readings and the launch counts by path."""
    import torch

    from mjvideo_tpu_torch import RewardScorer, kernels
    from mjvideo_tpu_torch.parallel.sequence import SequenceGroup

    t_phase = time.perf_counter()
    cfg = scorer.cfg
    request, bucket = long_request(scorer, dev)
    pixels, (ids,) = request[0], request[1]
    if (bucket, len(ids)) != LONG_KEYS:
        raise RuntimeError(f"phase 3 checked the long clip's K2 op at "
                           f"{LONG_KEYS}, its (bucket, prompt) is "
                           f"{(bucket, len(ids))}")
    tiles = pixels.shape[0]
    print(f"long context: {tiles} tiles ({LONG_FRAMES} frames x "
          f"{LONG_TILES}), prompt {len(ids)} tokens, bucket {bucket}")
    L_vit = cfg.chat.vision.num_hidden_layers
    L_llm = cfg.chat.llm.num_hidden_layers
    out, launches = {"tokens": len(ids), "bucket": bucket, "tiles": tiles}, {}
    for label, kw, want in (
            ("ring", dict(sp="ring", sp_group=SequenceGroup.local(SP_SHARDS)),
             _sp_launches(cfg, "ring")),
            ("no_sp", {}, _with_prepass({"vit_attention": L_vit,
                                         "decoder_attention": L_llm}))):
        sc = RewardScorer(cfg, scorer.params, scorer.tokenizer,
                          dtype=scorer.dtype, length_buckets=(bucket,),
                          gating_pattern=scorer.gating_pattern, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        score = sc.score_batch(*request).score.float().item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[f"long_context_{label}"] = _held_launches(
            f"long context ({label})", want)
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"long context ({label}): score {score:.6f}, {ms:.1f} ms (one "
              f"call), peak memory {peak / 2**30:.2f} GiB "
              f"({(peak - base) / 2**30:.2f} GiB above the state and pixels)")
        out[label] = {"score": score, "ms": ms, "peak_gib": peak / 2**30}
        del sc
    delta = abs(out["ring"]["score"] - out["no_sp"]["score"])
    out["delta"] = delta
    print(f"long context: |ring - no SP| {delta:.3e} (bound {SCORE_TOL:.0e})")
    if not (math.isfinite(out["ring"]["score"])
            and math.isfinite(out["no_sp"]["score"]) and delta < SCORE_TOL):
        raise RuntimeError(f"long context: scores {out}")
    del pixels, request
    torch.cuda.empty_cache()
    out["command_s"] = time.perf_counter() - t_phase
    print(f"phase 20 command time {out['command_s']:.1f} s")
    return out, launches


def frame_prompts(cfg, tok, gating_pattern, max_num, captions):
    """The prompts of FRAMES-frame clips of FRAME_HW on the frames path at
    ``max_num``: (ids list, gating positions, tiles a frame)."""
    from mjvideo_tpu_torch import build_video_question, prepare_chat_input
    from mjvideo_tpu_torch.eval.scorer import device_grid, tiles_per_frame

    per_frame = tiles_per_frame(cfg, device_grid(cfg, max_num, *FRAME_HW[::-1]))
    ids, gpos = [], []
    for caption in captions:
        chat = prepare_chat_input(cfg.chat, tok,
                                  build_video_question(caption, FRAMES),
                                  num_patches_list=[per_frame] * FRAMES,
                                  gating_pattern=gating_pattern)
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
    return ids, gpos, per_frame


def frame_buckets(ids):
    """The scorer's buckets, with one of whole FRAME_BUCKET_UNIT blocks for
    prompts past the largest."""
    buckets = (1024, 2304, 3072)
    n = max(len(i) for i in ids)
    if n > buckets[-1]:
        buckets += (-(-n // FRAME_BUCKET_UNIT) * FRAME_BUCKET_UNIT,)
    return buckets


def frames_decoder_shape():
    """Phase 22's largest decoder shape, the pair at the largest max_num:
    ((2, bucket, 16, 8, 128), the shorter prompt's length)."""
    from mjvideo_tpu_torch import ByteTokenizer, mjvideo_2b_config
    from mjvideo_tpu_torch.data.prompts import rebase_img_context_id

    cfg = mjvideo_2b_config()
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    ids, _, _ = frame_prompts(rebase_img_context_id(cfg, tok), tok,
                              tok.gating_pattern(), max(FRAME_MAX_NUMS),
                              FRAME_CAPTIONS[1:])
    return (2, frame_buckets(ids)[-1], 16, 8, 128), min(len(i) for i in ids)


def _flat_state(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _rss_bytes():
    """The process's resident set now (VmRSS) and its peak (ru_maxrss)."""
    import resource

    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    return now * 1024, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def checkpoint_phase(scorer, requests, scores, dev, d, name="checkpoint"):
    """Phase 22's checkpoint round trip on phase 4's state, written into the
    directory ``d`` (phase 23 reads it again); phase 24's on the 4B's.
    Returns the readings and the launch counts of the reloaded scorer's
    requests under ``name``."""
    import shutil

    import torch

    from mjvideo_tpu_torch import (
        RewardScorer,
        kernels,
        load_reward_model,
        save_reward_checkpoint_dir,
    )

    out = {}
    out["free_disk_bytes"] = shutil.disk_usage(d).free
    print(f"checkpoint: {out['free_disk_bytes'] / 2**30:.2f} GiB free "
          "where it is written")
    t0 = time.perf_counter()
    save_reward_checkpoint_dir(d, scorer.params, scorer.cfg)
    out["write_s"] = time.perf_counter() - t0
    out["bytes"] = os.path.getsize(os.path.join(d, "model.safetensors"))
    print(f"checkpoint: wrote {out['bytes']} bytes (F32) in "
          f"{out['write_s']:.2f} s")
    rss0, rss_peak0 = _rss_bytes()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, state = load_reward_model(d)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_peak_above_gib"] = (torch.cuda.max_memory_allocated(dev)
                                  - base) / 2**30
    out["state_gib"] = (torch.cuda.memory_allocated(dev) - base) / 2**30
    rss1, rss_peak1 = _rss_bytes()
    out.update(rss_before_gib=rss0 / 2**30, rss_after_gib=rss1 / 2**30,
               rss_peak_before_gib=rss_peak0 / 2**30,
               rss_peak_after_gib=rss_peak1 / 2**30)
    print(f"checkpoint: loaded to the card (bf16) in {out['load_s']:.2f} s; "
          f"state {out['state_gib']:.2f} GiB, device peak "
          f"{out['load_peak_above_gib']:.2f} GiB above what was held before; "
          f"host RSS {out['rss_before_gib']:.2f} -> "
          f"{out['rss_after_gib']:.2f} GiB, process peak "
          f"{out['rss_peak_before_gib']:.2f} -> "
          f"{out['rss_peak_after_gib']:.2f} GiB")
    made, back = _flat_state(scorer.params), _flat_state(state)
    if set(made) != set(back):
        raise RuntimeError(f"checkpoint leaves {sorted(set(made) ^ set(back))}")
    bad = [n for n, t in made.items() if not (
        back[n].dtype == t.dtype and back[n].device == t.device
        and torch.equal(back[n], t))]
    if bad:
        raise RuntimeError(f"checkpoint leaves not bit-equal: {bad}")
    out["leaves"] = len(made)
    sc = RewardScorer(cfg, state, scorer.tokenizer, dtype=scorer.dtype,
                      gating_pattern=scorer.gating_pattern)
    kernels.reset_launch_counts()
    got = torch.cat([sc.score_batch(*r).score for r in requests])
    torch.cuda.synchronize()
    launches = _held_launches(f"{name} round trip",
                              _serving_launches(cfg, len(requests)))
    got = got.float().cpu()
    out["scores_bit_equal"] = bool(torch.equal(got, scores))
    print(f"{name}: {len(made)} leaves bit-equal; scores {got.tolist()}"
          f" bit-equal to the written state's: {out['scores_bit_equal']}")
    if not out["scores_bit_equal"]:
        raise RuntimeError(f"reloaded scores {got.tolist()} against "
                           f"{scores.tolist()}")
    del sc, state
    torch.cuda.empty_cache()
    return out, {name: launches}


def _levels(card, cpu):
    """(max |card - cpu| in levels, the share of values that differ)."""
    diff = (card.cpu() - cpu).abs()
    return diff.max().item(), (diff > 0).double().mean().item()


def frames_phase(scorer, requests, dev):
    """Phase 22's frames path at each of FRAME_MAX_NUMS on phase 4's state,
    the card's preprocessing against the CPU's, and the bytes and ms per
    clip beside phase 4's normalised pixels.  Returns the readings and the
    launch counts by path."""
    import numpy as np
    import torch

    from mjvideo_tpu_torch import RewardScorer, kernels, map_state
    from mjvideo_tpu_torch.ops import preprocess as pre

    cfg, tok, gp = scorer.cfg, scorer.tokenizer, scorer.gating_pattern
    h, w = FRAME_HW
    size = cfg.chat.image_size
    per_dispatch = _with_prepass({
        "vit_attention": cfg.chat.vision.num_hidden_layers,
        "decoder_attention": cfg.chat.llm.num_hidden_layers})
    frames = np.random.default_rng(SEED + 22).integers(
        0, 256, (len(FRAME_CAPTIONS) * FRAMES, h, w, 3), dtype=np.uint8)
    clip = torch.from_numpy(frames[:FRAMES])
    plain = map_state(lambda t: t.float(), scorer.params)
    out, launches = {}, {}
    for m in FRAME_MAX_NUMS:
        ids, gpos, per_frame = frame_prompts(cfg, tok, gp, m, FRAME_CAPTIONS)
        kw = dict(gating_pattern=gp, length_buckets=frame_buckets(ids),
                  device_preprocess=True, device_max_num=m)
        sc = RewardScorer(cfg, scorer.params, tok, dtype=scorer.dtype, **kw)
        reqs = [(frames[:FRAMES], ids[:1], gpos[:1]),
                (frames[FRAMES:], ids[1:], gpos[1:])]
        print(f"frames path (max_num {m}): {per_frame} tiles a frame, "
              f"{FRAMES * per_frame} a clip, prompts "
              f"{[len(i) for i in ids]}, buckets {sc.buckets}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        got = [sc.score_batch(*r).score for r in reqs]
        torch.cuda.synchronize()
        launches[f"frames_max_num_{m}"] = _held_launches(
            f"frames path (max_num {m}), {len(reqs)} dispatches",
            {k: n * len(reqs) for k, n in per_dispatch.items()})
        peak = torch.cuda.max_memory_allocated(dev)
        got = torch.cat(got).float().cpu()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"max_num {m}: non-finite scores {got}")
        ref_sc = RewardScorer(cfg, plain, tok, dtype=torch.float32,
                              attn_impl="plain", **kw)
        ref = torch.cat([ref_sc.score_batch(*r).score for r in reqs])
        ref = ref.float().cpu()
        delta = (got - ref).abs().max().item()
        # The card's preprocessing of one clip against the CPU's, in levels
        # before the normalisation: each resize the tiles are cut from (the
        # grid's, and the thumbnail's where there is one).
        cols, rows = sc._device_grid(w, h)
        outs = [(rows * size, cols * size)] + (
            [(size, size)] if per_frame > cols * rows else [])
        lv = [_levels(pre.resize_bicubic_device(clip.to(dev), *o),
                      pre.resize_bicubic_device(clip, *o)) for o in outs]
        levels, share = max(x[0] for x in lv), max(x[1] for x in lv)
        ms = _host_ms(lambda: sc.score_batch(*reqs[0]), reps=5)
        out[m] = {"tiles_per_clip": FRAMES * per_frame,
                  "prompts": [len(i) for i in ids], "bucket": sc.buckets[-1],
                  "scores": got.tolist(), "fp32_plain": ref.tolist(),
                  "max_abs_delta": delta, "preprocess_levels": levels,
                  "preprocess_share_differing": share,
                  "ms_per_clip": ms, "peak_gib": peak / 2**30,
                  "bytes_per_clip": frames[:FRAMES].nbytes,
                  "host_tiled_fp32_bytes_per_clip":
                      FRAMES * per_frame * size * size * 3 * 4}
        print(f"frames path (max_num {m}): scores {got.tolist()}, fp32 "
              f"plain {ref.tolist()}, max |delta| {delta:.3e} (bound "
              f"{SCORE_TOL:.0e}); preprocessing on the card against the CPU:"
              f" max {levels:.0f} level(s), {share:.3e} of values differ; "
              f"single clip {ms:.1f} ms (median of 5, the uint8 frames' copy "
              f"and the preprocessing included); peak memory "
              f"{peak / 2**30:.2f} GiB")
        if not (delta < SCORE_TOL and levels <= 1.0):
            raise RuntimeError(f"frames path (max_num {m}): {out[m]}")
        del sc, ref_sc
        torch.cuda.empty_cache()
    del plain
    torch.cuda.empty_cache()
    pix = requests[0][0]
    base_ms = _host_ms(lambda: scorer.score_batch(*requests[0]), reps=5)
    out["normalized_path"] = {"ms_per_clip": base_ms,
                              "bytes_per_clip": pix.nbytes}
    for m in FRAME_MAX_NUMS:
        print(f"bytes to the scorer per clip: frames (uint8 {h}x{w}) "
              f"{out[m]['bytes_per_clip']}, host-tiled normalised fp32 at "
              f"max_num {m} {out[m]['host_tiled_fp32_bytes_per_clip']} "
              f"(computed from the shapes); ms per clip {out[m]['ms_per_clip']:.1f}"
              f" on the frames path at max_num {m}")
    print(f"phase 4's path (normalised fp32 tiles, {pix.nbytes} bytes a "
          f"clip): {base_ms:.1f} ms per clip (median of 5)")
    return out, launches


def microbatch_sweep(scorer, dev):
    """Phase 22's sweep of ``device_batch`` on the frames path at max_num 1:
    SWEEP_CLIPS clips a call.  Returns the readings and the launch counts
    (summed over the settings)."""
    import numpy as np
    import torch

    from mjvideo_tpu_torch import RewardScorer, kernels

    cfg, tok, gp = scorer.cfg, scorer.tokenizer, scorer.gating_pattern
    h, w = FRAME_HW
    captions = [f"{FRAME_CAPTIONS[i % len(FRAME_CAPTIONS)]} Take {i}."
                for i in range(SWEEP_CLIPS)]
    ids, gpos, _ = frame_prompts(cfg, tok, gp, 1, captions)
    frames = np.random.default_rng(SEED + 23).integers(
        0, 256, (SWEEP_CLIPS * FRAMES, h, w, 3), dtype=np.uint8)
    per_dispatch = _with_prepass({
        "vit_attention": cfg.chat.vision.num_hidden_layers,
        "decoder_attention": cfg.chat.llm.num_hidden_layers})
    out, total, scores = {}, {}, {}
    for b in SWEEP_BATCHES:
        sc = RewardScorer(cfg, scorer.params, tok, dtype=scorer.dtype,
                          gating_pattern=gp, device_preprocess=True,
                          device_batch=b)
        calls = -(-SWEEP_CLIPS // b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        scores[b] = sc.score_batch(frames, ids, gpos).score.float().cpu()
        torch.cuda.synchronize()
        got = _held_launches(f"device_batch {b}", {
            k: n * calls for k, n in per_dispatch.items()})
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        peak = torch.cuda.max_memory_allocated(dev)
        times = []  # after the counted call, which warms up
        for _ in range(SWEEP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc.score_batch(frames, ids, gpos)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        s = statistics.median(times)
        out[b] = {"clips_per_s": SWEEP_CLIPS / s, "ms": s * 1e3,
                  "ms_all": [x * 1e3 for x in times], "dispatches": calls,
                  "launches_per_dispatch": {k: n // calls for k, n in
                                            got.items() if n},
                  "peak_gib": peak / 2**30}
        del sc
        torch.cuda.empty_cache()
    one = scores[max(SWEEP_BATCHES)]
    for b in SWEEP_BATCHES:
        out[b]["max_abs_delta_vs_one_forward"] = (
            scores[b] - one).abs().max().item()
        print(f"device_batch {b}: {out[b]['clips_per_s']:.2f} clips/s "
              f"({SWEEP_CLIPS} clips, median of {SWEEP_REPS} calls: "
              f"{out[b]['ms']:.1f} ms; {out[b]['dispatches']} dispatches of "
              f"{out[b]['launches_per_dispatch']}), peak memory "
              f"{out[b]['peak_gib']:.2f} GiB, max |score - one forward's| "
              f"{out[b]['max_abs_delta_vs_one_forward']:.3e}")
        if not out[b]["max_abs_delta_vs_one_forward"] < SCORE_TOL:
            raise RuntimeError(f"device_batch {b}: scores {scores[b]} "
                               f"against one forward's {one}")
    return out, {"microbatch_sweep": total}


def _path_seed(path):
    return zlib.crc32(os.path.basename(path).encode())


@contextlib.contextmanager
def seeded_video_source(hw=None):
    """Seeded frames in place of decoded videos: the card's machine has no
    cv2 and no PIL.  Replaces ``data.video``'s ``video_metadata``,
    ``decode_frames`` and ``load_video`` and ``data.dataset``'s
    ``load_video`` (bound when that module is imported) where they are
    looked up, and restores them on exit.  A video reports
    SEEDED_VIDEO_FRAMES frames at SEEDED_VIDEO_FPS; frame i of a video is
    uint8 noise of ``hw`` seeded from the video's file name and i, so that
    every reader of a path sees the same frames.  ``load_video`` (the host
    tiling path) returns one normalised tile a frame, seeded alike at the
    tile size, as ``max_num=1`` does.  ``hw`` defaults to FRAME_HW."""
    import numpy as np

    from mjvideo_tpu_torch.data import dataset, video

    hw = hw or FRAME_HW

    def noise(path, i, shape):
        rng = np.random.default_rng([SEED, _path_seed(path), int(i)])
        return rng.integers(0, 256, shape, dtype=np.uint8)

    def video_metadata(path):
        return SEEDED_VIDEO_FRAMES, SEEDED_VIDEO_FPS

    def decode_frames(path, frame_indices):
        return [noise(path, i, (*hw, 3)) for i in frame_indices]

    def load_video(path, bound=None, input_size=448, max_num=1,
                   num_segments=32):
        if max_num != 1:
            raise ValueError("the seeded video source tiles one tile a frame")
        idx = video.get_frame_indices(SEEDED_VIDEO_FRAMES, num_segments,
                                      bound=bound, fps=SEEDED_VIDEO_FPS)
        tiles = np.stack([noise(path, i, (input_size, input_size, 3))
                          for i in idx])
        return video.normalize(tiles), [1] * len(idx)

    names = ((video, "video_metadata", video_metadata),
             (video, "decode_frames", decode_frames),
             (video, "load_video", load_video),
             (dataset, "load_video", load_video))
    saved = [(m, n, getattr(m, n)) for m, n, _ in names]
    for m, n, f in names:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def eval_records(n=EVAL_PAIRS):
    """``n`` MJ-BENCH-VIDEO pair records with seeded labels (the port's
    CRITERIA_NAMES and ASPECT_NAMES) and overall preferences cycling
    through EVAL_PREFERENCES; their videos come from the seeded source."""
    import numpy as np

    from mjvideo_tpu_torch import ASPECT_NAMES, CRITERIA_NAMES

    rng = np.random.default_rng(SEED + 23)

    def labels(names):
        return {name: int(rng.choice([0, 1, 2])) for name in names}

    out = []
    for i in range(n):
        rec = {"caption": f"{FRAME_CAPTIONS[i % len(FRAME_CAPTIONS)]} "
                          f"Pair {i}.",
               "video_0_path": f"pair{i}_a.mp4",
               "video_1_path": f"pair{i}_b.mp4"}
        for v in (0, 1):
            rec[f"video_{v}_label"] = labels(CRITERIA_NAMES)
            rec[f"video_{v}_overall_score"] = labels(ASPECT_NAMES)
            rec[f"video_{v}_total_score"] = int(rng.choice([1, 2]))
        rec["category_preference"] = {
            name: str(rng.choice(EVAL_PREFERENCES)) for name in ASPECT_NAMES}
        rec["overall_preference"] = EVAL_PREFERENCES[i % len(
            EVAL_PREFERENCES)]
        out.append(rec)
    return out


def _run_main(fn, argv, timed=None):
    """``fn(argv)`` (a CLI's ``main``) with its stdout captured; returns
    (its result, what it printed, command seconds, the seconds spent inside
    ``timed`` = (module, name) if given, the launch counts)."""
    import io

    import torch

    from mjvideo_tpu_torch import kernels

    inner = []
    if timed is not None:
        mod, name = timed
        orig = getattr(mod, name)

        def clocked(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = orig(*a, **kw)
            torch.cuda.synchronize()
            inner.append(time.perf_counter() - t)
            return res

        setattr(mod, name, clocked)
    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = fn(argv)
        torch.cuda.synchronize()
    finally:
        if timed is not None:
            setattr(mod, name, orig)
    secs = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    return res, buf.getvalue(), secs, (inner[0] if inner else None), launches


def _reference_outputs(scorer, records, root, quant=None):
    """``score_batch`` of each record's pair on ``scorer``'s state, on the
    frames path at max_num 1 (optionally quantized), as fp32 numpy."""
    import numpy as np
    import torch

    from mjvideo_tpu_torch import RewardScorer

    ref = RewardScorer(scorer.cfg, scorer.params, scorer.tokenizer,
                       dtype=scorer.dtype, gating_pattern=scorer.gating_pattern,
                       device_preprocess=True, quant=quant)
    outs = []
    for rec in records:
        clips = [ref.prepare_clip(os.path.join(root, rec[f"video_{v}_path"]),
                                  rec["caption"], num_segments=FRAMES)
                 for v in (0, 1)]
        out = ref.score_batch(np.concatenate([c[0] for c in clips]),
                              [c[1] for c in clips], [c[2] for c in clips])
        outs.append({k: getattr(out, k).float().cpu().numpy()
                     for k in ("score", "rewards", "aspect_scores")})
    del ref
    torch.cuda.empty_cache()
    return outs


def _bit_equal_rows(label, rows, refs, fields):
    """Each results row's values bit-equal to the reference outputs:
    ``fields`` maps a row key prefix to an output field."""
    bad = []
    for row, ref in zip(rows, refs):
        for key, field in fields.items():
            for b in (0, 1):
                want = ref[field][b]
                got = row[f"{key}_{b}"]
                if not (want.tolist() == got if want.ndim else
                        float(want) == got):
                    bad.append((row["id"], f"{key}_{b}"))
    print(f"{label}: {len(rows)} pairs, results bit-equal to score_batch of "
          f"the same state on the same frames: {not bad}")
    if bad or len(rows) != len(refs):
        raise RuntimeError(f"{label}: rows {bad} differ from score_batch")


def eval_cli_runs(scorer, ckpt_dir, root, data_path, records, dev):
    """Phase 23's eval CLI runs.  Returns the readings and the launch counts
    by path."""
    import torch

    from mjvideo_tpu_torch import RewardScorer, map_state
    from mjvideo_tpu_torch.eval import cli as eval_cli
    from mjvideo_tpu_torch.eval import preference

    cfg = scorer.cfg
    per_pair = _with_prepass({
        "vit_attention": cfg.chat.vision.num_hidden_layers,
        "decoder_attention": cfg.chat.llm.num_hidden_layers})
    L_vit = cfg.chat.vision.num_hidden_layers
    L_llm = cfg.chat.llm.num_hidden_layers
    k6 = 4 * L_vit + 2 + 3 * L_llm
    n = len(records)

    def argv(bench, results, *extra):
        return ["--benchmark", bench, "--device", "cuda", "--byte-tokenizer",
                "--device-preprocess", "--max-num", "1", "--model-path",
                ckpt_dir, "--data-json", data_path, "--video-root", root,
                "--num-segments", str(FRAMES), "--results", results, *extra]

    refs = _reference_outputs(scorer, records, root)
    out, launches = {}, {}
    work = os.path.dirname(data_path)
    runs = (("overall", "overall", "evaluate_preference", ()),
            ("aspects", "aspects", "evaluate_aspects", ()),
            ("overall_quant", "overall", "evaluate_preference",
             ("--quant", EVAL_QUANT)))
    for label, bench, driver, extra in runs:
        results = os.path.join(work, f"{label}.jsonl")
        res, printed, secs, inner, got = _run_main(
            eval_cli.main, argv(bench, results, *extra),
            timed=(preference, driver))
        printed = json.loads(printed[printed.index("{"):])
        if printed != json.loads(json.dumps(res, default=float)):
            raise RuntimeError(f"eval CLI {label}: printed JSON differs "
                               "from the result")
        want = {k: v * n for k, v in per_pair.items()}
        if extra:
            want.update(q8g_matmul_fused=k6 * n, q8g_quantize=k6 * n)
        launches[f"eval_cli_{label}"] = _hold(f"eval CLI {label}", got, want)
        rows = preference.iter_jsonl(results)
        rows = sorted(rows, key=lambda r: r["id"])
        if label == "overall_quant":
            _bit_equal_rows(f"eval CLI {label}", rows, _reference_outputs(
                scorer, records, root, quant=EVAL_QUANT), {"score": "score"})
        elif bench == "overall":
            _bit_equal_rows(f"eval CLI {label}", rows, refs,
                            {"score": "score"})
        else:
            _bit_equal_rows(f"eval CLI {label}", rows, refs, {
                "rewards": "rewards", "aspects": "aspect_scores"})
        out[label] = {"command_s": secs, "driver_s": inner,
                      "pairs_per_s": n / inner, "result": res}
        print(f"eval CLI {label}: {n} pairs, command {secs:.2f} s (the "
              f"checkpoint's load included), driver {inner:.2f} s -> "
              f"{n / inner:.2f} pairs/s; result "
              f"{json.dumps(res, default=float)[:300]}")
    # Two pairs against fp32 plain on the same frames.
    plain = RewardScorer(cfg, map_state(lambda t: t.float(), scorer.params),
                         scorer.tokenizer, dtype=torch.float32,
                         attn_impl="plain", gating_pattern=scorer.gating_pattern,
                         device_preprocess=True)
    rows = sorted(preference.iter_jsonl(os.path.join(work, "overall.jsonl")),
                  key=lambda r: r["id"])
    deltas = []
    for rec, row in zip(records[:EVAL_PLAIN_PAIRS], rows):
        ref = plain.score_pair(os.path.join(root, rec["video_0_path"]),
                               os.path.join(root, rec["video_1_path"]),
                               rec["caption"], num_segments=FRAMES)
        deltas += [abs(float(r["score"]) - row[f"score_{b}"])
                   for b, r in enumerate(ref)]
    del plain
    torch.cuda.empty_cache()
    out["fp32_plain_max_abs_delta"] = max(deltas)
    print(f"eval CLI overall: {EVAL_PLAIN_PAIRS} pairs against fp32 plain, "
          f"max |delta| {max(deltas):.3e} (bound {SCORE_TOL:.0e})")
    if not max(deltas) < SCORE_TOL:
        raise RuntimeError(f"eval CLI scores against fp32 plain: {deltas}")
    # Resume: the overall results cut after EVAL_RESUME_CUT records plus a
    # torn line.
    full = os.path.join(work, "overall.jsonl")
    cut = os.path.join(work, "resumed.jsonl")
    with open(full) as f:
        lines = f.readlines()
    with open(cut, "w") as f:
        f.writelines(lines[:EVAL_RESUME_CUT])
        f.write('{"id": %d, "score_0": 0.1' % EVAL_RESUME_CUT)
    res, _, secs, _, got = _run_main(eval_cli.main,
                                     argv("overall", cut))
    left = n - EVAL_RESUME_CUT
    launches["eval_cli_resume"] = _hold(
        "eval CLI resume", got, {k: v * left for k, v in per_pair.items()})
    if res != out["overall"]["result"]:
        raise RuntimeError(f"resumed result {res} against "
                           f"{out['overall']['result']}")
    out["resume"] = {"command_s": secs, "pairs_scored": left}
    print(f"eval CLI resume: {left} of {n} pairs scored (cut after "
          f"{EVAL_RESUME_CUT} and a torn line), same result, command "
          f"{secs:.2f} s")
    # score_pair on the same frames, pair by pair.
    ref = RewardScorer(cfg, scorer.params, scorer.tokenizer,
                       dtype=scorer.dtype, gating_pattern=scorer.gating_pattern,
                       device_preprocess=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for rec in records:
        ref.score_pair(os.path.join(root, rec["video_0_path"]),
                       os.path.join(root, rec["video_1_path"]),
                       rec["caption"], num_segments=FRAMES)
    torch.cuda.synchronize()
    pair_s = (time.perf_counter() - t) / n
    out["score_pair_pairs_per_s"] = 1 / pair_s
    print(f"score_pair on the same frames: "
          f"{out['score_pair_pairs_per_s']:.2f} pairs/s, against the CLI's "
          f"driver {out['overall']['pairs_per_s']:.2f} pairs/s")
    # The host's share of score_pair on the same records, timed alone: the
    # seeded source's decode (noise drawn on the host, no real decoder) and
    # the whole of prepare_clip (decode, stack, prompt) for both clips.
    from mjvideo_tpu_torch.data import video

    paths = [os.path.join(root, rec[key]) for rec in records
             for key in ("video_0_path", "video_1_path")]
    t = time.perf_counter()
    for path in paths:
        frames, fps = video.video_metadata(path)
        video.decode_frames(path, video.get_frame_indices(frames, FRAMES,
                                                          fps=fps))
    decode_s = (time.perf_counter() - t) / n
    t = time.perf_counter()
    for path, rec in zip(paths, [r for r in records for _ in (0, 1)]):
        ref.prepare_clip(path, rec["caption"], FRAMES)
    prepare_s = (time.perf_counter() - t) / n
    out.update(seeded_decode_s_per_pair=decode_s,
               prepare_clip_s_per_pair=prepare_s,
               score_pair_less_prepare_pairs_per_s=1 / (pair_s - prepare_s))
    print(f"host share of score_pair: seeded decode {decode_s * 1e3:.1f} ms "
          f"a pair, prepare_clip {prepare_s * 1e3:.1f} ms a pair, of "
          f"{pair_s * 1e3:.1f} ms; score_pair less prepare_clip "
          f"{out['score_pair_less_prepare_pairs_per_s']:.2f} pairs/s")
    # GenAI-Bench: one row per vote type.
    rows = [{"left_video": os.path.join(root, r["video_0_path"]),
             "right_video": os.path.join(root, r["video_1_path"]),
             "prompt": r["caption"], "vote_type": vote}
            for r, vote in zip(records, GENAI_VOTES)]
    res, _, secs, _, got = _run_main(
        lambda _: preference.evaluate_genai_bench(
            ref, rows, num_segments=FRAMES), None)
    launches["genai"] = _hold("GenAI-Bench", got, {
        k: v * len(rows) for k, v in per_pair.items()})
    if res["total"] != len(rows):
        raise RuntimeError(f"GenAI-Bench: {res}")
    out["genai"] = {"seconds": secs, "result": res}
    print(f"GenAI-Bench: {len(rows)} rows in {secs:.2f} s: {res}")
    del ref
    torch.cuda.empty_cache()
    return out, launches


def judge_driver_runs(records, root, dev):
    """Phase 23's judge drivers on phase 9's judge.  Returns the readings
    and the launch counts by path."""
    import gc

    import torch

    from mjvideo_tpu_torch.eval.judges import (
        FINE_GRAINED_RUBRIC,
        fine_grained_accuracy,
        fine_grained_prompt,
        overall_prompt,
        run_fine_grained_benchmark,
        run_overall_benchmark,
    )

    gc.collect()
    torch.cuda.empty_cache()
    judge = make_judge(generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    L_vit = judge.cfg.vision.num_hidden_layers
    L_llm = judge.cfg.llm.num_hidden_layers
    out, launches = {}, {}
    pairs = records[:JUDGE_DRIVER_PAIRS]
    res, _, secs, _, got = _run_main(
        lambda _: run_overall_benchmark(judge, pairs, root=root), None)
    launches["judge_overall"] = _hold("judge overall", got, _with_prepass({
        "vit_attention": 2 * L_vit * len(pairs),
        "exact_attention": L_llm * len(pairs)}))
    out["overall"] = {"seconds": secs, "result": res}
    print(f"judge run_overall_benchmark: {len(pairs)} pairs in {secs:.2f} s:"
          f" {res}")
    one = records[:1]
    rubric = {c: FINE_GRAINED_RUBRIC[c] for c in FINE_GRAINED_CATEGORIES}
    questions = sum(1 + len(c["subcategories"]) for c in rubric.values())
    res, _, secs, _, got = _run_main(
        lambda _: run_fine_grained_benchmark(judge, one, root=root,
                                             rubric=rubric), None)
    # The first record's videos are in the judge's cache already.
    launches["judge_fine_grained"] = _hold("judge fine-grained", got, {
        "exact_attention": L_llm * questions})
    acc = fine_grained_accuracy(res)
    out["fine_grained"] = {"seconds": secs, "questions": questions,
                           "accuracy": acc}
    print(f"judge run_fine_grained_benchmark: 1 pair, {questions} questions "
          f"in {secs:.2f} s ({secs / questions:.2f} s a question); "
          f"accuracy over {len(acc)} subcategories")
    # Every prompt above takes the full-prompt path (its suffix overflows
    # the bucket), which the counts assume.
    npl = tuple(judge._prep(os.path.join(root, one[0]["video_0_path"]))[1])
    cap = one[0]["caption"]
    prompts = [overall_prompt(cap)] + [
        fine_grained_prompt(cap, c, s) for c, e in FINE_GRAINED_RUBRIC.items()
        for s in (None, *e["subcategories"])]
    if any(judge._split(p, npl) is not None for p in prompts):
        raise RuntimeError("a judge prompt took the prefix path")
    del judge
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def train_cli_run(records, root, work, dev):
    """Phase 23's training CLI at the 2B config.  Returns the readings and
    the launch counts by path."""
    import shutil

    import torch

    from mjvideo_tpu_torch import kernels, mjvideo_2b_config
    from mjvideo_tpu_torch.train import cli as train_cli
    from mjvideo_tpu_torch.train.trainer import Trainer

    train_path = os.path.join(work, "train.json")
    eval_path = os.path.join(work, "eval.json")
    with open(train_path, "w") as f:
        json.dump(records, f)
    with open(eval_path, "w") as f:
        json.dump(records[:TRAIN_CLI_EVAL_PAIRS], f)
    decided = sum(r["overall_preference"] in EVAL_PREFERENCES[:2]
                  for r in records[:TRAIN_CLI_EVAL_PAIRS])
    out_dir = os.path.join(work, "train_out")
    os.makedirs(out_dir)
    out = {"free_disk_bytes": shutil.disk_usage(out_dir).free}
    print(f"train CLI: {out['free_disk_bytes'] / 2**30:.2f} GiB free where "
          "the checkpoint is written")
    evals = []
    evaluate = Trainer.evaluate

    def counted(self, batches):
        torch.cuda.synchronize()
        before = dict(kernels.launch_counts)
        res = evaluate(self, batches)
        torch.cuda.synchronize()
        evals.append({k: v - before[k] for k, v in
                      kernels.launch_counts.items()})
        return res

    Trainer.evaluate = counted
    try:
        _, _, secs, _, got = _run_main(train_cli.main, [
            "--stage", "3", "--batch-size", "1", "--num-segments", "2",
            "--max-steps", str(TRAIN_CLI_STEPS), "--log-every", "1",
            "--train-json", train_path, "--eval-json", eval_path,
            "--video-root", root, "--output-dir", out_dir,
            "--device", "cuda"])
    finally:
        Trainer.evaluate = evaluate
    saved = [f for f in os.listdir(out_dir) if f.endswith(".pt")]
    out["bytes_written"] = sum(os.path.getsize(os.path.join(out_dir, f))
                               for f in saved)
    print(f"train CLI: wrote {saved} ({out['bytes_written']} bytes) in a "
          f"command of {secs:.2f} s")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["loss"] for r in logged if "loss" in r]
    eval_lines = [r for r in logged if "eval" in r]
    if (len(losses) != TRAIN_CLI_STEPS
            or not all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"train CLI losses {losses}")
    if len(eval_lines) != 2 or eval_lines[-1].get("epoch") != 0:
        raise RuntimeError(f"train CLI eval lines {eval_lines}")
    pref = eval_lines[-1]["eval"]["preference"]
    if pref["count"] != decided:
        raise RuntimeError(f"train CLI eval preference {pref}")
    if len(evals) != 1:
        raise RuntimeError(f"Trainer.evaluate ran {len(evals)} times")
    # Trainer.evaluate: each decided pair's two forwards, without the lse.
    chat = mjvideo_2b_config().chat
    L_vit = chat.vision.num_hidden_layers
    L_llm = chat.llm.num_hidden_layers
    launches = {"train_cli_evaluate": _hold(
        "Trainer.evaluate", evals[0], _with_prepass({
            "vit_attention": 2 * decided * L_vit,
            "decoder_attention": 2 * decided * L_llm}))}
    # The training steps, as phase 5 counts them: per micro-step and video
    # the ViT's layers once, each decoder layer's forward twice (remat, K2
    # with the lse) and its backward once.
    per_video = _with_prepass({
        "vit_attention": L_vit, "decoder_attention": 2 * L_llm,
        "decoder_attention_lse": 2 * L_llm,
        "decoder_attention_bwd_dkdv": L_llm,
        "decoder_attention_bwd_dq": L_llm})
    launches["train_cli"] = _hold(
        "train CLI steps", {k: got[k] - evals[0][k] for k in got},
        {k: 2 * TRAIN_CLI_STEPS * v for k, v in per_video.items()})
    out.update(command_s=secs, losses=losses, eval_preference=pref,
               eval_pairs=decided)
    print(f"train CLI: stage 3, {TRAIN_CLI_STEPS} micro-steps, losses "
          f"{losses}; eval on {decided} decided pairs: {pref}")
    shutil.rmtree(out_dir)
    return out, launches


def eval_harness_phase(scorer, ckpt_dir, dev):
    """Phase 23 (see the module docstring).  Returns the readings and the
    launch counts by path."""
    import importlib.util

    import torch

    for name in ("cv2", "PIL"):
        print(f"phase 23: {name} importable: "
              f"{importlib.util.find_spec(name) is not None}")
    records = eval_records()
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as work, seeded_video_source():
        print("phase 23: the seeded video source replaces data.video's "
              "video_metadata, decode_frames, load_video and "
              "data.dataset's load_video")
        root = os.path.join(work, "videos")
        data_path = os.path.join(work, "pairs.json")
        with open(data_path, "w") as f:
            json.dump(records, f)
        t0 = time.perf_counter()
        out["eval_cli"], got = eval_cli_runs(scorer, ckpt_dir, root,
                                             data_path, records, dev)
        launches.update(got)
        t1 = time.perf_counter()
        out["judge"], got = judge_driver_runs(records, root, dev)
        launches.update(got)
        t2 = time.perf_counter()
        out["train_cli"], got = train_cli_run(records, root, work, dev)
        launches.update(got)
        t3 = time.perf_counter()
    out["seconds"] = {"eval_cli": t1 - t0, "judge": t2 - t1,
                      "train_cli": t3 - t2}
    torch.cuda.empty_cache()
    return out, launches


def check_d96_decoder_kernels(randn, shape):
    """Phase 24: K2 at Phi-3's head dim (the op, one C call of the pre-pass
    and the kernel; the kernel alone on the standalone kmax, two launches
    bit-identical; the pre-pass) against their twins on phase 3's ragged
    inputs (``_decoder_inputs``), the op bit-equal to the kernel alone
    (``_hold_op``).  No lse form: K2 lse at D = 96 is refused.  Returns
    each one's reading by label."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, dead = _decoder_inputs(randn, *shape, True)
    scale = shape[-1] ** -0.5
    kmax = kernels.key_norm_max(k, mask)
    dead_rows = (f"{int(dead.sum())} dead rows",
                 lambda got: not got[0][dead].any())

    def alone():
        return kernels.decoder_attention(q, k, v, mask, kmax, None, scale)

    _hold_op(f"K2 op {shape}",
             lambda: fa._decoder_attention_fwd(q, k, v, mask, None, scale,
                                               False), alone)
    work = _attention_work(q, k, v, mask)
    library = _sdpa(q, k, v, causal=True)
    return {
        "K2": _check_kernel(
            f"K2 decoder_attention (op: pre-pass and kernel) {shape}",
            lambda: fa.decoder_attention(q, k, v, mask),
            lambda: fa.decoder_attention_plain(q, k, v, mask),
            zero=dead_rows, work=work, library=library),
        "K2 kernel": _check_kernel(
            f"K2 decoder_attention (kernel alone) {shape}", alone,
            lambda: fa.decoder_attention_plain(q, k, v, mask),
            zero=dead_rows, extra=_again(alone), work=work,
            library=library),
        "K2 pre-pass": _check_prepass(str(shape), k, mask)}


def check_d96_k3(randn, label, shape, causal=True):
    """Phase 24: K3 at Phi-3's head dim against its twin on a judge shape's
    inputs (``_judge_inputs``; non-causal: without the offset, every row
    sees its batch's live keys), two launches bit-identical, dead rows
    exactly 0.  Returns the reading."""
    import torch

    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, off, dead = _judge_inputs(randn, shape)
    if not causal:
        off, dead = None, torch.zeros_like(dead)

    def kernel():
        return fa.exact_attention(q, k, v, mask, off, causal=causal)

    return _check_kernel(
        f"K3 exact_attention {label} {shape[:6]}"
        f"{'' if causal else ' non-causal'}", kernel,
        lambda: fa.exact_attention_plain(q, k, v, mask, off, causal=causal),
        zero=(f"{int(dead.sum())} dead rows",
              lambda got: not got[0][dead].any()),
        extra=_again(kernel), work=_attention_work(q, k, v, mask, off,
                                                   causal=causal),
        library=_sdpa(q, k, v, causal=causal) if off is None
        else _sdpa_at(q, k, v, mask, off))


def time_d96_in_turns(randn, rounds=10):
    """K2 alone on its kmax, the K2 op, K3, the pre-pass alone and
    ``F.scaled_dot_product_attention`` at the 4B's (2, 3072, 32/32, 96) on
    phase 3's ragged inputs, in turns by CUDA events; the ops' device time
    by kernel and back to back.  Returns the medians in ms."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    shape = D96_K2_SHAPES[-1]
    q, k, v, mask, _ = _decoder_inputs(randn, *shape, True)
    scale = shape[-1] ** -0.5
    kmax = kernels.key_norm_max(k, mask)
    runs = {
        "K2": lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                                scale),
        "K2 op": lambda: fa.decoder_attention(q, k, v, mask),
        "K3": lambda: kernels.exact_attention(q, k, v, mask, None, scale),
        "pre-pass": lambda: kernels.key_norm_max(k, mask),
        "SDPA": _sdpa(q, k, v, causal=True),
    }
    med = _in_turns(runs, list(runs) + list(runs)[::-1], rounds)
    print(f"D = 96 kernels at {shape}, in turns: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in med.items())
          + f" (median of {2 * rounds} each; against SDPA: "
          + ", ".join(f"{n} {t / med['SDPA']:.3f}" for n, t in med.items()
                      if n != "SDPA") + ")")
    _op_device_times(med, runs, ("K2 op", "K2", "K3", "pre-pass"), shape)
    return med


def make_scorer_4b(generator, device):
    """A 4B ``RewardScorer`` with random bf16 weights drawn on the card,
    the ``ByteTokenizer`` padding with the config's id and its gating
    pattern for ``phi3-chat`` ('<|end|><|assistant|>\\n')."""
    import torch

    from mjvideo_tpu_torch import (
        ByteTokenizer,
        RewardScorer,
        init_reward_params,
        mjvideo_4b_config,
    )

    cfg = mjvideo_4b_config()
    state = init_reward_params(cfg, generator=generator, device=device,
                               dtype=torch.bfloat16)
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    return RewardScorer(cfg, state, tok, dtype=torch.bfloat16,
                        gating_pattern=tok.gating_pattern(cfg.chat.template))


def scoring_4b_phase(scorer, dev):
    """Phase 24 (b): the 4B scorer on phase 4's requests (its own prompts):
    exact launches, finite scores, a pair's time and the peak memory, the
    scores against fp32 plain with S1's split (bf16 plain against fp32
    plain, bf16 kernels against bf16 plain).  Returns the readings, the
    launch counts, the requests and the scores."""
    import numpy as np
    import torch

    from mjvideo_tpu_torch import RewardScorer, kernels

    requests = make_requests(scorer, np.random.default_rng(SEED))
    for pix, ids, _ in requests:
        print(f"4B request: {len(ids)} clip(s), {pix.shape[0]} tiles, prompt "
              f"lengths {[len(i) for i in ids]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    scores = [scorer.score_batch(*r).score for r in requests]
    torch.cuda.synchronize()
    launches = _held_launches("4B scoring",
                              _serving_launches(scorer.cfg, len(requests)))
    scores = torch.cat(scores).float().cpu()
    if not torch.isfinite(scores).all():
        raise RuntimeError(f"4B: non-finite scores {scores.tolist()}")
    out = {"peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    times = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer.score_batch(*requests[1])
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    out["pair_ms"] = statistics.median(times) * 1e3
    out["clips_per_s"] = len(requests[1][1]) / statistics.median(times)
    print(f"4B serving: pair request median {out['pair_ms']:.1f} ms over "
          f"{len(times)} runs -> {out['clips_per_s']:.2f} clips/s; peak "
          f"memory {out['peak_gib']:.2f} GiB (bf16, kernels)")
    delta, rel, fp32 = plain_score_delta(scorer, requests, scores)
    bf16_plain = RewardScorer(scorer.cfg, scorer.params, scorer.tokenizer,
                              dtype=torch.bfloat16, attn_impl="plain",
                              gating_pattern=scorer.gating_pattern)
    bp = torch.cat([bf16_plain.score_batch(*r).score for r in requests])
    bp = bp.float().cpu()
    out.update(score_delta=delta, score_delta_rel=rel,
               bf16_plain_vs_fp32_plain=(bp - fp32).abs().max().item(),
               kernels_vs_bf16_plain=(scores - bp).abs().max().item(),
               scores=scores.tolist(), fp32_plain_scores=fp32.tolist())
    print(f"4B S1 split: bf16 plain against fp32 plain "
          f"{out['bf16_plain_vs_fp32_plain']:.3e}, bf16 kernels against "
          f"bf16 plain {out['kernels_vs_bf16_plain']:.3e} (the delta "
          f"{delta:.3e}, bound {SCORE_TOL:.0e})")
    if not delta < SCORE_TOL:
        raise RuntimeError(f"4B score delta {delta} >= {SCORE_TOL}")
    return out, {"scoring_4b": launches}, requests, scores


def eval_cli_4b(scorer, ckpt_dir, dev):
    """Phase 24 (c): ``eval/cli.main`` overall on the 4B's checkpoint
    directory (``--byte-tokenizer``: the gating pattern of its
    ``phi3-chat`` template), EVAL_4B_PAIRS pairs of phase 23's seeded
    frames; the results bit-equal to ``score_batch`` of the same state,
    exact launches.  Returns the readings and the launch counts."""
    from mjvideo_tpu_torch.eval import cli as eval_cli
    from mjvideo_tpu_torch.eval import preference

    records = eval_records(EVAL_4B_PAIRS)
    with tempfile.TemporaryDirectory() as work, seeded_video_source():
        data_path = os.path.join(work, "pairs.json")
        with open(data_path, "w") as f:
            json.dump(records, f)
        results = os.path.join(work, "overall.jsonl")
        argv = ["--benchmark", "overall", "--device", "cuda",
                "--byte-tokenizer", "--device-preprocess", "--max-num", "1",
                "--model-path", ckpt_dir, "--data-json", data_path,
                "--video-root", work, "--num-segments", str(FRAMES),
                "--results", results]
        res, printed, secs, inner, got = _run_main(
            eval_cli.main, argv, timed=(preference, "evaluate_preference"))
        want = {k: v * len(records) for k, v in
                _serving_launches(scorer.cfg, 1).items()}
        launches = {"eval_cli_4b": _hold("4B eval CLI", got, want)}
        rows = sorted(preference.iter_jsonl(results), key=lambda r: r["id"])
        _bit_equal_rows("4B eval CLI", rows,
                        _reference_outputs(scorer, records, work),
                        {"score": "score"})
    out = {"command_s": secs, "driver_s": inner, "result": res,
           "pairs_per_s": len(records) / inner}
    print(f"4B eval CLI: {len(records)} pairs, command {secs:.2f} s (the "
          f"checkpoint's load included), driver {inner:.2f} s; result "
          f"{json.dumps(res, default=float)[:300]}")
    return out, launches


def mjvideo_4b_phase(dev, generator, drawer):
    """Phase 24: MJ-VIDEO-4B on the card (see the module docstring).
    Returns the readings, the D = 96 kernel readings and the launch counts
    by path."""
    import gc
    import shutil

    import torch

    t0 = time.perf_counter()
    randn = drawer(generator())
    k = {"K2": {shape: check_d96_decoder_kernels(randn, shape)
                for shape in D96_K2_SHAPES}}
    k["K3"] = {name: check_d96_k3(randn, name, shape)
               for name, shape in D96_K3_SHAPES.items()}
    k["K3"]["non-causal"] = check_d96_k3(randn, "prefill keys",
                                         D96_K3_SHAPES["prefill"], False)
    k["turns"] = time_d96_in_turns(randn)
    out = {"kernels_s": time.perf_counter() - t0}
    t1 = time.perf_counter()
    scorer = make_scorer_4b(generator(), dev)
    torch.cuda.synchronize()
    out["state_s"] = time.perf_counter() - t1
    print(f"4B state (bf16) made on the card in {out['state_s']:.1f} s")
    out["scoring"], launches, requests, scores = scoring_4b_phase(scorer,
                                                                  dev)
    d = tempfile.mkdtemp()
    try:
        need = 4 * sum(t.numel() for t in _flat_state(scorer.params).values())
        free = shutil.disk_usage(d).free
        print(f"4B checkpoint: {need} bytes to write (F32), "
              f"{free / 2**30:.2f} GiB free")
        if free < need * 1.1:
            raise RuntimeError(f"4B checkpoint: {free} bytes free for "
                               f"{need}")
        out["checkpoint"], more = checkpoint_phase(
            scorer, requests, scores, dev, d, name="checkpoint_4b")
        launches.update(more)
        out["eval_cli"], more = eval_cli_4b(scorer, d, dev)
        launches.update(more)
    finally:
        shutil.rmtree(d)
    del scorer, requests
    gc.collect()
    torch.cuda.empty_cache()
    out["judge"], more = judge_phase(dev, base=judge_4b_config(),
                                     name="judge_4b")
    launches.update(more)
    out["command_s"] = time.perf_counter() - t0
    print(f"phase 24 command time {out['command_s']:.1f} s")
    return out, k, launches


def time_d96_lse_in_turns(randn, shape, live, rounds=10):
    """K2 lse alone on its kmax, the K2 lse op, K2 alone and
    ``F.scaled_dot_product_attention`` at ``shape`` with each row's first
    ``live`` keys live (phase 25: the reward gradient's single clip at the
    4B's heads), in turns by CUDA events; prints each against SDPA and K2
    lse's bound.  Returns the medians in ms and the bound."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, _ = _decoder_inputs(randn, *shape, False, live)
    scale = shape[-1] ** -0.5
    kmax = kernels.key_norm_max(k, mask)
    runs = {
        "K2 lse": lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                                    scale, with_lse=True),
        "K2 lse op": lambda: fa._decoder_attention_fwd(q, k, v, mask, None,
                                                       scale, True),
        "K2": lambda: kernels.decoder_attention(q, k, v, mask, kmax, None,
                                                scale),
        "SDPA": _sdpa(q, k, v, causal=True),
    }
    med = _in_turns(runs, list(runs) + list(runs)[::-1], rounds)
    lse_out = q.new_empty((shape[0], shape[2], shape[1]), dtype=torch.float32)
    med["bound_ms"] = _bound(*_attention_work(
        q, k, v, mask, outputs=(q, lse_out)))["bound_ms"]
    print(f"K2 lse at {shape}, {live} live keys, in turns (median of "
          f"{2 * rounds} each): " + ", ".join(
              f"{n} {med[n]:.4f} ms" for n in runs)
          + f"; against SDPA: K2 lse {med['K2 lse'] / med['SDPA']:.3f}, the "
          f"op {med['K2 lse op'] / med['SDPA']:.3f}; K2 lse/K2 "
          f"{med['K2 lse'] / med['K2']:.3f}; bound {med['bound_ms']:.4f} ms")
    return med


def _fidelity_held(label, rel, cos, floor=None):
    """Hold a gradient's (relative L2, cosine) against fp32 plain to
    FIDELITY_REL_L2 and FIDELITY_COS.  ``floor``: bf16 plain's own reading
    against the same fp32 gradient; where it misses the bars too, a miss
    is a standing failure (F5, printed and returned) unless the kernels add
    more than the bars to it.  Raises otherwise.  Returns the verdict's
    fields."""
    met = rel <= FIDELITY_REL_L2 and cos >= FIDELITY_COS
    if met:
        return {"bar_met": True}
    if floor is not None:
        f_rel, f_cos = floor
        floor_missed = not (f_rel <= FIDELITY_REL_L2 and f_cos >= FIDELITY_COS)
        added = {"rel_l2": rel - f_rel, "cos": f_cos - cos}
        if (floor_missed and added["rel_l2"] <= FIDELITY_REL_L2
                and added["cos"] <= 1 - FIDELITY_COS):
            print(f"{label}: MISSES the bars (relative L2 {rel:.4e} against "
                  f"{FIDELITY_REL_L2}, cosine {cos:.6f} against "
                  f"{FIDELITY_COS}); bf16 plain alone misses them too "
                  f"({f_rel:.4e}, {f_cos:.6f}) and the kernels add "
                  f"{added['rel_l2']:+.4e} / {-added['cos']:+.6f} to it: a "
                  "standing failure of bf16 arithmetic at this depth "
                  "(ROADMAP Queue 3 F5), not a kernel fault")
            return {"bar_met": False, "standing": "F5",
                    "added_by_kernels": added}
    raise RuntimeError(f"{label}: relative L2 {rel}, cosine {cos}"
                       + ("" if floor is None else f"; bf16 plain {floor}"))


def gradient_split(cfg, tc, params, paths, batch, dev, label):
    """Phase 25 (d): one micro-batch's trainable gradient with the bf16
    kernels, through bf16 plain and through fp32 plain (a copy of the
    weights), each pair's relative L2 error and cosine (S1's split: bf16
    arithmetic against fp32, the kernels against bf16 plain); the kernels
    against fp32 plain held to FIDELITY_REL_L2 and FIDELITY_COS after the
    split is printed (``_fidelity_held``, with bf16 plain's reading as the
    floor).  Returns the readings and the fp32 plain gradient."""
    import torch

    from mjvideo_tpu_torch import map_state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    loss_k, g_k = trainable_grads(cfg, tc, params, paths, batch, "auto",
                                  torch.bfloat16, dev)
    loss_b, g_b = trainable_grads(cfg, tc, params, paths, batch, "plain",
                                  torch.bfloat16, dev)
    p32 = map_state(lambda t: t.detach().float(), params)
    loss_p, g_p = trainable_grads(cfg, tc, p32, paths, batch, "plain",
                                  torch.float32, dev)
    del p32
    torch.cuda.empty_cache()
    out = {"loss_kernels": loss_k, "loss_bf16_plain": loss_b,
           "loss_fp32_plain": loss_p,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    for name, a, b in (("kernels_vs_fp32_plain", g_k, g_p),
                       ("bf16_plain_vs_fp32_plain", g_b, g_p),
                       ("kernels_vs_bf16_plain", g_k, g_b)):
        rel, cos, _ = _agreement(a, b)
        out[name] = {"rel_l2": rel, "cos": cos}
    del g_k, g_b
    rel, cos = (out["kernels_vs_fp32_plain"][f] for f in ("rel_l2", "cos"))
    print(f"{label} gradient fidelity: loss bf16+kernels {loss_k:.6f}, bf16 "
          f"plain {loss_b:.6f}, fp32 plain {loss_p:.6f}; the kernels against "
          f"fp32 plain relative L2 {rel:.4e} (bound {FIDELITY_REL_L2}), "
          f"cosine {cos:.6f} (bound {FIDELITY_COS}); S1's split: bf16 plain "
          f"against fp32 plain {out['bf16_plain_vs_fp32_plain']['rel_l2']:.4e}"
          f" (cosine {out['bf16_plain_vs_fp32_plain']['cos']:.6f}), the "
          f"kernels against bf16 plain "
          f"{out['kernels_vs_bf16_plain']['rel_l2']:.4e} (cosine "
          f"{out['kernels_vs_bf16_plain']['cos']:.6f}); peak memory "
          f"{out['peak_gib']:.2f} GiB")
    floor = tuple(out["bf16_plain_vs_fp32_plain"][f] for f in ("rel_l2",
                                                               "cos"))
    out.update(_fidelity_held(f"{label} gradient fidelity", rel, cos, floor))
    return out, g_p


def mjvideo_4b_grad_phase(dev, generator, drawer):
    """Phase 25: MJ-VIDEO-4B's gradients and training on the card (see the
    module docstring).  Returns the readings, the D = 96 kernel readings
    and the launch counts by path."""
    import gc

    import numpy as np
    import torch

    from mjvideo_tpu_torch import mjvideo_4b_config
    from mjvideo_tpu_torch.train.trainer import Trainer, make_optimizer

    t0 = time.perf_counter()
    cfg4 = mjvideo_4b_config()
    llm = cfg4.chat.llm
    heads = (llm.num_attention_heads, llm.num_key_value_heads)
    data = train_data(cfg4)
    train_shapes = train_decoder_shapes(*data)
    grad_live = single_clip_length(cfg4)
    grad_shape = (1, K2_SHAPES[-1][1]) + heads + (llm.head_dim,)
    # (a) The kernels at the 4B's shapes, on a generator of their own.
    randn = drawer(generator())
    k = {"train_shapes": train_shapes,
         "dec": {s: check_decoder_kernels(randn, s, ragged=False)
                 for s in train_shapes}}
    k["dec"][grad_shape] = check_decoder_kernels(randn, grad_shape,
                                                 ragged=False, live=grad_live)
    k["ring"] = check_ring_kernels(randn, heads=heads, D=llm.head_dim,
                                   gather_ranks=())
    k["k4_turns"] = time_k4_in_turns(randn, ((train_shapes[-1], None),
                                             (grad_shape, grad_live)))
    k["k2_lse_turns"] = time_d96_lse_in_turns(randn, grad_shape, grad_live)
    k["k3_lse_turns"] = time_k3_lse_chunks(
        randn, lengths=(SP_T // SP_SHARDS,), heads=heads, D=llm.head_dim)
    out = {"kernels_s": time.perf_counter() - t0}
    # (b) The reward gradient and (c) VADER on a 4B scorer.
    scorer = make_scorer_4b(generator(), dev)
    requests = make_requests(scorer, np.random.default_rng(SEED))
    if len(requests[0][1][0]) != grad_live:
        raise RuntimeError(f"phase 25 checked the single clip at {grad_live} "
                           f"live keys, its prompt has "
                           f"{len(requests[0][1][0])}")
    launches = {}
    out["reward_gradient"], launches["reward_gradient_4b"] = (
        reward_gradient_phase(scorer, requests[0], dev))
    out["vader"], launches["vader_4b"] = vader_phase(scorer, dev)
    params = scorer.params
    del scorer, requests
    gc.collect()
    torch.cuda.empty_cache()
    # (d) Training on the same weights: the gradient's fidelity and its
    # split, the ring micro-batch, then a stage-3 Trainer.
    cfg, batches = data
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tc = train_config(ckpt_dir)
        paths = make_optimizer(tc, params).paths
        out["fidelity"], plain_grads = gradient_split(
            cfg, tc, params, paths, batches[0], dev, "4B training")
        floor = tuple(out["fidelity"]["bf16_plain_vs_fp32_plain"][f]
                      for f in ("rel_l2", "cos"))
        sp_out, more = sp_training_phase(cfg, params, tc, batches[0],
                                         plain_grads, dev, kinds=("ring",),
                                         name="sp_training_4b", floor=floor)
        out["sp_training"] = sp_out
        launches.update(more)
        del plain_grads
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(cfg, params, tc)
        launches["training_4b"], peak = check_training(
            trainer, batches, dev, label="4B training")
        out["training"] = {**time_training(trainer, batches,
                                           steps=TRAIN_MICRO_BATCHES),
                           "peak_gib": peak / 2**30}
        del trainer, params
    gc.collect()
    torch.cuda.empty_cache()
    out["command_s"] = time.perf_counter() - t0
    print(f"phase 25 command time {out['command_s']:.1f} s")
    return out, k, launches


def check_d96_rows(randn, shape):
    """Phase 26 (a): K2r at Phi-3's head dim (the op, one C call of its
    pre-pass and the kernel; the kernel alone on the standalone kcum, two
    launches bit-identical; the pre-pass, its last column
    ``key_norm_max``'s) against their twins on phase 3's ragged inputs
    (``_decoder_inputs``), the op bit-equal to the kernel alone.  Returns
    each one's reading by label."""
    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, dead = _decoder_inputs(randn, *shape, True)
    scale = shape[-1] ** -0.5
    kcum = kernels.key_norm_cummax(k, mask)
    dead_rows = (f"{int(dead.sum())} dead rows",
                 lambda got: not got[0][dead].any())

    def alone():
        return kernels.decoder_attention_rows(q, k, v, mask, kcum, None,
                                              scale)

    _hold_op(f"K2r op {shape}",
             lambda: fa.decoder_attention_rows(q, k, v, mask), alone,
             bound="kcum")
    work = _attention_work(q, k, v, mask)
    library = _sdpa(q, k, v, causal=True)

    def prepass_rule(got, ref):
        rel = _rel_err(got[0], ref[0])[1]
        last = bool(torch.equal(got[0][..., -1],
                                kernels.key_norm_max(k, mask)))
        return (f"{rel:.3e} of max|plain| (bound {PREPASS_REL_TOL:.0e}); "
                f"the last column bit-equal to key_norm_max: {last}",
                rel <= PREPASS_REL_TOL and last, {})

    reading = _check_kernel(
        f"K2r pre-pass key_norm_cummax {shape}",
        lambda: kernels.key_norm_cummax(k, mask),
        lambda: fa.key_norm_cummax(k, mask), names=("kcum",),
        extra=prepass_rule,
        work=(_nbytes(k, mask, kcum), 2 * k.numel(), FP32_OPS_PER_S))
    dev = device_ms(lambda: kernels.key_norm_cummax(k, mask))
    reading.update(device_ms=sum(dev.values()) or None,
                   partial_device_ms=dev.get("partial pass"),
                   scan_device_ms=dev.get("scan"))
    print(f"K2r pre-pass key_norm_cummax {shape}: device time a launch "
          f"{_ms(reading['device_ms'])} (partial pass "
          f"{_ms(reading['partial_device_ms'])}, scan "
          f"{_ms(reading['scan_device_ms'])})")
    return {
        "K2r": _check_kernel(
            f"K2r decoder_attention_rows (op: pre-pass and kernel) {shape}",
            lambda: fa.decoder_attention_rows(q, k, v, mask),
            lambda: fa.decoder_attention_rows_plain(q, k, v, mask),
            zero=dead_rows, work=work, library=library),
        "K2r kernel": _check_kernel(
            f"K2r decoder_attention_rows (kernel alone) {shape}", alone,
            lambda: fa.decoder_attention_rows_plain(q, k, v, mask),
            zero=dead_rows, extra=_again(alone), work=work,
            library=library),
        "K2r pre-pass": reading}


def cut_text_depth(cfg, layers):
    """A judge config (``.text``: its decoder's ``LLMConfig``) with the
    decoder cut to ``layers`` layers, at full width."""
    import dataclasses

    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=layers))


def judge_4b_config():
    """The InternVL2-4B chat config with its decoder cut to
    JUDGE_4B_LLM_DEPTH layers: the 4B judge of phases 24 and 26."""
    import dataclasses

    from mjvideo_tpu_torch import internvl2_4b_chat_config

    base = internvl2_4b_chat_config()
    return dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, num_hidden_layers=JUDGE_4B_LLM_DEPTH))


def judge_4b_rows_phase(dev):
    """Phase 26 (b): phase 24's 4B judge (the same state, from a fresh
    generator at SEED) under the per-row bound (``_CACHE_BOUND = "rows"``,
    as MJV_CACHE_NORM_BOUND=1 sets it): a short question on the pair by the
    prefix path, exact launches (per video encoded 24 K1 after their
    pre-passes; per prefix prefill or continuation 32 K2r after theirs, at
    their D = 96 names too; none in decode), then the teacher-forced
    logits against fp32 plain.  Returns the readings and the launches."""
    import gc

    import torch

    from mjvideo_tpu_torch import kernels, map_state
    from mjvideo_tpu_torch.models import generate as gen

    videos = ("video_0", "video_1")
    base = judge_4b_config()
    gc.collect()
    torch.cuda.empty_cache()
    judge = make_judge(generator=torch.Generator(device=dev)
                       .manual_seed(SEED), device=dev, base=base)
    L_vit = judge.cfg.vision.num_hidden_layers
    L_llm = judge.cfg.llm.num_hidden_layers
    out = {}
    gen._CACHE_BOUND = "rows"
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = judge.ask_batch(JUDGE_QUESTION, list(videos))
        torch.cuda.synchronize()
        out["pair_prefix_cold_s"] = time.perf_counter() - t0
        launches = {"judge_4b_prefix_rows": _held_launches(
            "judge_4b prefix rows", _with_prepass({
                "vit_attention": 2 * L_vit,
                "decoder_attention_rows": 3 * L_llm,
                "key_norm_cummax": 3 * L_llm,
                "decoder_attention_rows_d96": 3 * L_llm,
                "key_norm_cummax_d96": 3 * L_llm}))}
        print(f"judge_4b prefix (rows): answers {[a[:60] for a in answers]!r}"
              f"; the pair in {out['pair_prefix_cold_s']:.3f} s (videos "
              "encoded and prefixes prefilled)")
        out["pair_prefix_s"] = _host_ms(
            lambda: judge.ask_batch(JUDGE_QUESTION, list(videos)),
            PAIR_REPS) / 1e3
        plain = make_judge(state=map_state(lambda t: t.float(), judge.params),
                           base=base)
        _, out["prefix_rows_rel"], _, _ = logits_fidelity(
            judge, plain, JUDGE_QUESTION, videos, True, "4B prefix (rows)")
        del plain
    finally:
        gen._CACHE_BOUND = False
    if not out["prefix_rows_rel"] <= LOGITS_REL_TOL:
        raise RuntimeError(f"judge_4b rows: {out['prefix_rows_rel']} > "
                           f"{LOGITS_REL_TOL}")
    print(f"judge_4b prefix (rows): a pair with cached prefixes "
          f"{out['pair_prefix_s']:.3f} s ({2 / out['pair_prefix_s']:.2f} "
          "answers/s)")
    del judge
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def _seeded_patches(video_path, cfg_vision):
    """A video's (t h w, patch_dim) fp32 patches of QWEN_GRID, seeded from
    its name."""
    import numpy as np

    rng = np.random.default_rng([SEED, sum(map(ord, video_path))])
    n = QWEN_GRID[0] * QWEN_GRID[1] * QWEN_GRID[2]
    return rng.normal(size=(n, cfg_vision.patch_dim)).astype(np.float32)


def _seeded_encode_video(judge, video_path):
    """``Qwen2VLJudge._encode_video`` on seeded patches of QWEN_GRID in
    place of a decoded video (the card's machine may lack cv2 and PIL):
    the vision tower in the weights' dtype."""
    import torch

    from mjvideo_tpu_torch.models.qwen2vl import vision_dtype, vision_forward

    from mjvideo_tpu_torch.parallel.mesh import sub

    patches = torch.from_numpy(_seeded_patches(
        video_path, judge.cfg.vision)).to(judge.device,
                                          vision_dtype(judge.params))
    with torch.no_grad():
        vis = vision_forward(sub(judge.params, "visual"), judge.cfg.vision,
                             patches, QWEN_GRID, impl=judge.attn_impl,
                             mesh=judge.mesh)
    return vis, QWEN_GRID


def make_qwen_judge(cfg, state, tok, **kw):
    """A ``Qwen2VLJudge`` whose videos are seeded patches
    (``_seeded_encode_video``).  fp32 weights take the plain path."""
    import torch

    from mjvideo_tpu_torch.eval.judges import Qwen2VLJudge
    from mjvideo_tpu_torch.utils.bridge import first_tensor

    class SeededQwenJudge(Qwen2VLJudge):
        _encode_video = _seeded_encode_video

    impl = "plain" if first_tensor(state).dtype == torch.float32 else "auto"
    kw = {"num_segments": 2 * QWEN_GRID[0],
          "max_new_tokens": JUDGE_NEW_TOKENS, "attn_impl": impl, **kw}
    return SeededQwenJudge(cfg, state, tok, **kw)


def qwen_prompt_lengths(cfg, tok):
    """(the overall prompt's tokens, the prefix's, the short question's
    suffix's) of the Qwen2-VL judge at QWEN_GRID."""
    from mjvideo_tpu_torch import overall_prompt
    from mjvideo_tpu_torch.models.qwen2vl import (
        build_video_prompt_ids,
        build_video_prompt_prefix_suffix,
    )

    full = build_video_prompt_ids(tok, cfg, QWEN_GRID,
                                  overall_prompt(JUDGE_CAPTION)).shape[1]
    prefix, suffix = build_video_prompt_prefix_suffix(tok, cfg, QWEN_GRID,
                                                      JUDGE_QUESTION)
    return full, len(prefix), len(suffix)


def qwen_decoder_shapes(cfg, tok, heads):
    """The Qwen judge's decoder attention shapes at (Hq, Hkv) ``heads``,
    with the prefix and suffix lengths and the pair's real prompt length:
    its pair prefill (right-padded to the 64 bucket), one video's prefix
    and the continuation of the 128-slot suffix bucket over the prefix's
    cache, as ``Qwen2VLJudge`` sizes them."""
    from mjvideo_tpu_torch.models.generate import round_up_bucket

    full, P, S = qwen_prompt_lengths(cfg, tok)
    Tb, Pb = round_up_bucket(full), round_up_bucket(P)
    Hq, Hkv = heads
    return {"prefill": (2, Tb, Tb, Hq, Hkv, 128, None),
            "prefix": (1, Pb, Pb, Hq, Hkv, 128, None),
            "continuation": (2, 128, Pb + 128 + JUDGE_NEW_TOKENS, Hq, Hkv,
                             128, P)}, P, S, full


def _qwen_teacher(judge, prompt, videos, prefix, teacher=None):
    """The Qwen judge's generation for ``prompt`` by one path: its (B,
    JUDGE_NEW_TOKENS) greedy tokens, eos-filled past each row's end, or
    with ``teacher`` the per-step logits."""
    import torch

    from mjvideo_tpu_torch.models.generate import stack_prefix_states

    if prefix:
        suffix = judge._prefix_suffix(prompt, list(videos))
        state = stack_prefix_states([judge._pstate(v) for v in videos])
        out = judge._continue(state, suffix, teacher_tokens=teacher)
        return out if teacher is not None else out[0]
    out = judge._generate_full(prompt, list(videos), teacher_tokens=teacher)
    if teacher is not None:
        return out
    eos = getattr(judge.cfg, judge._eos_attr)
    return torch.tensor([row + [eos] * (JUDGE_NEW_TOKENS - len(row))
                         for row in out], device=judge.device)


def qwen_logits_fidelity(judge, plain, prompt, videos, prefix, label,
                         name="qwen2vl judge"):
    """Teacher-forced per-step logits of one path of a ``_GreedyLocalJudge``
    (the Qwen2-VL, MiniCPM-V and CogVLM2 judges), the kernel judge's
    against the fp32 plain judge's on the kernel path's greedy tokens:
    (max|delta| / max|plain|, tokens)."""
    toks = _qwen_teacher(judge, prompt, videos, prefix)
    got = _qwen_teacher(judge, prompt, videos, prefix, toks)
    ref = _qwen_teacher(plain, prompt, videos, prefix, toks)
    if not bool(got.isfinite().all()):
        raise RuntimeError(f"{name} {label}: non-finite logits")
    err, rel = _rel_err(got, ref)
    print(f"{name} {label}: greedy tokens of row 0 begin "
          f"{toks[0, :8].tolist()}; teacher-forced logits over "
          f"{toks.shape[1]} steps, max|delta| {err:.4e}, relative to "
          f"max|plain logit| {rel:.4e} (bound {LOGITS_REL_TOL:.1e})")
    return rel, toks


def qwen_judge_phase(dev, cfg, state, tok):
    """Phase 26 (c): ``Qwen2VLJudge`` on ``state`` (Qwen2-VL-2B at full
    width, bf16): ``judge_pair`` with the overall prompt (the full prompt:
    its suffix exceeds the 128-token bucket) and a short question by the
    prefix path, exact launches (per video encoded 32 K1 after their
    pre-passes, at their D = 80 names too; a K3 per decoder layer and
    prefill or continuation; none in decode), teacher-forced logits of
    both paths against the same weights in fp32 through ``impl="plain"``,
    and the
    times: the vision tower a video, the pair's prefill, a decode step at
    B = 2 (by difference over QWEN_DECODE_STEPS steps), a pair by each path
    and the peak memory.  Returns the readings and the launches."""
    import gc

    import torch

    from mjvideo_tpu_torch import judge_pair, kernels, map_state
    from mjvideo_tpu_torch import overall_prompt
    from mjvideo_tpu_torch.models.qwen2vl import (
        greedy_generate_batch,
        vision_forward,
    )

    videos = ("video_0", "video_1")
    L_vit, L_llm = cfg.vision.depth, cfg.text.num_hidden_layers
    torch.cuda.reset_peak_memory_stats(dev)
    judge = make_qwen_judge(cfg, state, tok)
    out, launches = {}, {}
    kernels.reset_launch_counts()
    s0, s1, r0, r1 = judge_pair(judge, *videos, JUDGE_CAPTION)
    torch.cuda.synchronize()
    launches["qwen2vl_judge_full"] = _held_launches(
        "qwen2vl judge full prompt", _with_prepass({
            "vit_attention": 2 * L_vit, "vit_attention_d80": 2 * L_vit,
            "key_norm_max_d80": 2 * L_vit, "exact_attention": L_llm}))
    print(f"qwen2vl judge full prompt: ratings {s0}, {s1}; answers "
          f"{r0!r:.60}, {r1!r:.60}")
    kernels.reset_launch_counts()
    answers = judge.ask_batch(JUDGE_QUESTION, list(videos))
    torch.cuda.synchronize()
    launches["qwen2vl_judge_prefix"] = _held_launches(
        "qwen2vl judge prefix", {"exact_attention": 3 * L_llm})
    print(f"qwen2vl judge prefix: answers {[a[:60] for a in answers]!r}")
    if not all(isinstance(a, str) for a in (r0, r1, *answers)):
        raise RuntimeError("a qwen2vl answer did not decode to text")
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30

    plain = make_qwen_judge(cfg, map_state(lambda t: t.float(), state), tok)
    prompt = overall_prompt(JUDGE_CAPTION)
    out["full_rel"], otoks = qwen_logits_fidelity(judge, plain, prompt,
                                                  videos, False, "full prompt")
    out["prefix_rel"], ptoks = qwen_logits_fidelity(
        judge, plain, JUDGE_QUESTION, videos, True, "prefix")
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    for key in ("full_rel", "prefix_rel"):
        if not out[key] <= LOGITS_REL_TOL:
            raise RuntimeError(f"qwen2vl judge {key} {out[key]} > "
                               f"{LOGITS_REL_TOL}")

    # Times (warm: the videos encoded, the prefixes prefilled).
    patches = torch.from_numpy(_seeded_patches(videos[0], cfg.vision)).to(
        dev, torch.bfloat16)
    with torch.no_grad():
        out["vision_ms"] = _host_ms(lambda: vision_forward(
            state["visual"], cfg.vision, patches, QWEN_GRID))
    items, vis = judge._full_items(prompt, list(videos))

    def generate(n):
        return greedy_generate_batch(state, cfg, items, max_new_tokens=n,
                                     eos_token_id=-1, vision_embeds=vis)

    out["prefill_ms"] = _host_ms(lambda: generate(1))
    steps_ms = _host_ms(lambda: generate(1 + QWEN_DECODE_STEPS))
    out["decode_step_ms"] = (steps_ms - out["prefill_ms"]) / QWEN_DECODE_STEPS
    out["pair_full_s"] = _host_ms(
        lambda: judge_pair(judge, *videos, JUDGE_CAPTION), PAIR_REPS) / 1e3
    out["pair_prefix_s"] = _host_ms(
        lambda: judge.ask_batch(JUDGE_QUESTION, list(videos)),
        PAIR_REPS) / 1e3
    out["prompt_tokens"] = items[0][0].shape[1]
    print(f"qwen2vl judge time: vision tower {out['vision_ms']:.1f} ms a "
          f"video {QWEN_GRID}; the pair's full-prompt prefill "
          f"({out['prompt_tokens']} tokens a row) {out['prefill_ms']:.1f} ms"
          f"; decode step at B = 2 {out['decode_step_ms']:.2f} ms (by "
          f"difference over {QWEN_DECODE_STEPS}); a pair: full prompt "
          f"{out['pair_full_s']:.3f} s ({2 / out['pair_full_s']:.2f} "
          f"answers/s), prefix path {out['pair_prefix_s']:.3f} s "
          f"({2 / out['pair_prefix_s']:.2f} answers/s), at most "
          f"{JUDGE_NEW_TOKENS} new tokens; peak memory {out['peak_gib']:.2f}"
          " GiB")
    del judge
    return out, launches


def qwen_cli_phase(dev, cfg, generator):
    """Phase 26 (d): the 2B's widths at QWEN_CLI_DEPTH, a bf16 state from
    ``generator``, written by the port's writer as an HF Qwen2-VL directory
    (``config.json`` and safetensors); ``eval/cli.main --judge qwen2-vl
    --byte-tokenizer`` overall on QWEN_CLI_PAIRS pairs, the judge's videos
    seeded patches as in (c); every results row (ratings and answers) equal
    to (c)'s judge on the state read back, exact launches.  Returns the
    readings and the launches."""
    import dataclasses
    import inspect
    import shutil

    import torch

    from mjvideo_tpu_torch import judge_pair, kernels
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.eval import cli
    from mjvideo_tpu_torch.eval import judges as tj
    from mjvideo_tpu_torch.models.qwen2vl import (
        export_qwen2vl_state,
        import_qwen2vl_params,
        init_qwen2vl_params,
        qwen2vl_config_to_hf,
    )
    from mjvideo_tpu_torch.utils.checkpoint import load_safetensors_dir
    from mjvideo_tpu_torch.utils.export import save_safetensors

    small = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=QWEN_CLI_DEPTH[0]),
        text=dataclasses.replace(cfg.text,
                                 num_hidden_layers=QWEN_CLI_DEPTH[1]))
    state = init_qwen2vl_params(small, generator=generator, device=dev,
                                dtype=torch.bfloat16)
    d = tempfile.mkdtemp()
    out = {}
    try:
        t0 = time.perf_counter()
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(qwen2vl_config_to_hf(small), f)
        save_safetensors({k: v.cpu() for k, v in
                          export_qwen2vl_state(state, small).items()},
                         os.path.join(d, "model.safetensors"))
        out["write_s"] = time.perf_counter() - t0
        records = [{"caption": f"{JUDGE_CAPTION} ({i})",
                    "video_0_path": f"clip_{i}_0.mp4",
                    "video_1_path": f"clip_{i}_1.mp4",
                    "overall_preference": EVAL_PREFERENCES[i % 4]}
                   for i in range(QWEN_CLI_PAIRS)]
        data = os.path.join(d, "pairs.json")
        with open(data, "w") as f:
            json.dump(records, f)
        results = os.path.join(d, "results.jsonl")
        saved = tj.Qwen2VLJudge._encode_video
        tj.Qwen2VLJudge._encode_video = _seeded_encode_video
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = cli.main(["--benchmark", "overall", "--judge", "qwen2-vl",
                            "--judge-model", d, "--byte-tokenizer",
                            "--data-json", data, "--video-root", d,
                            "--results", results])
            torch.cuda.synchronize()
            out["cli_s"] = time.perf_counter() - t0
        finally:
            tj.Qwen2VLJudge._encode_video = saved
        L_vit, L_llm = QWEN_CLI_DEPTH
        n = QWEN_CLI_PAIRS
        launches = {"qwen2vl_cli": _held_launches(
            "qwen2vl CLI", _with_prepass({
                "vit_attention": 2 * n * L_vit,
                "vit_attention_d80": 2 * n * L_vit,
                "key_norm_max_d80": 2 * n * L_vit,
                "exact_attention": n * L_llm}))}
        rows = [json.loads(line) for line in open(results)]
        loaded = import_qwen2vl_params(load_safetensors_dir(d), small,
                                       dtype=torch.bfloat16, device=dev)
        fa, fb = _flat_state(loaded), _flat_state(state)
        same_state = fa.keys() == fb.keys() and all(
            torch.equal(fa[name], fb[name]) for name in fa)
        # The CLI's judge takes the class's defaults.
        defaults = {name: par.default for name, par in inspect.signature(
            tj.Qwen2VLJudge).parameters.items() if name in (
                "num_segments", "max_new_tokens", "max_pixels")}
        judge = make_qwen_judge(small, loaded, ByteTokenizer(), **defaults)
        want = [judge_pair(judge, os.path.join(d, r["video_0_path"]),
                           os.path.join(d, r["video_1_path"]), r["caption"])
                for r in records]
        got = [(r["score_0"], r["score_1"], r["response_0"], r["response_1"])
               for r in rows]
        out.update(metrics=res, rows_equal=got == list(map(tuple, want)),
                   state_bit_equal=same_state)
        print(f"qwen2vl CLI on a {small.vision.depth}+"
              f"{small.text.num_hidden_layers}-layer directory (written in "
              f"{out['write_s']:.1f} s): {len(rows)} rows in "
              f"{out['cli_s']:.1f} s; the state read back bit-equal: "
              f"{same_state}; every row equal to the judge's: "
              f"{out['rows_equal']}")
        if not (out["rows_equal"] and same_state and len(rows) == n):
            raise RuntimeError(f"qwen2vl CLI: rows {got} against {want}, "
                               f"state bit-equal {same_state}")
    finally:
        shutil.rmtree(d)
    return out, launches


def qwen2vl_phase(dev, generator, drawer):
    """Phase 26: the per-kernel checks of the new forms, the 4B judge under
    the per-row bound, the Qwen2-VL judge at full width and its CLI (see
    the module docstring).  Returns the readings, the kernel readings and
    the launch counts by path."""
    import gc

    import torch

    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.models.qwen2vl import (
        Qwen2VLConfig,
        init_qwen2vl_params,
    )

    t0 = time.perf_counter()
    randn = drawer(generator())
    cfg = Qwen2VLConfig()
    tok = ByteTokenizer()
    k = {"K1": {s: check_vit_attention(randn, s) for s in QWEN_K1_SHAPES}}
    k["K2r ragged"] = {s: check_d96_rows(randn, s) for s in D96_K2_SHAPES}
    k["K2r judge"] = {
        name: check_judge_kernels(randn, name, shape[:3] + (32, 32, 96)
                                  + shape[6:])
        for name, shape in JUDGE_SHAPES.items() if name != "prefill"}
    k["qwen"] = {}
    for size, heads in QWEN_HEADS.items():
        shapes, P, S, full = qwen_decoder_shapes(cfg, tok, heads)
        for name, shape in shapes.items():
            k["qwen"][size, name] = check_judge_kernels(
                randn, name, shape, prefix=P, suffix=S, right_padded=full)
    out = {"kernels_s": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["judge_4b_rows"], launches = judge_4b_rows_phase(dev)
    out["judge_4b_rows"]["command_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    cfg = cut_text_depth(cfg, QWEN_LLM_DEPTH)
    state = init_qwen2vl_params(cfg, generator=generator(), device=dev,
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out["state_s"] = time.perf_counter() - t1
    print(f"Qwen2-VL-2B state (bf16) made on the card in "
          f"{out['state_s']:.1f} s")
    out["judge"], more = qwen_judge_phase(dev, cfg, state, tok)
    launches.update(more)
    out["judge"]["command_s"] = time.perf_counter() - t1
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"], more = qwen_cli_phase(dev, cfg, generator())
    launches.update(more)
    out["command_s"] = time.perf_counter() - t0
    print(f"phase 26 command time {out['command_s']:.1f} s")
    return out, k, launches


class WordTokenizer:
    """A stand-in for VideoScore's Llama tokenizer at about its token
    counts, for the card (no tokenizer files there): ``<image>`` and
    ``<fake_token_around_image>`` at the config's image id and the id
    before it, every word or punctuation mark one id (its crc32 into
    [3, 32000)), so the pad id 0 never appears.  The 16-frame prompt takes
    about 1,340 tokens, 1,024 of them image tokens: the 1,536 bucket."""

    def __init__(self, image_token_id):
        self.specials = {"<fake_token_around_image>": image_token_id - 1,
                         "<image>": image_token_id}

    def __call__(self, text):
        import re

        ids = []
        for part in re.split("(<fake_token_around_image>|<image>)", text):
            if part in self.specials:
                ids.append(self.specials[part])
            else:
                ids += [3 + zlib.crc32(w.encode()) % 31997
                        for w in re.findall(r"\w+|[^\w\s]", part)]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}


def _at_d72(want):
    """``want`` (launches by kernel) of a path whose ViT is SigLIP's, plus
    the D = 72 names: K1 as ``vit_attention_d72``, the pre-pass of every K1
    and K1m as ``key_norm_max_d72``, K1m's as ``key_norm_max_masked_d72``,
    and ``key_norm_max`` (``_with_prepass``)."""
    want = _with_prepass(want)
    k1, k1m = want.get("vit_attention", 0), want.get("vit_attention_masked", 0)
    want.update(vit_attention_d72=k1, key_norm_max_d72=k1 + k1m,
                key_norm_max_masked_d72=k1m)
    return {name: n for name, n in want.items() if n}


def videoscore_split_mask(frames=None):
    """The (N, H, W) int32 pixel mask of ``do_image_splitting``'s images of
    ``frames`` 1280 x 720 frames as the Idefics2 processor pads them: per
    frame 4 quadrants resized to VS_QUADRANT_HW and the original at VS_HW,
    padded bottom/right to VS_HW."""
    import numpy as np

    sizes = [VS_QUADRANT_HW] * 4 + [VS_HW]
    frames = VS_SPLIT_FRAMES if frames is None else frames
    mask = np.zeros((frames * len(sizes), *VS_HW), np.int32)
    for i in range(mask.shape[0]):
        h, w = sizes[i % len(sizes)]
        mask[i, :h, :w] = 1
    return mask


def videoscore_split_inputs(rng, frames=None):
    """(pixels, pixel mask) of ``videoscore_split_mask``'s images: seeded
    normal pixels where real, 0 in the padding."""
    import numpy as np

    mask = videoscore_split_mask(frames)
    pix = rng.standard_normal((*mask.shape, 3), dtype=np.float32)
    return pix * mask[..., None], mask


def check_masked_vit_attention(randn, mask, heads=16, D=72):
    """K1m (the op: the masked pre-pass and the kernel, one C call), the
    kernel alone on the standalone masked kmax and the masked pre-pass,
    each against its twin, at SigLIP's heads on q, k and v as the tower
    makes them (three dense projections) under ``mask`` (N, S); the op
    bit-equal to the kernel alone (``_hold_op``).  Returns the readings."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    N, S = mask.shape
    q, k, v = (randn(N, S, heads, D) for _ in range(3))
    label = f"{(N, S, heads, D)}, {int(mask.sum())} live keys"
    work = _attention_work(q, k, v, mask, causal=False)
    library = _sdpa(q, k, v, causal=False,
                    allowed=(mask != 0)[:, None, :].expand(N, S, S))
    kmax = kernels.key_norm_max(k, mask)
    scale = D ** -0.5
    _hold_op(f"K1m op {label}",
             lambda: fa.vit_attention_masked(q, k, v, mask),
             lambda: kernels.vit_attention_masked(q, k, v, mask, kmax, scale))
    return {
        "K1m": _check_kernel(
            f"K1m vit_attention_masked (op: pre-pass and kernel) {label}",
            lambda: fa.vit_attention_masked(q, k, v, mask),
            lambda: fa.vit_attention_masked_plain(q, k, v, mask), work=work,
            library=library),
        "K1m kernel": _check_kernel(
            f"K1m vit_attention_masked (kernel alone) {label}",
            lambda: kernels.vit_attention_masked(q, k, v, mask, kmax, scale),
            lambda: fa.vit_attention_masked_plain(q, k, v, mask), work=work,
            library=library),
        "K1m pre-pass": _check_prepass(label, k, mask)}


def _score_split(label, kern, bf16_plain, fp32_plain):
    """S1's split of a VideoScore reading: the kernels against fp32 plain
    (held to LOGITS_REL_TOL of max|logit|), bf16 plain against fp32 plain
    and the kernels against bf16 plain (printed)."""
    import torch

    t = {n: torch.as_tensor(a) for n, a in (("kern", kern),
                                            ("bf16", bf16_plain),
                                            ("fp32", fp32_plain))}
    if not bool(t["kern"].isfinite().all()):
        raise RuntimeError(f"videoscore {label}: non-finite logits")
    rel = _rel_err(t["kern"], t["fp32"])[1]
    split = (_rel_err(t["bf16"], t["fp32"])[1],
             _rel_err(t["kern"], t["bf16"])[1])
    print(f"videoscore {label}: logits {[round(float(x), 4) for x in kern]};"
          f" kernels against fp32 plain {rel:.4e} of max|logit| (bound "
          f"{LOGITS_REL_TOL:.1e}); bf16 plain against fp32 plain "
          f"{split[0]:.4e}, kernels against bf16 plain {split[1]:.4e}")
    if not rel <= LOGITS_REL_TOL:
        raise RuntimeError(f"videoscore {label}: {rel} > {LOGITS_REL_TOL}")
    return {"rel": rel, "bf16_plain_rel": split[0],
            "kernels_vs_bf16_plain_rel": split[1]}


def videoscore_phase(dev, generator):
    """Phase 27 (c): VideoScore at full dims (SigLIP-so400m, the perceiver,
    Mistral-7B, 5 labels), random bf16 weights from a fresh generator at
    SEED, on a 16-frame clip of seeded pixels at VS_HW through
    ``VideoScoreJudge.score_frames`` (``WordTokenizer``'s prompt):
    launches exact (27 K1 and 32 K2, each after its pre-pass), the 5 logits
    against fp32 plain with S1's split, the aggregate, ms a clip and the
    peak; then ``do_image_splitting``'s 20 images of 4 frames (K1m: 27
    launches), against fp32 plain too.  The fp32 copy is made once, for
    both readings.  Returns the readings and the launches."""
    import gc

    import numpy as np
    import torch

    from mjvideo_tpu_torch import kernels, map_state
    from mjvideo_tpu_torch.eval.judges import (
        VideoScoreJudge,
        videoscore_prompt,
    )
    from mjvideo_tpu_torch.models.videoscore import (
        VideoScoreConfig,
        init_videoscore_params,
    )

    cfg = VideoScoreConfig(num_labels=5)
    L_vit, L_llm = cfg.vision.num_hidden_layers, cfg.text.num_hidden_layers
    out, launches = {}, {}
    t0 = time.perf_counter()
    state = init_videoscore_params(cfg, generator=generator(), device=dev,
                                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out["state_s"] = time.perf_counter() - t0
    out["params"] = sum(t.numel() for t in _flat_state(state).values())
    print(f"VideoScore state (bf16, {out['params'] / 1e9:.2f} B parameters) "
          f"made on the card in {out['state_s']:.1f} s")
    tok = WordTokenizer(cfg.image_token_id)
    rng = np.random.default_rng(SEED)
    clip = rng.standard_normal((VS_FRAMES, *VS_HW, 3), dtype=np.float32)
    split_pix, split_mask = videoscore_split_inputs(rng)

    def inputs(judge, n_frames):
        ids, mask = judge.tokenize(videoscore_prompt(JUDGE_CAPTION,
                                                     n_frames))
        return np.asarray([ids]), np.asarray([mask])

    def judge_of(params, dtype, impl, split):
        return VideoScoreJudge(tokenizer=tok, cfg=cfg, params=params,
                               dtype=dtype, attn_impl=impl,
                               do_image_splitting=split)

    judge = judge_of(state, torch.bfloat16, "auto", False)
    split_judge = judge_of(state, torch.bfloat16, "auto", True)
    ids, mask = inputs(judge, VS_FRAMES)
    sids, smask = inputs(split_judge, VS_SPLIT_FRAMES)
    out["prompt_tokens"], out["split_prompt_tokens"] = (ids.shape[1],
                                                        sids.shape[1])
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    kern = judge.score_frames(clip, ids, mask)
    torch.cuda.synchronize()
    launches["videoscore"] = _held_launches("videoscore clip", _at_d72({
        "vit_attention": L_vit, "decoder_attention": L_llm}))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["aggregate"] = judge.aggregate(kern)
    out["ms_per_clip"] = _host_ms(lambda: judge.score_frames(clip, ids, mask),
                                  reps=VS_TIMED)
    kernels.reset_launch_counts()
    split_kern = split_judge.score_frames(split_pix, sids, smask, split_mask)
    torch.cuda.synchronize()
    launches["videoscore_split"] = _held_launches(
        "videoscore split frames", _at_d72({
            "vit_attention_masked": L_vit, "decoder_attention": L_llm}))
    out["split_ms"] = _host_ms(lambda: split_judge.score_frames(
        split_pix, sids, smask, split_mask), reps=1)
    print(f"videoscore: a {VS_FRAMES}-frame clip ({VS_FRAMES} x "
          f"{(VS_HW[0] // 14) * (VS_HW[1] // 14)} patches, "
          f"{out['prompt_tokens']} tokens) aggregate {out['aggregate']:.3f}, "
          f"{out['ms_per_clip']:.1f} ms a clip (median of {VS_TIMED}), peak "
          f"{out['peak_gib']:.2f} GiB; {VS_SPLIT_FRAMES} split frames "
          f"({split_pix.shape[0]} images, {out['split_prompt_tokens']} "
          f"tokens) {out['split_ms']:.1f} ms")
    plain16 = judge_of(state, torch.bfloat16, "plain", False)
    bf16 = (plain16.score_frames(clip, ids, mask),
            judge_of(state, torch.bfloat16, "plain", True).score_frames(
                split_pix, sids, smask, split_mask))
    del plain16
    fstate = map_state(lambda t: t.float(), state)
    fp32 = (judge_of(fstate, torch.float32, "plain", False).score_frames(
        clip, ids, mask), judge_of(fstate, torch.float32, "plain",
                                   True).score_frames(split_pix, sids, smask,
                                                      split_mask))
    del fstate
    gc.collect()
    torch.cuda.empty_cache()
    out["clip"] = _score_split("clip", kern, bf16[0], fp32[0])
    out["split"] = _score_split("split frames", split_kern, bf16[1], fp32[1])
    del judge, split_judge, state
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def _seeded_minicpm_encode(judge, video_path):
    """``MiniCPMVJudge._encode_video`` on seeded pixels of MCPM_FRAMES
    frames at MCPM_HW (the resized and normalised 1280 x 720 frames) in
    place of a decoded video: the tower in the weights' dtype."""
    import numpy as np
    import torch

    from mjvideo_tpu_torch.models.minicpmv import (
        get_vision_embedding,
        vision_dtype,
    )

    rng = np.random.default_rng([SEED, _path_seed(video_path)])
    pix = rng.standard_normal((MCPM_FRAMES, *MCPM_HW, 3), dtype=np.float32)
    with torch.no_grad():
        vis = get_vision_embedding(
            judge.params, judge.cfg,
            torch.from_numpy(pix).to(judge.device, vision_dtype(judge.params)),
            impl=judge.attn_impl, mesh=judge.mesh)
    return vis, MCPM_FRAMES


def make_minicpm_judge(cfg, state, tok, **kw):
    """A ``MiniCPMVJudge`` whose videos are seeded pixels
    (``_seeded_minicpm_encode``); fp32 weights take the plain path."""
    import torch

    from mjvideo_tpu_torch.eval.judges import MiniCPMVJudge
    from mjvideo_tpu_torch.utils.bridge import first_tensor

    class SeededMiniCPMVJudge(MiniCPMVJudge):
        _encode_video = _seeded_minicpm_encode

    impl = "plain" if first_tensor(state).dtype == torch.float32 else "auto"
    kw = {"num_segments": MCPM_FRAMES, "max_new_tokens": JUDGE_NEW_TOKENS,
          "attn_impl": impl, **kw}
    return SeededMiniCPMVJudge(cfg, state, tok, **kw)


def minicpmv_phase(dev, generator):
    """Phase 27 (d): ``MiniCPMVJudge`` on MiniCPM-V-2.6 at full dims
    (SigLIP-so400m at 980, the resampler of 64 queries over 28 heads of
    128, Qwen2-7B with its biases and a 151,666-row untied head), random
    bf16 weights from a fresh generator at SEED, a pair of seeded 8-frame
    videos (``_seeded_minicpm_encode``): ``judge_pair`` with the overall
    prompt (the full prompt) and a short question (the prefix path), 64
    greedy tokens; launches exact (per video 27 K1 after their pre-passes;
    a K3 per decoder layer and prefill or continuation; none in decode);
    teacher-forced
    logits of both paths against the same weights in fp32 through
    ``impl="plain"``; the tower's ms a video, the pair's prefill, a decode
    step at B = 2, answers/s by each path and the peak.  Returns the
    readings and the launches."""
    import gc

    import numpy as np
    import torch

    from mjvideo_tpu_torch import judge_pair, kernels, map_state
    from mjvideo_tpu_torch import overall_prompt
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.models.minicpmv import (
        MiniCPMVConfig,
        build_video_prompt_ids,
        get_vision_embedding,
        greedy_generate_batch,
        init_minicpmv_params,
    )

    cfg = cut_text_depth(MiniCPMVConfig(), MCPM_LLM_DEPTH)
    L_vit, L_llm = cfg.vision.num_hidden_layers, cfg.text.num_hidden_layers
    videos = ("video_0", "video_1")
    out, launches = {}, {}
    t0 = time.perf_counter()
    state = init_minicpmv_params(cfg, generator=generator(), device=dev,
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out["state_s"] = time.perf_counter() - t0
    out["params"] = sum(t.numel() for t in _flat_state(state).values())
    print(f"MiniCPM-V-2.6 state (bf16, {out['params'] / 1e9:.2f} B "
          f"parameters) made on the card in {out['state_s']:.1f} s")
    tok = ByteTokenizer()
    torch.cuda.reset_peak_memory_stats(dev)
    judge = make_minicpm_judge(cfg, state, tok)
    kernels.reset_launch_counts()
    s0, s1, r0, r1 = judge_pair(judge, *videos, JUDGE_CAPTION)
    torch.cuda.synchronize()
    launches["minicpmv_judge_full"] = _held_launches(
        "minicpmv judge full prompt", _at_d72({
            "vit_attention": 2 * L_vit, "exact_attention": L_llm}))
    print(f"minicpmv judge full prompt: ratings {s0}, {s1}; answers "
          f"{r0!r:.60}, {r1!r:.60}")
    kernels.reset_launch_counts()
    judge.ask_batch(JUDGE_QUESTION, list(videos))
    torch.cuda.synchronize()
    launches["minicpmv_judge_prefix"] = _held_launches(
        "minicpmv judge prefix", {"exact_attention": 3 * L_llm})
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    plain = make_minicpm_judge(cfg, map_state(lambda t: t.float(), state),
                               tok)
    prompt = overall_prompt(JUDGE_CAPTION)
    out["full_rel"], _ = qwen_logits_fidelity(
        judge, plain, prompt, videos, False, "full prompt", "minicpmv judge")
    out["prefix_rel"], _ = qwen_logits_fidelity(
        judge, plain, JUDGE_QUESTION, videos, True, "prefix",
        "minicpmv judge")
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    for key in ("full_rel", "prefix_rel"):
        if not out[key] <= LOGITS_REL_TOL:
            raise RuntimeError(f"minicpmv judge {key} {out[key]} > "
                               f"{LOGITS_REL_TOL}")
    pix = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (MCPM_FRAMES, *MCPM_HW, 3), dtype=np.float32)).to(dev, torch.bfloat16)
    with torch.no_grad():
        out["vision_ms"] = _host_ms(lambda: get_vision_embedding(
            state, cfg, pix))
    preps = [judge._prep(v) for v in videos]
    items = [(build_video_prompt_ids(tok, cfg, n, prompt), None)
             for _, n in preps]

    def generate(n):
        return greedy_generate_batch(state, cfg, items, max_new_tokens=n,
                                     eos_token_id=-1,
                                     vision_embeds=[v for v, _ in preps])

    out["prefill_ms"] = _host_ms(lambda: generate(1))
    steps_ms = _host_ms(lambda: generate(1 + MCPM_DECODE_STEPS))
    out["decode_step_ms"] = (steps_ms - out["prefill_ms"]) / MCPM_DECODE_STEPS
    out["pair_full_s"] = _host_ms(
        lambda: judge_pair(judge, *videos, JUDGE_CAPTION), PAIR_REPS) / 1e3
    out["pair_prefix_s"] = _host_ms(
        lambda: judge.ask_batch(JUDGE_QUESTION, list(videos)),
        PAIR_REPS) / 1e3
    out["prompt_tokens"] = items[0][0].shape[1]
    print(f"minicpmv judge time: vision tower {out['vision_ms']:.1f} ms a "
          f"video ({MCPM_FRAMES} frames of {MCPM_HW}); the pair's "
          f"full-prompt prefill ({out['prompt_tokens']} tokens a row) "
          f"{out['prefill_ms']:.1f} ms; decode step at B = 2 "
          f"{out['decode_step_ms']:.2f} ms (by difference over "
          f"{MCPM_DECODE_STEPS}); a pair: full prompt "
          f"{out['pair_full_s']:.3f} s ({2 / out['pair_full_s']:.2f} "
          f"answers/s), prefix path {out['pair_prefix_s']:.3f} s "
          f"({2 / out['pair_prefix_s']:.2f} answers/s), at most "
          f"{JUDGE_NEW_TOKENS} new tokens; peak memory {out['peak_gib']:.2f}"
          " GiB")
    del judge, state
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def siglip_cli_phase(dev, generator):
    """Phase 27 (e): ``eval/cli.main --judge videoscore`` and ``--judge
    minicpm-v`` under ``--byte-tokenizer`` on small-depth HF directories
    at full width (VS_CLI_DEPTH, MCPM_CLI_DEPTH; the published names,
    ``write_hf_dir``), bf16 states from ``generator``, videos from
    ``seeded_video_source`` (1280 x 720 frames, the judges' own
    preprocessing); every results row equal to the port's judge built as
    the CLI builds it on the directory, launches exact.  Returns the
    readings and the launches."""
    import dataclasses
    import shutil

    import torch

    from mjvideo_tpu_torch import judge_pair, kernels
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.eval import cli
    from mjvideo_tpu_torch.eval.judges import MiniCPMVJudge, VideoScoreJudge
    from mjvideo_tpu_torch.models import minicpmv as mm
    from mjvideo_tpu_torch.models import videoscore as vs
    from mjvideo_tpu_torch.utils.checkpoint import load_safetensors_dir

    out, launches = {}, {}
    vcfg = vs.VideoScoreConfig(num_labels=5)
    vcfg = dataclasses.replace(
        vcfg, vision=dataclasses.replace(
            vcfg.vision, num_hidden_layers=VS_CLI_DEPTH[0]),
        perceiver=dataclasses.replace(vcfg.perceiver, depth=VS_CLI_DEPTH[1]),
        text=dataclasses.replace(vcfg.text,
                                 num_hidden_layers=VS_CLI_DEPTH[2]))
    mcfg = mm.MiniCPMVConfig()
    mcfg = dataclasses.replace(
        mcfg, vision=dataclasses.replace(
            mcfg.vision, num_hidden_layers=MCPM_CLI_DEPTH[0]),
        text=dataclasses.replace(mcfg.text,
                                 num_hidden_layers=MCPM_CLI_DEPTH[1]))
    d = tempfile.mkdtemp()
    try:
        records = [{"caption": f"{JUDGE_CAPTION} ({i})",
                    "video_0_path": f"clip_{i}_0.mp4",
                    "video_1_path": f"clip_{i}_1.mp4",
                    "overall_preference": EVAL_PREFERENCES[i % 2]}
                   for i in range(SIGLIP_CLI_PAIRS)]
        data = os.path.join(d, "pairs.json")
        with open(data, "w") as f:
            json.dump(records, f)
        n = SIGLIP_CLI_PAIRS
        for name, cfg, init, hf, to_hf, want in (
                ("videoscore", vcfg, vs.init_videoscore_params,
                 videoscore_hf_state, vs.videoscore_config_to_hf,
                 _at_d72({"vit_attention": 2 * n * VS_CLI_DEPTH[0],
                          "decoder_attention": 2 * n * VS_CLI_DEPTH[2]})),
                ("minicpm-v", mcfg, mm.init_minicpmv_params,
                 minicpmv_hf_state, mm.minicpmv_config_to_hf,
                 _at_d72({"vit_attention": 2 * n * MCPM_CLI_DEPTH[0],
                          "exact_attention": n * MCPM_CLI_DEPTH[1]}))):
            ckpt = os.path.join(d, name)
            t0 = time.perf_counter()
            state = init(cfg, generator=generator(), device=dev,
                         dtype=torch.bfloat16)
            write_hf_dir(ckpt, to_hf(cfg), hf(state, cfg))
            del state
            write_s = time.perf_counter() - t0
            results = os.path.join(d, f"{name}.jsonl")
            with seeded_video_source():
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                cli.main(["--benchmark", "overall", "--judge", name,
                          "--judge-model", ckpt, "--byte-tokenizer",
                          "--data-json", data, "--video-root", d,
                          "--results", results])
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - t0
                launches[f"{name}_cli"] = _held_launches(f"{name} CLI", want)
                rows = [json.loads(line) for line in open(results)]
                paths = [(os.path.join(d, r["video_0_path"]),
                          os.path.join(d, r["video_1_path"]), r["caption"])
                         for r in records]
                if name == "videoscore":
                    judge = VideoScoreJudge(
                        ckpt, device=dev, tokenizer=ByteTokenizer(
                            pad_token_id=cfg.text.pad_token_id,
                            extra_specials={
                                "<fake_token_around_image>":
                                cfg.image_token_id - 1,
                                "<image>": cfg.image_token_id}))
                    want_rows = [(judge.score(a, c), judge.score(b, c))
                                 for a, b, c in paths]
                    got = [(r["score_0"], r["score_1"]) for r in rows]
                else:
                    params = mm.import_minicpmv_params(
                        load_safetensors_dir(ckpt), cfg, torch.bfloat16,
                        device=dev)
                    judge = MiniCPMVJudge(cfg, params, ByteTokenizer())
                    want_rows = [judge_pair(judge, a, b, c)
                                 for a, b, c in paths]
                    got = [(r["score_0"], r["score_1"], r["response_0"],
                            r["response_1"]) for r in rows]
                del judge
            same = got == [tuple(w) for w in want_rows]
            out[name] = {"write_s": write_s, "cli_s": cli_s,
                         "rows_equal": same, "rows": len(rows)}
            print(f"{name} CLI on a small-depth directory (written in "
                  f"{write_s:.1f} s): {len(rows)} rows in {cli_s:.1f} s; "
                  f"every row equal to the judge's: {same}")
            if not (same and len(rows) == n):
                raise RuntimeError(f"{name} CLI: rows {got} against "
                                   f"{want_rows}")
            shutil.rmtree(ckpt)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d)
    return out, launches


def _split_patch_mask(dev):
    """(20, 2730) int32: the patch mask of VideoScore's split frames
    (``videoscore_split_mask`` pooled as ``videoscore_forward`` pools it),
    K1m's key mask in phase 27 (c) and its check in (b)."""
    import torch

    from mjvideo_tpu_torch.models.videoscore import patch_mask_from_pixels

    patch = patch_mask_from_pixels(torch.from_numpy(videoscore_split_mask()),
                                   14)
    return patch.reshape(patch.shape[0], -1).to(dev, torch.int32)


def siglip_phase(dev, generator, drawer):
    """Phase 27: the D = 72 kernel checks, VideoScore, MiniCPM-V-2.6 and
    their CLI (see the module docstring).  Returns the readings, the kernel
    readings and the launch counts by path."""
    import gc

    import torch

    t0 = time.perf_counter()
    randn = drawer(generator())
    k = {"K1": {s: check_vit_attention(randn, s) for s in SIGLIP_K1_SHAPES}}
    gc.collect()
    torch.cuda.empty_cache()
    k["K1m"] = check_masked_vit_attention(randn, _split_patch_mask(dev))
    out = {"kernels_s": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["videoscore"], launches = videoscore_phase(dev, generator)
    out["videoscore"]["command_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["minicpmv"], more = minicpmv_phase(dev, generator)
    launches.update(more)
    out["minicpmv"]["command_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["cli"], more = siglip_cli_phase(dev, generator)
    launches.update(more)
    out["cli"]["command_s"] = time.perf_counter() - t1
    out["command_s"] = time.perf_counter() - t0
    print(f"phase 27 command time {out['command_s']:.1f} s")
    return out, k, launches


def siglip_hf_state(vis, cfg_vision, prefix):
    """A SigLIP tower's state under the published torch names (the inverse
    of ``utils.checkpoint.import_siglip_vision``), views of the state:
    VideoScore's ``vision_model.*``, MiniCPM-V's ``vpm.*``."""
    P = cfg_vision.patch_size
    emb = vis["patch_embedding"]
    out = {prefix + "embeddings.patch_embedding.weight":
           emb["kernel"].reshape(P, P, 3, -1).permute(3, 2, 0, 1),
           prefix + "embeddings.patch_embedding.bias": emb["bias"],
           prefix + "embeddings.position_embedding.weight":
           vis["position_embedding"],
           prefix + "post_layernorm.weight": vis["post_layernorm"]["weight"],
           prefix + "post_layernorm.bias": vis["post_layernorm"]["bias"]}
    names = {"ln1": "layer_norm1", "ln2": "layer_norm2",
             "q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    lp = vis["layers"]
    for i in range(cfg_vision.num_hidden_layers):
        pre = f"{prefix}encoder.layers.{i}."
        for ours, hf in names.items():
            node = lp[ours]
            out[f"{pre}{hf}.weight"] = (node["weight"][i] if "weight" in node
                                        else node["kernel"][i].t())
            out[f"{pre}{hf}.bias"] = node["bias"][i]
    return out


def videoscore_hf_state(state, cfg):
    """A VideoScore state under the published Idefics2 names (no whole-model
    exporter exists, in the JAX package or the port): the tower's, the
    connector's (``modality_projection``, ``perceiver_resampler``), the
    Mistral text model's as ``text_model.*`` (the port's Llama exporter)
    and ``score.weight``; views of the state."""
    from mjvideo_tpu_torch.utils.export import export_decoder

    out = siglip_hf_state(state["vision_model"], cfg.vision, "vision_model.")
    c = state["connector"]
    for n in ("gate", "up", "down"):
        out[f"connector.modality_projection.{n}_proj.weight"] = c[
            "modality_projection"][n]["kernel"].t()
    pr = "connector.perceiver_resampler."
    out[pr + "latents"] = c["latents"]
    out[pr + "norm.weight"] = c["norm"]["weight"]
    lp = c["layers"]
    norms = {"ln_latents": "input_latents_norm",
             "ln_context": "input_context_norm",
             "ln_post": "post_attention_layernorm"}
    for i in range(cfg.perceiver.depth):
        pre = f"{pr}layers.{i}."
        for ours, hf in norms.items():
            out[f"{pre}{hf}.weight"] = lp[ours]["weight"][i]
        for n in ("q", "k", "v", "o"):
            out[f"{pre}self_attn.{n}_proj.weight"] = lp[n]["kernel"][i].t()
        for n in ("gate", "up", "down"):
            out[f"{pre}mlp.{n}_proj.weight"] = lp[n]["kernel"][i].t()
    for k, v in export_decoder(state["text"], cfg.text, prefix="").items():
        out["text_model." + k[len("model."):]] = v
    out["score.weight"] = state["score"]["kernel"].t()
    return out


def minicpmv_hf_state(state, cfg):
    """A MiniCPM-V-2.6 state under the published names: ``vpm.*``,
    ``resampler.*`` (the packed ``attn.in_proj_weight``) and Qwen2's
    ``llm.model.*`` and ``llm.lm_head.weight``, which has no o_proj bias
    (the importer fills zeros); views of the state."""
    from mjvideo_tpu_torch.utils.export import export_decoder

    out = siglip_hf_state(state["vpm"], cfg.vision, "vpm.")
    r = state["resampler"]
    out.update({
        "resampler.query": r["query"], "resampler.proj": r["proj"],
        "resampler.kv_proj.weight": r["kv_proj"]["kernel"].t(),
        "resampler.attn.in_proj_weight": r["attn"]["in_proj"]["kernel"].t(),
        "resampler.attn.in_proj_bias": r["attn"]["in_proj"]["bias"],
        "resampler.attn.out_proj.weight":
        r["attn"]["out_proj"]["kernel"].t(),
        "resampler.attn.out_proj.bias": r["attn"]["out_proj"]["bias"]})
    for n in ("ln_q", "ln_kv", "ln_post"):
        out[f"resampler.{n}.weight"] = r[n]["weight"]
        out[f"resampler.{n}.bias"] = r[n]["bias"]
    out.update({k: v for k, v in export_decoder(
        state["llm"], cfg.text, prefix="llm.").items()
        if not k.endswith("o_proj.bias")})
    return out


def write_hf_dir(d, hf_config, hf_state):
    """An HF checkpoint directory: ``config.json`` and one F32 safetensors
    file of ``hf_state`` (brought to the host a tensor at a time)."""
    from mjvideo_tpu_torch.utils.export import save_safetensors

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_config, f)
    save_safetensors(hf_state, os.path.join(d, "model.safetensors"))


def check_k3_d112(randn, shape):
    """Phase 28 (a): K3 not causal at the EVA2-CLIP-E tower's D = 112 on
    views into one (B, S, 3 H D) tensor, as the tower makes them, against
    its twin, two launches bit-identical, SDPA the library yardstick; then
    the kernel, SDPA and the twin in turns by CUDA events, and the kernel's
    device time and back-to-back time.  Returns the reading."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa

    B, S, H, D = shape
    q, k, v = (t.view(B, S, H, D)
               for t in randn(B, S, 3 * H * D).split(H * D, dim=-1))

    def kernel():
        return kernels.exact_attention(q, k, v, None, None, D ** -0.5,
                                       causal=False)

    def plain():
        return fa.exact_attention_plain(q, k, v, causal=False)

    library = _sdpa(q, k, v, causal=False)
    reading = _check_kernel(
        f"K3 exact_attention D = 112 not causal {shape}", kernel, plain,
        extra=_again(kernel),
        work=_attention_work(q, k, v, None, causal=False), library=library)
    runs = {"K3": kernel, "SDPA": library, "plain": plain}
    med = _in_turns(runs, list(runs) + list(runs)[::-1], 10)
    reading.update(ms_in_turns=med["K3"], sdpa_ms_in_turns=med["SDPA"],
                   plain_ms_in_turns=med["plain"],
                   device_ms=device_ms(kernel),
                   back_to_back_ms=stream_ms(kernel))
    print(f"K3 D = 112 at {shape}, in turns: K3 {med['K3']:.4f} ms, SDPA "
          f"{med['SDPA']:.4f} ms, plain {med['plain']:.4f} ms (median of "
          f"20 each); device time by kernel "
          + ", ".join(f"{n} {t:.4f} ms"
                      for n, t in reading["device_ms"].items())
          + f"; back to back {reading['back_to_back_ms']:.4f} ms a call")
    return reading


def _seeded_cog_encode(judge, video_path):
    """``CogVLM2Judge._encode_video`` on seeded pixels of COG_FRAMES frames
    at the model's 224 px (normalised pixels) in place of a decoded video:
    the tower and the adapter on fp32 pixels with each product's inputs in
    the judge's dtype."""
    import numpy as np
    import torch

    from mjvideo_tpu_torch.models.cogvlm2 import get_vision_embedding

    size = judge.cfg.vision.image_size
    rng = np.random.default_rng([judge.video_seed, _path_seed(video_path)])
    pix = rng.standard_normal((COG_FRAMES, size, size, 3), dtype=np.float32)
    with torch.no_grad():
        vis = get_vision_embedding(
            judge.params, judge.cfg,
            torch.from_numpy(pix).to(judge.device), impl=judge.attn_impl,
            dtype=judge.dtype, mesh=judge.mesh)
    return vis, COG_FRAMES


def make_cog_judge(cfg, state, tok, vision_of=None, dtype=None, seed=SEED,
                   **kw):
    """A ``CogVLM2Judge`` whose videos are pixels seeded by ``seed`` and the
    path (``_seeded_cog_encode``), or, with ``vision_of`` (another judge),
    that judge's vision embeds of each video cast to this one's dtype: the
    decoder's reading with the tower held equal.  ``dtype``: the decoder's
    activation dtype and the tower's product inputs in place of the
    weights' (``torch.float32`` on the bf16 state with
    ``attn_impl="plain"`` is the fp32 reference)."""
    from mjvideo_tpu_torch.eval.judges import CogVLM2Judge

    class SeededCogVLM2Judge(CogVLM2Judge):
        if vision_of is None:
            _encode_video = _seeded_cog_encode
        else:
            def _encode_video(self, video_path):
                vis, n = vision_of._prep(video_path)
                return vis.to(self.dtype), n

    kw = {"num_segments": COG_FRAMES, "max_new_tokens": JUDGE_NEW_TOKENS,
          **kw}
    judge = SeededCogVLM2Judge(cfg, state, tok, **kw)
    judge.dtype = dtype or judge.dtype
    judge.video_seed = seed
    return judge


def _cog_logits(judge, fp32, bf16, prompt, videos, prefix, label):
    """One path's teacher-forced logits on the kernel judge's greedy tokens:
    (the kernels against fp32 plain, S1's split: bf16 plain against fp32
    plain), each max|delta| / max|fp32 plain logit|."""
    toks = _qwen_teacher(judge, prompt, videos, prefix)
    ref = _qwen_teacher(fp32, prompt, videos, prefix, toks)
    got = _qwen_teacher(judge, prompt, videos, prefix, toks)
    if not bool(got.isfinite().all()):
        raise RuntimeError(f"cogvlm2 judge {label}: non-finite logits")
    rel = _rel_err(got, ref)[1]
    split = _rel_err(_qwen_teacher(bf16, prompt, videos, prefix, toks),
                     ref)[1]
    print(f"cogvlm2 judge {label}: greedy tokens of row 0 begin "
          f"{toks[0, :8].tolist()}; teacher-forced logits over "
          f"{toks.shape[1]} steps, the kernels against fp32 plain "
          f"{rel:.4e} of max|plain logit| (bound {LOGITS_REL_TOL:.1e}); "
          f"S1's split, bf16 plain against fp32 plain {split:.4e}")
    return rel, split


def cogvlm2_fidelity(cfg, state, tok, judge, videos, seed=SEED):
    """Phase 28's fidelity readings of ``judge`` (the kernels, bf16) on
    ``state`` against fp32 plain on the same state, with S1's split (bf16
    plain against fp32 plain) beside each, each max|delta| / max|fp32
    plain|: the tower and adapter's output of the first video; the
    teacher-forced logits of the full prompt and of the prefix path; and
    the same logits with the plain judges given the kernel judge's vision
    embeds (the decoder alone).  Holds nothing; returns the readings."""
    import gc

    import torch

    from mjvideo_tpu_torch import overall_prompt

    out = {}
    plains = (make_cog_judge(cfg, state, tok, attn_impl="plain",
                             dtype=torch.float32, seed=seed),
              make_cog_judge(cfg, state, tok, attn_impl="plain", seed=seed))
    vis = {}
    for name, j in (("kernels", judge), ("fp32", plains[0]),
                    ("bf16", plains[1])):
        vis[name] = j._prep(videos[0])[0]
    out["vision_rel"] = _rel_err(vis["kernels"], vis["fp32"])[1]
    out["vision_bf16_plain_rel"] = _rel_err(vis["bf16"], vis["fp32"])[1]
    print(f"cogvlm2 tower and adapter ({COG_FRAMES} frames, "
          f"{tuple(vis['kernels'].shape)}, {vis['kernels'].dtype}): kernels "
          f"against fp32 plain {out['vision_rel']:.4e} of max|plain| (bound "
          f"{LOGITS_REL_TOL:.1e}); S1's split, bf16 plain against fp32 "
          f"plain {out['vision_bf16_plain_rel']:.4e}")
    del vis
    # The decoder alone: the plain judges take the kernel judge's vision
    # embeds, so the reading holds the decoder's kernels and arithmetic
    # at full depth.
    shared = tuple(make_cog_judge(cfg, state, tok, vision_of=judge,
                                  attn_impl="plain", dtype=dt, seed=seed)
                   for dt in (torch.float32, torch.bfloat16))
    prompt = overall_prompt(JUDGE_CAPTION)
    for key, q, prefix in (("full", prompt, False),
                           ("prefix", JUDGE_QUESTION, True)):
        label = "full prompt" if key == "full" else key
        out[f"{key}_rel"], out[f"{key}_bf16_plain_rel"] = _cog_logits(
            judge, *plains, q, videos, prefix, label)
        (out[f"{key}_decoder_rel"],
         out[f"{key}_decoder_bf16_plain_rel"]) = _cog_logits(
            judge, *shared, q, videos, prefix, f"{label}, the decoder alone")
    del plains, shared
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cogvlm2_held(out):
    """Raises where a reading of ``cogvlm2_fidelity``'s held by phase 28
    (the tower, both paths end to end, both with the decoder alone)
    exceeds LOGITS_REL_TOL."""
    keys = ("vision_rel", "full_rel", "prefix_rel", "full_decoder_rel",
            "prefix_decoder_rel")
    missed = {k: out[k] for k in keys if not out[k] <= LOGITS_REL_TOL}
    if missed:
        raise RuntimeError(f"cogvlm2 judge against fp32 plain: {missed} > "
                           f"{LOGITS_REL_TOL}")


def cogvlm2_judge_phase(dev, generator):
    """Phase 28 (b): ``CogVLM2Judge`` on CogVLM2-Video at full dims (see the
    module docstring).  The fp32 reference runs on the bf16 state itself
    (``dtype=torch.float32``, ``impl="plain"``).  Returns the readings and
    the launches."""
    import gc

    import torch

    from mjvideo_tpu_torch import judge_pair, kernels
    from mjvideo_tpu_torch import overall_prompt
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.models.cogvlm2 import (
        CogVLM2Config,
        build_video_prompt_ids,
        get_vision_embedding,
        greedy_generate_batch,
        init_cogvlm2_params,
    )

    cfg = cut_text_depth(CogVLM2Config(), COG_LLM_DEPTH)
    L_vit, L_llm = cfg.vision.num_hidden_layers, cfg.text.num_hidden_layers
    videos = ("video_0", "video_1")
    out, launches = {}, {}
    t0 = time.perf_counter()
    state = init_cogvlm2_params(cfg, generator=generator(), device=dev,
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out["state_s"] = time.perf_counter() - t0
    out["params"] = sum(t.numel() for t in _flat_state(state).values())
    out["state_gib"] = sum(t.numel() * t.element_size()
                           for t in _flat_state(state).values()) / 2**30
    print(f"CogVLM2-Video state (bf16, {out['params'] / 1e9:.2f} B "
          f"parameters, {out['state_gib']:.1f} GiB) made on the card in "
          f"{out['state_s']:.1f} s")
    tok = ByteTokenizer()
    torch.cuda.reset_peak_memory_stats(dev)
    judge = make_cog_judge(cfg, state, tok)
    kernels.reset_launch_counts()
    s0, s1, r0, r1 = judge_pair(judge, *videos, JUDGE_CAPTION)
    torch.cuda.synchronize()
    launches["cogvlm2_judge_full"] = _held_launches(
        "cogvlm2 judge full prompt", {
            "exact_attention": 2 * L_vit + L_llm,
            "exact_attention_d112": 2 * L_vit})
    print(f"cogvlm2 judge full prompt: ratings {s0}, {s1}; answers "
          f"{r0!r:.60}, {r1!r:.60}")
    kernels.reset_launch_counts()
    judge.ask_batch(JUDGE_QUESTION, list(videos))
    torch.cuda.synchronize()
    launches["cogvlm2_judge_prefix"] = _held_launches(
        "cogvlm2 judge prefix", {"exact_attention": 3 * L_llm})
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out.update(cogvlm2_fidelity(cfg, state, tok, judge, videos))
    cogvlm2_held(out)
    out["peak_with_plain_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    import numpy as np

    prompt = overall_prompt(JUDGE_CAPTION)

    size = cfg.vision.image_size
    pix = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (COG_FRAMES, size, size, 3), dtype=np.float32)).to(dev)
    with torch.no_grad():
        out["vision_ms"] = _host_ms(lambda: get_vision_embedding(
            state, cfg, pix))
    preps = [judge._prep(v) for v in videos]
    items = [build_video_prompt_ids(tok, cfg, n, prompt) + (None,)
             for _, n in preps]

    def generate(n):
        return greedy_generate_batch(state, cfg, items, max_new_tokens=n,
                                     eos_token_id=-1,
                                     vision_embeds=[v for v, _ in preps])

    out["prefill_ms"] = _host_ms(lambda: generate(1))
    steps_ms = _host_ms(lambda: generate(1 + COG_DECODE_STEPS))
    out["decode_step_ms"] = (steps_ms - out["prefill_ms"]) / COG_DECODE_STEPS
    out["pair_full_s"] = _host_ms(
        lambda: judge_pair(judge, *videos, JUDGE_CAPTION), PAIR_REPS) / 1e3
    out["pair_prefix_s"] = _host_ms(
        lambda: judge.ask_batch(JUDGE_QUESTION, list(videos)),
        PAIR_REPS) / 1e3
    out["prompt_tokens"] = items[0][0].shape[1]
    print(f"cogvlm2 judge time: vision tower and adapter "
          f"{out['vision_ms']:.1f} ms a video ({COG_FRAMES} frames at "
          f"{size} px); the pair's full-prompt prefill "
          f"({out['prompt_tokens']} tokens a row) {out['prefill_ms']:.1f} ms;"
          f" decode step at B = 2 {out['decode_step_ms']:.2f} ms (by "
          f"difference over {COG_DECODE_STEPS}); a pair: full prompt "
          f"{out['pair_full_s']:.3f} s ({2 / out['pair_full_s']:.2f} "
          f"answers/s), prefix path {out['pair_prefix_s']:.3f} s "
          f"({2 / out['pair_prefix_s']:.2f} answers/s), at most "
          f"{JUDGE_NEW_TOKENS} new tokens; peak memory {out['peak_gib']:.2f}"
          f" GiB (kernels), {out['peak_with_plain_gib']:.2f} GiB with the "
          "fp32 reference")
    del judge, state
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def cogvlm2_cli_phase(dev, generator):
    """Phase 28 (c): ``eval/cli.main --judge cogvlm2 --byte-tokenizer`` on a
    THUDM-named directory at full width and COG_CLI_DEPTH (the port's
    exporter, ``write_hf_dir``), a bf16 state from ``generator``, videos
    from ``seeded_video_source`` (the judge's own preprocessing to 224 px):
    every results row equal to the port's judge built as the CLI builds it
    on the directory, launches exact.  Returns the readings and the
    launches."""
    import dataclasses
    import shutil

    import torch

    from mjvideo_tpu_torch import judge_pair, kernels
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.eval import cli
    from mjvideo_tpu_torch.eval.judges import CogVLM2Judge
    from mjvideo_tpu_torch.models import cogvlm2 as cm
    from mjvideo_tpu_torch.utils.checkpoint import load_safetensors_dir
    from mjvideo_tpu_torch.utils.export import export_cogvlm2

    cfg = cm.CogVLM2Config()
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(
            cfg.vision, num_hidden_layers=COG_CLI_DEPTH[0]),
        text=dataclasses.replace(cfg.text,
                                 num_hidden_layers=COG_CLI_DEPTH[1]))
    n = COG_CLI_PAIRS
    d = tempfile.mkdtemp()
    try:
        records = [{"caption": f"{JUDGE_CAPTION} ({i})",
                    "video_0_path": f"clip_{i}_0.mp4",
                    "video_1_path": f"clip_{i}_1.mp4",
                    "overall_preference": EVAL_PREFERENCES[i % 2]}
                   for i in range(n)]
        data = os.path.join(d, "pairs.json")
        with open(data, "w") as f:
            json.dump(records, f)
        ckpt = os.path.join(d, "cogvlm2")
        t0 = time.perf_counter()
        state = cm.init_cogvlm2_params(cfg, generator=generator(),
                                       device=dev, dtype=torch.bfloat16)
        write_hf_dir(ckpt, cm.cogvlm2_config_to_hf(cfg),
                     export_cogvlm2(state, cfg))
        del state
        write_s = time.perf_counter() - t0
        results = os.path.join(d, "cogvlm2.jsonl")
        with seeded_video_source():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(["--benchmark", "overall", "--judge", "cogvlm2",
                      "--judge-model", ckpt, "--byte-tokenizer",
                      "--data-json", data, "--video-root", d,
                      "--results", results])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = {"cogvlm2_cli": _held_launches("cogvlm2 CLI", {
                "exact_attention": n * (2 * COG_CLI_DEPTH[0]
                                        + COG_CLI_DEPTH[1]),
                "exact_attention_d112": 2 * n * COG_CLI_DEPTH[0]})}
            rows = [json.loads(line) for line in open(results)]
            params = cm.import_cogvlm2_params(load_safetensors_dir(ckpt), cfg,
                                              torch.bfloat16, device=dev)
            judge = CogVLM2Judge(cfg, params, ByteTokenizer())
            want = [judge_pair(judge, os.path.join(d, r["video_0_path"]),
                               os.path.join(d, r["video_1_path"]),
                               r["caption"]) for r in records]
            del judge, params
        got = [(r["score_0"], r["score_1"], r["response_0"], r["response_1"])
               for r in rows]
        same = got == [tuple(w) for w in want]
        out = {"write_s": write_s, "cli_s": cli_s, "rows_equal": same,
               "rows": len(rows)}
        print(f"cogvlm2 CLI on a small-depth directory (written in "
              f"{write_s:.1f} s): {len(rows)} rows in {cli_s:.1f} s; every "
              f"row equal to the judge's: {same}")
        if not (same and len(rows) == n):
            raise RuntimeError(f"cogvlm2 CLI: rows {got} against {want}")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d)
    return out, launches


def cogvlm2_phase(dev, generator, drawer):
    """Phase 28: the D = 112 kernel checks, the CogVLM2-Video judge and its
    CLI (see the module docstring).  Returns the readings, the kernel
    readings and the launch counts by path."""
    import gc

    import torch

    t0 = time.perf_counter()
    randn = drawer(generator())
    k = {"K3": {s: check_k3_d112(randn, s) for s in COG_K3_SHAPES}}
    out = {"kernels_s": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["judge"], launches = cogvlm2_judge_phase(dev, generator)
    out["judge"]["command_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["cli"], more = cogvlm2_cli_phase(dev, generator)
    launches.update(more)
    out["cli"]["command_s"] = time.perf_counter() - t1
    out["command_s"] = time.perf_counter() - t0
    print(f"phase 28 command time {out['command_s']:.1f} s")
    return out, k, launches


# ------------------------------------------------------------------ phase 29

def init_chat_params_by_layer(cfg, generator, device, dtype=None):
    """``init_chat_params(cfg, with_lm_head=True)``'s tree, scales and
    constants (dense leaves N(0, 0.02), norm weights 1, biases 0,
    LayerScale ``initializer_factor``), each random leaf drawn into a
    ``dtype`` (bf16) tensor made first and a stacked ``[L, ...]`` leaf a
    layer at a time, as ``init_cogvlm2_params`` draws: no fp32 copy of a
    whole stack is made (the 26B's (48, 6144, 16384) MLP stack would be
    19.3 GB in fp32, twice over with the scale).  The draws are not
    ``init_chat_params``'s, which the other phases' states keep."""
    import torch

    from mjvideo_tpu_torch import init_chat_params

    dtype = dtype or torch.bfloat16
    shapes = init_chat_params(cfg, generator=None,
                              device=torch.device("meta"), dtype=dtype,
                              with_lm_head=True)

    def fill(path, meta):
        out = torch.empty(meta.shape, dtype=dtype, device=device)
        name = path[-1]
        if name in ("kernel", "class_embedding", "position_embedding",
                    "tok_embeddings"):
            for row in out.unbind(0) if "layers" in path else (out,):
                row.copy_(torch.randn(row.shape, generator=generator,
                                      device=device) * 0.02)
        elif name in ("ls1", "ls2"):
            out.fill_(cfg.vision.initializer_factor)
        elif name in ("weight", "bias"):
            out.fill_(1.0 if name == "weight" else 0.0)
        else:
            raise ValueError(f"no rule for {'.'.join(path)}")
        return out

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else fill(path + (k,), v) for k, v in tree.items()}

    return walk(shapes, ())


def ivl_reference_judges(judge, base):
    """The fp32 plain and the bf16 plain judges on ``judge``'s bf16 state
    itself (S1's split).  The fp32 one takes its pixels in fp32 and the
    token table in fp32 (so that the decoder's activations and its cache
    are fp32), through ``impl="plain"``: each product promotes one weight
    at a time, as an fp32 copy of the 26B's 47.5 GiB state would not fit
    beside it."""
    import torch

    state = judge.params
    lm = state["language_model"]
    fp32_state = {**state, "language_model": {
        **lm, "tok_embeddings": lm["tok_embeddings"].float()}}
    return (make_judge(state=fp32_state, base=base, impl="plain",
                       pixel_dtype=torch.float32),
            make_judge(state=state, base=base, impl="plain"))


def ivl_fidelity(judge, base, videos=("video_0", "video_1")):
    """Phase 29 (b)'s readings of ``judge`` (the kernels, bf16) against fp32
    plain on its own state, S1's split (bf16 plain against fp32 plain)
    beside each, each max|delta| / max|fp32 plain|: the tower and mlp1's
    output of the first video; the teacher-forced logits, on the kernel
    judge's greedy tokens, of the full prompt, of the prefix path and of
    the prefix path under the per-row bound (K2r; teacher-forced on the
    prefix path's tokens, so that the plain judges' logits, which take the
    exact softmax the bound does not change, serve both).  Holds nothing;
    returns the readings and each path's greedy tokens."""
    import gc

    import torch

    from mjvideo_tpu_torch import overall_prompt
    from mjvideo_tpu_torch.models import generate as gen

    plains = ivl_reference_judges(judge, base)
    out, tokens = {}, {}
    vis = [j._prep(videos[0])[0] for j in (judge, *plains)]
    out["vision_rel"] = _rel_err(vis[0], vis[1])[1]
    out["vision_bf16_plain_rel"] = _rel_err(vis[2], vis[1])[1]
    print(f"internvl judge tower and mlp1 ({JUDGE_FRAMES} frames, "
          f"{tuple(vis[0].shape)}): kernels against fp32 plain "
          f"{out['vision_rel']:.4e} of max|plain| (bound "
          f"{LOGITS_REL_TOL:.1e}); S1's split, bf16 plain against fp32 plain"
          f" {out['vision_bf16_plain_rel']:.4e}")
    del vis
    refs = None
    for key, prompt, prefix, bound in (
            ("full", overall_prompt(JUDGE_CAPTION), False, False),
            ("prefix", JUDGE_QUESTION, True, False),
            ("prefix_rows", JUDGE_QUESTION, True, "rows")):
        judge._pstate.cache_clear()
        gen._CACHE_BOUND = bound
        try:
            run = path_runner(judge, prompt, videos, prefix)
            toks = tokens["prefix"] if bound else run()
            got = run(teacher_tokens=toks)
        finally:
            gen._CACHE_BOUND = False
            judge._pstate.cache_clear()
        if not bool(got.isfinite().all()):
            raise RuntimeError(f"internvl judge {key}: non-finite logits")
        if not bound:
            refs = [path_runner(j, prompt, videos, prefix)(
                teacher_tokens=toks) for j in plains]
        ref, split = refs
        out[f"{key}_rel"] = _rel_err(got, ref)[1]
        out[f"{key}_bf16_plain_rel"] = _rel_err(split, ref)[1]
        tokens[key] = toks
        print(f"internvl judge {key}: teacher tokens of row 0 begin "
              f"{toks[0, :8].tolist()}; teacher-forced logits over "
              f"{toks.shape[1]} steps, the kernels against fp32 plain "
              f"{out[f'{key}_rel']:.4e} of max|plain logit| (bound "
              f"{LOGITS_REL_TOL:.1e}); S1's split, bf16 plain against fp32 "
              f"plain {out[f'{key}_bf16_plain_rel']:.4e}")
    del plains, refs
    gc.collect()
    torch.cuda.empty_cache()
    return out, tokens


def ivl_held(out, label):
    """Holds each of ``ivl_fidelity``'s readings to LOGITS_REL_TOL.  Where
    bf16 plain alone misses the bar too, a miss is a standing failure of
    bf16 arithmetic (printed and returned), unless the kernels add more
    than the bar to bf16 plain's reading; raises otherwise.  Returns the
    standing failures."""
    standing = {}
    for key in ("vision", "full", "prefix", "prefix_rows"):
        rel, floor = out[f"{key}_rel"], out[f"{key}_bf16_plain_rel"]
        if rel <= LOGITS_REL_TOL:
            continue
        if floor > LOGITS_REL_TOL and rel - floor <= LOGITS_REL_TOL:
            print(f"{label} {key}: MISSES the bar ({rel:.4e} against "
                  f"{LOGITS_REL_TOL}); bf16 plain alone misses it too "
                  f"({floor:.4e}) and the kernels add {rel - floor:+.4e}: a "
                  "standing failure of bf16 arithmetic at this depth "
                  "(ROADMAP Queue 3), not a kernel fault")
            standing[key] = {"rel": rel, "bf16_plain_rel": floor}
            continue
        raise RuntimeError(f"{label} {key}: {rel} against fp32 plain > "
                           f"{LOGITS_REL_TOL} (bf16 plain {floor})")
    return standing


def internvl26b_judge_phase(dev, generator):
    """Phase 29 (b): ``InternVLJudge`` on InternVL2-26B at full width, its
    decoder IVL_26B_LLM_DEPTH deep (see the module docstring), its state
    drawn a layer at a time.  Returns the readings and the launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from mjvideo_tpu_torch import (
        extract_feature,
        internvl2_26b_chat_config,
        judge_pair,
        kernels,
    )
    from mjvideo_tpu_torch.models import generate as gen

    base = internvl2_26b_chat_config()
    base = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, num_hidden_layers=IVL_26B_LLM_DEPTH))
    videos = ("video_0", "video_1")
    out, launches = {}, {}
    t0 = time.perf_counter()
    state = init_chat_params_by_layer(base, generator(), dev)
    torch.cuda.synchronize()
    out["state_s"] = time.perf_counter() - t0
    flat = _flat_state(state).values()
    out["params"] = sum(t.numel() for t in flat)
    out["state_gib"] = sum(t.numel() * t.element_size() for t in flat) / 2**30
    print(f"InternVL2-26B state ({IVL_26B_LLM_DEPTH} decoder layers, bf16, "
          f"{out['params'] / 1e9:.2f} B parameters, "
          f"{out['state_gib']:.1f} GiB) made on the card in "
          f"{out['state_s']:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    judge = make_judge(state=state, base=base)
    cfg = judge.cfg
    L_vit = cfg.vision.num_hidden_layers
    L_llm = cfg.llm.num_hidden_layers
    kernels.reset_launch_counts()
    s0, s1, r0, r1 = judge_pair(judge, *videos, JUDGE_CAPTION)
    torch.cuda.synchronize()
    launches["internvl26b_judge_full"] = _held_launches(
        "internvl26b judge full prompt", _judge_launches(cfg, _with_prepass(
            {"vit_attention": 2 * L_vit, "exact_attention": L_llm})))
    print(f"internvl26b judge full prompt: ratings {s0}, {s1}; answers "
          f"{r0!r:.60}, {r1!r:.60}")
    kernels.reset_launch_counts()
    answers = judge.ask_batch(JUDGE_QUESTION, list(videos))
    torch.cuda.synchronize()
    launches["internvl26b_judge_prefix"] = _held_launches(
        "internvl26b judge prefix", {"exact_attention": 3 * L_llm})
    print(f"internvl26b judge prefix: answers {[a[:60] for a in answers]!r}")
    if not all(isinstance(a, str) for a in (r0, r1, *answers)):
        raise RuntimeError("an internvl26b answer did not decode to text")
    judge._pstate.cache_clear()
    gen._CACHE_BOUND = "rows"
    try:
        kernels.reset_launch_counts()
        judge.ask_batch(JUDGE_QUESTION, list(videos))
        torch.cuda.synchronize()
        launches["internvl26b_judge_prefix_rows"] = _held_launches(
            "internvl26b judge prefix rows", {
                "decoder_attention_rows": 3 * L_llm,
                "key_norm_cummax": 3 * L_llm})
    finally:
        gen._CACHE_BOUND = False
        judge._pstate.cache_clear()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    readings, tokens = ivl_fidelity(judge, base, videos)
    out.update(readings)
    out["standing"] = ivl_held(out, "internvl26b judge")
    out["peak_with_plain_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30

    size = cfg.image_size
    pix = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(JUDGE_FRAMES, size, size, 3))).to(dev, torch.bfloat16)
    with torch.no_grad():
        out["vision_ms"] = _host_ms(lambda: extract_feature(state, cfg, pix))
    out.update(time_judge(judge, videos, _drawn(judge, tokens["full"]),
                          _drawn(judge, tokens["prefix"])))
    print(f"internvl26b judge: vision tower and mlp1 {out['vision_ms']:.1f} "
          f"ms a video ({JUDGE_FRAMES} tiles of {size} px); peak memory "
          f"{out['peak_gib']:.2f} GiB (kernels), "
          f"{out['peak_with_plain_gib']:.2f} GiB with the fp32 reference")
    del judge, state
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def internvl26b_cli_phase(dev, generator):
    """Phase 29 (d): ``eval/cli.main --judge internvl-chat
    --byte-tokenizer`` on an InternVL2-26B-layout directory at full width
    and IVL_CLI_DEPTH (the port's exporter, ``write_hf_dir``), a bf16 state
    drawn a layer at a time from ``generator``, videos from
    ``seeded_video_source``: every results row equal to the port's judge
    built as the CLI builds it (``cli._make_judge``) on the directory,
    launches exact.  Returns the readings and the launches."""
    import dataclasses
    import shutil

    import torch

    from mjvideo_tpu_torch import (
        RewardConfig,
        internvl2_26b_chat_config,
        judge_pair,
        kernels,
    )
    from mjvideo_tpu_torch.configs import reward_config_to_hf
    from mjvideo_tpu_torch.eval import cli
    from mjvideo_tpu_torch.utils.export import export_chat

    base = internvl2_26b_chat_config()
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(
            base.vision, num_hidden_layers=IVL_CLI_DEPTH[0]),
        llm=dataclasses.replace(base.llm,
                                num_hidden_layers=IVL_CLI_DEPTH[1]))
    n = IVL_CLI_PAIRS
    d = tempfile.mkdtemp()
    try:
        records = [{"caption": f"{JUDGE_CAPTION} ({i})",
                    "video_0_path": f"clip_{i}_0.mp4",
                    "video_1_path": f"clip_{i}_1.mp4",
                    "overall_preference": EVAL_PREFERENCES[i % 2]}
                   for i in range(n)]
        data = os.path.join(d, "pairs.json")
        with open(data, "w") as f:
            json.dump(records, f)
        ckpt = os.path.join(d, "InternVL2-26B")
        t0 = time.perf_counter()
        state = init_chat_params_by_layer(cfg, generator(), dev)
        write_hf_dir(ckpt, reward_config_to_hf(RewardConfig(chat=cfg)),
                     export_chat(state, cfg))
        del state
        write_s = time.perf_counter() - t0
        results = os.path.join(d, "internvl26b.jsonl")
        argv = ["--benchmark", "overall", "--judge", "internvl-chat",
                "--judge-model", ckpt, "--byte-tokenizer", "--data-json",
                data, "--video-root", d, "--results", results]
        with seeded_video_source():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = {"internvl26b_cli": _held_launches(
                "internvl26b CLI", _judge_launches(cfg, _with_prepass({
                    "vit_attention": 2 * n * IVL_CLI_DEPTH[0],
                    "exact_attention": n * IVL_CLI_DEPTH[1]})))}
            rows = [json.loads(line) for line in open(results)]
            judge = cli._make_judge(cli.build_parser().parse_args(argv))
            want = [judge_pair(judge, os.path.join(d, r["video_0_path"]),
                               os.path.join(d, r["video_1_path"]),
                               r["caption"]) for r in records]
            del judge
        got = [(r["score_0"], r["score_1"], r["response_0"], r["response_1"])
               for r in rows]
        same = got == [tuple(w) for w in want]
        out = {"write_s": write_s, "cli_s": cli_s, "rows_equal": same,
               "rows": len(rows)}
        print(f"internvl26b CLI on a small-depth directory (written in "
              f"{write_s:.1f} s): {len(rows)} rows in {cli_s:.1f} s; every "
              f"row equal to the judge's: {same}")
        if not (same and len(rows) == n):
            raise RuntimeError(f"internvl26b CLI: rows {got} against {want}")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d)
    return out, launches


def internvl_phase(dev, generator, drawer, time_8b=False):
    """Phase 29: K1 at InternViT-6B's D = 128, the InternVL2-26B and -8B
    judges and the CLI (see the module docstring); ``time_8b``: the 8B
    judge's times too (``time_judge``, about 35 s).  Returns the readings,
    the kernel readings and the launch counts by path."""
    import dataclasses
    import gc

    import torch

    from mjvideo_tpu_torch import internvl2_8b_chat_config

    t0 = time.perf_counter()
    randn = drawer(generator())
    k = {"K1": {s: check_vit_attention(randn, s, dense_qk=True, turns=True)
                for s in IVL_K1_SHAPES}}
    out = {"kernels_s": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["judge_26b"], launches = internvl26b_judge_phase(dev, generator)
    out["judge_26b"]["command_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    base_8b = internvl2_8b_chat_config()
    base_8b = dataclasses.replace(base_8b, llm=dataclasses.replace(
        base_8b.llm, num_hidden_layers=IVL_8B_LLM_DEPTH))
    out["judge_8b"], more = judge_phase(dev, timing=time_8b, base=base_8b,
                                        name="internvl8b_judge")
    launches.update(more)
    out["judge_8b"]["command_s"] = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["cli"], more = internvl26b_cli_phase(dev, generator)
    launches.update(more)
    out["cli"]["command_s"] = time.perf_counter() - t1
    out["command_s"] = time.perf_counter() - t0
    print(f"phase 29 command time {out['command_s']:.1f} s")
    return out, k, launches


def _options_paths(params):
    """Phase 30's gradient set: stage 3's trainable tensors and the ViT's
    layer stack (which trains in no stage), so that the ViT's blocks are
    recorded and rematerialised too: K1 with the lse and K4 nc run."""
    from mjvideo_tpu_torch.train.trainer import flatten_state, trainable_mask

    return sorted(trainable_mask(params, 3) | {
        p for p in flatten_state(params)
        if p.startswith("model/vision_model/layers/")})


def _options_grad(cfg, tc, params, paths, batch, dev, rng=None):
    """(loss, gradients of ``paths``) of one micro-batch under ``tc`` on
    the bf16 kernel path, the ViT noise of key ``rng``."""
    import torch

    from mjvideo_tpu_torch.train.trainer import (
        flatten_state,
        make_loss_fn,
        place_batch,
        set_trainable,
    )

    set_trainable(params, set(paths))
    flat = flatten_state(params)
    loss = make_loss_fn(cfg, tc)(
        params, place_batch(batch, dev, torch.bfloat16), rng)
    return loss.detach(), torch.autograd.grad(loss,
                                              [flat[p] for p in paths])


def _equal_grads(label, got, ref):
    """Hold (loss, gradients) ``got`` bit-equal to ``ref``; returns the
    reading (the largest difference, 0 when equal)."""
    import torch

    loss, grads = got
    worst = max((g.float() - r.float()).abs().max().item()
                for g, r in zip(grads, ref[1]))
    same = all(torch.equal(x, y) for x, y in zip([loss, *grads],
                                                  [ref[0], *ref[1]]))
    print(f"{label}: loss {loss.item():.6f} against {ref[0].item():.6f}; "
          f"every gradient bit-equal: {same} (largest difference {worst:.3e})")
    if not same:
        raise RuntimeError(f"{label}: the loss or a gradient differs "
                           f"(largest difference {worst})")
    return worst


def remat_policies(cfg, params, batch, dev):
    """Phase 30 (a): one value-and-gradient of ``batch`` (the stage-3
    trainable set and the ViT's layers) under ``remat`` False, True and
    "dots": the loss and every gradient bit-equal across the three (the
    recompute runs the same deterministic kernels on the same inputs; the
    saved products are the first forward's), exact launches, the peak
    memory above the state (``max_memory_allocated``), the time by CUDA
    events and the device time (the profiler's kernels summed)."""
    from dataclasses import replace

    import torch

    from mjvideo_tpu_torch import kernels

    paths = _options_paths(params)
    tc0 = train_config("unused")
    out, launches, ref = {}, {}, None
    for remat in (False, True, "dots"):
        tc = replace(tc0, remat=remat)

        def run():
            return _options_grad(cfg, tc, params, paths, batch, dev)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        want = {k: 2 * n for k, n in _grad_launches(
            cfg, forwards=2 if remat else 1).items()}
        label = f"phase 30 remat={remat!r}"
        launches[f"options_remat_{remat}"] = _held_launches(label, want)
        if ref is None:
            ref = got
            worst = 0.0
        else:
            worst = _equal_grads(label, got, ref)
        del got
        ms = _median_ms(run, reps=1, warmup=0)
        dev_ms = sum(device_ms(run, reps=1, warmup=0).values()) or None
        print(f"{label}: peak {peak / 2**30:.3f} GiB above the state, "
              f"{ms:.2f} ms by CUDA events, device {_ms(dev_ms)}")
        out[str(remat)] = {"loss": ref[0].item(), "peak_gib": peak / 2**30,
                           "ms": ms, "device_ms": dev_ms,
                           "max_abs_vs_false": worst}
    return out, launches, ref


def _noisy(cfg):
    """``cfg`` with the ViT's DropPath and dropout at phase 30's rates."""
    import dataclasses

    vision = dataclasses.replace(cfg.chat.vision,
                                 drop_path_rate=NOISE_DROP_PATH,
                                 dropout=NOISE_DROPOUT)
    return dataclasses.replace(cfg, chat=dataclasses.replace(
        cfg.chat, vision=vision))


@contextlib.contextmanager
def _recorded_masks(into):
    """Record every mask ``vit._bernoulli`` draws into ``into``, keyed by
    (key path, global tile index)."""
    from mjvideo_tpu_torch.models import vit

    real = vit._bernoulli

    def record(key, keep, shape, device):
        mask = real(key, keep, shape, device)
        for b in range(shape[0]):
            into[key.path, key.tile0 + b] = mask[b]
        return mask

    vit._bernoulli = record
    try:
        yield into
    finally:
        vit._bernoulli = real


def noise_phase(cfg, params, batch, dev, quiet_loss):
    """Phase 30 (b): DropPath and dropout at NOISE_DROP_PATH and
    NOISE_DROPOUT.  The gradient under ``remat=True`` bit-equal to the one
    under ``remat=False`` at the same step's key (the recompute drew the
    same masks); the next step's key another loss (other masks), and both
    other than the noise-free loss ``quiet_loss``; the tower sharded over a
    local 2-member group drawing the whole tower's masks, tile by global
    tile, and its embeds within KERNEL_REL_TOL of the whole tower's."""
    from dataclasses import replace

    import torch

    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.models.internvl import extract_feature
    from mjvideo_tpu_torch.models.vit import NoiseKey
    from mjvideo_tpu_torch.parallel.sequence import SequenceGroup
    from mjvideo_tpu_torch.train.trainer import place_batch

    ncfg = _noisy(cfg)
    paths = _options_paths(params)
    base = NoiseKey(0)
    got = {}
    launches = {}
    for remat, step in ((False, 0), (True, 0), (True, 1)):
        kernels.reset_launch_counts()
        got[remat, step] = _options_grad(
            ncfg, replace(train_config("unused"), remat=remat), params,
            paths, batch, dev, base.fold_in(step))
        torch.cuda.synchronize()
        want = {k: 2 * n for k, n in _grad_launches(
            cfg, forwards=2 if remat else 1).items()}
        launches[f"options_noise_{remat}_{step}"] = _held_launches(
            f"phase 30 noise remat={remat} step {step}", want)
    worst = _equal_grads("phase 30 noise: remat=True against remat=False",
                         got[True, 0], got[False, 0])
    losses = {"step 0": got[True, 0][0].item(),
              "step 1": got[True, 1][0].item(), "noise-free": quiet_loss}
    print(f"phase 30 noise: losses {losses}")
    if len(set(losses.values())) != 3:
        raise RuntimeError(f"phase 30 noise: the masks did not change the "
                           f"loss: {losses}")
    del got
    pix = place_batch(batch, dev, torch.bfloat16)["video_0_pixel_values"]
    pix = pix.reshape((-1,) + tuple(pix.shape[-3:]))
    key = base.fold_in(0, 0)
    whole, sharded = {}, {}
    with torch.no_grad():
        kernels.reset_launch_counts()
        with _recorded_masks(whole):
            ref = extract_feature(params["model"], ncfg.chat, pix,
                                  remat=False, vit_rng=key)
        with _recorded_masks(sharded):
            emb = extract_feature(
                params["model"], ncfg.chat, pix, remat=False, vit_rng=key,
                sp={"group": SequenceGroup.local(2), "kind": "ring"})
        torch.cuda.synchronize()
    L_vit = cfg.chat.vision.num_hidden_layers
    launches["options_noise_sharded"] = _held_launches(
        "phase 30 noise: the whole and the sharded tower",
        _with_prepass({"vit_attention": 3 * L_vit}))
    same = (whole.keys() == sharded.keys() and all(
        torch.equal(m, sharded[k]) for k, m in whole.items()))
    err, rel = _rel_err(emb, ref)
    print(f"phase 30 noise: {pix.shape[0]} tiles, {len(whole)} masks, the "
          f"sharded tower's the same: {same}; its embeds against the whole "
          f"tower's {rel:.3e} of max|whole| (bound {KERNEL_REL_TOL})")
    if not same or not rel <= KERNEL_REL_TOL:
        raise RuntimeError(f"phase 30 noise: sharded tower masks equal "
                           f"{same}, embeds {rel}")
    return {"losses": losses, "max_abs_remat": worst, "masks": len(whole),
            "sharded_rel_err": rel}, launches


OPTIMIZERS = (("adamw", {}),
              ("adamw_bf16_mu", {"adam_mu_dtype": "bfloat16"}),
              ("adafactor", {"optimizer": "adafactor"}))


def _train_steps(cfg, params, tc, batches):
    """OPT_STEPS micro-steps of a ``Trainer``: (losses, the trainable
    tensors' update, the optimizer state's bytes without the accumulation
    buffer, frozen tensors all unchanged)."""
    import torch

    from mjvideo_tpu_torch.train.trainer import (
        Trainer,
        flatten_state,
        state_bytes,
    )

    before = {p: t.clone() for p, t in flatten_state(params).items()}
    tr = Trainer(cfg, params, tc)
    losses = [tr.train([b])["loss"] for b in batches[:OPT_STEPS]]
    torch.cuda.synchronize()
    after = flatten_state(tr.params)
    trainable = set(tr.optimizer.paths)
    frozen = all(torch.equal(t, before[p]) for p, t in after.items()
                 if p not in trainable)
    update = [after[p].float() - before[p].float()
              for p in tr.optimizer.paths]
    moments = {k: v for k, v in tr.opt_state.items() if k != "acc"}
    return losses, update, state_bytes(moments), frozen


def optimizers_phase(cfg, batches, dev, generator):
    """Phase 30 (c): OPT_STEPS ``Trainer`` micro-steps (phase 5's config:
    stage 3, accumulation 2, remat) with AdamW, AdamW with bf16 mu and
    Adafactor, on fresh bf16 weights from the seed through the kernels and
    on their fp32 copy through the plain path: exact launches on the kernel path, every
    loss finite and within OPT_LOSS_REL_TOL of plain's at its step, frozen
    tensors unchanged, the steps' update of the trainable tensors at
    cosine OPT_UPDATE_COS or more with plain's (bf16 weights round each
    update of lr = 1e-3 on weights of 0.02 to a few ulps), and each
    optimizer state's bytes (moments or factored statistics, without the
    accumulation buffer)."""
    import tempfile as tf
    from dataclasses import replace

    import torch

    from mjvideo_tpu_torch import init_reward_params, kernels, map_state

    L_vit = cfg.chat.vision.num_hidden_layers
    L_llm = cfg.chat.llm.num_hidden_layers
    per_video = _with_prepass({
        "vit_attention": L_vit, "decoder_attention": 2 * L_llm,
        "decoder_attention_lse": 2 * L_llm,
        "decoder_attention_bwd_dkdv": L_llm,
        "decoder_attention_bwd_dq": L_llm})
    want = {k: 2 * OPT_STEPS * n for k, n in per_video.items()}
    out, launches = {}, {}
    for name, kw in OPTIMIZERS:
        with tf.TemporaryDirectory() as d:
            tc = replace(train_config(d), **kw)
            params = init_reward_params(cfg, generator=generator(),
                                        device=dev, dtype=torch.bfloat16)
            p32 = map_state(lambda t: t.float(), params)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            k_loss, k_upd, k_bytes, k_frozen = _train_steps(cfg, params, tc,
                                                            batches)
            k_s = time.perf_counter() - t0
            launches[f"options_{name}"] = _held_launches(
                f"phase 30 {name}", want)
            del params
            p_loss, p_upd, p_bytes, p_frozen = _train_steps(
                cfg, p32, replace(tc, attn_impl="plain"), batches)
            del p32
        rel, cos, norm = _agreement(k_upd, p_upd)
        del k_upd, p_upd
        torch.cuda.empty_cache()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
        print(f"phase 30 {name}: losses kernels "
              f"{[round(x, 6) for x in k_loss]}, fp32 plain {[round(x, 6) for x in p_loss]} (largest "
              f"relative difference {loss_rel:.3e}, bound {OPT_LOSS_REL_TOL})"
              f"; the update against plain's: relative L2 {rel:.4e}, cosine "
              f"{cos:.6f} (bound {OPT_UPDATE_COS}), |update| plain {norm:.4e};"
              f" state {k_bytes / 2**30:.3f} GiB (bf16 weights), "
              f"{p_bytes / 2**30:.3f} GiB (fp32 weights); {OPT_STEPS} "
              f"micro-steps in {k_s:.1f} s (the first includes warm-up)")
        if not (all(math.isfinite(x) for x in k_loss) and k_frozen
                and p_frozen and loss_rel <= OPT_LOSS_REL_TOL
                and cos >= OPT_UPDATE_COS):
            raise RuntimeError(
                f"phase 30 {name}: losses {k_loss} against {p_loss}, frozen "
                f"unchanged {k_frozen}/{p_frozen}, update cosine {cos}")
        out[name] = {"losses": k_loss, "plain_losses": p_loss,
                     "loss_rel": loss_rel, "update_rel_l2": rel,
                     "update_cos": cos, "state_bytes": k_bytes,
                     "plain_state_bytes": p_bytes, "steps_s": k_s}
    return out, launches


def cut_depth(cfg, vit_layers, llm_layers):
    """``cfg`` at full width with its ViT and decoder cut in depth."""
    import dataclasses

    chat = dataclasses.replace(
        cfg.chat,
        vision=dataclasses.replace(cfg.chat.vision,
                                   num_hidden_layers=vit_layers),
        llm=dataclasses.replace(cfg.chat.llm, num_hidden_layers=llm_layers))
    return dataclasses.replace(cfg, chat=chat)


def _same_state(a, b):
    import torch

    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k])
                                            for k in a)
    return a == b


def async_checkpoint_phase(cfg, batches, dev, generator):
    """Phase 30 (d): ASYNC_STEPS micro-steps saving each
    (``checkpoint_every=1``, ASYNC_KEEP kept) of a stage-3 AdamW
    ``Trainer`` at full width, ASYNC_DEPTH deep, blocking and with
    ``async_checkpoint=True`` from the same weights: after ``train()``
    returns, each kept file of the async run reloads bit-equal to the
    blocking run's of that step, and no temporary file is left; the time a
    micro-step, save included, of each."""
    import tempfile as tf
    from dataclasses import replace

    import torch

    from mjvideo_tpu_torch import init_reward_params
    from mjvideo_tpu_torch.train.trainer import Trainer

    small = cut_depth(cfg, *ASYNC_DEPTH)
    out = {}
    with tf.TemporaryDirectory() as d:
        for mode in ("blocking", "async"):
            tc = replace(train_config(os.path.join(d, mode)),
                         gradient_accumulation_steps=1, checkpoint_every=1,
                         keep_checkpoints=ASYNC_KEEP,
                         async_checkpoint=mode == "async")
            params = init_reward_params(small, generator=generator(),
                                        device=dev, dtype=torch.bfloat16)
            tr = Trainer(small, params, tc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train(batches[:ASYNC_STEPS])
            torch.cuda.synchronize()
            out[f"{mode}_step_ms"] = ((time.perf_counter() - t0) * 1e3
                                      / ASYNC_STEPS)
            del tr, params
        names = {m: sorted(os.listdir(os.path.join(d, m)))
                 for m in ("blocking", "async")}
        kept = [n for n in names["async"] if n.endswith(".pt")]
        size = os.path.getsize(os.path.join(d, "async", kept[-1]))
        same = names["async"] == names["blocking"] and len(kept) == \
            ASYNC_KEEP and all(_same_state(
                torch.load(os.path.join(d, "blocking", n), map_location=dev),
                torch.load(os.path.join(d, "async", n), map_location=dev))
                for n in kept)
    print(f"phase 30 async checkpoints: {ASYNC_STEPS} micro-steps saving "
          f"each ({size / 2**30:.3f} GiB a checkpoint, depth {ASYNC_DEPTH}): "
          f"{out['blocking_step_ms']:.1f} ms a step blocking, "
          f"{out['async_step_ms']:.1f} ms async; files {names['async']}; "
          f"each reloads bit-equal to the blocking save: {same}")
    if not same:
        raise RuntimeError(f"phase 30 async checkpoints: files {names}, "
                           f"equal {same}")
    out.update(files=kept, checkpoint_bytes=size)
    return out


def training_options_phase(dev, generator):
    """Phase 30: the training options at the 2B widths, stage 3, on phase
    5's weights (a fresh generator at SEED) and micro-batches.  Returns
    the readings and the launch counts by path."""
    import gc

    import torch

    from mjvideo_tpu_torch import init_reward_params

    t0 = time.perf_counter()
    cfg, batches = train_data()
    params = init_reward_params(cfg, generator=generator(), device=dev,
                                dtype=torch.bfloat16)
    out, launches = {}, {}
    out["remat"], more, ref = remat_policies(cfg, params, batches[0], dev)
    launches.update(more)
    out["noise"], more = noise_phase(cfg, params, batches[0], dev,
                                     ref[0].item())
    launches.update(more)
    del params, ref
    gc.collect()
    torch.cuda.empty_cache()
    out["optimizers"], more = optimizers_phase(cfg, batches, dev, generator)
    launches.update(more)
    out["async_checkpoint"] = async_checkpoint_phase(cfg, batches, dev,
                                                     generator)
    out["command_s"] = time.perf_counter() - t0
    print(f"phase 30 command time {out['command_s']:.1f} s")
    return out, launches


def _layer_changed(after, before):
    """Per stacked layer (the leading axis), whether any element moved."""
    return (after != before).flatten(1).any(1)


def _micro_step_times(trainer, batches, label):
    """LORA_TIMED_STEPS micro-steps timed on the host clock (``time_training``)
    and the device time of a micro-step: ``torch.profiler``'s kernels over
    two more, one that accumulates and one that also steps, halved."""
    medians = time_training(trainer, batches, steps=LORA_TIMED_STEPS)
    calls = []

    def step():
        trainer.train([batches[len(calls) % len(batches)]])
        calls.append(1)

    dev_ms = sum(device_ms(step, reps=2, warmup=0).values())
    out = {**medians, "device_ms": (dev_ms or None)}
    print(f"{label}: micro-step device time {_ms(out['device_ms'])} (the "
          f"mean of one that accumulates and one that steps)")
    return out


def _lora_counts(trainer):
    """(adapter parameters, trainable parameters, optimizer state bytes
    without the accumulation buffer, with it)."""
    from mjvideo_tpu_torch.train.trainer import flatten_state, state_bytes

    flat = flatten_state(trainer.params)
    paths = trainer.optimizer.paths
    adapters = sum(flat[p].numel() for p in paths
                   if p.endswith(("/.a", "/.b")))
    moments = {k: v for k, v in trainer.opt_state.items() if k != "acc"}
    return (adapters, sum(flat[p].numel() for p in paths),
            state_bytes(moments), state_bytes(trainer.opt_state))


def _snapshot(trainer):
    """A copy on the card of every tensor of the trainer's params and
    optimizer state by path, with its stride, and the step."""
    import torch

    from mjvideo_tpu_torch.train.trainer import flatten_state

    out = {}
    for name, tree in (("params", trainer.params),
                       ("opt", trainer.opt_state)):
        for p, t in flatten_state(tree).items():
            out[f"{name}/{p}"] = (t.detach().clone() if torch.is_tensor(t)
                                  else t)
    return out, trainer.step


def _same_snapshot(got, want):
    """(every entry bit-equal with its dtype and stride, the first path
    that differs)."""
    import torch

    if got.keys() != want.keys():
        return False, sorted(set(got) ^ set(want))[:3]
    for p, t in want.items():
        g = got[p]
        if torch.is_tensor(t):
            if not (torch.is_tensor(g) and g.dtype == t.dtype
                    and g.stride() == t.stride() and torch.equal(g, t)):
                return False, p
        elif g != t:
            return False, p
    return True, None


def lora_training_phase(cfg, batches, dev, generator, d):
    """Phase 31 (a), (b), (f) and the timing against full stage 3: the
    2B's bf16 weights wrapped at LORA_RANK, its forward bit-equal to the
    unwrapped one, 4 micro-steps (phase 5's checks and launches), every
    layer's ``b`` moved and every layer's ``a`` by the second optimizer
    step, the merged state's score against the LoRA state's.  Returns
    (readings, launches, the LoRA trainer, the unwrapped state, whose
    tensors the LoRA state shares)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from mjvideo_tpu_torch import ByteTokenizer, RewardScorer, kernels
    from mjvideo_tpu_torch import init_reward_params
    from mjvideo_tpu_torch.models.reward import reward_forward
    from mjvideo_tpu_torch.ops.lora import LoraKernel, merge_lora
    from mjvideo_tpu_torch.ops.quant import map_with_path
    from mjvideo_tpu_torch.train.trainer import Trainer, place_batch

    out, launches = {}, {}
    params = init_reward_params(cfg, generator=generator(), device=dev,
                                dtype=torch.bfloat16)
    placed = place_batch(batches[0], dev, torch.bfloat16)

    def forward(state):
        with torch.no_grad():
            res = []
            for v in (0, 1):
                pix = placed[f"video_{v}_pixel_values"]
                res.append(reward_forward(
                    state, cfg, pix.reshape((-1,) + tuple(pix.shape[-3:])),
                    placed[f"video_{v}_input_ids"],
                    placed[f"video_{v}_attention_mask"],
                    placed[f"video_{v}_gating_pos"]))
            return res

    base_out = forward(params)
    tc = replace(train_config(os.path.join(d, "lora")), lora_rank=LORA_RANK)
    tr = Trainer(cfg, params, tc)
    nodes = {}
    map_with_path(lambda p, x: nodes.__setitem__(p, x)
                  if isinstance(x, LoraKernel) else None, tr.params)
    same = all(torch.equal(a, b) for o, r in zip(forward(tr.params), base_out)
               for a, b in zip(o, r))
    adapters, trainable, moments, with_acc = _lora_counts(tr)
    print(f"phase 31 (a): {len(nodes)} LoRA nodes of rank {LORA_RANK}, the "
          f"wrapped forward bit-equal to the unwrapped one: {same}; "
          f"{adapters:,} adapter parameters, {trainable:,} trainable; "
          f"optimizer state {moments / 2**30:.4f} GiB "
          f"({with_acc / 2**30:.4f} GiB with the accumulation buffer)")
    if not same or len(nodes) != 7:
        raise RuntimeError(f"phase 31 (a): {len(nodes)} nodes, forward "
                           f"bit-equal {same}")
    out["a"] = {"nodes": len(nodes), "bit_equal": same,
                "adapter_params": adapters, "trainable_params": trainable,
                "state_bytes": moments, "state_bytes_with_acc": with_acc}

    before = {p: (n.a.clone(), n.b.clone()) for p, n in nodes.items()}
    t0 = time.perf_counter()
    launches["lora_training"], peak = check_training(
        tr, batches, dev, label="phase 31 (b) LoRA training")
    moved = {p: (bool(_layer_changed(n.a, before[p][0]).all()),
                 bool(_layer_changed(n.b, before[p][1]).all()))
             for p, n in nodes.items()}
    print(f"phase 31 (b): every layer's a and b moved (a, b) {moved}; "
          f"{len(batches)} micro-steps in {time.perf_counter() - t0:.1f} s, "
          f"peak {peak / 2**30:.2f} GiB")
    if not all(a and b for a, b in moved.values()):
        raise RuntimeError(f"phase 31 (b): adapters that did not move "
                           f"{moved}")
    del before
    out["b"] = {"peak_gib": peak / 2**30, "moved": moved}

    # (f) The merged state scores as the LoRA state does.
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    lora_scorer = RewardScorer(cfg, tr.params, tok, dtype=torch.bfloat16,
                               gating_pattern=tok.gating_pattern())
    request = make_requests(lora_scorer, np.random.default_rng(SEED))[0]
    kernels.reset_launch_counts()
    s_lora = lora_scorer.score_batch(*request).score.float().item()
    torch.cuda.synchronize()
    launches["lora_serving"] = _held_launches(
        "phase 31 (f) LoRA scoring", _with_prepass({
            "vit_attention": cfg.chat.vision.num_hidden_layers,
            "decoder_attention": cfg.chat.llm.num_hidden_layers}))
    merged = RewardScorer(cfg, merge_lora(tr.params), tok,
                          dtype=torch.bfloat16,
                          gating_pattern=tok.gating_pattern())
    s_merged = merged.score_batch(*request).score.float().item()
    delta = abs(s_lora - s_merged)
    print(f"phase 31 (f): the LoRA state's score {s_lora:.6f}, the merged "
          f"state's {s_merged:.6f} (|delta| {delta:.3e}, bound {SCORE_TOL})")
    if not delta <= SCORE_TOL:
        raise RuntimeError(f"phase 31 (f): merged score delta {delta}")
    out["f"] = {"lora_score": s_lora, "merged_score": s_merged,
                "delta": delta}
    del merged, lora_scorer
    torch.cuda.empty_cache()

    return out, launches, tr, params


def lora_gradient_phase(tr, batch, dev):
    """Phase 31 (c): every ``b`` drawn seeded and nonzero (N(0,
    LORA_B_STD^2), its own generator), then the trainable gradient (the
    adapters and the heads) of one micro-batch with the bf16 kernels
    against fp32 plain (``gradient_split``: S1's split printed, the bars
    held with F5's rule), and ``product_f32_check`` at the first layer's
    base, ``a`` and ``b``."""
    import torch

    from mjvideo_tpu_torch.ops.lora import LoraKernel
    from mjvideo_tpu_torch.ops.quant import map_with_path

    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    nodes = []

    def draw(_, x):
        if isinstance(x, LoraKernel):
            nodes.append(x)
            with torch.no_grad():
                x.b.copy_(LORA_B_STD * torch.randn(
                    x.b.shape, generator=g, device=dev))
        return x

    map_with_path(draw, tr.params)
    out, _ = gradient_split(tr.cfg, tr.tc, tr.params, tr.optimizer.paths,
                            batch, dev, "phase 31 (c) LoRA")
    # bf16 plain's floor above runs the adapters through the same
    # product_f32 as the kernels: hold that product apart, against fp32.
    first = nodes[0]
    out["product_f32"] = product_f32_check(
        dev, g, (first.w[0], first.a[0], first.b[0]))
    return out



def product_f32_check(dev, g, weights, rows=1024):
    """``ops.matmul.product_f32`` on bf16 operands on the card (the
    autograd Function around ``torch.mm(out_dtype=float32)``) against
    fp32 autograd of the same values upcast: for each bf16 weight of
    ``weights`` (a LoRA node's base, ``a`` and ``b`` at one layer), the
    product of ``rows`` seeded bf16 rows and its gradients with respect to
    both inputs under a seeded fp32 cotangent.  The output within
    PRODUCT_F32_FWD_REL, each input gradient within PRODUCT_F32_BWD_REL
    (relative L2), both with the cosine above 1 - the bar.  Raises on a
    miss; returns the readings."""
    import torch

    from mjvideo_tpu_torch.ops.matmul import product_f32

    out = {}
    for w in weights:
        w = w.detach().to(torch.bfloat16)
        K, N = w.shape
        x = torch.randn((rows, K), generator=g, device=dev).to(torch.bfloat16)
        ct = torch.randn((rows, N), generator=g, device=dev)
        xb, wb = x.requires_grad_(), w.clone().requires_grad_()
        y = product_f32(xb, wb)
        y.backward(ct)
        x32 = x.detach().float().requires_grad_()
        w32 = w.float().requires_grad_()
        y32 = x32 @ w32
        y32.backward(ct)
        read = {}
        for name, got, ref, bar in (
                ("y", y.detach(), y32.detach(), PRODUCT_F32_FWD_REL),
                ("gx", xb.grad, x32.grad, PRODUCT_F32_BWD_REL),
                ("gw", wb.grad, w32.grad, PRODUCT_F32_BWD_REL)):
            ok_dtype = got.dtype == (torch.float32 if name == "y"
                                     else torch.bfloat16)
            rel, cos = _compare_grads(got, ref)
            read[name] = {"rel_l2": rel, "cos": cos}
            if not (ok_dtype and rel <= bar and cos >= 1 - bar):
                raise RuntimeError(f"product_f32 ({rows}, {K}) @ ({K}, {N})"
                                   f" {name}: dtype {got.dtype}, relative L2"
                                   f" {rel}, cosine {cos} (bar {bar})")
        out[f"{K}x{N}"] = read
        print(f"phase 31 (c) product_f32 ({rows}, {K}) @ ({K}, {N}) against "
              f"fp32 autograd: output relative L2 {read['y']['rel_l2']:.3e} "
              f"(bar {PRODUCT_F32_FWD_REL:.3e}), gx "
              f"{read['gx']['rel_l2']:.3e}, gw {read['gw']['rel_l2']:.3e} "
              f"(bar {PRODUCT_F32_BWD_REL:.3e})")
    return out


def qlora_phase(cfg, batches, dev, generator, d):
    """Phase 31 (d) and (e): for each of LORA_QUANT_MODES, fresh bf16
    weights quantized on the card, wrapped at LORA_RANK: the loss on the
    kernel path against the same tree in fp32 plain (within
    OPT_LOSS_REL_TOL), two micro-steps under phase 5's checks (the
    quantized fields bit-identical, no K5 under autograd), the decoder's
    frozen bases' bytes; under ``int4-wo`` then a third micro-step, an
    async save, a fourth (in place, while the save is written), and a
    fresh trainer's ``resume_latest``: every tensor, dtype and stride of
    the saved step bit-equal, the node types kept, and the fourth step
    again bit-equal."""
    from dataclasses import replace

    import torch

    from mjvideo_tpu_torch import init_reward_params
    from mjvideo_tpu_torch.ops.quant import quantize_params_mode
    from mjvideo_tpu_torch.train.trainer import (
        Trainer,
        make_loss_fn,
        place_batch,
    )
    from mjvideo_tpu_torch.utils.checkpoint import wait_for_saves

    def quantized(mode):
        bf16 = init_reward_params(cfg, generator=generator(), device=dev,
                                  dtype=torch.bfloat16)
        q = quantize_params_mode(bf16, mode)
        bytes_ = (_target_bytes(bf16), _target_bytes(q))
        del bf16
        torch.cuda.empty_cache()
        return q, bytes_

    out, launches = {}, {}
    for mode in LORA_QUANT_MODES:
        tc = replace(train_config(os.path.join(d, mode)),
                     lora_rank=LORA_RANK, async_checkpoint=True,
                     keep_checkpoints=1)
        q, (bf16_bytes, base_bytes) = quantized(mode)
        tr = Trainer(cfg, q, tc)
        with torch.no_grad():
            loss_k = make_loss_fn(cfg, tc)(
                tr.params, place_batch(batches[0], dev, torch.bfloat16))
            loss_p = make_loss_fn(cfg, replace(tc, attn_impl="plain"))(
                _float_plain(tr.params),
                place_batch(batches[0], dev, torch.float32))
        rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        print(f"phase 31 (d) QLoRA {mode}: loss bf16 kernels "
              f"{loss_k.item():.6f}, the same tree in fp32 plain "
              f"{loss_p.item():.6f} (relative {rel:.3e}, bound "
              f"{OPT_LOSS_REL_TOL}); the decoder's frozen bases "
              f"{base_bytes / 2**30:.3f} GiB against "
              f"{bf16_bytes / 2**30:.3f} GiB in bf16")
        if not rel <= OPT_LOSS_REL_TOL:
            raise RuntimeError(f"phase 31 (d) {mode}: loss {loss_k} against "
                               f"fp32 plain {loss_p}")
        launches[f"qlora_{mode}"], peak = check_training(
            tr, batches[:2], dev, label=f"phase 31 (d) QLoRA {mode}")
        out[mode] = {"loss_kernels": loss_k.item(),
                     "loss_fp32_plain": loss_p.item(), "loss_rel": rel,
                     "base_gib": base_bytes / 2**30,
                     "bf16_base_gib": bf16_bytes / 2**30,
                     "peak_gib": peak / 2**30}
        if mode == "int4-wo":
            out["e"] = _async_resume(cfg, tr, tc, batches, dev,
                                     lambda: quantized(mode)[0])
        del tr, q
        wait_for_saves()
        torch.cuda.empty_cache()
    return out, launches


def _target_bytes(state):
    """Bytes of the decoder kernels LoRA wraps (DEFAULT_TARGETS), before
    wrapping: plain tensors or every field of a quantized node."""
    import re

    from mjvideo_tpu_torch.ops.lora import DEFAULT_TARGETS
    from mjvideo_tpu_torch.train.trainer import flatten_state

    pats = [re.compile(p + "(/|$)") for p in
            (t.rstrip("$") for t in DEFAULT_TARGETS)]
    return sum(t.numel() * t.element_size()
               for p, t in flatten_state(state).items()
               if any(r.search(p) for r in pats))


def _async_resume(cfg, tr, tc, batches, dev, fresh):
    """Phase 31 (e) on the int4 trainer after its two micro-steps."""
    import torch

    from mjvideo_tpu_torch.ops.lora import LoraKernel
    from mjvideo_tpu_torch.ops.quant import is_k_major, map_with_path
    from mjvideo_tpu_torch.train.trainer import Trainer, flatten_state
    from mjvideo_tpu_torch.utils.checkpoint import wait_for_saves

    tr.train([batches[2]])  # mid-window: the accumulation buffer holds it
    ref, step = _snapshot(tr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = tr.save()
    save_ms = (time.perf_counter() - t0) * 1e3
    tr.train([batches[3]])  # updates the tensors in place during the write
    after = {p: t.detach().clone() for p, t in
             flatten_state(tr.params).items()}
    t0 = time.perf_counter()
    wait_for_saves()
    wait_ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(path)
    fresh_state = fresh()
    tr2 = Trainer(cfg, fresh_state, tc)
    got_path = tr2.resume_latest()
    got, got_step = _snapshot(tr2)
    same, first = _same_snapshot(got, ref)
    kinds = set()
    map_with_path(lambda p, x: kinds.add((type(x).__name__,
                                          type(x.w).__name__,
                                          is_k_major(x.w.packed[0])))
                  if isinstance(x, LoraKernel) else None, tr2.params)
    del got, ref
    tr2.train([batches[3]])
    again = all(torch.equal(t, after[p]) for p, t in
                flatten_state(tr2.params).items())
    print(f"phase 31 (e): async save of the int4 QLoRA run at step {step} "
          f"({size / 2**30:.3f} GiB; the call returned in {save_ms:.1f} ms, "
          f"the write ended {wait_ms:.1f} ms after the next micro-step); "
          f"resumed {got_path == path} at step {got_step}: every tensor, "
          f"dtype and stride bit-equal {same} (first difference {first}), "
          f"nodes {sorted(kinds)}; the next micro-step bit-equal to the "
          f"unbroken run's {again}")
    if not (got_path == path and got_step == step and same and again
            and kinds == {("LoraKernel", "Q4Kernel", True)}):
        raise RuntimeError(f"phase 31 (e): resumed {got_path}, step "
                           f"{got_step}/{step}, equal {same} ({first}), "
                           f"nodes {kinds}, next step equal {again}")
    del tr2, fresh_state, after
    return {"checkpoint_bytes": size, "save_call_ms": save_ms,
            "wait_ms": wait_ms, "bit_equal": same, "next_step_equal": again}


def lora_phase(dev, generator, timing=False):
    """Phase 31: LoRA and QLoRA training at the 2B widths, stage 3, on
    phase 5's weights (a fresh generator at SEED) and micro-batches;
    ``timing``: also a LoRA micro-step timed against a full stage-3 one on
    the same weights (``tools/phase31_torch.py``).  Returns the readings
    and the launch counts by path."""
    import gc
    import tempfile as tf

    import torch

    from mjvideo_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg, batches = train_data()
    out = {}
    with tf.TemporaryDirectory() as d:
        out["train"], launches, tr, params = lora_training_phase(
            cfg, batches, dev, generator, d)
        if timing:
            out["time_lora"] = _micro_step_times(tr, batches,
                                                 "phase 31 LoRA")
        out["c"] = lora_gradient_phase(tr, batches[0], dev)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        if timing:
            full = Trainer(cfg, params, train_config(os.path.join(d,
                                                                  "full")))
            full.train([batches[0]])  # warm-up
            out["time_full"] = _micro_step_times(full, batches,
                                                 "phase 31 full stage 3")
            del full
            ratio = {k: out["time_lora"][k] / out["time_full"][k]
                     for k in ("accumulate_ms", "optimizer_ms", "device_ms")
                     if out["time_lora"][k] and out["time_full"][k]}
            print(f"phase 31: a LoRA micro-step against a full stage-3 one "
                  f"{ratio}")
            out["time_ratio"] = ratio
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["qlora"], more = qlora_phase(cfg, batches, dev, generator, d)
        launches.update(more)
    out["command_s"] = time.perf_counter() - t0
    print(f"phase 31 command time {out['command_s']:.1f} s")
    return out, launches


def _trace_kernels(path):
    """{kind: count} of the card's kernels in a Chrome trace written by
    ``utils.profiling.trace``: K1 (the attention template at D = 64), K2
    (at D = 128) and the pre-pass's partial pass; and the names of the
    host regions."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {"K1": 0, "K2": 0, "pre-pass": 0}
    regions = set()
    for e in events:
        name = e.get("name") or ""
        if e.get("cat") == "kernel":
            if "attention_kernel" in name and "Config<64" in name:
                counts["K1"] += 1
            elif "attention_kernel" in name and "Config<128" in name:
                counts["K2"] += 1
            elif "key_norm_partial" in name:
                counts["pre-pass"] += 1
        elif name.startswith("score "):
            regions.add(name)
    return counts, regions


def serving_example_phase(scorer, ckpt_dir, dev):
    """Phase 32: ``examples/serve.py`` on phase 22's checkpoint directory
    (phase 23's decode stand-in, four decode workers), over SERVE_CLIPS
    seeded clips, then under ``--trace-dir`` over SERVE_TRACED others: the
    JSONL scores of both runs bit-equal to ``score_video`` of phase 4's
    state through a scorer built as the example builds it, exact launches
    (24 K1 and 24 K2 a clip, each after its pre-pass), the trace naming K1
    and K2 as often as its clips launched them; the first run's
    ``Throughput`` clips/s beside its command time.  Returns the readings
    and the launch counts of both runs."""
    import tempfile as tf

    import numpy as np
    import torch

    from mjvideo_tpu_torch import RewardScorer
    from mjvideo_tpu_torch.data.prompts import load_tokenizer
    from mjvideo_tpu_torch.examples import serve
    from mjvideo_tpu_torch.utils.profiling import TRACE_FILE

    cfg = scorer.cfg
    L_vit = cfg.chat.vision.num_hidden_layers
    L_llm = cfg.chat.llm.num_hidden_layers
    tok, _ = load_tokenizer(None)
    ref = RewardScorer(cfg, scorer.params, tok, dtype=torch.bfloat16,
                       gating_pattern=tok.gating_pattern(cfg.chat.template))

    def serve_run(d, stem, clips, trace_dir=None):
        videos = os.path.join(d, stem)
        os.makedirs(videos)
        names = [f"{stem}{i}.mp4" for i in range(clips)]
        for n in names:
            open(os.path.join(videos, n), "wb").close()
        out = os.path.join(d, f"{stem}.jsonl")
        argv = ["--model-path", ckpt_dir, "--videos", videos,
                "--byte-tokenizer", "--num-segments", str(FRAMES),
                "--workers", "4", "--out", out]
        if trace_dir:
            argv += ["--trace-dir", trace_dir]
        summary, _, secs, _, got = _run_main(serve.main, argv)
        launches = _hold(f"phase 32 serving example ({stem})", got,
                         _with_prepass({"vit_attention": clips * L_vit,
                                        "decoder_attention": clips * L_llm}))
        with open(out) as f:
            rows = [json.loads(line) for line in f]
        want = [ref.score_video(os.path.join(videos, r["video"]),
                                "a generated video", num_segments=FRAMES)
                for r in rows]
        same = [r["video"] for r in rows] == names and all(
            np.float32(r["score"]) == w["score"] and np.array_equal(
                np.asarray(r["aspect_scores"], np.float32),
                w["aspect_scores"])
            for r, w in zip(rows, want))
        return summary, secs, launches, same

    with tf.TemporaryDirectory() as d, seeded_video_source():
        summary, secs, launches, same = serve_run(d, "serve", SERVE_CLIPS)
        trace_dir = os.path.join(d, "trace")
        _, traced_s, traced_launches, traced_same = serve_run(
            d, "traced", SERVE_TRACED, trace_dir)
        traced, regions = _trace_kernels(os.path.join(trace_dir,
                                                      TRACE_FILE))
    traced_want = {"K1": SERVE_TRACED * L_vit, "K2": SERVE_TRACED * L_llm,
                   "pre-pass": SERVE_TRACED * (L_vit + L_llm)}
    print(f"phase 32 serving example: {summary['clips']} clips, "
          f"{summary['clips_per_s']:.2f} clips/s by Throughput (smoothed "
          f"{summary['rate']:.2f}), {secs:.1f} s of command time (the 2B "
          f"load included); scores bit-equal to score_video {same}; "
          f"{SERVE_TRACED} more traced in {traced_s:.1f} s, their scores "
          f"bit-equal {traced_same}, the trace's kernels {traced} (want "
          f"{traced_want}), regions {sorted(regions)}")
    if not (same and traced_same and traced == traced_want
            and len(regions) == SERVE_TRACED):
        raise RuntimeError(f"phase 32: scores equal {same} and "
                           f"{traced_same}, traced {traced}, regions "
                           f"{regions}")
    launches = {k: n + traced_launches[k] for k, n in launches.items()}
    return {**summary, "command_s": secs, "traced_command_s": traced_s,
            "traced": traced}, launches


# Phase 33: the (data, model) mesh (``parallel/mesh.py``) on one card, every
# shard in this process (``Mesh.local``).  (a) and (b) score phase 4's pair
# request on phase 4's state; (c) trains phase 5's weights on batches of
# two of phase 5's pairs; (d) is the dry run.
MESH_SCORING = ((2, 1), (1, 2), (2, 2))
MESH_QUANT_MODES = ("int8-wo", "int4-wo")
# K5 at the 2B decoder's projections cut over 2 model ranks, (K, N): wq
# (and the ViT's fc2) by N, wo by K, w1/w3 by N, w2 by K; M = 2 rows.
MESH_W4_SHAPES = ((2048, 1024), (1024, 2048), (2048, 4096), (4096, 2048))
MESH_W4_ROWS = 2
MESH_TRAIN_PAIRS = 8   # phase 5's draw, merged two pairs a batch
MESH_TP = 2


def _merge_pairs(a, b, pad_id):
    """One batch of the two one-pair batches ``a`` and ``b``, each video's
    prompts padded to the longer (pad ids, mask 0): the rows of each pair
    keep what they held."""
    import numpy as np

    out = {}
    for k in a:
        x, y = a[k], b[k]
        if k.endswith(("input_ids", "attention_mask")):
            T = max(x.shape[1], y.shape[1])
            value = pad_id if k.endswith("input_ids") else 0
            x, y = (np.pad(t, ((0, 0), (0, T - t.shape[1])),
                           constant_values=value) for t in (x, y))
        out[k] = np.concatenate([x, y])
    return out


def mesh_train_data():
    """The 2B config rebased on the ``ByteTokenizer`` and phase 5's first
    MESH_TRAIN_PAIRS pairs (the same seeded draw) merged two a batch."""
    import numpy as np

    from mjvideo_tpu_torch import ByteTokenizer, mjvideo_2b_config
    from mjvideo_tpu_torch.data.prompts import rebase_img_context_id

    cfg = mjvideo_2b_config()
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    cfg = rebase_img_context_id(cfg, tok)
    pairs = make_train_batches(cfg, tok, np.random.default_rng(SEED),
                               MESH_TRAIN_PAIRS)
    return cfg, [_merge_pairs(pairs[i], pairs[i + 1],
                              cfg.chat.llm.pad_token_id)
                 for i in range(0, len(pairs), 2)]


def check_mesh_kernels(randn, batches, cfg):
    """Each kernel at the head counts a model rank of 2 runs, against its
    twin (``check_vit_attention``, ``check_decoder_kernels``: 2**-7 of
    max|plain|): K1 at 8 of the ViT's 16 heads (a data shard's clip),
    K2 and its pre-pass at 8/4 of the decoder's 16/8 at serving's bucket
    (a clip a data shard, and the pair), K2 lse, K4a and K4b at training's
    prompts (a pair a data shard, one video a forward); then K5 at the
    decoder's projections cut over the model axis (``MESH_W4_SHAPES``).
    Returns the readings by (kernel, shape)."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import quant as q8
    from mjvideo_tpu_torch.ops import quant4 as q4

    out = {}
    vis, llm = cfg.chat.vision, cfg.chat.llm
    H, Hq, Hkv = (vis.num_attention_heads // MESH_TP,
                  llm.num_attention_heads // MESH_TP,
                  llm.num_key_value_heads // MESH_TP)
    shape = (FRAMES, K1_SHAPES[0][1], H, vis.head_dim)
    for name, r in check_vit_attention(randn, shape).items():
        out[name, shape] = r
    T = K2_SHAPES[-1][1]
    for B in (1, 2):
        # A data shard's clip (its prompt's keys live, as phase 3's single
        # clip), and the pair with a ragged mask.
        shape = (B, T, Hq, Hkv, llm.head_dim)
        live = single_clip_length() if B == 1 else None
        for name, r in check_decoder_kernels(randn, shape, ragged=B == 2,
                                             live=live).items():
            out[name, shape] = r
    lengths = sorted({b[f"video_{v}_input_ids"].shape[1]
                      for b in batches for v in (0, 1)})
    for T in lengths:
        shape = (1, T, Hq, Hkv, llm.head_dim)
        for name, r in check_decoder_kernels(randn, shape,
                                             ragged=False).items():
            out[name, shape] = r
    M = MESH_W4_ROWS
    for K, N in MESH_W4_SHAPES:
        k4 = q4.quantize_kernel_q4(randn(K, N).float() * 0.02,
                                   group_size=W4_GROUP)
        if not q8.is_k_major(k4.packed):
            raise RuntimeError("quantize_kernel_q4 gave strides "
                               f"{k4.packed.stride()}, not k-major")
        x = randn(M, K)
        out["K5", (M, K, N)] = _check_kernel(
            f"K5 w4_matmul at a model rank's {(M, K, N)} g {W4_GROUP}",
            lambda: kernels.w4_matmul(x, k4.packed, k4.scale),
            lambda: q4.w4_matmul_plain(x, k4.packed, k4.scale),
            extra=_again(lambda: kernels.w4_matmul(x, k4.packed, k4.scale)),
            work=(_nbytes(x, k4.packed, k4.scale) + 4 * M * N,
                  2 * M * K * N, BF16_OPS_PER_S))
    return out


def _first_layer_heads(scorer, request, dev):
    """The first ViT and decoder layer's attention on the pair request: the
    whole layer's K1 and K2 against each model rank's heads (of 2), given
    the same q, k and v (the unsharded product's head columns, laid out as
    a rank's product lays them out: the ViT's q|k|v of its heads, the
    decoder's query heads and their kv heads).  Raises unless every rank's
    output is bit-equal to the whole layer's on its heads."""
    import numpy as np
    import torch

    from mjvideo_tpu_torch.eval.scorer import round_to_bucket
    from mjvideo_tpu_torch.models import internvl as tivl
    from mjvideo_tpu_torch.models import vit as tvit
    from mjvideo_tpu_torch.ops.attention import multi_head_attention
    from mjvideo_tpu_torch.ops.matmul import dot
    from mjvideo_tpu_torch.ops.norms import rms_norm
    from mjvideo_tpu_torch.ops.rope import apply_rope, rope_tables
    from mjvideo_tpu_torch.utils.bridge import map_state

    pix, ids_list, _ = request
    cfg, p = scorer.cfg, scorer.params["model"]
    vis, llm = cfg.chat.vision, cfg.chat.llm
    m = MESH_TP
    out = {}
    with torch.inference_mode():
        x = torch.as_tensor(pix).to(dev, scorer.dtype)
        h = tvit.embeddings(p["vision_model"]["embeddings"], vis, x)
        layer = map_state(lambda a: a[0], p["vision_model"]["layers"])
        h = tvit._norm(vis, layer["norm1"], h)
        qkv = dot(h, layer["attn"]["qkv"]["kernel"])
        qkv = qkv + layer["attn"]["qkv"]["bias"]
        B, S, C3 = qkv.shape
        C, H, D = C3 // 3, vis.num_attention_heads, vis.head_dim

        def k1(t, heads):
            q, k, v = (u.view(B, S, heads, D) for u in t.split(t.shape[-1]
                                                              // 3, -1))
            return multi_head_attention(q, k, v, causal=False,
                                        norm_bound=True)

        whole = k1(qkv, H)
        same = []
        for j in range(m):
            n = C // m
            mine = torch.cat([qkv[..., i * C + j * n:i * C + (j + 1) * n]
                              for i in range(3)], -1)
            got = k1(mine, H // m)
            same.append(torch.equal(got, whole.view(B, S, H, D)[
                :, :, j * (H // m):(j + 1) * (H // m)]))
        out["vit"] = same

        T = round_to_bucket(max(len(i) for i in ids_list), scorer.buckets)
        ids = np.stack([scorer._pad(np.asarray(i, np.int32), T,
                                    scorer.pad_token_id) for i in ids_list])
        mask = np.stack([scorer._pad(np.ones(len(i), np.int32), T, 0)
                         for i in ids_list])
        ids_t = torch.as_tensor(ids).to(dev)
        mask_t = torch.as_tensor(mask).to(dev)
        lm = p["language_model"]
        emb = tivl.embed_prompt(lm, ids_t, scorer.img_context_token_id)
        feats = tivl.extract_feature(p, cfg.chat, x)
        emb = tivl.scatter_image_embeds(emb, ids_t, feats,
                                        scorer.img_context_token_id)
        layer = map_state(lambda a: a[0], lm["layers"])
        h = rms_norm(emb, layer["attention_norm"]["weight"],
                     eps=llm.rms_norm_eps)
        Hq, Hkv, D = (llm.num_attention_heads, llm.num_key_value_heads,
                      llm.head_dim)
        q, k, v = (dot(h, layer["attention"][w]["kernel"]).reshape(
            B // FRAMES, T, -1, D) for w in ("wq", "wk", "wv"))
        cos, sin = rope_tables(
            T, D, base=llm.rope_theta, scaling_type=llm.rope_scaling_type,
            scaling_factor=llm.rope_scaling_factor,
            max_position_embeddings=llm.max_position_embeddings, device=dev)
        q, k = apply_rope(q, k, cos, sin)

        def k2(q, k, v):
            return multi_head_attention(q, k, v, attention_mask=mask_t,
                                        causal=True, norm_bound=True)

        whole = k2(q, k, v)
        same = []
        for j in range(m):
            qs, ks = slice(j * Hq // m, (j + 1) * Hq // m), slice(
                j * Hkv // m, (j + 1) * Hkv // m)
            got = k2(q[:, :, qs].contiguous(), k[:, :, ks].contiguous(),
                     v[:, :, ks].contiguous())
            same.append(torch.equal(got, whole[:, :, qs]))
        out["decoder"] = same
    print(f"phase 33 (a): the first layer's attention on each of {m} model "
          f"ranks' heads bit-equal to the whole layer's: ViT K1 "
          f"{out['vit']}, decoder K2 {out['decoder']}")
    if not all(out["vit"] + out["decoder"]):
        raise RuntimeError(f"phase 33 (a): a rank's heads differ: {out}")
    return out


def mesh_scoring_phase(scorer, requests, pair_scores, dev):
    """Phase 33 (a) and (b) on phase 4's state: the pair request through
    ``RewardScorer(mesh=)`` at each of MESH_SCORING against phase 4's
    unsharded scores (SCORE_TOL), the launches exact (a clip a data shard,
    a head group a model rank); the first layer's attention per rank's
    heads bit-equal to the whole layer's; then ``int8-wo`` and ``int4-wo``
    at ``local(1, 2)`` against the same quantized tree unsharded (both
    bf16 kernels) and through the plain path in fp32, each within the
    quantized modes' bar, QUANT_SCORE_TOL (phase 11's).  ``pair_scores``: phase 4's scores of the pair.
    Returns the readings and the launch counts by path."""
    import torch

    from mjvideo_tpu_torch import RewardScorer, kernels
    from mjvideo_tpu_torch.parallel.mesh import Mesh

    pair, want = requests[1], pair_scores
    vis, llm = scorer.cfg.chat.vision, scorer.cfg.chat.llm
    out, launches = {}, {}

    def meshed(params, mesh, quant=None):
        return RewardScorer(scorer.cfg, params, scorer.tokenizer,
                            dtype=scorer.dtype, quant=quant,
                            length_buckets=scorer.buckets,
                            gating_pattern=scorer.gating_pattern, mesh=mesh)

    for data, model in MESH_SCORING:
        mesh = Mesh.local(data, model)
        sc = meshed(scorer.params, mesh)
        sc.score_batch(*pair)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = sc.score_batch(*pair).score.float().cpu()
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)
        ms = _host_ms(lambda: sc.score_batch(*pair), reps=3)
        del sc
        shards = data * model
        wanted = _with_prepass({
            "vit_attention": vis.num_hidden_layers * shards,
            "decoder_attention": llm.num_hidden_layers * shards})
        wanted = {k: wanted.get(k, 0) for k in counts}
        delta = (got - want.float().cpu()).abs().max().item()
        name = f"local({data}, {model})"
        print(f"phase 33 (a) {name}: pair scores {got.tolist()} against "
              f"{want.float().cpu().tolist()} unsharded, |delta| "
              f"{delta:.3e} (bound {SCORE_TOL}); {ms:.1f} ms a pair "
              f"request; launches {counts}")
        if not delta < SCORE_TOL:
            raise RuntimeError(f"phase 33 (a) {name}: score delta {delta}")
        if counts != wanted:
            raise RuntimeError(f"phase 33 (a) {name}: launches {counts}, "
                               f"want {wanted}")
        out[name] = {"scores": got.tolist(), "delta": delta, "ms": ms}
        launches[f"mesh_scoring_{data}x{model}"] = counts
    out["first_layer_heads"] = _first_layer_heads(scorer, pair, dev)

    for mode in MESH_QUANT_MODES:
        one = meshed(scorer.params, None, quant=mode)
        ref = one.score_batch(*pair).score.float().cpu()
        tree = one.params
        del one
        plain = RewardScorer(scorer.cfg, _float_plain(tree), scorer.tokenizer,
                             dtype=torch.float32,
                             length_buckets=scorer.buckets,
                             gating_pattern=scorer.gating_pattern,
                             attn_impl="plain")
        fp32 = plain.score_batch(*pair).score.float().cpu()
        del plain
        sc = meshed(tree, Mesh.local(1, 2), quant=mode)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = sc.score_batch(*pair).score.float().cpu()
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)
        del sc, tree
        torch.cuda.empty_cache()
        delta = (got - ref).abs().max().item()
        vs_plain = (got - fp32).abs().max().item()
        ref_vs_plain = (ref - fp32).abs().max().item()
        print(f"phase 33 (b) {mode} at local(1, 2): pair scores "
              f"{got.tolist()} against {ref.tolist()} unsharded, |delta| "
              f"{delta:.3e}; against the tree through the plain path in fp32 "
              f"{fp32.tolist()}: |delta| {vs_plain:.3e} (unsharded "
              f"{ref_vs_plain:.3e}); bound {QUANT_SCORE_TOL} each")
        if not (delta < QUANT_SCORE_TOL and vs_plain < QUANT_SCORE_TOL):
            raise RuntimeError(f"phase 33 (b) {mode}: score delta {delta}, "
                               f"against fp32 plain {vs_plain}")
        out[mode] = {"scores": got.tolist(), "unsharded": ref.tolist(),
                     "fp32_plain": fp32.tolist(), "delta": delta,
                     "delta_vs_plain": vs_plain,
                     "unsharded_delta_vs_plain": ref_vs_plain}
        launches[f"mesh_scoring_{mode}"] = counts
    return out, launches


def _acc_grads(trainer):
    """The accumulation buffer (after one micro-step: its gradient) by
    path, whole."""
    acc = trainer.whole_opt_state()["acc"]
    return [acc[p] for p in trainer.optimizer.paths]


def mesh_training_phase(dev, generator, d):
    """Phase 33 (c) at the 2B widths: stage 3 (phase 5's config) at
    ``local(2, 2)`` on batches of two of phase 5's pairs, 2 optimizer
    steps (4 micro-batches), without and with ZeRO-1: ZeRO-1's parameters
    and optimizer state bit-equal to the replicated run's; its first
    micro-batch's gradient against the unsharded ``Trainer``'s (the same
    bf16 kernels) by FIDELITY_REL_L2 and FIDELITY_COS; each data rank's
    optimizer bytes beside the unsharded state's; then, at full width and
    ASYNC_DEPTH deep (a resume is bit-equal or not at any depth), a ZeRO-1
    run of 3 micro-batches (one optimizer step, the accumulator
    mid-window), a save, a resume and one more micro-step bit-equal to the
    unbroken run's.  Returns the readings and the launch counts by
    path."""
    import gc

    import torch

    from mjvideo_tpu_torch import init_reward_params, kernels
    from mjvideo_tpu_torch.parallel.mesh import Mesh
    from mjvideo_tpu_torch.train.trainer import (
        Trainer,
        flatten_state,
        state_bytes,
    )

    cfg, batches = mesh_train_data()
    out, launches = {}, {}

    def trainer(mesh, zero1, sub, c=cfg):
        params = init_reward_params(c, generator=generator(), device=dev,
                                    dtype=torch.bfloat16)
        tc = train_config(os.path.join(d, sub))
        tc.zero1 = zero1
        return Trainer(c, params, tc, mesh=mesh)

    def snapshot(tr):
        """The whole state by path (gathered), and the step."""
        return ({**{f"params/{k}": v for k, v in
                    flatten_state(tr.whole_params()).items()},
                 **{f"opt/{k}": v for k, v in
                    flatten_state(tr.whole_opt_state()).items()}}, tr.step)

    def same_state(got, want):
        """Every entry of the two snapshots bit-equal."""
        if got[1] != want[1] or got[0].keys() != want[0].keys():
            return False
        return all(torch.equal(v, want[0][k]) if torch.is_tensor(v)
                   else v == want[0][k] for k, v in got[0].items())

    # The unsharded kernel run's first micro-batch.
    clock = {}
    start = time.perf_counter()
    one = trainer(None, False, "one")
    one.train(batches[:1])
    ref = _acc_grads(one)
    out["unsharded_state_gib"] = state_bytes(one.opt_state) / 2**30
    del one
    gc.collect()
    torch.cuda.empty_cache()
    clock["unsharded"] = time.perf_counter() - start

    mesh = Mesh.local(2, 2)
    replicated = None
    for zero1 in (False, True):
        start = time.perf_counter()
        tr = trainer(mesh, zero1, f"zero1_{zero1}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        records, dt = [], 0.0
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            records.append(tr.train([b]))
            torch.cuda.synchronize()
            dt += time.perf_counter() - t0
            if i == 0 and zero1:
                got = _acc_grads(tr)
                rel, cos, _ = _agreement(got, ref)
                del got, ref
                print(f"phase 33 (c): the first micro-batch's gradient on "
                      f"local(2, 2) against the unsharded kernel run: "
                      f"relative L2 {rel:.4e} (bound {FIDELITY_REL_L2}), "
                      f"cosine {cos:.6f} (bound {FIDELITY_COS})")
                out["gradient"] = {"rel_l2": rel, "cos": cos}
                if not (rel <= FIDELITY_REL_L2 and cos >= FIDELITY_COS):
                    raise RuntimeError(f"phase 33 (c): gradient relative "
                                       f"L2 {rel}, cosine {cos}")
        counts = dict(kernels.launch_counts)
        # Phase 5's launches a video and micro-batch, once per data shard
        # and model rank.
        per_video = _with_prepass({
            "vit_attention": cfg.chat.vision.num_hidden_layers,
            "decoder_attention": 2 * cfg.chat.llm.num_hidden_layers,
            "decoder_attention_lse": 2 * cfg.chat.llm.num_hidden_layers,
            "decoder_attention_bwd_dkdv": cfg.chat.llm.num_hidden_layers,
            "decoder_attention_bwd_dq": cfg.chat.llm.num_hidden_layers})
        wanted = {k: 2 * len(batches) * mesh.data * mesh.model
                  * per_video.get(k, 0) for k in counts}
        if counts != wanted:
            raise RuntimeError(f"phase 33 (c) launches {counts}, want "
                               f"{wanted}")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if not all(math.isfinite(r["loss"]) for r in records):
            raise RuntimeError(f"phase 33 (c): non-finite losses {records}")
        if tr.opt_state["gradient_step"] != len(batches) // 2:
            raise RuntimeError("phase 33 (c): the optimizer did not step "
                               "once per 2 micro-batches")
        ranks = {f"{dr},{mr}": n / 2**30 for (dr, mr), n in
                 tr.optimizer.rank_bytes(tr.opt_state).items()}
        label = "ZeRO-1" if zero1 else "replicated"
        print(f"phase 33 (c) {label} at local(2, 2): losses "
              f"{[round(r['loss'], 6) for r in records]}, {dt:.1f} s for "
              f"{len(batches)} micro-steps, peak {peak:.2f} GiB; optimizer "
              f"GiB by (data, model) rank {ranks} (unsharded "
              f"{out['unsharded_state_gib']:.3f} GiB)")
        out[label] = {"losses": [r["loss"] for r in records], "s": dt,
                      "peak_gib": peak, "rank_state_gib": ranks}
        launches[f"mesh_training_{label}"] = counts
        if not zero1:
            replicated = snapshot(tr)
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        clock[label] = time.perf_counter() - start
    same = same_state(snapshot(tr), replicated)
    print(f"phase 33 (c): ZeRO-1's parameters and optimizer state bit-equal "
          f"to the replicated run's: {same}")
    if not same:
        raise RuntimeError("phase 33 (c): ZeRO-1 differs from the "
                           "replicated run")
    out["zero1_bit_equal"] = same
    del replicated, tr
    gc.collect()
    torch.cuda.empty_cache()

    # Save after 3 micro-batches at ASYNC_DEPTH; one more on the unbroken
    # run and on a resumed one.
    small = cut_depth(cfg, *ASYNC_DEPTH)
    tr = trainer(mesh, True, "resume", small)
    tr.train(batches[:3])
    t0 = time.perf_counter()
    path = tr.save()
    clock["save"] = time.perf_counter() - t0
    size = os.path.getsize(path)
    tr.train(batches[3:4])
    unbroken = snapshot(tr)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    back = trainer(mesh, True, "resume", small)
    back.resume_latest()
    clock["resume"] = time.perf_counter() - t0
    back.train(batches[3:4])
    same = same_state(snapshot(back), unbroken)
    print(f"phase 33 (c): at {ASYNC_DEPTH} (ViT, decoder) layers, saved at "
          f"step 3 ({os.path.basename(path)}, {size / 2**30:.2f} GiB), "
          f"resumed, one more micro-step bit-equal to the unbroken run's: "
          f"{same}; seconds by part "
          f"{({k: round(v, 1) for k, v in clock.items()})}")
    out["seconds_by_part"] = clock
    out["checkpoint_gib"] = size / 2**30
    if not same:
        raise RuntimeError("phase 33 (c): the resumed step differs")
    out["resume_bit_equal"] = same
    del back, unbroken
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def mesh_phase_tail(dev, generator):
    """Phase 33 (c) and (d): the mesh training (``mesh_training_phase``)
    and ``dryrun_multichip(4)`` on the card, with their command time and
    launch counts by path."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.dryrun import dryrun_multichip

    with tempfile.TemporaryDirectory() as d:
        out, launches = mesh_training_phase(dev, generator, d)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    out["dryrun"] = dryrun_multichip(4, device=str(dev))
    launches["mesh_dryrun"] = dict(kernels.launch_counts)
    out["dryrun"]["s"] = time.perf_counter() - t0
    print(f"phase 33 (d): dryrun_multichip(4) on the card in "
          f"{out['dryrun']['s']:.1f} s")
    return out, launches


# Phase 34: every local judge on a (data, model) mesh on one card (every
# shard in this process, ``Mesh.local``), against the same judge unsharded
# (the same bf16 kernels) and against its state in fp32 through the plain
# path.  Each judge answers the pair of seeded videos by its prefix path
# (``ask_batch`` with JUDGE_QUESTION, JUDGE_NEW_TOKENS greedy tokens): the
# meshed answer's tokens against the unsharded answer's (where they part,
# the unsharded run's top-two gap at that step beside the two runs' logit
# distance there), and its teacher-forced logits over the first
# MESH_FORCED_STEPS of the unsharded tokens against fp32 plain
# (LOGITS_REL_TOL of max|logit|) and against the unsharded run.  The
# InternVL2-2B judge runs at all 24 of its decoder layers; the other
# judges at full width with their depths cut (MESH_JUDGE_DEPTHS) for the
# script's time limit.
MESH_JUDGE_2B = (((1, 2), False), ((1, 2), True), ((2, 2), False),
                 ((2, 2), True))  # ((data, model), the int8 KV cache)
MESH_JUDGE_QUANT = "int4-wo"      # at local(1, 2)
MESH_FORCED_STEPS = 8
MESH_26B_TOWER = 5                # the 6B tower's 25 heads over 5 ranks
# (vision tower layers, decoder layers) of each judge; VideoScore's
# perceiver keeps its 3 layers.
MESH_JUDGE_DEPTHS = {"minicpmv": (4, 4), "cogvlm2": (4, 4), "qwen2vl": (4, 4),
                     "videoscore": (4, 4), "internvl26b": (6, 4)}
# The decoders' kv and query heads on a model rank of 2 (of InternLM2-1.8B,
# Qwen2-7B, InternLM2-20B, Llama-3-8B and Mistral-7B), K3 checked at each
# at the 2B judge's prefill and continuation shapes (JUDGE_SHAPES).
MESH_DECODER_HEADS = {"internlm2-1.8b": (8, 4), "qwen2-7b": (14, 2),
                      "internlm2-20b": (24, 4), "llama3-8b": (16, 4),
                      "mistral-7b": (16, 4)}


def check_judge_mesh_kernels(randn):
    """Phase 34 (a): each kernel of the meshed judges at a model rank's
    head counts against its twin (2**-7 of max|plain|): K1 at D = 64 (8 of
    InternViT-300M's 16 heads), 72 (8 of SigLIP's 16), 80 (8 of the
    Qwen2-VL tower's 16) and 128 (5 of InternViT-6B's 25, q and k dense);
    K1m at 8 of SigLIP's heads on VideoScore's split frames; K3 not causal
    at D = 112 (8 of EVA's 16); K3 causal at each decoder's rank heads
    (MESH_DECODER_HEADS) at the judge's pair prefill and suffix
    continuation, K2r with its pre-pass at the 2B's prefix; K5 at the 2B
    decoder's projections cut over 2 ranks and its whole LM head.
    Returns the readings by (kernel, shape)."""
    from mjvideo_tpu_torch import kernels
    from mjvideo_tpu_torch.ops import flash_attention as fa
    from mjvideo_tpu_torch.ops import quant4 as q4

    out = {}
    for shape, dense in (((JUDGE_FRAMES, 1025, 8, 64), False),
                         ((MCPM_FRAMES, 1032, 8, 72), False),
                         ((QWEN_GRID[0], 676, 8, 80), False),
                         ((JUDGE_FRAMES, 1025, 5, 128), True)):
        for name, r in check_vit_attention(randn, shape,
                                           dense_qk=dense).items():
            out[name, shape] = r
    mask = _split_patch_mask(randn(1).device)
    for name, r in check_masked_vit_attention(randn, mask, heads=8).items():
        out[name, (mask.shape[0], mask.shape[1], 8, 72)] = r
    shape = (COG_FRAMES, 257, 8, 112)
    out["K3 D112", shape] = check_k3_d112(randn, shape)
    for label, (Hq, Hkv) in MESH_DECODER_HEADS.items():
        for path in ("prefill", "continuation"):
            B, Q, K, _, _, D, off = JUDGE_SHAPES[path]
            shape = (B, Q, K, Hq, Hkv, D, off)
            q, k, v, m, o, dead = _judge_inputs(randn, shape)
            out["K3", shape] = _check_kernel(
                f"K3 exact_attention {label} {path} {shape[:6]}",
                lambda: fa.exact_attention(q, k, v, m, o),
                lambda: fa.exact_attention_plain(q, k, v, m, o),
                zero=(f"{int(dead.sum())} dead rows",
                      lambda got: not got[0][dead].any()),
                work=_attention_work(q, k, v, m, o),
                library=_sdpa_at(q, k, v, m, o))
    B, Q, K, Hq, Hkv, D, off = JUDGE_SHAPES["prefix"]
    shape = (B, Q, K, 8, 4, D, off)
    for name, r in check_judge_kernels(randn, "internlm2-1.8b prefix",
                                       shape).items():
        out[name, shape] = r
    for K, N in ((2048, 1024), (1024, 2048), (2048, 92553)):
        k4 = q4.quantize_kernel_q4(randn(K, N).float() * 0.02,
                                   group_size=W4_GROUP)
        x = randn(2, K)
        out["K5", (2, K, N)] = _check_kernel(
            f"K5 w4_matmul at a model rank's {(2, K, N)} g {W4_GROUP}",
            lambda: kernels.w4_matmul(x, k4.packed, k4.scale),
            lambda: q4.w4_matmul_plain(x, k4.packed, k4.scale),
            extra=_again(lambda: kernels.w4_matmul(x, k4.packed, k4.scale)),
            work=(_nbytes(x, k4.packed, k4.scale) + 4 * 2 * N,
                  2 * 2 * K * N, BF16_OPS_PER_S))
    return out


class RecordingTokenizer:
    """A judge's tokenizer that also keeps every token row the judge decodes
    (its answers' greedy tokens, the stop token stripped), in order."""

    def __init__(self, tok):
        self.tok, self.rows = tok, []

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def __call__(self, *args, **kw):
        return self.tok(*args, **kw)

    def decode(self, toks):
        self.rows.append([int(t) for t in toks])
        return self.tok.decode(toks)


def _judge_teacher(judge, videos, teacher):
    """The prefix path's teacher-forced logits (B, n, V) of ``judge`` on
    ``teacher`` (B, n)."""
    from mjvideo_tpu_torch.eval.judges import InternVLJudge

    if isinstance(judge, InternVLJudge):
        return path_runner(judge, JUDGE_QUESTION, videos, True)(
            teacher_tokens=teacher)
    return _qwen_teacher(judge, JUDGE_QUESTION, videos, True, teacher)


def _sync():
    """``torch.cuda.synchronize()`` where there is a card (the multi-card
    tool's CPU rehearsal runs these helpers on the CPU)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _answer(judge, videos):
    """``judge.ask_batch`` on the pair by the prefix path, timed (cold: the
    videos encoded and their prefixes prefilled): (its token rows, s)."""
    judge.tokenizer.rows = []
    _sync()
    t0 = time.perf_counter()
    answers = judge.ask_batch(JUDGE_QUESTION, list(videos))
    _sync()
    secs = time.perf_counter() - t0
    if not all(isinstance(a, str) for a in answers):
        raise RuntimeError("an answer did not decode to text")
    rows = judge.tokenizer.rows[-len(videos):]
    return rows, secs


def _teacher_of(rows, n, eos, device):
    """The (B, n) teacher tokens of answer rows, eos past a row's end."""
    import torch

    return torch.tensor([(r + [eos] * n)[:n] for r in rows], device=device)


def _timed_teacher(judge, videos, teacher):
    """(the teacher-forced logits over ``teacher``'s steps, ms a decode
    step by difference against one step)."""
    _sync()
    t0 = time.perf_counter()
    logits = _judge_teacher(judge, videos, teacher)
    _sync()
    t_n = time.perf_counter() - t0
    t0 = time.perf_counter()
    _judge_teacher(judge, videos, teacher[:, :1])
    _sync()
    t_1 = time.perf_counter() - t0
    return logits, (t_n - t_1) * 1e3 / (teacher.shape[1] - 1)


def mesh_judge_reference(judge, plain, videos, eos):
    """The unsharded kernel judge's answer rows, its timing and its
    teacher-forced logits over MESH_FORCED_STEPS, and the fp32 plain
    judge's on the same tokens."""
    rows, secs = _answer(judge, videos)
    teacher = _teacher_of(rows, MESH_FORCED_STEPS, eos, judge.device)
    logits, step_ms = _timed_teacher(judge, videos, teacher)
    return {"rows": rows, "pair_s": secs, "step_ms": step_ms,
            "teacher": teacher, "logits": logits,
            "plain": _judge_teacher(plain, videos, teacher)}


def _first_parting(rows, ref_rows):
    """(row, step) where two answers' token rows first part, or None."""
    for b, (r, w) in enumerate(zip(rows, ref_rows)):
        if r != w:
            s = next((i for i, (x, y) in enumerate(zip(r, w)) if x != y),
                     min(len(r), len(w)))
            return b, s
    return None


def mesh_judge_reading(label, judge, unsharded, ref, videos, eos, want):
    """One meshed judge against its unsharded twin (``ref``,
    ``mesh_judge_reference``'s): its answer by the prefix path with the
    launches held to ``want`` (kernel -> count, names not given 0; or a
    function of the answer's token rows giving it), its
    teacher-forced logits against fp32 plain (LOGITS_REL_TOL) and against
    the unsharded run, and its tokens against the unsharded answer's.
    Where they part, the unsharded run's top-two gap at that step is read
    beside the two runs' max|logit delta| there; a flip needs the two top
    logits to move by the gap together, so it raises where the gap exceeds
    twice the delta.  Returns the reading and the launches."""
    import torch

    from mjvideo_tpu_torch import kernels

    kernels.reset_launch_counts()
    rows, secs = _answer(judge, videos)
    launches = _held_launches(f"phase 34 {label}",
                              want(rows) if callable(want) else want)
    logits, step_ms = _timed_teacher(judge, videos, ref["teacher"])
    if not bool(logits.isfinite().all()):
        raise RuntimeError(f"phase 34 {label}: non-finite logits")
    rel = _rel_err(logits, ref["plain"])[1]
    dist, dist_rel = _rel_err(logits, ref["logits"])
    part = _first_parting(rows, ref["rows"])
    reading = {"rel_vs_fp32_plain": rel, "max_abs_vs_unsharded": dist,
               "rel_vs_unsharded": dist_rel, "pair_s": secs,
               "step_ms": step_ms, "unsharded_pair_s": ref["pair_s"],
               "unsharded_step_ms": ref["step_ms"], "tokens_equal":
               part is None, "tokens": sum(len(r) for r in rows)}
    text = "tokens equal to the unsharded answer's"
    if part is not None:
        b, s = part
        n = s + 1
        mine, theirs = logits, ref["logits"]
        if n > mine.shape[1]:  # past the forced steps: both runs to s
            teacher = _teacher_of(ref["rows"], n, eos, judge.device)
            mine = _judge_teacher(judge, videos, teacher)
            theirs = _judge_teacher(unsharded, videos, teacher)
        top2 = torch.topk(theirs[b, s].float(), 2).values
        gap = (top2[0] - top2[1]).item()
        delta = (mine[b, s].float() - theirs[b, s].float()).abs().max().item()
        reading.update(parted_at=[b, s], top2_gap=gap, delta_there=delta)
        text = (f"tokens part from the unsharded answer's at row {b} step "
                f"{s}: its top-two gap there {gap:.4e}, the logit delta "
                f"{delta:.4e}")
        if gap > 2 * delta:
            raise RuntimeError(f"phase 34 {label}: {text} (a gap over "
                               "twice the delta)")
    print(f"phase 34 {label}: {text}; teacher-forced logits over "
          f"{MESH_FORCED_STEPS} steps {rel:.4e} of max|fp32 plain logit| "
          f"(bound {LOGITS_REL_TOL:.1e}), max|delta| against the unsharded "
          f"run {dist:.4e} ({dist_rel:.4e}); a pair {secs:.3f} s cold "
          f"(unsharded {ref['pair_s']:.3f} s), a decode step at B = 2 "
          f"{step_ms:.2f} ms (unsharded {ref['step_ms']:.2f} ms)")
    if not rel <= LOGITS_REL_TOL:
        raise RuntimeError(f"phase 34 {label}: logits {rel} of max|fp32 "
                           f"plain| > {LOGITS_REL_TOL}")
    return reading, launches


def _split_layers(plan, *keys):
    """Whether every pair named by ``keys`` (path fragments) is split."""
    return {k: any(k in p for p in plan) for k in keys}


def internvl2b_mesh_phase(dev, generator):
    """Phase 34 (b): the InternVL2-2B judge (phase 9's state: the same
    seed) at all 24 decoder layers on ``local(1, 2)`` and ``(2, 2)`` with
    the dense and the int8 KV cache, and ``int4-wo`` at ``(1, 2)``.  Every
    pair of the 2B splits at model 2 (16 ViT heads, 8 kv heads; the
    92,553-row vocabulary stays whole).  Returns the readings and the
    launches."""
    import gc

    import torch

    from mjvideo_tpu_torch.models.generate import _eos_pad
    from mjvideo_tpu_torch.parallel.mesh import Mesh, split_plan

    videos = ("video_0", "video_1")
    state = make_judge(generator=generator(), device=dev).params

    def judge_of(params, mesh=None, kv_quant=False, quant=None):
        j = make_judge(state=params, mesh=mesh, kv_quant=kv_quant,
                       quant=quant)
        j.tokenizer = RecordingTokenizer(j.tokenizer)
        return j

    base = judge_of(state)
    cfg = base.cfg
    eos = _eos_pad(cfg, base.tokenizer)[0]
    L_vit, L_llm = cfg.vision.num_hidden_layers, cfg.llm.num_hidden_layers
    plan = split_plan(state, 2, cfg)
    out = {"split": _split_layers(plan, "vision_model/layers/attn/",
                                  "language_model/layers/attention/",
                                  "language_model/output/")}
    launches = {}
    del base
    fp32 = _float_plain(state)
    for kv_quant in (False, True):
        ref = mesh_judge_reference(
            judge_of(state, kv_quant=kv_quant),
            judge_of(fp32, kv_quant=kv_quant), videos, eos)
        unsharded = judge_of(state, kv_quant=kv_quant)
        for (data, model), kvq in MESH_JUDGE_2B:
            if kvq != kv_quant:
                continue
            label = f"internvl2-2b local({data}, {model})" + (
                " int8 cache" if kvq else "")
            judge = judge_of(state, Mesh.local(data, model), kvq)
            want = _with_prepass({"vit_attention": 2 * L_vit * model,
                                  "exact_attention": (2 + data) * L_llm
                                  * model})
            out[label], launches[label] = mesh_judge_reading(
                label, judge, unsharded, ref, videos, eos, want)
            del judge
        del ref, unsharded
        gc.collect()
        torch.cuda.empty_cache()
    del fp32
    one = judge_of(state, quant=MESH_JUDGE_QUANT)
    tree = one.params
    ref = mesh_judge_reference(one, judge_of(_float_plain(tree)), videos,
                               eos)
    judge = judge_of(tree, Mesh.local(1, 2))
    label = f"internvl2-2b local(1, 2) {MESH_JUDGE_QUANT}"

    def want(rows):
        """K5: the LM head (whole: 92,553 columns) on the continuation's
        last rows, then per decode step each rank's 7 products a layer and
        the head; the loop stops once every row has drawn EOS (rows
        stripped of it) or at the budget."""
        n = max(len(r) for r in rows)
        steps = JUDGE_NEW_TOKENS - 1 if n == JUDGE_NEW_TOKENS else n
        return _with_prepass({"vit_attention": 4 * L_vit,
                              "exact_attention": 6 * L_llm,
                              "w4_matmul": 1 + (14 * L_llm + 1) * steps})

    out[label], launches[label] = mesh_judge_reading(
        label, judge, one, ref, videos, eos, want)
    del one, tree, judge, ref, state
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def _cut_vision(cfg, layers):
    """``cfg`` with its vision tower cut to ``layers`` layers."""
    import dataclasses

    v = cfg.vision
    field = "depth" if hasattr(v, "depth") else "num_hidden_layers"
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        v, **{field: layers}))


def families_mesh_phase(dev, generator):
    """Phase 34 (c): the MiniCPM-V-2.6, CogVLM2-Video and Qwen2-VL-2B judges
    at ``local(1, 2)`` (towers and decoders cut to MESH_JUDGE_DEPTHS at
    full width; every pair of theirs splits at model 2), each against
    itself unsharded and in fp32 plain; then VideoScore's split frames
    (K1m at 8 of SigLIP's heads) at ``local(1, 2)``, its 5 logits against
    fp32 plain and unsharded.  Returns the readings and the launches."""
    import gc

    import numpy as np
    import torch

    from mjvideo_tpu_torch import kernels, map_state
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.eval.judges import (
        VideoScoreJudge,
        videoscore_prompt,
    )
    from mjvideo_tpu_torch.models import cogvlm2, minicpmv, qwen2vl
    from mjvideo_tpu_torch.models import videoscore as vs
    from mjvideo_tpu_torch.parallel.mesh import Mesh

    videos = ("video_0", "video_1")
    mesh = Mesh.local(1, 2)
    out, launches = {}, {}
    families = (
        ("minicpmv", minicpmv.MiniCPMVConfig(), minicpmv.init_minicpmv_params,
         make_minicpm_judge, lambda c: {"vit_attention": 2 * c[0] * 2,
                                        "exact_attention": 3 * c[1] * 2},
         _at_d72),
        ("cogvlm2", cogvlm2.CogVLM2Config(), cogvlm2.init_cogvlm2_params,
         make_cog_judge, lambda c: {"exact_attention": (2 * c[0] + 3 * c[1])
                                    * 2, "exact_attention_d112":
                                    2 * c[0] * 2}, dict),
        ("qwen2vl", qwen2vl.Qwen2VLConfig(), qwen2vl.init_qwen2vl_params,
         make_qwen_judge, lambda c: {
             "vit_attention": 2 * c[0] * 2, "vit_attention_d80": 2 * c[0] * 2,
             "key_norm_max_d80": 2 * c[0] * 2,
             "exact_attention": 3 * c[1] * 2}, _with_prepass))
    for name, full, init, make, want_of, names in families:
        depth = MESH_JUDGE_DEPTHS[name]
        cfg = _cut_vision(cut_text_depth(full, depth[1]), depth[0])
        state = init(cfg, generator=generator(), device=dev,
                     dtype=torch.bfloat16)
        tok = ByteTokenizer()

        def judge_of(params, mesh=None, **kw):
            return make(cfg, params, RecordingTokenizer(tok), mesh=mesh,
                        **kw)

        eos = (cfg.eos_token_id if name == "cogvlm2"
               else cfg.im_end_token_id)
        if name == "cogvlm2":
            plain = judge_of(state, dtype=torch.float32, attn_impl="plain")
        else:
            plain = judge_of(map_state(lambda t: t.float(), state))
        ref = mesh_judge_reference(judge_of(state), plain, videos, eos)
        del plain
        label = f"{name} local(1, 2) at depths {depth}"
        out[label], launches[label] = mesh_judge_reading(
            label, judge_of(state, mesh), judge_of(state), ref, videos, eos,
            names(want_of(depth)))
        del state, ref
        gc.collect()
        torch.cuda.empty_cache()

    # VideoScore: do_image_splitting's images (K1m), one forward.
    depth = MESH_JUDGE_DEPTHS["videoscore"]
    cfg = _cut_vision(cut_text_depth(vs.VideoScoreConfig(num_labels=5),
                                     depth[1]), depth[0])
    state = vs.init_videoscore_params(cfg, generator=generator(), device=dev,
                                      dtype=torch.bfloat16)
    tok = WordTokenizer(cfg.image_token_id)
    pix, pmask = videoscore_split_inputs(np.random.default_rng(SEED))

    def vs_judge(params, dtype, impl, m=None):
        return VideoScoreJudge(tokenizer=tok, cfg=cfg, params=params,
                               dtype=dtype, attn_impl=impl,
                               do_image_splitting=True, mesh=m)

    judge = vs_judge(state, torch.bfloat16, "auto", mesh)
    ids, mask = judge.tokenize(videoscore_prompt(JUDGE_CAPTION,
                                                 VS_SPLIT_FRAMES))
    ids, mask = np.asarray([ids]), np.asarray([mask])
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = judge.score_frames(pix, ids, mask, pmask)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    label = f"videoscore local(1, 2) at depths {depth}"
    launches[label] = _held_launches(f"phase 34 {label}", _at_d72({
        "vit_attention_masked": depth[0] * 2,
        "decoder_attention": depth[1] * 2}))
    unsharded = vs_judge(state, torch.bfloat16, "auto")
    t0 = time.perf_counter()
    one = unsharded.score_frames(pix, ids, mask, pmask)
    one_s = time.perf_counter() - t0
    fp32 = vs_judge(map_state(lambda t: t.float(), state), torch.float32,
                    "plain").score_frames(pix, ids, mask, pmask)
    rel = _rel_err(torch.from_numpy(got), torch.from_numpy(fp32))[1]
    dist = float(np.abs(got - one).max())
    out[label] = {"logits": got.tolist(), "unsharded": one.tolist(),
                  "fp32_plain": fp32.tolist(), "rel_vs_fp32_plain": rel,
                  "max_abs_vs_unsharded": dist, "s": secs,
                  "unsharded_s": one_s}
    print(f"phase 34 {label}: {VS_SPLIT_FRAMES} split frames "
          f"({pix.shape[0]} images), logits {got.tolist()} against fp32 "
          f"plain {fp32.tolist()}: {rel:.4e} of max|plain| (bound "
          f"{LOGITS_REL_TOL:.1e}), max|delta| against the unsharded run "
          f"{dist:.4e}; {secs * 1e3:.1f} ms a clip (unsharded "
          f"{one_s * 1e3:.1f} ms, cold)")
    if not rel <= LOGITS_REL_TOL:
        raise RuntimeError(f"phase 34 {label}: {rel} > {LOGITS_REL_TOL}")
    del judge, unsharded, state
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def internvl26b_mesh_phase(dev, generator):
    """Phase 34 (d): the InternVL2-26B judge at full width, its tower and
    decoder cut to MESH_JUDGE_DEPTHS: the InternViT-6B tower on
    ``local(1, MESH_26B_TOWER)``, where its 25 heads split 5 a rank and the
    QK-RMSNorm's statistics cross the ranks, and the decoder (48/8 heads:
    24/4 a rank) on ``local(1, 2)``, against the judge unsharded and in
    fp32 plain.  Returns the readings and the launches."""
    import dataclasses
    import functools
    import gc

    import torch

    from mjvideo_tpu_torch import internvl2_26b_chat_config
    from mjvideo_tpu_torch.models.generate import _eos_pad
    from mjvideo_tpu_torch.parallel.mesh import Mesh, shard_params, split_plan

    videos = ("video_0", "video_1")
    depth = MESH_JUDGE_DEPTHS["internvl26b"]
    base = internvl2_26b_chat_config()
    base = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision,
                                         num_hidden_layers=depth[0]),
        llm=dataclasses.replace(base.llm, num_hidden_layers=depth[1]))
    state = init_chat_params_by_layer(base, generator(), dev)
    tower_mesh = Mesh.local(1, MESH_26B_TOWER)
    tower = {k: state[k] for k in ("vision_model", "mlp1")}

    def judge_of(params, mesh=None, **kw):
        j = make_judge(state=params, base=base, mesh=mesh, **kw)
        j.tokenizer = RecordingTokenizer(j.tokenizer)
        return j

    unsharded = judge_of(state)
    cfg = unsharded.cfg
    tower_plan = split_plan(tower, MESH_26B_TOWER, cfg)
    out = {"tower_split": _split_layers(tower_plan, "attn/qkv", "mlp/fc1")}
    tower_shards = shard_params(tower, tower_mesh, cfg=cfg)
    judge = judge_of(state, Mesh.local(1, 2))
    encode_video = judge._encode_video

    def encode(video_path):
        """The judge's encoding with the tower on its own mesh."""
        mesh, params = judge.mesh, judge.params
        judge.mesh, judge.params = tower_mesh, tower_shards
        try:
            return encode_video(video_path)
        finally:
            judge.mesh, judge.params = mesh, params

    judge._prep = functools.lru_cache(maxsize=8)(encode)
    eos = _eos_pad(cfg, unsharded.tokenizer)[0]
    fp32 = {**state, "language_model": {
        **state["language_model"],
        "tok_embeddings": state["language_model"]["tok_embeddings"].float()}}
    plain = judge_of(fp32, impl="plain", pixel_dtype=torch.float32)
    ref = mesh_judge_reference(unsharded, plain, videos, eos)
    del plain
    vis = [j._prep(videos[0])[0] for j in (judge, unsharded)]
    out["tower_rel_vs_unsharded"] = _rel_err(vis[0], vis[1])[1]
    del vis
    L_vit, L_llm = depth
    label = (f"internvl2-26b tower local(1, {MESH_26B_TOWER}), decoder "
             f"local(1, 2), at depths {depth}")
    want = _judge_launches(cfg, _with_prepass({
        "vit_attention": 2 * L_vit * MESH_26B_TOWER,
        "exact_attention": 3 * L_llm * 2}))
    judge._prep.cache_clear()
    judge._pstate.cache_clear()
    out[label], launches = mesh_judge_reading(
        label, judge, unsharded, ref, videos, eos, want)
    print(f"phase 34 {label}: the tower's output (mlp1) of a video against "
          f"the unsharded tower {out['tower_rel_vs_unsharded']:.4e} of "
          f"max|unsharded|; pairs split {out['tower_split']}")
    del judge, unsharded, state, tower, tower_shards, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out, {label: launches}


def judges_mesh_phase(dev, generator, drawer):
    """Phase 34: the kernel checks at the rank shapes (a generator of their
    own), then (b) the 2B judge, (c) the other families and (d) the 26B,
    each on fresh states.  Returns the readings, the kernel readings and
    the launch counts by path."""
    import gc

    import torch

    t0 = time.perf_counter()
    k34 = check_judge_mesh_kernels(drawer(generator()))
    out = {"kernel_checks_s": time.perf_counter() - t0}
    launches = {}
    for part, fn in (("internvl2b", internvl2b_mesh_phase),
                     ("families", families_mesh_phase),
                     ("internvl26b", internvl26b_mesh_phase)):
        t0 = time.perf_counter()
        got, more = fn(dev, generator)
        out.update(got)
        launches.update(more)
        out[f"{part}_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    launches = {f"mesh_judges {k}": v for k, v in launches.items()}
    return out, k34, launches


def phase_alone_setup(name):
    """For a tool that runs one phase alone (``tools/phase24_torch.py``,
    ``tools/phase25_torch.py``, ``tools/phase27_torch.py``,
    ``tools/phase28_torch.py``, ``tools/phase29_torch.py``,
    ``tools/phase30_torch.py``, ``tools/phase31_torch.py``): the card and
    its power limit printed, TF32 off, the kernels built and their ptxas report (a spill or a missing
    instantiation printed, not raised, so that the phase still runs), and
    the seeded generators as ``main`` makes them.  Returns (device,
    generator, drawer, ptxas), or None without CUDA."""
    import torch

    from mjvideo_tpu_torch import kernels

    if not torch.cuda.is_available():
        print(f"{name}: CUDA is not available", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    try:
        ptxas = sm90_ptxas(lib)
    except RuntimeError as e:
        print(f"ptxas check failed: {e}")
        ptxas = None

    def generator():
        return torch.Generator(device=dev).manual_seed(SEED)

    def drawer(g):
        return lambda *shape: torch.randn(shape, generator=g,
                                          device=dev).to(torch.bfloat16)

    return dev, generator, drawer, ptxas


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
    ptxas = sm90_ptxas(lib)

    def generator():
        # Each phase draws from its own generator, so the weights do not
        # depend on how many inputs the kernel checks drew before them.
        return torch.Generator(device=dev).manual_seed(SEED)

    def drawer(g):
        return lambda *shape: torch.randn(shape, generator=g,
                                          device=dev).to(torch.bfloat16)

    randn = drawer(generator())

    # Phases 2 and 3: each kernel against its plain twin, at serving's
    # shapes and at training's.
    train = train_data()
    train_shapes = train_decoder_shapes(*train)
    k1 = {s: check_vit_attention(randn, s) for s in K1_SHAPES}
    dec = {s: check_decoder_kernels(randn, s, ragged=True) for s in K2_SHAPES}
    dec.update({s: check_decoder_kernels(randn, s, ragged=False)
                for s in train_shapes})
    # The reward gradient's decoder: the single clip's prompt in its
    # bucket, drawn from a generator of its own, so that the checks after
    # it draw what they drew before it was added.
    grad_shape, grad_live = (1,) + K2_SHAPES[-1][1:], single_clip_length()
    dec[grad_shape] = check_decoder_kernels(drawer(generator()), grad_shape,
                                            ragged=False, live=grad_live)
    long_k2 = check_long_k2_op(drawer(generator()))
    # Phase 22's largest shapes: the pair's decoder at max_num 12, and its
    # 144 tiles through the ViT.
    frames_k2 = check_long_k2_op(drawer(generator()), *frames_decoder_shape())
    frames_k1_shape = (FRAME_TILES_MAX,) + K1_SHAPES[0][1:]
    k1[frames_k1_shape] = check_vit_attention(drawer(generator()),
                                              frames_k1_shape)
    judge_k = {name: check_judge_kernels(randn, name, shape)
               for name, shape in JUDGE_SHAPES.items()}
    turns = time_shifts_in_turns(randn)
    k1_turns = time_k1_in_turns(randn)
    check_k2r_prefix_rows(randn)
    quant_k = check_quant_kernels(randn, drawer(generator()))
    vit_bwd = {s: check_vit_backward(randn, s) for s in K1_SHAPES}
    # The tile edges and the timing in turns draw from generators of their
    # own, so that the checks after them draw what they drew before.
    k4nc_edges = check_k4nc_edges(drawer(generator()))
    k4nc_turns = time_k4nc_in_turns(drawer(generator()))
    k4_turns = time_k4_in_turns(drawer(generator()),
                                ((train_shapes[-1], None),
                                 (grad_shape, grad_live)))
    ring_k = check_ring_kernels(randn)
    chunks = time_k3_lse_chunks(drawer(generator()))
    # Phase 21: the ViT attention variants, then their A/B harnesses.
    t0 = time.perf_counter()
    variant_k = check_variant_kernels(randn)
    variant_out, variant_launches = variant_ab_phase(variant_k, dev)
    for name, row in variant_out["block_ab"].items():
        rel = row["max_abs_vs_first"] / row["first_update_max"]
        if not row["finite"] or not rel <= BLOCK_REL_TOL:
            raise RuntimeError(f"vit block A/B {name}: finite {row['finite']}"
                               f", {rel:.3e} of max|block(x) - x| against "
                               f"K1's block (bound {BLOCK_REL_TOL})")
    print(f"phase 21 command time {time.perf_counter() - t0:.1f} s")

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
    if len(requests[0][1][0]) != grad_live:
        raise RuntimeError(f"phase 3 checked the single clip at {grad_live} "
                           f"live keys, its prompt has {len(requests[0][1][0])}")

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    scores = [scorer.score_batch(*r).score for r in requests]
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    print(f"launches over {len(requests)} requests: {launches}")
    # Serving runs K1 and K2 (without the lse), each after its pre-pass,
    # and no backward kernel.
    want = _with_prepass({"vit_attention": 24 * len(requests),
                          "decoder_attention": 24 * len(requests)})
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise RuntimeError(f"{name}: {n} launches, want "
                               f"{want.get(name, 0)}")
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

    delta, _, fp32_scores = plain_score_delta(scorer, requests, scores)
    if not delta < SCORE_TOL:
        raise RuntimeError(f"score delta {delta} >= {SCORE_TOL}")
    # Phase 22: serving from a checkpoint directory and from decoded frames;
    # phase 23 (the benchmark harness and the CLIs) reads the same directory.
    with tempfile.TemporaryDirectory() as export_dir:
        t0 = time.perf_counter()
        ckpt_out, ckpt_launches = checkpoint_phase(scorer, requests, scores,
                                                   dev, export_dir)
        frames_out, frames_launches = frames_phase(scorer, requests, dev)
        sweep_out, sweep_launches = microbatch_sweep(scorer, dev)
        print(f"phase 22 command time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        harness_out, harness_launches = eval_harness_phase(scorer, export_dir,
                                                           dev)
        harness_out["command_s"] = time.perf_counter() - t0
        print(f"phase 23 command time {harness_out['command_s']:.1f} s")
        # Phase 32: the serving example on the same directory.
        t0 = time.perf_counter()
        serve_out, serve_launches = serving_example_phase(scorer, export_dir,
                                                          dev)
        print(f"phase 32 command time {time.perf_counter() - t0:.1f} s")
    # Phase 18: sequence-parallel scoring on the same bf16 state.
    sp_scored, sp_score_launches = sp_scoring_phase(
        scorer, requests, scores, fp32_scores, pair_s * 1e3, peak, dev)
    # Phase 11: quantized serving on the same bf16 state.
    quant_scored, quant_launches = quant_scoring_phase(scorer, requests,
                                                       fp32_scores, dev)
    # Phases 14 and 15: the reward gradient and the VADER loop.
    grad_out, grad_launches = reward_gradient_phase(scorer, requests[0], dev)
    vader_out, vader_launches = vader_phase(scorer, dev)
    # Phase 20: the long-context reading, with and without the ring.
    long_out, long_launches = long_context_phase(scorer, dev)
    # Phase 33 (a) and (b): the mesh's scoring on the same bf16 state; its
    # kernels at the head counts of a model rank of 2.
    t0 = time.perf_counter()
    mesh_k = check_mesh_kernels(drawer(generator()), mesh_train_data()[1],
                                scorer.cfg)
    mesh_out, mesh_launches = mesh_scoring_phase(scorer, requests,
                                                 scores[-2:], dev)
    mesh_s = time.perf_counter() - t0
    print(f"phase 33 (a), (b) and its kernel checks: {mesh_s:.1f} s")
    del scorer, requests
    torch.cuda.empty_cache()

    # Phases 5-7: training, the gradient against fp32 plain, then timing;
    # phase 19 (sequence-parallel training) on phase 6's weights and batch.
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer, batches, train_launches, train_peak = run_training(
            generator(), dev, ckpt_dir, train)
        plain_grads = gradient_fidelity(trainer, batches[0])[-1]
        f4 = f4_budget_phase(trainer, batches[0])
        sp_trained, sp_train_launches = sp_training_phase(
            trainer.cfg, trainer.params, trainer.tc, batches[0], plain_grads,
            dev)
        del plain_grads
        torch.cuda.empty_cache()
        train_ms = time_training(trainer, batches)
    del trainer, batches
    torch.cuda.empty_cache()

    # Phase 9: the judge at the 2B widths and depths.
    judged_out, judge_launches = judge_phase(dev)
    # Phase 12: the judge in int4 weight-only.
    quant_judged, quant_judge_launches = quant_judge_phase(
        dev, judged_out["decode_step_ms"])
    # Phase 24: MJ-VIDEO-4B, once the earlier phases' states are freed.
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out_4b, d96, launches_4b = mjvideo_4b_phase(dev, generator, drawer)
    # Phase 25: MJ-VIDEO-4B's gradients and training, on a fresh state.
    gc.collect()
    torch.cuda.empty_cache()
    out_25, grad96, launches_25 = mjvideo_4b_grad_phase(dev, generator,
                                                        drawer)
    # Phase 26: the new kernel forms, the 4B judge under the per-row bound,
    # the Qwen2-VL judge and its CLI, on fresh states.
    gc.collect()
    torch.cuda.empty_cache()
    out_26, k26, launches_26 = qwen2vl_phase(dev, generator, drawer)
    # Phase 27: SigLIP's K1 at D = 72 and K1m, VideoScore, MiniCPM-V-2.6
    # and their CLI, on fresh states.
    gc.collect()
    torch.cuda.empty_cache()
    out_27, k27, launches_27 = siglip_phase(dev, generator, drawer)
    # Phase 28: K3 at the EVA2-CLIP-E tower's D = 112, the CogVLM2-Video
    # judge and its CLI, on fresh states.
    gc.collect()
    torch.cuda.empty_cache()
    out_28, k28, launches_28 = cogvlm2_phase(dev, generator, drawer)
    # Phase 29: K1 at InternViT-6B's D = 128, the InternVL2-26B and -8B
    # judges and the CLI, on fresh states.
    gc.collect()
    torch.cuda.empty_cache()
    out_29, k29, launches_29 = internvl_phase(dev, generator, drawer)
    # Phase 30: the training options at the 2B widths, on fresh states.
    gc.collect()
    torch.cuda.empty_cache()
    out_30, launches_30 = training_options_phase(dev, generator)
    # Phase 31: LoRA and QLoRA training at the 2B widths, on fresh states.
    gc.collect()
    torch.cuda.empty_cache()
    out_31, launches_31 = lora_phase(dev, generator)
    # Phase 33 (c) and (d): training on the mesh and the dry run.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_tail, more = mesh_phase_tail(dev, generator)
    mesh_launches.update(more)
    mesh_out.update(mesh_tail)
    mesh_out["command_s"] = mesh_s + time.perf_counter() - t0
    print(f"phase 33 command time {mesh_out['command_s']:.1f} s")
    # Phase 34: the judges on a (data, model) mesh, on fresh states.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    judges_mesh_out, k34, launches_34 = judges_mesh_phase(dev, generator,
                                                          drawer)
    judges_mesh_out["command_s"] = time.perf_counter() - t0
    print(f"phase 34 command time {judges_mesh_out['command_s']:.1f} s")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "mjvideo_tpu"))
    if loaded:
        raise RuntimeError(f"the port imported {loaded}")

    by_path = {"serving": launches, "training": train_launches,
               **judge_launches, **quant_launches, **quant_judge_launches,
               "reward_gradient": grad_launches, "vader": vader_launches,
               **sp_score_launches, **sp_train_launches, **long_launches,
               **ckpt_launches, **frames_launches, **sweep_launches,
               **harness_launches, **launches_4b, **launches_25,
               **launches_26, **launches_27, **launches_28, **launches_29,
               **launches_30, **launches_31,
               "serving_example": serve_launches, **mesh_launches,
               **launches_34}

    def counts(name):
        paths = {path: n[name] for path, n in by_path.items()}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    def ab_counts(name):
        # Phase 21's harnesses, the path of the three ViT attention variants.
        paths = {path: n[name] for path, n in variant_launches.items()}
        return {"launches": sum(paths.values()), "launches_by_path": paths,
                "on_main_path": False}

    def by_key(prefix, keys):
        return {str(key): {f: variant_k[prefix, key][f] for f in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "device_ms") if f in variant_k[prefix, key]} for key in keys}

    hp = variant_out["block_hp"]

    def brief(r):
        return {f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_share")}

    gathered = [r * (SP_T // SP_SHARDS) for r in SP_GATHER_RANKS]
    served, trained = K2_SHAPES[-1], train_shapes[-1]
    ring_l = SP_T // SP_SHARDS
    lse = dec[trained]["K2 lse"]
    judged = JUDGE_SHAPES["prefill"][:6]
    served_k1 = k1[K1_SHAPES[0]]
    served_96 = D96_K2_SHAPES[-1]
    k2_96, turns_96 = d96["K2"][served_96], d96["turns"]
    trained_96 = grad96["train_shapes"][-1]  # the 4B's longest prompt
    dec_96 = grad96["dec"][trained_96]
    ring_96 = grad96["ring"]
    k4_96 = grad96["k4_turns"]
    k1_80 = k26["K1"][QWEN_K1_SHAPES[0]]
    k1_72 = k27["K1"][SIGLIP_K1_SHAPES[0]]
    k1m = k27["K1m"]
    k3_112 = k28["K3"][COG_K3_SHAPES[0]]
    k1_128 = k29["K1"][IVL_K1_SHAPES[0]]
    rows_96 = k26["K2r ragged"][D96_K2_SHAPES[-1]]
    summary = {"kernels": [
        {"name": "vit_attention", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:99",
         **counts("vit_attention"), "shape": K1_SHAPES[0],
         **served_k1["K1"], "kernel_alone": brief(served_k1["K1 kernel"]),
         "kernel_ms_in_turns": k1_turns["K1"],
         "op_ms_in_turns": k1_turns["K1 op"],
         "op_device_ms": k1_turns["K1 op device_ms"],
         "op_back_to_back_ms": k1_turns["K1 op back_to_back_ms"],
         "sdpa_ms_in_turns": k1_turns["SDPA"],
         "at_shapes": {str(sh): {n: brief(r[n]) for n in ("K1", "K1 kernel")}
                       for sh, r in k1.items()}},
        {"name": "vit_attention_lse", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:153",
         **counts("vit_attention_lse"), "shape": K1_SHAPES[0],
         **vit_bwd[K1_SHAPES[0]]["K1 lse"],
         "kernel_ms_in_turns": k1_turns["K1 lse"],
         "op_ms_in_turns": k1_turns["K1 lse op"],
         "k1_kernel_ms_in_turns": k1_turns["K1"],
         "sdpa_ms_in_turns": k1_turns["SDPA"],
         "at_shapes": {str(sh): brief(r["K1 lse"])
                       for sh, r in vit_bwd.items()}},
        {"name": "vit_attention_bwd_dkdv", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/attention_bwd_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:603",
         **counts("vit_attention_bwd_dkdv"), "shape": K1_SHAPES[0],
         **vit_bwd[K1_SHAPES[0]]["K4 nc dkdv"],
         "kernel_ms_in_turns": k4nc_turns["K4 nc dkdv"],
         "sdpa_backward_ms_in_turns": k4nc_turns["SDPA backward"],
         "pair_over_sdpa_backward": k4nc_turns["pair / SDPA backward"],
         "at_shapes": {str(sh): brief(r["K4 nc dkdv"])
                       for sh, r in vit_bwd.items()},
         "tile_edges_rel_err": k4nc_edges},
        {"name": "vit_attention_bwd_dq", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/attention_bwd_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:656",
         **counts("vit_attention_bwd_dq"), "shape": K1_SHAPES[0],
         **vit_bwd[K1_SHAPES[0]]["K4 nc dq"],
         "kernel_ms_in_turns": k4nc_turns["K4 nc dq"],
         "sdpa_backward_ms_in_turns": k4nc_turns["SDPA backward"],
         "at_shapes": {str(sh): brief(r["K4 nc dq"])
                       for sh, r in vit_bwd.items()}},
        {"name": "decoder_attention", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:318",
         **counts("decoder_attention"), "shape": served, **dec[served]["K2"],
         "kernel_alone": brief(dec[served]["K2 kernel"]),
         "kernel_ms_in_turns": turns["K2"], "op_ms_in_turns": turns["K2 op"],
         "op_device_ms": turns["K2 op device_ms"],
         "op_back_to_back_ms": turns["K2 op back_to_back_ms"],
         "long_clip_op": long_k2["op"],
         "frames_pair_op": frames_k2["op"],
         "sdpa_ms_in_turns": turns["SDPA"], "turns_shape": judged,
         "at_shapes": {str(sh): {n: brief(r[n]) for n in ("K2", "K2 kernel")}
                       for sh, r in dec.items()}},
        # The pre-pass of K1 and K2 (and their lse forms): kmax on the card,
        # the XLA reduce of the TPU path and _fwd_nc_kernel's in-kernel max.
        # "ms" is the standalone call (partial pass and fold, host
        # included), "device_ms" the partial pass a launch (the ops' part).
        {"name": "key_norm_max", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:484",
         "design": "partial maxima per chunk of keys, plain stores (no "
                   "memset, no atomics), folded by the attention kernel "
                   "after griddepcontrol.wait (programmatic dependent "
                   "launch)",
         **counts("key_norm_max"), "shape": served,
         **dec[served]["K2 pre-pass"],
         "ms_in_turns": turns["pre-pass"], "turns_shape": judged,
         "vit": {"shape": K1_SHAPES[0], **brief(served_k1["K1 pre-pass"]),
                 **{f: served_k1["K1 pre-pass"][f] for f in (
                     "device_ms", "fold_device_ms", "parts")},
                 "ms_in_turns": k1_turns["pre-pass"]},
         "long_clip": {"shape": (1,) + LONG_KEYS[:1] + (16, 8, 128),
                       **brief(long_k2["pre-pass"]),
                       **{f: long_k2["pre-pass"][f] for f in (
                           "device_ms", "parts")}},
         "frames_pair": {"shape": frames_decoder_shape()[0],
                         **brief(frames_k2["pre-pass"]),
                         **{f: frames_k2["pre-pass"][f] for f in (
                             "device_ms", "parts")}},
         "at_shapes": {str(sh): brief(r["K2 pre-pass"]) | {
             "device_ms": r["K2 pre-pass"]["device_ms"]}
             for sh, r in dec.items()}},
        {"name": "decoder_attention_lse", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:407",
         **counts("decoder_attention_lse"), "shape": trained, **lse,
         "kernel_ms_in_turns": turns["K2 lse"],
         "op_ms_in_turns": turns["K2 lse op"],
         "k2_kernel_ms_in_turns": turns["K2"],
         "sdpa_ms_in_turns": turns["SDPA"], "turns_shape": judged,
         "at_shapes": {str(sh): brief(r["K2 lse"]) for sh, r in dec.items()}},
        {"name": "decoder_attention_bwd_dkdv", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/attention_bwd_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/decoder_attention_bwd.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:603",
         **counts("decoder_attention_bwd_dkdv"), "shape": trained,
         **dec[trained]["K4a"],
         "at_shapes": {str(sh): brief(r["K4a"]) for sh, r in dec.items()},
         "in_turns": {sh: {"ms": r["ms"]["K4a"],
                           "bound_ms": r["bound_ms"]["K4a"],
                           "sdpa_backward_ms": r["ms"]["SDPA backward"]}
                      for sh, r in k4_turns.items()}},
        {"name": "decoder_attention_bwd_dq", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/attention_bwd_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/decoder_attention_bwd.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:656",
         **counts("decoder_attention_bwd_dq"), "shape": trained,
         **dec[trained]["K4b"],
         "at_shapes": {str(sh): brief(r["K4b"]) for sh, r in dec.items()},
         "in_turns": {sh: {"ms": r["ms"]["K4b"],
                           "bound_ms": r["bound_ms"]["K4b"],
                           "sdpa_backward_ms": r["ms"]["SDPA backward"],
                           "pair_over_sdpa_backward":
                           r["pair_over_sdpa_backward"]}
                      for sh, r in k4_turns.items()}},
        {"name": "exact_attention", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:260",
         **counts("exact_attention"), "shape": judged,
         **judge_k["prefill"]["K3"], "kernel_ms_in_turns": turns["K3"],
         "k2_kernel_ms_in_turns": turns["K2"],
         "sdpa_ms_in_turns": turns["SDPA"],
         "at_shapes": {n: brief(r["K3"]) for n, r in judge_k.items()},
         "all_gather": {str(o): brief(ring_k["K3 all-gather", o])
                        for o in gathered}},
        {"name": "exact_attention_lse", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:526",
         **counts("exact_attention_lse"),
         "shape": (1, ring_l, ring_l, 16, 8, 128), "rel_off": ring_l,
         **ring_k["K3 lse", ring_l],
         "kernel_ms_in_turns": turns["K3 lse"], "turns_shape": judged,
         "k3_kernel_ms_in_turns": turns["K3"],
         "chunks_in_turns": {str(n): r for n, r in chunks.items()},
         "at_offsets": {str(o): brief(ring_k["K3 lse", o]) for o in (
             (my - src) * ring_l for my, src in SP_CHUNKS)}},
        {"name": "decoder_attention_rows", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:318",
         **counts("decoder_attention_rows"), "shape": judged,
         **judge_k["prefill"]["K2r"], "kernel_ms_in_turns": turns["K2r"],
         "op_ms_in_turns": turns["K2r op"],
         "op_device_ms": turns["K2r op device_ms"],
         "kernel_device_ms": turns["K2r device_ms"],
         "kernel_alone": brief(judge_k["prefill"]["K2r kernel"]),
         "op_against_kernel_alone": judge_k["prefill"]["K2r op"],
         "at_shapes": {n: brief(r["K2r"]) for n, r in judge_k.items()}},
        # K2r's pre-pass, its bound column (the XLA reduce of the TPU path).
        {"name": "key_norm_cummax", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:489",
         "design": "the partial pass storing each key's norm and its "
                   "chunk's max, plain stores; a scan per (chunk, b) as its "
                   "programmatic dependent; K2r launched behind the scan",
         **counts("key_norm_cummax"), "shape": judged,
         **judge_k["prefill"]["K2r pre-pass"],
         "ms_in_turns": turns["K2r pre-pass"],
         "at_shapes": {n: brief(r["K2r pre-pass"]) | {f: r["K2r pre-pass"][
             f] for f in ("device_ms", "partial_device_ms", "scan_device_ms",
                          "parts")} for n, r in judge_k.items()}},
        # The D = 96 forms (MJ-VIDEO-4B's Phi-3 decoder, phase 24): the
        # same template at Config D96, launched through the same entries.
        {"name": "decoder_attention_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:318",
         **counts("decoder_attention_d96"), "shape": served_96,
         **k2_96["K2"], "kernel_alone": brief(k2_96["K2 kernel"]),
         "kernel_ms_in_turns": turns_96["K2"],
         "op_ms_in_turns": turns_96["K2 op"],
         "op_device_ms": turns_96["K2 op device_ms"],
         "op_back_to_back_ms": turns_96["K2 op back_to_back_ms"],
         "sdpa_ms_in_turns": turns_96["SDPA"],
         "at_shapes": {str(sh): {n: brief(r[n]) for n in ("K2", "K2 kernel")}
                       for sh, r in d96["K2"].items()}},
        {"name": "key_norm_max_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:484",
         "design": "key_norm_partial_kernel<96>: 16 lanes a key vector, 4 "
                   "of them loading nothing; the op's partials folded by "
                   "K2 after griddepcontrol.wait",
         **counts("key_norm_max_d96"), "shape": served_96,
         **k2_96["K2 pre-pass"], "ms_in_turns": turns_96["pre-pass"],
         "at_shapes": {str(sh): brief(r["K2 pre-pass"]) | {
             "device_ms": r["K2 pre-pass"]["device_ms"]}
             for sh, r in d96["K2"].items()}},
        {"name": "exact_attention_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/exact_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:260",
         **counts("exact_attention_d96"),
         "shape": D96_K3_SHAPES["prefill"][:6], **d96["K3"]["prefill"],
         "kernel_ms_in_turns": turns_96["K3"],
         "kernel_device_ms": turns_96["K3 device_ms"],
         "sdpa_ms_in_turns": turns_96["SDPA"], "turns_shape": served_96,
         "at_shapes": {n: brief(r) for n, r in d96["K3"].items()}},
        # The D = 96 gradient forms (MJ-VIDEO-4B's reward gradient, VADER
        # and training, phase 25): K2 lse and K3 lse on Config D96's lse
        # epilogue, K4a and K4b on the backward template's DkdvD96/DqD96.
        {"name": "decoder_attention_lse_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:407",
         **counts("decoder_attention_lse_d96"), "shape": trained_96,
         **dec_96["K2 lse"],
         "in_turns": grad96["k2_lse_turns"],
         "at_shapes": {str(sh): brief(r["K2 lse"])
                       for sh, r in grad96["dec"].items()}},
        {"name": "exact_attention_lse_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/exact_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:526",
         **counts("exact_attention_lse_d96"),
         "shape": (1, ring_l, ring_l) + trained_96[2:], "rel_off": ring_l,
         **ring_96["K3 lse", ring_l],
         "chunk_in_turns": {str(n): r for n, r in
                            grad96["k3_lse_turns"].items()},
         "at_offsets": {str(o): brief(ring_96["K3 lse", o]) for o in (
             (my - src) * ring_l for my, src in SP_CHUNKS)}},
        {"name": "decoder_attention_bwd_dkdv_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/attention_bwd_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/decoder_attention_bwd.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:603",
         **counts("decoder_attention_bwd_dkdv_d96"), "shape": trained_96,
         **dec_96["K4a"],
         "at_shapes": {str(sh): brief(r["K4a"])
                       for sh, r in grad96["dec"].items()},
         "at_offsets": {str(o): brief(ring_96["K4a", o]) for o in (
             (my - src) * ring_l for my, src in SP_CHUNKS)},
         "in_turns": {sh: {"ms": r["ms"]["K4a"],
                           "bound_ms": r["bound_ms"]["K4a"],
                           "sdpa_backward_ms": r["ms"]["SDPA backward"]}
                      for sh, r in k4_96.items()}},
        {"name": "decoder_attention_bwd_dq_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/attention_bwd_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/decoder_attention_bwd.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:656",
         **counts("decoder_attention_bwd_dq_d96"), "shape": trained_96,
         **dec_96["K4b"],
         "at_shapes": {str(sh): brief(r["K4b"])
                       for sh, r in grad96["dec"].items()},
         "at_offsets": {str(o): brief(ring_96["K4b", o]) for o in (
             (my - src) * ring_l for my, src in SP_CHUNKS)},
         "in_turns": {sh: {"ms": r["ms"]["K4b"],
                           "bound_ms": r["bound_ms"]["K4b"],
                           "sdpa_backward_ms": r["ms"]["SDPA backward"],
                           "pair_over_sdpa_backward":
                           r["pair_over_sdpa_backward"]}
                      for sh, r in k4_96.items()}},
        # Phase 26's forms: K1 at the Qwen2-VL vision tower's D = 80
        # (Config D80, D128's layout) and its pre-pass at 16 lanes a key;
        # K2r at D = 96 (Config D96) and its pre-pass with the norms.
        {"name": "vit_attention_d80", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/vit_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:99",
         **counts("vit_attention_d80"), "shape": QWEN_K1_SHAPES[0],
         **k1_80["K1"], "kernel_alone": brief(k1_80["K1 kernel"]),
         "at_shapes": {str(sh): {n: brief(r[n]) for n in ("K1", "K1 kernel")}
                       for sh, r in k26["K1"].items()}},
        {"name": "key_norm_max_d80", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:131",
         "design": "key_norm_partial_kernel<80>: 16 lanes a key vector, 6 "
                   "of them adding nothing; the op's partials folded by K1 "
                   "after griddepcontrol.wait",
         **counts("key_norm_max_d80"), "shape": QWEN_K1_SHAPES[0],
         **k1_80["K1 pre-pass"],
         "at_shapes": {str(sh): brief(r["K1 pre-pass"]) | {
             "device_ms": r["K1 pre-pass"]["device_ms"]}
             for sh, r in k26["K1"].items()}},
        {"name": "decoder_attention_rows_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:318",
         **counts("decoder_attention_rows_d96"), "shape": D96_K2_SHAPES[-1],
         **rows_96["K2r"], "kernel_alone": brief(rows_96["K2r kernel"]),
         "at_shapes": {str(sh): {n: brief(r[n]) for n in ("K2r",
                                                          "K2r kernel")}
                       for sh, r in k26["K2r ragged"].items()},
         "at_judge_shapes": {n: brief(r["K2r"])
                             for n, r in k26["K2r judge"].items()}},
        {"name": "key_norm_cummax_d96", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:489",
         "design": "key_norm_partial_kernel<96, true>: 16 lanes a key "
                   "vector, each key's norm stored; the scan as its "
                   "programmatic dependent, K2r behind the scan",
         **counts("key_norm_cummax_d96"), "shape": D96_K2_SHAPES[-1],
         **rows_96["K2r pre-pass"],
         "at_judge_shapes": {n: brief(r["K2r pre-pass"])
                             for n, r in k26["K2r judge"].items()}},
        # Phase 27's forms: K1 at SigLIP-so400m's D = 72 (Config D72,
        # D128's layout, q k^T over 5 k-steps) and its pre-pass; K1m, K2's
        # masked path not causal at D = 72, and its masked pre-pass.
        {"name": "vit_attention_d72", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/vit_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:99",
         **counts("vit_attention_d72"), "shape": SIGLIP_K1_SHAPES[0],
         **k1_72["K1"], "kernel_alone": brief(k1_72["K1 kernel"]),
         "at_shapes": {str(sh): {n: brief(r[n]) for n in ("K1", "K1 kernel")}
                       for sh, r in k27["K1"].items()}},
        {"name": "key_norm_max_d72", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:131",
         "design": "key_norm_partial_kernel<72>: 16 lanes a key vector, 7 "
                   "of them adding nothing; the op's partials folded by K1 "
                   "or K1m after griddepcontrol.wait",
         **counts("key_norm_max_d72"), "shape": SIGLIP_K1_SHAPES[0],
         **k1_72["K1 pre-pass"],
         "at_shapes": {str(sh): brief(r["K1 pre-pass"]) | {
             "device_ms": r["K1 pre-pass"]["device_ms"]}
             for sh, r in k27["K1"].items()}},
        {"name": "vit_attention_masked", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:318",
         **counts("vit_attention_masked"),
         "shape": (VS_SPLIT_FRAMES * 5, 2730, 16, 72), **k1m["K1m"],
         "kernel_alone": brief(k1m["K1m kernel"])},
        {"name": "key_norm_max_masked_d72", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:484",
         "design": "key_norm_partial_kernel<72> with the patch mask: a "
                   "padded patch's key gives nothing; folded by K1m",
         **counts("key_norm_max_masked_d72"),
         "shape": (VS_SPLIT_FRAMES * 5, 2730, 16, 72),
         **k1m["K1m pre-pass"]},
        # Phase 28's form: K3 not causal at the EVA2-CLIP-E tower's
        # D = 112 (Config D112, D128's layout, q k^T over 7 k-steps).
        {"name": "exact_attention_d112", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/exact_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:99",
         **counts("exact_attention_d112"), "shape": COG_K3_SHAPES[0],
         **{f: k3_112[f] for f in ("max_abs_err", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "bound_share")},
         **{f: k3_112[f] for f in ("ms_in_turns", "sdpa_ms_in_turns",
                                   "plain_ms_in_turns", "device_ms",
                                   "back_to_back_ms")},
         "at_shapes": {str(sh): brief(r) for sh, r in k28["K3"].items()}},
        # Phase 29's form: K1 at InternViT-6B's D = 128 (Config D128, K2's,
        # not causal and floored), q and k dense, v a view into qkv.
        {"name": "vit_attention_d128", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/vit_attention.cu",
         "replaces": "mjvideo_tpu/ops/flash_attention.py:99",
         **counts("vit_attention_d128"), "shape": IVL_K1_SHAPES[0],
         **k1_128["K1"], "kernel_alone": brief(k1_128["K1 kernel"]),
         "pre_pass": brief(k1_128["K1 pre-pass"]) | {
             f: k1_128["K1 pre-pass"][f] for f in ("device_ms", "parts")},
         "in_turns": k1_128["turns"],
         "at_shapes": {str(sh): {n: brief(r[n]) for n in ("K1", "K1 kernel")}
                       for sh, r in k29["K1"].items()}},
        {"name": "q8g_matmul_fused", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/q8g_matmul.cu",
         "replaces": "mjvideo_tpu/ops/quant.py:316",
         **counts("q8g_matmul_fused"), "shape": Q8G_SHAPES[1],
         **quant_k["K6", Q8G_SHAPES[1]],
         "at_shapes": {str(sh): brief(quant_k["K6", sh]) | {
             f: quant_k["K6", sh][f] for f in (
                 "ms_in_turns", "bf16_matmul_ms_in_turns",
                 "int_mm_ms_in_turns", "device_ms_by_kernel",
                 "back_to_back_ms")} for sh in Q8G_SHAPES}},
        # K6's pre-pass: x quantized once per (row, group); the TPU kernel
        # did it inside _q8g_matmul_pallas_fused.
        {"name": "q8g_quantize", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/q8g_matmul.cu",
         "replaces": "mjvideo_tpu/ops/quant.py:316",
         "design": "each group's pieces in registers of a few lanes, the "
                   "amax by shuffles, 8-byte stores, several rows a CTA; "
                   "K6's GEMM launched behind it as a programmatic "
                   "dependent",
         **counts("q8g_quantize"), "shape": Q8G_SHAPES[1][:2],
         **quant_k["K6 pre-pass", Q8G_SHAPES[1]],
         "at_shapes": {str(sh[:2]): brief(quant_k["K6 pre-pass", sh]) | {
             f: quant_k["K6 pre-pass", sh][f] for f in (
                 "device_ms", "ms_in_turns")} for sh in Q8G_SHAPES}},
        # K6's oracle, as in the JAX package: not on the main path.
        {"name": "q8g_matmul", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/q8g_matmul.cu",
         "replaces": "mjvideo_tpu/ops/quant.py:423",
         **counts("q8g_matmul"), "on_main_path": False,
         "shape": Q8G_SHAPES[1], **quant_k["K7", Q8G_SHAPES[1]],
         "at_shapes": {str(sh): brief(quant_k["K7", sh]) | {
             "device_ms": quant_k["K7", sh]["device_ms"]}
             for sh in Q8G_SHAPES}},
        # K5: mma.m16n8k16 on a k-major nibble layout, K split over a
        # cluster where the columns are few; "ms" is the op (host
        # included), "device_ms_cold" a launch with the L2 cold.
        {"name": "w4_matmul", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/w4_matmul.cu",
         "replaces": "mjvideo_tpu/ops/quant4.py:177",
         **counts("w4_matmul"), "shape": (2, 2048, 8192),
         **quant_k["K5", (2, 2048, 8192)],
         "at_shapes": {str((M,) + sh): brief(quant_k["K5", (M,) + sh]) | {
             f: quant_k["K5", (M,) + sh][f] for f in (
                 "device_ms_cold", "bound_share_cold", "library_ms_cold",
                 "bf16_matmul_ms", "bit_identical")}
             for sh in W4_SHAPES for M in W4_ROWS}},
        # The A/B harnesses' kernels (phase 21): not on the main path.  B1,
        # B2 and B3 run the sm90 forward template through
        # vit_attention_variants.cu's entries.
        {"name": "vit_attention_variant", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/vit_attention_variants.cu",
         "template": "sm90 (wgmma, TMA, online softmax)",
         "replaces": "benchmarks/vit_attn_variants.py:63",
         **ab_counts("vit_attention_variant"), "shape": VARIANT_SHAPE,
         "mode": "exp2", **variant_k["B1", "exp2"],
         "modes": by_key("B1", kernels.VARIANT_MODES)},
        {"name": "vit_attention_tmajor", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/vit_attention_variants.cu",
         "template": "sm90 (wgmma, TMA, online softmax)",
         "replaces": "benchmarks/vit_attn_variants.py:150",
         **ab_counts("vit_attention_tmajor"), "shape": VARIANT_SHAPE,
         "hp": hp, **variant_k["B2", hp],
         "hps": by_key("B2", kernels.TMAJOR_HP)},
        {"name": "vit_attention_bshd", "route": "cuda",
         "source": "mjvideo_tpu_torch/csrc/decoder_attention_sm90.cuh",
         "entry": "mjvideo_tpu_torch/csrc/vit_attention_variants.cu",
         "template": "sm90 (wgmma, TMA, online softmax): B2's hp 1 over "
                     "kv_valid keys",
         "replaces": "benchmarks/vit_layout_ab.py:72",
         **ab_counts("vit_attention_bshd"),
         "shape": VARIANT_SHAPE[:1] + (VARIANT_PADDED,) + VARIANT_SHAPE[2:],
         "kv_valid": VARIANT_SHAPE[1], **variant_k["B3", VARIANT_PADDED],
         "at_s": by_key("B3", (VARIANT_SHAPE[1], VARIANT_PADDED))},
    ], "vit_attention_ab": {
        "attention_ab_ms": variant_out["attention_ab_ms"],
        "block_ab": {n: {f: r[f] for f in r if f != "ms_all"}
                     for n, r in variant_out["block_ab"].items()}},
        "training": {**train_ms, "peak_gib": train_peak / 2**30},
        "f4_reading": f4,
        "judge": judged_out, "quantized_scoring": quant_scored,
        "quantized_judge": quant_judged, "reward_gradient": grad_out,
        "vader": vader_out, "sp_scoring": sp_scored, "ptxas": ptxas,
        "sp_training": sp_trained, "long_context": long_out,
        "serving_from_files": {"checkpoint": ckpt_out, "frames": {
            str(k): v for k, v in frames_out.items()},
            "device_batch_sweep": {str(k): v for k, v in sweep_out.items()}},
        "eval_harness": harness_out, "mjvideo_4b": out_4b,
        "mjvideo_4b_gradients": out_25, "qwen2vl": out_26,
        "siglip_judges": out_27, "cogvlm2": out_28, "internvl": out_29,
        "training_options": out_30, "lora": out_31,
        "serving_example": serve_out, "mesh": mesh_out,
        "mesh_kernels": {f"{name} {shape}": {f: r.get(f) for f in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")}
            for (name, shape), r in mesh_k.items() if isinstance(r, dict)},
        "mesh_judges": judges_mesh_out,
        "mesh_judge_kernels": {f"{name} {shape}": {f: r.get(f) for f in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")}
            for (name, shape), r in k34.items() if isinstance(r, dict)},
        "qwen2vl_decoder_kernels": {f"{size} {name}": {
            n: brief(r[n]) for n in ("K3", "K2r", "K2r kernel")}
            for (size, name), r in k26["qwen"].items()},
        "sp_kernels": {f"{name} {off}": {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")}
            for (name, off), r in ring_k.items()}}
    idle = [k["name"] for k in summary["kernels"]
            if k.get("on_main_path", True) and k["launches"] == 0]
    if idle:
        raise RuntimeError(f"kernels of the main path never launched: {idle}")
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
