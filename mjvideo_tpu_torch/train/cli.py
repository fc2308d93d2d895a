"""Training CLI: ``python -m mjvideo_tpu_torch.train.cli --stage {1,2,3} ...``

The port's counterpart of ``mjvideo_tpu/train/cli.py``, which replaces the
reference's per-stage argparse mains and launch scripts
(``scripts/train/{criteria,aspect,overall}_train.py`` ``:13-63``,
``*.sh:1-13``).  One entry point covers the three stages: the dataset
(``data.dataset``) -> ``Trainer.train`` -> ``Trainer.save`` ->
``Trainer.evaluate`` on ``--eval-json``, once per epoch.

It runs on the card (``--device cuda``, the default; a machine without one
refuses) unless ``--device cpu`` asks for the CPU.  ``--attn`` keeps the
JAX choices: ``auto`` and ``flash`` run the hand-written kernels
(``attn_impl="auto"``), ``xla`` the exact-softmax oracle
(``attn_impl="plain"``).  ``--optimizer adafactor``, ``--bf16-adam-mu``,
``--async-checkpoint``, ``--remat-policy dots`` and ``--lora-rank`` /
``--lora-alpha`` (LoRA adapters on the decoder's attention and MLP
kernels, ``ops/lora.py``) are the trainer's options of those names.  A
``--warm-start`` from a LoRA run's checkpoint, whose kernels are LoRA
nodes, fails on the unwrapped state; with ``--lora-rank`` > 0 the CLI then
wraps first and warm-starts again (``mjvideo_tpu/train/cli.py:145-160``),
so the checkpoint's adapters replace the fresh ones.  ``--tp`` and
``--dp`` build a (data, model) mesh (``parallel.mesh.make_mesh``): in one
process ``Mesh.local(dp, tp)`` (``--dp -1`` means 1), every shard on the
one card in turn; under ``torchrun --nproc-per-node n`` (which sets
``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``; ``parallel.maybe_initialize``
joins the group first) ``Mesh.distributed`` over the n processes, one card
each (``--dp -1``: n / tp), rank 0 writing the checkpoints and metrics.
Each micro-batch of ``--batch-size`` pairs splits over the data axis, so
the data axis must divide it.  ``--zero1`` keeps each data rank's slice of
the optimizer state only (ZeRO-1).  ``--lora-rank`` trains under any
``--tp`` and ``--dp``: the adapters split with their kernels.
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.prompts import load_tokenizer
from ..utils.device import resolve_device

# The reference stage scripts' training defaults
# (criteria/aspect/overall_train.py argparse blocks): lr 3e-5, cosine
# schedule, weight decay 0.1, 3 epochs for every stage; warmup and
# accumulation differ per stage.
REFERENCE_STAGE_DEFAULTS = {
    1: dict(learning_rate=3e-5, weight_decay=0.1, schedule="cosine",
            num_epochs=3, warmup_steps=25, gradient_accumulation_steps=8),
    2: dict(learning_rate=3e-5, weight_decay=0.1, schedule="cosine",
            num_epochs=3, warmup_steps=50, gradient_accumulation_steps=8),
    3: dict(learning_rate=3e-5, weight_decay=0.1, schedule="cosine",
            num_epochs=3, warmup_steps=5, gradient_accumulation_steps=4),
}

# --attn (the JAX package's choices) -> TrainConfig.attn_impl.
ATTN_IMPLS = {"auto": "auto", "flash": "auto", "xla": "plain"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MJ-Video trainer (PyTorch)")
    p.add_argument("--stage", type=int, choices=(1, 2, 3), required=True,
                   help="1=criteria, 2=aspect, 3=overall")
    p.add_argument("--train-json", required=True)
    p.add_argument("--optimizer", default="adamw",
                   choices=("adamw", "adafactor"),
                   help="adamw matches the reference; adafactor keeps a "
                        "factored second moment (low memory)")
    p.add_argument("--remat-policy", default="full",
                   choices=("none", "full", "dots"),
                   help="gradient checkpointing: the full layer, none, or "
                        "dots (keep the matmul outputs, recompute the rest)")
    p.add_argument("--eval-json", default=None)
    p.add_argument("--video-root", default="./datas/videos")
    p.add_argument("--model-path", default=None,
                   help="HF checkpoint dir (config.json + safetensors)")
    p.add_argument("--warm-start", default=None,
                   help="a checkpoint of the previous stage (Trainer.save)")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer path (defaults to --model-path)")
    p.add_argument("--output-dir", default="./checkpoints")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-segments", type=int, default=2)
    p.add_argument("--decode-workers", type=int, default=0,
                   help="N-worker video decode pool (reference: 12-thread "
                        "prefetch, dataset.py:299-309); 0 = in-line decode")
    p.add_argument("--max-length", type=int, default=3072)
    # Hyperparameter defaults of None resolve per stage to the reference
    # training scripts' defaults (REFERENCE_STAGE_DEFAULTS).
    p.add_argument("--learning-rate", type=float, default=None,
                   help="default: 3e-5, every reference stage script")
    p.add_argument("--weight-decay", type=float, default=None,
                   help="default: 0.1 (criteria_train.py:40)")
    p.add_argument("--schedule", choices=("linear", "cosine", "none"),
                   default=None,
                   help="LR schedule; default: cosine "
                        "(lr_scheduler_type, criteria_train.py:37)")
    p.add_argument("--num-epochs", type=int, default=None,
                   help="default: 3 (num_train_epochs)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="default: 25/50/5 for stage 1/2/3")
    p.add_argument("--gradient-accumulation-steps", type=int, default=None,
                   help="mean micro-batch grads, apply the optimizer "
                        "every k steps; default: 8/8/4 for stage 1/2/3")
    p.add_argument("--mse", action="store_true", default=None)
    p.add_argument("--no-mse", dest="mse", action="store_false")
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--attn", choices=tuple(ATTN_IMPLS), default=None,
                   help="auto/flash: the attention kernels (their plain "
                        "twins on the CPU); xla: exact softmax")
    p.add_argument("--tp", type=int, default=1,
                   help="model-axis mesh size (tensor parallelism)")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-axis mesh size: -1 = the processes under "
                        "torchrun over --tp, 1 in one process "
                        "(Mesh.local(dp, tp) in one process, "
                        "Mesh.distributed under torchrun)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--save-total-limit", type=int, default=3)
    p.add_argument("--bf16-adam-mu", action="store_true",
                   help="store Adam first moments in bf16")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard optimizer moments over the data axis")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="rank > 0 trains low-rank LoRA adapters on the LLM "
                        "instead of full weights (ops/lora.py)")
    p.add_argument("--lora-alpha", type=float, default=None,
                   help="LoRA scale numerator (default: rank, i.e. scale 1)")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="overlap checkpoint writes with training")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="hermetic smoke mode: tiny config + byte tokenizer")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card; "
                        "'cpu' runs the kernels' plain twins)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import torch

    from ..configs import mjvideo_2b_config, tiny_test_config
    from ..data.dataset import (
        PairCollator,
        PreferencePairDataset,
        batched,
        prefetch,
    )
    from ..data.prompts import rebase_img_context_id
    from ..models.reward import init_reward_params
    from ..utils.checkpoint import wait_for_saves
    from .trainer import TrainConfig, Trainer, warm_start

    from ..parallel.distributed import maybe_initialize, process_info
    from ..parallel.mesh import make_mesh

    device = resolve_device(args.device)
    maybe_initialize(device)
    mesh = None
    if args.tp != 1 or args.dp not in (-1, 1) or process_info()[1] > 1:
        mesh = make_mesh(data=args.dp, model=args.tp)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    if args.model_path:
        from ..utils.checkpoint import load_reward_model

        cfg, params = load_reward_model(args.model_path, dtype=dtype,
                                        device=device)
    else:
        cfg = tiny_test_config() if args.tiny else mjvideo_2b_config()
        params = init_reward_params(
            cfg, generator=torch.Generator(device=device).manual_seed(
                args.seed), device=device, dtype=dtype)
    if args.warm_start:
        try:
            params = warm_start(params, args.warm_start)
        except KeyError:
            if args.lora_rank <= 0:
                raise
            # The previous stage trained with LoRA: its checkpoint's kernels
            # are LoRA nodes (their paths end in /.a, /.b, ... where the
            # fresh state's end in /kernel), so wrap before restoring (the Trainer's own
            # apply_lora is idempotent, and the restore overwrites the
            # fresh adapters).
            from ..ops.lora import apply_lora

            params = apply_lora(
                params, torch.Generator(device=device).manual_seed(
                    args.lora_rank), args.lora_rank, alpha=args.lora_alpha)
            params = warm_start(params, args.warm_start)

    tokenizer, gating_pattern = load_tokenizer(args.tokenizer
                                               or args.model_path)
    if gating_pattern is None:
        gating_pattern = cfg.gating_token_pattern
    # The tokenizer owns the <IMG_CONTEXT> scatter id (the reference's
    # load-time assignment): rebase so that the prompts and the forward
    # agree.
    cfg = rebase_img_context_id(cfg, tokenizer)

    def dataset(path):
        return PreferencePairDataset(
            path, tokenizer, cfg.chat, root=args.video_root,
            num_segments=args.num_segments, overall=(args.stage == 3),
            gating_pattern=gating_pattern,
            decode_workers=args.decode_workers)

    train_set = dataset(args.train_json)
    collator = PairCollator(
        pad_token_id=getattr(tokenizer, "pad_token_id", None)
        or cfg.chat.llm.pad_token_id,
        max_length=args.max_length)

    for k, v in REFERENCE_STAGE_DEFAULTS[args.stage].items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    steps_per_epoch = max(len(train_set) // args.batch_size, 1)
    total = args.max_steps or steps_per_epoch * args.num_epochs
    accum = args.gradient_accumulation_steps
    tc = TrainConfig(
        stage=args.stage,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        schedule=args.schedule,
        warmup_steps=args.warmup_steps,
        # The schedule counts optimizer steps (HF semantics); the loop
        # below counts micro-steps.
        total_steps=max(total // accum, 1),
        mse=args.mse,
        beta=args.beta,
        attn_impl=ATTN_IMPLS[args.attn or "auto"],
        log_every=args.log_every,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.output_dir,
        keep_checkpoints=args.save_total_limit,
        mesh_model_axis=args.tp,
        mesh_data_axis=args.dp,
        adam_mu_dtype="bfloat16" if args.bf16_adam_mu else None,
        remat={"none": False, "full": True,
               "dots": "dots"}[args.remat_policy],
        optimizer=args.optimizer,
        zero1=args.zero1,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        async_checkpoint=args.async_checkpoint,
        gradient_accumulation_steps=accum,
    )
    trainer = Trainer(cfg, params, tc,
                      **({} if mesh is None else {"mesh": mesh}))

    if process_info()[0] == 0:
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "train_args.json"),
                  "w") as f:
            json.dump(vars(args), f, indent=2)

    eval_set = dataset(args.eval_json) if args.eval_json else None
    for epoch in range(args.num_epochs):
        stream = prefetch(batched(train_set, collator, args.batch_size))
        last = trainer.train(stream, max_steps=total)
        # save_strategy='epoch', the reference default
        # (criteria_train.py:30); checkpoint_every adds the 'steps' mode.
        path = trainer.save()
        print(f"epoch {epoch}: {last} -> {path}")
        if eval_set is not None:
            # eval_strategy='epoch' (criteria_train.py:32): preference
            # accuracy and the per-dimension criteria/aspect metrics on the
            # held-out set, logged to the metrics JSONL.
            metrics = trainer.evaluate(
                batched(eval_set, collator, args.batch_size))
            trainer.log({"eval": metrics, "step": trainer.step,
                         "epoch": epoch})
            print(f"epoch {epoch} eval: {metrics}")
        if trainer.step >= total:
            break
    wait_for_saves()  # the last save is durable before the CLI returns
    print(f"final checkpoint: {path}")


if __name__ == "__main__":
    main()
