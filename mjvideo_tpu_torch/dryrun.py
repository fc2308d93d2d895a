"""Driver entry points: the single-card reward forward and the multichip
dry run.

Counterpart of ``__graft_entry__.py``.  ``entry()`` returns the 2B reward
forward (random bf16 weights, on the card) and its example inputs.
``dryrun_multichip(n)`` runs the JAX dry run's four phases over a mesh of
n shards.  JAX makes n virtual CPU devices in one process; here the mesh
is ``Mesh.local(n // 2, 2)`` (``Mesh.local(n, 1)`` for an odd n, as JAX
picks tp, ``__graft_entry__.py:165-172``), every shard in this process on
one device, on the card unless ``device="cpu"``:

1. a stage-3 training step with the plain attention (JAX's "xla");
2. the same step with the kernels (their plain twins on the CPU), remat
   and ZeRO-1, at least one optimizer leaf split over the data axis;
3. a ring sequence-parallel reward forward over the data axis with the
   tile-sharded ViT (16 frames x 13 tiles);
4. a ring sequence-parallel stage-3 step at 4,096 tokens (``train_seq``)
   with ZeRO-1 and the model axis, at least one optimizer leaf split.

Tiny shapes: ``tiny_test_config`` on the CPU; on the card its widths are
raised to the kernels' head dims (the ViT's heads of 64, the decoder's of
128), which the kernels take.  Run ``python -m mjvideo_tpu_torch.dryrun
[N] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

import numpy as np
import torch


def _example_inputs(cfg, batch: int, frames: int, text_len: int, dtype,
                    device):
    """Synthetic (pixel_values, input_ids, attention_mask, gating_pos) for
    a reward forward shaped like the 8-frame ``max_num=1`` eval path."""
    c = cfg.chat
    n_img = c.num_image_token * frames
    T = n_img + text_len
    rng = np.random.default_rng(0)
    pix = rng.normal(size=(batch * frames, c.vision.image_size,
                           c.vision.image_size, 3)).astype(np.float32)
    ids = np.full((batch, T), 11, np.int64)
    # Image context tokens at the front of each row, after a prefix.
    ids[:, 8:8 + n_img] = c.img_context_token_id
    return (torch.from_numpy(pix).to(device, dtype),
            torch.from_numpy(ids).to(device),
            torch.ones((batch, T), dtype=torch.int32, device=device),
            torch.full((batch,), T - 6, dtype=torch.int32, device=device))


def entry(device: str = "cuda"):
    """(fn, example_args): the MJ-VIDEO-2B reward forward with random bf16
    weights (seed 0), returning (score, aspect_scores, rewards)."""
    from .configs import mjvideo_2b_config
    from .models.reward import init_reward_params, reward_forward

    cfg = mjvideo_2b_config()
    dev = torch.device(device)
    params = init_reward_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev, dtype=torch.bfloat16)

    @torch.inference_mode()
    def fwd(params, pixel_values, input_ids, attention_mask, gating_pos):
        out = reward_forward(params, cfg, pixel_values, input_ids,
                             attention_mask, gating_pos, remat=False)
        return out.score, out.aspect_scores, out.rewards

    return fwd, (params,) + _example_inputs(cfg, 1, 8, 64, torch.bfloat16,
                                            dev)


def dryrun_config(device: torch.device):
    """``tiny_test_config``, on the card with the kernels' head dims: the
    ViT at 4 heads of 64, the decoder at 2 query and 2 kv heads of 128."""
    from .configs import tiny_test_config

    cfg = tiny_test_config()
    if device.type != "cuda":
        return cfg
    cfg = tiny_test_config(hidden_size=256)
    llm = dataclasses.replace(cfg.chat.llm, num_attention_heads=2,
                              num_key_value_heads=2)
    return dataclasses.replace(
        cfg, chat=dataclasses.replace(cfg.chat, llm=llm))


def _pair_batch(cfg, B: int, frames: int, T: int, rng) -> Dict[str, np.ndarray]:
    """A stage-3 batch of B pairs (JAX's dry-run batch)."""
    c = cfg.chat
    n_img = c.num_image_token * frames
    batch = {}
    for v in (0, 1):
        ids = np.full((B, T), 5, np.int64)
        ids[:, 2:2 + n_img] = c.img_context_token_id
        batch[f"video_{v}_pixel_values"] = rng.normal(
            size=(B, frames, c.vision.image_size, c.vision.image_size, 3)
        ).astype(np.float32)
        batch[f"video_{v}_input_ids"] = ids
        batch[f"video_{v}_attention_mask"] = np.ones((B, T), np.int32)
        batch[f"video_{v}_gating_pos"] = np.full((B,), T - 4, np.int32)
        batch[f"video_{v}_criteria_score"] = rng.choice(
            [-1.0, 0.0, 1.0], size=(B, 28)).astype(np.float32)
        batch[f"video_{v}_criteria_related"] = rng.integers(
            0, 2, size=(B, 28)).astype(np.float32)
        batch[f"video_{v}_aspect_score"] = rng.choice(
            [-1.0, 0.0, 1.0], size=(B, 5)).astype(np.float32)
        batch[f"video_{v}_aspect_related"] = rng.integers(
            0, 2, size=(B, 5)).astype(np.float32)
        batch[f"video_{v}_overall_score"] = rng.choice(
            [-1.0, 1.0], size=(B, 1)).astype(np.float32)
        batch[f"video_{v}_overall_related"] = np.ones((B, 1), np.float32)
    batch["aspect_preference"] = rng.integers(0, 2, (B, 5)).astype(np.int32)
    batch["aspect_mask"] = rng.integers(0, 2, (B, 5)).astype(np.float32)
    batch["overall_preference"] = rng.integers(0, 2, (B, 1)).astype(np.int32)
    batch["overall_mask"] = np.ones((B, 1), np.float32)
    return batch


def _split_moment_leaves(optimizer, state) -> int:
    """The optimizer leaves of 64 elements or more that hold one data
    rank's slice of their parameter (ZeRO-1's ``#d`` slots)."""
    return sum(1 for name in ("mu", "nu", "v", "acc") if name in state
               for slot, t in state[name].items()
               if "#d" in slot and t.numel() >= 64)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     train_seq: int = 4096) -> Dict:
    """The four phases over ``Mesh.local`` of ``n_devices`` shards; raises
    on a non-finite loss or score, or on ZeRO-1 moments left whole.
    Returns each phase's reading.  ``train_seq``: phase 4's tokens (JAX's
    4,096; the CPU tests take fewer, the plain ring attention being
    quadratic in it)."""
    from .models.reward import init_reward_params, reward_forward
    from .parallel.mesh import Mesh, shard_params, split_plan
    from .train.trainer import (
        TrainConfig,
        make_optimizer,
        make_train_step,
        place_batch,
    )

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: CUDA is not available; pass "
                           "device='cpu'")
    model_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = Mesh.local(n_devices // model_axis, model_axis)
    cfg = dryrun_config(dev)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = init_reward_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev, dtype=dtype)
    plan = split_plan(params, mesh.model, cfg)
    out = {"mesh": mesh.shape}
    rng = np.random.default_rng(0)
    c = cfg.chat

    def run_step(tc, batch, sp_group=None):
        shards = shard_params(params, mesh, cfg=cfg)
        opt = make_optimizer(tc, shards, mesh, plan)
        state = opt.init(shards)
        step = make_train_step(cfg, tc, opt, sp_group)
        _, state, metrics = step(shards, state, place_batch(batch, dev,
                                                             dtype))
        loss = float(metrics["loss"])
        return loss, _split_moment_leaves(opt, state)

    # Phase 1: a stage-3 step with the plain attention.
    frames, B = 2, mesh.data * 2  # 2 pairs per data shard
    batch = _pair_batch(cfg, B, frames, c.num_image_token * frames + 16, rng)
    tc = TrainConfig(stage=3, attn_impl="plain", total_steps=2, remat=False,
                     checkpoint_dir="unused")
    loss, _ = run_step(tc, batch)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun phase 1: non-finite loss {loss}")
    out["step"] = {"loss": loss}
    print(f"dryrun_multichip OK: mesh={mesh.shape} loss={loss:.4f}")

    # Phase 2: the kernels, remat and ZeRO-1.
    tc = TrainConfig(stage=3, attn_impl="auto", total_steps=2, remat=True,
                     zero1=True, checkpoint_dir="unused")
    loss, n_split = run_step(tc, batch)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun phase 2: non-finite loss {loss}")
    if mesh.data > 1 and n_split == 0:
        raise RuntimeError("dryrun phase 2: ZeRO-1 moments not split")
    out["kernels_zero1"] = {"loss": loss, "split_moment_leaves": n_split}
    print(f"dryrun_multichip OK (kernels+remat+zero1): mesh={mesh.shape} "
          f"loss={loss:.4f} sharded_moment_leaves={n_split}")

    # Phase 3: ring sequence parallelism at the production tile count (16
    # frames x (12 tiles + thumbnail)) with the tile-sharded ViT.
    group = mesh.sequence_group()
    n_seq = mesh.data
    n_tiles = 16 * 13
    n_img = c.num_image_token * n_tiles
    unit = n_seq * (64 if dev.type == "cuda" else 1)
    T = -(-(n_img + 24) // unit) * unit
    ids = np.full((1, T), 5, np.int64)
    ids[:, 2:2 + n_img] = c.img_context_token_id
    pix = torch.from_numpy(rng.normal(size=(
        n_tiles, c.vision.image_size, c.vision.image_size, 3)
    ).astype(np.float32)).to(dev, dtype)
    shards = shard_params(params, mesh, cfg=cfg)
    with torch.inference_mode():
        score = reward_forward(
            shards, cfg, pix, torch.from_numpy(ids).to(dev),
            torch.ones((1, T), dtype=torch.int32, device=dev),
            torch.tensor([T - 4], dtype=torch.int32, device=dev),
            impl="plain", remat=False,
            sp={"group": group, "kind": "ring"}, mesh=mesh).score
    score = float(score[0])
    if not np.isfinite(score):
        raise RuntimeError(f"dryrun phase 3: non-finite score {score}")
    out["ring_forward"] = {"seq": T, "tiles": n_tiles, "score": score}
    print(f"dryrun_multichip OK (ring sequence parallel): seq={T} "
          f"tiles={n_tiles} over data={n_seq} score={score:.4f}")
    del shards

    # Phase 4: ring SP, ZeRO-1 and the model axis in one stage-3 step at
    # ``train_seq`` tokens.
    T = -(-train_seq // unit) * unit
    batch = _pair_batch(cfg, 1, 2, T, rng)
    tc = TrainConfig(stage=3, attn_impl="plain", total_steps=2, remat=True,
                     zero1=True, sp="ring", checkpoint_dir="unused")
    loss, n_split = run_step(tc, batch, sp_group=group)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun phase 4: non-finite loss {loss}")
    if mesh.data > 1 and n_split == 0:
        raise RuntimeError("dryrun phase 4: ZeRO-1 moments not split")
    out["ring_train"] = {"seq": T, "loss": loss,
                         "split_moment_leaves": n_split}
    print(f"dryrun_multichip OK (ring-SP + ZeRO-1 + TP train step): "
          f"seq={T} mesh={mesh.shape} loss={loss:.4f} "
          f"sharded_moment_leaves={n_split}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--train-seq", type=int, default=4096)
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device,
                     train_seq=args.train_seq)


if __name__ == "__main__":
    main()
