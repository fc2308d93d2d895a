"""VADER-style reward-feedback loop: finetune a (toy) differentiable video
generator against the MJ-VIDEO reward model's gradient.

Counterpart of ``examples/vader_loop.py``.  ``RewardScorer.score_fn`` is a
differentiable (frames -> score) function, so any PyTorch generator
backprops through the whole reward stack: the reward head, the decoder (K2
with the lse, K4a, K4b), the ``<IMG_CONTEXT>`` scatter, the projector and
the ViT (K1 with the lse, K4 nc), each layer rematerialised.  The
reference's VADER integration is external (README.md:188 reports
VADER+VideoCrafter2 tuned with MJ-VIDEO as the reward; BASELINE config #5).

The generator is deliberately tiny: a learnable coarse space-time pixel
field, bilinearly upsampled to the model resolution, standing in for a
diffusion model's final frames.  The point is the gradient plumbing and the
ascent curve, not video quality.

    python -m mjvideo_tpu_torch.examples.vader_loop [--steps 30] \\
        [--frames 2] [--coarse 16] [--lr 0.05] [--device cpu]

On the card (the default) the model is MJ-VIDEO-2B with random bf16 weights
drawn from a seed; with ``--device cpu`` it is ``tiny_test_config`` in fp32.
"""

from __future__ import annotations

import argparse
from typing import Callable, List

import torch
import torch.nn.functional as F

from ..data.video import IMAGENET_MEAN, IMAGENET_STD


def make_field(frames: int, coarse: int, *, generator: torch.Generator,
               device) -> torch.Tensor:
    """The learnable coarse field (frames, coarse, coarse, 3), fp32, drawn
    as 0.1 * N(0, 1) from ``generator``."""
    field = 0.1 * torch.randn((frames, coarse, coarse, 3), generator=generator,
                              device=device)
    return field.requires_grad_()


def render(field: torch.Tensor, image_size: int) -> torch.Tensor:
    """Coarse field -> (frames, S, S, 3) ImageNet-normalised NHWC frames:
    bilinear upsampling (half-pixel centres, as ``jax.image.resize``),
    sigmoid, then the ImageNet normalisation."""
    up = F.interpolate(field.permute(0, 3, 1, 2), size=(image_size, image_size),
                       mode="bilinear", align_corners=False)
    rgb = torch.sigmoid(up.permute(0, 2, 3, 1))
    mean = torch.as_tensor(IMAGENET_MEAN, device=field.device)
    std = torch.as_tensor(IMAGENET_STD, device=field.device)
    return (rgb - mean) / std


def reward_fn(scorer, frames: int, caption: str) -> Callable:
    """``scorer.score_fn`` for a ``frames``-frame clip (one tile per frame)
    captioned ``caption``, its prompt built from the scorer's tokenizer."""
    from ..data.prompts import build_video_question, prepare_chat_input

    chat = prepare_chat_input(scorer.cfg.chat, scorer.tokenizer,
                              build_video_question(caption, frames),
                              num_patches_list=[1] * frames,
                              gating_pattern=scorer.gating_pattern)
    return scorer.score_fn(chat.input_ids[0], chat.gating_pos)


def make_step(score_fn: Callable, field: torch.Tensor, image_size: int,
              lr: float) -> Callable[[], torch.Tensor]:
    """One Adam step that ascends the reward, loss = -score(render(field)):
    ``step()`` returns the reward before the update (a 0-d tensor on the
    field's device)."""
    opt = torch.optim.Adam([field], lr=lr)

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        score = score_fn(render(field, image_size))
        (-score).backward()
        opt.step()
        return score.detach()

    return step


def make_scorer(device: torch.device):
    """MJ-VIDEO-2B in bf16 on the card, ``tiny_test_config`` in fp32 on the
    CPU; random weights from seed 0; the ``ByteTokenizer``, one 4,096 bucket."""
    from ..configs import mjvideo_2b_config, tiny_test_config
    from ..data.prompts import ByteTokenizer
    from ..eval.scorer import RewardScorer
    from ..models.reward import init_reward_params

    on_card = device.type == "cuda"
    cfg = mjvideo_2b_config() if on_card else tiny_test_config()
    dtype = torch.bfloat16 if on_card else torch.float32
    params = init_reward_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device, dtype=dtype)
    tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
    return RewardScorer(cfg, params, tok, dtype=dtype, length_buckets=(4096,),
                        gating_pattern=tok.gating_pattern())


def run(scorer, steps: int, frames: int, coarse: int, lr: float,
        caption: str, seed: int = 1) -> List[float]:
    """``steps`` Adam steps of a fresh field against ``scorer``; the reward
    at each step."""
    field = make_field(frames, coarse, device=scorer.device,
                       generator=torch.Generator(device=scorer.device)
                       .manual_seed(seed))
    step = make_step(reward_fn(scorer, frames, caption), field,
                     scorer.cfg.chat.image_size, lr)
    history = []
    for i in range(steps):
        history.append(float(step()))
        print(f"step {i:3d}  reward {history[-1]:+.5f}", flush=True)
    return history


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--coarse", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--caption", default="a bright colorful scene")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    history = run(make_scorer(device), args.steps, args.frames, args.coarse,
                  args.lr, args.caption)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"\nreward ascent: {history[0]:+.5f} -> {history[-1]:+.5f} "
          f"({'UP' if history[-1] > history[0] else 'NO GAIN'}) over "
          f"{args.steps} steps on {where}")


if __name__ == "__main__":
    main()
