"""End-to-end playground: the ``moe-playground.ipynb`` equivalent.

Counterpart of ``examples/playground.py`` on the port's ``chat``,
``RewardScorer`` and ``load_reward_model``.  Without a checkpoint it runs
the tiny hermetic demo (random weights, the ``ByteTokenizer``, no network):
chat generation, a video reward forward with batched padding, and pair
scoring.  With a checkpoint and a video it scores the clip with
MJ-VIDEO-2B.  It runs on the card (``--device cuda``, the default; a
machine without one refuses) unless ``--device cpu`` asks for the CPU.

    python -m mjvideo_tpu_torch.examples.playground --device cpu   # tiny demo
    python -m mjvideo_tpu_torch.examples.playground \\
        --model-path /path/to/MJ-VIDEO-2B --video clip.mp4 \\
        --caption "a red panda climbing"
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-path", default=None,
                    help="reward checkpoint dir (config.json and "
                         "safetensors); without it, the tiny demo")
    ap.add_argument("--video", default=None)
    ap.add_argument("--caption", default="a video")
    ap.add_argument("--tokenizer", default=None,
                    help="HF tokenizer path (defaults to --model-path)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain twins)")
    return ap


def tiny_demo(device) -> dict:
    """The hermetic demo at ``tiny_test_config`` in fp32: a chat reply, a
    clip's reward outputs and a pair's scores.  Returns what it prints."""
    import numpy as np
    import torch

    from ..configs import tiny_test_config
    from ..data.prompts import (
        ByteTokenizer,
        build_video_question,
        prepare_chat_input,
    )
    from ..eval.scorer import RewardScorer
    from ..models import internvl, reward
    from ..models.generate import GenerationConfig, chat

    cfg = tiny_test_config()
    tok = ByteTokenizer()
    out = {}

    # 1. chat (cell 3 of the reference notebook)
    chat_params = internvl.init_chat_params(
        cfg.chat, generator=torch.Generator(device=device).manual_seed(0),
        device=device, dtype=torch.float32, with_lm_head=True)
    response, history = chat(
        chat_params, cfg.chat, tok, "Hello, who are you?",
        generation_config=GenerationConfig(max_new_tokens=8,
                                           temperature=0.0))
    print(f"chat response (random weights, {len(history)} turns):",
          repr(response[:60]))
    out["chat"] = response

    # 2. batched reward forward with padding (cells 10-14)
    params = reward.init_reward_params(
        cfg, generator=torch.Generator(device=device).manual_seed(1),
        device=device, dtype=torch.float32)
    scorer = RewardScorer(cfg, params, tok, dtype=torch.float32,
                          length_buckets=(256, 512),
                          gating_pattern=tok.gating_pattern())
    rng = np.random.default_rng(0)
    c = scorer.cfg.chat
    frames = rng.normal(size=(2, c.vision.image_size, c.vision.image_size,
                              3)).astype(np.float32)
    chat_in = prepare_chat_input(c, tok,
                                 build_video_question("a bouncing ball", 2),
                                 num_patches_list=[1, 1],
                                 gating_pattern=tok.gating_pattern())
    res = scorer.score_batch(frames, [chat_in.input_ids[0]],
                             [chat_in.gating_pos])
    print("reward score:", float(res.score[0]))
    print("aspect scores:",
          np.round(res.aspect_scores[0].float().cpu().numpy(), 4))
    print("criteria rewards shape:", tuple(res.rewards.shape))
    out["score"] = float(res.score[0])

    # 3. a pair: the two clips in one request
    pair = prepare_chat_input(c, tok, build_video_question("a red fox", 1),
                              num_patches_list=[1],
                              gating_pattern=tok.gating_pattern())
    both = scorer.score_batch(
        frames, [pair.input_ids[0], pair.input_ids[0]],
        [pair.gating_pos, pair.gating_pos])
    print("pair scores:", [round(float(s), 6) for s in both.score])
    out["pair"] = [float(s) for s in both.score]
    return out


def real_demo(model_path: str, video: str, caption: str, tokenizer,
              device) -> dict:
    """MJ-VIDEO's scores of one clip from a checkpoint directory."""
    import torch

    from ..data.prompts import load_tokenizer
    from ..eval.scorer import RewardScorer
    from ..utils.checkpoint import load_reward_model

    cfg, params = load_reward_model(model_path, dtype=torch.bfloat16,
                                    device=device)
    tok, pattern = load_tokenizer(tokenizer or model_path)
    scorer = RewardScorer(cfg, params, tok,
                          gating_pattern=pattern or cfg.gating_token_pattern)
    res = scorer.score_video(video, caption)
    print("overall:", res["score"])
    print("aspects:", res["aspect_scores"])
    print("criteria:", res["rewards"])
    return res


def main(argv=None) -> dict:
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.model_path and args.video:
        return real_demo(args.model_path, args.video, args.caption,
                         args.tokenizer, device)
    return tiny_demo(device)


if __name__ == "__main__":
    main()
