"""Throughput-oriented scoring loop: score every video of a directory.

Counterpart of ``examples/serve.py``: host decode pipelined ahead of the
card's work (``data.dataset.pool_map`` workers, or one ``prefetch``
thread), bucketed prompt lengths (``RewardScorer``), and the clips/s
counter (``utils.profiling.Throughput``).  Each clip's scores are appended
to ``--out`` as one JSON line ``{"video", "score", "aspect_scores"}``, the
values ``RewardScorer.score_video`` gives for the clip.

    python -m mjvideo_tpu_torch.examples.serve --model-path DIR \\
        --videos dir_of_mp4s [--caption-file captions.json] \\
        [--device-preprocess] [--quant int4-wo] [--trace-dir DIR]

The checkpoint directory is read by ``utils.checkpoint.load_reward_model``
and the tokenizer found as the eval CLI finds it
(``data.prompts.load_tokenizer``: ``--tokenizer``, else the checkpoint's;
``--byte-tokenizer`` for the hermetic ``ByteTokenizer``).  It runs on the
card (``--device cuda``, the default; a machine without one refuses)
unless ``--device cpu`` asks for the CPU.  ``--trace-dir`` writes a
``torch.profiler`` Chrome trace of the whole run
(``utils.profiling.trace``), each clip's scoring a named region.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

VIDEO_SUFFIXES = (".mp4", ".webm", ".avi", ".mov")
QUANT_MODES = ("int8", "int8-vit", "int8-wo", "int4-wo")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="MJ-Video scoring loop "
                                             "(PyTorch)")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--videos", required=True, help="directory of videos")
    ap.add_argument("--caption-file", default=None,
                    help="json {filename: caption}; default caption otherwise")
    ap.add_argument("--num-segments", type=int, default=8)
    ap.add_argument("--max-num", type=int, default=1,
                    help="dynamic-tiling ceiling per frame")
    ap.add_argument("--workers", type=int, default=4,
                    help="decode-pool workers (0 = single prefetch thread)")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="raw uint8 frames in; resize, tile and normalise "
                         "on the device")
    ap.add_argument("--quant", default=None, choices=QUANT_MODES,
                    help="serving quantization: w8a8 everywhere (int8), "
                         "vision tower only (int8-vit), weight-only "
                         "w8a16 (int8-wo) or weight-only int4 (int4-wo)")
    ap.add_argument("--tokenizer", default=None,
                    help="HF tokenizer path (defaults to --model-path)")
    ap.add_argument("--byte-tokenizer", action="store_true",
                    help="the hermetic ByteTokenizer in place of an HF "
                         "tokenizer")
    ap.add_argument("--device", default="cuda",
                    help="torch device to score on (default: the card)")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace of the run here")
    ap.add_argument("--out", default="scores.jsonl")
    return ap


def main(argv=None) -> dict:
    """Score the directory; returns {"clips", "seconds", "clips_per_s",
    "rate"}: the count, the wall time from the first clip's decode, the
    average rate and the smoothed rate at the end."""
    args = build_parser().parse_args(argv)

    import torch

    from ..data.dataset import pool_map, prefetch
    from ..data.prompts import load_tokenizer
    from ..eval.scorer import RewardScorer
    from ..utils.checkpoint import load_reward_model
    from ..utils.device import resolve_device
    from ..utils.profiling import Throughput, annotate, trace

    cfg, params = load_reward_model(args.model_path, dtype=torch.bfloat16,
                                    device=resolve_device(args.device))
    tok, pattern = load_tokenizer(
        None if args.byte_tokenizer else args.tokenizer or args.model_path)
    if args.byte_tokenizer:
        # The gating text of the checkpoint's template (the eval CLI's).
        pattern = tok.gating_pattern(cfg.chat.template)
    scorer = RewardScorer(
        cfg, params, tok,
        gating_pattern=cfg.gating_token_pattern if pattern is None
        else pattern,
        device_preprocess=args.device_preprocess,
        device_max_num=args.max_num if args.device_preprocess else 1,
        quant=args.quant)

    captions = {}
    if args.caption_file:
        with open(args.caption_file) as f:
            captions = json.load(f)
    videos = sorted(f for f in os.listdir(args.videos)
                    if f.lower().endswith(VIDEO_SUFFIXES))

    def prep(name):
        caption = captions.get(name, "a generated video")
        return name, scorer.prepare_clip(
            os.path.join(args.videos, name), caption,
            num_segments=args.num_segments, max_num=args.max_num)

    def prepared():
        # N decode workers; 0 falls back to the single prefetch thread.
        if args.workers > 0:
            yield from pool_map(prep, videos, num_workers=args.workers)
        else:
            yield from prefetch(map(prep, videos), 2)

    tracing = (trace(args.trace_dir) if args.trace_dir
               else contextlib.nullcontext())
    tp = Throughput()
    with tracing, open(args.out, "a") as out:
        for name, (pixels, ids, gpos) in prepared():
            with annotate(f"score {name}"):
                res = scorer.score_batch(pixels, [ids], [gpos])
                rec = {
                    "video": name,
                    "score": float(res.score[0]),
                    "aspect_scores": [float(x)
                                      for x in res.aspect_scores[0]],
                }
            out.write(json.dumps(rec) + "\n")
            out.flush()
            rate = tp.update(1)
            print(f"{name}: {rec['score']:+.4f}  ({rate:.2f} clips/s)")
    avg = tp.average()
    print(f"done: {tp.total} clips, avg {avg:.2f} clips/s")
    return {"clips": tp.total, "seconds": tp.total / avg if avg else 0.0,
            "clips_per_s": avg, "rate": tp.rate}


if __name__ == "__main__":
    main()
