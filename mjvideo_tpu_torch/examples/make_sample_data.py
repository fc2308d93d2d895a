"""Generate a synthetic MJ-BENCH-VIDEO-style sample dataset (C25 stand-in).

The port's copy of ``examples/make_sample_data.py``, on the port's own
``configs``.  The reference ships ``datas/test.json`` (1,085 annotated
pairs) whose videos live on S3; offline we synthesize structurally-identical
records + tiny mp4s so every pipeline stage (dataset -> collator -> trainer
-> eval) runs end-to-end hermetically.

    python -m mjvideo_tpu_torch.examples.make_sample_data \
        --out datas_sample --pairs 4
"""

import argparse
import json
import os

import numpy as np

from ..configs import ASPECT_NAMES, CRITERIA_NAMES


def write_video(path, seed, size=64, n_frames=16, fps=8.0):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (size, size))
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    for i in range(n_frames):
        frame = np.roll(base, i * 2, axis=1)
        w.write(frame)
    w.release()


def make_record(rng, idx, videos_dir):
    v0, v1 = f"pair{idx}_a.mp4", f"pair{idx}_b.mp4"
    write_video(os.path.join(videos_dir, v0), seed=idx * 2)
    write_video(os.path.join(videos_dir, v1), seed=idx * 2 + 1)

    def labels():
        return {name: int(rng.choice([0, 1, 2])) for name in CRITERIA_NAMES}

    def aspect_scores():
        return {name: int(rng.choice([0, 1, 2])) for name in ASPECT_NAMES}

    prefs = ["Video 1 better", "Video 2 better", "Same", "Hard to judge"]
    return {
        "caption": f"synthetic clip pair number {idx}",
        "video_0_path": v0,
        "video_1_path": v1,
        "video_0_label": labels(),
        "video_1_label": labels(),
        "video_0_overall_score": aspect_scores(),
        "video_1_overall_score": aspect_scores(),
        "video_0_total_score": int(rng.choice([1, 2])),
        "video_1_total_score": int(rng.choice([1, 2])),
        "category_preference": {
            name: str(rng.choice(prefs)) for name in ASPECT_NAMES
        },
        "overall_preference": str(rng.choice(prefs[:3])),
    }


def make_safesora_record(rng, idx, videos_dir, unanimous=True):
    """SafeSora-test record shape (``eval_safesora_internvl2_2b.py:95-108``):
    ``prompt_text``, ``video_{0,1}.video_path``, helpfulness/harmlessness +
    sub-preference votes with 'video_0'/'video_1' values.  Non-unanimous
    records exercise ``filter_safesora_pairs``'s drop path."""
    v0, v1 = f"ss{idx}_a.mp4", f"ss{idx}_b.mp4"
    write_video(os.path.join(videos_dir, v0), seed=1000 + idx * 2)
    write_video(os.path.join(videos_dir, v1), seed=1000 + idx * 2 + 1)
    winner = str(rng.choice(["video_0", "video_1"]))
    other = "video_1" if winner == "video_0" else "video_0"
    return {
        "prompt_text": f"synthetic safesora prompt {idx}",
        "video_0": {"video_path": v0},
        "video_1": {"video_path": v1},
        "helpfulness": winner,
        "harmlessness": winner if unanimous else other,
        "sub_preferences": {
            "instruction_following": winner,
            "correctness": winner,
            "informativeness": winner,
            "aesthetics": winner,
        },
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="datas_sample")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    videos_dir = os.path.join(args.out, "videos")
    os.makedirs(videos_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    records = [make_record(rng, i, videos_dir) for i in range(args.pairs)]
    path = os.path.join(args.out, "pairs.json")
    with open(path, "w") as f:
        json.dump(records, f, indent=2)
    print(f"wrote {len(records)} pairs -> {path} (videos in {videos_dir})")

    ss = [make_safesora_record(rng, i, videos_dir, unanimous=(i % 2 == 0))
          for i in range(args.pairs)]
    ss_path = os.path.join(args.out, "safesora.json")
    with open(ss_path, "w") as f:
        json.dump(ss, f, indent=2)
    print(f"wrote {len(ss)} safesora records -> {ss_path}")


if __name__ == "__main__":
    main()
