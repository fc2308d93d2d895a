#!/usr/bin/env bash
# The reward model over all four benchmarks on the PyTorch port (the
# counterpart of launch/eval_all_benchmarks.sh).  CKPT is an HF-format
# reward checkpoint directory; DEVICE=cpu runs on the CPU.  Extra
# arguments go to every run (e.g. --quant int8 --dp 2).
set -euo pipefail
CKPT=${CKPT:-./checkpoints/stage3}
DEVICE=${DEVICE:-cuda}
mkdir -p results
python -m mjvideo_tpu_torch.eval.cli --benchmark overall \
  --data-json datas/test.json --video-root datas/videos \
  --model-path "$CKPT" --results results/overall.jsonl --device "$DEVICE" "$@"
python -m mjvideo_tpu_torch.eval.cli --benchmark aspects \
  --data-json datas/test.json --video-root datas/videos \
  --model-path "$CKPT" --results results/aspects.jsonl --device "$DEVICE" "$@"
python -m mjvideo_tpu_torch.eval.cli --benchmark safesora \
  --data-json Safesora/config-test.json --video-root Safesora/videos \
  --model-path "$CKPT" --results results/safesora.jsonl --device "$DEVICE" "$@"
python -m mjvideo_tpu_torch.eval.cli --benchmark genai --model-path "$CKPT" \
  --results results/genai.jsonl --device "$DEVICE" "$@"
