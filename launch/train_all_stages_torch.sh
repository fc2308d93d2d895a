#!/usr/bin/env bash
# Three-stage training chain on the PyTorch port (the counterpart of
# launch/train_all_stages.sh): each stage warm-starts from the newest
# checkpoint of the one before.  Extra arguments go to every stage
# (e.g. --lora-rank 16, --tp 2, --zero1).  DEVICE=cpu runs on the CPU;
# LAUNCH="torchrun --nproc-per-node 4" runs one process a card.
set -euo pipefail

MODEL=${MODEL:-/path/to/InternVL2-2B}
DATA=${DATA:-datas/train.json}
OUT=${OUT:-./checkpoints}
DEVICE=${DEVICE:-cuda}
LAUNCH=${LAUNCH:-python}

$LAUNCH -m mjvideo_tpu_torch.train.cli --stage 1 --train-json "$DATA" \
  --model-path "$MODEL" --output-dir "$OUT/stage1" --device "$DEVICE" "$@"

S1=$(ls -d "$OUT"/stage1/stage1_step* | sort -V | tail -1)
$LAUNCH -m mjvideo_tpu_torch.train.cli --stage 2 --train-json "$DATA" \
  --model-path "$MODEL" --warm-start "$S1" --output-dir "$OUT/stage2" \
  --device "$DEVICE" "$@"

S2=$(ls -d "$OUT"/stage2/stage2_step* | sort -V | tail -1)
$LAUNCH -m mjvideo_tpu_torch.train.cli --stage 3 --train-json "$DATA" \
  --model-path "$MODEL" --warm-start "$S2" --output-dir "$OUT/stage3" \
  --device "$DEVICE" "$@"
