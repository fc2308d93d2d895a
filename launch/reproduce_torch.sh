#!/usr/bin/env bash
# One-command reproduction of the reference README leaderboards
# (the reference README.md:145-188) from the PyTorch port's eval CLI:
# the counterpart of launch/reproduce.sh, the same runs through
# `python -m mjvideo_tpu_torch.eval.cli`.
#
# Real mode (default) needs the real inputs the reference needed:
#   CKPT          MJ-VIDEO reward checkpoint dir (config.json + safetensors)
#   DATA_JSON     MJ-BENCH-VIDEO pair records (datas/test.json)
#   VIDEO_ROOT    MJ-BENCH-VIDEO videos dir
#   SAFESORA_JSON SafeSora-test records (Safesora/config-test.json)
#   SAFESORA_ROOT SafeSora videos dir
#   JUDGE_<FAM>   optional baseline judge checkpoint dirs:
#                 JUDGE_INTERNVL / JUDGE_QWEN2VL / JUDGE_MINICPMV /
#                 JUDGE_COGVLM2 / JUDGE_VIDEOSCORE (each: HF safetensors
#                 dir with config.json + tokenizer)
#   RESULTS_DIR   output dir (default ./results/reproduce_torch)
#   DEVICE        torch device (default cuda; the hermetic mode runs on
#                 the CPU)
#
# Hermetic mode (./launch/reproduce_torch.sh --hermetic) runs the same
# command plumbing end to end on synthetic tiny data
# (mjvideo_tpu_torch.examples.make_sample_data) and random tiny
# checkpoints written through the port's utils/export.py, with the
# dependency-free ByteTokenizer, on the CPU.  Numbers are meaningless
# there; only the plumbing is under test.
#
# Table mapping (reference README.md): as in launch/reproduce.sh.
#  * Fine-grained table (:150-161): `--benchmark aspects` (scorer) and
#    `--benchmark fine-grained --judge <family>` (baseline rows).
#  * Overall-preference table (:165-182): `--benchmark overall|safesora`
#    and `--benchmark genai` (scorer), the same with `--judge <family>`.
#  * VBench / human-eval table (:184-188): not reproducible (VADER-tuned
#    VideoCrafter2 videos scored by external pipelines); the reward
#    feedback hook is `RewardScorer.score_fn`,
#    mjvideo_tpu_torch/examples/vader_loop.py.
set -euo pipefail
cd "$(dirname "$0")/.."

HERMETIC=0
[[ "${1:-}" == "--hermetic" ]] && HERMETIC=1

RESULTS_DIR=${RESULTS_DIR:-./results/reproduce_torch}

EXTRA=(--device "${DEVICE:-cuda}")
if [[ $HERMETIC == 1 ]]; then
  WORK=$(mktemp -d)
  echo "hermetic mode: synthetic data + tiny random checkpoints in $WORK"
  python -m mjvideo_tpu_torch.examples.make_sample_data --out "$WORK/data" \
    --pairs 2
  python - "$WORK" <<'PY'
import json
import os
import sys

import torch

from mjvideo_tpu_torch.configs import reward_config_to_hf, tiny_test_config
from mjvideo_tpu_torch.models.internvl import init_chat_params
from mjvideo_tpu_torch.models.reward import init_reward_params
from mjvideo_tpu_torch.utils.export import (
    export_chat,
    save_reward_checkpoint_dir,
    save_safetensors,
)

work = sys.argv[1]
cfg = tiny_test_config()
kw = dict(device="cpu", dtype=torch.float32)
save_reward_checkpoint_dir(
    f"{work}/reward_ckpt",
    init_reward_params(cfg, generator=torch.Generator().manual_seed(0), **kw),
    cfg)
os.makedirs(f"{work}/judge_ckpt", exist_ok=True)
save_safetensors(
    export_chat(init_chat_params(cfg.chat,
                                 generator=torch.Generator().manual_seed(1),
                                 with_lm_head=True, **kw), cfg.chat),
    f"{work}/judge_ckpt/model.safetensors")
with open(f"{work}/judge_ckpt/config.json", "w") as f:
    json.dump(reward_config_to_hf(cfg), f)
print("tiny checkpoints exported")
PY
  CKPT="$WORK/reward_ckpt"
  DATA_JSON="$WORK/data/pairs.json"
  VIDEO_ROOT="$WORK/data/videos"
  SAFESORA_JSON="$WORK/data/safesora.json"  # from make_sample_data
  SAFESORA_ROOT="$WORK/data/videos"
  JUDGE_INTERNVL="$WORK/judge_ckpt"
  RESULTS_DIR="$WORK/results"
  EXTRA=(--byte-tokenizer --num-segments 2 --fp32 --device cpu)
fi
mkdir -p "$RESULTS_DIR"

: "${CKPT:?set CKPT to the MJ-VIDEO reward checkpoint dir}"
: "${DATA_JSON:?set DATA_JSON to the MJ-BENCH-VIDEO records json}"
: "${VIDEO_ROOT:?set VIDEO_ROOT to the MJ-BENCH-VIDEO videos dir}"

run() {  # run <results-name> <cli args...>
  local name=$1; shift
  echo "== $name"
  python -m mjvideo_tpu_torch.eval.cli "$@" \
    --results "$RESULTS_DIR/$name.jsonl" | tee "$RESULTS_DIR/$name.json"
}

# ---- fine-grained table, MJ-VIDEO row (README.md:150-161) ----
run aspects_mjvideo --benchmark aspects --model-path "$CKPT" \
    --data-json "$DATA_JSON" --video-root "$VIDEO_ROOT" "${EXTRA[@]}"

# ---- overall table, MJ-VIDEO rows (README.md:165-182) ----
run overall_mjvideo --benchmark overall --model-path "$CKPT" \
    --data-json "$DATA_JSON" --video-root "$VIDEO_ROOT" "${EXTRA[@]}"

if [[ -n "${SAFESORA_JSON:-}" ]]; then
  run safesora_mjvideo --benchmark safesora --model-path "$CKPT" \
      --data-json "$SAFESORA_JSON" --video-root "${SAFESORA_ROOT:-}" \
      "${EXTRA[@]}"
fi
if [[ $HERMETIC == 0 ]]; then
  # GenAI-Bench streams from the HF hub (TIGER-Lab/GenAI-Bench)
  run genai_mjvideo --benchmark genai --model-path "$CKPT" "${EXTRA[@]}"
fi

# ---- baseline judge rows (any judge checkpoint that was provided) ----
for fam in internvl:JUDGE_INTERNVL qwen2vl:JUDGE_QWEN2VL \
           minicpmv:JUDGE_MINICPMV cogvlm2:JUDGE_COGVLM2; do
  name=${fam%%:*}; var=${fam##*:}
  ckpt=${!var:-}
  [[ -z "$ckpt" ]] && continue
  flag=$name
  [[ $name == internvl ]] && flag=internvl-chat
  [[ $name == qwen2vl ]] && flag=qwen2-vl
  [[ $name == minicpmv ]] && flag=minicpm-v
  run "overall_$name" --benchmark overall --judge "$flag" \
      --judge-model "$ckpt" --data-json "$DATA_JSON" \
      --video-root "$VIDEO_ROOT" "${EXTRA[@]}"
  if [[ $HERMETIC == 0 ]]; then
    run "fine_grained_$name" --benchmark fine-grained --judge "$flag" \
        --judge-model "$ckpt" --data-json "$DATA_JSON" \
        --video-root "$VIDEO_ROOT" "${EXTRA[@]}"
  else
    # hermetic: the full rubric loop (34 prompts a pair, prefix cache
    # on) through one pair of one family, the most complex eval path
    run "fine_grained_$name" --benchmark fine-grained --judge "$flag" \
        --judge-model "$ckpt" --data-json "$DATA_JSON" \
        --video-root "$VIDEO_ROOT" --limit 1 "${EXTRA[@]}"
  fi
done
if [[ -n "${JUDGE_VIDEOSCORE:-}" ]]; then
  run overall_videoscore --benchmark overall --judge videoscore \
      --judge-model "$JUDGE_VIDEOSCORE" --data-json "$DATA_JSON" \
      --video-root "$VIDEO_ROOT" --device "${DEVICE:-cuda}"
  run genai_videoscore --benchmark genai --judge videoscore \
      --judge-model "$JUDGE_VIDEOSCORE" --device "${DEVICE:-cuda}"
fi

echo "reproduction results in $RESULTS_DIR"
[[ $HERMETIC == 1 ]] && echo "HERMETIC_OK"
exit 0
