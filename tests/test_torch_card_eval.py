"""The benchmark harness on a card, at a small depth.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_card_eval.py --noconftest -m cuda -q

Without a card every test here skips.  The 2B widths are cut to two ViT
and two decoder layers (the kernels need the 2B head dims); the videos come
from ``chip_smoke.seeded_video_source`` (the card's machine has no cv2 and
no PIL).  The eval CLI's scores must be bit-equal to ``score_batch`` of the
in-memory state it exported, on the same frames; ``Trainer.evaluate``
launches K1 and K2 and neither lse form nor a backward kernel.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from mjvideo_tpu_torch import (
    ByteTokenizer,
    RewardScorer,
    init_reward_params,
    kernels,
    mjvideo_2b_config,
)

LAYERS = 2
FRAMES = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _shallow_2b():
    cfg = mjvideo_2b_config()
    chat = cfg.chat
    chat = dataclasses.replace(
        chat,
        vision=dataclasses.replace(chat.vision, num_hidden_layers=LAYERS),
        llm=dataclasses.replace(chat.llm, num_hidden_layers=LAYERS))
    return dataclasses.replace(cfg, chat=chat)


@pytest.fixture
def records(tmp_path):
    recs = chip_smoke.eval_records(4)
    path = tmp_path / "pairs.json"
    path.write_text(json.dumps(recs))
    return str(path), str(tmp_path / "videos"), recs


@pytest.mark.cuda
def test_card_eval_cli_scores_bit_equal_score_batch(cuda_device, records,
                                                    tmp_path):
    from mjvideo_tpu_torch.eval import cli as eval_cli
    from mjvideo_tpu_torch.eval.preference import iter_jsonl
    from mjvideo_tpu_torch.utils.export import save_reward_checkpoint_dir

    cfg = _shallow_2b()
    state = init_reward_params(
        cfg, generator=torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device, dtype=torch.bfloat16)
    ckpt = tmp_path / "ckpt"
    save_reward_checkpoint_dir(str(ckpt), state, cfg)
    path, root, recs = records
    results = tmp_path / "res.jsonl"
    with chip_smoke.seeded_video_source((72, 128)):
        kernels.reset_launch_counts()
        eval_cli.main(["--benchmark", "overall", "--byte-tokenizer",
                       "--device-preprocess", "--model-path", str(ckpt),
                       "--data-json", path, "--video-root", root,
                       "--num-segments", str(FRAMES),
                       "--results", str(results)])
        torch.cuda.synchronize()
        assert kernels.launch_counts["vit_attention"] == LAYERS * len(recs)
        assert kernels.launch_counts["decoder_attention"] == LAYERS * len(
            recs)
        tok = ByteTokenizer(pad_token_id=cfg.chat.llm.pad_token_id)
        ref = RewardScorer(cfg, state, tok, gating_pattern=tok.gating_pattern(),
                           device_preprocess=True)
        rows = sorted(iter_jsonl(str(results)), key=lambda r: r["id"])
        assert len(rows) == len(recs)
        for rec, row in zip(recs, rows):
            clips = [ref.prepare_clip(os.path.join(root, rec[f"video_{v}_path"]),
                                      rec["caption"], num_segments=FRAMES)
                     for v in (0, 1)]
            out = ref.score_batch(np.concatenate([c[0] for c in clips]),
                                  [c[1] for c in clips], [c[2] for c in clips])
            got = out.score.float().cpu().tolist()
            assert got == [row["score_0"], row["score_1"]]


@pytest.mark.cuda
def test_card_trainer_evaluate_launches_no_lse_form(cuda_device, records,
                                                    tmp_path):
    from mjvideo_tpu_torch.data.dataset import (
        PairCollator,
        PreferencePairDataset,
        batched,
    )
    from mjvideo_tpu_torch.data.prompts import rebase_img_context_id
    from mjvideo_tpu_torch.train.trainer import TrainConfig, Trainer

    tok = ByteTokenizer()
    cfg = rebase_img_context_id(_shallow_2b(), tok)
    state = init_reward_params(
        cfg, generator=torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device, dtype=torch.bfloat16)
    tr = Trainer(cfg, state, TrainConfig(stage=3,
                                         checkpoint_dir=str(tmp_path / "t")))
    path, root, recs = records
    with chip_smoke.seeded_video_source():
        ds = PreferencePairDataset(path, tok, cfg.chat, root=root,
                                   num_segments=2, overall=True,
                                   gating_pattern=tok.gating_pattern())
        batches = list(batched(ds, PairCollator(cfg.chat.llm.pad_token_id),
                               1))
    before = {k: v.clone() for k, v in chip_smoke._flat_state(
        tr.params).items()}
    kernels.reset_launch_counts()
    res = tr.evaluate(batches)
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.launch_counts.items() if v}
    n = 2 * len(batches) * LAYERS
    assert got == {"vit_attention": n, "decoder_attention": n,
                   "key_norm_max": 2 * n}
    assert res["preference"]["count"] == len(batches) == 2
    for k, v in chip_smoke._flat_state(tr.params).items():
        assert torch.equal(v, before[k]), k
