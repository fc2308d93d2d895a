"""Serving from a checkpoint directory and decoded frames, on a card.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_card_serving.py --noconftest -m cuda -q

Without a card every test here skips.  The preprocessing on the card is
held within one level of the same frames' on the CPU (both compute the
resize in float64: summation orders differ only), and must not move when
the caller turns TF32 on; ``load_reward_model(device="cuda")`` gives the
CPU load's leaves bit for bit, and the checkpoint written from the card
reads back bit-equal.
"""

import numpy as np
import pytest
import torch

from mjvideo_tpu_torch import configs, init_reward_params
from mjvideo_tpu_torch.ops import preprocess as pre
from mjvideo_tpu_torch.utils.checkpoint import load_reward_model
from mjvideo_tpu_torch.utils.export import save_reward_checkpoint_dir


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run there with --noconftest -m cuda")
    return torch.device("cuda:0")


def _frames(n=2, h=720, w=1280, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, h, w, 3),
                                         dtype=np.uint8))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.cuda
@pytest.mark.parametrize("out", [(448, 448), (896, 1792)])
def test_card_resize_within_one_level_of_cpu(cuda_device, out):
    f = _frames()
    cpu = pre.resize_bicubic_device(f, *out)
    card = pre.resize_bicubic_device(f.to(cuda_device), *out).cpu()
    assert card.dtype == torch.float32 and card.shape == cpu.shape
    diff = (card - cpu).abs()
    assert diff.max().item() <= 1.0
    assert (diff > 0).float().mean().item() < 1e-3


@pytest.mark.cuda
def test_card_tiles_unchanged_by_tf32(cuda_device):
    f = _frames(seed=1).to(cuda_device)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        outs = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            outs.append((pre.tile_frames_device(f, 4, 2, 448,
                                                dtype=torch.float32),
                         pre.resize_bicubic_device(f, 448, 448,
                                                   quantize=False)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_load_reward_model_on_the_card_equals_the_cpu_load(cuda_device,
                                                           tmp_path):
    cfg = configs.tiny_test_config()
    state = init_reward_params(cfg, generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device,
        dtype=torch.bfloat16)
    save_reward_checkpoint_dir(str(tmp_path), state, cfg)
    _, card = load_reward_model(str(tmp_path))
    _, cpu = load_reward_model(str(tmp_path), device="cpu")
    card, cpu, made = _flat(card), _flat(cpu), _flat(state)
    assert set(card) == set(cpu) == set(made)
    for name, t in card.items():
        assert t.device.type == "cuda" and t.dtype == torch.bfloat16
        assert torch.equal(t.cpu(), cpu[name]), name
        assert torch.equal(t, made[name]), name
