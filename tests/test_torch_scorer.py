"""The port's RewardScorer against the JAX RewardScorer, and the port's
isolation from JAX.

Two clips with prompts of different lengths (``prepare_chat_input`` over the
``ByteTokenizer``) are padded into one bucket; fp32 on the CPU.  Scores agree
within atol 2e-5 (the bar of ``test_torch_models.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data.prompts import (ByteTokenizer, build_video_question,
                                      prepare_chat_input)
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models.reward import init_reward_params as jax_init
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
BUCKET = 512


def _clips(scorer_cfg, tok, rng):
    ids, gpos, frames = [], [], []
    for caption, n in (("a dog", 2), ("a much longer caption about a cat", 1)):
        chat = prepare_chat_input(scorer_cfg.chat, tok,
                                  build_video_question(caption, n),
                                  num_patches_list=[1] * n,
                                  gating_pattern=tok.gating_pattern())
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
        frames.append(n)
    size = scorer_cfg.chat.image_size
    pix = rng.normal(size=(sum(frames), size, size, 3)).astype(np.float32)
    return pix, ids, gpos


@pytest.fixture(scope="module")
def scorers():
    cfg = tiny_test_config()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init(key, cfg))(jax.random.PRNGKey(1)))
    tok = ByteTokenizer()
    common = dict(length_buckets=(BUCKET,), gating_pattern=tok.gating_pattern())
    jax_scorer = JaxRewardScorer(cfg, params, tok, attn_impl="xla",
                                 dtype=jnp.float32, **common)
    port = RewardScorer(cfg, from_jax_params(params, device="cpu"), tok,
                        dtype=torch.float32, **common)
    return jax_scorer, port, tok


def test_score_batch_matches_jax_scorer(scorers):
    jax_scorer, port, tok = scorers
    pix, ids, gpos = _clips(port.cfg, tok, np.random.default_rng(0))
    assert len(ids[0]) != len(ids[1])
    ref = jax_scorer.score_batch(pix, ids, gpos)
    got = port.score_batch(pix, ids, gpos)
    assert got.score.shape == (2,)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-5, err_msg=name)


def test_wrong_img_context_count_raises_in_both(scorers):
    jax_scorer, port, tok = scorers
    pix, ids, gpos = _clips(port.cfg, tok, np.random.default_rng(0))
    for scorer in (jax_scorer, port):
        with pytest.raises(ValueError, match="IMG_CONTEXT"):
            scorer.score_batch(pix[:-1], ids, gpos)


def test_port_scores_without_jax_and_without_library_attention():
    """In a fresh interpreter: import the port, score a tiny batch on the
    CPU, and find no ``jax`` module loaded.  No source file of the port may
    name PyTorch's fused attention or its compiler."""
    code = """
import sys
import numpy as np
import torch
import mjvideo_tpu_torch as mt
cfg = mt.tiny_test_config()
state = mt.init_reward_params(cfg, generator=torch.Generator().manual_seed(0),
                              device=torch.device("cpu"), dtype=torch.float32)
tok = mt.ByteTokenizer()
sc = mt.RewardScorer(cfg, state, tok, dtype=torch.float32,
                     length_buckets=(512,), gating_pattern=tok.gating_pattern())
chat = mt.prepare_chat_input(sc.cfg.chat, tok, mt.build_video_question("x", 1),
                             num_patches_list=[1],
                             gating_pattern=tok.gating_pattern())
pix = np.zeros((1, cfg.chat.image_size, cfg.chat.image_size, 3), np.float32)
out = sc.score_batch(pix, [chat.input_ids[0]], [chat.gating_pos])
assert torch.isfinite(out.score).all()
# Generation and the judge module import no jax either.
ch = cfg.chat
chat_state = mt.init_chat_params(ch, generator=torch.Generator().manual_seed(0),
                                 device=torch.device("cpu"),
                                 dtype=torch.float32, with_lm_head=True)
answer, _ = mt.chat(chat_state, ch, tok, "Hello?",
                    generation_config=mt.GenerationConfig(max_new_tokens=3))
assert isinstance(answer, str)
assert mt.parse_rating("RATING: Good") == 7
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    banned = ("scaled_dot_product_attention", "torch.compile")
    for path in (REPO / "mjvideo_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for word in banned:
            assert word not in text, f"{path} names {word}"
