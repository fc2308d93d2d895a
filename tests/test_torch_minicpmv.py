"""The port's MiniCPM-V-2.6 (``mjvideo_tpu_torch/models/minicpmv.py``,
``data/judge_templates.py``, ``MiniCPMVJudge`` and the CLI's ``--judge
minicpm-v``) against the JAX package, in fp32 on the CPU.

A tiny MiniCPM-V: the SigLIP tower at 2 layers x 144 wide with 2 heads of
72 (the real head dim: K1's twin), a resampler of 6 queries over 4 heads of
16, a 2-layer Qwen2 (4/2 heads of 16, q/k/v biases, an untied head) whose
320-row vocabulary holds the special ids (300-304).  JAX's weights
(``init_minicpmv_params``) cross by ``utils.bridge.minicpmv_from_jax``; JAX
runs ``attn_impl="xla"``.  Tolerances: activations within 1e-4 of the
reference's largest magnitude, cached teacher-forced logits atol 1e-4
against JAX's uncached forward; greedy tokens equal where every step's
top-2 margin exceeds 1e-3 (checked); the sin-cos table, resize rule,
preprocessing, prompt ids, templates and importer leaves exact.  No
``transformers`` import.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mjvideo_tpu.configs import LLMConfig as JLLMConfig
from mjvideo_tpu.data import judge_templates as jt_templates
from mjvideo_tpu.data.prompts import ByteTokenizer as JByteTokenizer
from mjvideo_tpu.eval import judges as jj
from mjvideo_tpu.models import minicpmv as jm
from mjvideo_tpu.models.videoscore import SigLIPVisionConfig as JSig
from mjvideo_tpu_torch.configs import LLMConfig
from mjvideo_tpu_torch.data import judge_templates as tt_templates
from mjvideo_tpu_torch.data.prompts import ByteTokenizer
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.models import minicpmv as tm
from mjvideo_tpu_torch.models.generate import stack_prefix_states
from mjvideo_tpu_torch.models.videoscore import SigLIPVisionConfig
from mjvideo_tpu_torch.utils.bridge import minicpmv_from_jax, to_numpy

torch.set_num_threads(1)

REL = 1e-4
ATOL = 1e-4
MARGIN = 1e-3
NEW = 6
VISION = dict(hidden_size=144, intermediate_size=288, num_hidden_layers=2,
              num_attention_heads=2, patch_size=14, image_size=70)
RESAMPLER = dict(num_queries=6, embed_dim=64, num_heads=4, kv_dim=144)
TEXT = dict(architecture="llama", vocab_size=320, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4,
            rms_norm_eps=1e-6, pad_token_id=0, max_position_embeddings=4096,
            bias=True)
IDS = dict(im_start_token_id=300, im_end_token_id=301,
           image_start_token_id=302, image_end_token_id=303,
           unk_token_id=304, scale_resolution=42)


def _configs():
    jcfg = jm.MiniCPMVConfig(vision=JSig(**VISION),
                             resampler=jm.ResamplerConfig(**RESAMPLER),
                             text=JLLMConfig(**TEXT), **IDS)
    tcfg = tm.MiniCPMVConfig(vision=SigLIPVisionConfig(**VISION),
                             resampler=tm.ResamplerConfig(**RESAMPLER),
                             text=LLMConfig(**TEXT), **IDS)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    jp = jax.tree.map(np.asarray,
                      jm.init_minicpmv_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jp, minicpmv_from_jax(jp, device="cpu")


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _np(t):
    return t.detach().cpu().numpy()


def _published():
    """The tiny config as an HF ``config.json`` can state it: the published
    special ids and pad id (the config carries none), the real
    151,666-row vocabulary, the resampler at the hidden size's heads of 128
    (``minicpmv_config_from_hf`` derives them), so a width of 128."""
    base = tm.MiniCPMVConfig()
    _, tcfg = _configs()
    return dataclasses.replace(
        tcfg, resampler=tm.ResamplerConfig(num_queries=6, embed_dim=128,
                                           num_heads=1, kv_dim=144),
        text=dataclasses.replace(tcfg.text, vocab_size=151666,
                                 hidden_size=128, pad_token_id=151643),
        **{k: getattr(base, k) for k in IDS if k != "scale_resolution"})


def _pixels(seed, n, h=28, w=42):
    return np.random.default_rng(seed).normal(
        size=(n, h, w, 3)).astype(np.float32)


# --- templates, configs, importers --------------------------------------------

def test_judge_templates_are_the_jax_package_s():
    for name in ("MINICPM_IMAGE_PATTERN", "MINICPM_IM_START",
                 "MINICPM_IM_END", "MINICPM_SLICE_START",
                 "MINICPM_SLICE_END", "MINICPM_UNK", "MINICPM_CHAT_PREFIX",
                 "MINICPM_CHAT_SUFFIX", "COGVLM2_ANSWER_FORMAT"):
        assert getattr(tt_templates, name) == getattr(jt_templates, name)
    for n, q in ((0, "hi"), (1, "Rate it."), (3, "a\nb")):
        assert tt_templates.minicpm_video_prompt(n, q, 6) == \
            jt_templates.minicpm_video_prompt(n, q, 6)
        assert tt_templates.minicpm_video_segments(n, q, 6) == \
            jt_templates.minicpm_video_segments(n, q, 6)
    for version in ("chat", "vqa", "base"):
        assert tt_templates.cogvlm2_history_to_prompt(
            "q", [("a", "b")], version) == \
            jt_templates.cogvlm2_history_to_prompt("q", [("a", "b")],
                                                   version)


def test_configs_and_importer_leaves_equal_jax(model):
    """The HF config written and read back (at the published special ids,
    which the config does not carry) by both packages; one HF-named state
    (``vpm.*``, ``resampler.*``, ``llm.*`` without Qwen2's o_proj bias)
    through both importers: every leaf equal to JAX's and to its source;
    the random tree's shapes are the importer's."""
    jcfg, tcfg, jp, tp = model
    for published in (tm.MiniCPMVConfig(), _published()):
        hf = tm.minicpmv_config_to_hf(published)
        assert tm.minicpmv_config_from_hf(hf) == published
        assert dataclasses.asdict(jm.minicpmv_config_from_hf(hf)) == \
            dataclasses.asdict(published)
    state = {k: v.contiguous() for k, v in
             chip_smoke.minicpmv_hf_state(tp, tcfg).items()}
    assert not any(k.endswith("o_proj.bias") for k in state)
    got = tm.import_minicpmv_params(state, tcfg, device="cpu")
    want = jm.import_minicpmv_params({k: v.numpy() for k, v in
                                      state.items()}, jcfg)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want)))
    flat_src = dict(jax.tree_util.tree_leaves_with_path(to_numpy(tp)))
    flat_got = jax.tree_util.tree_leaves_with_path(to_numpy(got))
    assert len(flat_got) == len(flat_want) == len(flat_src)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[path], str(path))
        np.testing.assert_array_equal(leaf, flat_src[path], str(path))
    init = tm.init_minicpmv_params(tcfg, generator=torch.Generator()
                                   .manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: a.shape, to_numpy(init)) == \
        jax.tree.map(lambda a: a.shape, jp)


def test_sincos_resize_and_preprocess_equal_jax():
    for grid in ((2, 3), (24, 43), (1, 1)):
        np.testing.assert_array_equal(tm.get_2d_sincos_pos_embed(64, grid),
                                      jm.get_2d_sincos_pos_embed(64, grid))
    for w, h in ((1280, 720), (640, 360), (56, 40), (100, 300), (448, 448)):
        for up in (True, False):
            assert tm.find_best_resize(w, h, allow_upscale=up) == \
                jm.find_best_resize(w, h, allow_upscale=up)
    # MiniCPM-V's frames at 1280 x 720: 602 x 336, 43 x 24 patches.
    assert tm.find_best_resize(1280, 720) == (602, 336)
    _, tcfg = _configs()
    jcfg, _ = _configs()
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
              for _ in range(2)]
    np.testing.assert_array_equal(tm.preprocess_video_frames(frames, tcfg),
                                  jm.preprocess_video_frames(frames, jcfg))


def test_prompt_builders_equal_jax():
    jcfg, tcfg = _configs()
    for n, q in ((1, "Rate it."), (3, "Which video is better?")):
        got = tm.build_video_prompt_ids(ByteTokenizer(), tcfg, n, q)
        want = jm.build_video_prompt_ids(JByteTokenizer(), jcfg, n, q)
        np.testing.assert_array_equal(got, want)
        p, s = tm.build_video_prompt_prefix_suffix(ByteTokenizer(), tcfg, n,
                                                   q)
        assert (p, s) == jm.build_video_prompt_prefix_suffix(
            JByteTokenizer(), jcfg, n, q)
        assert p + s == got[0].tolist()
        assert (got == tcfg.unk_token_id).sum() == n * 6


# --- the forward ---------------------------------------------------------------

def test_resampler_and_vision_embedding_match_jax(model):
    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(5).normal(size=(3, 6, 144)).astype(np.float32)
    want = np.asarray(jm.resampler_forward(jp["resampler"], jcfg.resampler,
                                           jnp.asarray(x), (2, 3)))
    _close(_np(tm.resampler_forward(tp["resampler"], tcfg.resampler,
                                    torch.from_numpy(x), (2, 3))), want)
    pix = _pixels(6, 2)
    want = np.asarray(jm.get_vision_embedding(jp, jcfg, jnp.asarray(pix),
                                              attn_impl="xla"))
    got = tm.get_vision_embedding(tp, tcfg, torch.from_numpy(pix))
    assert got.shape == (2, 6, 64)
    _close(_np(got), want)


def _items(cfg, seed, frames=(1, 2)):
    rng = np.random.default_rng(seed)
    items = []
    for b, n in enumerate(frames):
        ids = tm.build_video_prompt_ids(ByteTokenizer(), cfg, n,
                                        "Rate it" + "!" * b)
        items.append((ids, _pixels(int(rng.integers(1 << 30)), n)))
    return items


def test_minicpmv_forward_logits_match_jax(model):
    jcfg, tcfg, jp, tp = model
    ids, pix = _items(tcfg, 7, frames=(2,))[0]
    mask = np.ones_like(ids)
    h = jm.minicpmv_forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                            jnp.asarray(pix), attn_impl="xla")
    want = np.asarray(jm.lm_logits(jp, h))
    got = tm.lm_logits(tp, tm.minicpmv_forward(
        tp, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(pix)))
    _close(_np(got), want)


def _reference_logits(jcfg, jp, item, toks):
    """JAX's uncached forward over prompt + tokens: the logits after each
    of the first len(toks) positions from the prompt's last token on."""
    ids, pix = item
    full = np.concatenate([ids, np.asarray([toks[:-1]], ids.dtype)], 1)
    h = jm.minicpmv_forward(jp, jcfg, jnp.asarray(full),
                            jnp.ones(full.shape, jnp.int32), jnp.asarray(pix),
                            attn_impl="xla")
    T = ids.shape[1]
    return np.asarray(jm.lm_logits(jp, h))[0, T - 1:T - 1 + len(toks)]


def _margins_ok(logits):
    top2 = torch.topk(torch.as_tensor(logits), 2, dim=-1).values
    return bool(((top2[..., 0] - top2[..., 1]) > MARGIN).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_cached_generation_matches_jax(model, seed):
    """Two prompts of 1 and 2 frames, batched: the port's teacher-forced
    cached logits on JAX's greedy tokens against JAX's uncached forward
    (atol 1e-4), and the port's greedy tokens equal to JAX's
    ``greedy_generate_batch``'s (every step's top-2 margin above 1e-3)."""
    jcfg, tcfg, jp, tp = model
    items = _items(tcfg, seed)
    want = jm.greedy_generate_batch(jp, jcfg, items, max_new_tokens=NEW,
                                    eos_token_id=-1, attn_impl="xla")
    teacher = torch.tensor(want)
    logits = tm.greedy_generate_batch(tp, tcfg, items, max_new_tokens=NEW,
                                      eos_token_id=-1, teacher_tokens=teacher)
    for b, item in enumerate(items):
        np.testing.assert_allclose(
            _np(logits[b]), _reference_logits(jcfg, jp, item, want[b]),
            atol=ATOL)
    assert _margins_ok(logits)
    assert tm.greedy_generate_batch(tp, tcfg, items, max_new_tokens=NEW,
                                    eos_token_id=-1) == want
    assert tm.greedy_generate(tp, tcfg, *items[0], max_new_tokens=NEW,
                              eos_token_id=-1) == want[0]


def test_prefix_path_equals_the_full_prompt(model):
    """``prefill_prefix`` of the headers and frame blocks and
    ``continue_prefix`` of a question: the full prompt's tokens and,
    teacher-forced, its logits (the suffix runs over the whole cache at
    ``q_offset`` = P); the state is unchanged by use."""
    _, tcfg, _, tp = model
    tok = ByteTokenizer()
    pix = torch.from_numpy(_pixels(8, 2))
    vis = tm.get_vision_embedding(tp, tcfg, pix)
    prefix, suffix = tm.build_video_prompt_prefix_suffix(tok, tcfg, 2,
                                                         "Rate it.")
    ids = tm.build_video_prompt_ids(tok, tcfg, 2, "Rate it.")
    full = tm.greedy_generate_batch(tp, tcfg, [(ids, None)],
                                    max_new_tokens=NEW, eos_token_id=-1,
                                    vision_embeds=[vis])
    Pb = 64
    state = tm.prefill_prefix(tp, tcfg, prefix, vis, max_len=Pb + 32 + NEW,
                              bucket=Pb)
    before = [t.clone() for t in state.cache if t is not None]
    toks, n = tm.continue_prefix(tp, tcfg, state, suffix, 32, NEW, -1)
    assert [toks[0, : n[0]].tolist()] == full
    teacher = torch.tensor(full)
    a = tm.continue_prefix(tp, tcfg, state, suffix, 32, NEW, -1,
                           teacher_tokens=teacher)
    b = tm.greedy_generate_batch(tp, tcfg, [(ids, None)], max_new_tokens=NEW,
                                 eos_token_id=-1, vision_embeds=[vis],
                                 teacher_tokens=teacher)
    np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)
    assert all(torch.equal(x, y) for x, y in
               zip(before, [t for t in state.cache if t is not None]))
    stacked = stack_prefix_states([state, state])
    assert stacked.mask.shape[0] == 2 and stacked.P == state.P
    assert stacked.cache.k.shape[1] == 2


# --- the judge and the CLI -----------------------------------------------------

def _write_video(path, seed, frames=10, size=(40, 56)):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                        (size[1], size[0]))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 255, size + (3,), dtype=np.uint8))
    w.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvids")
    paths = [str(root / "a.mp4"), str(root / "b.mp4")]
    for seed, path in enumerate(paths):
        _write_video(path, seed)
    return paths


JUDGE = dict(num_segments=3, max_new_tokens=NEW, suffix_bucket=32)


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix", "full"])
def test_judge_answers_equal_jax(model, videos, prefix_cache):
    """``MiniCPMVJudge`` on two cv2-written videos by the prefix path and
    the full prompt (the overall prompt, past the suffix bucket, always
    takes it): ``ask``, ``ask_batch`` and ``judge_pair`` give JAX's
    answers, and the prefix path's answers are the full prompt's."""
    jcfg, tcfg, jp, tp = model
    jjudge = jj.MiniCPMVJudge(jcfg, jp, JByteTokenizer(), attn_impl="xla",
                              prefix_cache=prefix_cache, **JUDGE)
    tjudge = tj.MiniCPMVJudge(tcfg, tp, ByteTokenizer(),
                              prefix_cache=prefix_cache, **JUDGE)
    q = "Rate it."
    assert tjudge.ask(q, videos[0]) == jjudge.ask(q, videos[0])
    answers = tjudge.ask_batch(q, videos)
    assert answers == jjudge.ask_batch(q, videos) and any(answers)
    assert (tj.judge_pair(tjudge, *videos, "a fox")
            == jj.judge_pair(jjudge, *videos, "a fox"))
    assert tjudge._prep.cache_info().currsize == 2
    if prefix_cache:
        assert tjudge._pstate.cache_info().hits >= 1
        full = tj.MiniCPMVJudge(tcfg, tp, ByteTokenizer(),
                                prefix_cache=False, **JUDGE)
        assert full.ask_batch(q, videos) == answers


def test_eval_cli_minicpmv_branch(videos, tmp_path, monkeypatch):
    """``--judge minicpm-v --byte-tokenizer --device cpu`` on a directory
    of the published names (``_published``'s config): every results row
    equal to the port's judge on the state read back as the CLI reads it,
    ratings and answers.  The CLI loads a judge in bf16, as JAX's does; its
    importer is called here at fp32, which decodes faster on the CPU."""
    from mjvideo_tpu_torch.eval import cli
    from mjvideo_tpu_torch.utils.checkpoint import load_safetensors_dir

    tcfg = _published()
    tp = tm.init_minicpmv_params(tcfg, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    d = str(tmp_path / "ckpt")
    chip_smoke.write_hf_dir(d, tm.minicpmv_config_to_hf(tcfg),
                            chip_smoke.minicpmv_hf_state(tp, tcfg))
    (tmp_path / "v").mkdir()
    root = str(tmp_path / "v")
    for name, src in zip(("a.mp4", "b.mp4"), videos):
        shutil.copy(src, f"{root}/{name}")
    records = [{"caption": "a fox", "video_0_path": "a.mp4",
                "video_1_path": "b.mp4",
                "overall_preference": "Video 1 better"}]
    data = tmp_path / "pairs.json"
    data.write_text(json.dumps(records))
    results = tmp_path / "res.jsonl"
    real = tm.import_minicpmv_params
    monkeypatch.setattr(tm, "import_minicpmv_params",
                        lambda state, cfg, dtype, device: real(
                            state, cfg, torch.float32, device))
    cli.main(["--benchmark", "overall", "--judge", "minicpm-v",
              "--judge-model", d, "--byte-tokenizer", "--device", "cpu",
              "--data-json", str(data), "--video-root", root,
              "--num-segments", "3", "--results", str(results)])
    row = json.loads(results.read_text().splitlines()[0])
    cfg = tm.minicpmv_config_from_hf(json.loads(
        open(f"{d}/config.json").read()))
    assert cfg == tcfg
    params = real(load_safetensors_dir(d), cfg, dtype=torch.float32,
                  device="cpu")
    judge = tj.MiniCPMVJudge(cfg, params, ByteTokenizer(), num_segments=3)
    want = tj.judge_pair(judge, f"{root}/a.mp4", f"{root}/b.mp4", "a fox")
    assert (row["score_0"], row["score_1"], row["response_0"],
            row["response_1"]) == want
