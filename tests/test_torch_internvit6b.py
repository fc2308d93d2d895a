"""The port's InternViT-6B tower and the InternVL2-26B / -8B judges against
the JAX package, fp32 on the CPU.

The presets equal JAX's field for field, and their parameter counts, read
from shapes on the ``meta`` device (nothing drawn), are the published
sizes within 2% (``tests/test_size_presets.py``: 8.08e9 and 25.5e9).  A
tiny 6B-shaped tower (5 heads of 128, RMSNorm, QK-RMSNorm over the whole
width, with and without the qkv bias, q/k norm weights away from 1),
JAX's weights carried by ``from_jax_params``: one block and
``vit_forward`` within atol 1e-5 of ``mjvideo_tpu.models.vit``.  A tiny
26B-shaped chat config (the tower at 2 heads of 128, a 2-layer
InternLM2 decoder with 12/2 heads: GQA group 6) through
``extract_feature`` (atol 1e-5) and ``InternVLJudge`` by the prefix path
and the full prompt: greedy tokens equal to JAX's judge built directly,
where every step's top-2 margin exceeds 1e-3 (checked), and the port's
teacher-forced logits within atol 1e-4 of JAX's by one uncached forward
over each row's prompt and tokens.  A 26B-layout directory written by the
port's exporter reads back bit-equal through the port's importer and to
the same tensors through JAX's; the port's CLI on it gives JAX's judge's
results.  The chip script's layer-at-a-time state has
``init_chat_params``'s tree, and the 300M state keeps its draws.
"""

import dataclasses
import hashlib
import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mjvideo_tpu import configs as jconfigs
from mjvideo_tpu.data.prompts import ByteTokenizer as JByteTokenizer
from mjvideo_tpu.eval import judges as jj
from mjvideo_tpu.models import decoder as jdec
from mjvideo_tpu.models import internvl as jinternvl
from mjvideo_tpu.models import vit as jvit
from mjvideo_tpu.utils import checkpoint as jckpt
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch.data.prompts import ByteTokenizer, prepare_chat_input
from mjvideo_tpu_torch.data.prompts import build_video_question
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.models import vit as tvit
from mjvideo_tpu_torch.models.internvl import (
    extract_feature,
    init_chat_params,
)
from mjvideo_tpu_torch.utils.bridge import from_jax_params, map_state
from mjvideo_tpu_torch.utils.checkpoint import (
    import_chat_params,
    load_safetensors_dir,
)
from mjvideo_tpu_torch.utils.export import export_chat

torch.set_num_threads(1)

ATOL_VISION = 1e-5
ATOL = 1e-4
MARGIN = 1e-3
NEW = 6
SEGMENTS = 2
# InternViT-6B's block at 5 heads of 128 (the real head dim), 2 layers.
TOWER = dict(hidden_size=640, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=5, image_size=56, patch_size=14,
             qk_normalization=True, norm_type="rms_norm")
# The 26B judge's shape: the 6B tower's norms and heads of 128 (the
# preset's qkv bias), and an InternLM2 decoder with GQA group 6.
CHAT_VISION = dict(TOWER, hidden_size=256, num_attention_heads=2)
CHAT_LLM = dict(vocab_size=272, hidden_size=192, intermediate_size=384,
                num_hidden_layers=2, num_attention_heads=12,
                num_key_value_heads=2, pad_token_id=0, rope_theta=1e6)
CHAT_IDS = dict(template="internlm2-chat", img_context_token_id=260,
                img_start_token_id=258, img_end_token_id=259)


def _chat_configs():
    """(JAX's, the port's) tiny 26B-shaped ChatConfig."""
    return tuple(m.ChatConfig(vision=m.VisionConfig(**CHAT_VISION),
                              llm=m.LLMConfig(**CHAT_LLM), **CHAT_IDS)
                 for m in (jconfigs, tconfigs))


def _np(t):
    return t.detach().numpy()


# --- presets -----------------------------------------------------------------

PRESETS = {"8b": ("internvl2_8b_chat_config", 8.08e9),
           "26b": ("internvl2_26b_chat_config", 25.5e9)}


@pytest.mark.parametrize("size", sorted(PRESETS))
def test_presets_equal_jax(size):
    name = PRESETS[size][0]
    got = getattr(tconfigs, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(
        getattr(jconfigs, name)())
    import mjvideo_tpu_torch

    assert getattr(mjvideo_tpu_torch, name)() == got
    assert got.llm.head_dim == 128 and got.template == "internlm2-chat"
    if size == "26b":
        v = got.vision
        assert (v.norm_type, v.qk_normalization, v.head_dim,
                v.num_attention_heads) == ("rms_norm", True, 128, 25)
        # As JAX's preset: the default (ROADMAP Queue 3 asks after the
        # published config's value).
        assert v.qkv_bias


@pytest.mark.parametrize("size", sorted(PRESETS))
def test_preset_param_counts_from_shapes(size):
    """The judge's state (with its LM head) on the ``meta`` device: shapes
    only, nothing drawn; the count is JAX's (``jax.eval_shape``) and the
    published size within 2%."""
    name, published = PRESETS[size]
    cfg = getattr(tconfigs, name)()
    state = init_chat_params(cfg, generator=None,
                             device=torch.device("meta"),
                             dtype=torch.bfloat16, with_lm_head=True)
    leaves = []
    map_state(leaves.append, state)
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in leaves)
    shapes = jax.eval_shape(lambda k: jinternvl.init_chat_params(
        k, getattr(jconfigs, name)(), with_lm_head=True),
        jax.random.PRNGKey(0))
    assert n == sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    assert abs(n - published) / published < 0.02, n


def test_state_by_layer_has_init_chat_params_tree():
    """``chip_smoke.init_chat_params_by_layer`` (the 26B's state on the card,
    drawn a layer at a time into bf16) has ``init_chat_params``'s leaves,
    shapes and dtypes, its constants, and N(0, 0.02) draws, each layer of a
    stack its own."""
    _, cfg = _chat_configs()
    want = init_chat_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.bfloat16,
                            with_lm_head=True)
    got = chip_smoke.init_chat_params_by_layer(
        cfg, torch.Generator().manual_seed(0), "cpu")

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: v})
        return out

    want, got = flat(want), flat(got)
    assert list(got) == list(want)
    for name, t in got.items():
        assert (t.shape, t.dtype) == (want[name].shape, want[name].dtype)
        leaf = name.split(".")[-1]
        if leaf in ("weight", "bias", "ls1", "ls2"):
            assert torch.equal(t, want[name]), name
        else:
            std = t.float().std().item()
            assert 0.015 < std < 0.025, (name, std)
    w1 = got["language_model.layers.feed_forward.w1.kernel"]
    assert not torch.equal(w1[0], w1[1])


def test_300m_state_keeps_its_draws():
    """The 6B family adds leaves without drawing anything more: the 300M
    chat state of ``tiny_test_config`` keeps the bits it had before the 6B
    tower was ported (the digest of its leaves in order, seed 0, fp32),
    and a 6B tower of the same shapes draws the same random leaves."""
    cfg = tconfigs.tiny_test_config().chat
    state = init_chat_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32,
                             with_lm_head=True)
    digest = hashlib.sha256()
    map_state(lambda t: digest.update(t.contiguous().view(torch.uint8)
                                      .numpy().tobytes()), state)
    assert digest.hexdigest()[:16] == "5255b2a1dadca1f9"
    six = dataclasses.replace(cfg.vision, norm_type="rms_norm",
                              qk_normalization=True)
    kw = dict(device="cpu", dtype=torch.float32)
    a = tvit.init_vit_params(cfg.vision,
                             generator=torch.Generator().manual_seed(3), **kw)
    b = tvit.init_vit_params(six, generator=torch.Generator().manual_seed(3),
                             **kw)
    for key in ("qkv", "proj"):
        assert torch.equal(a["layers"]["attn"][key]["kernel"],
                           b["layers"]["attn"][key]["kernel"])
    assert torch.equal(a["layers"]["mlp"]["fc2"]["kernel"],
                       b["layers"]["mlp"]["fc2"]["kernel"])
    assert "bias" not in b["layers"]["norm1"]
    assert set(b["layers"]["attn"]) == {"qkv", "proj", "q_norm", "k_norm"}


# --- the tower ---------------------------------------------------------------

def _tower(qkv_bias):
    """JAX's tiny 6B tower with its biases, LayerScale and q/k norm weights
    away from their initial values, the port's config and its state."""
    jcfg = jconfigs.VisionConfig(**TOWER, qkv_bias=qkv_bias)
    tcfg = tconfigs.VisionConfig(**TOWER, qkv_bias=qkv_bias)
    p = jax.jit(lambda key: jvit.init_vit_params(key, jcfg))(
        jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    L, C = TOWER["num_hidden_layers"], TOWER["hidden_size"]
    lay = p["layers"]
    for node, key in ((lay["attn"]["q_norm"], "weight"),
                      (lay["attn"]["k_norm"], "weight"),
                      (lay["norm1"], "weight"), (lay["ls1"], None)):
        vals = jnp.asarray(rng.uniform(0.5, 2.0, (L, C)).astype(np.float32))
        if key is None:
            lay["ls1"] = vals
        else:
            node[key] = vals
    if qkv_bias:
        lay["attn"]["qkv"]["bias"] = jnp.asarray(
            rng.normal(0, 0.1, (L, 3 * C)).astype(np.float32))
    return jcfg, tcfg, p, from_jax_params(p, device="cpu")


def _pixels(n, size, seed):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("qkv_bias", [False, True],
                         ids=["published", "preset"])
def test_6b_block_and_tower_match_jax(qkv_bias):
    jcfg, tcfg, jp, tp = _tower(qkv_bias)
    assert ("bias" in tp["layers"]["attn"]["qkv"]) == qkv_bias
    assert "bias" not in tp["layers"]["norm1"]
    pix = _pixels(2, TOWER["image_size"], 6)
    x = jvit.embeddings(jp["embeddings"], jcfg, jnp.asarray(pix))
    layer0 = jax.tree.map(lambda a: a[0], jp["layers"])
    ref = jax.jit(lambda p, x: jvit._block(jcfg, p, x, "auto"))(layer0, x)
    got = tvit._block(tcfg, map_state(lambda a: a[0], tp["layers"]),
                      torch.from_numpy(np.array(x)), "auto")
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL_VISION)
    ref = jvit.vit_forward(jp, jcfg, jnp.asarray(pix))
    got = tvit.vit_forward(tp, tcfg, torch.from_numpy(pix))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL_VISION)
    # The tower's own init: JAX's tree (leaves and shapes).
    mine = tvit.init_vit_params(tcfg, generator=None, device="meta",
                                dtype=torch.float32)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tp))


# --- the judge ---------------------------------------------------------------

@pytest.fixture(scope="module")
def chat():
    jcfg, tcfg = _chat_configs()
    jp = jax.jit(lambda key: jinternvl.init_chat_params(
        key, jcfg, with_lm_head=True))(jax.random.PRNGKey(7))
    return jcfg, tcfg, jp, from_jax_params(jp, device="cpu")


def test_extract_feature_matches_jax_at_26b_shape(chat):
    jcfg, tcfg, jp, tp = chat
    pix = _pixels(3, CHAT_VISION["image_size"], 8)
    ref = jinternvl.extract_feature(jp, jcfg, jnp.asarray(pix))
    got = extract_feature(tp, tcfg, torch.from_numpy(pix))
    assert got.shape == (3, tcfg.num_image_token, CHAT_LLM["hidden_size"])
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL_VISION)


def _write_video(path, seed, frames=10, size=48):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                        (size, size))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    w.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("ivl")
    paths = [str(root / "a.mp4"), str(root / "b.mp4")]
    for seed, path in enumerate(paths):
        _write_video(path, seed + 11)
    return paths


def _jax_forced_logits(jcfg, jp, ids, vis, toks):
    """JAX's logits at each of a row's generated steps with ``toks`` fed
    back: one uncached forward over the prompt ``ids`` and the tokens,
    (n, V)."""
    lm = jp["language_model"]
    seq = jnp.asarray(np.concatenate([ids, toks[:-1]])[None])
    emb = jinternvl.scatter_image_embeds(jdec.embed_tokens(lm, seq), seq,
                                         vis, jcfg.img_context_token_id)
    h = jdec.decoder_forward(lm, jcfg.llm, emb, jnp.ones_like(seq),
                             remat=False)
    return np.asarray(jdec.lm_logits(lm, h[0, len(ids) - 1:]))


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "full"])
def test_internvl_judge_matches_jax_at_26b_shape(chat, videos, prefix):
    """A pair's question by the prefix path, or by the full prompt (the
    path of a question past the suffix bucket, such as the overall
    prompt: here the bucket is cut to 4 tokens): the port's answers are
    JAX's judge's, and its teacher-forced logits on its greedy tokens are
    JAX's to ATOL."""
    jcfg, tcfg, jp, tp = chat
    kw = dict(num_segments=SEGMENTS, max_new_tokens=NEW,
              suffix_bucket=128 if prefix else 4)
    jjudge = jj.InternVLJudge(jcfg, jp, JByteTokenizer(), attn_impl="xla",
                              **kw)
    tjudge = tj.InternVLJudge(tcfg, tp, ByteTokenizer(), **kw)
    prompt = "Which video is better?"
    assert (tjudge._prefix_inputs(prompt, videos) is not None) == prefix
    answers = tjudge.ask_batch(prompt, videos)
    assert answers == jjudge.ask_batch(prompt, videos)
    toks = chip_smoke.path_runner(tjudge, prompt, videos, prefix)()
    got = chip_smoke.path_runner(tjudge, prompt, videos, prefix)(
        teacher_tokens=toks)
    eos = tj._eos_pad(tcfg, tjudge.tokenizer)[0]
    for b, path in enumerate(videos):
        vis, npl = tjudge._prep(path)
        ids = prepare_chat_input(tcfg, tjudge.tokenizer,
                                 build_video_question(prompt, len(npl)),
                                 num_patches_list=list(npl),
                                 require_gating=False).input_ids[0]
        row = toks[b].numpy()
        n = int(np.argmax(row == eos)) + 1 if (row == eos).any() else NEW
        ref = _jax_forced_logits(jcfg, jp, np.asarray(ids), jjudge._prep(
            path)[0], row[:n])
        np.testing.assert_allclose(_np(got[b, :n]), ref, atol=ATOL)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


# --- the checkpoint directory and the CLI ------------------------------------

def _write_dir(path, tcfg, tp):
    """A 26B-layout directory (the port's exporter and writer)."""
    chip_smoke.write_hf_dir(str(path), tconfigs.reward_config_to_hf(
        tconfigs.RewardConfig(chat=tcfg)), export_chat(tp, tcfg))


def test_26b_layout_directory_round_trips(chat, tmp_path):
    """The exporter writes the 6B tower's names (``attn.q_norm.weight``,
    ``attn.k_norm.weight``, weight-only norms); the port's importer reads
    the state back bit-equal, JAX's importer to JAX's tensors, and the
    config back to the one written."""
    jcfg, tcfg, jp, tp = chat
    _write_dir(tmp_path, tcfg, tp)
    state = load_safetensors_dir(str(tmp_path))
    pre = "vision_model.encoder.layers.0."
    assert pre + "attn.q_norm.weight" in state
    assert pre + "attn.k_norm.weight" in state
    assert pre + "norm1.bias" not in state
    back = import_chat_params(state, tcfg, torch.float32, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tp))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(_np(a), _np(b)),
                 back, tp)
    jback = jckpt.import_chat_params(jckpt.load_safetensors_dir(
        str(tmp_path)), jcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), jback, jp)
    cfg = tconfigs.load_config(str(tmp_path / "config.json")).chat
    assert (cfg.vision, cfg.llm) == (tcfg.vision, tcfg.llm)


def test_eval_cli_internvl_chat_on_a_26b_layout_directory(
        chat, videos, tmp_path, monkeypatch):
    """``--judge internvl-chat --byte-tokenizer --device cpu`` on the
    directory: the results rows are JAX's judge's (built directly on JAX's
    state) through JAX's driver.  The CLI loads a judge in bf16, as JAX's
    does; its importer is called here at fp32."""
    import mjvideo_tpu_torch.utils.checkpoint as tckpt
    from mjvideo_tpu_torch.eval import cli

    jcfg, tcfg, jp, tp = chat
    ckpt = tmp_path / "InternVL2-26B"
    _write_dir(ckpt, tcfg, tp)
    root = tmp_path / "v"
    root.mkdir()
    for name, src in zip(("a.mp4", "b.mp4"), videos):
        shutil.copy(src, root / name)
    records = [{"caption": "a fox", "video_0_path": "a.mp4",
                "video_1_path": "b.mp4",
                "overall_preference": "Video 1 better"}]
    data = tmp_path / "pairs.json"
    data.write_text(json.dumps(records))
    load = tckpt.import_chat_params
    monkeypatch.setattr(tckpt, "import_chat_params",
                        lambda state, cfg, dtype, **kw: load(
                            state, cfg, torch.float32, **kw))
    cli.main(["--benchmark", "overall", "--judge", "internvl-chat",
              "--judge-model", str(ckpt), "--byte-tokenizer", "--device",
              "cpu", "--data-json", str(data), "--video-root", str(root),
              "--num-segments", str(SEGMENTS),
              "--results", str(tmp_path / "p.jsonl")])
    judge = jj.InternVLJudge(jcfg, jp, JByteTokenizer(),
                             num_segments=SEGMENTS, attn_impl="xla")
    jj.run_overall_benchmark(judge, records, root=str(root),
                             results_path=str(tmp_path / "j.jsonl"))
    lines = [(tmp_path / f).read_text().splitlines()
             for f in ("p.jsonl", "j.jsonl")]
    assert len(lines[0]) == 1
    assert [json.loads(x) for x in lines[0]] == [json.loads(x)
                                                 for x in lines[1]]
