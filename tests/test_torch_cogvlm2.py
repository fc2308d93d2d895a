"""The port's CogVLM2-Video (``mjvideo_tpu_torch/models/cogvlm2.py``,
``CogVLM2Judge`` and the CLI's ``--judge cogvlm2``) against the JAX
package, in fp32 on the CPU.

A tiny CogVLM2: the EVA2-CLIP tower at 2 layers x 224 wide with 2 heads of
112 (the real head dim: K3's non-causal twin at D = 112), patch 7 at 28 px
(17 tokens a frame, 6 after the adapter), a 2-layer dual-expert Llama-3 at
64 wide with 4/2 heads, whose 320-row vocabulary holds bos, eos and pad
(300-302).  JAX's weights (``init_cogvlm2_params``) cross by
``utils.bridge.cogvlm2_from_jax``; JAX runs ``attn_impl="xla"``.
Tolerances: the tower and the adapter atol 1e-5, logits atol 1e-4 (cached
teacher-forced logits against JAX's uncached forward, or its cached int8
path under ``kv_quant``); greedy tokens equal where every step's top-2
margin exceeds 1e-3 (checked); position ids, prompt ids, preprocessing
and importer leaves exact.  No ``transformers`` import.
"""

import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mjvideo_tpu.configs import LLMConfig as JLLMConfig
from mjvideo_tpu.data.prompts import ByteTokenizer as JByteTokenizer
from mjvideo_tpu.eval import judges as jj
from mjvideo_tpu.models import cogvlm2 as jm
from mjvideo_tpu.models import generate as jgen
from mjvideo_tpu_torch.configs import LLMConfig
from mjvideo_tpu_torch.data.prompts import ByteTokenizer
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.models import cogvlm2 as tm
from mjvideo_tpu_torch.models.generate import (
    init_kv_cache,
    prefill_slot_mask,
    stack_prefix_states,
)
from mjvideo_tpu_torch.utils.bridge import cogvlm2_from_jax, to_numpy
from mjvideo_tpu_torch.utils.export import export_cogvlm2

torch.set_num_threads(1)

ATOL_VISION = 1e-5
ATOL = 1e-4
MARGIN = 1e-3
NEW = 6
VISION = dict(hidden_size=224, intermediate_size=448, num_hidden_layers=2,
              num_heads=2, patch_size=7, image_size=28, scaling_factor=8.0)
TEXT = dict(architecture="llama", vocab_size=320, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=5e5,
            rms_norm_eps=1e-5, pad_token_id=302,
            max_position_embeddings=8192)
IDS = dict(bos_token_id=300, eos_token_id=301, pad_token_id=302)


def _configs():
    jcfg = jm.CogVLM2Config(vision=jm.CogVLM2VisionConfig(**VISION),
                            text=JLLMConfig(**TEXT), **IDS)
    tcfg = tm.CogVLM2Config(vision=tm.CogVLM2VisionConfig(**VISION),
                            text=LLMConfig(**TEXT), **IDS)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    init = jax.jit(functools.partial(jm.init_cogvlm2_params, cfg=jcfg))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp, cogvlm2_from_jax(jp, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _pixels(seed, n):
    return np.random.default_rng(seed).normal(
        size=(n, 28, 28, 3)).astype(np.float32)


def _hf_state(tp, tcfg):
    return {k: v.contiguous() for k, v in export_cogvlm2(tp, tcfg).items()}


# --- configs, importer, exporter ----------------------------------------------

def test_configs_equal_jax_and_round_trip_through_hf():
    """The published config and the tiny one, written by
    ``cogvlm2_config_to_hf`` and read back by both packages; the tower's
    head dim is 112 and a 224 px frame gives 66 tokens (the JAX judge's
    comment of 198 is stale)."""
    _, tcfg = _configs()
    for cfg in (tm.CogVLM2Config(), tcfg):
        hf = tm.cogvlm2_config_to_hf(cfg)
        assert tm.cogvlm2_config_from_hf(hf) == cfg
        assert dataclasses.asdict(jm.cogvlm2_config_from_hf(hf)) == \
            dataclasses.asdict(cfg)
    assert dataclasses.asdict(jm.CogVLM2Config()) == \
        dataclasses.asdict(tm.CogVLM2Config())
    vc = tm.CogVLM2Config().vision
    assert (vc.head_dim, vc.grid, vc.tokens_per_frame) == (112, 16, 66)
    assert tcfg.vision.head_dim == 112 and tcfg.vision.tokens_per_frame == 6


def test_importer_leaves_equal_jax_and_the_exporter_round_trips(model):
    """One THUDM-named state (the port's exporter) through both importers:
    every leaf bit-equal to JAX's and to the state it was written from;
    under ``model.``-less names too (the importers look both up); the
    random tree's shapes are the importer's."""
    jcfg, tcfg, jp, tp = model
    state = _hf_state(tp, tcfg)
    assert "model.vision.patch_embedding.proj.weight" in state
    assert state["model.vision.conv.weight"].shape == (224, 224, 2, 2)
    assert not any("language_expert_query_key_value.bias" in k
                   for k in state)
    got = tm.import_cogvlm2_params(state, tcfg, device="cpu")
    want = jm.import_cogvlm2_params({k: v.numpy() for k, v in
                                     state.items()}, jcfg)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want)))
    flat_src = dict(jax.tree_util.tree_leaves_with_path(to_numpy(tp)))
    flat_got = jax.tree_util.tree_leaves_with_path(to_numpy(got))
    assert len(flat_got) == len(flat_want) == len(flat_src)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[path], str(path))
        np.testing.assert_array_equal(leaf, flat_src[path], str(path))
    bare = {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in state.items()}
    again = tm.import_cogvlm2_params(bare, tcfg, device="cpu")
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(
            to_numpy(again)), flat_got):
        np.testing.assert_array_equal(a, b, str(path))
    init = tm.init_cogvlm2_params(tcfg, generator=torch.Generator()
                                  .manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: a.shape, to_numpy(init)) == \
        jax.tree.map(lambda a: a.shape, jp)


@pytest.mark.parametrize("case", ["one_run", "ragged_runs", "edges"])
def test_position_ids_equal_jax(case):
    """``build_position_ids`` on ragged vision runs: one block, several
    runs of different lengths (length 1 and 2 among them) and runs at the
    row's first and last token, element for element JAX's, each interior
    vision token at its run's shared position."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "one_run":
        tt = np.zeros((2, 40), np.int32)
        tt[0, 1:25] = 1
        tt[1, 1:13] = 1
    elif case == "ragged_runs":
        tt = (rng.random((3, 57)) < 0.55).astype(np.int32)
        tt[0, 5:6] = 1
        tt[1, 9:11] = 1
    else:
        tt = np.ones((2, 19), np.int32)
        tt[0, 7:9] = 0
        tt[1, 0] = 0
    got = tm.build_position_ids(tt)
    np.testing.assert_array_equal(got, jm.build_position_ids(tt))
    if case == "one_run":
        assert len(set(got[0, 2:24])) == 1 and got[0, 25] == got[0, 24] + 1


def test_preprocess_and_prompt_builders_equal_jax():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
              for _ in range(3)]
    np.testing.assert_array_equal(
        tm.preprocess_video_frames(frames, tcfg.vision),
        jm.preprocess_video_frames(frames, jcfg.vision))
    for n, q in ((1, "Rate it."), (3, "Which video is better?")):
        ids, tt = tm.build_video_prompt_ids(ByteTokenizer(), tcfg, n, q)
        jids, jtt = jm.build_video_prompt_ids(JByteTokenizer(), jcfg, n, q)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(tt, jtt)
        p, s = tm.build_video_prompt_prefix_suffix(ByteTokenizer(), tcfg, n,
                                                   q)
        assert (p, s) == jm.build_video_prompt_prefix_suffix(
            JByteTokenizer(), jcfg, n, q)
        assert p + s == ids[0].tolist()
        assert tt.sum() == n * 6 and tt[0, 0] == 0


# --- the forward ---------------------------------------------------------------

def test_tower_and_adapter_match_jax(model):
    """The EVA2-CLIP tower (post-norm blocks, K3's non-causal twin at
    D = 112 on qkv views) and the adapter against ``vision_forward(
    attn_impl="xla")`` and ``adapter_forward``, atol 1e-5; the kernel's
    route and the plain oracle agree."""
    jcfg, tcfg, jp, tp = model
    pix = _pixels(1, 3)
    jvis = jm.vision_forward(jp["vision"], jcfg.vision, jnp.asarray(pix),
                             attn_impl="xla")
    want = np.asarray(jm.adapter_forward(jp["adapter"], jcfg, jvis))
    vis = tm.vision_forward(tp["vision"], tcfg.vision, torch.from_numpy(pix))
    assert vis.shape == (3, 17, 224)
    np.testing.assert_allclose(_np(vis), np.asarray(jvis), atol=ATOL_VISION)
    got = tm.get_vision_embedding(tp, tcfg, torch.from_numpy(pix))
    assert got.shape == (3, 6, 64)
    np.testing.assert_allclose(_np(got), want, atol=ATOL_VISION)
    plain = tm.get_vision_embedding(tp, tcfg, torch.from_numpy(pix),
                                    impl="plain")
    np.testing.assert_allclose(_np(plain), _np(got), atol=1e-6)


def test_tower_keeps_fp32_activations_on_bf16_weights(model):
    """On a bf16 state the tower and the adapter run fp32 activations, as
    the JAX judge's fp32 pixels make them (``_jit_vision``): with fp32
    product inputs they equal JAX's on the same bf16 state within 1e-5 (a
    bf16 residual stream would read about 1e-3), and with the default
    bf16 product inputs within 2e-3 of max|JAX|; the output is fp32."""
    jcfg, tcfg, jp, _ = model
    jp16 = jax.tree.map(lambda a: np.asarray(a).astype(jnp.bfloat16), jp)
    tp16 = cogvlm2_from_jax(jp16, device="cpu")
    assert tm.compute_dtype(tp16) == torch.bfloat16
    pix = _pixels(1, 3)
    want = np.asarray(jm._jit_vision(jp16, jcfg, jnp.asarray(pix),
                                     attn_impl="xla"), np.float32)
    top = np.abs(want).max()
    fp32_in = tm.get_vision_embedding(tp16, tcfg, torch.from_numpy(pix),
                                      dtype=torch.float32)
    assert fp32_in.dtype == torch.float32
    np.testing.assert_allclose(_np(fp32_in), want, atol=ATOL_VISION)
    got = tm.get_vision_embedding(tp16, tcfg, torch.from_numpy(pix))
    assert got.dtype == torch.float32
    assert np.abs(_np(got) - want).max() <= 2e-3 * top


def _items(cfg, seed, frames=(1, 2)):
    rng = np.random.default_rng(seed)
    items = []
    for b, n in enumerate(frames):
        ids, tt = tm.build_video_prompt_ids(ByteTokenizer(), cfg, n,
                                            "Rate it" + "!" * b)
        items.append((ids, tt, _pixels(int(rng.integers(1 << 30)), n)))
    return items


def _jax_logits(jcfg, jp, item, toks=()):
    """JAX's uncached forward over the prompt and ``toks[:-1]``: the logits
    after each of the first len(toks) positions from the prompt's last
    token on (the prompt's last logits alone without ``toks``)."""
    ids, tt, pix = item
    extra = list(toks[:-1])
    full = np.concatenate([ids, np.asarray([extra], ids.dtype)], 1)
    ftt = np.concatenate([tt, np.zeros((1, len(extra)), tt.dtype)], 1)
    pos = jm.build_position_ids(ftt)
    h = jm.cogvlm2_forward(jp, jcfg, jnp.asarray(full), jnp.asarray(ftt),
                           None, jnp.asarray(pos), jnp.asarray(pix),
                           attn_impl="xla")
    T = ids.shape[1]
    return np.asarray(jm.lm_logits(jp, h))[0, T - 1:T - 1 + max(len(toks),
                                                                1)]


def test_cogvlm2_forward_logits_match_jax(model):
    jcfg, tcfg, jp, tp = model
    item = _items(tcfg, 7, frames=(2,))[0]
    ids, tt, pix = item
    pos = tm.build_position_ids(tt)
    h = jm.cogvlm2_forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(tt), None,
                           jnp.asarray(pos), jnp.asarray(pix),
                           attn_impl="xla")
    want = np.asarray(jm.lm_logits(jp, h))
    got = tm.lm_logits(tp, tm.cogvlm2_forward(
        tp, tcfg, torch.from_numpy(ids), torch.from_numpy(tt), None, pos,
        torch.from_numpy(pix)))
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


def _margins_ok(logits):
    top2 = torch.topk(torch.as_tensor(logits), 2, dim=-1).values
    return bool(((top2[..., 0] - top2[..., 1]) > MARGIN).all())


@pytest.mark.parametrize("frames", [(2,), (1, 2)], ids=["b1", "ragged_b2"])
def test_cached_generation_matches_jax(model, frames):
    """One prompt, and two of 1 and 2 frames batched (ragged: pads of
    language type, each row's position table its own): the port's
    teacher-forced cached logits on JAX's greedy tokens against JAX's
    uncached forward (atol 1e-4), and the port's greedy tokens equal to
    JAX's ``greedy_generate_batch``'s (every step's top-2 margin above
    1e-3)."""
    jcfg, tcfg, jp, tp = model
    items = _items(tcfg, len(frames), frames)
    want = jm.greedy_generate_batch(jp, jcfg, items, max_new_tokens=NEW,
                                    eos_token_id=-1, attn_impl="xla")
    teacher = torch.tensor(want)
    logits = tm.greedy_generate_batch(tp, tcfg, items, max_new_tokens=NEW,
                                      eos_token_id=-1, teacher_tokens=teacher)
    for b, item in enumerate(items):
        np.testing.assert_allclose(_np(logits[b]),
                                   _jax_logits(jcfg, jp, item, want[b]),
                                   atol=ATOL)
    assert _margins_ok(logits)
    assert tm.greedy_generate_batch(tp, tcfg, items, max_new_tokens=NEW,
                                    eos_token_id=-1) == want
    if len(items) == 1:
        assert tm.greedy_generate(tp, tcfg, *items[0], max_new_tokens=NEW,
                                  eos_token_id=-1) == want[0]


def test_prefix_path_equals_the_full_prompt(model):
    """``prefill_prefix`` of [bos] and the vision block and
    ``continue_prefix`` of a question: the full prompt's tokens and,
    teacher-forced, its logits (the suffix rotates by the prefix's table
    and runs over the whole cache at ``q_offset`` = P); the state is
    unchanged by use and stacks."""
    _, tcfg, _, tp = model
    tok = ByteTokenizer()
    vis = tm.get_vision_embedding(tp, tcfg, torch.from_numpy(_pixels(8, 2)))
    prefix, suffix = tm.build_video_prompt_prefix_suffix(tok, tcfg, 2,
                                                         "Rate it.")
    ids, tt = tm.build_video_prompt_ids(tok, tcfg, 2, "Rate it.")
    full = tm.greedy_generate_batch(tp, tcfg, [(ids, tt, None)],
                                    max_new_tokens=NEW, eos_token_id=-1,
                                    vision_embeds=[vis])
    Pb = 64
    state = tm.prefill_prefix(tp, tcfg, prefix, vis, max_len=Pb + 32 + NEW,
                              bucket=Pb)
    assert state.P == 13 and state.pos_all.shape == (1, Pb + 32 + NEW)
    np.testing.assert_array_equal(
        _np(state.pos_all[0, :len(prefix + suffix)]),
        tm.build_position_ids(tt)[0])
    before = [t.clone() for t in state.cache if t is not None]
    toks, n = tm.continue_prefix(tp, tcfg, state, suffix, 32, NEW, -1)
    assert [toks[0, : n[0]].tolist()] == full
    teacher = torch.tensor(full)
    a = tm.continue_prefix(tp, tcfg, state, suffix, 32, NEW, -1,
                           teacher_tokens=teacher)
    b = tm.greedy_generate_batch(tp, tcfg, [(ids, tt, None)],
                                 max_new_tokens=NEW, eos_token_id=-1,
                                 vision_embeds=[vis], teacher_tokens=teacher)
    np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)
    assert all(torch.equal(x, y) for x, y in
               zip(before, [t for t in state.cache if t is not None]))
    stacked = stack_prefix_states([state, state])
    assert stacked.mask.shape[0] == 2 and stacked.P == state.P
    assert stacked.cache.k.shape[1] == 2 and stacked.pos_all.shape[0] == 2


def test_language_expert_alone_is_bit_equal_to_the_select(model):
    """Where every token of a call is language, the language expert alone
    (``vis_mask=None``: every decode step and suffix) gives the select's
    values bit for bit, through the layers and the cache writes."""
    _, tcfg, _, tp = model
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    results = []
    for vis_mask in (None, torch.zeros((2, 5, 1), dtype=torch.bool)):
        cache = init_kv_cache(tcfg.text, 2, 16, device="cpu",
                              dtype=torch.float32)
        slots, mask = prefill_slot_mask(5, 16, torch.tensor([5, 3]))
        pos = torch.tensor([[0, 1, 1, 1, 2], [0, 1, 2, 3, 4]])
        h, cache = tm.forward_cached(tp, tcfg, x, cache, slots, pos, mask,
                                     vis_mask)
        results.append((h, cache.k, cache.v))
    for a, b in zip(*results):
        assert torch.equal(a, b)


def _jax_cached_logits(jcfg, jp, item, toks, kv_quant):
    """JAX's cached path (``_generate_fn``'s prefill and steps) fed
    ``toks``: the (n, V) logits of the prompt's last token and each step,
    its KV cache int8 under ``kv_quant``.  The prefill takes the kernel
    route (``attn_impl="flash"``, the TPU's, interpreted here), which
    attends over the fresh tokens as the port's does, where JAX's off-TPU
    XLA route reads the dequantized cache."""
    ids, tt, pix = item
    Tb = jgen.round_up_bucket(ids.shape[1])
    max_len = Tb + len(toks)
    nr = ids.shape[1]
    pad_ids = np.full((1, Tb), jcfg.pad_token_id, np.int32)
    pad_ids[0, :nr] = ids[0]
    ptt = np.zeros((1, Tb), np.int32)
    ptt[0, :nr] = tt[0]
    pos = jm.build_position_ids(tt)[0]
    pos_all = np.concatenate([pos, pos.max() + 1 + np.arange(max_len - nr)])
    pos_all = jnp.asarray(pos_all[None], jnp.int32)
    n_real = jnp.asarray([nr], jnp.int32)

    @jax.jit
    def prefill(jp):
        vis = jm._jit_vision(jp, jcfg, jnp.asarray(pix))
        embeds = jm.dec.embed_tokens(jp["language_model"],
                                     jnp.asarray(pad_ids))
        embeds = jm.scatter_image_embeds(
            embeds, jnp.asarray(ptt), vis.reshape(-1, vis.shape[-1]), 1)
        cache = tuple(jgen.init_kv_cache(jcfg.text, 1, max_len,
                                         dtype=embeds.dtype, quant=kv_quant))
        slots, mask = jgen.prefill_slot_mask(Tb, max_len, n_real)
        vm = jnp.asarray(ptt, embeds.dtype)[..., None]
        hidden, cache = jm._cogvlm2_forward_cached(
            jp, jcfg, embeds, cache, slots, pos_all[:, :Tb], mask, vm,
            attn_impl="flash")
        return (jm.lm_logits(jp, jgen.last_real_token(hidden, n_real))[:, 0],
                cache)

    logits, cache = prefill(jp)
    out = [logits]

    @jax.jit
    def step(jp, tok, i, cache):
        e = jm.dec.embed_tokens(jp["language_model"], tok)
        s, m = jgen.step_slot_mask(max_len, n_real, i)
        h, cache = jm._cogvlm2_forward_cached(
            jp, jcfg, e, cache, s, pos_all[:, nr + i][:, None], m,
            jnp.zeros((1, 1, 1), e.dtype))
        return jm.lm_logits(jp, h)[:, 0], cache

    for i in range(len(toks) - 1):
        logits, cache = step(jp, jnp.asarray([[toks[i]]], jnp.int32), i,
                             cache)
        out.append(logits)
    return np.concatenate([np.asarray(o) for o in out])


@pytest.mark.parametrize("mode", ["kv_quant", "int8-wo"])
def test_quantized_modes_match_the_jax_judge(model, mode):
    """The judges' serving modes: ``kv_quant=True`` (the int8 KV cache)
    against JAX's cached kernel-route path with its int8 cache, and ``quant="int8-wo"``
    (the state quantized by each judge: the tower's kernels reach the
    default size) against JAX's forward on the JAX judge's state;
    teacher-forced logits atol 1e-4."""
    jcfg, tcfg, jp, tp = model
    item = _items(tcfg, 11, frames=(2,))[0]
    toks = list(np.random.default_rng(12).integers(1, 250, NEW))
    teacher = torch.tensor([toks])
    if mode == "kv_quant":
        want = _jax_cached_logits(jcfg, jp, item, toks, kv_quant=True)
        got = tm.greedy_generate_batch(tp, tcfg, [item], max_new_tokens=NEW,
                                       kv_quant=True, teacher_tokens=teacher)
    else:
        jjudge = jj.CogVLM2Judge(jcfg, jp, JByteTokenizer(), quant=mode,
                                 attn_impl="xla")
        tjudge = tj.CogVLM2Judge(tcfg, tp, ByteTokenizer(), quant=mode)
        qkv = tjudge.params["vision"]["layers"]["qkv"]["kernel"]
        assert type(qkv).__name__ == "WOQuantKernel"
        want = _jax_logits(jcfg, jjudge.params, item, toks)
        got = tm.greedy_generate_batch(tjudge.params, tcfg, [item],
                                       max_new_tokens=NEW,
                                       teacher_tokens=teacher)
    np.testing.assert_allclose(_np(got[0]), want, atol=ATOL)


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
    root = tmp_path_factory.mktemp("cvids")
    paths = [str(root / "a.mp4"), str(root / "b.mp4")]
    for seed, path in enumerate(paths):
        _write_video(path, seed)
    return paths


JUDGE = dict(num_segments=3, max_new_tokens=NEW, suffix_bucket=32)


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix", "full"])
def test_judge_answers_equal_jax(model, videos, prefix_cache):
    """``CogVLM2Judge`` on two cv2-written videos by the prefix path and the
    full prompt (the overall prompt, past the suffix bucket, always takes
    it): ``ask``, ``ask_batch`` and ``judge_pair`` give JAX's answers, and
    the prefix path's answers are the full prompt's."""
    jcfg, tcfg, jp, tp = model
    jjudge = jj.CogVLM2Judge(jcfg, jp, JByteTokenizer(), attn_impl="xla",
                             prefix_cache=prefix_cache, **JUDGE)
    tjudge = tj.CogVLM2Judge(tcfg, tp, ByteTokenizer(),
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
        full = tj.CogVLM2Judge(tcfg, tp, ByteTokenizer(), prefix_cache=False,
                               **JUDGE)
        assert full.ask_batch(q, videos) == answers


def test_eval_cli_cogvlm2_branch(model, videos, tmp_path, monkeypatch):
    """``--judge cogvlm2 --byte-tokenizer --device cpu`` on a THUDM-named
    directory written by the port's exporter: the config read back is the
    one written, and every results row equals the port's judge on the
    state read back as the CLI reads it, ratings and answers.  The CLI
    loads a judge in bf16, as JAX's does; its importer is called here at
    fp32, which decodes faster on the CPU."""
    from mjvideo_tpu_torch.eval import cli
    from mjvideo_tpu_torch.utils.checkpoint import load_safetensors_dir

    _, tcfg, _, tp = model
    d = str(tmp_path / "ckpt")
    chip_smoke.write_hf_dir(d, tm.cogvlm2_config_to_hf(tcfg),
                            export_cogvlm2(tp, tcfg))
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
    real = tm.import_cogvlm2_params
    monkeypatch.setattr(tm, "import_cogvlm2_params",
                        lambda state, cfg, dtype, device: real(
                            state, cfg, torch.float32, device))
    cli.main(["--benchmark", "overall", "--judge", "cogvlm2",
              "--judge-model", d, "--byte-tokenizer", "--device", "cpu",
              "--data-json", str(data), "--video-root", root,
              "--num-segments", "3", "--results", str(results)])
    row = json.loads(results.read_text().splitlines()[0])
    cfg = tm.cogvlm2_config_from_hf(json.loads(
        open(f"{d}/config.json").read()))
    assert cfg == tcfg
    params = real(load_safetensors_dir(d), cfg, dtype=torch.float32,
                  device="cpu")
    judge = tj.CogVLM2Judge(cfg, params, ByteTokenizer(), num_segments=3)
    want = tj.judge_pair(judge, f"{root}/a.mp4", f"{root}/b.mp4", "a fox")
    assert (row["score_0"], row["score_1"], row["response_0"],
            row["response_1"]) == want
