"""The judges on a (data, model) mesh (``parallel/mesh.py``, the judge
families' ``mesh=`` and ``models/generate.py``'s caches per model rank)
against the JAX package's unsharded runs.

JAX's own tests hold its meshed judge backbones to its unsharded ones
(``tests/test_parallel.py:264-494``), so the oracle of a meshed port run is
JAX's unsharded run (``attn_impl="xla"``, jitted), at the configs and seeds
of those tests where they have one and at the port's tiny configs of
``tests/test_torch_qwen2vl.py`` and ``tests/test_torch_videoscore.py``
otherwise.  Meshes: ``Mesh.local(2, 2)`` and ``(1, 2)``.  Tolerances, each
with its reason:

* forwards and logits: atol 2e-4 (JAX's bar between its meshed and its
  unsharded forward): a row-parallel product sums its ranks' fp32
  partials, and the port's attention twins take the bound softmax where
  JAX's XLA path takes the exact one;
* greedy tokens: equal (the dense and the int8 cache, the left-padded row,
  the prefix path);
* two gloo processes against ``Mesh.local``: ``torch.equal`` (a sum of two
  partials is the same in either order).
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu import configs as jconfigs
from mjvideo_tpu.configs import LLMConfig as JLLMConfig
from mjvideo_tpu.models import cogvlm2 as jcog
from mjvideo_tpu.models import generate as jgen
from mjvideo_tpu.models import internvl as jivl
from mjvideo_tpu.models import minicpmv as jmcpm
from mjvideo_tpu.models import qwen2vl as jqwen
from mjvideo_tpu.models import videoscore as jvs
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch.configs import LLMConfig
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.models import cogvlm2 as tcog
from mjvideo_tpu_torch.models import decoder as tdec
from mjvideo_tpu_torch.models import generate as tgen
from mjvideo_tpu_torch.models import internvl as tivl
from mjvideo_tpu_torch.models import minicpmv as tmcpm
from mjvideo_tpu_torch.models import qwen2vl as tqwen
from mjvideo_tpu_torch.models import videoscore as tvs
from mjvideo_tpu_torch.ops.quant import quantize_params_mode
from mjvideo_tpu_torch.parallel import mesh as tmesh
from mjvideo_tpu_torch.parallel.mesh import Mesh, shard_params
from mjvideo_tpu_torch.utils.bridge import (
    cogvlm2_from_jax,
    from_jax_params,
    minicpmv_from_jax,
    videoscore_from_jax,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-4
MESHES = [(2, 2), (1, 2)]
MIN_ELEMENTS = 1024  # tiny kernels are below the serving modes' 1 << 16


def _np(t):
    return t.detach().float().numpy()


def _split_paths(state, cfg, model=2):
    return set(tmesh.split_plan(state, model, cfg))


def _meta(shapes):
    """A nested state of meta tensors from {path: shape}: ``split_plan``
    reads shapes only."""
    out = {}
    for path, shape in shapes.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.empty(shape, device="meta")
    return out


# ------------------------------------------------------------- the guard

@pytest.mark.parametrize("model,split", [(2, False), (4, False), (5, True)])
def test_guard_keeps_the_6b_towers_25_heads_whole_unless_they_divide(
        model, split):
    """The 26B judge's InternViT-6B: its 25 heads stay whole at model 2
    and 4 and split at 5, the QK-norm with them; its MLP (12,800 columns)
    splits at each."""
    cfg = tconfigs.internvl2_26b_chat_config()
    v = cfg.vision
    C, I = v.hidden_size, v.intermediate_size
    state = _meta({
        "vision_model/layers/attn/qkv/kernel": (2, C, 3 * C),
        "vision_model/layers/attn/qkv/bias": (2, 3 * C),
        "vision_model/layers/attn/proj/kernel": (2, C, C),
        "vision_model/layers/attn/q_norm/weight": (2, C),
        "vision_model/layers/mlp/fc1/kernel": (2, C, I),
        "vision_model/layers/mlp/fc2/kernel": (2, I, C),
    })
    plan = tmesh.split_plan(state, model, cfg)
    assert ("vision_model/layers/attn/qkv/kernel" in plan) == split
    assert ("vision_model/layers/attn/proj/kernel" in plan) == split
    assert "vision_model/layers/mlp/fc2/kernel" in plan
    assert not any("q_norm" in p for p in plan)  # sliced at run time


@pytest.mark.parametrize("vocab,splits", [
    (92553, ()), (32003, ()), (128256, (2, 4)), (151936, (2, 4)),
    (151666, (2,))], ids=["internlm2", "mistral", "llama3", "qwen2vl",
                          "minicpm"])
def test_guard_splits_an_lm_head_only_where_its_vocabulary_divides(
        vocab, splits):
    cfg = tconfigs.internvl2_2b_chat_config()
    state = _meta({"language_model/output/kernel": (64, vocab)})
    for model in (2, 4):
        plan = tmesh.split_plan(state, model, cfg)
        assert bool(plan) == (model in splits), model
        if plan:
            assert plan["language_model/output/kernel"].kind == "logits"


def test_lifted_qknorm_and_kept_refusals():
    """The QK-norm ViT splits; LoRA and the w8a8 modes still raise, naming
    ROADMAP Queue 1 item 12."""
    base = tconfigs.tiny_test_config().chat
    cfg = dataclasses.replace(base, vision=dataclasses.replace(
        base.vision, qk_normalization=True, norm_type="rms_norm"))
    state = tivl.init_chat_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32, with_lm_head=True)
    assert "vision_model/layers/attn/qkv/kernel" in _split_paths(state, cfg)
    w8a8 = quantize_params_mode(state, "int8", min_elements=MIN_ELEMENTS)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        shard_params(w8a8, Mesh.local(1, 2), cfg=cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        tj.InternVLJudge(cfg, w8a8, None, mesh=Mesh.local(1, 2))
    tj.InternVLJudge(cfg, w8a8, None, mesh=Mesh.local(2, 1))  # no model axis


def test_vocabulary_split_tie_takes_the_first_index():
    """A tie between a column of rank 0 and one of rank 1: the gathered
    row's argmax is the first, as ``torch.argmax`` of the whole row."""
    g = torch.Generator().manual_seed(0)
    C, V = 8, 16
    kernel = torch.randn(C, V, generator=g) * 0.1
    hidden = torch.randn(3, C, generator=g)
    kernel[:, 3] = kernel[:, 3 + V // 2] = hidden[0] * 5  # a tie, row 0
    state = {"output": {"kernel": kernel}}
    split = tmesh.Split("logits", 1)
    ps = [{"output": {"kernel": tmesh.cut(kernel, split, j, 2)}}
          for j in (0, 1)]
    whole = tdec.lm_logits(state, hidden, impl="plain")
    got = tdec.lm_logits(ps, hidden, impl="plain", mesh=Mesh.local(1, 2),
                         vocab_size=V)
    assert got.shape == (3, V)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6)
    assert got[0, 3] == got[0, 3 + V // 2]
    assert int(got[0].argmax()) == 3 == int(whole[0].argmax())


# ---------------------------------------------------------- the forwards

def _minicpmv_cfgs():
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, patch_size=14, image_size=56)
    text = dict(architecture="llama", vocab_size=128, hidden_size=32,
                intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4,
                rms_norm_eps=1e-6, pad_token_id=0,
                max_position_embeddings=256, bias=True)
    res = dict(num_queries=6, embed_dim=32, num_heads=4, kv_dim=32)
    jcfg = jmcpm.MiniCPMVConfig(vision=jvs.SigLIPVisionConfig(**vision),
                                resampler=jmcpm.ResamplerConfig(**res),
                                text=JLLMConfig(**text), unk_token_id=120)
    tcfg = tmcpm.MiniCPMVConfig(vision=tvs.SigLIPVisionConfig(**vision),
                                resampler=tmcpm.ResamplerConfig(**res),
                                text=LLMConfig(**text), unk_token_id=120)
    return jcfg, tcfg


@functools.lru_cache(None)
def _minicpmv_ref():
    """(port config, port state, inputs, JAX's unsharded logits), once a
    worker: the cases of a test share JAX's compile."""
    jcfg, tcfg = _minicpmv_cfgs()
    jp = jax.tree.map(np.asarray, jmcpm.init_minicpmv_params(
        jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    pix = rng.normal(size=(2, 28, 42, 3)).astype(np.float32)
    ids = np.full((1, 40), 7, np.int64)
    ids[0, 2:14] = 120  # two 6-query image slots
    mask = np.ones_like(ids)
    want = np.asarray(jax.jit(lambda p: jmcpm.lm_logits(
        p, jmcpm.minicpmv_forward(
            p, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
            pixel_values=jnp.asarray(pix), attn_impl="xla")))(jp))
    return tcfg, minicpmv_from_jax(jp, device="cpu"), (pix, ids, mask), want


@pytest.mark.parametrize("data,model", MESHES)
def test_minicpmv_logits_match_jax(data, model):
    """``test_parallel.py:264``: the SigLIP tower and the Qwen2 text model
    (with its LM head) split."""
    tcfg, state, (pix, ids, mask), want = _minicpmv_ref()
    split = _split_paths(state, tcfg)
    assert {"vpm/layers/q/kernel", "vpm/layers/o/kernel",
            "llm/layers/attention/wq/kernel", "llm/output/kernel",
            "llm/tok_embeddings"} <= split
    assert not any(p.startswith("resampler") for p in split)
    mesh = Mesh.local(data, model)
    ps = shard_params(state, mesh, cfg=tcfg)
    got = tmcpm.lm_logits(ps, tmcpm.minicpmv_forward(
        ps, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(pix), mesh=mesh), mesh=mesh,
        vocab_size=tcfg.text.vocab_size)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


def _cogvlm2_cfgs():
    vision = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                  num_heads=2, patch_size=7, image_size=28,
                  scaling_factor=8.0)
    text = dict(architecture="llama", vocab_size=128, hidden_size=32,
                intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4,
                rms_norm_eps=1e-5, pad_token_id=0,
                max_position_embeddings=256)
    ids = dict(bos_token_id=1, eos_token_id=2, pad_token_id=0)
    return (jcog.CogVLM2Config(vision=jcog.CogVLM2VisionConfig(**vision),
                               text=JLLMConfig(**text), **ids),
            tcog.CogVLM2Config(vision=tcog.CogVLM2VisionConfig(**vision),
                               text=LLMConfig(**text), **ids))


@functools.lru_cache(None)
def _cogvlm2_model():
    jcfg, tcfg = _cogvlm2_cfgs()
    jp = jax.tree.map(np.asarray, jcog.init_cogvlm2_params(
        jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jp, cogvlm2_from_jax(jp, device="cpu")


@pytest.fixture
def cogvlm2():
    return _cogvlm2_model()


@functools.lru_cache(None)
def _cogvlm2_ref():
    jcfg, tcfg, jp, state = _cogvlm2_model()
    rng = np.random.default_rng(1)
    pix = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    tok = lambda s: {"input_ids": [5] * len(s)}  # noqa: E731
    ids, tt = jcog.build_video_prompt_ids(tok, jcfg, 2, "ok")
    pos = jcog.build_position_ids(tt)
    mask = np.ones_like(ids)
    want = np.asarray(jax.jit(lambda p: jcog.lm_logits(
        p, jcog.cogvlm2_forward(
            p, jcfg, jnp.asarray(ids), jnp.asarray(tt), jnp.asarray(mask),
            jnp.asarray(pos), pixel_values=jnp.asarray(pix),
            attn_impl="xla")))(jp))
    return tcfg, state, (pix, ids, tt, pos, mask), want


@pytest.mark.parametrize("data,model", MESHES)
def test_cogvlm2_logits_match_jax(data, model):
    """``test_parallel.py:316``: the EVA tower and both experts' MLPs and
    ``dense`` split; the packed expert qkv stays whole, each rank slicing
    its query heads with their kv group."""
    tcfg, state, (pix, ids, tt, pos, mask), want = _cogvlm2_ref()
    split = _split_paths(state, tcfg)
    assert {"vision/layers/qkv/kernel", "vision/layers/dense/kernel",
            "language_model/layers/mlp/vision/w1/kernel",
            "language_model/layers/attention/language_dense/kernel",
            "language_model/output/kernel"} <= split
    assert not any("_qkv" in p for p in split)
    mesh = Mesh.local(data, model)
    ps = shard_params(state, mesh, cfg=tcfg)
    T = torch.from_numpy
    got = tcog.lm_logits(ps, tcog.cogvlm2_forward(
        ps, tcfg, T(ids), T(tt), T(mask), T(pos), pixel_values=T(pix),
        mesh=mesh), mesh=mesh, vocab_size=tcfg.text.vocab_size)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


def _qk_cfg(pkg):
    base = pkg.tiny_test_config().chat
    return dataclasses.replace(base, vision=dataclasses.replace(
        base.vision, qk_normalization=True, norm_type="rms_norm"))


@functools.lru_cache(None)
def _qknorm_ref():
    jcfg, tcfg = _qk_cfg(jconfigs), _qk_cfg(tconfigs)
    jp = jax.tree.map(np.asarray, jivl.init_chat_params(
        jax.random.PRNGKey(4), jcfg, with_lm_head=False))
    rng = np.random.default_rng(5)
    n_img = jcfg.num_image_token
    ids = np.full((2, n_img + 8), 5, np.int64)
    ids[:, 2:2 + n_img] = jcfg.img_context_token_id
    pix = rng.normal(size=(2, jcfg.vision.image_size, jcfg.vision.image_size,
                           3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: jivl.chat_forward(
        p, jcfg, jnp.asarray(pix), jnp.asarray(ids, jnp.int32),
        attn_impl="xla", remat=False))(jp))
    return tcfg, from_jax_params(jp, device="cpu"), (pix, ids), want


@pytest.mark.parametrize("data,model", MESHES)
def test_qknorm_chat_forward_matches_jax(data, model):
    """``test_parallel.py:365``: the 6B family's QK-RMSNorm over the whole
    width crosses the head split; its statistics are summed over the model
    axis."""
    tcfg, state, (pix, ids), want = _qknorm_ref()
    assert "vision_model/layers/attn/qkv/kernel" in _split_paths(state, tcfg)
    mesh = Mesh.local(data, model)
    ps = shard_params(state, mesh, cfg=tcfg)
    got = tivl.chat_forward(ps, tcfg, torch.from_numpy(pix),
                            torch.from_numpy(ids), remat=False, mesh=mesh)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


def _qwen_cfgs(tie):
    ids = dict(im_start_token_id=300, im_end_token_id=301,
               vision_start_token_id=302, vision_end_token_id=303,
               image_token_id=304, video_token_id=305)
    vision = dict(depth=2, embed_dim=160, num_heads=2, mlp_ratio=2,
                  patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
                  hidden_size=48)
    text = dict(architecture="llama", vocab_size=320, hidden_size=48,
                intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=3, num_key_value_heads=1,
                rope_theta=10000.0, rms_norm_eps=1e-6, pad_token_id=0,
                max_position_embeddings=512, bias=True)
    kw = dict(mrope_section=(2, 3, 3), tie_word_embeddings=tie, **ids)
    return (jqwen.Qwen2VLConfig(vision=jqwen.Qwen2VLVisionConfig(**vision),
                                text=JLLMConfig(**text), **kw),
            tqwen.Qwen2VLConfig(vision=tqwen.Qwen2VLVisionConfig(**vision),
                                text=LLMConfig(**text), **kw))


@functools.lru_cache(None)
def _qwen2vl_ref(tie):
    jcfg, tcfg = _qwen_cfgs(tie)
    jp = jax.tree.map(np.asarray, jqwen.init_qwen2vl_params(
        jax.random.PRNGKey(0), jcfg))
    grid = (2, 4, 4)
    patches = np.random.default_rng(2).normal(
        size=(32, tcfg.vision.patch_dim)).astype(np.float32)
    ids = np.asarray([[5, 6, 302] + [305] * 8 + [303, 7, 8, 9]], np.int64)
    mask = np.ones_like(ids)
    pos, _ = tqwen.get_rope_index(ids, [grid], tcfg)
    want = np.asarray(jax.jit(lambda p: jqwen.lm_logits(
        p, jcfg, jqwen.qwen2vl_forward(
            p, jcfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos),
            jnp.asarray(patches), grid, attn_impl="xla", remat=False)))(jp))
    return tcfg, from_jax_params(jp, device="cpu"), \
        (grid, patches, ids, mask, pos), want


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_qwen2vl_logits_match_jax(tie, data, model):
    """The tower on each rank's heads (M-RoPE on them, K1's twin at D =
    80), the text MLP and the vocabulary (the tied head: the embedding's
    rows) split; the text attention's one kv head keeps it whole."""
    tcfg, state, (grid, patches, ids, mask, pos), want = _qwen2vl_ref(tie)
    split = _split_paths(state, tcfg)
    assert {"visual/blocks/attn/qkv/kernel", "visual/blocks/attn/proj/kernel",
            "language_model/layers/feed_forward/w2/kernel",
            "language_model/tok_embeddings"} <= split
    assert not any("attention/" in p for p in split)
    assert ("language_model/output/kernel" in split) == (not tie)
    mesh = Mesh.local(data, model)
    ps = shard_params(state, mesh, cfg=tcfg)
    T = torch.from_numpy
    got = tqwen.lm_logits(ps, tcfg, tqwen.qwen2vl_forward(
        ps, tcfg, T(ids), T(mask), T(pos), T(patches), grid, mesh=mesh),
        mesh=mesh)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


@functools.lru_cache(None)
def _videoscore_ref():
    vision = dict(hidden_size=144, intermediate_size=288, num_hidden_layers=2,
                  num_attention_heads=2, patch_size=14, image_size=70)
    per = dict(depth=1, n_heads=4, head_dim=16, num_key_value_heads=2,
               n_latents=6)
    text = dict(architecture="llama", vocab_size=320, hidden_size=64,
                intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4,
                rms_norm_eps=1e-5, pad_token_id=0,
                max_position_embeddings=4096)
    jcfg = jvs.VideoScoreConfig(
        vision=jvs.SigLIPVisionConfig(**vision),
        perceiver=jvs.PerceiverConfig(**per), text=JLLMConfig(**text),
        image_token_id=300, num_labels=5)
    tcfg = tvs.VideoScoreConfig(
        vision=tvs.SigLIPVisionConfig(**vision),
        perceiver=tvs.PerceiverConfig(**per), text=LLMConfig(**text),
        image_token_id=300, num_labels=5)
    jp = jax.tree.map(np.asarray, jvs.init_videoscore_params(
        jax.random.PRNGKey(0), jcfg))
    pix = np.random.default_rng(2).normal(size=(2, 56, 70, 3)).astype(
        np.float32)
    ids = np.asarray([[5, 6, 7] + [300] * 12 + [8, 9, 10, 11] + [0] * 9])
    mask = (ids != 0).astype(np.int64)
    mask[0, :3] = 1
    want = np.asarray(jax.jit(lambda p: jvs.videoscore_forward(
        p, jcfg, jnp.asarray(pix), jnp.asarray(ids), jnp.asarray(mask),
        attn_impl="xla"))(jp))
    return tcfg, videoscore_from_jax(jp, device="cpu"), (pix, ids, mask), want


@pytest.mark.parametrize("data,model", MESHES)
def test_videoscore_logits_match_jax(data, model):
    """The SigLIP tower (K1's twin at D = 72), the perceiver's q/k/v/o by
    its 4/2 heads and the Mistral decoder split; the regression head
    whole."""
    tcfg, state, (pix, ids, mask), want = _videoscore_ref()
    split = _split_paths(state, tcfg)
    assert {"vision_model/layers/q/kernel", "vision_model/layers/fc2/kernel",
            "connector/layers/k/kernel", "connector/layers/o/kernel",
            "text/layers/attention/wk/kernel"} <= split
    assert not any(p.startswith("score") for p in split)
    mesh = Mesh.local(data, model)
    ps = shard_params(state, mesh, cfg=tcfg)
    T = torch.from_numpy
    got = tvs.videoscore_forward(ps, tcfg, T(pix), T(ids), T(mask),
                                 mesh=mesh)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


# ---------------------------------------------------------- generation

@pytest.fixture(scope="module")
def chat():
    """``test_parallel.py:453``'s state, prompts and left-padded row."""
    ch = jconfigs.tiny_test_config().chat
    jp = jivl.init_chat_params(jax.random.PRNGKey(1), ch, with_lm_head=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 50, size=(2, 9)).astype(np.int32)
    am = np.ones_like(ids)
    ids[1, :2], am[1, :2] = 0, 0  # left-padded row
    return ch, tconfigs.tiny_test_config().chat, jp, \
        from_jax_params(jp, device="cpu"), ids, am


def _gc(pkg, kv_quant):
    return pkg.GenerationConfig(max_new_tokens=6, eos_token_id=-1,
                                pad_token_id=0, kv_quant=kv_quant)


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "int8"])
def test_generate_tokens_equal_jax(chat, kv_quant, data, model):
    """Cached generation on the mesh: each rank's cache holds its kv heads
    (and their int8 scales), the rows split over the data axis."""
    jch, tch, jp, state, ids, am = chat
    want = np.asarray(jgen.generate(jp, jch, jnp.asarray(ids),
                                    jnp.asarray(am),
                                    generation_config=_gc(jgen, kv_quant)))
    mesh = Mesh.local(data, model)
    ps = shard_params(state, mesh, cfg=tch)
    assert "language_model/layers/attention/wq/kernel" in _split_paths(
        state, tch)
    got = tgen.generate(ps, tch, torch.from_numpy(ids), torch.from_numpy(am),
                        generation_config=_gc(tgen, kv_quant), mesh=mesh)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data,model", MESHES)
def test_prefix_path_tokens_equal_jax(chat, data, model):
    """Two B = 1 prefix states (their caches per model rank) stacked rank
    by rank, a suffix each, against JAX's prefix path."""
    jch, tch, jp, state, _, _ = chat
    rng = np.random.default_rng(2)
    pre = np.zeros((2, 10), np.int32)
    pam = np.zeros_like(pre)
    for b, n in enumerate((8, 9)):
        pre[b, :n], pam[b, :n] = rng.integers(1, 250, size=n), 1
    suf = np.zeros((2, 7), np.int32)
    sam = np.zeros_like(suf)
    suf[:, :5], sam[:, :5] = rng.integers(1, 250, size=5), 1
    max_len = 10 + 7 + 6
    jst = jgen.stack_prefix_states([
        jgen.prefill_prefix(jp, jch, jnp.asarray(pre[b:b + 1]),
                            jnp.asarray(pam[b:b + 1]), max_len=max_len)
        for b in (0, 1)])
    want = np.asarray(jgen.generate_from_prefix(
        jp, jch, jst, jnp.asarray(suf), jnp.asarray(sam),
        generation_config=_gc(jgen, False)))
    mesh = Mesh.local(data, model)
    ps = shard_params(state, mesh, cfg=tch)
    T = torch.from_numpy
    states = [tgen.prefill_prefix(ps, tch, T(pre[b:b + 1]), T(pam[b:b + 1]),
                                  max_len=max_len, mesh=mesh)
              for b in (0, 1)]
    assert isinstance(states[0].cache, tgen.RankCaches)
    assert states[0].cache[0].k.shape[3] == tch.llm.num_key_value_heads // 2
    st = tgen.stack_prefix_states(states)
    got = tgen.generate_from_prefix(ps, tch, st, T(suf), T(sam),
                                    generation_config=_gc(tgen, False),
                                    mesh=mesh)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["int8-wo", "int4-wo"])
def test_weight_only_modes_on_the_mesh_equal_the_unsharded_port(chat, mode):
    """``int8-wo`` and ``int4-wo`` under TP (at width 128 an int4 row
    member holds whole groups on each rank, repacked per rank): the meshed
    tokens equal the unsharded port's on the same quantized tree, and its
    teacher-forced logits are within 2e-4."""
    _, _, _, _, ids, am = chat
    ch = tconfigs.tiny_test_config(hidden_size=128).chat
    state = tivl.init_chat_params(
        ch, generator=torch.Generator().manual_seed(3), device="cpu",
        dtype=torch.float32, with_lm_head=True)
    tree = quantize_params_mode(state, mode, min_elements=MIN_ELEMENTS)
    plan = tmesh.split_plan(tree, 2, ch)
    assert any(p.endswith("fc2/kernel/.packed" if mode == "int4-wo"
                          else "feed_forward/w2/kernel/.qw") for p in plan)
    T = torch.from_numpy
    gc = _gc(tgen, False)
    want = tgen.generate(tree, ch, T(ids), T(am), generation_config=gc)
    mesh = Mesh.local(1, 2)
    ps = shard_params(tree, mesh, cfg=ch)
    got = tgen.generate(ps, ch, T(ids), T(am), generation_config=gc,
                        mesh=mesh)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    logits = tgen.generate(ps, ch, T(ids), T(am), generation_config=gc,
                           teacher_tokens=want, mesh=mesh)
    ref = tgen.generate(tree, ch, T(ids), T(am), generation_config=gc,
                        teacher_tokens=want)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=ATOL)


# ------------------------------------------------------------ the judges

class _Tok:
    """A tokenizer of the families' prompts: one id a character."""

    pad_token_id = 0

    def __call__(self, s):
        return {"input_ids": [5 + ord(c) % 60 for c in s]}

    def decode(self, toks):
        return " ".join(map(str, toks))


@pytest.mark.parametrize("data,model", MESHES)
def test_cogvlm2_judge_on_the_mesh_answers_as_jax(cogvlm2, data, model):
    """``CogVLM2Judge(mesh=)`` on a pair through the full prompt and the
    prefix path: the tokens of JAX's unsharded ``greedy_generate_batch``
    and ``continue_prefix`` on the same frames."""
    jcfg, tcfg, jp, state = cogvlm2
    rng = np.random.default_rng(3)
    frames = {p: rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
              for p in ("a", "b")}

    class Judge(tj.CogVLM2Judge):
        def _encode_video(self, path):
            from mjvideo_tpu_torch.models.cogvlm2 import get_vision_embedding

            with torch.no_grad():
                vis = get_vision_embedding(
                    self.params, self.cfg, torch.from_numpy(frames[path]),
                    impl=self.attn_impl, dtype=self.dtype, mesh=self.mesh)
            return vis, 2

    tok = _Tok()
    items = [jcog.build_video_prompt_ids(tok, jcfg, 2, "rate")
             + (frames[p],) for p in "ab"]
    want = jcog.greedy_generate_batch(
        jp, jcfg, items, max_new_tokens=4, eos_token_id=-1, attn_impl="xla")
    mesh = Mesh.local(data, model)
    for prefix_cache in (False, True):
        judge = Judge(tcfg, state, tok, max_new_tokens=4, mesh=mesh,
                      prefix_cache=prefix_cache, suffix_bucket=64)
        judge.cfg = dataclasses.replace(tcfg, eos_token_id=-1)
        got = (judge._ask_prefix("rate", ["a", "b"]) if prefix_cache
               else [judge._decode(t) for t in
                     judge._generate_full("rate", ["a", "b"])])
        assert got == [" ".join(map(str, w)) for w in want], prefix_cache


# ---------------------------------------------------------- two processes

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

from mjvideo_tpu_torch import configs
from mjvideo_tpu_torch.models import generate as tgen
from mjvideo_tpu_torch.models.internvl import init_chat_params
from mjvideo_tpu_torch.parallel.distributed import maybe_initialize
from mjvideo_tpu_torch.parallel.mesh import Mesh, shard_params

torch.set_num_threads(1)
out_dir, data, model = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
maybe_initialize(device="cpu")
mesh = Mesh.distributed(data, model)
inp = np.load(out_dir + "/inputs.npz")
ch = configs.tiny_test_config().chat
state = init_chat_params(ch, generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32, with_lm_head=True)
ps = shard_params(state, mesh, cfg=ch)
res = {}
T = torch.from_numpy
for kv in (False, True):
    gc = tgen.GenerationConfig(max_new_tokens=5, eos_token_id=-1,
                               pad_token_id=0, kv_quant=kv)
    res[f"toks{int(kv)}"] = tgen.generate(
        ps, ch, T(inp["ids"]), T(inp["am"]), generation_config=gc,
        mesh=mesh).numpy()
    res[f"logits{int(kv)}"] = tgen.generate(
        ps, ch, T(inp["ids"]), T(inp["am"]), generation_config=gc,
        teacher_tokens=T(res[f"toks{int(kv)}"]), mesh=mesh).numpy()
if dist.get_rank() == 0:
    np.savez(out_dir + "/rank0.npz", **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_processes_generate_as_the_local_mesh(tmp_path):
    """Two processes over gloo (``Mesh.distributed(1, 2)``: each its own
    kv heads, caches and vocabulary columns, the logits all-gathered)
    against ``Mesh.local(1, 2)`` in this process, bit for bit: tokens and
    teacher-forced logits, dense and int8 cache."""
    ch = tconfigs.tiny_test_config().chat
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 50, size=(2, 9)).astype(np.int32)
    am = np.ones_like(ids)
    ids[1, :2], am[1, :2] = 0, 0
    np.savez(tmp_path / "inputs.npz", ids=ids, am=am)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path), "1", "2"], cwd=REPO,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    logs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err
    got = dict(np.load(tmp_path / "rank0.npz"))

    state = tivl.init_chat_params(
        ch, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32, with_lm_head=True)
    mesh = Mesh.local(1, 2)
    ps = shard_params(state, mesh, cfg=ch)
    T = torch.from_numpy
    for kv in (False, True):
        gc = tgen.GenerationConfig(max_new_tokens=5, eos_token_id=-1,
                                   pad_token_id=0, kv_quant=kv)
        toks = tgen.generate(ps, ch, T(ids), T(am), generation_config=gc,
                             mesh=mesh)
        np.testing.assert_array_equal(got[f"toks{int(kv)}"], toks.numpy())
        logits = tgen.generate(ps, ch, T(ids), T(am), generation_config=gc,
                               teacher_tokens=toks, mesh=mesh)
        np.testing.assert_array_equal(got[f"logits{int(kv)}"],
                                      logits.numpy())
