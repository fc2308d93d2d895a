"""The port's quantized serving against the JAX package's, on the CPU.

* The plain twins of K6, K7 and K5 against the JAX Pallas kernels in
  interpret mode, called as ``tests/test_quant.py`` and
  ``tests/test_quant4.py`` call them, at M tails, odd N and g of 32, 64 and
  128: fp32 operands, max|twin - pallas| <= 1e-5 * max|pallas| (the two
  multiply each group's scales and sum in fp32, in orders that may differ
  by an ulp; an int8 or nibble fault moves the output by a quantization
  step, 1e-3 of it or more).
* ``quantize_kernel``, ``quantize_kernel_q4`` and every mode of
  ``quantize_params_mode`` on bridged weights: q, qw, packed and scale
  bit-equal to JAX's, and ``from_jax_params`` of JAX's quantized tree equal
  to the port's own quantization.  At ``tiny_test_config`` the default
  ``min_elements = 1 << 16`` quantizes nothing, so both sides quantize with
  ``MIN_ELEMENTS`` and the expected count of nodes is asserted.
* ``RewardScorer`` scores and the InternVL judge's teacher-forced logits
  (vision, prefill and cached decode) against JAX with the same quantized
  tree, fp32: scores to atol 2e-5 (the bar of ``test_torch_scorer.py``)
  in the weight-only modes and 2e-4 in those that quantize activations at
  run time (``ACT_QUANT_ATOL``), logits to atol 1e-4 (that of
  ``test_torch_generate.py``).  Each quantized product agrees with JAX's
  to an ulp on the same input (the twin tests above); but an ulp of
  difference upstream (attention's fp32 sums run in another order) can move
  an activation across a rounding boundary of its int8 step, which moves
  the result by that step's product, about 7e-5 of a hidden state here.
* The port imports no ``jax`` and no ``mjvideo_tpu`` module, and its
  copied configs and prompts equal the JAX package's.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu import configs as jconfigs
from mjvideo_tpu.data import prompts as jprompts
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models import decoder as jdec
from mjvideo_tpu.models import generate as jgen
from mjvideo_tpu.models import internvl as jinternvl
from mjvideo_tpu.models.reward import init_reward_params
from mjvideo_tpu.ops import quant as jq
from mjvideo_tpu.ops import quant4 as jq4
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch.data import prompts as tprompts
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.models import generate as tgen
from mjvideo_tpu_torch.ops import matmul as tmm
from mjvideo_tpu_torch.ops import quant as tq
from mjvideo_tpu_torch.ops import quant4 as tq4
from mjvideo_tpu_torch.utils.bridge import from_jax_params, map_state

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TWIN_REL = 1e-5
ACT_QUANT_ATOL = 2e-4
MIN_ELEMENTS = 1024
MODES = ("int8", "int8-vit", "int8-noattn", "int8-wo", "int8-g32",
         "int8-noattn-g128", "int8-wo-g64", "int8-ol8", "int4-wo")
SERVED_MODES = ("int8", "int8-noattn-g32", "int8-wo", "int8-ol8", "int4-wo")
NEW = 4


def _close(got, ref, rel=TWIN_REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ------------------------------------------------------------ the twins

@pytest.mark.parametrize("M,K,N,g", [(37, 256, 72, 32), (16, 256, 201, 64),
                                     (5, 512, 128, 128), (1, 128, 33, 32)])
def test_k6_and_k7_twins_match_pallas(M, K, N, g):
    rng = np.random.default_rng(M + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    qk = jq.quantize_kernel(jnp.asarray(w), group_size=g)
    ref6 = jq._q8g_matmul_pallas_fused(
        jnp.asarray(x), qk.q, qk.scale, out_dtype=jnp.float32, block_m=16,
        block_n=N, interpret=True)
    wq, ws = torch.from_numpy(np.array(qk.q)), torch.from_numpy(
        np.array(qk.scale))
    got6 = tq.q8g_matmul_fused(torch.from_numpy(x), wq, ws, torch.float32)
    _close(got6, ref6)
    G = K // g
    xq, a_s = jq._quantize_rows_grouped(jnp.asarray(x), G, g)
    txq, ta_s = tq._quantize_rows_grouped(torch.from_numpy(x), G, g)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(ta_s.numpy(), np.asarray(a_s))
    ref7 = jq._q8g_matmul_pallas(xq, a_s, qk.q, qk.scale, block_m=16,
                                 block_n=N, interpret=True)
    _close(tq.q8g_matmul(txq, ta_s, wq, ws), ref7)
    # The public dot routes a grouped kernel to K6 at x's dtype.
    node = tq.QuantKernel(q=wq, scale=ws)
    _close(tmm.dot(torch.from_numpy(x), node), ref6)


@pytest.mark.parametrize("M,K,N,g,dtype", [
    (1, 256, 77, 64, "float32"), (2, 256, 72, 32, "float32"),
    (32, 512, 96, 128, "float32"), (5, 256, 40, 64, "bfloat16")])
def test_k5_twin_matches_pallas(M, K, N, g, dtype):
    """K5's twin, and ``dot_q4`` (K5's route at 32 rows or fewer), against
    ``_w4_matmul_pallas``; in bf16 both round each dequantized weight to
    bf16 before the fp32-accumulated product."""
    rng = np.random.default_rng(M * K + N)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    k4 = jq4.quantize_kernel_q4(jnp.asarray(w), group_size=g)
    jx = jnp.asarray(x).astype(dtype)
    ref = jq4._w4_matmul_pallas(jx, k4.packed, k4.scale, block_n=N,
                                interpret=True)
    tk4 = from_jax_params({"k": k4}, device="cpu")["k"]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    _close(tq4.w4_matmul(tx, tk4.packed, tk4.scale), ref)
    _close(tmm.dot_f32(tx, tk4), ref)


def test_dot_q4_over_32_rows_takes_the_halves():
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(128, 48)) * 0.05).astype(np.float32)
    x = rng.normal(size=(3, 20, 128)).astype(np.float32)
    k4 = jq4.quantize_kernel_q4(jnp.asarray(w), group_size=32)
    ref = jq4.dot_q4(jnp.asarray(x), k4)
    tk4 = tq4.quantize_kernel_q4(torch.from_numpy(w), group_size=32)
    _close(tmm.dot(torch.from_numpy(x), tk4), ref)


def test_dot_q8_ol_matches_jax_and_breaks_ties_by_index():
    """The outlier decomposition against JAX; then a column-amax tie at the
    top-k boundary (channels 3 and 9 share it, k = 2 after channel 0),
    which ``jax.lax.top_k`` breaks toward the lower index, as the port's
    stable sort does."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(64, 40)) * 0.05).astype(np.float32)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    x[:, 0] *= 30.0
    jk = jq.quantize_kernel(jnp.asarray(w))
    jol = jq.OutlierQuantKernel(q=jk.q, scale=jk.scale, n_outliers=2)
    tol = from_jax_params({"k": jol}, device="cpu")["k"]
    assert isinstance(tol, tq.OutlierQuantKernel) and tol.n_outliers == 2
    _close(tq.dot_q8_ol_f32(torch.from_numpy(x), tol),
           jq.dot_q8_ol_f32(jnp.asarray(x), jol))
    x = np.clip(x, -2.0, 2.0)
    x[0, 0], x[1, 3], x[2, 9] = 9.0, 5.0, -5.0
    _close(tq.dot_q8_ol_f32(torch.from_numpy(x), tol),
           jq.dot_q8_ol_f32(jnp.asarray(x), jol))


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("group_size", [None, 32, 64, 128])
def test_quantize_kernel_is_bit_equal_to_jax(group_size):
    w = np.random.default_rng(0).normal(size=(3, 256, 96)).astype(np.float32)
    ref = jq.quantize_kernel(jnp.asarray(w), group_size=group_size)
    got = tq.quantize_kernel(torch.from_numpy(w), group_size=group_size)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    _close(tq.dequantize_kernel(got), jq.dequantize_kernel(ref), 0)


def test_quantize_kernel_q4_is_bit_equal_to_jax():
    w = np.random.default_rng(1).normal(size=(2, 256, 40)).astype(np.float32)
    ref = jq4.quantize_kernel_q4(jnp.asarray(w), group_size=64)
    got = tq4.quantize_kernel_q4(torch.from_numpy(w), group_size=64)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(
        got.scale.float().numpy(), np.asarray(ref.scale.astype(jnp.float32)))
    _close(tq4.dequantize_kernel_q4(got), jq4.dequantize_kernel_q4(ref), 0)


@pytest.fixture(scope="module")
def reward_params():
    cfg = jconfigs.tiny_test_config()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_reward_params(key, cfg))(jax.random.PRNGKey(1)))
    return cfg, params


def _nodes_by_path(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_nodes_by_path(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _expected_nodes(mode):
    """Kernels quantized at MIN_ELEMENTS in the tiny reward tree: the ViT's
    4 per layer, the projector's 2 and the decoder's 7 per layer are
    stacked leaves, one node each."""
    vit, proj, dec_attn, dec_mlp = 4, 2, 4, 3
    if "vit" in mode.split("-"):
        return vit
    if "noattn" in mode:
        return vit + proj + dec_mlp
    return vit + proj + dec_attn + dec_mlp


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_mode_is_bit_equal_to_jax(reward_params, mode):
    _, params = reward_params
    jtree = jax.tree.map(np.asarray, jq.quantize_params_mode(
        params, mode, min_elements=MIN_ELEMENTS))
    ttree = tq.quantize_params_mode(from_jax_params(params, device="cpu"),
                                    mode, min_elements=MIN_ELEMENTS)
    bridged = from_jax_params(jtree, device="cpu")
    got, via, ref = (_nodes_by_path(t) for t in (ttree, bridged, jtree))
    assert got.keys() == ref.keys() == via.keys()
    n = 0
    for path, r in ref.items():
        t = got[path]
        assert type(via[path]) is type(t), path
        if not tq.is_qnode(t):
            assert isinstance(r, np.ndarray), path
            np.testing.assert_array_equal(t.numpy(), r, err_msg=path)
            continue
        assert type(t).__name__ == type(r).__name__, path
        n += 1
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(via[path], f.name)
            want = getattr(r, f.name)
            if f.name == "n_outliers":
                assert a == b == want, path
                continue
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(
                want).astype(np.float32), err_msg=f"{path}/{f.name}")
            assert torch.equal(a, b), f"{path}/{f.name}"
    assert n == _expected_nodes(mode) == len(tq.quant_nodes(ttree))
    assert tq.is_quantized(ttree)


def test_map_state_slices_stacked_nodes(reward_params):
    _, params = reward_params
    tree = tq.quantize_params_mode(from_jax_params(params, device="cpu"),
                                   "int4-wo", min_elements=MIN_ELEMENTS)
    layers = tree["model"]["language_model"]["layers"]
    one = map_state(lambda a: a[1], layers)
    node = one["feed_forward"]["w1"]["kernel"]
    full = layers["feed_forward"]["w1"]["kernel"]
    assert isinstance(node, tq4.Q4Kernel) and node.packed.dim() == 2
    assert torch.equal(node.packed, full.packed[1])
    assert torch.equal(node.scale, full.scale[1])


# ------------------------------------------------ scorer and judge paths

def _clips(cfg, tok, rng):
    ids, gpos, frames = [], [], []
    for caption, n in (("a dog", 2), ("a much longer caption about a cat", 1)):
        chat = jprompts.prepare_chat_input(
            cfg.chat, tok, jprompts.build_video_question(caption, n),
            num_patches_list=[1] * n, gating_pattern=tok.gating_pattern())
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
        frames.append(n)
    size = cfg.chat.image_size
    pix = rng.normal(size=(sum(frames), size, size, 3)).astype(np.float32)
    return pix, ids, gpos


def _jax_tree(params, mode):
    """JAX's quantized tree for the scorer and judge tests, quantized under
    jit (several times faster than op by op; the bits may differ from the
    eager quantizer's, but both sides take this same tree)."""
    return jax.tree.map(np.asarray, jax.jit(
        lambda p: jq.quantize_params_mode(p, mode,
                                          min_elements=MIN_ELEMENTS))(params))


def _vision_per_column(tree, path=""):
    """``tree`` with the vision tower's outlier nodes made per-column
    ``QuantKernel``s of the same q and scale.  The JAX ViT pads its tokens
    to a multiple of 8 (``vit.py:245-255``: 17 -> 24 here, 1,025 -> 1,032 at
    448 px), and ``dot_q8_ol`` takes its outlier channels over every row,
    the pad rows too; the port has no pad rows, so the two pick their
    channels from different rows there (ROADMAP, Queue 3)."""
    if isinstance(tree, dict):
        return {k: _vision_per_column(v, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, jq.OutlierQuantKernel) and "vision_model" in path:
        return jq.QuantKernel(q=tree.q, scale=tree.scale)
    return tree


@pytest.mark.parametrize("mode", SERVED_MODES)
def test_scorer_quant_matches_jax(reward_params, mode):
    """Both scorers take the same pre-quantized tree and ``quant=mode``
    (which leaves a quantized tree as it is); under ``-olN`` the vision
    tower's nodes are per-column (``_vision_per_column``)."""
    cfg, params = reward_params
    jtree = _jax_tree(params, mode)
    if "-ol" in mode:
        jtree = _vision_per_column(jtree)
    tok = jprompts.ByteTokenizer()
    common = dict(length_buckets=(512,), gating_pattern=tok.gating_pattern(),
                  quant=mode)
    ref_scorer = JaxRewardScorer(cfg, jtree, tok, attn_impl="xla",
                                 dtype=jnp.float32, **common)
    port = RewardScorer(cfg, from_jax_params(jtree, device="cpu"), tok,
                        dtype=torch.float32, **common)
    assert port.quant == mode
    assert len(tq.quant_nodes(port.params)) == _expected_nodes(mode)
    pix, ids, gpos = _clips(port.cfg, tok, np.random.default_rng(0))
    ref = ref_scorer.score_batch(pix, ids, gpos)
    got = port.score_batch(pix, ids, gpos)
    atol = 2e-5 if mode.endswith("-wo") else ACT_QUANT_ATOL
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def chat_params():
    ch = jconfigs.tiny_test_config().chat
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jinternvl.init_chat_params(key, ch, with_lm_head=True))(
            jax.random.PRNGKey(1)))
    return ch, params


def _jax_forced_logits(ch, params, ids, mask, pix, toks):
    """JAX's per-step logits with ``toks`` fed back: vision, the image
    scatter, the cached prefill and one cached step per token."""
    lm = params["language_model"]
    B, T = ids.shape
    # Jitted, as ``test_torch_generate.py`` runs them: op by op, JAX's
    # quantized products dominate the test's time.
    step = jax.jit(lambda lm, e, c, s, m: jgen.decoder_forward_cached(
        lm, ch.llm, e, c, s, m, attn_impl="xla"))
    head = jax.jit(jdec.lm_logits)
    vis = jax.jit(lambda p, x: jinternvl.extract_feature(
        p, ch, x, attn_impl="xla"))(params, jnp.asarray(pix))
    emb = jinternvl.scatter_image_embeds(
        jdec.embed_tokens(lm, jnp.asarray(ids)), jnp.asarray(ids), vis,
        ch.img_context_token_id)
    cache = jgen.init_kv_cache(ch.llm, B, T + NEW, dtype=emb.dtype)
    cmask = jnp.pad(jnp.asarray(mask), ((0, 0), (0, NEW)))
    slots = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    hidden, cache = step(lm, emb, cache, slots, cmask)
    out = [head(lm, hidden[:, T - 1])]
    for i in range(toks.shape[1] - 1):
        slot = jnp.full((B,), T + i)
        cmask = cmask.at[:, T + i].set(1)
        emb = jdec.embed_tokens(lm, jnp.asarray(toks[:, i:i + 1]))
        hidden, cache = step(lm, emb, cache, slot[:, None], cmask)
        out.append(head(lm, hidden[:, 0]))
    return np.stack([np.asarray(x) for x in out], axis=1)


@pytest.mark.parametrize("mode", SERVED_MODES)
def test_judge_quant_logits_match_jax(chat_params, mode):
    """An ``InternVLJudge(quant=mode)`` on the pre-quantized chat tree (the
    LM head quantized too): teacher-forced logits of a 2-row prompt with 2
    image tiles each, through the judge's state, against JAX's."""
    ch, params = chat_params
    jtree = _jax_tree(params, mode)
    assert isinstance(jtree["language_model"]["output"]["kernel"],
                      (jq.QuantKernel, jq.WOQuantKernel,
                       jq.OutlierQuantKernel, jq4.Q4Kernel))
    judge = tj.InternVLJudge(ch, from_jax_params(jtree, device="cpu"),
                             tprompts.ByteTokenizer(), quant=mode)
    rng = np.random.default_rng(4)
    n_img = ch.num_image_token
    T = 6 + 2 * n_img
    ids = rng.integers(1, 250, size=(2, T)).astype(np.int32)
    ids[:, 3:3 + 2 * n_img] = ch.img_context_token_id
    mask = np.ones((2, T), np.int32)
    pix = rng.normal(size=(4, ch.image_size, ch.image_size, 3)).astype(
        np.float32)
    toks = rng.integers(1, 250, size=(2, NEW))
    gc = tgen.GenerationConfig(max_new_tokens=NEW)
    got = tgen.generate(judge.params, ch, torch.from_numpy(ids),
                        torch.from_numpy(mask), pixel_values=pix,
                        generation_config=gc,
                        teacher_tokens=torch.from_numpy(toks))
    ref = _jax_forced_logits(ch, jtree, ids, mask, pix, toks)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


# ----------------------------------------------------- isolation, copies

def test_port_imports_no_jax_and_no_mjvideo_tpu():
    """In a fresh interpreter: import ``mjvideo_tpu_torch`` and every
    submodule (the ViT attention variants' ``ops.vit_attention_variants``
    among them), ``chip_smoke.py`` and the two A/B harnesses of the ViT
    attention under ``tools/``, then find no ``jax`` and no
    ``mjvideo_tpu`` module loaded."""
    code = """
import importlib, importlib.util, pkgutil, sys
import mjvideo_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, "mjvideo_tpu_torch."):
    importlib.import_module(m.name)
assert "mjvideo_tpu_torch.ops.vit_attention_variants" in sys.modules
import chip_smoke
for name in ("vit_attn_variants_torch", "vit_layout_ab_torch"):
    spec = importlib.util.spec_from_file_location(name, f"tools/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "mjvideo_tpu" or m.startswith("mjvideo_tpu."))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_copied_configs_and_prompts_equal_jax():
    for name in ("tiny_test_config", "mjvideo_2b_config",
                 "internvl2_2b_chat_config"):
        assert (dataclasses.asdict(getattr(tconfigs, name)())
                == dataclasses.asdict(getattr(jconfigs, name)())), name
    cfg_t, cfg_j = tconfigs.tiny_test_config(), jconfigs.tiny_test_config()
    tok_t, tok_j = tprompts.ByteTokenizer(), jprompts.ByteTokenizer()
    q = tprompts.build_video_question("A cat naps.", 2)
    assert q == jprompts.build_video_question("A cat naps.", 2)
    for history in (None, [("Hi", "Hello.")]):
        a = tprompts.prepare_chat_input(cfg_t.chat, tok_t, q, [1, 1],
                                        history=history,
                                        gating_pattern=tok_t.gating_pattern())
        b = jprompts.prepare_chat_input(cfg_j.chat, tok_j, q, [1, 1],
                                        history=history,
                                        gating_pattern=tok_j.gating_pattern())
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        assert (a.prompt, a.gating_pos) == (b.prompt, b.gating_pos)
    assert (tprompts.rebase_img_context_id(tconfigs.mjvideo_2b_config(), tok_t)
            .chat.img_context_token_id == tok_t.img_context_token_id)
