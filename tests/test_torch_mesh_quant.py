"""The w8a8 serving modes under a model axis (``parallel/mesh.py``'s
``split_plan`` and ``row_dot_over_model``, ``ops/quant.py``'s row products
over the model axis) against the port's unsharded runs and JAX's scorer.

JAX quantizes, then shards over the mesh, and pins that its sharded int8
product equals the single-device one (``tests/test_quant.py:372-392``), so
the oracle of a meshed port run is the unsharded run: the port's on the
same tree, and JAX's scorer on the same bridged tree.  ``tiny_test_config``
in fp32 on the CPU.  Tolerances, each with its reason:

* per-row ``int8``: ``torch.equal`` with the unsharded port (the row amax
  is max-reduced and the int32 partials summed before they dequantize,
  both exact), in a product and in the scorer;
* grouped (``-gN``) and ``-olN`` products: 1e-6 of max|unsharded| (each
  rank's fp32 partial summed in another order than one product's);
* scorers against JAX and against the unsharded port in the other modes:
  ``test_torch_mesh.py``'s TOL (atol 2e-5, rtol 1e-5).  An ulp upstream
  can move an activation across a rounding boundary of its int8 step
  (``test_torch_quant.py`` holds the unsharded port to JAX at 2e-4 for
  that); on these seeds no activation does, and every field reads within
  1e-6 of JAX's;
* the judge: tokens equal, logits ``test_torch_mesh_judges.py``'s ATOL.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu import configs as jconfigs
from mjvideo_tpu.data import prompts as jprompts
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.ops import quant as jq
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.models import cogvlm2 as tcog
from mjvideo_tpu_torch.models import generate as tgen
from mjvideo_tpu_torch.models import internvl as tivl
from mjvideo_tpu_torch.models import minicpmv as tmcpm
from mjvideo_tpu_torch.models import qwen2vl as tqwen
from mjvideo_tpu_torch.models import reward as treward
from mjvideo_tpu_torch.models import videoscore as tvs
from mjvideo_tpu_torch.ops import quant as tq
from mjvideo_tpu_torch.parallel import mesh as tmesh
from mjvideo_tpu_torch.parallel.mesh import Mesh, shard_params
from mjvideo_tpu_torch.utils.bridge import flatten_state, from_jax_params

from test_torch_mesh import TOL, _clips, _jax_params
from test_torch_mesh_judges import (
    ATOL,
    _cogvlm2_ref,
    _gc,
    _minicpmv_ref,
    _qwen2vl_ref,
    _videoscore_ref,
)
from test_torch_quant import _vision_per_column

torch.set_num_threads(1)
MIN_ELEMENTS = 1024  # tiny kernels are below the serving modes' 1 << 16
# At hidden 64 a group of 32 holds whole on each of 2 ranks in every row
# member: the decoder's wo (K 64) and w2 (128), the ViT's proj and fc2.
MODES = ("int8", "int8-vit", "int8-noattn-g32", "int8-ol8")
MESHES = [(1, 2), (2, 2)]
# The 2B's Megatron members: (path, column member or not).
MEMBERS_2B = (
    ("vision_model/layers/attn/qkv/kernel", True),
    ("vision_model/layers/attn/proj/kernel", False),
    ("vision_model/layers/mlp/fc1/kernel", True),
    ("vision_model/layers/mlp/fc2/kernel", False),
    ("language_model/layers/attention/wq/kernel", True),
    ("language_model/layers/attention/wk/kernel", True),
    ("language_model/layers/attention/wv/kernel", True),
    ("language_model/layers/attention/wo/kernel", False),
    ("language_model/layers/feed_forward/w1/kernel", True),
    ("language_model/layers/feed_forward/w3/kernel", True),
    ("language_model/layers/feed_forward/w2/kernel", False),
)


def _rel(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("mode", MODES[:2] + ("int8-noattn-g128", "int8-ol8"))
def test_split_plan_splits_the_2b_pairs_under_each_mode(mode):
    """The full 2B (shapes on the meta device) quantized by ``mode``: every
    Megatron pair of the ViT and the decoder splits, node field by field
    (``q`` with its member, a per-column ``scale`` with a column member and
    whole under a row member, a group-128 row member's scale by groups),
    so that the guard cannot quietly keep them whole."""
    cfg = tconfigs.mjvideo_2b_config()
    state = treward.init_reward_params(cfg, generator=None, device="meta",
                                       dtype=torch.bfloat16)
    tree = tq.quantize_params_mode(state, mode)
    plan = tmesh.split_plan(tree, 2, cfg)
    flat = flatten_state(tree)
    quantized = 0
    for member, column in MEMBERS_2B:
        path = "model/" + member
        if path + "/.q" not in flat:
            assert plan[path].kind in ("cols", "qkv", "rows"), path
            continue
        quantized += 1
        assert plan[path + "/.q"].kind == (
            ("qkv" if "qkv" in path else "cols") if column else "rows")
        grouped = flat[path + "/.scale"].shape[-2] > 1
        if column or grouped:
            assert plan[path + "/.scale"].dim == (2 if column else 1), path
        else:
            assert path + "/.scale" not in plan, path
    assert quantized == {"int8-vit": 4, "int8-noattn-g128": 7}.get(mode, 11)


def test_grouped_row_member_without_whole_groups_stays_whole():
    """At the decoder's intermediate 96 a group of 32 gives w2 three
    groups: two ranks cannot hold them whole, so the MLP pair stays whole
    on every rank (the guard of an int4 row member, ``q4rows``); the
    attention pair, whose wo holds two groups, splits."""
    base = tconfigs.tiny_test_config()
    cfg = dataclasses.replace(base, chat=dataclasses.replace(
        base.chat, llm=dataclasses.replace(base.chat.llm,
                                           intermediate_size=96)))
    state = treward.init_reward_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    tree = tq.quantize_params_mode(state, "int8-g32",
                                   min_elements=MIN_ELEMENTS)
    plan = tmesh.split_plan(tree, 2, cfg)
    assert not any("feed_forward" in p for p in plan)
    assert "model/language_model/layers/attention/wo/kernel/.scale" in plan
    assert plan["model/language_model/layers/attention/wo/kernel/.q"
                ].kind == "rows"


def test_cut_and_join_round_trip_node_fields():
    """``shard_params`` then ``gather_params`` gives a quantized state back
    bit for bit, its int8 fields k-major again."""
    cfg = tconfigs.tiny_test_config()
    state = treward.init_reward_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    for mode in ("int8", "int8-noattn-g32"):
        tree = tq.quantize_params_mode(state, mode, min_elements=MIN_ELEMENTS)
        mesh = Mesh.local(1, 2)
        plan = tmesh.split_plan(tree, 2, cfg)
        back = tmesh.gather_params(shard_params(tree, mesh, cfg=cfg), mesh,
                                   plan)
        a, b = flatten_state(back), flatten_state(tree)
        assert a.keys() == b.keys()
        for k, v in b.items():
            assert torch.equal(a[k], v), k
            if v.dtype == torch.int8 and v.dim() == 3:
                assert tq.is_k_major(a[k][0]), k


# ------------------------------------------------------------ products

def _row_cut(kernel, m=2, rows_scale=False):
    """Each rank's rows of a (K, N) quantized row member, as
    ``shard_params`` cuts it: a per-column ``QuantKernel``'s piece a
    ``RowsQuantKernel``."""
    split = tmesh.Split("rows", 0)
    out = []
    for j in range(m):
        scale = (tmesh.cut(kernel.scale, split, j, m) if rows_scale
                 else kernel.scale)
        piece = dataclasses.replace(
            kernel, q=tmesh.cut(kernel.q, split, j, m), scale=scale)
        if type(kernel) is tq.QuantKernel and not rows_scale:
            piece = tq.RowsQuantKernel(piece.q, piece.scale)
        out.append(piece)
    return out


@pytest.mark.parametrize("kind", ["int8", "g32", "ol8"])
def test_row_products_over_the_model_axis_match_one_product(kind):
    """A row member cut over 2 ranks against its whole product on the same
    x: per-row int8 bit-equal; grouped (K6's twin on each rank's groups)
    and ``-ol8`` (the outlier channels chosen over the whole K) within 1e-6
    of max|unsharded|."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 128, generator=g)
    x[..., 70] *= 9.0  # an outlier channel on rank 1
    w = torch.randn(128, 48, generator=g) * 0.05
    tp = Mesh.local(1, 2)
    xs = list(x.split(64, -1))
    if kind == "int8":
        k = tq.quantize_kernel(w)
        got = tq.dot_q8_rows_over_model(tp, xs, _row_cut(k))
        assert torch.equal(got, tq.dot_q8_f32(x, k))
        assert torch.equal(tmesh.row_dot_over_model(tp, xs, _row_cut(k)),
                           got)
        return
    if kind == "g32":
        k = tq.quantize_kernel(w, group_size=32)
        got = tmesh.row_dot_over_model(tp, xs, _row_cut(k, rows_scale=True))
        want = tq.dot_q8_f32(x, k)
    else:
        qk = tq.quantize_kernel(w)
        k = tq.OutlierQuantKernel(qk.q, qk.scale, n_outliers=8)
        got = tmesh.row_dot_over_model(tp, xs, _row_cut(k))
        want = tq.dot_q8_ol_f32(x, k)
    assert _rel(got, want) <= 1e-6


def test_shard_params_marks_per_column_row_pieces_only():
    """``shard_params`` makes a per-column w8a8 row member's piece a
    ``RowsQuantKernel`` (its product takes the amax over every rank) and
    leaves a grouped one's, one group a rank at hidden 64 and g 32 (the
    same shapes as a per-column piece), a ``QuantKernel``;
    ``gather_params`` gives the plain nodes back."""
    cfg = tconfigs.tiny_test_config()
    state = treward.init_reward_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    mesh = Mesh.local(1, 2)
    for mode, cls in (("int8", tq.RowsQuantKernel), ("int8-g32",
                                                     tq.QuantKernel)):
        tree = tq.quantize_params_mode(state, mode, min_elements=MIN_ELEMENTS)
        shards = shard_params(tree, mesh, cfg=cfg)
        for ps in shards:
            wo = ps["model"]["language_model"]["layers"]["attention"]["wo"]
            assert type(wo["kernel"]) is cls
            wq = ps["model"]["language_model"]["layers"]["attention"]["wq"]
            assert type(wq["kernel"]) is tq.QuantKernel
        back = tmesh.gather_params(shards, mesh,
                                   tmesh.split_plan(tree, 2, cfg))
        assert all(type(n) is tq.QuantKernel for n in tq.quant_nodes(back))


@pytest.mark.parametrize("layout", ["straddle", "one_rank"])
def test_outlier_channels_straddling_ranks_are_jaxs(layout):
    """``-ol8`` over 2 ranks of 32 channels: the top 8 by column amax,
    ties to the lower global index as ``jax.lax.top_k`` breaks them, where
    the tied channels lie on both ranks (or all on rank 1).  The result
    equals JAX's ``dot_q8_ol`` on the whole x; a pick from the wrong side
    of a tie quantizes a channel JAX keeps in full precision."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    tied = ([3, 7, 20, 30, 33, 40, 41, 50, 60, 62] if layout == "straddle"
            else [33, 35, 40, 41, 44, 50, 52, 55, 60, 62])
    for c in tied:  # ten channels share the largest amax, 8 are taken
        x[:, c] = rng.uniform(-1.3, 1.3, size=6)
        x[0, c] = 40.0
    w = (0.05 * rng.normal(size=(64, 24))).astype(np.float32)
    jk = jq.quantize_kernel(jnp.asarray(w))
    jk = jq.OutlierQuantKernel(q=jk.q, scale=jk.scale, n_outliers=8)
    want = np.asarray(jq.dot_q8_ol(jnp.asarray(x), jk))
    k = tq.OutlierQuantKernel(tq.k_major(torch.from_numpy(np.asarray(jk.q))),
                              torch.from_numpy(np.asarray(jk.scale)), 8)
    xt = torch.from_numpy(x)
    got = tmesh.row_dot_over_model(Mesh.local(1, 2), list(xt.split(32, -1)),
                                   _row_cut(k))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
    # The two untaken ties (the two of highest index) go through int8.
    idx = torch.sort(xt.abs().amax(0), descending=True,
                     stable=True).indices[:8]
    assert sorted(idx.tolist()) == sorted(tied[:8])


# ------------------------------------------------------------- scoring

@functools.lru_cache(None)
def _scoring_ref(mode):
    """(the bridged quantized tree, the clips, JAX's scores), once a
    worker: the cases of a mode share JAX's compile."""
    jcfg = jconfigs.tiny_test_config()
    jtree = jax.tree.map(np.asarray, jq.quantize_params_mode(
        _jax_params(jcfg, seed=1), mode, min_elements=MIN_ELEMENTS))
    if "-ol" in mode:
        # The JAX ViT picks its outlier channels over its pad rows too
        # (``test_torch_quant.py``): per-column nodes in the tower.
        jtree = _vision_per_column(jtree)
    tok = jprompts.ByteTokenizer()
    ref_scorer = JaxRewardScorer(jcfg, jtree, tok, attn_impl="xla",
                                 dtype=jnp.float32, length_buckets=(512,),
                                 gating_pattern=tok.gating_pattern(),
                                 quant=mode)
    cfg = tconfigs.tiny_test_config()
    clips = _clips(cfg, tok, np.random.default_rng(0))
    return jtree, clips, ref_scorer.score_batch(*clips)


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_meshed_w8a8_scorer_matches_jax_and_the_unsharded_port(mode, data,
                                                               model):
    """``RewardScorer(quant=mode, mesh=local(data, 2))`` on JAX's quantized
    tree: every output field within TOL of JAX's scorer; the score
    bit-equal to the unsharded port's in per-row ``int8`` (every row member
    quantized) and within TOL in the others (``-vit``
    leaves the decoder's row members in fp32, summed from each rank's
    partial)."""
    jtree, (pix, ids, gpos), ref = _scoring_ref(mode)
    cfg = tconfigs.tiny_test_config()
    tok = jprompts.ByteTokenizer()
    tree = from_jax_params(jtree, device="cpu")
    common = dict(length_buckets=(512,), gating_pattern=tok.gating_pattern(),
                  dtype=torch.float32, quant=mode)
    # The clips a forward: one, or under ``-olN`` (whose channels couple
    # the rows of a forward) the whole batch, as JAX's scorer runs it.
    batch = None if "-ol" in mode else 1
    port = RewardScorer(cfg, tree, tok, device_batch=batch,
                        mesh=Mesh.local(data, model), **common)
    assert any(".q" in p for p in tmesh.split_plan(tree, model, cfg))
    got = port.score_batch(pix, ids, gpos)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    one = RewardScorer(cfg, tree, tok, device_batch=batch, **common)
    want = one.score_batch(pix, ids, gpos).score
    if mode == "int8":
        assert torch.equal(got.score, want)
    else:
        np.testing.assert_allclose(got.score.numpy(), want.numpy(), **TOL)


# --------------------------------------------------------------- judges

@pytest.fixture(scope="module")
def chat_int8():
    ch = tconfigs.tiny_test_config().chat
    state = tivl.init_chat_params(
        ch, generator=torch.Generator().manual_seed(1), device="cpu",
        dtype=torch.float32, with_lm_head=True)
    tree = tq.quantize_params_mode(state, "int8", min_elements=MIN_ELEMENTS)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 50, size=(2, 9)).astype(np.int64)
    am = np.ones_like(ids)
    ids[1, :2], am[1, :2] = 0, 0  # left-padded row
    return ch, tree, torch.from_numpy(ids), torch.from_numpy(am)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "int8"])
def test_int8_judge_generation_at_one_by_two_equals_unsharded(chat_int8,
                                                              kv_quant):
    """The tiny judge's decoder under ``int8`` at ``local(1, 2)``, the
    dense and the int8 KV cache: greedy tokens equal to the unsharded
    port's on the same tree, teacher-forced logits within ATOL; the
    judge's ``_place`` splits the tree."""
    ch, tree, ids, am = chat_int8
    gc = _gc(tgen, kv_quant)
    want = tgen.generate(tree, ch, ids, am, generation_config=gc)
    mesh = Mesh.local(1, 2)
    judge = tj.InternVLJudge(ch, tree, None, mesh=mesh)
    assert isinstance(judge.params, list) and len(judge.params) == 2
    assert "language_model/layers/attention/wo/kernel/.q" in \
        tmesh.split_plan(tree, 2, ch)
    got = tgen.generate(judge.params, ch, ids, am, generation_config=gc,
                        mesh=mesh)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    logits = tgen.generate(judge.params, ch, ids, am, generation_config=gc,
                           teacher_tokens=want, mesh=mesh)
    ref = tgen.generate(tree, ch, ids, am, generation_config=gc,
                        teacher_tokens=want)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=ATOL)


def test_int8_judge_prefix_path_at_one_by_two_equals_unsharded(chat_int8):
    """Two B = 1 prefix states of the ``int8`` tree (each rank's cache of
    its kv heads), stacked, a suffix each: the tokens at ``local(1, 2)``
    equal the unsharded prefix path's."""
    ch, tree, _, _ = chat_int8
    rng = np.random.default_rng(2)
    pre = np.zeros((2, 10), np.int64)
    pam = np.zeros_like(pre)
    for b, n in enumerate((8, 9)):
        pre[b, :n], pam[b, :n] = rng.integers(1, 250, size=n), 1
    suf = np.zeros((2, 7), np.int64)
    sam = np.zeros_like(suf)
    suf[:, :5], sam[:, :5] = rng.integers(1, 250, size=5), 1
    T = torch.from_numpy
    gc, max_len = _gc(tgen, False), 10 + 7 + 6

    def run(ps, mesh=None):
        states = [tgen.prefill_prefix(ps, ch, T(pre[b:b + 1]),
                                      T(pam[b:b + 1]), max_len=max_len,
                                      mesh=mesh) for b in (0, 1)]
        return tgen.generate_from_prefix(
            ps, ch, tgen.stack_prefix_states(states), T(suf), T(sam),
            generation_config=gc, mesh=mesh)

    mesh = Mesh.local(1, 2)
    got = run(shard_params(tree, mesh, cfg=ch), mesh)
    np.testing.assert_array_equal(got.numpy(), run(tree).numpy())


def _family_logits(name, tree, cfg, inputs, mesh=None):
    T = torch.from_numpy
    ps = tree if mesh is None else shard_params(tree, mesh, cfg=cfg)
    if name == "minicpmv":
        pix, ids, mask = inputs
        return tmcpm.lm_logits(ps, tmcpm.minicpmv_forward(
            ps, cfg, T(ids), T(mask), T(pix), mesh=mesh), mesh=mesh,
            vocab_size=cfg.text.vocab_size)
    if name == "cogvlm2":
        pix, ids, tt, pos, mask = inputs
        return tcog.lm_logits(ps, tcog.cogvlm2_forward(
            ps, cfg, T(ids), T(tt), T(mask), T(pos), pixel_values=T(pix),
            mesh=mesh), mesh=mesh, vocab_size=cfg.text.vocab_size)
    if name == "qwen2vl":
        grid, patches, ids, mask, pos = inputs
        return tqwen.lm_logits(ps, cfg, tqwen.qwen2vl_forward(
            ps, cfg, T(ids), T(mask), T(pos), T(patches), grid, mesh=mesh),
            mesh=mesh)
    pix, ids, mask = inputs
    return tvs.videoscore_forward(ps, cfg, T(pix), T(ids), T(mask),
                                  mesh=mesh)


_FAMILIES = {"minicpmv": _minicpmv_ref, "cogvlm2": _cogvlm2_ref,
             "qwen2vl": lambda: _qwen2vl_ref(False),
             "videoscore": _videoscore_ref}


@pytest.mark.parametrize("name", sorted(_FAMILIES))
def test_int8_families_at_one_by_two_equal_unsharded(name):
    """MiniCPM-V, CogVLM2 (its dual-expert ``dense`` and MLPs), Qwen2-VL and
    VideoScore (the perceiver's ``o``) under ``int8`` at ``local(1, 2)``:
    their split row members' products run through ``row_dot_over_model``,
    the logits within ATOL of the unsharded port's on the same tree, with
    some of the family's pairs split."""
    cfg, state, inputs, _ = _FAMILIES[name]()
    tree = tq.quantize_params_mode(state, "int8", min_elements=256)
    plan = tmesh.split_plan(tree, 2, cfg)
    assert sum(p.endswith("/.q") for p in plan) >= 4, sorted(plan)
    with torch.no_grad():
        want = _family_logits(name, tree, cfg, inputs)
        got = _family_logits(name, tree, cfg, inputs, Mesh.local(1, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
