"""The port's mesh (``mjvideo_tpu_torch/parallel/mesh.py``): its rules
against JAX's, and data and tensor parallelism against the JAX package's
unsharded runs.

JAX's own tests hold every meshed JAX run to the unsharded one
(``tests/test_parallel.py``), so the oracle of a meshed port run is the
unsharded JAX run; no JAX mesh is compiled.  ``tiny_test_config`` in fp32
on the CPU unless a test says otherwise.  Tolerances, each with its
reason:

* forwards and scorers: atol 2e-5, rtol 1e-5 (the unsharded port's bar
  against JAX, ``test_torch_scorer.py``); a row-parallel product sums its
  ranks' fp32 partials, a few ulps from one product;
* the bf16 scorer: 2e-2 of max|score| against JAX's bf16 scorer (the
  unsharded port in bf16 reads within it too: bf16 activations rounded at
  other points);
* gradients: atol 1e-6, rtol 1e-4 (the train step's bar against JAX,
  ``test_torch_train.py``);
* two gloo processes against ``Mesh.local``: ``torch.equal`` (a sum of two
  partials is the same in either order).
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu import configs as jconfigs
from mjvideo_tpu.data import prompts as jprompts
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.ops import lora as jlora
from mjvideo_tpu.ops import quant as jq
from mjvideo_tpu.parallel import mesh as jmesh
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.models import reward as treward
from mjvideo_tpu_torch.ops import quant as tq
from mjvideo_tpu_torch.ops.quant4 import dequantize_kernel_q4, quantize_kernel_q4
from mjvideo_tpu_torch.parallel import mesh as tmesh
from mjvideo_tpu_torch.parallel.mesh import Mesh
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils.bridge import flatten_state, from_jax_params

from test_torch_train import make_batch, to_torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
MIN_ELEMENTS = 1024  # tiny kernels are below the serving modes' 1 << 16
LR = 1e-3


def _cfg(pkg, kind="2b", **kw):
    """``pkg``'s tiny config: "2b" with an odd vocabulary (the 2B's 92,553
    rows stay whole under the guard), "phi3" the 4B's decoder (Hq = Hkv =
    4, the ``phi3-chat`` template, an even vocabulary that splits)."""
    if kind == "2b":
        return pkg.tiny_test_config(vocab_size=273, **kw)
    base = pkg.tiny_test_config(**kw)
    llm = dataclasses.replace(base.chat.llm, architecture="phi3",
                              num_key_value_heads=4, rope_theta=10000.0)
    return dataclasses.replace(base, chat=dataclasses.replace(
        base.chat, llm=llm, template="phi3-chat"))


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jreward.init_reward_params(key, cfg))(
            jax.random.PRNGKey(seed)))


def _jax_paths(tree):
    return [jmesh._path_str(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(tree)]


class _Sharding:
    """What JAX's functions read of a ``NamedSharding``: its spec."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


def _spec_leaves(tree):
    """{JAX path: spec} of a tree of ``_Sharding``s."""
    return {jmesh._path_str(p): s.spec for p, s in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture
def spec_mesh(monkeypatch):
    """JAX's sharding functions on a mesh of the given shape without
    devices: ``NamedSharding`` holds its spec only."""
    monkeypatch.setattr(jmesh, "NamedSharding", _Sharding)
    return lambda data, model: SimpleNamespace(
        shape={"data": data, "model": model})


@pytest.fixture(scope="module")
def tiny_params():
    return _jax_params(jconfigs.tiny_test_config())


# ------------------------------------------------------------ the rules

def test_tp_rules_equal_jax():
    assert [(p, tuple(s)) for p, s in jmesh.TP_RULES] == list(tmesh.TP_RULES)


def _tree_paths(kind, params):
    """(JAX path strings of a state, the port's paths of the same state or
    None where the port is not built): the full 2B and 4B by shapes alone,
    LoRA and ``int8-wo`` trees at tiny dims, bridged."""
    if kind in ("2b", "4b"):
        cfg = (jconfigs.mjvideo_2b_config() if kind == "2b"
               else jconfigs.mjvideo_4b_config())
        shapes = jax.eval_shape(lambda: jreward.init_reward_params(
            jax.random.PRNGKey(0), cfg))
        return _jax_paths(shapes), None
    if kind == "lora":
        tree = jax.jit(lambda p: jlora.apply_lora(
            p, jax.random.PRNGKey(1), 4))(params)
    else:
        tree = jax.jit(lambda p: jq.quantize_params_mode(
            p, "int8-wo", min_elements=MIN_ELEMENTS))(params)
    tree = jax.tree.map(np.asarray, tree)
    return _jax_paths(tree), list(flatten_state(from_jax_params(
        tree, device="cpu")))


@pytest.mark.parametrize("kind", ["2b", "4b", "lora", "int8-wo"])
def test_param_pspec_agrees_with_jax_on_every_path(kind, tiny_params):
    jpaths, tpaths = _tree_paths(kind, tiny_params)
    if tpaths is not None:
        assert tpaths == jpaths
    split = 0
    for path in jpaths:
        want = tuple(jmesh.param_pspec(path, True))
        assert tmesh.param_pspec(path, True) == want, path
        assert tmesh.param_pspec(path, False) == ()
        split += "model" in want
    assert split >= 7  # every Megatron member of the backbone


@pytest.mark.parametrize("model", [2, 3, 4])
def test_param_shardings_guard_agrees_with_jax(spec_mesh, model,
                                               tiny_params):
    params = tiny_params
    want = _spec_leaves(jmesh.param_shardings(params, spec_mesh(2, model)))
    got = tmesh.param_shardings(from_jax_params(params, device="cpu"),
                                Mesh.local(2, model))
    assert got == want


@pytest.mark.parametrize("optimizer,hidden", [("adamw", 64),
                                              ("adafactor", 128)])
def test_zero1_opt_shardings_agree_with_jax(spec_mesh, optimizer, hidden):
    """The param-shaped leaves of an AdamW and an Adafactor state (with the
    accumulator; at width 128 Adafactor factors the decoder's kernels, whose
    statistics stay replicated) take JAX's specs."""
    cfg = jconfigs.tiny_test_config(hidden_size=hidden)
    params = _jax_params(cfg)
    kw = dict(stage=3, optimizer=optimizer, gradient_accumulation_steps=2)
    jopt = jtrainer.make_optimizer(jtrainer.TrainConfig(**kw), params)
    jspecs = _spec_leaves(jmesh.zero1_opt_shardings(
        jopt.init(params), params, spec_mesh(2, 2)))
    jshapes = {jmesh._path_str(p): tuple(np.shape(x)) for p, x in
               jax.tree_util.tree_leaves_with_path(jopt.init(params))}
    state = from_jax_params(params, device="cpu")
    topt = ttrainer.make_optimizer(ttrainer.TrainConfig(**kw), state)
    tstate = topt.init(state)
    tspecs = tmesh.zero1_opt_shardings(tstate, state, Mesh.local(2, 2))
    flat = flatten_state(state)
    factored = split = 0
    for name, by_path in tstate.items():
        if not isinstance(by_path, dict):
            continue
        for p in by_path:
            got = tspecs[f"{name}/{p}"]
            shape = tuple(by_path[p].shape)
            want = {s for jp, s in jspecs.items()
                    if jp.endswith("/" + p) and jshapes[jp] == shape}
            assert want == {got}, (name, p, want, got)
            if shape != tuple(flat[p].shape):
                assert got == ()
                factored += 1
            split += "data" in got
    assert (factored > 0) == (optimizer == "adafactor")
    assert split > 0


def test_qkv_split_takes_each_ranks_heads():
    """A rank's piece of the packed ViT qkv holds its own heads of each of
    q, k and v (JAX's contiguous cut of 3C would not), the decoder's wq its
    contiguous query heads; ``join`` gives the whole back."""
    cfg = tconfigs.tiny_test_config()
    state = treward.init_reward_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    plan = tmesh.split_plan(state, 2, cfg)
    flat = flatten_state(state)
    C = cfg.chat.vision.hidden_size
    for name in ("kernel", "bias"):
        path = f"model/vision_model/layers/attn/qkv/{name}"
        whole = flat[path]
        assert plan[path].kind == "qkv"
        pieces = [tmesh.cut(whole, plan[path], j, 2) for j in (0, 1)]
        for j, piece in enumerate(pieces):
            assert piece.shape[-1] == 3 * C // 2
            for i in range(3):  # q, k, v
                want = whole[..., i * C + j * C // 2:i * C + (j + 1) * C // 2]
                got = piece[..., i * C // 2:(i + 1) * C // 2]
                assert torch.equal(got, want)
        assert torch.equal(tmesh.join(pieces, plan[path]), whole)
    wq = "model/language_model/layers/attention/wq/kernel"
    assert plan[wq].kind == "cols"
    n = flat[wq].shape[-1] // 2
    assert torch.equal(tmesh.cut(flat[wq], plan[wq], 1, 2),
                       flat[wq][..., n:])


def test_int4_row_member_is_repacked_per_rank():
    """An int4 row member's piece is rank j's logical rows, packed
    half-split on its own (its own lo and hi halves), with its groups'
    scales; ``join`` gives the packed bytes back."""
    w = torch.randn(2, 512, 48, generator=torch.Generator().manual_seed(0))
    k4 = quantize_kernel_q4(w, group_size=128)
    whole = dequantize_kernel_q4(k4)
    split = tmesh.Split("q4rows", 1)
    pieces = [tmesh.cut(k4.packed, split, j, 2) for j in (0, 1)]
    scales = [tmesh.cut(k4.scale, tmesh.Split("rows", 1), j, 2)
              for j in (0, 1)]
    for j in (0, 1):
        got = dequantize_kernel_q4(type(k4)(packed=pieces[j],
                                            scale=scales[j]))
        assert torch.equal(got, whole[:, j * 256:(j + 1) * 256])
        assert tq.is_k_major(pieces[j][0])
    assert torch.equal(tmesh.join(pieces, split), k4.packed)


def test_split_plan_guards_whole_pairs():
    """A pair splits only if every member divides, heads included: at 4
    ranks the decoder's 2 kv heads keep its attention whole (the MLP
    splits) and the vocabulary of 273 rows stays whole; at 3 only that
    vocabulary splits, at 5 nothing, and every rank holds the state as
    it is."""
    cfg = tconfigs.tiny_test_config(vocab_size=273)
    state = treward.init_reward_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    plan = tmesh.split_plan(state, 4, cfg)
    assert not any("attention/" in p for p in plan)
    assert any("feed_forward/w2" in p for p in plan)
    assert not any("tok_embeddings" in p for p in plan)
    assert list(tmesh.split_plan(state, 3, cfg)) == [
        "model/language_model/tok_embeddings"]
    assert tmesh.split_plan(state, 5, cfg) == {}
    shards = tmesh.shard_params(state, Mesh.local(1, 5), cfg=cfg)
    assert all(s is state for s in shards)


def test_make_mesh_in_one_process_is_local():
    mesh = tmesh.make_mesh()
    assert mesh.is_local and mesh.shape == {"data": 1, "model": 1}
    mesh = tmesh.make_mesh(data=2, model=2)
    assert mesh.is_local and list(mesh.model_ranks) == [0, 1]
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_batch({"x": np.zeros((3, 2))}, Mesh.local(2, 1))
    parts = tmesh.shard_batch({"x": np.arange(4)}, Mesh.local(2, 1))
    assert [p["x"].tolist() for p in parts] == [[0, 1], [2, 3]]


# -------------------------------------------------------------- forwards

def _forward_inputs(cfg, B=4, frames=1, seed=0):
    rng = np.random.default_rng(seed)
    c = cfg.chat
    n_img = c.num_image_token * frames
    T = n_img + 12
    ids = np.full((B, T), 5, np.int32)
    ids[:, 2:2 + n_img] = c.img_context_token_id
    ids[:, n_img + 3] = 270  # an id near the end of the vocabulary
    ids[-1, T - 3:] = c.llm.pad_token_id
    mask = (ids != c.llm.pad_token_id).astype(np.int32)
    pix = rng.normal(size=(B * frames, c.vision.image_size,
                           c.vision.image_size, 3)).astype(np.float32)
    return pix, ids, mask, np.full((B,), T - 6, np.int32)


@pytest.fixture(scope="module", params=["2b", "phi3"])
def forward_ref(request):
    jcfg, tcfg = _cfg(jconfigs, request.param), _cfg(tconfigs, request.param)
    params = _jax_params(jcfg, seed=3)
    inputs = _forward_inputs(jcfg)
    ref = jax.jit(lambda p, *a: jreward.reward_forward(
        p, jcfg, *a, attn_impl="xla"))(params, *map(jnp.asarray, inputs))
    return tcfg, from_jax_params(params, device="cpu"), inputs, ref


@pytest.mark.parametrize("data,model", [(4, 1), (1, 2), (2, 2)])
def test_meshed_reward_forward_matches_jax(forward_ref, data, model):
    """DP, TP and DP x TP: each data shard's rows through the held model
    ranks' trees, against JAX's unsharded forward in every field."""
    cfg, state, (pix, ids, mask, gpos), ref = forward_ref
    mesh = Mesh.local(data, model)
    shards = tmesh.shard_params(state, mesh, cfg=cfg)
    if model > 1:
        assert len(shards) == model and shards[0] is not shards[1]
    parts = tmesh.shard_batch({"pix": pix, "ids": ids, "mask": mask,
                               "gpos": gpos}, mesh)
    with torch.no_grad():
        outs = [treward.reward_forward(
            shards, cfg, *(torch.from_numpy(p[k]) for k in
                           ("pix", "ids", "mask", "gpos")), mesh=mesh)
            for p in parts]
    for i, name in enumerate(ref._fields):
        got = torch.cat([o[i] for o in outs]).numpy()
        np.testing.assert_allclose(got, np.asarray(ref[i]), err_msg=name,
                                   **TOL)


# --------------------------------------------------------------- scoring

def _clips(cfg, tok, rng, n=4):
    ids, gpos, frames = [], [], []
    for i in range(n):
        k = 1 + i % 2
        chat = jprompts.prepare_chat_input(
            cfg.chat, tok, jprompts.build_video_question("a dog" * (i + 1), k),
            num_patches_list=[1] * k, gating_pattern=tok.gating_pattern())
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
        frames.append(k)
    size = cfg.chat.image_size
    pix = rng.normal(size=(sum(frames), size, size, 3)).astype(np.float32)
    return pix, ids, gpos


@pytest.mark.parametrize("mode", [None, "int8-wo", "int4-wo"])
def test_meshed_scorer_matches_jax_scorer(mode):
    """``RewardScorer(mesh=local(2, 2))`` against JAX's unsharded scorer on
    the same tree: bf16 weights and pixels, or a weight-only tree (fp32;
    ``int4-wo`` at width 128, where the ViT MLP's int4 row member holds
    whole groups on each rank and splits); 4 clips in micro-batches of 1
    clip per data shard."""
    hidden = 128 if mode == "int4-wo" else 64
    jcfg = jconfigs.tiny_test_config(hidden_size=hidden)
    params = _jax_params(jcfg, seed=1)
    tok = jprompts.ByteTokenizer()
    if mode is None:
        jtree = jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16), params)
        jdtype, tdtype = jnp.bfloat16, torch.bfloat16
    else:
        jtree = jax.tree.map(np.asarray, jq.quantize_params_mode(
            params, mode, min_elements=MIN_ELEMENTS))
        jdtype, tdtype = jnp.float32, torch.float32
    common = dict(length_buckets=(512,), gating_pattern=tok.gating_pattern(),
                  quant=mode)
    ref_scorer = JaxRewardScorer(jcfg, jtree, tok, attn_impl="xla",
                                 dtype=jdtype, **common)
    mesh = Mesh.local(2, 2)
    tcfg = tconfigs.tiny_test_config(hidden_size=hidden)
    port = RewardScorer(tcfg, from_jax_params(jtree, device="cpu"), tok,
                        dtype=tdtype, device_batch=1, mesh=mesh, **common)
    plan = tmesh.split_plan(from_jax_params(jtree, device="cpu"), 2, tcfg)
    if mode == "int4-wo":
        assert any(p.endswith("fc2/kernel/.packed") for p in plan)
    pix, ids, gpos = _clips(port.cfg, tok, np.random.default_rng(0))
    ref = ref_scorer.score_batch(pix, ids, gpos)
    got = port.score_batch(pix, ids, gpos)
    if mode is None:
        want = np.asarray(ref.score, np.float32)
        err = np.abs(got.score.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err
        return
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_w8a8_under_tp_raises_and_outliers_follow_the_batch():
    """w8a8 under a model axis raises naming ROADMAP item 12; ``-olN``
    under ``local(2, 1)`` picks the channels of the whole micro-batch (the
    shards run in one forward), bit-equal to the unsharded scorer."""
    cfg = tconfigs.tiny_test_config()
    state = treward.init_reward_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    tok = jprompts.ByteTokenizer()
    common = dict(length_buckets=(512,), gating_pattern=tok.gating_pattern(),
                  dtype=torch.float32)
    tree = tq.quantize_params_mode(state, "int8", min_elements=MIN_ELEMENTS)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        RewardScorer(cfg, tree, tok, mesh=Mesh.local(1, 2), **common)
    tree = tq.quantize_params_mode(state, "int8-ol8",
                                   min_elements=MIN_ELEMENTS)
    one = RewardScorer(cfg, tree, tok, **common)
    meshed = RewardScorer(cfg, tree, tok, mesh=Mesh.local(2, 1), **common)
    pix, ids, gpos = _clips(one.cfg, tok, np.random.default_rng(1))
    assert torch.equal(meshed.score_batch(pix, ids, gpos).score,
                       one.score_batch(pix, ids, gpos).score)
    with pytest.raises(ValueError, match="data axis"):
        meshed.score_batch(pix[:1], ids[:1], gpos[:1])


# --------------------------------------------------------- unequal shards

@pytest.mark.parametrize("stage", [2, 3])
def test_unequal_shards_step_matches_jax(stage):
    """A stage-2 and a stage-3 step at ``local(2, 1)`` where the second
    shard's preference masks and aspect relations are all 0: the losses
    divide by the whole batch's counts, as JAX's global step does."""
    jcfg, tcfg = jconfigs.tiny_test_config(), tconfigs.tiny_test_config()
    params = _jax_params(jcfg)
    batch = make_batch(jcfg, B=2, seed=stage)
    for k in ("aspect_mask", "overall_mask", "video_0_aspect_related",
              "video_1_aspect_related"):
        batch[k][1] = 0
    kw = dict(stage=stage, learning_rate=LR, total_steps=4,
              gradient_accumulation_steps=2)
    tc_j = jtrainer.TrainConfig(attn_impl="xla", **kw)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(
        jcfg, tc_j)))(jax.tree.map(jnp.asarray, params),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    want = flatten_state(from_jax_params(jax.tree.map(np.asarray, jgrads),
                                         device="cpu"))
    tc = ttrainer.TrainConfig(**kw, checkpoint_dir="unused")
    tr = ttrainer.Trainer(tcfg, from_jax_params(params, device="cpu"), tc,
                          mesh=Mesh.local(2, 1))
    _, state, metrics = tr.step_fn(tr.params, tr.opt_state,
                                   to_torch(batch))
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                               rtol=1e-5)
    for path, g in tr.optimizer.gather_state(state)["acc"].items():
        np.testing.assert_allclose(g.numpy(), want[path].numpy(),
                                   err_msg=path, **GRAD_TOL)


# ------------------------------------------- processes against local form

WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from mjvideo_tpu_torch.configs import tiny_test_config
from mjvideo_tpu_torch.data.prompts import ByteTokenizer
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.models.reward import init_reward_params
from mjvideo_tpu_torch.ops.quant import quantize_params_mode
from mjvideo_tpu_torch.parallel import maybe_initialize
from mjvideo_tpu_torch.parallel.mesh import Mesh
from mjvideo_tpu_torch.train.trainer import TrainConfig, Trainer
import torch.distributed as dist

out_dir, data, model = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert maybe_initialize(device="cpu")
mesh = Mesh.distributed(data, model)
inp = dict(np.load(f"{out_dir}/inputs.npz", allow_pickle=True))
cfg = tiny_test_config()
state = init_reward_params(cfg, generator=torch.Generator().manual_seed(0),
                           device=torch.device("cpu"), dtype=torch.float32)
tok = ByteTokenizer()
common = dict(length_buckets=(512,), gating_pattern=tok.gating_pattern(),
              dtype=torch.float32, mesh=mesh)
ids = [inp[f"ids{i}"] for i in range(4)]
res = {}
res["score"] = RewardScorer(cfg, state, tok, **common).score_batch(
    inp["pix"], ids, list(inp["gpos"])).score.numpy()
if model == 1:
    tree = quantize_params_mode(state, "int8-ol8", min_elements=1024)
    res["ol_score"] = RewardScorer(cfg, tree, tok, **common).score_batch(
        inp["pix"], ids, list(inp["gpos"])).score.numpy()
batch = {k[6:]: torch.from_numpy(v) for k, v in inp.items()
         if k.startswith("batch/")}
tc = TrainConfig(stage=3, gradient_accumulation_steps=2,
                 checkpoint_dir=out_dir + "/ckpt")
tr = Trainer(cfg, state, tc, mesh=mesh)
_, opt_state, metrics = tr.step_fn(tr.params, tr.opt_state, batch)
res["loss"] = metrics["loss"].numpy()
res["grad_norm"] = metrics["grad_norm"].numpy()
for path, acc in tr.optimizer.gather_state(opt_state)["acc"].items():
    res["grad/" + path] = acc.numpy()
if dist.get_rank() == 0:
    np.savez(f"{out_dir}/rank0.npz", **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_gloo_processes_equal_the_local_mesh(tmp_path, data, model):
    """Two processes over gloo (``Mesh.distributed``, joined through
    ``maybe_initialize`` with the launcher's variables) against
    ``Mesh.local`` in this process, bit for bit: the scorer's scores (and
    at (2, 1) an ``-ol8`` tree's, its column amax max-reduced over the data
    axis) and one stage-3 micro-step's loss, grad norm and gradients.  A
    missing ``copy_to_model`` leaves the replicated leaves' gradients at
    one rank's share."""
    cfg = tconfigs.tiny_test_config()
    tok = jprompts.ByteTokenizer()
    pix, ids, gpos = _clips(cfg, tok, np.random.default_rng(2))
    batch = make_batch(cfg, B=2, seed=5)
    np.savez(tmp_path / "inputs.npz", pix=pix, gpos=np.asarray(gpos),
             **{f"ids{i}": a for i, a in enumerate(ids)},
             **{f"batch/{k}": v for k, v in batch.items()})
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path), str(data), str(model)],
        cwd=REPO, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    logs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err
    got = dict(np.load(tmp_path / "rank0.npz"))

    mesh = Mesh.local(data, model)
    state = treward.init_reward_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)
    common = dict(length_buckets=(512,), gating_pattern=tok.gating_pattern(),
                  dtype=torch.float32, mesh=mesh)
    want = {"score": RewardScorer(cfg, state, tok, **common).score_batch(
        pix, ids, gpos).score.numpy()}
    if model == 1:
        tree = tq.quantize_params_mode(state, "int8-ol8",
                                       min_elements=MIN_ELEMENTS)
        want["ol_score"] = RewardScorer(cfg, tree, tok, **common).score_batch(
            pix, ids, gpos).score.numpy()
    tc = ttrainer.TrainConfig(stage=3, gradient_accumulation_steps=2,
                              checkpoint_dir=str(tmp_path / "local"))
    tr = ttrainer.Trainer(cfg, state, tc, mesh=mesh)
    _, opt_state, metrics = tr.step_fn(tr.params, tr.opt_state,
                                       to_torch(batch))
    want["loss"] = metrics["loss"].numpy()
    want["grad_norm"] = metrics["grad_norm"].numpy()
    for path, acc in tr.optimizer.gather_state(opt_state)["acc"].items():
        want["grad/" + path] = acc.numpy()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ----------------------------------------------------------------- dryrun

@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_the_cpu(n):
    """The dry run's four phases over ``Mesh.local(n // 2, 2)``; phase 4 at
    512 tokens here (the plain ring attention is quadratic in them; the
    card runs JAX's 4,096)."""
    from mjvideo_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(n, device="cpu", train_seq=512)
    assert out["mesh"] == {"data": n // 2, "model": 2}
    assert out["kernels_zero1"]["split_moment_leaves"] > 0
    assert out["ring_train"]["split_moment_leaves"] > 0
    assert out["ring_forward"]["tiles"] == 208
    for phase in ("step", "kernels_zero1", "ring_train"):
        assert np.isfinite(out[phase]["loss"])
