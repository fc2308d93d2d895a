"""LoRA and QLoRA training under a model axis (``parallel/mesh.py``'s
``split_plan`` of LoRA nodes, ``ops/lora.py``'s row product over the model
axis, the trainer's model-axis sum of a column member's adapter gradient)
against JAX's LoRA ``Trainer`` and the port's unsharded one.

JAX applies LoRA, then shards the state over any mesh, and GSPMD keeps the
unsharded semantics, so the oracle of a meshed run is the unsharded run.
``tiny_test_config`` in fp32 on the CPU, stage 3, batches of 2 pairs (the
data axis of 2 divides them), LoRA rank 2 from a nonzero ``b`` (every
adapter has a gradient).  Tolerances, each with its reason:

* against the unsharded port and against JAX: ``test_torch_lora.py``'s
  rule (atol 2e-6, 2 bf16 ulps for bf16 adapters; an element may be off
  that by at most 2 lr where Adam's first step divides a gradient near
  eps, on under 1% of a leaf): a row-parallel product sums its ranks'
  partials in another order, an ulp that Adam's first step can magnify
  at such an element;
* merged kernels: atol 1e-5 (such an element of ``a``, times ``scale b``);
* ZeRO-1 against the replicated run, a save and resume, and a resume into
  another mesh: ``torch.equal``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config as jax_tiny
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.parallel import mesh as jmesh
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch.configs import tiny_test_config
from mjvideo_tpu_torch.ops import lora as tlora
from mjvideo_tpu_torch.ops.quant4 import Q4Kernel
from mjvideo_tpu_torch.parallel import mesh as tmesh
from mjvideo_tpu_torch.parallel.mesh import Mesh
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils.bridge import (
    flatten_state,
    from_jax_params,
    map_state,
)

from test_torch_lora import LR, RANK, _close_update, lora_tree
from test_torch_train import make_batch

torch.set_num_threads(1)
STEPS = 2
# (data, model, zero1); ZeRO-1 acts only where the data axis is above 1.
MESHES = [(1, 2, False), (2, 2, False), (2, 2, True)]


@pytest.fixture(scope="module")
def setup():
    cfg = jax_tiny()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jreward.init_reward_params(key, cfg))(
            jax.random.PRNGKey(0)))
    batches = [make_batch(cfg, B=2, seed=10 + s) for s in range(STEPS + 1)]
    return cfg, params, batches


def _tc(pkg, tmp, **kw):
    base = dict(stage=3, learning_rate=LR, total_steps=4, remat=False,
                lora_rank=RANK, gradient_accumulation_steps=1, log_every=1,
                checkpoint_every=10**9, checkpoint_dir=str(tmp))
    return pkg.TrainConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_run(setup, tmp_path_factory):
    """JAX's LoRA ``Trainer`` over STEPS batches from the bridged tree (its
    ``b`` moved), unsharded: (the tree, the params after)."""
    cfg, params, batches = setup
    tree = lora_tree(params)
    tc = _tc(jtrainer, tmp_path_factory.mktemp("jax"), attn_impl="xla",
             mesh_data_axis=1)
    tr = jtrainer.Trainer(cfg, jax.tree.map(jnp.asarray, tree), tc)
    tr.train(batches[:STEPS], max_steps=STEPS)
    return tree, jax.tree.map(np.asarray, jax.device_get(tr.params))


def _port(tree, tc, mesh, batches, steps=STEPS):
    tr = ttrainer.Trainer(tiny_test_config(), from_jax_params(
        tree, device="cpu"), tc, mesh=mesh)
    tr.train(batches[:steps])
    return tr


@pytest.fixture(scope="module")
def unsharded(setup, jax_run, tmp_path_factory):
    _, _, batches = setup
    return _port(jax_run[0], _tc(ttrainer, tmp_path_factory.mktemp("one")),
                 None, batches)


def _close(got, want):
    """``got`` within ``_close_update``'s rule of ``want``."""
    _close_update(got, want.detach(), want.detach())


def _equal(a, b):
    fa, fb = flatten_state(a), flatten_state(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if torch.is_tensor(v):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


# ---------------------------------------------------------------- layout

def test_lora_layout_departs_from_jax_specs_on_two_adapters(setup):
    """Every field of the 7 LoRA nodes at ``model = 2``: ``w`` splits as
    its member, a row member's ``a`` by its rows (K) and a column member's
    ``b`` by its columns, as JAX's specs cut them; JAX's rules would also
    cut a column member's ``a`` and a row member's ``b`` along r
    (``P(None, None, "model")`` on (L, K, r), ``P(None, "model", None)``
    on (L, r, N)), which the port keeps whole (the module docstring of
    ``parallel/mesh.py``); ``scale`` whole."""
    _, params, _ = setup
    tree = from_jax_params(lora_tree(params), device="cpu")
    plan = tmesh.split_plan(tree, 2, tiny_test_config())
    nodes = [p[:-len("/.a")] for p in flatten_state(tree) if p.endswith("/.a")]
    assert len(nodes) == 7
    departures = 0
    for node in nodes:
        row = node.endswith(("wo/kernel", "w2/kernel"))
        for field in (".w", ".a", ".b", ".scale"):
            path = f"{node}/{field}"
            jspec = tuple(jmesh.param_pspec(path, True))
            got = plan.get(path)
            if field == ".w":
                assert got.kind == ("rows" if row else "cols"), path
                assert jspec.index("model") == got.dim, path
            elif field == ".a" and row or field == ".b" and not row:
                assert got is not None and got.dim == jspec.index("model")
            elif field != ".scale":
                assert got is None and jspec.index("model") == (
                    1 if row else 2), path  # JAX's cut along r
                departures += 1
            else:
                assert got is None, path
    assert departures == 7
    assert tmesh.model_summed(plan) == sorted(
        f"{n}/.a" for n in nodes if not n.endswith(("wo/kernel", "w2/kernel")))


# ------------------------------------------------------------ training

@pytest.mark.parametrize("data,model,zero1", MESHES)
def test_meshed_lora_trainer_matches_jax_and_unsharded(setup, jax_run,
                                                       unsharded, tmp_path,
                                                       data, model, zero1):
    """STEPS LoRA steps at ``local(data, 2)`` (ZeRO-1 slicing the adapters'
    moments over the data axis): every tensor against the unsharded port
    and against JAX's ``Trainer`` (the module's rule), the frozen ones
    bit-equal, both adapters of every node moved."""
    _, _, batches = setup
    tree, jp = jax_run
    tr = _port(tree, _tc(ttrainer, tmp_path, zero1=zero1), Mesh.local(data,
                                                                      model),
               batches)
    assert any(k.endswith("/.a#m1") for k in tr.optimizer.keys)
    if zero1:
        assert any("#d1" in s and "/.b" in s for s in tr.opt_state["mu"])
    got = flatten_state(tr.whole_params())
    want = flatten_state(unsharded.params)
    jwant = flatten_state(from_jax_params(jp, device="cpu"))
    before = flatten_state(from_jax_params(tree, device="cpu"))
    trained = set(tr.optimizer.paths)
    moved = set()
    assert got.keys() == want.keys()
    for path, t in got.items():
        _close(t, want[path])
        if path in trained:
            if _close_update(t, jwant[path], before[path]):
                moved.add(path)
        else:
            assert torch.equal(t, before[path]), path
    assert sum(p.endswith(("/.a", "/.b")) for p in moved) == 14


def test_zero1_lora_is_bit_equal_to_the_replicated_run(setup, jax_run,
                                                       tmp_path):
    """ZeRO-1 over the adapters at ``local(2, 2)``: the parameters and the
    whole optimizer state bit-equal to the replicated run's."""
    _, _, batches = setup
    runs = [_port(jax_run[0], _tc(ttrainer, tmp_path / str(z), zero1=z),
                  Mesh.local(2, 2), batches) for z in (False, True)]
    _equal(runs[1].whole_params(), runs[0].whole_params())
    _equal(runs[1].whole_opt_state(), runs[0].whole_opt_state())


@pytest.mark.parametrize("base", ["int8-wo", "int4-wo"])
def test_qlora_over_a_model_axis_matches_unsharded(setup, tmp_path, base):
    """QLoRA at ``local(1, 2)`` from a nonzero ``b``: the frozen quantized
    base splits with its LoRA node (an int4 base at group 32, whose MLP
    row member holds whole groups in each half of each rank's rows,
    repacked per rank), and two steps equal the unsharded QLoRA run's by
    the module's rule (an int4 base's adapters are bf16)."""
    from mjvideo_tpu_torch.ops.quant import quantize_params_int8
    from mjvideo_tpu_torch.ops.quant4 import quantize_params_int4

    _, params, batches = setup
    state = from_jax_params(params, device="cpu")
    qtree = (quantize_params_int8(state, min_elements=1024, weight_only=True)
             if base == "int8-wo" else
             quantize_params_int4(state, min_elements=1024, group_size=32))
    qtree = tlora.apply_lora(qtree, torch.Generator().manual_seed(4), RANK)
    g = torch.Generator().manual_seed(5)
    for path, b in flatten_state(qtree).items():
        if path.endswith("/.b"):
            b.copy_(0.05 * torch.randn(b.shape, generator=g))
    runs = []
    for mesh in (None, Mesh.local(1, 2)):
        tr = ttrainer.Trainer(tiny_test_config(), map_state(
            torch.clone, qtree), _tc(
            ttrainer, tmp_path / str(mesh), gradient_accumulation_steps=2),
            mesh=mesh)
        tr.train(batches[:STEPS])
        runs.append(tr)
    field = ".w/.packed" if base == "int4-wo" else ".w/.qw"
    assert any(p.endswith("w2/kernel/" + field) for p in runs[1].plan)
    got, want = flatten_state(runs[1].whole_params()), flatten_state(
        runs[0].params)
    assert got.keys() == want.keys()
    for path, t in got.items():
        _close(t, want[path])
    node = runs[1].params[1]["model"]["language_model"]["layers"][
        "feed_forward"]["w2"]["kernel"]
    if base == "int4-wo":
        assert isinstance(node.w, Q4Kernel)


def test_lora_save_at_2x2_resumes_elsewhere(setup, jax_run, tmp_path):
    """A ZeRO-1 LoRA run at ``local(2, 2)`` saved in the middle of an
    accumulation window: resumed on ``local(2, 2)`` its next micro-step is
    bit-equal to the unbroken run's, and an unsharded ``Trainer`` and one
    on ``local(1, 2)`` resume the file into the same whole state."""
    _, _, batches = setup
    tc = _tc(ttrainer, tmp_path, zero1=True, gradient_accumulation_steps=2)
    mesh = Mesh.local(2, 2)
    whole = _port(jax_run[0], tc, mesh, batches, steps=1)
    path = whole.save()
    whole.train(batches[1:2])
    back = _port(jax_run[0], tc, mesh, batches, steps=0)
    assert back.resume_latest() == path and back.step == 1
    back.train(batches[1:2])
    _equal(back.whole_params(), whole.whole_params())
    _equal(back.whole_opt_state(), whole.whole_opt_state())
    saved = ttrainer.load_state(path)
    for other in (None, Mesh.local(1, 2)):
        tr = _port(jax_run[0], tc, other, batches, steps=0)
        tr.resume_latest()
        _equal(tr.whole_params(), saved["params"])
        _equal(tr.whole_opt_state(), saved["opt_state"])


def test_merge_lora_of_the_gathered_state_equals_the_unsharded_merge(
        setup, jax_run, unsharded, tmp_path):
    """``merge_lora(whole_params())`` of the run at ``local(2, 2)`` against
    the unsharded run's merge: atol 1e-5, and bit-equal on the state before
    training (``gather_params`` of the cut tree is the tree)."""
    _, _, batches = setup
    tr = _port(jax_run[0], _tc(ttrainer, tmp_path), Mesh.local(2, 2),
               batches)
    got = flatten_state(tlora.merge_lora(tr.whole_params()))
    want = flatten_state(tlora.merge_lora(unsharded.params))
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[path].detach().numpy(), atol=1e-5,
                                   err_msg=path)
    fresh = _port(jax_run[0], _tc(ttrainer, tmp_path / "fresh"),
                  Mesh.local(2, 2), batches, steps=0)
    _equal(tlora.merge_lora(fresh.whole_params()), tlora.merge_lora(
        from_jax_params(jax_run[0], device="cpu")))


def test_lora_row_product_adds_the_adapter_once():
    """A LoRA row member over 2 ranks (``dot_lora_rows_over_model``): the
    base's row product and ``x @ a`` summed over the ranks, ``@ b`` added
    once, within 1e-6 of max|unsharded| of ``dot_lora_f32``; ``b``'s
    gradient whole (not a rank's share)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 64, generator=g)
    w = torch.randn(64, 24, generator=g)
    a = torch.randn(64, 3, generator=g, requires_grad=True)
    b = torch.randn(3, 24, generator=g, requires_grad=True)
    node = tlora.LoraKernel(w, a, b, torch.tensor(2.0))
    want = tlora.dot_lora_f32(x, node)
    (ga, gb) = torch.autograd.grad(want.sum(), (a, b))
    split = tmesh.Split("rows", 0)
    pieces = [tlora.LoraKernel(tmesh.cut(w, split, j, 2), a[j * 32:(j + 1)
                                                            * 32], b,
                               node.scale) for j in (0, 1)]
    got = tmesh.row_dot_over_model(Mesh.local(1, 2), list(x.split(32, -1)),
                                   pieces)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    (ga2, gb2) = torch.autograd.grad(got.sum(), (a, b))
    assert torch.allclose(gb2, gb, rtol=1e-6, atol=1e-6)
    assert torch.allclose(ga2, ga, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    from mjvideo_tpu_torch.examples import make_sample_data

    root = tmp_path_factory.mktemp("tp_lora_cli")
    (root / "videos").mkdir()
    rng = np.random.default_rng(2)
    records = [make_sample_data.make_record(rng, i, str(root / "videos"))
               for i in range(2)]
    (root / "pairs.json").write_text(json.dumps(records))
    return root


def test_train_cli_trains_lora_under_tp(sample, tmp_path):
    """``--tp 2 --lora-rank 4``: the CLI trains the adapters on
    ``Mesh.local(1, 2)`` and writes the whole state, its LoRA nodes
    whole."""
    from mjvideo_tpu_torch.train import cli as tcli
    from mjvideo_tpu_torch.utils.checkpoint import load_state

    out = tmp_path / "s1"
    tcli.main(["--stage", "1", "--tiny", "--fp32", "--device", "cpu",
               "--train-json", str(sample / "pairs.json"),
               "--video-root", str(sample / "videos"), "--output-dir",
               str(out), "--batch-size", "1", "--num-segments", "2",
               "--max-length", "512", "--max-steps", "1",
               "--gradient-accumulation-steps", "1", "--warmup-steps", "0",
               "--lora-rank", "4", "--tp", "2"])
    saved = load_state(str(out / "stage1_step1.pt"))["params"]
    nodes = {p: n for p, n in flatten_state(saved).items()
             if p.endswith("/.b")}
    assert len(nodes) == 7 and any(n.any() for n in nodes.values())
    cfg = tiny_test_config()
    wq = flatten_state(saved)[
        "model/language_model/layers/attention/wq/kernel/.b"]
    assert wq.shape[-1] == cfg.chat.llm.num_attention_heads * \
        cfg.chat.llm.head_dim
