"""LoRA and QLoRA training in the port (``ops/lora.py``, the trainer's LoRA
mode, the train CLI's ``--lora-rank``) and the saving and restoring of
states that hold LoRA or quantized nodes, against the JAX package.

``tiny_test_config`` in fp32 on the CPU; JAX's LoRA trees cross through
``from_jax_params`` (the port cannot draw JAX's threefry adapters), JAX
runs ``attn_impl="xla"``, the port its default (the kernels' plain twins
on the CPU).  Tolerances, each with its reason:

* ``dot`` on a LoRA node: fp32 atol 1e-5 (the same fp32 formula summed in
  other orders); bf16 2^-7 of max|JAX| (one bf16 rounding of the output);
  with ``b = 0`` bit-equal to the base product;
* ``reward_forward``: atol 2e-5, rtol 1e-5, the model parity tests' bar
  (``tests/test_torch_models.py``);
* one trainer step: loss and grad_norm rtol 1e-4 (grad_norm 1e-3 over an
  int4 base, whose bf16 adapters take bf16 gradients); the fp32 adapters and
  heads after the step atol 2e-6 = 2e-3 lr, bf16 adapters (an int4
  base's, whose scales are bf16) 2 bf16 ulps of the value; under 1% of the
  elements may be off that by at most 2 lr: Adam's first step is lr g /
  (|g| + eps), so an element whose gradient is near eps may move by up to
  2 lr (``tests/test_torch_train.py``);
* ``merge_lora``: atol 1e-6 (fp32 ``w + s a b``).
"""

import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.ops import lora as jlora
from mjvideo_tpu.ops import matmul as jmatmul
from mjvideo_tpu.ops import quant as jquant
from mjvideo_tpu.ops import quant4 as jquant4
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch.models import reward as treward
from mjvideo_tpu_torch.ops import lora as tlora
from mjvideo_tpu_torch.ops import matmul as tmatmul
from mjvideo_tpu_torch.ops import quant as tquant
from mjvideo_tpu_torch.ops.quant import map_with_path
from mjvideo_tpu_torch.ops.quant4 import Q4Kernel
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils import checkpoint as tckpt
from mjvideo_tpu_torch.utils.bridge import from_jax_params, map_state

from test_torch_train import make_batch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
RANK = 2
MIN_ELEMENTS = 1024  # tiny_test_config's kernels sit below the 1 << 16 floor
BASES = ("plain", "int8-wo", "int4-wo")


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    params = jax.jit(lambda key: jreward.init_reward_params(key, cfg))(
        jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


# JAX's quantizers and apply_lora, jitted (op by op they take 3-12 s here);
# each tree is made once a worker (the module's ``setup`` params are the
# only ones used).  Both packages then read the same tree.
_TREES = {}


def quantized(params, base):
    """JAX's tree with the base ``base``: as it is, weight-only int8 or
    int4 (every kernel the quantizers take at MIN_ELEMENTS), as numpy."""
    if base == "plain":
        return params
    if ("q", base) not in _TREES:
        q = jax.jit(lambda p: jquant.quantize_params_int8(
            p, min_elements=MIN_ELEMENTS, weight_only=True)
            if base == "int8-wo" else jquant4.quantize_params_int4(
                p, min_elements=MIN_ELEMENTS))(params)
        _TREES["q", base] = jax.tree.map(np.asarray, q)
    return _TREES["q", base]


def is_jlora(n):
    return isinstance(n, jlora.LoraKernel)


def moved(tree, seed=5, size=0.05):
    """``tree`` with every LoRA node's ``b`` drawn nonzero (numpy seeded),
    so that ``a`` has a gradient and the delta moves the forward."""
    rng = np.random.default_rng(seed)

    def one(n):
        if not is_jlora(n):
            return n
        b = (size * rng.normal(size=n.b.shape)).astype(np.float32)
        return jlora.LoraKernel(n.w, n.a, jnp.asarray(b, n.b.dtype), n.scale)

    return jax.tree.map(one, tree, is_leaf=is_jlora)


def lora_tree(params, base="plain"):
    """JAX's tree with ``base``, wrapped (rank RANK) and its ``b`` moved,
    as numpy."""
    if ("lora", base) not in _TREES:
        wrapped = jax.jit(lambda p: jlora.apply_lora(
            p, jax.random.PRNGKey(4), rank=RANK))(quantized(params, base))
        _TREES["lora", base] = jax.tree.map(np.asarray, moved(wrapped))
    return _TREES["lora", base]


def kind(x):
    """A kernel's class name in either package, "array" for a plain one."""
    name = type(x).__name__
    return name if name.endswith("Kernel") else "array"


def jax_lora_paths(tree):
    return {jtrainer._path_str(p): n for p, n in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_jlora)
            if is_jlora(n)}


def port_lora_paths(state):
    out = {}

    def one(path, leaf):
        if isinstance(leaf, tlora.LoraKernel):
            out[path] = leaf
        return leaf

    map_with_path(one, state)
    return out


# --------------------------------------------------------------- products

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_with_a_lora_kernel_matches_jax(dtype):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 24)).astype(np.float32)
    a = (0.3 * rng.normal(size=(16, 4))).astype(np.float32)
    b = (0.3 * rng.normal(size=(4, 24))).astype(np.float32)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jlk = jlora.LoraKernel(w=jnp.asarray(w, jdt), a=jnp.asarray(a, jdt),
                           b=jnp.asarray(b, jdt),
                           scale=jnp.asarray(2.0, jnp.float32))
    tlk = from_jax_params({"k": jlk}, device="cpu")["k"]
    assert isinstance(tlk, tlora.LoraKernel) and tlk.a.dtype == tdt
    xt = torch.from_numpy(x).to(tdt)
    for jfn, tfn in ((jmatmul.dot, tmatmul.dot),
                     (jmatmul.dot_f32, tmatmul.dot_f32)):
        want = np.asarray(jfn(jnp.asarray(x, jdt), jlk), np.float32)
        got = tfn(xt, tlk)
        assert got.dtype == (tdt if tfn is tmatmul.dot else torch.float32)
        tol = 1e-5 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
        # b = 0: the base product to the bit.
        zero = tlora.LoraKernel(tlk.w, tlk.a, torch.zeros_like(tlk.b),
                                tlk.scale)
        assert torch.equal(tfn(xt, zero), tfn(xt, tlk.w))
    # A stacked node slices through map_state, its scale with the layers.
    stacked = tlora.LoraKernel(*(torch.stack([t, t]) for t in (
        tlk.w, tlk.a, tlk.b)), scale=torch.full((2,), 2.0))
    one = map_state(lambda t: t[1], stacked)
    assert one.scale.shape == () and torch.equal(tmatmul.dot(xt, one),
                                                 tmatmul.dot(xt, tlk))


@pytest.mark.parametrize("base", BASES)
def test_apply_lora_wraps_the_paths_and_shapes_jax_wraps(setup, base):
    _, params = setup
    jtree = quantized(params, base)
    want = jax_lora_paths(lora_tree(params, base))
    state = from_jax_params(jtree, device="cpu")
    wrapped = tlora.apply_lora(state, torch.Generator().manual_seed(3), RANK)
    got = port_lora_paths(wrapped)
    assert sorted(got) == sorted(want) and len(got) == 7
    for path, lk in got.items():
        ref = want[path]
        for name in ("a", "b", "scale"):
            t, r = getattr(lk, name), np.asarray(getattr(ref, name))
            assert tuple(t.shape) == r.shape, (path, name)
            assert str(t.dtype).split(".")[-1] == r.dtype.name, (path, name)
        assert kind(lk.w) == kind(ref.w)
        # The nodes' logical shape and dtype, as JAX's properties give them
        # (an int4 base's K counts two rows a byte).
        for t, r in ((lk, ref), (lk.w, ref.w)):
            assert tuple(t.shape) == tuple(r.shape) and t.ndim == r.ndim
            assert str(t.dtype).split(".")[-1] == np.dtype(r.dtype).name
        assert not lk.b.any() and torch.all(lk.scale == 1.0)
        node = state
        for key in path.split("/"):
            node = node[key]
        assert lk.w is node  # the base is shared, not copied
        a = lk.a.float()
        assert abs(a.std().item() - RANK ** -0.5) < 0.25, path  # N(0, 1/r)
    # A second call changes nothing.
    again = tlora.apply_lora(wrapped, torch.Generator().manual_seed(9), RANK)
    for path, lk in port_lora_paths(again).items():
        assert lk is got[path]
    scaled = port_lora_paths(tlora.apply_lora(
        state, torch.Generator().manual_seed(3), 4, alpha=8.0))
    assert all(torch.all(lk.scale == 2.0) for lk in scaled.values())


def _forward_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    c = cfg.chat
    T = 2 + 2 * c.num_image_token + 8
    pix = rng.normal(size=(2, c.vision.image_size, c.vision.image_size,
                           3)).astype(np.float32)
    ids = np.full((1, T), 5, np.int32)
    ids[:, 2:2 + 2 * c.num_image_token] = c.img_context_token_id
    return pix, ids, np.ones((1, T), np.int32), np.asarray([T - 4], np.int32)


def test_reward_forward_on_a_bridged_lora_tree_matches_jax(setup):
    """JAX's LoRA tree with a nonzero ``b``, bridged, in every output
    field; the port's wrapped forward at ``b = 0`` is its base forward to
    the bit."""
    cfg, params = setup
    tree = lora_tree(params)
    inputs = _forward_inputs(cfg)
    ref = jax.jit(lambda p, *a: jreward.reward_forward(
        p, cfg, *a, attn_impl="xla", remat=False))(
            tree, *map(jnp.asarray, inputs))
    state = from_jax_params(tree, device="cpu")
    t_in = [torch.from_numpy(x) for x in inputs]
    got = treward.reward_forward(state, cfg, *t_in)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-5, err_msg=name)
    base = from_jax_params(params, device="cpu")
    fresh = tlora.apply_lora(base, torch.Generator().manual_seed(0), RANK)
    plain = treward.reward_forward(base, cfg, *t_in)
    assert torch.equal(treward.reward_forward(fresh, cfg, *t_in).score,
                       plain.score)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_trainable_mask_lora_matches_jax(setup, stage):
    """The LoRA trainable set equals JAX's True paths, on a plain and on an
    int4 base (whose integer fields sit under ``.w``)."""
    _, params = setup
    for base in ("plain", "int4-wo"):
        tree = lora_tree(params, base)
        mask = jtrainer.trainable_mask(tree, stage, lora=True)
        want = {jtrainer._path_str(path) for path, on in
                jax.tree_util.tree_leaves_with_path(mask) if on}
        state = from_jax_params(tree, device="cpu")
        got = ttrainer.trainable_mask(state, stage, lora=True)
        assert got == want
        assert {p.rsplit("/", 1)[-1] for p in got if p.startswith("model/")
                } == {".a", ".b"}
        # Every flattened path is one of JAX's leaves.
        leaves = {jtrainer._path_str(path) for path, _ in
                  jax.tree_util.tree_leaves_with_path(tree)}
        assert set(ttrainer.flatten_state(state)) == leaves


def test_a_quantized_base_trains_only_with_lora(setup):
    """JAX's mask would train the integer fields of a quantized tree
    trained without LoRA; torch cannot take their gradient, so the port
    refuses, naming LoRA."""
    _, params = setup
    state = from_jax_params(jax.tree.map(np.asarray, quantized(
        params, "int8-wo")), device="cpu")
    with pytest.raises(ValueError, match="only with LoRA"):
        ttrainer.make_optimizer(ttrainer.TrainConfig(stage=1), state)
    opt = ttrainer.make_optimizer(ttrainer.TrainConfig(stage=1, lora_rank=2),
                                  tlora.apply_lora(
                                      state, torch.Generator(), RANK))
    assert opt.paths and all(p.endswith(("/.a", "/.b")) or
                             p.startswith("regression_layer")
                             for p in opt.paths)


# -------------------------------------------------------- one trainer step

def _jax_step(cfg, tree, tmp):
    tc = jtrainer.TrainConfig(stage=1, attn_impl="xla", learning_rate=LR,
                              total_steps=4, lora_rank=RANK, log_every=1,
                              remat=False, mesh_data_axis=1,
                              checkpoint_dir=str(tmp))
    tr = jtrainer.Trainer(cfg, jax.tree.map(jnp.asarray, tree), tc)
    last = tr.train([make_batch(cfg, seed=1)], max_steps=1)
    return last, jax.tree.map(np.asarray, jax.device_get(tr.params))


@pytest.fixture(scope="module")
def jax_steps(setup, tmp_path_factory):
    """One JAX ``Trainer`` step (stage 1, LoRA rank 2, from a nonzero
    ``b``) per base, run when a test first asks for that base."""
    cfg, params = setup
    done = {}

    def run(base):
        if base not in done:
            tree = lora_tree(params, base)
            done[base] = (tree, *_jax_step(
                cfg, tree, tmp_path_factory.mktemp(f"jax_{base}")))
        return done[base]

    return run


def _close_update(got, want, before):
    """Hold the port's stepped tensor to JAX's by the module's rules
    (atol 2e-6, or 2 bf16 ulps for a bf16 one; an element off that by at
    most 2 lr, Adam's first step where the gradient is near eps); returns
    whether the step moved it."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.detach().float().numpy(), want.float().numpy()
    tol = (2 * 2 ** -8 * np.abs(want) + 1e-6) if bf16 else 2e-6
    off = np.abs(got - want) > tol
    if off.any():
        assert np.abs(got - want)[off].max() <= 2 * LR * (1 + 2 ** -6)
        assert off.mean() < 0.01, off.mean()
    return not np.array_equal(got, before.float().numpy())


@pytest.mark.parametrize("base", BASES)
def test_one_lora_trainer_step_matches_jax(setup, jax_steps, base,
                                           tmp_path):
    """Loss, grad_norm and the stepped adapters and head against JAX's
    ``Trainer``; every ``.w`` field and every ViT tensor bit-identical,
    the node types kept (QLoRA over ``int8-wo`` and ``int4-wo`` too)."""
    cfg, _ = setup
    tree, last, jp1 = jax_steps(base)
    state = from_jax_params(tree, device="cpu")
    before = {p: t.clone() for p, t in ttrainer.flatten_state(state).items()}
    tc = ttrainer.TrainConfig(stage=1, learning_rate=LR, total_steps=4,
                              lora_rank=RANK, log_every=1, remat=False,
                              checkpoint_dir=str(tmp_path))
    tr = ttrainer.Trainer(cfg, state, tc)
    got = tr.train([make_batch(cfg, seed=1)], max_steps=1)
    np.testing.assert_allclose(got["loss"], last["loss"], rtol=1e-4)
    # An int4 base's adapters are bf16 (its scales' dtype): each gradient
    # element is rounded to bf16 (2^-9) in either package's own order.
    np.testing.assert_allclose(got["grad_norm"], last["grad_norm"],
                               rtol=1e-3 if base == "int4-wo" else 1e-4)
    after = ttrainer.flatten_state(tr.params)
    want = ttrainer.flatten_state(from_jax_params(jp1, device="cpu"))
    trained = set(tr.optimizer.paths)
    assert trained == {jtrainer._path_str(p) for p, on in
                       jax.tree_util.tree_leaves_with_path(
                           jtrainer.trainable_mask(tree, 1, lora=True))
                       if on}
    moved_ab = set()
    for path, t in after.items():
        if path in trained:
            if _close_update(t, want[path], before[path]):
                moved_ab.add(path.rsplit("/", 1)[-1])
        else:
            assert torch.equal(t, before[path]), path
            assert t.dtype == before[path].dtype
    assert {".a", ".b"} <= moved_ab
    lks = port_lora_paths(tr.params)
    refs = jax_lora_paths(tree)
    assert len(lks) == 7 and all(kind(lk.w) == kind(refs[p].w)
                                 for p, lk in lks.items())


# -------------------------------------------------------- merge and revive

def test_merge_lora_matches_jax_and_refuses_a_quantized_base(setup):
    _, params = setup
    tree = lora_tree(params)
    want = from_jax_params(jax.tree.map(np.asarray, jlora.merge_lora(
        jax.tree.map(jnp.asarray, tree))), device="cpu")
    got = tlora.merge_lora(from_jax_params(tree, device="cpu"))
    assert not port_lora_paths(got)
    flat = ttrainer.flatten_state(want)
    for path, t in ttrainer.flatten_state(got).items():
        np.testing.assert_allclose(t.numpy(), flat[path].numpy(), atol=1e-6,
                                   err_msg=path)
    qtree = lora_tree(params, "int8-wo")
    with pytest.raises(ValueError) as jerr:
        jlora.merge_lora(qtree)
    with pytest.raises(ValueError) as terr:
        tlora.merge_lora(from_jax_params(qtree, device="cpu"))
    assert str(terr.value) == str(jerr.value)


def _plain_tree(rng):
    """Plain dicts as a structure-less restore returns them: each of JAX's
    revival rules, a stacked (L, K, N) one, a nested LoRA base and two
    dicts that must stay dicts."""
    def i8(*s):
        return rng.integers(-127, 128, size=s).astype(np.int8)

    def f32(*s):
        return rng.normal(size=s).astype(np.float32)

    return {
        "q8": {"kernel": {"q": i8(8, 6), "scale": f32(1, 6)}},
        "stacked": {"kernel": {"q": i8(3, 8, 6), "scale": f32(3, 2, 6)}},
        "wo": {"kernel": {"qw": i8(8, 6), "scale": f32(1, 6)}},
        "q4": {"kernel": {"packed": i8(4, 6), "scale": f32(1, 6)}},
        "lora": {"kernel": {"w": {"qw": i8(8, 6), "scale": f32(1, 6)},
                            "a": f32(8, 2), "b": f32(2, 6),
                            "scale": np.asarray(1.0, np.float32)}},
        "float_q": {"kernel": {"q": f32(8, 6), "scale": f32(1, 6)}},
        "extra": {"kernel": {"q": i8(8, 6), "scale": f32(1, 6),
                             "bias": f32(6)}},
    }


def _kinds(tree, prefix=""):
    """{path: class name} of the nodes and leaves of a revived tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _kinds(sub, f"{prefix}{key}/").items()}
    kind = type(tree).__name__
    if kind == "LoraKernel":
        return {prefix: kind, prefix + ".w": type(tree.w).__name__}
    return {prefix: kind if kind in ("QuantKernel", "WOQuantKernel",
                                     "Q4Kernel") else "leaf"}


def test_revive_follows_jax_rules_and_restores_k_major(tmp_path):
    rng = np.random.default_rng(3)
    tree = _plain_tree(rng)
    want = jquant.revive_quant_kernels(jlora.revive_lora_kernels(
        jax.tree.map(jnp.asarray, tree)))
    state = jax.tree.map(torch.from_numpy, tree)
    got = tquant.revive_quant_kernels(tlora.revive_lora_kernels(state))
    assert _kinds(got) == _kinds(want)
    assert _kinds(got)["q4/kernel/"] == "Q4Kernel"
    assert _kinds(got)["float_q/kernel/q/"] == "leaf"
    for q in (got["q8"]["kernel"].q, got["wo"]["kernel"].qw,
              got["q4"]["kernel"].packed, got["lora"]["kernel"].w.qw):
        assert tquant.is_k_major(q)
    st = got["stacked"]["kernel"].q
    assert st.transpose(-1, -2).is_contiguous()
    np.testing.assert_array_equal(st.numpy(), tree["stacked"]["kernel"]["q"])
    # save_state writes plain dicts; an outlier node comes back per column.
    node = tquant.OutlierQuantKernel(q=tquant.k_major(torch.from_numpy(
        tree["q8"]["kernel"]["q"])), scale=torch.ones(1, 6), n_outliers=4)
    tckpt.save_state({"k": node}, str(tmp_path / "s.pt"))
    raw = torch.load(tmp_path / "s.pt", weights_only=True)
    assert set(raw["k"]) == {"q", "scale"}
    back = tckpt.load_state(str(tmp_path / "s.pt"))["k"]
    assert type(back) is tquant.QuantKernel and torch.equal(back.q, node.q)
    assert tquant.is_k_major(back.q)


# ------------------------------------------------------- F8 and F9 repairs

def _qlora_trainer(cfg, params, d, accumulate=2):
    state = from_jax_params(jax.tree.map(np.asarray, quantized(
        params, "int4-wo")), device="cpu")
    tc = ttrainer.TrainConfig(stage=3, learning_rate=LR, total_steps=4,
                              gradient_accumulation_steps=accumulate,
                              lora_rank=RANK, log_every=1,
                              checkpoint_every=10**9, checkpoint_dir=str(d))
    return ttrainer.Trainer(cfg, state, tc)


def test_qlora_save_and_resume_keep_nodes_and_the_next_step(setup, tmp_path):
    """F8: a QLoRA (int4) trainer saved in the middle of an accumulation
    window and resumed: the file loads with ``torch.load(weights_only=
    True)``, the LoRA and int4 nodes come back (packed k-major), and the
    next step is bit-equal to an unbroken run's."""
    cfg, params = setup
    batches = [make_batch(cfg, B=1, frames=1, seed=60 + i) for i in range(3)]
    tr_a = _qlora_trainer(cfg, params, tmp_path / "a")
    tr_a.train(iter(batches))
    tr_b = _qlora_trainer(cfg, params, tmp_path / "b")
    tr_b.train(iter(batches[:1]))
    assert tr_b.opt_state["mini_step"] == 1
    path = tr_b.save()
    torch.load(path, weights_only=True)
    tr_c = _qlora_trainer(cfg, params, tmp_path / "b")
    assert tr_c.resume_latest() == path and tr_c.step == 1
    lks = port_lora_paths(tr_c.params)
    assert len(lks) == 7 and all(isinstance(lk.w, Q4Kernel)
                                 for lk in lks.values())
    assert all(tquant.is_k_major(lk.w.packed[0]) for lk in lks.values())
    tr_c.train(iter(batches[1:]))
    assert tr_c.step == 3
    a = ttrainer.flatten_state(tr_a.params)
    for p, t in ttrainer.flatten_state(tr_c.params).items():
        assert torch.equal(t, a[p]), p


def test_async_save_writes_the_node_fields_of_the_call(tmp_path, monkeypatch):
    """F9: a background save of a state with a QLoRA node, its tensors
    updated in place right after the call returns (the write held back
    until then): the file holds the values of the call."""
    gate = threading.Event()
    real = tckpt._write

    def held(state, path):
        assert gate.wait(30)
        real(state, path)

    monkeypatch.setattr(tckpt, "_write", held)
    rng = np.random.default_rng(4)
    qw = tquant.k_major(torch.from_numpy(
        rng.integers(-127, 128, size=(8, 6)).astype(np.int8)))
    node = tlora.LoraKernel(
        w=tquant.WOQuantKernel(qw=qw, scale=torch.rand(1, 6)),
        a=torch.randn(8, 2), b=torch.randn(2, 6), scale=torch.tensor(1.0))
    before = map_state(torch.clone, node)
    path = str(tmp_path / "async.pt")
    tckpt.save_state({"params": {"k": node}, "step": 1}, path, block=False)
    for t in (node.a, node.b, node.w.scale):
        t.add_(1.0)
    node.w.qw.add_(1)
    gate.set()
    tckpt.wait_for_saves()
    got = tckpt.load_state(path)["params"]["k"]
    assert isinstance(got.w, tquant.WOQuantKernel)
    for t, r in ((got.a, before.a), (got.b, before.b),
                 (got.w.scale, before.w.scale), (got.w.qw, before.w.qw)):
        assert torch.equal(t, r)


# -------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location(
        "make_sample_data", REPO / "examples" / "make_sample_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("lora_cli")
    (root / "videos").mkdir()
    rng = np.random.default_rng(2)
    records = [mod.make_record(rng, i, str(root / "videos"))
               for i in range(2)]
    (root / "pairs.json").write_text(json.dumps(records))
    return root


def _cli_argv(root, stage, out, *extra):
    return ["--stage", str(stage), "--tiny", "--fp32", "--device", "cpu",
            "--train-json", str(root / "pairs.json"),
            "--video-root", str(root / "videos"), "--output-dir", str(out),
            "--batch-size", "1", "--num-segments", "2", "--max-length",
            "512", "--max-steps", "1", "--gradient-accumulation-steps", "1",
            "--warmup-steps", "0", "--lora-rank", "4", *extra]


def test_train_cli_trains_lora_and_warm_starts_a_lora_stage(
        sample, tmp_path, monkeypatch):
    """``--lora-rank 4`` trains adapters and saves LoRA nodes; stage 2's
    ``--warm-start`` from that checkpoint fails on the unwrapped state, so
    the CLI wraps first and the stage-1 adapters reach the trainer."""
    from mjvideo_tpu_torch.train import cli as tcli

    first = tmp_path / "s1"
    tcli.main(_cli_argv(sample, 1, first, "--lora-alpha", "8"))
    saved = tckpt.load_state(str(first / "stage1_step1.pt"))["params"]
    lks = port_lora_paths(saved)
    assert len(lks) == 7
    assert all(torch.all(lk.scale == 2.0) for lk in lks.values())
    assert any(lk.b.any() for lk in lks.values())
    made = {}

    class Capture(ttrainer.Trainer):
        def __init__(self, cfg, params, tc, sp_group=None):
            made.update((p, t.clone()) for p, t in
                        ttrainer.flatten_state(params).items())
            super().__init__(cfg, params, tc, sp_group)

    monkeypatch.setattr(ttrainer, "Trainer", Capture)
    second = tmp_path / "s2"
    tcli.main(_cli_argv(sample, 2, second, "--lora-alpha", "8",
                        "--warm-start", str(first / "stage1_step1.pt")))
    for p, t in ttrainer.flatten_state(saved).items():
        assert torch.equal(made[p], t), p
    assert (second / "stage2_step1.pt").exists()
