"""The port's sequence parallelism (``mjvideo_tpu_torch/parallel/``) against
the JAX package, and its two group forms against each other.

fp32 on the CPU, inputs from numpy seeds.  The JAX side runs the Pallas
kernels in interpret mode (``flash_attention_with_lse``, ``_bwd_impl``) or
its exact XLA attention (``impl="xla"``, ``attn_impl="xla"``) without
sequence parallelism; the port runs the kernels' plain twins.  Tolerances,
each with its reason:

* the K3-lse twin: 1e-5 on live rows (the same fp32 sums in other orders);
  dead rows exactly 0 and ``DEAD_LSE`` on both sides;
* the K4a/K4b twins at a ring offset: atol 2e-5, rtol 1e-5, the bar of
  ``tests/test_torch_flash_attention.py``;
* ring and all-gather attention: atol 3e-5 on the output (the JAX
  package's own bar, ``tests/test_parallel.py:167-233``), each gradient to
  1e-4 of its largest entry (n chunks merged by log-sum-exp in fp32);
* ``reward_forward`` and ``RewardScorer`` under ``sp``: atol 1e-4 against
  JAX without it (two towers of 2 layers each);
* the stage-3 gradient: atol 1e-6, rtol 1e-4, the bar of
  ``tests/test_torch_train.py``;
* two gloo processes against the one-process form of the same group size:
  1e-6 for attention, 1e-5 for the reward and the gradient (the
  position-wise products run on half the rows, so their sums may block
  differently).
"""

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

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data.prompts import (ByteTokenizer, build_video_question,
                                      prepare_chat_input)
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.ops.attention import multi_head_attention
from mjvideo_tpu.ops.flash_attention import _bwd_impl, flash_attention_with_lse
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.models import reward as treward
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.parallel import distributed as tdist
from mjvideo_tpu_torch.parallel.sequence import (
    SequenceGroup,
    ring_flash_attention,
    shard_sequence,
    sp_flash_attention,
)
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
T_ = torch.from_numpy


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ K3 lse, K4

L = 32  # one shard's rows: S = 128 over n = 4


def _chunk_inputs(seed):
    """One shard's queries and one chunk's keys: B = 2, GQA 4/2, D = 16;
    row 0 masks the chunk's last 5 keys, row 1 its first 6, so at offset 0
    row 1's first 6 queries see no key."""
    rng = np.random.default_rng(seed)
    q = _rand(rng, (2, L, 4, 16))
    k = _rand(rng, (2, L, 2, 16))
    v = _rand(rng, (2, L, 2, 16))
    do = _rand(rng, (2, L, 4, 16))
    mask = np.ones((2, L), np.int32)
    mask[0, L - 5:] = 0
    mask[1, :6] = 0
    return q, k, v, do, mask


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rel", [-L, 0, L])
def test_k3_lse_twin_matches_pallas_at_ring_offsets(rel, causal):
    """``exact_attention_with_lse`` (the K3-lse twin) against
    ``flash_attention_with_lse(q_offset=rel)`` at the ring's relative
    offsets: a later shard's chunk (every causal row dead), the diagonal
    chunk and an earlier one."""
    q, k, v, _, mask = _chunk_inputs(7)
    out, lse = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attention_mask=jnp.asarray(mask), causal=causal,
        q_offset=jnp.asarray(rel, jnp.int32), interpret=True)
    out, lse = np.asarray(out), np.asarray(lse)[:, :, 0, :L]
    got, got_lse = tfa.exact_attention_with_lse(
        T_(q), T_(k), T_(v), T_(mask), torch.full((2,), rel, dtype=torch.int32),
        causal=causal)
    got, got_lse = got.numpy(), got_lse.numpy()
    dead = lse >= tfa.DEAD_LSE * 0.5
    np.testing.assert_array_equal(got_lse >= tfa.DEAD_LSE * 0.5, dead)
    assert np.all(got_lse[dead] == tfa.DEAD_LSE) and np.all(
        lse[dead] == tfa.DEAD_LSE)
    np.testing.assert_allclose(got_lse[~dead], lse[~dead], atol=1e-5)
    np.testing.assert_allclose(got, out, atol=1e-5)
    rows_dead = dead.transpose(0, 2, 1)  # (B, L, Hq)
    assert np.all(got[rows_dead] == 0.0) and np.all(out[rows_dead] == 0.0)
    if causal and rel == -L:
        assert dead.all()
    if causal and rel == 0:
        assert dead[1, :, :6].all() and not dead[1, :, 6:].any()
    # Without the lse the same call gives the same output.
    alone = tfa.exact_attention(T_(q), T_(k), T_(v), T_(mask),
                                torch.full((2,), rel, dtype=torch.int32),
                                causal=causal)
    np.testing.assert_array_equal(alone.numpy(), got)


@pytest.mark.parametrize("rel", [-L, 0, L])
def test_k4_twins_match_pallas_backward_at_ring_offsets(rel):
    """K4a/K4b's twin against ``_bwd_impl`` at a ring offset, from a
    natural-layout (B, Hq, L) lse as the ring's merge gives it: the chunk's
    own lse raised by 0.5 on its live rows (the mass of other chunks), and
    a finite 3.0 where this chunk gives a row no key."""
    q, k, v, do, mask = _chunk_inputs(11)
    off = jnp.asarray(rel, jnp.int32)
    out, lse = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attention_mask=jnp.asarray(mask), causal=True, q_offset=off,
        interpret=True)
    lse = np.asarray(lse)[:, :, 0, :L]
    lse = np.where(lse >= tfa.DEAD_LSE * 0.5, 3.0, lse + 0.5)
    lse = np.ascontiguousarray(lse.astype(np.float32))
    want = _bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask), off, out, jnp.asarray(lse),
                     jnp.asarray(do), True, None, None, None, True)
    got = tfa.decoder_attention_backward_plain(
        T_(q), T_(k), T_(v), T_(mask), torch.full((2,), rel, dtype=torch.int32),
        T_(np.array(out)), T_(lse), T_(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5, err_msg=name)
    if rel == -L:
        assert not any(g.numpy().any() for g in got)
    else:
        assert all(g.numpy().any() for g in got)


# ------------------------------------------------ ring and all-gather

S = 64


def _attn_inputs():
    rng = np.random.default_rng(13)
    q = _rand(rng, (2, S, 4, 16))
    k = _rand(rng, (2, S, 2, 16))
    v = _rand(rng, (2, S, 2, 16))
    g = _rand(rng, (2, S, 4, 16))
    mask = np.ones((2, S), np.int32)
    mask[0, S - 7:] = 0
    mask[1, S - 20:] = 0
    return q, k, v, g, mask


@functools.lru_cache(maxsize=None)
def _xla_reference(causal, masked):
    """JAX's exact attention and its vjp (cotangent g on real rows)."""
    q, k, v, g, mask = _attn_inputs()
    m = jnp.asarray(mask) if masked else None
    g = g * mask[:, :, None, None] if masked else g

    def f(q, k, v):
        return multi_head_attention(q, k, v, attention_mask=m, causal=causal,
                                    impl="xla")

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(d) for d in vjp(jnp.asarray(g))], g


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("kind", ["ring", "allgather"])
def test_sequence_parallel_attention_matches_jax_xla(kind, n, causal, masked):
    q, k, v, _, mask = _attn_inputs()
    ref, ref_grads, g = _xla_reference(causal, masked)
    fn = ring_flash_attention if kind == "ring" else sp_flash_attention
    leaves = [T_(a).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves, SequenceGroup.local(n),
             attention_mask=T_(mask) if masked else None, causal=causal)
    rows = mask[:, :, None, None] if masked else 1.0
    np.testing.assert_allclose(out.detach().numpy() * rows, ref * rows,
                               atol=3e-5)
    grads = torch.autograd.grad(out, leaves, T_(np.ascontiguousarray(g)))
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


# ------------------------------------------- reward forward and scorer

@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jreward.init_reward_params(key, cfg))(
            jax.random.PRNGKey(2)))
    return cfg, params, from_jax_params(params, device="cpu")


def _reward_inputs(cfg):
    """Two prompts of T = 64 (a multiple of 4 and 8), one right-padded."""
    ch = cfg.chat
    n_img, T = ch.num_image_token, 64
    rng = np.random.default_rng(5)
    ids = rng.integers(10, 200, size=(2, T)).astype(np.int32)
    ids[0, 3:3 + 2 * n_img] = ch.img_context_token_id
    ids[1, 30:30 + 2 * n_img] = ch.img_context_token_id  # crosses shards
    ids[1, T - 9:] = ch.llm.pad_token_id
    mask = (ids != ch.llm.pad_token_id).astype(np.int32)
    pix = _rand(rng, (4, ch.image_size, ch.image_size, 3))
    return pix, ids, mask, np.array([T - 6, T - 20], np.int32)


@pytest.mark.parametrize("kind", ["ring", "allgather"])
def test_sequence_parallel_reward_forward_matches_jax(model, kind):
    """Every field of ``reward_forward(sp=)`` against JAX's non-SP forward
    (4 tiles over 4 shards; an image span that crosses shard boundaries)."""
    cfg, params, state = model
    pix, ids, mask, gpos = _reward_inputs(cfg)
    ref = jax.jit(lambda p, x, i, m, g: jreward.reward_forward(
        p, cfg, x, i, m, g, attn_impl="xla", remat=False))(
            params, jnp.asarray(pix), jnp.asarray(ids), jnp.asarray(mask),
            jnp.asarray(gpos))
    got = treward.reward_forward(
        state, cfg, T_(pix), T_(ids), T_(mask), T_(gpos),
        sp={"group": SequenceGroup.local(4), "kind": kind})
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=name)


def _clips(scorer_cfg, tok, rng):
    ids, gpos = [], []
    for caption, frames in (("a dog", 2), ("a much longer caption", 1)):
        chat = prepare_chat_input(scorer_cfg.chat, tok,
                                  build_video_question(caption, frames),
                                  num_patches_list=[1] * frames,
                                  gating_pattern=tok.gating_pattern())
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
    size = scorer_cfg.chat.image_size
    return _rand(rng, (3, size, size, 3)), ids, gpos


@pytest.mark.parametrize("kind", ["ring", "allgather"])
def test_sequence_parallel_scorer_matches_jax_scorer(model, kind):
    """``RewardScorer(sp=kind, sp_group=local(4))`` against the JAX scorer
    without sequence parallelism, two clips in one 512 bucket."""
    cfg, params, state = model
    tok = ByteTokenizer()
    common = dict(length_buckets=(512,), gating_pattern=tok.gating_pattern())
    jax_scorer = JaxRewardScorer(cfg, params, tok, attn_impl="xla",
                                 dtype=jnp.float32, **common)
    port = RewardScorer(cfg, state, tok, dtype=torch.float32, sp=kind,
                        sp_group=SequenceGroup.local(4), **common)
    pix, ids, gpos = _clips(port.cfg, tok, np.random.default_rng(3))
    ref = jax_scorer.score_batch(pix, ids, gpos)
    got = port.score_batch(pix, ids, gpos)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=name)


def test_sequence_parallel_scorer_rejects_bad_arguments(model):
    cfg, _, state = model
    tok = ByteTokenizer()
    with pytest.raises(ValueError, match="unknown sp kind"):
        RewardScorer(cfg, state, tok, sp="tree",
                     sp_group=SequenceGroup.local(4))
    with pytest.raises(ValueError, match="sp_group"):
        RewardScorer(cfg, state, tok, sp="ring")
    with pytest.raises(ValueError, match=r"\[510\] are not divisible by 4"):
        RewardScorer(cfg, state, tok, sp="ring", length_buckets=(512, 510),
                     sp_group=SequenceGroup.local(4))
    with pytest.raises(ValueError, match="not divisible by 8 shards"):
        ring_flash_attention(*(torch.zeros(1, 12, 2, 16) for _ in range(3)),
                             SequenceGroup.local(8))


# ------------------------------------------------------------- training

def _train_batch(cfg, seed=0):
    """One ``PairCollator``-layout batch of 2 pairs of 2-frame clips, T =
    24 (a multiple of 4), the second row right-padded."""
    rng = np.random.default_rng(seed)
    c = cfg.chat
    n_img, T, B = 2 * c.num_image_token, 24, 2
    batch = {}
    for v in (0, 1):
        ids = np.full((B, T), 5, np.int32)
        ids[:, 2:2 + n_img] = c.img_context_token_id
        mask = np.ones((B, T), np.int32)
        mask[1, T - 3:] = 0
        ids[1, T - 3:] = c.llm.pad_token_id
        batch[f"video_{v}_pixel_values"] = _rand(
            rng, (B, 2, c.vision.image_size, c.vision.image_size, 3))
        batch[f"video_{v}_input_ids"] = ids
        batch[f"video_{v}_attention_mask"] = mask
        batch[f"video_{v}_gating_pos"] = np.full((B,), T - 6, np.int32)
        for name, n in (("criteria", 28), ("aspect", 5)):
            batch[f"video_{v}_{name}_score"] = rng.choice(
                [-1.0, 0.0, 1.0], size=(B, n)).astype(np.float32)
            batch[f"video_{v}_{name}_related"] = rng.integers(
                0, 2, size=(B, n)).astype(np.float32)
        batch[f"video_{v}_overall_score"] = rng.choice(
            [-1.0, 1.0], size=(B, 1)).astype(np.float32)
        batch[f"video_{v}_overall_related"] = np.ones((B, 1), np.float32)
    batch["aspect_preference"] = rng.integers(0, 2, (B, 5)).astype(np.int32)
    batch["aspect_mask"] = rng.integers(0, 2, (B, 5)).astype(np.float32)
    batch["overall_preference"] = rng.integers(0, 2, (B, 1)).astype(np.int32)
    batch["overall_mask"] = np.ones((B, 1), np.float32)
    return batch


def test_sequence_parallel_stage3_gradient_matches_jax(model, tmp_path):
    """The stage-3 loss and trainable gradient with ``sp="ring"`` over
    ``local(4)`` against ``jax.grad`` of JAX's non-SP loss; then one
    ``Trainer`` micro-step (accumulation 2) holds that gradient in its
    accumulation buffer."""
    cfg, params, _ = model
    batch = _train_batch(cfg)
    kw = dict(stage=3, learning_rate=1e-3, total_steps=4)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(
        cfg, jtrainer.TrainConfig(attn_impl="xla", **kw))))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    want = ttrainer.flatten_state(from_jax_params(
        jax.tree.map(np.asarray, jgrads), device="cpu"))

    tc = ttrainer.TrainConfig(sp="ring", gradient_accumulation_steps=2,
                              checkpoint_dir=str(tmp_path), **kw)
    group = SequenceGroup.local(4)
    with pytest.raises(ValueError, match="sp_group"):
        ttrainer.make_loss_fn(cfg, tc)
    state = from_jax_params(params, device="cpu")
    opt = ttrainer.make_optimizer(tc, state)
    ttrainer.set_trainable(state, set(opt.paths))
    flat = ttrainer.flatten_state(state)
    tbatch = {k: T_(np.array(v)) for k, v in batch.items()}
    loss = ttrainer.make_loss_fn(cfg, tc, group)(state, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, [flat[p] for p in opt.paths])
    for path, g in zip(opt.paths, grads):
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=path)

    trainer = ttrainer.Trainer(cfg, from_jax_params(params, device="cpu"),
                               tc, sp_group=group)
    trainer.train([batch])
    for path, g in zip(opt.paths, grads):
        np.testing.assert_allclose(trainer.opt_state["acc"][path].numpy(),
                                   g.numpy(), atol=1e-7, err_msg=path)


# ------------------------------------------------ two gloo processes

WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from mjvideo_tpu_torch import init_reward_params, tiny_test_config
from mjvideo_tpu_torch.models.reward import reward_forward
from mjvideo_tpu_torch.parallel.sequence import (
    SequenceGroup, ring_flash_attention, shard_sequence, sp_flash_attention)
from mjvideo_tpu_torch.train import trainer as tt

rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
group = SequenceGroup.distributed()
data = dict(np.load(f"{out_dir}/inputs.npz"))
res = {}
for kind, fn in (("ring", ring_flash_attention),
                 ("allgather", sp_flash_attention)):
    leaves = [shard_sequence(torch.from_numpy(data[n]), group)
              .requires_grad_() for n in ("q", "k", "v")]
    mask = shard_sequence(torch.from_numpy(data["mask"]), group)
    out = fn(*leaves, group, attention_mask=mask, causal=True)
    grads = torch.autograd.grad(
        out, leaves, shard_sequence(torch.from_numpy(data["g"]), group))
    res[f"{kind}_out"] = out.detach().numpy()
    for name, gr in zip(("dq", "dk", "dv"), grads):
        res[f"{kind}_{name}"] = gr.numpy()

cfg = tiny_test_config()
state = init_reward_params(cfg, generator=torch.Generator().manual_seed(0),
                           device=torch.device("cpu"), dtype=torch.float32)
sp = {"group": group, "kind": "ring"}
with torch.no_grad():
    r = reward_forward(state, cfg, torch.from_numpy(data["pix"]),
                       torch.from_numpy(data["ids"]),
                       torch.from_numpy(data["ids_mask"]),
                       torch.from_numpy(data["gpos"]), sp=sp)
res["score"] = r.score.numpy()
res["hidden_state"] = r.hidden_state.numpy()
batch = {k[6:]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith("batch/")}
tc = tt.TrainConfig(stage=3, sp="ring", gradient_accumulation_steps=2)
opt = tt.make_optimizer(tc, state)
step = tt.make_train_step(cfg, tc, opt, group)
_, opt_state, metrics = step(state, opt.init(state), batch)
res["loss"] = metrics["loss"].numpy()
for path, acc in opt_state["acc"].items():
    res["grad/" + path] = acc.numpy()
np.savez(f"{out_dir}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_processes_equal_the_local_form(model, tmp_path, monkeypatch):
    """Two processes over gloo (one shard each, ``SequenceGroup.
    distributed()``) against ``local(2)`` in this process: ring and
    all-gather attention with their gradients, the ring ``reward_forward``
    (global RoPE positions, the image scatter by global index, the head's
    rows gathered) and a stage-3 train step's gradient (backbone gradients
    summed over the ranks).  ``maybe_initialize`` is a no-op without a
    launcher's variables."""
    cfg = tiny_test_config()
    q, k, v, g, mask = _attn_inputs()
    pix, ids, ids_mask, gpos = _reward_inputs(cfg)
    batch = _train_batch(cfg, seed=4)
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, g=g, mask=mask, pix=pix,
             ids=ids, ids_mask=ids_mask, gpos=gpos,
             **{f"batch/{k_}": v_ for k_, v_ in batch.items()})
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                               str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    logs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1)]

    group = SequenceGroup.local(2)
    for kind, fn in (("ring", ring_flash_attention),
                     ("allgather", sp_flash_attention)):
        leaves = [T_(a).requires_grad_() for a in (q, k, v)]
        out = fn(*leaves, group, attention_mask=T_(mask), causal=True)
        grads = torch.autograd.grad(out, leaves, T_(g))
        for name, want in zip(("out", "dq", "dk", "dv"), (out,) + grads):
            got = np.concatenate([r[f"{kind}_{name}"] for r in ranks], 1)
            np.testing.assert_allclose(got, want.detach().numpy(), atol=1e-6,
                                       err_msg=f"{kind} {name}")

    state = treward.init_reward_params(
        cfg, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu"), dtype=torch.float32)
    with torch.no_grad():
        ref = treward.reward_forward(state, cfg, T_(pix), T_(ids),
                                     T_(ids_mask), T_(gpos),
                                     sp={"group": group, "kind": "ring"})
    for r in ranks:
        np.testing.assert_allclose(r["score"], ref.score.numpy(), atol=1e-5)
        np.testing.assert_allclose(r["hidden_state"],
                                   ref.hidden_state.numpy(), atol=1e-5)

    tc = ttrainer.TrainConfig(stage=3, sp="ring")
    opt = ttrainer.make_optimizer(tc, state)
    ttrainer.set_trainable(state, set(opt.paths))
    flat = ttrainer.flatten_state(state)
    loss = ttrainer.make_loss_fn(cfg, tc, group)(
        state, {k_: T_(np.array(v_)) for k_, v_ in batch.items()})
    grads = torch.autograd.grad(loss, [flat[p] for p in opt.paths])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-6)
        for path, want in zip(opt.paths, grads):
            np.testing.assert_allclose(r["grad/" + path], want.numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=path)

    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.maybe_initialize() is False
    assert not torch.distributed.is_initialized()
    assert tdist.process_info() == (0, 1)


def test_shard_sequence_keeps_rows_of_the_rank():
    x = torch.arange(24).reshape(2, 12)
    assert shard_sequence(x, SequenceGroup.local(3)) is x
    group = SequenceGroup(3, rank=1)
    assert torch.equal(shard_sequence(x, group), x[:, 4:8])
    assert group.held_rows(4) == (4, 12)
    with pytest.raises(ValueError, match="not divisible"):
        shard_sequence(x, SequenceGroup(5, rank=0))
