"""MJ-VIDEO-4B's gradient paths in the port against the JAX package, at a
tiny Phi-3-shaped config whose decoder has Phi-3's head dim of 96.

``tests/test_torch_phi3.py``'s ``_phi3`` with the LLM at hidden size 192
and 2 heads of 96 (Hq = Hkv, as in Phi-3), fp32 on the CPU, the weights
made by JAX and bridged by ``from_jax_params``, inputs from numpy seeds.
JAX runs ``attn_impl="xla"`` (the exact softmax with autodiff); the port
runs its kernels' twins at D = 96 (K2 with the lse forward, K4a/K4b
backward, K3 lse in the ring), the forms whose twins
``tests/test_torch_d96.py`` holds against the Pallas kernels.  Tolerances,
each with its reason:

* the score: atol 2e-5 (the bar of ``tests/test_torch_scorer.py``);
* ``score_fn``'s pixel gradient and ``score_fn_with_params``' leaf
  gradients: 1e-4 of each gradient's largest entry, the bar of
  ``tests/test_torch_reward_grad.py`` (the same fp32 terms summed in other
  orders through 2 ViT and 2 decoder layers);
* VADER: each step's reward atol 2e-5, the field after 3 Adam steps atol
  1e-4 (2e-3 of the learning rate: Adam's normalisation magnifies the
  error of a gradient entry near 0), as ``tests/test_torch_reward_grad.py``;
* the train step at stages 1-3: the loss and grad norm rtol 1e-4, each
  trainable gradient atol 1e-6 and rtol 1e-4, the params after the step
  atol 2e-6 (lr * 2e-3) except where the gradient Adam sees lies within
  1e-6 of 0, as ``tests/test_torch_train.py``: Adam's first update is lr
  * g / (|g| + eps) on the gradient clipped to a global norm of 1
  (``max_grad_norm``), so at this config's norm of about 126 an element
  whose clipped gradient is within 100 eps moves by up to 2 lr with the
  gradient's own error (measured: 3 of 110,592 elements of one kernel,
  up to 3.8e-5 off); accumulation of two micro-batches against one
  concatenated batch at stage 1, relative 5e-5, as there (stages 2 and 3
  divide by each batch's mask counts, so two halves are not one batch);
* the ring micro-batch over ``SequenceGroup.local(2)``: the loss rtol
  1e-5 and each gradient atol 1e-6, rtol 1e-4 against JAX without
  sequence parallelism, and the ``Trainer``'s accumulation buffer atol
  1e-7 against that gradient, as ``tests/test_torch_sequence.py``.

JAX's train step is ``make_train_step``'s body on one jitted
``value_and_grad``: the optimizer's update and ``apply_updates`` (jitted
apart) and ``global_norm`` of the gradients.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mjvideo_tpu import configs as jconfigs
from mjvideo_tpu.data.prompts import ByteTokenizer as JaxByteTokenizer
from mjvideo_tpu.data.prompts import build_video_question
from mjvideo_tpu.data.prompts import prepare_chat_input as jax_prepare
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.train import trainer as jtrainer
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.data.prompts import ByteTokenizer
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.examples import vader_loop
from mjvideo_tpu_torch.parallel.sequence import SequenceGroup
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils.bridge import from_jax_params
from test_torch_train import make_batch, to_torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
BUCKET = 256
FRAMES = 2
CAPTION = "a bright colorful scene"
GRAD_REL_TOL = 1e-4
LR = 1e-3
LEAVES = (
    ("model", "vision_model", "layers", "attn", "qkv", "kernel"),
    ("model", "mlp1", "fc1", "kernel"),
    ("model", "language_model", "layers", "attention", "wq", "kernel"),
    ("model", "language_model", "layers", "attention", "wk", "kernel"),
    ("model", "language_model", "layers", "attention", "wv", "kernel"),
    ("model", "language_model", "layers", "feed_forward", "w1", "kernel"),
    ("regression_layer", "kernel"),
)


def _phi3_96(pkg):
    """``pkg``'s tiny test config with a Phi-3 decoder of 2 heads of 96."""
    base = pkg.tiny_test_config()
    llm = dataclasses.replace(base.chat.llm, architecture="phi3",
                              hidden_size=192, intermediate_size=256,
                              num_attention_heads=2, num_key_value_heads=2,
                              rope_theta=10000.0)
    return dataclasses.replace(base, chat=dataclasses.replace(
        base.chat, llm=llm, template="phi3-chat"))


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _phi3_96(jconfigs), _phi3_96(tconfigs)
    assert cfg_t.chat.llm.head_dim == 96
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jreward.init_reward_params(key, cfg_j))(
            jax.random.PRNGKey(21)))
    return cfg_j, cfg_t, params


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_REL_TOL * np.abs(want).max(),
                               err_msg=name)


# ------------------------------------------------------- the reward gradient

@pytest.fixture(scope="module")
def reward(model):
    """Both scorers with the ``phi3-chat`` gating pattern, one 2-frame
    clip's prompt, and JAX's score with its gradients to the weights and
    the pixels (one compile)."""
    cfg_j, cfg_t, params = model
    tok = ByteTokenizer()
    pattern = tok.gating_pattern("phi3-chat")
    kw = dict(length_buckets=(BUCKET,), gating_pattern=pattern)
    jax_scorer = JaxRewardScorer(cfg_j, params, JaxByteTokenizer(),
                                 attn_impl="xla", dtype=jnp.float32, **kw)
    port = RewardScorer(cfg_t, from_jax_params(params, device="cpu"), tok,
                        dtype=torch.float32, **kw)
    chat = jax_prepare(cfg_j.chat, JaxByteTokenizer(),
                       build_video_question(CAPTION, FRAMES),
                       num_patches_list=[1] * FRAMES, gating_pattern=pattern)
    size = cfg_j.chat.image_size
    pix = np.random.default_rng(21).normal(
        size=(FRAMES, size, size, 3)).astype(np.float32)
    f = jax_scorer.score_fn_with_params(chat.input_ids[0], chat.gating_pos)
    score, (g_params, g_pix) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pix))
    return dict(jax=jax_scorer, port=port, ids=chat.input_ids[0],
                gpos=chat.gating_pos, pix=pix, score=float(score),
                g_params=g_params, g_pix=np.asarray(g_pix))


def test_score_fn_pixel_gradient_at_d96_matches_jax(reward):
    s = reward
    pix = torch.from_numpy(s["pix"]).requires_grad_()
    before = dict(kernels.launch_counts)
    score = s["port"].score_fn(s["ids"], s["gpos"])(pix)
    (grad,) = torch.autograd.grad(score, pix)
    assert kernels.launch_counts == before  # the CPU runs the twins
    np.testing.assert_allclose(score.item(), s["score"], atol=2e-5)
    assert np.abs(s["g_pix"]).max() > 0
    _close(grad.numpy(), s["g_pix"], "pixel gradient")


def test_score_fn_with_params_leaf_gradients_at_d96_match_jax(model, reward):
    """The gradients of the ViT's qkv, ``mlp1``, the Phi-3 decoder's
    wq/wk/wv (its ``qkv_proj`` rows) and w1 (its ``gate_up_proj``'s gate
    rows), each stacked over its layers, and the regression head's."""
    s = reward
    state = from_jax_params(model[2], device="cpu")
    leaves = [_get(state, p).requires_grad_() for p in LEAVES]
    pix = torch.from_numpy(s["pix"]).requires_grad_()
    score = s["port"].score_fn_with_params(s["ids"], s["gpos"])(state, pix)
    grads = torch.autograd.grad(score, leaves + [pix])
    for path, g in zip(LEAVES, grads):
        want = np.asarray(_get(s["g_params"], path))
        assert np.abs(want).max() > 0, path
        _close(g.numpy(), want, "/".join(path))
    _close(grads[-1].numpy(), s["g_pix"], "pixel gradient")


def test_vader_steps_at_d96_match_jax(model, reward):
    """Three Adam steps of the port's loop against the same steps built from
    the JAX example's render, ``score_fn_with_params`` and ``optax.adam``,
    from one numpy-seeded field."""
    s = reward
    size = model[0].chat.image_size
    coarse, lr = 16, 0.05
    field0 = 0.1 * np.random.default_rng(22).normal(
        size=(FRAMES, coarse, coarse, 3)).astype(np.float32)
    spec = importlib.util.spec_from_file_location(
        "jax_vader_loop", REPO / "examples" / "vader_loop.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    _, render = example.make_generator(jax.random.PRNGKey(1), FRAMES, coarse,
                                       size)
    score_fn = s["jax"].score_fn_with_params(s["ids"], s["gpos"])
    opt = optax.adam(lr)

    @jax.jit
    def jax_step(params, field, opt_state):
        loss, grads = jax.value_and_grad(
            lambda f: -score_fn(params, render(f)))(field)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(field, updates), opt_state, -loss

    params = jax.tree.map(jnp.asarray, model[2])
    jfield = jnp.asarray(field0)
    opt_state = opt.init(jfield)
    want = []
    for _ in range(3):
        jfield, opt_state, r = jax_step(params, jfield, opt_state)
        want.append(float(r))

    field = torch.from_numpy(field0.copy()).requires_grad_()
    step = vader_loop.make_step(
        vader_loop.reward_fn(s["port"], FRAMES, CAPTION), field, size, lr)
    got = [float(step()) for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(field.detach().numpy(), np.asarray(jfield),
                               atol=1e-4)


# ------------------------------------------------------------------ training
# ``make_batch``: ``tests/test_torch_train.py``'s ``PairCollator`` layout,
# pairs of 2-frame clips, T = 24 (a whole number of shards of
# ``local(2)``), the last row right-padded.

def _jax_value_and_grad(cfg, params, batch, **kw):
    loss, grads = jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(
        cfg, jtrainer.TrainConfig(attn_impl="xla", **kw))))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), grads


def _port_grads(cfg, params, batch, tc, group=None):
    state = from_jax_params(params, device="cpu")
    opt = ttrainer.make_optimizer(tc, state)
    ttrainer.set_trainable(state, set(opt.paths))
    flat = ttrainer.flatten_state(state)
    loss = ttrainer.make_loss_fn(cfg, tc, group)(state, to_torch(batch))
    return loss.item(), dict(zip(opt.paths, torch.autograd.grad(
        loss, [flat[p] for p in opt.paths])))


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_train_step_at_d96_matches_jax(model, stage):
    """One step: the trainable gradients leaf by leaf, then the loss, grad
    norm and params of ``make_train_step``; frozen leaves bit-identical."""
    cfg_j, cfg_t, params = model
    batch = make_batch(cfg_t, seed=stage)
    kw = dict(stage=stage, learning_rate=LR, total_steps=4)
    jloss, jgrads = _jax_value_and_grad(cfg_j, params, batch, **kw)
    want_g = ttrainer.flatten_state(from_jax_params(
        jax.tree.map(np.asarray, jgrads), device="cpu"))
    tc = ttrainer.TrainConfig(**kw)
    loss, grads = _port_grads(cfg_t, params, batch, tc)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[path].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=path)

    jopt = jtrainer.make_optimizer(jtrainer.TrainConfig(attn_impl="xla", **kw),
                                   params)

    @jax.jit
    def jax_update(p, g):
        return optax.apply_updates(p, jopt.update(g, jopt.init(p), p)[0])

    want_p = ttrainer.flatten_state(from_jax_params(jax.tree.map(
        np.asarray, jax_update(jax.tree.map(jnp.asarray, params), jgrads)),
        device="cpu"))
    tp = from_jax_params(params, device="cpu")
    topt = ttrainer.make_optimizer(tc, tp)
    tp1, _, metrics = ttrainer.make_train_step(cfg_t, tc, topt)(
        tp, topt.init(tp), to_torch(batch))
    np.testing.assert_allclose(metrics["loss"].item(), jloss, rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(optax.global_norm(jgrads)), rtol=1e-4)
    clip = min(1.0, tc.max_grad_norm / float(optax.global_norm(jgrads)))
    before = ttrainer.flatten_state(from_jax_params(params, device="cpu"))
    moved = False
    for path, t in ttrainer.flatten_state(tp1).items():
        got = t.detach().numpy()
        off = np.abs(got - want_p[path].numpy()) > 2e-6
        if off.any():  # only where the clipped gradient is near Adam's eps
            assert clip * np.abs(want_g[path].numpy()[off]).max() < 1e-6, \
                path
            assert np.abs(got - want_p[path].numpy()).max() <= 2 * LR, path
        if path in topt.paths:
            moved = moved or not np.array_equal(got, before[path].numpy())
        else:
            np.testing.assert_array_equal(got, before[path].numpy())
    assert moved


def test_accumulating_two_batches_at_d96_matches_one_concatenated_batch(
        model):
    """k = 2 micro-steps == one step on the concatenated batch, and nothing
    moves before the window closes."""
    _, cfg, params = model
    b1, b2 = make_batch(cfg, seed=4), make_batch(cfg, seed=5)
    full = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
    kw = dict(stage=1, learning_rate=LR, total_steps=4, schedule="none")
    tc_f = ttrainer.TrainConfig(**kw)
    p_full = from_jax_params(params, device="cpu")
    opt_f = ttrainer.make_optimizer(tc_f, p_full)
    ttrainer.make_train_step(cfg, tc_f, opt_f)(p_full, opt_f.init(p_full),
                                               to_torch(full))
    tc_a = ttrainer.TrainConfig(gradient_accumulation_steps=2, **kw)
    p_acc = from_jax_params(params, device="cpu")
    opt_a = ttrainer.make_optimizer(tc_a, p_acc)
    step = ttrainer.make_train_step(cfg, tc_a, opt_a)
    p_acc, st, _ = step(p_acc, opt_a.init(p_acc), to_torch(b1))
    before = ttrainer.flatten_state(from_jax_params(params, device="cpu"))
    for path, t in ttrainer.flatten_state(p_acc).items():
        assert torch.equal(t.detach(), before[path]), path
    p_acc, st, _ = step(p_acc, st, to_torch(b2))
    assert st["mini_step"] == 0 and st["gradient_step"] == 1
    ref = ttrainer.flatten_state(p_full)
    moved = 0
    for path, t in ttrainer.flatten_state(p_acc).items():
        rel = ((t - ref[path]).norm() / (ref[path].norm() + 1e-12)).item()
        assert rel < 5e-5, (path, rel)
        moved += not torch.equal(t.detach(), before[path])
    assert moved


def test_ring_training_micro_batch_at_d96_matches_jax_without_sp(
        model, tmp_path):
    """The stage-3 loss and trainable gradient with ``sp="ring"`` over
    ``local(2)`` (K3 lse's twin at D = 96 for each ring step, K4a/K4b's at
    each chunk offset) against ``jax.grad`` of JAX's loss without sequence
    parallelism; then one ``Trainer`` micro-step (accumulation 2) holds
    that gradient in its accumulation buffer."""
    cfg_j, cfg_t, params = model
    batch = make_batch(cfg_t, seed=6)
    kw = dict(stage=3, learning_rate=LR, total_steps=4)
    jloss, jgrads = _jax_value_and_grad(cfg_j, params, batch, **kw)
    want = ttrainer.flatten_state(from_jax_params(
        jax.tree.map(np.asarray, jgrads), device="cpu"))
    tc = ttrainer.TrainConfig(sp="ring", gradient_accumulation_steps=2,
                              checkpoint_dir=str(tmp_path), **kw)
    group = SequenceGroup.local(2)
    loss, grads = _port_grads(cfg_t, params, batch, tc, group)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=path)
    trainer = ttrainer.Trainer(cfg_t, from_jax_params(params, device="cpu"),
                               tc, sp_group=group)
    trainer.train([batch])
    assert trainer.opt_state["gradient_step"] == 0
    for path, g in grads.items():
        np.testing.assert_allclose(trainer.opt_state["acc"][path].numpy(),
                                   g.numpy(), atol=1e-7, err_msg=path)
