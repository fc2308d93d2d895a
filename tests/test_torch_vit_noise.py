"""The ViT's training noise (DropPath and projection dropout) against the
JAX package, and the port's own draw (``models/vit.py`` ``NoiseKey``).

``tiny_test_config`` in fp32 on the CPU with ``drop_path_rate = 0.1`` and
``dropout = 0.1``.  The port cannot draw JAX's threefry bits, so the math
is held with the masks fixed in both packages: the test monkeypatches
``mjvideo_tpu.models.vit._drop_path`` / ``_dropout`` and the port's
counterparts with the same fixed patterns (a tile's DropPath mask a
function of its index, the layer, read back from its rate, and the branch;
the dropout mask a function of the element's index), so the tower runs
each package's own block.  Tolerances: the tower's output atol 2e-5 (the
fp32 ViT of ``tests/test_torch_models.py`` summed in other orders, the
masks scaling by 1 / 0.9); the port's own draws bit-equal where they must
repeat (the same step, the recompute, the sharded tower's masks); the
rates to two fp32 ulps of JAX's ``jnp.linspace`` (the reference's
``torch.linspace`` decides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.models import vit as jvit
from mjvideo_tpu_torch.models import internvl as tinternvl
from mjvideo_tpu_torch.models import vit as tvit
from mjvideo_tpu_torch.parallel.sequence import SequenceGroup
from mjvideo_tpu_torch.train import trainer as ttrainer
from mjvideo_tpu_torch.utils.bridge import from_jax_params
from test_torch_train import make_batch

torch.set_num_threads(1)
DROP_PATH, DROPOUT = 0.1, 0.1


def noisy(cfg, drop_path=DROP_PATH, dropout=DROPOUT, attention_dropout=0.0):
    vision = dataclasses.replace(cfg.chat.vision, drop_path_rate=drop_path,
                                 dropout=dropout,
                                 attention_dropout=attention_dropout)
    return dataclasses.replace(cfg, chat=dataclasses.replace(cfg.chat,
                                                             vision=vision))


@pytest.fixture(scope="module")
def setup():
    cfg = noisy(tiny_test_config())
    params = jax.jit(lambda key: jreward.init_reward_params(key, cfg))(
        jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


def pixels(cfg, n, seed=0):
    size = cfg.chat.vision.image_size
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _fixed_masks(L):
    """The fixed-mask ``_drop_path`` / ``_dropout`` of both packages: the
    branch is the call's parity (each block calls the attention branch,
    then the MLP one), the layer is read back from the rate."""
    calls = {"jax": 0, "torch": 0}

    def layer_of(rate, rnd):
        return rnd(rate * (L - 1) / DROP_PATH)

    def jax_drop_path(x, rate, key):
        branch = calls["jax"] % 2
        calls["jax"] += 1
        layer = layer_of(rate, lambda r: jnp.round(r).astype(jnp.int32))
        b = jnp.arange(x.shape[0])
        mask = ((b + layer + branch) % 3 != 0)[:, None, None]
        return jnp.where(mask, x.astype(jnp.float32) / (1.0 - rate),
                         0.0).astype(x.dtype)

    def jax_dropout(x, rate, key):
        b, s, c = jnp.meshgrid(*(jnp.arange(n) for n in x.shape),
                               indexing="ij")
        mask = (b * 7 + s * 3 + c) % 5 != 0
        return jnp.where(mask, x.astype(jnp.float32) / (1.0 - rate),
                         0.0).astype(x.dtype)

    def torch_drop_path(x, rate, key):
        branch = calls["torch"] % 2
        calls["torch"] += 1
        layer = layer_of(rate, lambda r: int(round(r)))
        b = torch.arange(x.shape[0])
        mask = ((b + layer + branch) % 3 != 0)[:, None, None]
        keep = float(np.float32(1.0) - np.float32(rate))
        return torch.where(mask, x.float() / keep, 0.0).to(x.dtype)

    def torch_dropout(x, rate, key):
        b, s, c = torch.meshgrid(*(torch.arange(n) for n in x.shape),
                                 indexing="ij")
        mask = (b * 7 + s * 3 + c) % 5 != 0
        keep = float(np.float32(1.0) - np.float32(rate))
        return torch.where(mask, x.float() / keep, 0.0).to(x.dtype)

    return jax_drop_path, jax_dropout, torch_drop_path, torch_dropout


@pytest.mark.parametrize("select_layer", [-1, -2])
def test_noise_math_matches_jax_with_fixed_masks(setup, monkeypatch,
                                                 select_layer):
    """DropPath on both branches, dropout before LayerScale, the rates of
    the full depth (a cut tower keeps each layer's rate)."""
    cfg, params = setup
    vis = cfg.chat.vision
    jdp, jdo, tdp, tdo = _fixed_masks(vis.num_hidden_layers)
    monkeypatch.setattr(jvit, "_drop_path", jdp)
    monkeypatch.setattr(jvit, "_dropout", jdo)
    monkeypatch.setattr(tvit, "_drop_path", tdp)
    monkeypatch.setattr(tvit, "_dropout", tdo)
    pix = pixels(cfg, 3)
    vparams = params["model"]["vision_model"]
    want = jax.jit(lambda p, x: jvit.vit_forward(
        p, vis, x, select_layer=select_layer, attn_impl="xla", remat=False,
        rng=jax.random.PRNGKey(0)))(vparams, jnp.asarray(pix))
    plain = jax.jit(lambda p, x: jvit.vit_forward(
        p, vis, x, select_layer=select_layer, attn_impl="xla",
        remat=False))(vparams, jnp.asarray(pix))
    got = tvit.vit_forward(from_jax_params(vparams, device="cpu"), vis,
                           torch.from_numpy(pix), select_layer=select_layer,
                           remat=False, rng=tvit.NoiseKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # The masks bite: the noisy tower is not the eval one.
    assert np.abs(np.asarray(want) - np.asarray(plain)).max() > 1e-3


def test_rates_follow_the_full_depth(setup, monkeypatch):
    cfg, params = setup
    vis = cfg.chat.vision
    L = vis.num_hidden_layers
    for n in (1, 2, 7, 24, 45):
        np.testing.assert_allclose(
            tvit.drop_path_rates(0.1, n),
            np.asarray(jnp.linspace(0.0, 0.1, n)), rtol=2.4e-7, atol=0)
    seen = []
    real = tvit._drop_path

    def record(x, rate, key):
        seen.append((rate, key.path))
        return real(x, rate, key)

    monkeypatch.setattr(tvit, "_drop_path", record)
    tvit.vit_forward(from_jax_params(params["model"]["vision_model"],
                                     device="cpu"), vis,
                     torch.from_numpy(pixels(cfg, 2)), select_layer=-2,
                     remat=False, rng=tvit.NoiseKey(5).fold_in(9))
    rates = tvit.drop_path_rates(DROP_PATH, L)
    assert seen == [(float(rates[i]), (9, i, branch))
                    for i in range(L - 1) for branch in (0, 1)]


def test_port_draws_are_a_function_of_the_key(setup):
    """The same key gives the same output; another step, another video or
    another tile index gives other masks; dropout keeps about 90%."""
    cfg, params = setup
    vis = cfg.chat.vision
    vp = from_jax_params(params["model"]["vision_model"], device="cpu")
    pix = torch.from_numpy(pixels(cfg, 2))

    def run(key):
        return tvit.vit_forward(vp, vis, pix, remat=False, rng=key)

    key = tvit.NoiseKey(0).fold_in(3, 0)
    a, b = run(key), run(key)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(tvit.NoiseKey(0).fold_in(4, 0)))
    assert not torch.equal(a, run(tvit.NoiseKey(0).fold_in(3, 1)))
    shifted = run(key.starting_at(1))
    assert not torch.equal(a[0], shifted[0])
    x = torch.ones(4, 64, 64)
    kept = (tvit._dropout(x, 0.1, key) != 0).float().mean().item()
    assert 0.88 < kept < 0.92
    assert torch.equal(tvit._dropout(x, 0.1, key), tvit._dropout(x, 0.1, key))
    dp = tvit._drop_path(x, 0.5, key)
    assert set(dp.reshape(4, -1)[:, 0].tolist()) <= {0.0, 2.0}


@pytest.mark.parametrize("remat", [True, "dots"])
def test_recompute_draws_the_first_forwards_masks(setup, remat):
    """Under remat the backward runs each block's forward again; its masks
    come from generators seeded afresh from the key, so the gradient is
    the one without remat, to the bit."""
    cfg, params = setup
    vis = cfg.chat.vision
    pix = pixels(cfg, 2)
    grads = []
    for r in (False, remat):
        vp = from_jax_params(params["model"]["vision_model"], device="cpu")
        leaves = list(ttrainer.flatten_state(vp["layers"]).values())
        for t in leaves:
            t.requires_grad_(True)
        x = torch.from_numpy(pix).requires_grad_(True)
        out = tvit.vit_forward(vp, vis, x, remat=r,
                               rng=tvit.NoiseKey(0).fold_in(1, 0))
        w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        grads.append(torch.autograd.grad((out * w).sum(), [x] + leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_sharded_tower_draws_the_whole_towers_masks(setup, monkeypatch):
    """The tile-sharded tower over a local 2-member group (3 tiles padded
    to 4) keys each tile by its global index: the masks are the whole
    tower's, and so are the embeds."""
    cfg, params = setup
    drawn = {"whole": {}, "sharded": {}}
    into = {"at": None}
    real = tvit._bernoulli

    def record(key, keep, shape, device):
        mask = real(key, keep, shape, device)
        for b in range(shape[0]):
            drawn[into["at"]][key.path, key.tile0 + b] = mask[b].clone()
        return mask

    monkeypatch.setattr(tvit, "_bernoulli", record)
    chat = from_jax_params(params["model"], device="cpu")
    pix = torch.from_numpy(pixels(cfg, 3))
    key = tvit.NoiseKey(0).fold_in(2, 1)
    into["at"] = "whole"
    whole = tinternvl.extract_feature(chat, cfg.chat, pix, remat=False,
                                      vit_rng=key)
    into["at"] = "sharded"
    sharded = tinternvl.extract_feature(
        chat, cfg.chat, pix, remat=False, vit_rng=key,
        sp={"group": SequenceGroup.local(2), "kind": "ring"})
    assert set(drawn["whole"]) <= set(drawn["sharded"])
    for k, mask in drawn["whole"].items():
        assert torch.equal(mask, drawn["sharded"][k]), k
    np.testing.assert_allclose(sharded.numpy(), whole.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_attention_dropout_raises(setup):
    cfg, params = setup
    vis = noisy(cfg, attention_dropout=0.1).chat.vision
    vp = from_jax_params(params["model"]["vision_model"], device="cpu")
    with pytest.raises(ValueError, match="attention_dropout"):
        tvit.vit_forward(vp, vis, torch.from_numpy(pixels(cfg, 1)),
                         rng=tvit.NoiseKey(0))
    # Eval (no key) ignores the training rates, as in JAX.
    tvit.vit_forward(vp, vis, torch.from_numpy(pixels(cfg, 1)), remat=False)


def test_trainer_noise_is_keyed_by_the_step(setup, tmp_path):
    """A Trainer with DropPath and dropout: its first loss is not the
    noise-free one, and train(2) equals train(1) + save + resume +
    train(1) to the bit (the key depends on the step number alone)."""
    cfg, params = setup
    batches = [make_batch(cfg, B=1, frames=1, seed=70 + i) for i in range(2)]

    def make(name, c=cfg):
        tc = ttrainer.TrainConfig(stage=3, learning_rate=1e-3, total_steps=4,
                                  log_every=1, checkpoint_every=10**9,
                                  checkpoint_dir=str(tmp_path / name))
        return ttrainer.Trainer(c, from_jax_params(params, device="cpu"), tc)

    whole = make("a")
    first = whole.train(iter(batches[:1]))
    whole.train(iter(batches[1:]))
    quiet = make("quiet", noisy(cfg, 0.0, 0.0)).train(iter(batches[:1]))
    assert first["loss"] != quiet["loss"]
    part = make("b")
    part.train(iter(batches[:1]))
    part.save()
    resumed = make("b")
    resumed.resume_latest()
    resumed.train(iter(batches[1:]))
    want = ttrainer.flatten_state(whole.params)
    for p, t in ttrainer.flatten_state(resumed.params).items():
        assert torch.equal(t, want[p]), p
