"""Plain twins of B1, B2 and B3 (the ViT attention variants of the JAX
package's A/B harnesses) against the Pallas kernels, and the port's ViT
block with each twin swapped in against the JAX harness's copy of it.

``benchmarks/`` is not a package: both harnesses load by path.  B1
(``variant_impl``) has no ``interpret`` argument and runs under
``pltpu.force_tpu_interpret_mode()``; B2 (``tmajor_impl``) and B3
(``nc_bshd_attention``) run with ``interpret=True``.  Inputs come from one
numpy generator and run in fp32.  Tolerances: atol 2e-5 where both sides
compute the same fp32 sums in another order (the bar of
``tests/test_torch_flash_attention.py``).  B1's ``bf16s`` mode rounds the
logits, ``s - m`` and ``p`` to bf16; XLA on the CPU may keep ``s - m`` and
the exp in fp32, and the Pallas kernel takes the pad keys' zero logits into
its max where the twin masks them, so the two differ by about one bf16 ulp
of p: held to 2**-8 of max|JAX| (half the 2**-7 bar the card holds each
kernel to).  The CUDA kernels run only on the card: ``chip_smoke.py``
phase 21 and ``tests/test_torch_kernels.py`` hold them against these
twins there.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.models import vit as jvit
from mjvideo_tpu.ops.flash_attention import flash_attention
from mjvideo_tpu_torch.models import vit as tvit
from mjvideo_tpu_torch.ops import vit_attention_variants as tva
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "benchmarks"
ATOL = 2e-5
BF16S_REL = 2 ** -8


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_bench_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def variants():
    return _load("vit_attn_variants")


@pytest.fixture(scope="module")
def layout():
    return _load("vit_layout_ab")


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _b1_jax(variants, q, k, v, mode):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(variants.variant_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mode=mode))


def _assert_bar(got, want, mode):
    if mode == "bf16s":
        err = float(np.abs(got - want).max())
        assert err <= BF16S_REL * float(np.abs(want).max()), err
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("S", [65, 64])
@pytest.mark.parametrize("mode", ["exp2", "bf16s", "nomax", "exp2_nomax"])
def test_b1_twin_matches_pallas_variant(variants, mode, S):
    """S = 65 takes the TPU kernel's pad path (7 zero keys, their mass
    subtracted from l), S = 64 none."""
    q, k, v = _qkv(S, (1, S, 2, 64))
    want = _b1_jax(variants, q, k, v, mode)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tva.variant_attention_plain(tq, tk, tv, mode)
    _assert_bar(got.numpy(), want, mode)
    # The dispatcher computes the twin on a CPU tensor.
    np.testing.assert_array_equal(
        tva.variant_attention(tq, tk, tv, mode).numpy(), got.numpy())


@pytest.mark.parametrize("S", [65, 64])
@pytest.mark.parametrize("hp", [1, 2])
def test_b2_twin_matches_pallas_tmajor(variants, hp, S):
    q, k, v = _qkv(10 + S, (2, S, 4, 64))
    want = np.asarray(variants.tmajor_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hp=hp,
        interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tva.tmajor_attention_plain(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(
        tva.tmajor_attention(tq, tk, tv, hp=hp).numpy(), got.numpy())


@pytest.mark.parametrize("B,S,H,D,valid", [(2, 64, 4, 32, None),
                                           (1, 128, 2, 64, 101),
                                           (2, 256, 8, 64, 250)])
def test_b3_twin_matches_pallas_bshd(layout, B, S, H, D, valid):
    """The three shapes of the JAX harness's own ``check()``: k/v rows at
    or past ``kv_valid`` zero, as its contract requires."""
    q, k, v = _qkv(S, (B, S, H, D))
    if valid is not None:
        k[:, valid:] = 0.0
        v[:, valid:] = 0.0
    want = np.asarray(layout.nc_bshd_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_valid=valid,
        interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tva.bshd_attention_plain(tq, tk, tv, valid)
    assert got.shape == (B, S, H * D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(
        tva.bshd_attention(tq, tk, tv, valid).numpy(), got.numpy())
    if valid is not None:
        # The twin never reads the keys past kv_valid.
        tk[:, valid:] = float("nan")
        tv[:, valid:] = float("nan")
        np.testing.assert_array_equal(
            tva.bshd_attention_plain(tq, tk, tv, valid).numpy(), got.numpy())


def test_dispatchers_refuse_what_no_kernel_takes():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError, match="mode"):
        tva.variant_attention(q, q, q, "exp")
    with pytest.raises(ValueError, match="divide"):
        tva.tmajor_attention(q, q, q, hp=3)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="kv_valid"):
            tva.bshd_attention(q, q, q, kv_valid=bad)
    assert tva.TMAJOR_HP == (1, 2, 4)
    assert tva.VARIANT_MODES == ("exp2", "bf16s", "nomax", "exp2_nomax")


# ------------------------------------------------------- the ViT block A/B

@pytest.fixture(scope="module")
def block_setup():
    """Layer 0 of the tiny config's ViT (fp32, seed 0) in both packages,
    with norms and biases moved off their init so each reaches the
    output."""
    cfg = tiny_test_config().chat.vision
    layers = jax.jit(lambda key: jvit.init_vit_params(key, cfg))(
        jax.random.PRNGKey(0))["layers"]
    rng = np.random.default_rng(3)
    p = jax.tree.map(lambda a: np.asarray(a[0]), layers)
    p = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(a.dtype)
                     * 0.05 if a.ndim == 1 else a, p)
    state = from_jax_params(p, device="cpu")
    return cfg, p, state


def _zero_past(t, valid):
    ok = (torch.arange(t.shape[1]) < valid).to(t.dtype)[None, :, None, None]
    return t * ok


BLOCK_VARIANTS = ["exp2", "bf16s", "nomax", "exp2_nomax", "tmajor_hp1",
                  "tmajor_hp2", "bshd_pad", "k1"]


def _attentions(name, variants, layout, valid):
    """(JAX attention for ``make_block_fn``, port attention for
    ``_block``)."""
    if name in tva.VARIANT_MODES:
        def jattn(q, k, v, _):
            with pltpu.force_tpu_interpret_mode():
                return variants.variant_impl(q, k, v, mode=name)
        return jattn, lambda q, k, v: tva.variant_attention(q, k, v, name)
    if name.startswith("tmajor"):
        hp = int(name[-1])
        return (lambda q, k, v, _: variants.tmajor_impl(q, k, v, hp=hp,
                                                        interpret=True),
                lambda q, k, v: tva.tmajor_attention(q, k, v, hp=hp))
    if name == "bshd_pad":
        return (lambda q, k, v, sv: layout.nc_bshd_attention(
                    q, k, v, kv_valid=sv, interpret=True),
                lambda q, k, v: tva.bshd_attention(
                    q, _zero_past(k, valid), _zero_past(v, valid), valid))
    # K1, the production attention, through the block's default.
    return (lambda q, k, v, sv: flash_attention(q, k, v, kv_valid=sv,
                                                norm_bound=True), None)


@pytest.mark.parametrize("name", BLOCK_VARIANTS)
def test_block_with_each_twin_matches_jax_block(block_setup, variants, layout,
                                                name):
    """``_block`` with the twin swapped in against ``make_block_fn`` with
    the matching Pallas kernel.  B3 runs at the tiny tile's 17 tokens
    pre-padded to 24 with ``kv_valid`` 17, as the JAX harness runs it at
    1025 -> 1032; the others at 17."""
    cfg, p, state = block_setup
    valid = (cfg.image_size // cfg.patch_size) ** 2 + 1
    S = 24 if name == "bshd_pad" else valid
    x = np.random.default_rng(7).normal(
        size=(2, S, cfg.hidden_size)).astype(np.float32)
    jattn, tattn = _attentions(name, variants, layout, valid)
    block = layout.make_block_fn(cfg, p, jattn)
    want = np.asarray(block(jnp.asarray(x), valid))
    got = tvit._block(cfg, state, torch.from_numpy(x), "auto",
                      attention=tattn).numpy()
    if name == "bf16s":
        delta = np.asarray(want) - x
        err = float(np.abs(got - want).max())
        assert err <= BF16S_REL * float(np.abs(delta).max()), err
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)
    if name == "k1":
        # None is the production path itself, call for call.
        prod = tvit._block(cfg, state, torch.from_numpy(x), "auto")
        np.testing.assert_array_equal(prod.numpy(), got)

