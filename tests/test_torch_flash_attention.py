"""Plain twins of K1 and K2 against the JAX Pallas kernels in interpret mode.

The JAX side runs ``flash_attention`` as the JAX package's own tests do on
the CPU (Pallas interpret mode).  Inputs come from one numpy generator and
run in fp32.  Tolerance atol 2e-5: both sides compute the same bound-shifted
sums in fp32 in different orders, the JAX package's own kernel-vs-XLA bar
(``tests/test_flash_attention.py``).  The CUDA kernels themselves run only on
the card: ``chip_smoke.py`` and ``tests/test_torch_kernels.py`` compare them
with these twins there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import flash_attention
from mjvideo_tpu_torch.ops import flash_attention as tfa
from mjvideo_tpu_torch.ops.attention import multi_head_attention

torch.set_num_threads(1)


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("S", [37, 65])
def test_k1_twin_matches_pallas_nc_kernel_with_kv_valid_tail(S):
    """The JAX ViT path pre-pads to 8 rows, zeroes the tail of k/v and
    declares ``kv_valid``; the port takes S as it is."""
    rng = np.random.default_rng(S)
    B, H, D = 2, 2, 32
    Sp = -(-S // 8) * 8
    q = _rand(rng, (B, Sp, H, D))
    k = _rand(rng, (B, Sp, H, D))
    v = _rand(rng, (B, Sp, H, D))
    k[:, S:] = 0.0
    v[:, S:] = 0.0
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, kv_valid=S, norm_bound=True)
    got = tfa.vit_attention(torch.from_numpy(q[:, :S]),
                            torch.from_numpy(k[:, :S]),
                            torch.from_numpy(v[:, :S]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :S], atol=2e-5)
    # The same call through the dispatch point.
    via = multi_head_attention(torch.from_numpy(q[:, :S]),
                               torch.from_numpy(k[:, :S]),
                               torch.from_numpy(v[:, :S]), causal=False)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_k2_twin_matches_pallas_bound_kernel_with_gqa_and_dead_rows():
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, D = 3, 67, 4, 2, 16
    q = _rand(rng, (B, S, Hq, D))
    k = _rand(rng, (B, S, Hkv, D))
    v = _rand(rng, (B, S, Hkv, D))
    mask = np.ones((B, S), np.int32)
    mask[1, S - 23:] = 0            # ragged right padding
    mask[2, :4] = 0                 # left padding: rows 0-3 see no key
    mask[2, 50:] = 0
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          attention_mask=jnp.asarray(mask), causal=True,
                          norm_bound=True)
    got = tfa.decoder_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    assert np.all(got.numpy()[2, :4] == 0.0)
    assert np.all(np.asarray(ref)[2, :4] == 0.0)
    via = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               attention_mask=torch.from_numpy(mask),
                               causal=True)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_k2_twin_honours_q_offset():
    """A suffix of queries at a per-row offset sees the same keys as those
    rows of the full self-attention."""
    rng = np.random.default_rng(5)
    B, S, Hq, Hkv, D = 2, 40, 4, 2, 16
    q = torch.from_numpy(_rand(rng, (B, S, Hq, D)))
    k = torch.from_numpy(_rand(rng, (B, S, Hkv, D)))
    v = torch.from_numpy(_rand(rng, (B, S, Hkv, D)))
    full = tfa.decoder_attention_plain(q, k, v)
    off = torch.tensor([10, 25], dtype=torch.int32)
    for b in range(B):
        o = int(off[b])
        part = tfa.decoder_attention_plain(q[b:b + 1, o:o + 8], k[b:b + 1],
                                           v[b:b + 1], q_offset=off[b:b + 1])
        torch.testing.assert_close(part, full[b:b + 1, o:o + 8],
                                   atol=1e-6, rtol=1e-6)


def test_wrappers_raise_for_kernel_less_shapes_and_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError):
        multi_head_attention(q, k, k, causal=False)  # non-causal GQA: K3
    with pytest.raises(ValueError):
        multi_head_attention(q, q, q, impl="flash")
