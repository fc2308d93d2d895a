"""K2r's bound column and the build of the Hopper decoder-attention template,
on the CPU.

``key_norm_cummax`` (the plain twin of K2r's pre-pass kernel) is held
against the JAX package's row-bound arithmetic (``_fwd_impl``,
``mjvideo_tpu/ops/flash_attention.py:489-508``) written out in ``jnp`` on
the same numpy inputs, and ``row_key_bound`` built on it against the form
it had before the pre-pass existed.  The K2r and K3 twins are held against
``flash_attention(norm_bound="rows" | False)`` in Pallas interpret mode at
the new template's tile edges.  Tolerances: the key norms are fp32 sums of
squares taken in another order than XLA's, so relative 1e-6; the running
max and the gather are exact, so equal structure; the attention twins atol
2e-5, as ``tests/test_torch_flash_attention.py`` holds them.  The kernels
themselves run only on the card (``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.ops.flash_attention import flash_attention
from mjvideo_tpu_torch import kernels
from mjvideo_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# (B, K, Q, Hq, Hkv, D, q_offset per row or None, mask kind): odd K with
# GQA and a left-padded row with holes; offsets whose positions run past
# K - 1 (clipped high) and below 0 (clipped low); MHA unmasked with K one
# key past a 128-key tile.
BOUND_CASES = {
    "odd_k_gqa": (2, 131, 131, 8, 2, 16, None, "holes"),
    "clips_high": (2, 77, 40, 4, 2, 16, (60, 50), "holes"),
    "clips_low": (2, 77, 40, 4, 2, 16, (-30, -5), "holes"),
    "mha_past_a_tile": (1, 129, 129, 4, 4, 16, None, None),
}


def _bound_inputs(case):
    B, K, Q, Hq, Hkv, D, off, kind = BOUND_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(B, Q, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    # Varied key norms, so the running max steps up along K.
    k *= rng.uniform(0.2, 3.0, size=(B, K, Hkv, 1)).astype(np.float32)
    v = rng.normal(size=(B, K, Hkv, D)).astype(np.float32)
    mask = None
    if kind == "holes":
        mask = (rng.uniform(size=(B, K)) > 0.25).astype(np.int32)
        mask[-1, :9] = 0
    off = None if off is None else np.asarray(off, np.int32)
    return q, k, v, mask, off


def _jax_row_bound(k, mask, off, Q, Hq):
    """``_fwd_impl``'s row-bound arithmetic on (B, K, Hkv, D) inputs:
    ``kcum`` (B, Hkv, K) and the (B, Hq, Q) column."""
    B, K, Hkv, _ = k.shape
    G = Hq // Hkv
    k32 = jnp.transpose(jnp.asarray(k), (0, 2, 1, 3))  # (B, Hkv, K, D)
    kn2 = jnp.sum(k32 * k32, axis=-1)
    m = jnp.ones((B, K), jnp.int32) if mask is None else jnp.asarray(mask)
    kn2 = kn2 * (m != 0)[:, None, :].astype(jnp.float32)
    kcum = jax.lax.cummax(jnp.sqrt(kn2), axis=2)
    rep = jnp.repeat(kcum, G, axis=1)
    o = jnp.zeros((B, 1), jnp.int32) if off is None else jnp.asarray(
        off).reshape(-1, 1)
    pos = jnp.clip(o + jnp.arange(Q)[None, :], 0, K - 1)
    col = jnp.take_along_axis(
        rep, jnp.broadcast_to(pos[:, None, :], (B, Hq, Q)), axis=2)
    return np.asarray(kcum), np.asarray(col)


def _former_row_key_bound(k, attention_mask, q_offset, q_len, q_heads):
    """``row_key_bound`` as it was before ``key_norm_cummax`` existed."""
    B, K, Hkv = k.shape[:3]
    kn2 = k.float().square().sum(-1)
    if attention_mask is not None:
        kn2 = kn2 * (attention_mask != 0)[:, :, None].float()
    kcum = torch.cummax(kn2.sqrt(), dim=1).values.transpose(1, 2)
    off = (torch.zeros(B, dtype=torch.long, device=k.device)
           if q_offset is None else q_offset.long().reshape(-1).expand(B))
    pos = (off[:, None] + torch.arange(q_len, device=k.device)).clamp(0, K - 1)
    rows = kcum.gather(2, pos[:, None, :].expand(B, Hkv, q_len))
    return rows.repeat_interleave(q_heads // Hkv, dim=1).contiguous()


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_key_norm_cummax_twin_matches_jax_row_bound(case):
    """The pre-pass twin's (B, Hkv, K) running max and the (B, Hq, Q)
    column built on it against ``_fwd_impl``'s ``kcum`` and gathered
    ``kmax``, offsets clipped at both ends."""
    q, k, _, mask, off = _bound_inputs(case)
    Q, Hq = q.shape[1], q.shape[2]
    want_kcum, want_col = _jax_row_bound(k, mask, off, Q, Hq)
    kcum = tfa.key_norm_cummax(_t(k), _t(mask))
    assert kcum.shape == want_kcum.shape and kcum.dtype == torch.float32
    np.testing.assert_allclose(kcum.numpy(), want_kcum, rtol=1e-6, atol=0)
    assert np.all(np.diff(kcum.numpy(), axis=-1) >= 0)
    col = tfa.row_key_bound(_t(k), _t(mask), _t(off), Q, Hq)
    np.testing.assert_allclose(col.numpy(), want_col, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_row_key_bound_on_the_pre_pass_twin_is_unchanged(case):
    """``row_key_bound``, now a gather of ``key_norm_cummax``, gives the
    former implementation's numbers bit for bit."""
    q, k, _, mask, off = _bound_inputs(case)
    Q, Hq = q.shape[1], q.shape[2]
    got = tfa.row_key_bound(_t(k), _t(mask), _t(off), Q, Hq)
    want = _former_row_key_bound(_t(k), _t(mask), _t(off), Q, Hq)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
@pytest.mark.parametrize("norm_bound", [False, "rows"])
def test_k3_and_k2r_twins_match_pallas_at_tile_edges(case, norm_bound):
    """The K3 and K2r twins (what the CPU path of ``exact_attention`` and
    ``decoder_attention_rows`` computes) against the JAX kernels through
    ``flash_attention`` at the cases above: K one key past a 128-key tile,
    Q = 129 (one row past a 128-row q tile), offsets clipped at both ends;
    a row that sees no key is 0 in both."""
    q, k, v, mask, off = _bound_inputs(case)
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = np.asarray(flash_attention(J(q), J(k), J(v), attention_mask=J(mask),
                                     causal=True, q_offset=J(off),
                                     norm_bound=norm_bound))
    fn = tfa.decoder_attention_rows if norm_bound else tfa.exact_attention
    got = fn(_t(q), _t(k), _t(v), _t(mask), _t(off)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    dead = ~tfa._decoder_allowed(_t(q), _t(k), _t(mask), _t(off)).any(-1)
    assert np.all(got[dead.numpy()] == 0.0)


def test_every_csrc_file_is_in_the_build_hash():
    """A source or header that ``kernels.build`` does not hash would leave
    a stale library in place when it changes."""
    on_disk = {p.name for p in kernels.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    named = set(kernels.SOURCES) | set(kernels.HEADERS)
    assert on_disk == named
    assert set(kernels.SOURCES).isdisjoint(kernels.HEADERS)
    assert "decoder_attention_sm90.cuh" in kernels.HEADERS


def test_k2r_pre_pass_is_counted_under_its_own_name():
    """K2r's launches and its pre-pass's are two counters, both reset."""
    assert {"decoder_attention_rows", "key_norm_cummax"} <= set(
        kernels.launch_counts)
    kernels.launch_counts["key_norm_cummax"] = 3
    kernels.reset_launch_counts()
    assert kernels.launch_counts["key_norm_cummax"] == 0
