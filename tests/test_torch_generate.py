"""The port's cached generation against the JAX package's, fp32 on the CPU.

One tiny chat state with the LM head (JAX's ``init_chat_params`` through
``from_jax_params``) runs through both.  JAX runs its XLA path
(``attn_impl="auto"`` off the TPU); the port runs ``impl="auto"``, whose
kernel wrappers compute the K3 twin on the CPU, so both take the exact
softmax.  Tolerances: hidden states and logits atol 1e-4 (fp32 sums in
other orders through two layers and a 272-way head).  Greedy tokens must be
equal where JAX's top-2 logit margin exceeds 1e-3; the seeds below have
such margins at every step (``_assert_margins``), so the token checks are
complete.  Per-step logits are teacher-forced on JAX's tokens: the port's
``teacher_tokens``, and on the JAX side the same prefill and steps built
from its ``decoder_forward_cached`` and ``lm_logits``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data.prompts import ByteTokenizer
from mjvideo_tpu.models import decoder as jdec
from mjvideo_tpu.models import generate as jgen
from mjvideo_tpu.models.internvl import init_chat_params
from mjvideo_tpu_torch.models import generate as tgen
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
ATOL = 1e-4
MARGIN = 1e-3
NEW = 6


@pytest.fixture(scope="module")
def setup():
    ch = tiny_test_config().chat
    params = init_chat_params(jax.random.PRNGKey(1), ch, with_lm_head=True)
    return ch, params, from_jax_params(params, device="cpu")


def _prompts(seed, lengths, T, left):
    """(B, T) ids padded with 0 on the left or the right, and the mask."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), T), np.int32)
    mask = np.zeros((len(lengths), T), np.int32)
    for b, n in enumerate(lengths):
        sl = slice(T - n, T) if left else slice(0, n)
        ids[b, sl] = rng.integers(1, 250, size=n)
        mask[b, sl] = 1
    return ids, mask


def _jax_forced_logits(ch, params, ids, mask, toks, kv_quant=False,
                       attn_impl="xla"):
    """JAX's per-step logits with ``toks`` fed back, built from the
    functions ``generate`` runs: (B, n, V)."""
    lm = params["language_model"]
    B, T = ids.shape
    n = toks.shape[1]
    step = jax.jit(lambda lm, e, c, s, m: jgen.decoder_forward_cached(
        lm, ch.llm, e, c, s, m, attn_impl=attn_impl))
    emb = jdec.embed_tokens(lm, jnp.asarray(ids))
    cache = jgen.init_kv_cache(ch.llm, B, T + NEW, dtype=emb.dtype,
                               quant=kv_quant)
    cmask = jnp.pad(jnp.asarray(mask), ((0, 0), (0, NEW)))
    slots = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    hidden, cache = step(lm, emb, cache, slots, cmask)
    last = np.max(np.where(mask != 0, np.arange(T)[None], -1), axis=-1)
    out = [jdec.lm_logits(lm, hidden[np.arange(B), last])]
    for i in range(n - 1):
        slot = jnp.asarray(last + 1 + i)
        cmask = cmask.at[jnp.arange(B), slot].set(1)
        emb = jdec.embed_tokens(lm, jnp.asarray(toks[:, i:i + 1]))
        hidden, cache = step(lm, emb, cache, slot[:, None], cmask)
        out.append(jdec.lm_logits(lm, hidden[:, 0]))
    return np.stack([np.asarray(x) for x in out], axis=1)


def _assert_margins(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN


def _greedy(ch, gc):
    return gc._replace(eos_token_id=-1, pad_token_id=0)


def test_decoder_forward_cached_prefill_and_step_match_jax(setup):
    ch, jp, tp = setup
    ids, mask = _prompts(0, (12, 9), 12, left=False)
    lm, tlm = jp["language_model"], tp["language_model"]
    B, T = ids.shape
    emb = jdec.embed_tokens(lm, jnp.asarray(ids))
    cache = jgen.init_kv_cache(ch.llm, B, T + 4, dtype=emb.dtype)
    cmask = jnp.pad(jnp.asarray(mask), ((0, 0), (0, 4)))
    slots = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    ref_h, cache = jgen.decoder_forward_cached(lm, ch.llm, emb, cache, slots,
                                               cmask)
    tcache = tgen.init_kv_cache(ch.llm, B, T + 4, device=torch.device("cpu"),
                                dtype=torch.float32)
    tcmask = torch.from_numpy(np.array(cmask))
    tids = torch.from_numpy(ids).long()
    got_h, tcache = tgen.decoder_forward_cached(
        tlm, ch.llm, tgen.dec.embed_tokens(tlm, tids), tcache,
        torch.arange(T)[None].expand(B, T), tcmask)
    live = mask != 0  # pad rows' hidden states are never read
    np.testing.assert_allclose(got_h.numpy()[live], np.asarray(ref_h)[live],
                               atol=ATOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(cache.k),
                               atol=ATOL)
    # One decode step at each row's next slot.
    slot = np.array([12, 9])
    cmask = cmask.at[jnp.arange(B), slot].set(1)
    tok = np.array([[5], [7]], np.int32)
    ref, _ = jgen.decoder_forward_cached(
        lm, ch.llm, jdec.embed_tokens(lm, jnp.asarray(tok)), cache,
        jnp.asarray(slot)[:, None], cmask)
    got, _ = tgen.decoder_forward_cached(
        tlm, ch.llm, tgen.dec.embed_tokens(tlm, torch.from_numpy(tok).long()),
        tcache, torch.from_numpy(slot)[:, None],
        torch.from_numpy(np.array(cmask)))
    np.testing.assert_allclose(
        tgen.dec.lm_logits(tlm, got[:, 0]).numpy(),
        np.asarray(jdec.lm_logits(lm, ref[:, 0])), atol=ATOL)


@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_generate_greedy_matches_jax(setup, left):
    ch, jp, tp = setup
    ids, mask = _prompts(1, (14, 10), 16, left)
    gc = _greedy(ch, jgen.GenerationConfig(max_new_tokens=NEW))
    ref = np.asarray(jgen.generate(jp, ch, jnp.asarray(ids), jnp.asarray(mask),
                                   generation_config=gc))
    ref_logits = _jax_forced_logits(ch, jp, ids, mask, ref)
    _assert_margins(ref_logits)
    tgc = tgen.GenerationConfig(**gc._asdict())
    got = tgen.generate(tp, ch, torch.from_numpy(ids),
                        torch.from_numpy(mask), generation_config=tgc)
    np.testing.assert_array_equal(got.numpy(), ref)
    logits = tgen.generate(tp, ch, torch.from_numpy(ids),
                           torch.from_numpy(mask), generation_config=tgc,
                           teacher_tokens=torch.from_numpy(ref.copy()))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)


def _split(full_rows, P, Pb, Sb):
    """Right-padded prefix (bucket Pb) and suffix (bucket Sb) of each row."""
    B = len(full_rows)
    pre, pam = np.zeros((B, Pb), np.int32), np.zeros((B, Pb), np.int32)
    suf, sam = np.zeros((B, Sb), np.int32), np.zeros((B, Sb), np.int32)
    for b, (row, p) in enumerate(zip(full_rows, P)):
        pre[b, :p], pam[b, :p] = row[:p], 1
        s = len(row) - p
        suf[b, :s], sam[b, :s] = row[p:], 1
    return pre, pam, suf, sam


@pytest.mark.parametrize("pair", [False, True], ids=["one", "pair"])
def test_prefix_generation_matches_jax_and_the_full_prompt(setup, pair):
    """prefill_prefix + generate_from_prefix against JAX's, and against the
    port's own full-prompt ``generate``; the pair stacks two B = 1 states
    with different prefix lengths (per-row q_offset)."""
    ch, jp, tp = setup
    rng = np.random.default_rng(2)
    suffix = rng.integers(1, 250, size=5)
    reals = (8, 9) if pair else (8,)
    rows = [np.concatenate([rng.integers(1, 250, size=r), suffix])
            for r in reals]
    pre, pam, suf, sam = _split(rows, reals, 10, 7)
    gc = _greedy(ch, jgen.GenerationConfig(max_new_tokens=NEW))
    tgc = tgen.GenerationConfig(**gc._asdict())
    max_len = 10 + 7 + NEW
    jstates = [jgen.prefill_prefix(jp, ch, jnp.asarray(pre[b:b + 1]),
                                   jnp.asarray(pam[b:b + 1]), max_len=max_len)
               for b in range(len(reals))]
    jst = jstates[0] if not pair else jgen.stack_prefix_states(jstates)
    ref = np.asarray(jgen.generate_from_prefix(
        jp, ch, jst, jnp.asarray(suf), jnp.asarray(sam), generation_config=gc))
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    tstates = [tgen.prefill_prefix(tp, ch, T(pre[b:b + 1]), T(pam[b:b + 1]),
                                   max_len=max_len)
               for b in range(len(reals))]
    for js, ts in zip(jstates, tstates):
        np.testing.assert_allclose(ts.cache.k.numpy(), np.asarray(js.cache.k),
                                   atol=ATOL)
        np.testing.assert_array_equal(ts.cache_mask.numpy(),
                                      np.asarray(js.cache_mask))
    tst = tstates[0] if not pair else tgen.stack_prefix_states(tstates)
    got = tgen.generate_from_prefix(tp, ch, tst, T(suf), T(sam),
                                    generation_config=tgc)
    np.testing.assert_array_equal(got.numpy(), ref)
    # Teacher-forced logits against JAX's on the whole prompts.
    full = np.zeros((len(rows), max(map(len, rows))), np.int32)
    fmask = np.zeros_like(full)
    for b, row in enumerate(rows):
        full[b, :len(row)], fmask[b, :len(row)] = row, 1
    ref_logits = _jax_forced_logits(ch, jp, full, fmask, ref)
    _assert_margins(ref_logits)
    logits = tgen.generate_from_prefix(tp, ch, tst, T(suf), T(sam),
                                       generation_config=tgc,
                                       teacher_tokens=T(ref.copy()))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    # The port's own full-prompt path gives the same tokens.
    whole = tgen.generate(tp, ch, T(full), T(fmask), generation_config=tgc)
    np.testing.assert_array_equal(whole.numpy(), got.numpy())


def test_prefix_state_is_unchanged_by_use(setup):
    """A state is bit-identical after a call, and two different questions
    in a row answer as each does alone on a fresh state."""
    ch, _, tp = setup
    rng = np.random.default_rng(3)
    pre = torch.from_numpy(rng.integers(1, 250, size=(1, 10)).astype(np.int32))
    gc = tgen.GenerationConfig(max_new_tokens=NEW, eos_token_id=-1,
                               pad_token_id=0)
    st = tgen.prefill_prefix(tp, ch, pre, torch.ones_like(pre), max_len=24)
    before = [t.clone() for t in (*st.cache[:2], st.cache_mask, st.n_prefix)]
    questions = [torch.from_numpy(rng.integers(1, 250, size=(1, 8))
                                  .astype(np.int32)) for _ in range(2)]
    alone = []
    for q in questions:
        fresh = tgen.prefill_prefix(tp, ch, pre, torch.ones_like(pre),
                                    max_len=24)
        alone.append(tgen.generate_from_prefix(
            tp, ch, fresh, q, torch.ones_like(q), generation_config=gc))
    for q, want in zip(questions, alone):
        got = tgen.generate_from_prefix(tp, ch, st, q, torch.ones_like(q),
                                        generation_config=gc)
        assert torch.equal(got, want)
        after = (*st.cache[:2], st.cache_mask, st.n_prefix)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
    # Stacking copies too.
    pair = tgen.stack_prefix_states([st, st])
    pair.cache.k.zero_()
    assert torch.equal(st.cache.k, before[0])


def test_kv_quant_logits_match_jax(setup):
    """int8 cache.  The prefill attends over the fresh (unquantized) tokens
    on the kernel route, the TPU's (``attn_impl="flash"``, interpreted
    here), and over the dequantized cache on JAX's off-TPU XLA route; the
    port's ``impl="auto"`` is the kernel route, so JAX runs "flash"."""
    ch, jp, tp = setup
    ids, mask = _prompts(4, (13, 11), 16, left=False)
    gc = _greedy(ch, jgen.GenerationConfig(max_new_tokens=NEW,
                                           kv_quant=True))
    ref = np.asarray(jgen.generate(jp, ch, jnp.asarray(ids), jnp.asarray(mask),
                                   generation_config=gc, attn_impl="flash"))
    ref_logits = _jax_forced_logits(ch, jp, ids, mask, ref, kv_quant=True,
                                    attn_impl="flash")
    _assert_margins(ref_logits)
    tgc = tgen.GenerationConfig(**gc._asdict())
    args = (tp, ch, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_array_equal(
        tgen.generate(*args, generation_config=tgc).numpy(), ref)
    logits = tgen.generate(*args, generation_config=tgc,
                           teacher_tokens=torch.from_numpy(ref.copy()))
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (7, 0.6)])
def test_sampling_keeps_jax_support_and_is_seeded(top_k, top_p):
    """The support ``_sample`` keeps (captured from the logits JAX hands to
    ``jax.random.categorical``) equals the port's, with ties at the top-k
    and nucleus cutoffs; port draws lie in it and repeat under a seed."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 40)).astype(np.float32) * 2
    logits[:, 7] = logits[:, 3]  # ties
    logits[:, 11] = logits[:, 3]
    gc = jgen.GenerationConfig(temperature=0.7, top_k=top_k, top_p=top_p)
    seen = {}

    def capture(key, x, axis=-1):
        seen["logits"] = np.asarray(x)
        return jnp.argmax(x, axis=axis)

    with mock.patch.object(jax.random, "categorical", capture):
        jgen._sample(jnp.asarray(logits), gc, jax.random.PRNGKey(0))
    want = seen["logits"] > -1e29
    tgc = tgen.GenerationConfig(**gc._asdict())
    kept = tgen.filter_logits(torch.from_numpy(logits), tgc).numpy() > -1e29
    np.testing.assert_array_equal(kept, want)
    assert (kept.sum(-1) < 40).all()
    draws = [tgen._sample(torch.from_numpy(logits), tgc,
                          torch.Generator().manual_seed(s)) for s in range(20)]
    assert all(kept[np.arange(3), d.numpy()].all() for d in draws)
    again = tgen._sample(torch.from_numpy(logits), tgc,
                         torch.Generator().manual_seed(0))
    assert torch.equal(again, draws[0])
    greedy = tgen._sample(torch.from_numpy(logits),
                          tgc._replace(temperature=0.0), None)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_chat_session_and_stream_chat_match_chat(setup):
    """Two session turns (the first with an image) against ``chat`` with
    the history, and ``stream_chat``'s last value against ``chat``."""
    ch, _, tp = setup
    tok = ByteTokenizer()
    rng = np.random.default_rng(6)
    pix = torch.from_numpy(rng.normal(
        size=(1, ch.image_size, ch.image_size, 3)).astype(np.float32))
    gc = tgen.GenerationConfig(max_new_tokens=NEW)
    sess = tgen.ChatSession(tp, ch, tok, max_len=512, generation_config=gc)
    hist = None
    for i, q in enumerate(["<image>\nDescribe the image.", "Why?"]):
        kw = dict(pixel_values=pix, num_patches_list=[1]) if i == 0 else {}
        want, hist = tgen.chat(tp, ch, tok, q, history=hist,
                               generation_config=gc, **kw)
        assert sess.ask(q, **kw) == want
    assert len(sess.history) == 2
    want, _ = tgen.chat(tp, ch, tok, "Name a colour.", generation_config=gc)
    *_, last = tgen.stream_chat(tp, ch, tok, "Name a colour.",
                                generation_config=gc)
    assert last == want
