"""The port's InternVL judge and prompts against the JAX package's, fp32 on
the CPU.

The prompt constants and rubric are byte-equal to ``mjvideo_tpu.eval.
judges`` (imported here, where JAX may load).  The judges run on two
cv2-written videos, as ``tests/test_prefix_cache.py`` makes them, with one
tiny chat state with the LM head (JAX's ``init_chat_params`` through
``from_jax_params``); the JAX judge runs its XLA path, the port its kernel
twins.  Answers must be equal.  That is a complete check only where each
greedy step has a clear winner: the port's teacher-forced logits on its own
answers must show a top-2 margin above 1e-3 at every step up to EOS, ten
times the 1e-4 at which ``test_torch_generate.py`` holds the port's logits
to JAX's, so JAX's argmax is the same token.
"""

import jax
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data.prompts import ByteTokenizer, build_video_question
from mjvideo_tpu.eval import judges as jj
from mjvideo_tpu.models.internvl import init_chat_params
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.models import generate as tgen
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
MARGIN = 1e-3
NEW = 6


def test_prompt_constants_are_byte_equal_to_jax():
    assert tj.OVERALL_PROMPT_TEMPLATE == jj.OVERALL_PROMPT_TEMPLATE
    assert tj.FINE_GRAINED_PROMPT_TEMPLATE == jj.FINE_GRAINED_PROMPT_TEMPLATE
    assert tj.FINE_GRAINED_RUBRIC == jj.FINE_GRAINED_RUBRIC
    assert list(tj.RATING_SCALE.items()) == list(jj.RATING_SCALE.items())
    caption = "A dog runs on a beach."
    assert tj.overall_prompt(caption) == jj.overall_prompt(caption)
    for cat, entry in jj.FINE_GRAINED_RUBRIC.items():
        for sub in (None, *entry["subcategories"]):
            assert (tj.fine_grained_prompt(caption, cat, sub)
                    == jj.fine_grained_prompt(caption, cat, sub))


@pytest.mark.parametrize("response", [
    "", "RATING: Good", "{RATING: Very Good}", "RATING:excelent",
    "I think it is Below Average overall.", "rating: poor", "Outstanding!",
    "RATING: Extremely Poor\nRATING: Good", "no rating here at all",
])
def test_parse_rating_matches_jax(response):
    assert tj.parse_rating(response) == jj.parse_rating(response)


def _write_video(path, seed, frames=12, size=48):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                        (size, size))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    w.release()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ch = tiny_test_config().chat
    params = init_chat_params(jax.random.PRNGKey(1), ch, with_lm_head=True)
    root = tmp_path_factory.mktemp("vids")
    videos = [str(root / "a.mp4"), str(root / "b.mp4")]
    for seed, path in enumerate(videos):
        _write_video(path, seed)
    return ch, params, from_jax_params(params), ByteTokenizer(), videos


def _judges(setup, **kw):
    ch, jp, tp, tok, _ = setup
    common = dict(num_segments=2, max_new_tokens=NEW, **kw)
    return (jj.InternVLJudge(ch, jp, tok, attn_impl="xla", **common),
            tj.InternVLJudge(ch, tp, tok, **common))


def _assert_margins(logits, toks, eos):
    """Top-2 margin above MARGIN at every step up to each row's EOS."""
    top2 = np.sort(logits.numpy(), axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for row, m in zip(toks.tolist(), margin):
        n = row.index(eos) + 1 if eos in row else len(row)
        assert m[:n].min() > MARGIN, m[:n]


def _check_margins(judge, prompt, videos):
    """The port judge's answer to ``prompt`` about ``videos``, by the path
    it takes, with its teacher-forced logits held to MARGIN."""
    inputs = judge._prefix_inputs(prompt, videos) if judge.prefix_cache \
        else None
    if inputs is not None:
        state, sids, smask, gc = inputs
        run = lambda **kw: tgen.generate_from_prefix(  # noqa: E731
            judge.params, judge.cfg, state, sids, smask, generation_config=gc,
            **kw)
    else:
        preps = [judge._prep(v) for v in videos]
        ids, mask, gc = tgen.batch_chat_inputs(
            judge.cfg, judge.tokenizer,
            [build_video_question(prompt, len(n)) for _, n in preps],
            [n for _, n in preps], generation_config=judge._gc())
        vis = torch.cat([v for v, _ in preps])
        run = lambda **kw: tgen.generate(  # noqa: E731
            judge.params, judge.cfg, ids, mask, generation_config=gc,
            vision_embeds=vis, **kw)
    toks = run()
    _assert_margins(run(teacher_tokens=toks), toks, gc.eos_token_id)


@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix", "full"])
def test_judge_answers_match_jax(setup, prefix_cache):
    """``ask`` (two questions about one video: the second reuses the cached
    prefix state) and ``ask_batch`` (a pair) against the JAX judge."""
    videos = setup[-1]
    jax_judge, judge = _judges(setup, prefix_cache=prefix_cache)
    got_vis, got_npl = judge._prep(videos[0])
    ref_vis, ref_npl = jax_judge._prep(videos[0])
    assert list(got_npl) == list(ref_npl)
    np.testing.assert_allclose(got_vis.numpy(), np.asarray(ref_vis),
                               atol=1e-4)
    for q in ("Rate the coherence.", "Rate the alignment of this video."):
        assert judge.ask(q, videos[0]) == jax_judge.ask(q, videos[0])
    if prefix_cache:
        assert judge._pstate.cache_info().hits >= 1
    q = "Which is better?"
    assert judge.ask_batch(q, videos) == jax_judge.ask_batch(q, videos)
    _check_margins(judge, q, videos)


def test_judge_pair_and_suffix_bucket_fallback(setup):
    """The overall prompt is longer than the 128-token suffix bucket, so
    ``judge_pair`` takes the full-prompt path in both packages; a bucket of
    4 sends a short question there too, with the same answer as the
    judge without the prefix cache."""
    videos = setup[-1]
    jax_judge, judge = _judges(setup)
    caption = "A dog runs on a beach."
    assert judge._prefix_inputs(tj.overall_prompt(caption), videos) is None
    got = tj.judge_pair(judge, *videos, caption)
    assert got == jj.judge_pair(jax_judge, *videos, caption)
    _check_margins(judge, tj.overall_prompt(caption), videos)
    _, tiny = _judges(setup, suffix_bucket=4)
    _, off = _judges(setup, prefix_cache=False)
    q = "A question much longer than four tokens for certain."
    assert tiny._ask_prefix(q, videos[:1]) is None
    assert tiny.ask(q, videos[0]) == off.ask(q, videos[0])


def test_judge_quant_raises_with_its_roadmap_item(setup):
    ch, _, tp, tok, _ = setup
    with pytest.raises(NotImplementedError, match="item 11"):
        tj.InternVLJudge(ch, tp, tok, quant="w8a8")
