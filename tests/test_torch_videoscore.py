"""The port's VideoScore (``mjvideo_tpu_torch/models/videoscore.py``, the
Llama importer and exporter, ``VideoScoreJudge``, its drivers and the CLI's
``--judge videoscore``) against the JAX package, in fp32 on the CPU.

A tiny Idefics2: SigLIP 2 layers x 144 wide with 2 heads of 72 (the real
tower's head dim, so its attention runs the K1 and K1m twins), a 1-layer
perceiver (4/2 heads of 16, 6 latents), a 2-layer Mistral (4/2 heads of 16)
whose 320-row vocabulary holds the image marker ids (300, and 299 for
``<fake_token_around_image>``), 5 labels.  JAX's weights
(``init_videoscore_params``) cross by ``utils.bridge.videoscore_from_jax``.
JAX runs its attention with ``attn_impl="xla"`` (its Pallas kernels need a
TPU; ``tests/test_torch_d72.py`` holds the port's twins against them in
interpret mode), the port its kernels' twins: the bound softmax against
the exact one.  Tolerances: activations and logits within 1e-4 of the
reference's largest magnitude (fp32 sums in other orders); position ids,
resize shapes, frame grids, prompts, token ids and importer leaves exact;
a judge's score within 5e-3 of JAX's (each of the 5 dimensions rounds to 3
digits, so a 1e-7 difference can move one by 1e-3).  No ``transformers``
import.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mjvideo_tpu.configs import LLMConfig as JLLMConfig
from mjvideo_tpu.eval import judges as jj
from mjvideo_tpu.models import videoscore as jv
from mjvideo_tpu.utils import checkpoint as jck
from mjvideo_tpu_torch.configs import LLMConfig
from mjvideo_tpu_torch.data.prompts import ByteTokenizer
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.models import videoscore as tv
from mjvideo_tpu_torch.utils import checkpoint as tck
from mjvideo_tpu_torch.utils.bridge import to_numpy, videoscore_from_jax
from mjvideo_tpu_torch.utils.export import export_decoder

torch.set_num_threads(1)

REL = 1e-4
IMAGE_ID = 300
VISION = dict(hidden_size=144, intermediate_size=288, num_hidden_layers=2,
              num_attention_heads=2, patch_size=14, image_size=70)
PERCEIVER = dict(depth=1, n_heads=4, head_dim=16, num_key_value_heads=2,
                 n_latents=6)
TEXT = dict(architecture="llama", vocab_size=320, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=1e4,
            rms_norm_eps=1e-5, pad_token_id=0, max_position_embeddings=4096)


def _configs(**text):
    jcfg = jv.VideoScoreConfig(
        vision=jv.SigLIPVisionConfig(**VISION),
        perceiver=jv.PerceiverConfig(**PERCEIVER),
        text=JLLMConfig(**{**TEXT, **text}), image_token_id=IMAGE_ID,
        num_labels=5)
    tcfg = tv.VideoScoreConfig(
        vision=tv.SigLIPVisionConfig(**VISION),
        perceiver=tv.PerceiverConfig(**PERCEIVER),
        text=LLMConfig(**{**TEXT, **text}), image_token_id=IMAGE_ID,
        num_labels=5)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    jp = jax.tree.map(np.asarray,
                      jv.init_videoscore_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jp, videoscore_from_jax(jp, device="cpu")


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _np(t):
    return t.detach().cpu().numpy()


def _tok():
    return ByteTokenizer(extra_specials={
        "<fake_token_around_image>": IMAGE_ID - 1, "<image>": IMAGE_ID})


def _patch_grid_mask(n, gh, gw, live):
    m = np.zeros((n, gh, gw), np.int32)
    for i, (h, w) in enumerate(live):
        m[i, :h, :w] = 1
    return m


# --- configs and the importers -----------------------------------------------

def test_configs_and_importer_leaves_equal_jax(model):
    """One HF-named state (the published Idefics2 names, written from the
    port's state) through both importers: every leaf equal to JAX's and to
    the state it was written from; the HF config read back by both
    packages as the config; the random tree's shapes are the importer's."""
    jcfg, tcfg, jp, tp = model
    hf = tv.videoscore_config_to_hf(tcfg)
    assert tv.videoscore_config_from_hf(hf) == tcfg
    assert dataclasses.asdict(jv.videoscore_config_from_hf(hf)) == \
        dataclasses.asdict(tcfg)
    state = {k: v.contiguous() for k, v in
             chip_smoke.videoscore_hf_state(tp, tcfg).items()}
    got = tv.import_videoscore_params(state, tcfg, device="cpu")
    want = jv.import_videoscore_params({k: v.numpy() for k, v in
                                        state.items()}, jcfg)
    flat_got = jax.tree_util.tree_leaves_with_path(to_numpy(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want)))
    flat_src = dict(jax.tree_util.tree_leaves_with_path(to_numpy(tp)))
    assert len(flat_got) == len(flat_want) == len(flat_src)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[path], str(path))
        np.testing.assert_array_equal(leaf, flat_src[path], str(path))
    init = tv.init_videoscore_params(tcfg, generator=torch.Generator()
                                     .manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: a.shape, to_numpy(init)) == \
        jax.tree.map(lambda a: a.shape, jp)


@pytest.mark.parametrize("bias", [False, True], ids=["mistral", "qwen2"])
def test_llama_exporter_round_trips_through_both_importers(bias):
    """The port's Llama-layout exporter (q/k/v biases where the state has
    them) read back by the port's importer leaf for leaf, and by JAX's to
    the same leaves; Qwen2's missing o_proj bias imports as zeros in
    both."""
    cfg = LLMConfig(**{**TEXT, "bias": bias})
    jcfg = JLLMConfig(**{**TEXT, "bias": bias})
    g = torch.Generator().manual_seed(1)
    from mjvideo_tpu_torch.models.decoder import init_decoder_params

    p = init_decoder_params(cfg, generator=g, device="cpu",
                            dtype=torch.float32, with_lm_head=True)
    if bias:
        p["layers"]["attention"]["wq"]["bias"].normal_(generator=g)
    state = {k: v.contiguous() for k, v in
             export_decoder(p, cfg, prefix="llm.").items()
             if not k.endswith("o_proj.bias")}
    got = tck.import_decoder_params(state, cfg, prefix="llm.", device="cpu")
    want = jck.import_decoder_params({k: v.numpy() for k, v in
                                      state.items()}, jcfg, prefix="llm.")
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want)))
    flat_src = dict(jax.tree_util.tree_leaves_with_path(to_numpy(p)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(to_numpy(got)):
        np.testing.assert_array_equal(leaf, flat_want[path], str(path))
        np.testing.assert_array_equal(leaf, flat_src[path], str(path))


# --- the tower, the connector, the forward -----------------------------------

@pytest.mark.parametrize("grid", [(39, 70, 70), (27, 45, 70), (5, 5, 5),
                                  (3, 7, 5), (24, 43, 70)])
def test_bucket_position_ids_equal_jax(grid):
    np.testing.assert_array_equal(tv._bucket_position_ids(*grid),
                                  jv._bucket_position_ids(*grid))


def test_masked_position_ids_equal_jax():
    """Idefics2's (1 - 1e-6) fractional bucketing in fp32, on VideoScore's
    split frames (27 x 45 quadrants and the 39 x 70 original on a 39 x 70
    grid, side 70) and on every live grid of a small padded one: ids
    equal, padded patches 0."""
    masks = [(_patch_grid_mask(5, 39, 70, [(27, 45)] * 4 + [(39, 70)]), 70)]
    live = [(h, w) for h in range(1, 8) for w in range(1, 9)]
    masks.append((_patch_grid_mask(len(live), 7, 8, live), 5))
    masks.append((_patch_grid_mask(2, 6, 6, [(6, 6), (0, 0)]), 70))
    for m, side in masks:
        got = tv.masked_position_ids(torch.from_numpy(m), side)
        want = np.asarray(jv.masked_position_ids(jnp.asarray(m), side))
        np.testing.assert_array_equal(got.numpy(), want)


def _pixels(seed, n, h, w):
    return np.random.default_rng(seed).normal(
        size=(n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["maskless", "masked"])
def test_vision_forward_matches_jax(model, masked):
    """The tower on 60 x 75 pixels (cropped to 4 x 5 patches): maskless
    (K1's twin) and with a patch mask (K1m's twin, per-image position
    ids); rows of padded patches are garbage by construction and are not
    compared."""
    jcfg, tcfg, jp, tp = model
    pix = _pixels(0, 3, 60, 75)
    pm = _patch_grid_mask(3, 4, 5, [(4, 5), (2, 3), (4, 1)]) if masked \
        else None
    want = np.asarray(jv.vision_forward(
        jp["vision_model"], jcfg.vision, jnp.asarray(pix), attn_impl="xla",
        patch_attention_mask=None if pm is None else jnp.asarray(pm)))
    for impl in ("auto", "plain"):
        got = _np(tv.vision_forward(
            tp["vision_model"], tcfg.vision, torch.from_numpy(pix), impl=impl,
            patch_attention_mask=None if pm is None else torch.from_numpy(pm)))
        live = np.ones((3, 20), bool) if pm is None else pm.reshape(3, 20) > 0
        _close(got[live], want[live])


@pytest.mark.parametrize("masked", [False, True], ids=["maskless", "masked"])
def test_connector_forward_matches_jax(model, masked):
    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(1).normal(size=(3, 20, 144)).astype(np.float32)
    cm = (np.arange(20)[None] < np.array([[20], [11], [3]])).astype(np.int32) \
        if masked else None
    want = np.asarray(jv.connector_forward(
        jp["connector"], jcfg.perceiver, jnp.asarray(x),
        context_mask=None if cm is None else jnp.asarray(cm)))
    got = tv.connector_forward(tp["connector"], tcfg.perceiver,
                               torch.from_numpy(x),
                               context_mask=None if cm is None
                               else torch.from_numpy(cm))
    _close(_np(got), want)


def _ids(n_images, n_lat, tail_pad=0):
    ids = [5, 6, 7] + [IMAGE_ID] * (n_images * n_lat) + [8, 9, 10, 11]
    mask = [1] * len(ids) + [0] * tail_pad
    return np.asarray([ids + [0] * tail_pad]), np.asarray([mask])


@pytest.mark.parametrize("masked", [False, True], ids=["maskless", "masked"])
def test_videoscore_forward_matches_jax(model, masked):
    """The whole forward -> 5 logits: the pixel mask's patch any-pool (a
    pixel pad that cuts a patch in half keeps it), the image tokens
    scattered, the last non-pad token pooled (tail padding with mask 0)."""
    jcfg, tcfg, jp, tp = model
    pix = _pixels(2, 2, 56, 70)
    pam = None
    if masked:
        pam = np.zeros((2, 56, 70), np.int32)
        pam[0] = 1
        pam[1, :35, :50] = 1
        pix[1, 35:] = 0
        pix[1, :, 50:] = 0
    ids, mask = _ids(2, PERCEIVER["n_latents"], tail_pad=9)
    want = np.asarray(jv.videoscore_forward(
        jp, jcfg, jnp.asarray(pix), jnp.asarray(ids), jnp.asarray(mask),
        attn_impl="xla",
        pixel_attention_mask=None if pam is None else jnp.asarray(pam)))
    got = tv.videoscore_forward(
        tp, tcfg, torch.from_numpy(pix), torch.from_numpy(ids),
        torch.from_numpy(mask),
        pixel_attention_mask=None if pam is None else torch.from_numpy(pam))
    assert got.dtype == torch.float32 and got.shape == (1, 5)
    _close(_np(got), want)


# --- the prompt and preprocessing helpers ------------------------------------

def test_prompt_helpers_equal_jax():
    assert tj.VIDEOSCORE_REGRESSION_QUERY_PROMPT == \
        jj.VIDEOSCORE_REGRESSION_QUERY_PROMPT
    for n in (0, 1, 16):
        assert tj.videoscore_prompt("a fox", n) == jj.videoscore_prompt(
            "a fox", n)
    text = tj.videoscore_prompt("a fox", 3) + "<image><image>"
    for split in (False, True):
        for seq in (6, 64):
            assert tj.idefics2_expand_image_tokens(text, seq, split) == \
                jj.idefics2_expand_image_tokens(text, seq, split)
    for total in (1, 15, 16, 17, 48, 100, 241):
        np.testing.assert_array_equal(tj.videoscore_frame_indices(total),
                                      jj.videoscore_frame_indices(total))
    for h, w in ((720, 1280), (360, 640), (1080, 1920), (40, 56), (1500, 900),
                 (980, 980), (200, 100)):
        assert tj.idefics2_resize_shape(h, w) == jj.idefics2_resize_shape(h, w)
        assert tj.idefics2_resize_shape(h, w, 28, 70) == \
            jj.idefics2_resize_shape(h, w, 28, 70)
    # VideoScore's frames: a 1280 x 720 frame and its quadrants.
    assert tj.idefics2_resize_shape(720, 1280) == (551, 980)
    assert tj.idefics2_resize_shape(360, 640) == (378, 640)


SMALL = dict(num_frames=4, resize_shortest=28, resize_longest=70)


def _judges(model, split):
    jcfg, tcfg, jp, tp = model
    tok = _tok()
    jjudge = jj.VideoScoreJudge(tokenizer=tok, cfg=jcfg, params=jp,
                                dtype=jnp.float32, do_image_splitting=split,
                                **SMALL)
    tjudge = tj.VideoScoreJudge(tokenizer=tok, cfg=tcfg, params=tp,
                                dtype=torch.float32,
                                do_image_splitting=split, **SMALL)
    return jjudge, tjudge


@pytest.mark.parametrize("split", [False, True], ids=["frames", "split"])
def test_preprocess_and_tokenize_equal_jax(model, split):
    jjudge, tjudge = _judges(model, split)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
              for _ in range(2)]
    (pa, ma), (pb, mb) = (tjudge.preprocess_frames(frames),
                          jjudge.preprocess_frames(frames))
    np.testing.assert_array_equal(pa, pb)
    assert (ma is None) == (mb is None) == (not split)
    if split:
        np.testing.assert_array_equal(ma, mb)
    prompt = tj.videoscore_prompt("a fox", 2)
    assert tjudge.tokenize(prompt) == jjudge.tokenize(prompt)


def _write_video(path, seed, frames=10, size=(40, 56)):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                        (size[1], size[0]))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 255, size + (3,), dtype=np.uint8))
    w.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("vsvids")
    paths = [str(root / "a.mp4"), str(root / "b.mp4")]
    for seed, path in enumerate(paths):
        _write_video(path, seed)
    return paths


@pytest.mark.parametrize("split", [False, True], ids=["frames", "split"])
def test_judge_scores_equal_jax(model, videos, split):
    """``VideoScoreJudge.score`` on two cv2-written videos, one image a
    frame (the maskless tower) and with image splitting (quadrants and
    originals of two sizes: the masked tower): per-dimension logits within
    REL of JAX's judge's, the aggregate within 5e-3; the image-token guard
    refuses a prompt without markers."""
    jjudge, tjudge = _judges(model, split)
    for path in videos:
        assert abs(tjudge.score(path, "a fox") - jjudge.score(path, "a fox")) \
            <= 5e-3
    from mjvideo_tpu_torch.data.video import decode_frames, video_metadata

    n, _ = video_metadata(videos[0])
    frames = decode_frames(videos[0], tj.videoscore_frame_indices(n, 4))
    pix, pm = tjudge.preprocess_frames(frames)
    assert (pm is None) == (not split)
    ids, mask = tjudge.tokenize(tj.videoscore_prompt("a fox", len(frames)))
    got = tjudge.score_frames(pix, np.asarray([ids]), np.asarray([mask]), pm)
    want = jjudge.score_frames(pix, np.asarray([ids]), np.asarray([mask]), pm)
    _close(got, want)
    with pytest.raises(ValueError, match="image tokens"):
        tjudge.score_frames(pix, np.asarray([[5, 6, 7]]),
                            np.asarray([[1, 1, 1]]), pm)


class _StubScoreJudge:
    """score() by file name, counting calls."""

    def __init__(self):
        self.calls = []

    def score(self, video_path, caption):
        self.calls.append(video_path)
        return {"good": 3.0, "ok": 2.0}.get(video_path.split("_")[0], 1.0)


def test_drivers_equal_jax(tmp_path):
    """``run_overall_videoscore_benchmark`` (undecided pairs never scored,
    resume scores nothing) and ``run_genai_videoscore_benchmark`` (good
    above 2, no tie credit): the port's metrics equal JAX's."""
    records = [
        {"video_0_path": "good_a.mp4", "video_1_path": "bad_b.mp4",
         "caption": "c", "overall_preference": "Video 1 better"},
        {"video_0_path": "same_a.mp4", "video_1_path": "same_b.mp4",
         "caption": "c", "overall_preference": "Same"},
        {"video_0_path": "bad_a.mp4", "video_1_path": "good_b.mp4",
         "caption": "c", "overall_preference": "Video 1 better"},
        {"video_0_path": "ok_a.mp4", "video_1_path": "ok_b.mp4",
         "caption": "c", "overall_preference": "Video 2 better"},
    ]
    stub = _StubScoreJudge()
    got = tj.run_overall_videoscore_benchmark(
        stub, records, results_path=str(tmp_path / "t.jsonl"))
    want = jj.run_overall_videoscore_benchmark(
        _StubScoreJudge(), records, results_path=str(tmp_path / "j.jsonl"))
    assert got == want and not any("same" in p for p in stub.calls)
    again = _StubScoreJudge()
    assert tj.run_overall_videoscore_benchmark(
        again, records, results_path=str(tmp_path / "t.jsonl")) == got
    assert again.calls == []
    examples = [
        {"left_video": "good_l.mp4", "right_video": "bad_r.mp4",
         "prompt": "p", "vote_type": "leftvote"},
        {"left_video": "ok_l.mp4", "right_video": "good_r.mp4",
         "prompt": "p", "vote_type": "rightvote"},
        {"left_video": "bad_l.mp4", "right_video": "bad_r.mp4",
         "prompt": "p", "vote_type": "bothbad_vote"},
        {"left_video": "ok_l.mp4", "right_video": "ok_r.mp4",
         "prompt": "p", "vote_type": "tievote"},
    ]
    assert tj.run_genai_videoscore_benchmark(_StubScoreJudge(), examples) == \
        jj.run_genai_videoscore_benchmark(_StubScoreJudge(), examples)


def test_eval_cli_videoscore_branch(model, videos, tmp_path):
    """``--judge videoscore --byte-tokenizer --device cpu`` on a directory
    of the published names (``chip_smoke.write_hf_dir``): the overall
    benchmark's rows (undecided pairs skipped) hold the scores of the
    port's judge built as the CLI builds it (bf16, 16 frames, the
    ByteTokenizer with the config's marker ids), bit for bit; a
    fine-grained run is refused."""
    from mjvideo_tpu_torch.eval import cli

    _, tcfg, _, tp = model
    d = str(tmp_path / "ckpt")
    chip_smoke.write_hf_dir(d, tv.videoscore_config_to_hf(tcfg),
                            chip_smoke.videoscore_hf_state(tp, tcfg))
    (tmp_path / "v").mkdir()
    root = str(tmp_path / "v")
    for name, src in zip(("a.mp4", "b.mp4"), videos):
        shutil.copy(src, f"{root}/{name}")
    records = [{"caption": "a fox", "video_0_path": "a.mp4",
                "video_1_path": "b.mp4", "overall_preference": pref}
               for pref in ("Video 1 better", "Same")]
    data = tmp_path / "pairs.json"
    data.write_text(json.dumps(records))
    results = tmp_path / "res.jsonl"
    args = ["--judge", "videoscore", "--judge-model", d, "--byte-tokenizer",
            "--device", "cpu", "--data-json", str(data), "--video-root",
            root]
    cli.main(["--benchmark", "overall", "--results", str(results)] + args)
    rows = [json.loads(line) for line in results.read_text().splitlines()]
    judge = tj.VideoScoreJudge(d, tokenizer=_tok(), device="cpu")
    assert judge.params["text"]["tok_embeddings"].dtype == torch.bfloat16
    want = [judge.score(f"{root}/{n}", "a fox") for n in ("a.mp4", "b.mp4")]
    assert len(rows) == 1 and [rows[0]["score_0"], rows[0]["score_1"]] == want
    with pytest.raises(SystemExit):
        cli.main(["--benchmark", "fine-grained"] + args)
