"""The port's Qwen2-VL (``mjvideo_tpu_torch/models/qwen2vl.py``) and its judge
against the JAX package's, fp32 on the CPU.

One tiny config whose vision heads are 80 wide (2 heads of 80, depth 2;
text 2 layers of 48 with 3/1 heads of 16), its special ids inside the
vocabulary, weights from JAX's ``init_qwen2vl_params`` carried across by
``from_jax_params``.  JAX runs its XLA attention, the port its kernels'
plain twins (K1's bound shift at D = 80 in the tower, K3 in the cached
prefill and continuation).  Tolerances: leaves of the importers and the
M-RoPE positions, the preprocessing and the judge's answers exactly equal;
the vision tower, the forward and the teacher-forced cached logits atol
1e-4 (fp32 sums in other orders); greedy tokens equal on the seeds whose
top-2 margins exceed 1e-3 at every step, ten times that.  No
``transformers`` import: its first import costs 10-15 s.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import LLMConfig as JLLMConfig
from mjvideo_tpu.data.prompts import ByteTokenizer as JByteTokenizer
from mjvideo_tpu.eval import judges as jj
from mjvideo_tpu.models import qwen2vl as jq
from mjvideo_tpu_torch.configs import LLMConfig
from mjvideo_tpu_torch.data.prompts import ByteTokenizer
from mjvideo_tpu_torch.eval import judges as tj
from mjvideo_tpu_torch.models import qwen2vl as tq
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
ATOL = 1e-4
MARGIN = 1e-3
NEW = 5
IDS = dict(im_start_token_id=300, im_end_token_id=301,
           vision_start_token_id=302, vision_end_token_id=303,
           image_token_id=304, video_token_id=305)
VISION = dict(depth=2, embed_dim=160, num_heads=2, mlp_ratio=2,
              patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
              hidden_size=48)
TEXT = dict(architecture="llama", vocab_size=320, hidden_size=48,
            intermediate_size=96, num_hidden_layers=2, num_attention_heads=3,
            num_key_value_heads=1, rope_theta=10000.0, rms_norm_eps=1e-6,
            pad_token_id=0, max_position_embeddings=512, bias=True)


def _configs(tie=True, **text):
    kw = dict(mrope_section=(2, 3, 3), tie_word_embeddings=tie, **IDS)
    t = dict(TEXT, **text)
    return (jq.Qwen2VLConfig(vision=jq.Qwen2VLVisionConfig(**VISION),
                             text=JLLMConfig(**t), **kw),
            tq.Qwen2VLConfig(vision=tq.Qwen2VLVisionConfig(**VISION),
                             text=LLMConfig(**t), **kw))


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = jq.init_qwen2vl_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def tied():
    jcfg, tcfg = _configs(True)
    jp = jq.init_qwen2vl_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, from_jax_params(jp, device="cpu")


def _np(t):
    return t.detach().float().numpy()


def _patches(rng, cfg, grid):
    n = grid[0] * grid[1] * grid[2]
    return rng.normal(size=(n, cfg.vision.patch_dim)).astype(np.float32)


def _prompt(cfg, grid, text=(7, 8, 9), lead=(5, 6)):
    n_video = grid[0] * grid[1] * grid[2] // cfg.vision.spatial_merge_size**2
    return np.asarray([list(lead) + [cfg.vision_start_token_id]
                       + [cfg.video_token_id] * n_video
                       + [cfg.vision_end_token_id] + list(text)], np.int64)


# --- the importers -----------------------------------------------------------

@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_importer_leaves_equal_jax_and_export_round_trips(tie):
    """One seeded HF-named numpy state through both importers: every leaf
    equal; the port's exporter writes the same state back."""
    jcfg, tcfg = _configs(tie)
    g = torch.Generator().manual_seed(3)
    src = tq.init_qwen2vl_params(tcfg, generator=g, device="cpu")
    rng = np.random.default_rng(3)
    state = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
             for k, v in tq.export_qwen2vl_state(src, tcfg).items()}
    # Qwen2 has no o_proj bias: both importers fill zeros.
    for i in range(tcfg.text.num_hidden_layers):
        del state[f"model.language_model.layers.{i}.self_attn.o_proj.bias"]
    jl = jax.tree_util.tree_flatten_with_path(
        jq.import_qwen2vl_params(state, jcfg))[0]
    tp = tq.import_qwen2vl_params(state, tcfg, device="cpu")
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=str(path))
    back = tq.export_qwen2vl_state(tp, tcfg)
    for name, arr in state.items():
        np.testing.assert_array_equal(_np(back[name]), arr, err_msg=name)
    assert set(back) - set(state) == {
        f"model.language_model.layers.{i}.self_attn.o_proj.bias"
        for i in range(tcfg.text.num_hidden_layers)}


def test_hf_config_round_trips_and_matches_jax():
    _, tcfg = _configs(False)
    d = json.loads(json.dumps(tq.qwen2vl_config_to_hf(tcfg)))
    got = tq.qwen2vl_config_from_hf(d)
    # The stop ids are the tokenizer's, and a pad id of 0 reads as Qwen2's
    # 151643, in both packages.
    want = dataclasses.replace(
        tcfg, im_start_token_id=151644, im_end_token_id=151645,
        text=dataclasses.replace(tcfg.text, pad_token_id=151643))
    assert got == want
    j = jq.qwen2vl_config_from_hf(d)
    assert dataclasses.asdict(j) == dataclasses.asdict(got)
    assert (dataclasses.asdict(jq.qwen2vl_7b_config())
            == dataclasses.asdict(tq.qwen2vl_7b_config()))
    assert (dataclasses.asdict(jq.Qwen2VLConfig())
            == dataclasses.asdict(tq.Qwen2VLConfig()))


# --- the vision tower and M-RoPE ---------------------------------------------

@pytest.mark.parametrize("grid", [(1, 4, 4), (2, 4, 6)])
def test_vision_forward_matches_jax(tied, grid):
    jcfg, tcfg, jp, tp = tied
    patches = _patches(np.random.default_rng(1), tcfg, grid)
    want = np.asarray(jq.vision_forward(jp["visual"], jcfg.vision,
                                        jnp.asarray(patches), grid,
                                        attn_impl="xla", remat=False))
    got = tq.vision_forward(tp["visual"], tcfg.vision,
                            torch.from_numpy(patches), grid)
    assert got.shape == want.shape == (grid[0] * grid[1] * grid[2] // 4, 48)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


def test_vision_rot_pos_emb_is_jax_s():
    _, tcfg = _configs()
    for grid in ((1, 4, 6), (2, 8, 4)):
        for a, b in zip(tq.vision_rot_pos_emb(grid, tcfg.vision),
                        jq.vision_rot_pos_emb(grid, _configs()[0].vision)):
            np.testing.assert_array_equal(a, b)


def test_get_rope_index_equals_jax():
    """Text around one or two vision spans, an image span, left and right
    padding: the positions and deltas are JAX's exactly."""
    jcfg, tcfg = _configs()
    g1, g2 = (1, 4, 4), (2, 4, 6)
    one = _prompt(tcfg, g1)[0].tolist()
    two = one + _prompt(tcfg, g2, text=(11,), lead=(10,))[0].tolist()
    img = [5, tcfg.vision_start_token_id] + [tcfg.image_token_id] * 4 + [
        tcfg.vision_end_token_id, 6]
    cases = [
        (np.asarray([one]), [g1], None, None),
        (np.asarray([two]), [g1, g2], None, None),
        (np.asarray([img + one]), [g1], None, [g1]),
        (np.asarray([[0, 0] + one, one + [0, 0]]), [g1, g1],
         np.asarray([[0, 0] + [1] * len(one), [1] * len(one) + [0, 0]]),
         None),
    ]
    for ids, vids, mask, imgs in cases:
        got = tq.get_rope_index(ids, vids, tcfg, mask, imgs)
        want = jq.get_rope_index(ids, vids, jcfg, mask, imgs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_mrope_cos_sin_matches_jax():
    jcfg, tcfg = _configs()
    ids = _prompt(tcfg, (2, 4, 6))
    pos, _ = tq.get_rope_index(ids, [(2, 4, 6)], tcfg)
    got = tq.mrope_cos_sin(torch.from_numpy(pos), tcfg)
    want = jq.mrope_cos_sin(jnp.asarray(pos), jcfg)
    for a, b in zip(got, want):
        assert a.shape == (1, ids.shape[1], tcfg.text.head_dim)
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)


# --- the forward and generation ----------------------------------------------

def test_qwen2vl_forward_logits_match_jax(model):
    """The whole multimodal forward, then ``lm_logits`` by the tied head or
    the untied one."""
    jcfg, tcfg, jp, tp = model
    grid = (2, 4, 4)
    patches = _patches(np.random.default_rng(2), tcfg, grid)
    ids = _prompt(tcfg, grid)
    mask = np.ones_like(ids)
    pos, _ = tq.get_rope_index(ids, [grid], tcfg)
    jh = jq.qwen2vl_forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                            jnp.asarray(pos), jnp.asarray(patches), grid,
                            attn_impl="xla", remat=False)
    want = np.asarray(jq.lm_logits(jp, jcfg, jh))
    th = tq.qwen2vl_forward(tp, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(mask), torch.from_numpy(pos),
                            torch.from_numpy(patches), grid)
    got = tq.lm_logits(tp, tcfg, th)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


def _items(cfg, seed, grids=((1, 4, 4), (2, 4, 4))):
    rng = np.random.default_rng(seed)
    items = []
    for b, grid in enumerate(grids):
        ids = _prompt(cfg, grid, text=tuple(range(7, 10 + 3 * b)))
        pos, _ = tq.get_rope_index(ids, [grid], cfg)
        items.append((ids.astype(np.int32), pos, _patches(rng, cfg, grid),
                      grid))
    return items


def _reference_logits(jcfg, jp, item, toks):
    """JAX's uncached forward over prompt + tokens: the logits after each
    of the first len(toks) positions from the prompt's last token on."""
    ids, _, patches, grid = item
    full = np.concatenate([ids, np.asarray([toks[:-1]], ids.dtype)], 1)
    pos, _ = jq.get_rope_index(full, [grid], jcfg)
    h = jq.qwen2vl_forward(jp, jcfg, jnp.asarray(full),
                           jnp.ones(full.shape, jnp.int32), jnp.asarray(pos),
                           jnp.asarray(patches), grid, attn_impl="xla",
                           remat=False)
    T = ids.shape[1]
    return np.asarray(jq.lm_logits(jp, jcfg, h))[0, T - 1:T - 1 + len(toks)]


def _margins_ok(logits):
    top2 = torch.topk(torch.as_tensor(logits), 2, dim=-1).values
    return bool(((top2[..., 0] - top2[..., 1]) > MARGIN).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_cached_generation_matches_jax(model, seed):
    """A batch of two prompts of different grids and lengths: the port's
    teacher-forced cached logits on JAX's greedy tokens against JAX's
    uncached forward (atol 1e-4), and the port's greedy tokens equal to
    JAX's ``greedy_generate_batch``'s where every step's top-2 margin
    exceeds MARGIN."""
    jcfg, tcfg, jp, tp = model
    items = _items(tcfg, seed)
    eos = tcfg.im_end_token_id
    want = jq.greedy_generate_batch(jp, jcfg, items, max_new_tokens=NEW,
                                    eos_token_id=-1, attn_impl="xla")
    teacher = torch.tensor(want)
    got_logits = tq.greedy_generate_batch(tp, tcfg, items,
                                          max_new_tokens=NEW,
                                          eos_token_id=-1,
                                          teacher_tokens=teacher)
    for b, item in enumerate(items):
        ref = _reference_logits(jcfg, jp, item, want[b])
        np.testing.assert_allclose(_np(got_logits[b]), ref, atol=ATOL)
    assert _margins_ok(got_logits)
    got = tq.greedy_generate_batch(tp, tcfg, items, max_new_tokens=NEW,
                                   eos_token_id=-1)
    assert got == want
    # With the real stop token, rows end at it (JAX's counts).
    assert (tq.greedy_generate_batch(tp, tcfg, items, max_new_tokens=NEW,
                                     eos_token_id=eos)
            == jq.greedy_generate_batch(jp, jcfg, items, max_new_tokens=NEW,
                                        eos_token_id=eos, attn_impl="xla"))


def test_prefix_path_equals_the_full_prompt(tied):
    """``prefill_prefix`` of the vision block and ``continue_prefix`` of a
    question: the same tokens and, teacher-forced, the full prompt's logits
    (the suffix runs over the whole cache at ``q_offset`` = P); the state is
    unchanged by use."""
    jcfg, tcfg, jp, tp = tied
    tok = ByteTokenizer()
    grid = (2, 4, 4)
    patches = _patches(np.random.default_rng(5), tcfg, grid)
    vis = tq.vision_forward(tp["visual"], tcfg.vision,
                            torch.from_numpy(patches), grid)
    prefix, suffix = tq.build_video_prompt_prefix_suffix(tok, tcfg, grid,
                                                         "Rate it.")
    ids = tq.build_video_prompt_ids(tok, tcfg, grid, "Rate it.")
    assert prefix + suffix == ids[0].tolist()
    pos, _ = tq.get_rope_index(ids, [grid], tcfg)
    full = tq.greedy_generate_batch(tp, tcfg, [(ids, pos, None, None)],
                                    max_new_tokens=NEW, eos_token_id=-1,
                                    vision_embeds=[vis])
    Pb = 64
    state = tq.prefill_prefix(tp, tcfg, prefix, grid, vis,
                              max_len=Pb + 32 + NEW, bucket=Pb)
    before = [t.clone() for t in state.cache if t is not None]
    toks, n = tq.continue_prefix(tp, tcfg, state, suffix, 32, NEW, -1)
    assert [toks[0, : n[0]].tolist()] == full
    teacher = torch.tensor(full)
    a = tq.continue_prefix(tp, tcfg, state, suffix, 32, NEW, -1,
                           teacher_tokens=teacher)
    b = tq.greedy_generate_batch(tp, tcfg, [(ids, pos, None, None)],
                                 max_new_tokens=NEW, eos_token_id=-1,
                                 vision_embeds=[vis], teacher_tokens=teacher)
    np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)
    assert all(torch.equal(x, y) for x, y in
               zip(before, [t for t in state.cache if t is not None]))


def test_generate_helpers_match_jax():
    """The slot arithmetic and the loop of the judge families' scaffolding
    against ``mjvideo_tpu.models.generate``."""
    from mjvideo_tpu.models import generate as jg
    from mjvideo_tpu_torch.models import generate as tg

    rows = [np.asarray([[3, 4, 5]]), np.asarray([[6] * 70])]
    for a, b in zip(tg.pad_prompt_batch(rows, 9), jg.pad_prompt_batch(rows,
                                                                       9)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    n = np.asarray([3, 70], np.int32)
    for got, want in ((tg.prefill_slot_mask(128, 140, torch.from_numpy(n)),
                       jg.prefill_slot_mask(128, 140, jnp.asarray(n))),
                      (tg.step_slot_mask(140, torch.from_numpy(n), 4),
                       jg.step_slot_mask(140, jnp.asarray(n), 4))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    h = np.random.default_rng(0).normal(size=(2, 80, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tg.last_real_token(torch.from_numpy(h), torch.from_numpy(n)).numpy(),
        np.asarray(jg.last_real_token(jnp.asarray(h), jnp.asarray(n))))
    # The loop: row 0 stops at eos 2 on its third token, row 1 runs out.
    script = np.asarray([[5, 1, 2, 7, 7, 7], [4, 4, 4, 4, 4, 4]])
    V = 8

    def logits_at(i):
        return np.eye(V, dtype=np.float32)[script[:, min(i, 5)]]

    def tstep(p, tok, i, c):
        return torch.from_numpy(logits_at(i + 1)), c + 1

    table = jnp.asarray(np.stack([logits_at(k) for k in range(7)]))

    def jstep(p, tok, i, c):
        return jnp.take(table, i + 1, axis=0), c + 1

    for budget in (1, 4, 6):
        got = tg.greedy_decode_batch(tstep, None,
                                     torch.from_numpy(logits_at(0)), 0,
                                     budget, 2)
        want = jax.jit(lambda l0: jg.greedy_decode_batch(
            jstep, None, l0, jnp.int32(0), budget, 2))(
                jnp.asarray(logits_at(0)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_greedy_loop_skips_the_last_forward():
    """The step after the token that ends the generation never runs: two
    forwards for a budget of 3, none when every row stops at once."""
    from mjvideo_tpu_torch.models import generate as tg

    calls = []

    def step(p, tok, i, c):
        calls.append(i)
        return torch.tensor([[0.0, 1.0, 0.0]]), c

    tg.greedy_decode_batch(step, None, torch.tensor([[0.0, 1.0, 0.0]]), None,
                           3, 2)
    assert calls == [0, 1]
    calls.clear()
    toks, n = tg.greedy_decode_batch(step, None,
                                     torch.tensor([[0.0, 0.0, 1.0]]), None,
                                     3, 2)
    assert calls == [] and toks.tolist() == [[2, 2, 2]] and n.tolist() == [1]


# --- preprocessing -----------------------------------------------------------

def test_smart_resize_and_preprocess_equal_jax():
    for hw in ((48, 64), (360, 640), (1080, 1920), (30, 28), (28, 5000)):
        kw = dict(factor=28, min_pixels=56 * 56, max_pixels=360 * 420)
        assert tq.smart_resize(*hw, **kw) == jq.smart_resize(*hw, **kw)
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(4)
    for n in (3, 4):
        frames = [rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
                  for _ in range(n)]
        got = tq.preprocess_video_frames(frames, tcfg.vision,
                                         max_pixels=32 * 32)
        want = jq.preprocess_video_frames(frames, jcfg.vision,
                                          max_pixels=32 * 32)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


# --- the judge and the CLI ---------------------------------------------------

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
    root = tmp_path_factory.mktemp("qvids")
    paths = [str(root / "a.mp4"), str(root / "b.mp4")]
    for seed, path in enumerate(paths):
        _write_video(path, seed)
    return paths


JUDGE = dict(num_segments=4, max_new_tokens=NEW, max_pixels=32 * 32,
             suffix_bucket=32)


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix", "full"])
def test_judge_answers_equal_jax(tied, videos, prefix_cache):
    """``Qwen2VLJudge`` on two cv2-written videos, by the prefix path and by
    the full prompt (a question past the suffix bucket always takes it):
    ``ask``, ``ask_batch`` and ``judge_pair`` give JAX's answers."""
    jcfg, tcfg, jp, tp = tied
    jjudge = jj.Qwen2VLJudge(jcfg, jp, JByteTokenizer(), attn_impl="xla",
                             prefix_cache=prefix_cache, **JUDGE)
    tjudge = tj.Qwen2VLJudge(tcfg, tp, ByteTokenizer(),
                             prefix_cache=prefix_cache, **JUDGE)
    q = "Rate it."
    assert tjudge.ask(q, videos[0]) == jjudge.ask(q, videos[0])
    assert (tjudge.ask_batch(q, videos) == jjudge.ask_batch(q, videos))
    assert (tj.judge_pair(tjudge, *videos, "a fox")
            == jj.judge_pair(jjudge, *videos, "a fox"))
    assert tjudge._prep.cache_info().currsize == 2
    if prefix_cache:
        assert tjudge._pstate.cache_info().hits >= 1
        # The prefix path's answers are the full prompt's.
        full = tj.Qwen2VLJudge(tcfg, tp, ByteTokenizer(), prefix_cache=False,
                               **JUDGE)
        assert full.ask_batch(q, videos) == tjudge.ask_batch(q, videos)


def test_judge_answers_decode_to_text(tied, videos):
    """At the tiny vocabulary the greedy ids are bytes: the answers are
    non-empty text, so the equalities above compare real answers."""
    _, tcfg, _, tp = tied
    tjudge = tj.Qwen2VLJudge(tcfg, tp, ByteTokenizer(), **JUDGE)
    answers = tjudge.ask_batch("Rate it.", videos)
    assert all(isinstance(a, str) for a in answers)
    assert any(answers)


def test_eval_cli_qwen2vl_branch(videos, tmp_path, monkeypatch):
    """``--judge qwen2-vl`` on a directory the port's writer made (the HF
    config and safetensors; the real vocabulary, which the config's stop
    ids need): the results file's ratings and answers equal JAX's judge on
    the same fp32 weights.  The CLI loads a judge in bf16, as JAX's does,
    so its importer is called here at fp32."""
    from mjvideo_tpu_torch.eval import cli
    from mjvideo_tpu_torch.models import qwen2vl as mod
    from mjvideo_tpu_torch.utils.export import save_safetensors

    _, tcfg = _configs(True, vocab_size=151936)
    tcfg = dataclasses.replace(tcfg, im_start_token_id=151644,
                               im_end_token_id=151645)
    tp = tq.init_qwen2vl_params(tcfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(tq.qwen2vl_config_to_hf(tcfg)))
    save_safetensors(tq.export_qwen2vl_state(tp, tcfg),
                     str(d / "model.safetensors"))
    records = [{"caption": "a fox", "video_0_path": "a.mp4",
                "video_1_path": "b.mp4",
                "overall_preference": "Video 1 better"}]
    data = tmp_path / "pairs.json"
    data.write_text(json.dumps(records))
    root = str(tmp_path / "v")
    import shutil

    (tmp_path / "v").mkdir()
    for name, src in zip(("a.mp4", "b.mp4"), videos):
        shutil.copy(src, f"{root}/{name}")
    real = mod.import_qwen2vl_params
    monkeypatch.setattr(mod, "import_qwen2vl_params",
                        lambda state, cfg, dtype, device: real(
                            state, cfg, torch.float32, device))
    results = tmp_path / "res.jsonl"
    cli.main(["--benchmark", "overall", "--judge", "qwen2-vl",
              "--judge-model", str(d), "--byte-tokenizer", "--device", "cpu",
              "--data-json", str(data), "--video-root", root,
              "--num-segments", "4", "--results", str(results)])
    row = json.loads(results.read_text().splitlines()[0])
    state = {k: v.numpy() for k, v in
             tq.export_qwen2vl_state(tp, tcfg).items()}
    jcfg = jq.qwen2vl_config_from_hf(json.loads(
        (d / "config.json").read_text()))
    jp = jq.import_qwen2vl_params(state, jcfg)
    jjudge = jj.Qwen2VLJudge(jcfg, jp, JByteTokenizer(), num_segments=4,
                             attn_impl="xla")
    s0, s1, r0, r1 = jj.judge_pair(jjudge, f"{root}/a.mp4", f"{root}/b.mp4",
                                   "a fox")
    assert (row["score_0"], row["score_1"], row["response_0"],
            row["response_1"]) == (s0, s1, r0, r1)
