"""MJ-VIDEO-4B's decoder layout (Phi-3) in the port against the JAX package
and the original, at tiny dims in fp32 on the CPU.

The JAX decoder has no Phi-3 layer of its own: only the checkpoint layout
differs from InternLM2's (``qkv_proj`` packs [q; k; v] rows, ``gate_up_proj``
[gate; up] rows, the head is ``lm_head``).  So: JAX's export imported by
the port equals JAX's import leaf for leaf, bit for bit, with Hq = Hkv as
in Phi-3 and with GQA; the port's export equals JAX's key for key, bit for
bit, and round-trips; the port's decoder on transformers' ``Phi3Model``
weights gives its hidden states within 2e-5 (as ``tests/test_checkpoint.py``
holds JAX's); ``reward_forward``, ``RewardScorer`` (the ``phi3-chat``
gating pattern passed on both sides) and ``eval/cli.py`` on a checkpoint
directory JAX wrote agree with JAX within atol 2e-5 (the bar of
``tests/test_torch_models.py``).  Then the two satellites: an
``<IMG_CONTEXT>`` id past the vocabulary gives JAX's result, and RoPE
scaling the port does not compute is refused.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu import configs as jconfigs
from mjvideo_tpu.data.prompts import ByteTokenizer as JaxByteTokenizer
from mjvideo_tpu.data.prompts import build_video_question
from mjvideo_tpu.data.prompts import prepare_chat_input as jax_prepare
from mjvideo_tpu.eval import preference as jpref
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models import decoder as jdec
from mjvideo_tpu.models import reward as jreward
from mjvideo_tpu.utils import checkpoint as jckpt
from mjvideo_tpu.utils import export as jexport
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch.data.prompts import ByteTokenizer
from mjvideo_tpu_torch.eval import cli as ecli
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.models import decoder as tdec
from mjvideo_tpu_torch.models import reward as treward
from mjvideo_tpu_torch.ops.rope import rope_tables
from mjvideo_tpu_torch.utils import checkpoint as tckpt
from mjvideo_tpu_torch.utils import export as texport
from mjvideo_tpu_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=1e-5)
BUCKET = 512


def _phi3(pkg, kv_heads=4):
    """``pkg``'s tiny test config with a Phi-3 decoder and template: Hq =
    Hkv = 4 as in Phi-3 (``kv_heads`` 2: GQA)."""
    base = pkg.tiny_test_config()
    llm = dataclasses.replace(base.chat.llm, architecture="phi3",
                              num_key_value_heads=kv_heads,
                              rope_theta=10000.0)
    return dataclasses.replace(base, chat=dataclasses.replace(
        base.chat, llm=llm, template="phi3-chat"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jax_decoder(kv_heads):
    cfg = _phi3(jconfigs, kv_heads).chat.llm
    params = jax.tree.map(np.asarray, jdec.init_decoder_params(
        jax.random.PRNGKey(kv_heads), cfg, with_lm_head=True))
    return cfg, params


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_importer_matches_jax_bit_for_bit(kv_heads):
    cfg_j, params = _jax_decoder(kv_heads)
    cfg_t = _phi3(tconfigs, kv_heads).chat.llm
    state = {k: np.asarray(v) for k, v in
             jexport.export_decoder(params, cfg_j, prefix="").items()}
    assert "model.layers.1.self_attn.qkv_proj.weight" in state
    assert "model.layers.1.mlp.gate_up_proj.weight" in state
    want = _flat(from_jax_params(
        jckpt.import_decoder_params(state, cfg_j, prefix=""), device="cpu"))
    got = _flat(tckpt.import_decoder_params(
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg_t,
        prefix="", device="cpu"))
    assert list(got) == list(want) and "/output/kernel" in got
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.is_contiguous(), name
        assert torch.equal(t, want[name]), name
    no_head = {k: torch.from_numpy(v) for k, v in state.items()
               if k != "lm_head.weight"}
    with pytest.raises(KeyError, match="lm_head.weight"):
        tckpt.import_decoder_params(no_head, cfg_t, prefix="", device="cpu")
    assert "output" not in tckpt.import_decoder_params(
        no_head, cfg_t, prefix="", with_lm_head=False, device="cpu")


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_exporter_matches_jax_and_round_trips(kv_heads):
    cfg_j, params = _jax_decoder(kv_heads)
    cfg_t = _phi3(tconfigs, kv_heads).chat.llm
    state = from_jax_params(params, device="cpu")
    got = texport.export_decoder(state, cfg_t)
    want = jexport.export_decoder(params, cfg_j)
    assert list(got) == list(want)
    assert "language_model.lm_head.weight" in got
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr),
                                      err_msg=name)
    back = tckpt.import_decoder_params(got, cfg_t, device="cpu")
    for name, t in _flat(back).items():
        assert torch.equal(t, _flat(state)[name]), name


def test_decoder_matches_transformers_phi3():
    """The port's decoder on a transformers ``Phi3Model``'s weights (eager
    attention), through the port's importer."""
    from transformers import Phi3Config, Phi3Model

    hf = Phi3Config(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        pad_token_id=0, attn_implementation="eager", resid_pdrop=0.0,
        embd_pdrop=0.0, attention_dropout=0.0)
    torch.manual_seed(1)
    tm = Phi3Model(hf).eval()
    cfg = tconfigs.LLMConfig(
        architecture="phi3", vocab_size=96, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-5,
        max_position_embeddings=128, pad_token_id=0)
    state = {"model." + k: v for k, v in tm.state_dict().items()}
    params = tckpt.import_decoder_params(state, cfg, prefix="",
                                         with_lm_head=False, device="cpu")
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(1, 90, size=(2, 9)))
    mask = torch.ones((2, 9), dtype=torch.int64)
    mask[1, 6:] = 0
    with torch.no_grad():
        want = tm(input_ids=ids, attention_mask=mask).last_hidden_state
        got = tdec.decoder_forward(params, cfg, tdec.embed_tokens(params, ids),
                                   attention_mask=mask, remat=False)
    real = mask.bool()
    np.testing.assert_allclose(got[real].numpy(), want[real].numpy(),
                               atol=2e-5)


@pytest.fixture(scope="module")
def reward_setup():
    """JAX's tiny Phi-3 reward params with non-trivial norms and biases,
    bridged to the port, and two prompts with their image slots."""
    cfg = _phi3(jconfigs)
    params = jax.jit(lambda key: jreward.init_reward_params(key, cfg))(
        jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape).astype(a.dtype)
                   * 0.05 if a.ndim >= 1 and a.shape[-1] > 1 and a.size < 5000
                   else np.asarray(a)), params)
    return cfg, params, from_jax_params(params, device="cpu")


def _reward_inputs(ch, rng, img_id):
    n_img = ch.num_image_token
    T = 2 * n_img + 14
    ids = rng.integers(10, 200, size=(2, T)).astype(np.int32)
    ids[0, 3:3 + n_img] = img_id
    ids[1, 5:5 + n_img] = img_id
    ids[1, T - 4:] = ch.llm.pad_token_id
    mask = (ids != ch.llm.pad_token_id).astype(np.int32)
    pix = rng.normal(size=(2, ch.image_size, ch.image_size, 3)).astype(
        np.float32)
    return pix, ids, mask, np.array([T - 6, T - 9], np.int32)


def _forwards(cfg_j, cfg_t, params, state, inputs):
    ref = jax.jit(lambda p, x, i, m, g: jreward.reward_forward(
        p, cfg_j, x, i, m, g, attn_impl="xla", remat=False))(
            params, *map(jnp.asarray, inputs))
    got = treward.reward_forward(state, cfg_t,
                                 *map(torch.from_numpy, inputs))
    return got, ref


def test_reward_forward_matches_jax_in_every_field(reward_setup):
    cfg, params, state = reward_setup
    inputs = _reward_inputs(cfg.chat, np.random.default_rng(5),
                            cfg.chat.img_context_token_id)
    got, ref = _forwards(cfg, _phi3(tconfigs), params, state, inputs)
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_scorer_matches_jax_with_the_phi3_gating_pattern(reward_setup):
    """A 4B caller passes the ``phi3-chat`` pattern, the byte encoding of
    '<|end|><|assistant|>\\n', on either side."""
    cfg, params, state = reward_setup
    tok = ByteTokenizer()
    pattern = tok.gating_pattern("phi3-chat")
    assert pattern == tuple(JaxByteTokenizer()("<|end|><|assistant|>\n")[
        "input_ids"])
    kw = dict(length_buckets=(BUCKET,), gating_pattern=pattern)
    jax_scorer = JaxRewardScorer(cfg, params, JaxByteTokenizer(),
                                 attn_impl="xla", dtype=jnp.float32, **kw)
    port = RewardScorer(_phi3(tconfigs), state, tok, dtype=torch.float32,
                        **kw)
    ids, gpos = [], []
    for caption, n in (("a dog", 2), ("a cat on a much longer walk", 1)):
        chat = jax_prepare(cfg.chat, JaxByteTokenizer(),
                           build_video_question(caption, n),
                           num_patches_list=[1] * n, gating_pattern=pattern)
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
        assert chat.input_ids[0][chat.gating_pos] == pattern[0]
    size = cfg.chat.image_size
    pix = np.random.default_rng(6).normal(size=(3, size, size, 3)).astype(
        np.float32)
    want = jax_scorer.score_batch(pix, ids, gpos)
    got = port.score_batch(pix, ids, gpos)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_eval_cli_scores_a_jax_phi3_checkpoint_as_jax(reward_setup, tmp_path,
                                                      capsys):
    """A tiny Phi-3 checkpoint directory written by JAX's exporter, scored
    by the port's ``eval/cli.py`` (``--byte-tokenizer``: the gating pattern
    of the checkpoint's ``phi3-chat`` template) against JAX's driver on
    JAX's load of the same directory: scores within atol 2e-5, then the
    metrics exactly where every comparison has a margin above 1e-4."""
    cfg, params, _ = reward_setup
    ckpt = tmp_path / "reward"
    jexport.save_reward_checkpoint_dir(str(ckpt), params, cfg)
    assert json.loads((ckpt / "config.json").read_text())["llm_config"][
        "architectures"] == ["Phi3ForCausalLM"]
    spec = importlib.util.spec_from_file_location(
        "make_sample_data", REPO / "examples" / "make_sample_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    videos = tmp_path / "videos"
    videos.mkdir()
    rng = np.random.default_rng(2)
    records = [mod.make_record(rng, i, str(videos)) for i in range(3)]
    for rec, pref in zip(records, ("Video 2 better", "Same",
                                   "Video 1 better")):
        rec["overall_preference"] = pref
    (tmp_path / "pairs.json").write_text(json.dumps(records))
    res = ecli.main(["--benchmark", "overall", "--device", "cpu", "--fp32",
                     "--byte-tokenizer", "--model-path", str(ckpt),
                     "--data-json", str(tmp_path / "pairs.json"),
                     "--video-root", str(videos), "--num-segments", "2",
                     "--results", str(tmp_path / "p.jsonl")])
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):]) == json.loads(json.dumps(res))
    jcfg, jstate = jckpt.load_reward_model(str(ckpt), dtype=jnp.float32)
    tok = JaxByteTokenizer()
    scorer = JaxRewardScorer(jcfg, jstate, tok, attn_impl="xla",
                             dtype=jnp.float32,
                             gating_pattern=tuple(tok(
                                 "<|end|><|assistant|>\n")["input_ids"]))
    want = jpref.evaluate_preference(scorer, records, root=str(videos),
                                     num_segments=2,
                                     results_path=str(tmp_path / "j.jsonl"))
    rows, ref = ([json.loads(line) for line in (tmp_path / n).read_text(
    ).splitlines()] for n in ("p.jsonl", "j.jsonl"))
    assert [r["id"] for r in rows] == [r["id"] for r in ref]
    for r, w in zip(rows, ref):
        assert set(r) == set(w)
        np.testing.assert_allclose([r["score_0"], r["score_1"]],
                                   [w["score_0"], w["score_1"]], **TOL)
    gaps = np.abs(np.asarray([r["score_0"] - r["score_1"] for r in rows]))
    assert gaps.min() > 1e-4, gaps
    assert res == want and res["count"] == 2


def test_img_context_id_past_the_vocabulary_gives_jax_result(reward_setup):
    """The 4B preset keeps ``img_context_token_id`` 92546 against Phi-3's
    32,064 rows.  JAX's gather clamps the id and the scatter overwrites the
    row; the port gives the same result and clamps no other id."""
    _, params, state = reward_setup
    assert (tconfigs.mjvideo_4b_config().chat.img_context_token_id
            >= tconfigs.mjvideo_4b_config().chat.llm.vocab_size)
    cfg_j, cfg_t = (dataclasses.replace(c, chat=dataclasses.replace(
        c.chat, img_context_token_id=300)) for c in (_phi3(jconfigs),
                                                      _phi3(tconfigs)))
    assert cfg_t.chat.llm.vocab_size == 272
    inputs = _reward_inputs(cfg_t.chat, np.random.default_rng(7), 300)
    got, ref = _forwards(cfg_j, cfg_t, params, state, inputs)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    pix, ids, mask, gpos = inputs
    ids = ids.copy()
    ids[0, -1] = 280  # past the vocabulary and not an image slot
    with pytest.raises(IndexError):
        treward.reward_forward(state, cfg_t, *map(torch.from_numpy, (
            pix, ids, mask, gpos)))


@pytest.mark.parametrize("kind", ["su", "longrope", "yarn"])
def test_rope_scaling_the_port_does_not_compute_is_refused(kind):
    for ok in (None, "linear", "dynamic"):
        cos, sin = rope_tables(16, 8, scaling_type=ok, scaling_factor=2.0,
                               max_position_embeddings=8,
                               device=torch.device("cpu"))
        assert cos.shape == sin.shape == (16, 8)
    with pytest.raises(ValueError, match=repr(kind)):
        rope_tables(16, 8, scaling_type=kind, device=torch.device("cpu"))
    # A config that names it is refused by both packages alike.
    d = dict(jconfigs.reward_config_to_hf(jconfigs.mjvideo_4b_config())[
        "llm_config"], rope_scaling={"type": kind, "factor": 2.0})
    for pkg in (jconfigs, tconfigs):
        with pytest.raises(ValueError, match="rope_scaling_type"):
            pkg.llm_config_from_hf(d)
