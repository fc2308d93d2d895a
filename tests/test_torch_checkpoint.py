"""The port's HF checkpoint importer and exporter, its safetensors reader
and writer, and its HF config readers against the JAX package.

At ``tiny_test_config`` in fp32 on the CPU: a checkpoint directory written
by JAX's ``save_reward_checkpoint_dir`` loads in the port leaf by leaf
bit-equal to ``from_jax_params`` of JAX's import, and scores as JAX's
scorer does on it (atol 2e-5, the bar of ``test_torch_scorer.py``); the
port's exporter writes the key set and the tensors of JAX's export, bit
for bit, as JAX's reader reads them.  The safetensors reader and writer
are held against the ``safetensors`` package, which is the tests' oracle
only: the port never imports it.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as st
import torch

from mjvideo_tpu import configs as jconfigs
from mjvideo_tpu.data.prompts import (ByteTokenizer, build_video_question,
                                      prepare_chat_input)
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models.reward import init_reward_params as jax_init
from mjvideo_tpu.utils import checkpoint as jckpt
from mjvideo_tpu.utils import export as jexport
from mjvideo_tpu_torch import configs as tconfigs
from mjvideo_tpu_torch.eval.scorer import RewardScorer
from mjvideo_tpu_torch.utils import checkpoint as tckpt
from mjvideo_tpu_torch.utils import export as texport
from mjvideo_tpu_torch.utils import safetensors_io as sio
from mjvideo_tpu_torch.utils.bridge import from_jax_params, to_numpy

torch.set_num_threads(1)
BUCKET = 512


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def jax_params():
    cfg = jconfigs.tiny_test_config()
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init(key, cfg))(jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def jax_dir(jax_params, tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ckpt")
    jexport.save_reward_checkpoint_dir(str(path), jax_params,
                                       jconfigs.tiny_test_config())
    return path


# --- the safetensors reader and writer ---------------------------------------

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8,
          torch.int32, torch.int64]


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"a": (3, 5), "b.c": (7,), "scalar": (), "empty": (0, 4),
              "d": (2, 3, 4)}
    out = {}
    for name, shape in shapes.items():
        if dtype.is_floating_point:
            out[name] = (torch.randn(shape, generator=g) * 100).to(dtype)
        else:
            out[name] = torch.randint(-100, 100, shape, generator=g,
                                      dtype=torch.int64).to(dtype)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_and_writer_match_safetensors_package(dtype, tmp_path):
    tensors = _tensors(dtype)
    meta = {"format": "pt", "note": "x"}
    st.save_file(tensors, str(tmp_path / "theirs.safetensors"), metadata=meta)
    sio.save_file(tensors, str(tmp_path / "ours.safetensors"), metadata=meta)
    mine = sio.load_file(str(tmp_path / "theirs.safetensors"))
    theirs = st.load_file(str(tmp_path / "ours.safetensors"))
    for got in (mine, theirs):
        assert set(got) == set(tensors)
        for name, want in tensors.items():
            assert got[name].dtype == dtype and got[name].shape == want.shape
            assert torch.equal(got[name], want), name
    assert sio.read_header(str(tmp_path / "theirs.safetensors"))[1] == meta
    from safetensors import safe_open

    with safe_open(str(tmp_path / "ours.safetensors"), "pt") as f:
        assert f.metadata() == meta


def test_two_shards_in_one_directory(tmp_path):
    a, b = _tensors(torch.float32, 1), _tensors(torch.bfloat16, 2)
    b = {f"second.{k}": v for k, v in b.items()}
    st.save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"),
                 metadata={"format": "pt"})
    sio.save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    got = tckpt.load_safetensors_dir(str(tmp_path))
    assert set(got) == set(a) | set(b)
    for name, want in {**a, **b}.items():
        assert got[name].dtype == want.dtype
        assert torch.equal(got[name], want), name
    with pytest.raises(FileNotFoundError):
        tckpt.load_safetensors_dir(str(tmp_path / "nothing_here"))


def test_writer_stores_values_of_non_contiguous_tensors(tmp_path):
    """A transposed or permuted view is written by value: the JAX exporter
    once wrote the patch-conv view in its storage's order."""
    base = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    views = {"t": base[0, 0].T, "p": base.permute(3, 2, 0, 1),
             "s": base[:, ::2, 1]}
    assert not any(v.is_contiguous() for v in views.values())
    sio.save_file(views, str(tmp_path / "v.safetensors"))
    theirs = st.load_file(str(tmp_path / "v.safetensors"))
    mine = sio.load_file(str(tmp_path / "v.safetensors"))
    for name, v in views.items():
        assert torch.equal(theirs[name], v) and torch.equal(mine[name], v)


def test_writer_casts_and_aligns(tmp_path):
    tensors = {"i8": torch.arange(3, dtype=torch.int8),
               "f": torch.randn(3, 4, dtype=torch.bfloat16)}
    sio.save_file(tensors, str(tmp_path / "c.safetensors"),
                  dtype=torch.float32)
    header, meta, start = sio.read_header(str(tmp_path / "c.safetensors"))
    assert meta is None and start % 8 == 0
    assert {e["dtype"] for e in header.values()} == {"F32"}
    got = st.load_file(str(tmp_path / "c.safetensors"))
    for name, t in tensors.items():
        assert torch.equal(got[name], t.float())


# --- configs -----------------------------------------------------------------

def _with_tokenizer_fields(cfg2, cfg):
    """``cfg2`` with ``cfg``'s special-token ids and gating pattern: the HF
    dict leaves them to the tokenizer, which assigns them at load time."""
    return dataclasses.replace(
        cfg2, chat=dataclasses.replace(
            cfg2.chat, img_context_token_id=cfg.chat.img_context_token_id,
            img_start_token_id=cfg.chat.img_start_token_id,
            img_end_token_id=cfg.chat.img_end_token_id),
        gating_token_pattern=cfg.gating_token_pattern)


def _llm_dict(arch):
    d = jconfigs.reward_config_to_hf(jconfigs.tiny_test_config())["llm_config"]
    d = dict(d, architectures=[arch])
    if arch == "LlamaForCausalLM":
        d.pop("bias")
        d["attention_bias"] = True
        d["rope_scaling"] = {"type": "linear", "factor": 2.0}
    return d


@pytest.mark.parametrize("arch", ["InternLM2ForCausalLM", "LlamaForCausalLM",
                                  "Phi3ForCausalLM"])
def test_llm_config_from_hf_matches_jax(arch):
    d = _llm_dict(arch)
    got = dataclasses.asdict(tconfigs.llm_config_from_hf(d))
    assert got == dataclasses.asdict(jconfigs.llm_config_from_hf(d))
    with pytest.raises(ValueError, match="Unsupported"):
        tconfigs.llm_config_from_hf(dict(d, architectures=["GPT2"]))


@pytest.mark.parametrize("name", ["tiny_test_config", "mjvideo_2b_config",
                                  "mjvideo_4b_config"])
def test_config_json_equal_to_jax_and_round_trips(name, tmp_path):
    cfg_t, cfg_j = getattr(tconfigs, name)(), getattr(jconfigs, name)()
    d = tconfigs.reward_config_to_hf(cfg_t)
    assert d == jconfigs.reward_config_to_hf(cfg_j)
    (tmp_path / "config.json").write_text(json.dumps(d))
    back = tconfigs.load_config(str(tmp_path / "config.json"))
    assert _with_tokenizer_fields(back, cfg_t) == cfg_t
    assert (dataclasses.asdict(back) == dataclasses.asdict(
        jconfigs.load_config(str(tmp_path / "config.json"))))
    assert json.loads(tconfigs.to_json(back)) == json.loads(
        jconfigs.to_json(jconfigs.load_config(str(tmp_path / "config.json"))))


# --- the importer and the exporter -------------------------------------------

def test_unpack_and_pack_wqkv_match_jax():
    cfg_t = tconfigs.tiny_test_config().chat.llm
    cfg_j = jconfigs.tiny_test_config().chat.llm
    Hq, Hkv, D, C = (cfg_t.num_attention_heads, cfg_t.num_key_value_heads,
                     cfg_t.head_dim, cfg_t.hidden_size)
    w = np.random.default_rng(0).normal(
        size=((Hq + 2 * Hkv) * D, C)).astype(np.float32)
    got = tckpt.unpack_wqkv(torch.from_numpy(w), cfg_t)
    want = jckpt.unpack_wqkv(w, cfg_j)
    for part in ("q", "k", "v"):
        np.testing.assert_array_equal(got[part].numpy(), want[part])
    packed = texport.pack_wqkv(got["q"], got["k"], got["v"], cfg_t)
    np.testing.assert_array_equal(
        packed.numpy(), jexport.pack_wqkv(want["q"], want["k"], want["v"],
                                          cfg_j))
    np.testing.assert_array_equal(packed.numpy(), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_jax_checkpoint_loads_bit_equal_to_bridge(jax_dir, dtype):
    cfg, state = tckpt.load_reward_model(str(jax_dir), dtype=dtype,
                                         device="cpu")
    assert cfg == tconfigs.load_config(str(jax_dir / "config.json"))
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    _, jstate = jckpt.load_reward_model(str(jax_dir), dtype=jdtype)
    want = _flat(from_jax_params(jstate, device="cpu"))
    got = _flat(state)
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.dtype == want[name].dtype == dtype, name
        assert t.shape == want[name].shape and t.is_contiguous(), name
        assert torch.equal(t, want[name]), name


def _requests(cfg, tok):
    rng = np.random.default_rng(0)
    ids, gpos = [], []
    for caption in ("a dog", "a cat on a much longer walk"):
        chat = prepare_chat_input(cfg.chat, tok, build_video_question(
            caption, 1), num_patches_list=[1],
            gating_pattern=tok.gating_pattern())
        ids.append(chat.input_ids[0])
        gpos.append(chat.gating_pos)
    size = cfg.chat.image_size
    pix = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    return pix, ids, gpos


def test_loaded_checkpoint_scores_match_jax(jax_dir):
    tok = ByteTokenizer()
    kw = dict(length_buckets=(BUCKET,), gating_pattern=tok.gating_pattern())
    jcfg, jstate = jckpt.load_reward_model(str(jax_dir), dtype=jnp.float32)
    jax_scorer = JaxRewardScorer(jcfg, jstate, tok, attn_impl="xla",
                                 dtype=jnp.float32, **kw)
    cfg, state = tckpt.load_reward_model(str(jax_dir), dtype=torch.float32,
                                         device="cpu")
    port = RewardScorer(cfg, state, tok, dtype=torch.float32, **kw)
    pix, ids, gpos = _requests(port.cfg, tok)
    want = jax_scorer.score_batch(pix, ids, gpos)
    got = port.score_batch(pix, ids, gpos)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-5, err_msg=name)


def test_port_export_reads_back_in_jax_as_jax_export(jax_params, tmp_path):
    cfg_t, cfg_j = tconfigs.tiny_test_config(), jconfigs.tiny_test_config()
    state = from_jax_params(jax_params, device="cpu")
    texport.save_reward_checkpoint_dir(str(tmp_path), state, cfg_t)
    got = jckpt.load_safetensors_dir(str(tmp_path))
    want = jexport.export_reward_checkpoint(jax_params, cfg_j)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == np.float32, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    assert (json.loads((tmp_path / "config.json").read_text())
            == jconfigs.reward_config_to_hf(cfg_j))
    # The in-memory export holds the same values as views of the state.
    mem = texport.export_reward_checkpoint(state, cfg_t)
    assert set(mem) == set(want)
    for name, t in mem.items():
        np.testing.assert_array_equal(t.float().numpy(), want[name],
                                      err_msg=name)


def test_port_round_trip_bit_equal_in_bf16(jax_params, tmp_path):
    """bf16 state -> F32 file -> bf16 state: every leaf bit-equal, the
    patch-conv kernel (exported as a permuted view) among them."""
    cfg = tconfigs.tiny_test_config()
    state = from_jax_params(jax_params, device="cpu", dtype=torch.bfloat16)
    texport.save_reward_checkpoint_dir(str(tmp_path), state, cfg)
    cfg2, back = tckpt.load_reward_model(str(tmp_path), device="cpu")
    assert _with_tokenizer_fields(cfg2, cfg) == cfg
    a, b = _flat(state), _flat(back)
    assert set(a) == set(b)
    assert "/model/vision_model/embeddings/patch_embedding/kernel" in a
    for name in a:
        assert b[name].dtype == torch.bfloat16
        assert torch.equal(a[name], b[name]), name


def test_attention_biases_round_trip(jax_params):
    """An InternLM2 decoder with attention biases (``bias=True``) exports
    its packed ``wqkv`` bias and reads back the same leaves, as the
    importer reads JAX's layout."""
    cfg = tconfigs.tiny_test_config()
    llm = dataclasses.replace(cfg.chat.llm, bias=True)
    cfg = dataclasses.replace(cfg, chat=dataclasses.replace(cfg.chat, llm=llm))
    state = from_jax_params(jax_params, device="cpu")
    attn = state["model"]["language_model"]["layers"]["attention"]
    g = torch.Generator().manual_seed(0)
    for name in ("wq", "wk", "wv", "wo"):
        attn[name]["bias"] = torch.randn(
            (llm.num_hidden_layers, attn[name]["kernel"].shape[-1]),
            generator=g)
    exported = texport.export_reward_checkpoint(state, cfg)
    want = jckpt.import_reward_checkpoint(
        {k: v.float().numpy() for k, v in exported.items()},
        jconfigs.reward_config_from_hf(tconfigs.reward_config_to_hf(cfg)))
    got = tckpt.import_reward_checkpoint(exported, cfg, device="cpu")
    ref = to_numpy(state)
    for name, t in _flat(got).items():
        np.testing.assert_array_equal(t.numpy(), _flat(ref)[name])
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(_flat(want)[name]), err_msg=name)


@pytest.mark.parametrize("arch", ["llama"])
def test_other_decoder_layouts_are_not_ported(arch, jax_params):
    """The Llama layout, which this test once found refused, is ported (the
    VideoScore and MiniCPM-V judges' Mistral and Qwen2): the tiny decoder's
    state under its names reads back leaf for leaf, by the port's importer
    and by JAX's; an architecture of no layout is still refused."""
    llm = dataclasses.replace(tconfigs.tiny_test_config().chat.llm,
                              architecture=arch)
    state = from_jax_params(jax_params, device="cpu")
    lm = state["model"]["language_model"]
    exported = {k: v.contiguous() for k, v in
                texport.export_decoder(lm, llm).items()}
    assert "language_model.model.layers.0.self_attn.q_proj.weight" in exported
    got = tckpt.import_decoder_params(exported, llm, with_lm_head=False,
                                      device="cpu")
    want = jckpt.import_decoder_params(
        {k: v.numpy() for k, v in exported.items()},
        jconfigs.LLMConfig(**dataclasses.asdict(llm)), with_lm_head=False)
    ref = _flat(to_numpy(lm))
    for name, t in _flat(got).items():
        np.testing.assert_array_equal(t.numpy(), ref[name], err_msg=name)
        np.testing.assert_array_equal(t.numpy(), np.asarray(_flat(want)[name]),
                                      err_msg=name)
    with pytest.raises(ValueError, match="unknown architecture"):
        tckpt.import_decoder_params({}, dataclasses.replace(
            llm, architecture="cogvlm2"), device="cpu")


def test_lm_head_missing_raises_and_present_imports(jax_params):
    cfg = tconfigs.tiny_test_config()
    state = from_jax_params(jax_params, device="cpu")
    sd = texport.export_chat(state["model"], cfg.chat)
    with pytest.raises(KeyError, match="output.weight"):
        tckpt.import_chat_params(sd, cfg.chat, device="cpu")
    C, V = cfg.chat.llm.hidden_size, cfg.chat.llm.vocab_size
    head = torch.randn(C, V)
    sd["language_model.output.weight"] = head.T
    got = tckpt.import_chat_params(sd, cfg.chat, device="cpu")
    assert torch.equal(got["language_model"]["output"]["kernel"], head)


def test_entry_points_default_to_the_card_in_bf16():
    import inspect

    sig = inspect.signature(tckpt.load_reward_model).parameters
    assert sig["device"].default == "cuda"
    assert sig["dtype"].default == torch.bfloat16
    for fn in (tckpt.import_reward_checkpoint, tckpt.import_chat_params,
               tckpt.import_vit_params, tckpt.import_decoder_params,
               tckpt.import_projector_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
