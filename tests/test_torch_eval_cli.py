"""The port's two command-line entry points, ``mjvideo_tpu_torch.train.cli``
and ``mjvideo_tpu_torch.eval.cli``, end to end with ``--device cpu`` at
``tiny_test_config`` in fp32.

The training CLI's stage defaults and parser equal the JAX CLI's; one run
writes a checkpoint, ``train_args.json`` and an eval record; each option
whose machinery the port lacks raises ``NotImplementedError`` naming its
ROADMAP item.  The eval CLI scores records made as
``examples/make_sample_data.py`` makes them from a checkpoint directory
written by the port's ``save_reward_checkpoint_dir`` (the bridged weights
of one JAX state), and its printed JSON is held against the JAX driver
functions (``evaluate_preference``, ``evaluate_aspects``,
``run_overall_benchmark``) on JAX's load of the same directory: the scores
in the results files within atol 2e-5, rtol 1e-5, then the metrics exactly
after asserting that every comparison has a margin above 1e-4.  No test
calls a JAX ``main`` (it would turn on JAX's persistent compilation cache
in the test's worker).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjvideo_tpu.configs import tiny_test_config
from mjvideo_tpu.data.prompts import ByteTokenizer as JaxByteTokenizer
from mjvideo_tpu.eval import judges as jjudges
from mjvideo_tpu.eval import preference as jpref
from mjvideo_tpu.eval.scorer import RewardScorer as JaxRewardScorer
from mjvideo_tpu.models.internvl import init_chat_params as jax_chat_init
from mjvideo_tpu.models.reward import init_reward_params as jax_init
from mjvideo_tpu_torch.eval import cli as ecli
from mjvideo_tpu_torch.train import cli as tcli
from mjvideo_tpu_torch.utils.bridge import from_jax_params, map_state

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
ATOL, RTOL, MARGIN = 2e-5, 1e-5, 1e-4
STATS = ("min", "max", "mean", "std")


def _sample_data_module():
    spec = importlib.util.spec_from_file_location(
        "make_sample_data", REPO / "examples" / "make_sample_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """Three MJ-BENCH-VIDEO pairs (overall preferences: decided both ways
    and 'Same') and four SafeSora records, two of them unanimous."""
    mod = _sample_data_module()
    root = tmp_path_factory.mktemp("cli")
    videos = root / "videos"
    videos.mkdir()
    rng = np.random.default_rng(2)
    records = [mod.make_record(rng, i, str(videos)) for i in range(3)]
    for rec, pref in zip(records, ("Video 2 better", "Same",
                                   "Video 1 better")):
        rec["overall_preference"] = pref
    (root / "pairs.json").write_text(json.dumps(records))
    ss = [mod.make_safesora_record(rng, i, str(videos), unanimous=(i % 2 == 0))
          for i in range(4)]
    (root / "safesora.json").write_text(json.dumps(ss))
    return root, records, ss


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny reward checkpoint directory written by the port."""
    from mjvideo_tpu_torch.utils.export import save_reward_checkpoint_dir

    cfg = tiny_test_config()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init(key, cfg))(jax.random.PRNGKey(3)))
    path = tmp_path_factory.mktemp("ckpt") / "reward"
    from mjvideo_tpu_torch import configs as tconfigs

    save_reward_checkpoint_dir(str(path), from_jax_params(params,
                                                          device="cpu"),
                               tconfigs.tiny_test_config())
    return str(path)


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _assert_margin(a, b=0.0):
    gap = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert gap.min() > MARGIN, gap


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=ATOL, rtol=RTOL)


def _eval(capsys, argv):
    """Run the eval CLI; (returned metrics, printed metrics)."""
    res = ecli.main(argv)
    out = capsys.readouterr().out
    return res, json.loads(out[out.index("{"):])


def _scorer_args(sample, checkpoint, results, benchmark, *extra):
    root = sample[0]
    data = "safesora.json" if benchmark == "safesora" else "pairs.json"
    return ["--benchmark", benchmark, "--device", "cpu", "--fp32",
            "--byte-tokenizer", "--model-path", checkpoint,
            "--data-json", str(root / data),
            "--video-root", str(root / "videos"), "--num-segments", "2",
            "--results", str(results), *extra]


@pytest.fixture(scope="module")
def jax_scorer(checkpoint):
    from mjvideo_tpu.utils.checkpoint import load_reward_model

    cfg, params = load_reward_model(checkpoint, dtype=jnp.float32)
    tok = JaxByteTokenizer()
    return JaxRewardScorer(cfg, params, tok, attn_impl="xla",
                           dtype=jnp.float32,
                           gating_pattern=tok.gating_pattern())


# ------------------------------------------------------------- train CLI

def test_stage_defaults_and_parser_equal_jax():
    from mjvideo_tpu.train import cli as jcli

    assert tcli.REFERENCE_STAGE_DEFAULTS == jcli.REFERENCE_STAGE_DEFAULTS
    for argv in (["--stage", "1", "--train-json", "x"],
                 ["--stage", "3", "--train-json", "x", "--learning-rate",
                  "1e-6", "--no-mse", "--fp32", "--attn", "xla"]):
        got = vars(tcli.build_parser().parse_args(argv))
        want = vars(jcli.build_parser().parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want
    a = tcli.build_parser().parse_args(["--stage", "2", "--train-json", "x"])
    for k in tcli.REFERENCE_STAGE_DEFAULTS[2]:
        assert getattr(a, k) is None  # resolved per stage in main()


def _train_argv(sample, out, *extra):
    root = sample[0]
    return ["--stage", "1", "--tiny", "--fp32", "--device", "cpu",
            "--train-json", str(root / "pairs.json"),
            "--video-root", str(root / "videos"), "--output-dir", str(out),
            "--batch-size", "1", "--num-segments", "2", "--max-length", "512",
            *extra]


def test_train_cli_runs_a_step_saves_and_evaluates(sample, tmp_path):
    out = tmp_path / "ckpt"
    tcli.main(_train_argv(sample, out, "--max-steps", "1", "--log-every",
                          "1", "--eval-json", str(sample[0] / "pairs.json")))
    assert sorted(p.name for p in out.glob("stage1_step*.pt")) == [
        "stage1_step1.pt"]
    args = json.loads((out / "train_args.json").read_text())
    assert args["device"] == "cpu" and args["warmup_steps"] == 25
    assert args["gradient_accumulation_steps"] == 8
    logged = _lines(out / "metrics.jsonl")
    assert np.isfinite(logged[0]["loss"]) and logged[0]["step"] == 1
    evals = [r for r in logged if "eval" in r]
    assert len(evals) == 2  # Trainer.evaluate's line and the epoch's
    assert evals[-1]["epoch"] == 0
    assert evals[-1]["eval"]["preference"]["count"] == 2
    assert len(evals[-1]["eval"]["criteria"]) == 28
    assert len(evals[-1]["eval"]["aspects"]) == 5


def test_train_cli_warm_start_and_attn(sample, tmp_path, monkeypatch):
    """``--warm-start`` restores the previous stage's weights; ``--attn``
    maps onto the port's ``attn_impl``; stage 3 trains on decided pairs."""
    from mjvideo_tpu_torch.train import trainer as ttrainer

    first = tmp_path / "s1"
    tcli.main(_train_argv(sample, first, "--max-steps", "1"))
    made = {}

    class Stop(Exception):
        pass

    class Capture(ttrainer.Trainer):
        def __init__(self, cfg, params, tc, sp_group=None):
            made.update(params=params, tc=tc)
            raise Stop

    monkeypatch.setattr(ttrainer, "Trainer", Capture)
    for attn, impl in (("xla", "plain"), ("flash", "auto"), (None, "auto")):
        argv = _train_argv(sample, tmp_path / "s3", "--warm-start",
                           str(first / "stage1_step1.pt"))
        argv[1] = "3"
        with pytest.raises(Stop):
            tcli.main(argv + (["--attn", attn] if attn else []))
        assert made["tc"].attn_impl == impl and made["tc"].stage == 3
    saved = torch.load(first / "stage1_step1.pt")["params"]
    got = ttrainer.flatten_state(made["params"])
    for k, v in ttrainer.flatten_state(saved).items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("flags,item", [
    (["--optimizer", "adafactor"], "item 9"),
    (["--bf16-adam-mu"], "item 9"),
    (["--zero1"], "items 9 and 12"),
    (["--lora-rank", "4"], "items 9 and 11"),
    (["--async-checkpoint"], "item 9"),
    (["--remat-policy", "dots"], "item 9"),
    (["--tp", "2"], "item 12"),
    (["--dp", "2"], "item 12"),
])
def test_train_cli_refuses_what_is_not_ported(sample, tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        tcli.main(_train_argv(sample, tmp_path, "--max-steps", "1", *flags))


@pytest.mark.parametrize("which", ["train", "eval"])
def test_clis_default_to_the_card(sample, checkpoint, tmp_path, which):
    """Without ``--device cpu`` both CLIs refuse on a machine without CUDA;
    neither falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    if which == "train":
        argv = _train_argv(sample, tmp_path, "--max-steps", "1")
        i = argv.index("--device")
        run = tcli.main
    else:
        argv = _scorer_args(sample, checkpoint, tmp_path / "r.jsonl",
                            "overall")
        i = argv.index("--device")
        run = ecli.main
    del argv[i:i + 2]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(argv)
    assert not (tmp_path / "r.jsonl").exists()


# -------------------------------------------------------------- eval CLI

def _preference_against_jax(got, want, rows, ref):
    assert [r["id"] for r in rows] == [r["id"] for r in ref]
    for r, w in zip(rows, ref):
        assert set(r) == set(w)
        _close([r["score_0"], r["score_1"]], [w["score_0"], w["score_1"]])
    _assert_margin([r["score_0"] for r in rows], [r["score_1"] for r in rows])
    assert got == want


@pytest.mark.parametrize("benchmark", ["overall", "safesora"])
def test_eval_cli_preference_matches_jax_driver(sample, checkpoint,
                                                jax_scorer, capsys, tmp_path,
                                                benchmark):
    root, records, ss = sample
    res, printed = _eval(capsys, _scorer_args(
        sample, checkpoint, tmp_path / "p.jsonl", benchmark))
    assert printed == json.loads(json.dumps(res))
    recs = records if benchmark == "overall" else jpref.filter_safesora_pairs(
        ss)
    want = jpref.evaluate_preference(jax_scorer, recs,
                                     root=str(root / "videos"),
                                     num_segments=2,
                                     results_path=str(tmp_path / "j.jsonl"))
    _preference_against_jax(res, want, _lines(tmp_path / "p.jsonl"),
                            _lines(tmp_path / "j.jsonl"))
    assert res["count"] == 2


def test_eval_cli_aspects_matches_jax_driver(sample, checkpoint, jax_scorer,
                                             capsys, tmp_path):
    root, records, _ = sample
    res, printed = _eval(capsys, _scorer_args(
        sample, checkpoint, tmp_path / "p.jsonl", "aspects"))
    assert printed == json.loads(json.dumps(res))
    want = jpref.evaluate_aspects(jax_scorer, records,
                                  root=str(root / "videos"), num_segments=2,
                                  results_path=str(tmp_path / "j.jsonl"))
    rows, ref = _lines(tmp_path / "p.jsonl"), _lines(tmp_path / "j.jsonl")
    for r, w in zip(rows, ref):
        for key in ("rewards_0", "rewards_1", "aspects_0", "aspects_1"):
            _close(r[key], w[key])
    from mjvideo_tpu_torch.data.labels import pair_record_labels

    labels = [pair_record_labels(rec) for rec in records]
    for key, field, rel in (("criteria", "rewards", "criteria_related"),
                            ("aspects", "aspects", "aspect_related")):
        vals = np.asarray([r[f"{field}_{v}"] for r in rows for v in (0, 1)])
        related = np.asarray([lb[f"video_{v}_{rel}"] for lb in labels
                              for v in (0, 1)], bool)
        _assert_margin(vals[related])
        for g, w in zip(res[key], want[key]):
            assert {k: v for k, v in g.items() if k not in STATS} == {
                k: v for k, v in w.items() if k not in STATS}
            _close([g[s] for s in STATS], [w[s] for s in STATS])
    a0 = np.asarray([r["aspects_0"] for r in rows])
    a1 = np.asarray([r["aspects_1"] for r in rows])
    am = np.stack([lb["aspect_mask"] for lb in labels]).astype(bool)
    _assert_margin(a0[am], a1[am])
    assert res["aspect_preference"] == want["aspect_preference"]


def test_eval_cli_quant_and_device_preprocess(sample, checkpoint, capsys,
                                              tmp_path, monkeypatch):
    """``--quant int8-wo`` and ``--device-preprocess`` reach the scorer: the
    CLI's result equals ``evaluate_preference`` on a ``RewardScorer`` built
    by hand with them, and holds against JAX's ``evaluate_preference`` on
    JAX's quantized scorer (``quant="int8-wo"``, ``device_preprocess``) on
    the same weights.  At ``tiny_test_config`` the default size floor
    (``min_elements`` 1 << 16) quantizes nothing, so both packages'
    quantizers run with 1024 here."""
    from mjvideo_tpu_torch.data.prompts import ByteTokenizer
    from mjvideo_tpu_torch.eval import scorer as tscorer
    from mjvideo_tpu_torch.eval.preference import evaluate_preference
    from mjvideo_tpu_torch.eval.scorer import RewardScorer
    from mjvideo_tpu_torch.ops.quant import quant_nodes, quantize_params_mode
    from mjvideo_tpu_torch.utils.checkpoint import load_reward_model

    modes = []

    def quantize(params, mode):
        modes.append(mode)
        return quantize_params_mode(params, mode, min_elements=1024)

    monkeypatch.setattr(tscorer, "quantize_params_mode", quantize)
    root, records, _ = sample
    res, _ = _eval(capsys, _scorer_args(
        sample, checkpoint, tmp_path / "p.jsonl", "overall", "--quant",
        "int8-wo", "--device-preprocess"))
    cfg, state = load_reward_model(checkpoint, dtype=torch.float32,
                                   device="cpu")
    tok = ByteTokenizer()
    scorer = RewardScorer(cfg, state, tok, dtype=torch.float32,
                          gating_pattern=tok.gating_pattern(),
                          quant="int8-wo", device_preprocess=True)
    assert quant_nodes(scorer.params)
    assert modes == ["int8-wo", "int8-wo"]
    want = evaluate_preference(scorer, records, root=str(root / "videos"),
                               num_segments=2,
                               results_path=str(tmp_path / "h.jsonl"))
    assert res == want
    assert _lines(tmp_path / "p.jsonl") == _lines(tmp_path / "h.jsonl")

    import mjvideo_tpu.ops.quant as jquant
    from mjvideo_tpu.utils.checkpoint import load_reward_model as jax_load

    jquantize = jquant.quantize_params_mode
    monkeypatch.setattr(jquant, "quantize_params_mode",
                        lambda params, mode: jquantize(params, mode,
                                                       min_elements=1024))
    jcfg, jparams = jax_load(checkpoint, dtype=jnp.float32)
    jtok = JaxByteTokenizer()
    jax_q = JaxRewardScorer(jcfg, jparams, jtok, attn_impl="xla",
                            dtype=jnp.float32,
                            gating_pattern=jtok.gating_pattern(),
                            quant="int8-wo", device_preprocess=True)
    assert jquant.is_quantized(jax_q.params)
    jwant = jpref.evaluate_preference(jax_q, records,
                                      root=str(root / "videos"),
                                      num_segments=2,
                                      results_path=str(tmp_path / "j.jsonl"))
    _preference_against_jax(res, jwant, _lines(tmp_path / "p.jsonl"),
                            _lines(tmp_path / "j.jsonl"))


def test_eval_cli_sp_forms_a_local_group(sample, checkpoint, monkeypatch):
    """``--sp ring --dp 2`` scores over ``SequenceGroup.local(2)``."""
    from mjvideo_tpu_torch.eval import preference

    made = {}

    def capture(scorer, records, **kw):
        made["sp"] = scorer.sp
        return {}

    monkeypatch.setattr(preference, "evaluate_preference", capture)
    ecli.main(_scorer_args(sample, checkpoint, "unused.jsonl", "overall",
                           "--sp", "ring", "--dp", "2"))
    assert made["sp"]["kind"] == "ring"
    assert made["sp"]["group"].size == 2 and made["sp"]["group"].is_local
    with pytest.raises(SystemExit):
        ecli.main(_scorer_args(sample, checkpoint, "unused.jsonl", "overall",
                               "--sp", "ring"))


@pytest.mark.parametrize("judge", list(ecli.NOT_PORTED_JUDGES))
def test_eval_cli_refuses_the_other_judges(judge):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 10"):
        ecli.main(["--benchmark", "overall", "--device", "cpu", "--judge",
                   judge, "--judge-model", "unused"])


def test_eval_cli_refuses_data_parallel(sample, checkpoint):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        ecli.main(_scorer_args(sample, checkpoint, "unused.jsonl", "overall",
                               "--dp", "2"))


@pytest.fixture(scope="module")
def chat_dir(tmp_path_factory):
    """A tiny chat checkpoint directory (with the LM head) written by the
    port's exporter, and the JAX state it came from."""
    from mjvideo_tpu_torch import configs as tconfigs
    from mjvideo_tpu_torch.utils.export import export_chat, save_safetensors

    cfg = tconfigs.tiny_test_config()
    params = jax_chat_init(jax.random.PRNGKey(1), tiny_test_config().chat,
                           with_lm_head=True)
    path = tmp_path_factory.mktemp("judge")
    save_safetensors(export_chat(from_jax_params(params, device="cpu"),
                                 cfg.chat), str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(
        tconfigs.reward_config_to_hf(cfg)))
    return str(path), params


@pytest.mark.parametrize("flag,kw", [
    ("--kv-quant", {"kv_quant": True}),
    ("--no-prefix-cache", {"prefix_cache": False}),
], ids=["kv_quant", "no_prefix_cache"])
def test_eval_cli_internvl_judge_matches_jax_driver(sample, chat_dir, capsys,
                                                    tmp_path, monkeypatch,
                                                    flag, kw):
    """The CLI loads a judge in bf16, as JAX's does; for the fp32
    comparison this test loads it in fp32 by patching the importer."""
    import mjvideo_tpu_torch.utils.checkpoint as tckpt

    load = tckpt.import_chat_params
    monkeypatch.setattr(tckpt, "import_chat_params",
                        lambda state, cfg, dtype, **kw: load(
                            state, cfg, torch.float32, **kw))
    root, records, _ = sample
    path, params = chat_dir
    res, _ = _eval(capsys, [
        "--benchmark", "overall", "--device", "cpu", "--fp32",
        "--byte-tokenizer", "--judge", "internvl-chat", "--judge-model",
        path, flag, "--data-json", str(root / "pairs.json"), "--limit", "2",
        "--video-root", str(root / "videos"), "--num-segments", "2",
        "--results", str(tmp_path / "p.jsonl")])
    judge = jjudges.InternVLJudge(tiny_test_config().chat, params,
                                  JaxByteTokenizer(), num_segments=2,
                                  attn_impl="xla", **kw)
    want = jjudges.run_overall_benchmark(
        judge, records[:2], root=str(root / "videos"),
        results_path=str(tmp_path / "j.jsonl"))
    assert _lines(tmp_path / "p.jsonl") == _lines(tmp_path / "j.jsonl")
    assert res == want


def test_eval_cli_loads_the_judge_in_bf16(chat_dir):
    """``--fp32`` applies to the reward model only: the judge's weights are
    bf16, as the JAX CLI loads them."""
    path, _ = chat_dir
    args = ecli.build_parser().parse_args([
        "--benchmark", "overall", "--device", "cpu", "--fp32",
        "--byte-tokenizer", "--judge", "internvl-chat", "--judge-model",
        path])
    dtypes = set()
    map_state(lambda t: dtypes.add(t.dtype), ecli._make_judge(args).params)
    assert dtypes == {torch.bfloat16}
