"""Evaluation CLI: ``python -m mjvideo_tpu_torch.eval.cli --benchmark ...``

The port's counterpart of ``mjvideo_tpu/eval/cli.py``, which replaces the
reference's 40 per-(benchmark x model) scripts under ``scripts/eval/``: pick
a benchmark (overall / aspects / fine-grained / genai / safesora) and the
MJ-Video reward model (``--model-path``), the InternVL chat judge
(``--judge internvl-chat --judge-model DIR``), the Qwen2-VL, MiniCPM-V-2.6,
CogVLM2-Video or VideoScore judge (``--judge
qwen2-vl|minicpm-v|cogvlm2|videoscore --judge-model DIR``, an HF checkpoint
directory of that model; VideoScore scores the overall, safesora and genai
benchmarks); results stream to JSONL
(``--results``), and a rerun resumes from the file.  The metrics JSON is
printed on stdout.

It runs on the card (``--device cuda``, the default; a machine without one
refuses) unless ``--device cpu`` asks for the CPU.  As in the JAX CLI,
``--fp32`` applies to the reward model only: a judge is loaded in bf16.
Under ``--byte-tokenizer`` the VideoScore judge's tokenizer maps
``<image>`` and ``<fake_token_around_image>`` to the config's
``image_token_id`` and the id before it (Idefics2's 32001 and 32000).
Not ported: the API judges (gpt4o, gemini; ROADMAP Queue 1 item 10),
data
parallelism (``--dp`` > 1 without ``--sp``, or a group across processes;
item 12), and the JAX CLI's ``MJV_PLATFORM`` backend pin and persistent
compilation cache, which only the TPU needed.  ``--sp`` scores each pair
sequence-parallel over ``SequenceGroup.local(--dp)`` in this process.
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.prompts import load_tokenizer
from ..utils.device import resolve_device

# Judges of the JAX CLI that wait for ROADMAP Queue 1 item 10: the API
# judges.
NOT_PORTED_JUDGES = ("gpt4o", "gemini")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MJ-Video evaluator (PyTorch)")
    p.add_argument("--benchmark",
                   choices=("overall", "aspects", "fine-grained", "genai",
                            "safesora"),
                   required=True,
                   help="'aspects'/'fine-grained': per-dimension metrics — "
                        "scorer mode reads the reward heads directly; judge "
                        "mode asks per-category/subcategory rating prompts")
    p.add_argument("--data-json", default=None,
                   help="records JSON (MJ-BENCH-VIDEO / SafeSora format)")
    p.add_argument("--video-root", default="")
    p.add_argument("--model-path", default=None,
                   help="reward checkpoint dir (scorer mode)")
    p.add_argument("--judge", default=None,
                   choices=(None, "internvl-chat", "qwen2-vl", "minicpm-v",
                            "cogvlm2", "videoscore") + NOT_PORTED_JUDGES,
                   help="use a baseline judge instead of the reward scorer "
                        "(internvl-chat, qwen2-vl, minicpm-v, cogvlm2 and "
                        "videoscore are ported)")
    p.add_argument("--judge-model", default=None,
                   help="the judge's checkpoint dir (config.json and "
                        "safetensors)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--num-segments", type=int, default=8)
    p.add_argument("--results", default=None, help="incremental JSONL path")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel size (not ported beyond 1); with "
                        "--sp, the number of sequence shards")
    p.add_argument("--sp", default=None, choices=(None, "ring", "allgather"),
                   help="sequence-parallel decoder attention over --dp "
                        "shards in this process (long-context mode)")
    p.add_argument("--device-preprocess", action="store_true",
                   help="ship decoded uint8 frames; resize, tiling and "
                        "normalisation on the device")
    p.add_argument("--max-num", type=int, default=1,
                   help="dynamic-tiling ceiling per frame "
                        "(reference reward default 1; high-res config 12)")
    p.add_argument("--device-batch", type=int, default=None,
                   help="clips per device dispatch (default: the scorer's, "
                        "the measured optimum)")
    p.add_argument("--quant", default=None,
                   help="serving quantization (ops.quant."
                        "quantize_params_mode): 'int8', 'int8-vit', "
                        "'int8-wo', 'int4-wo', with -noattn / -gN suffixes "
                        "on the int8 modes ('int8-noattn-g128' is the "
                        "parity-grade w8a8 mode)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable the judge's per-video prefix KV cache")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache for judge generation; no effect on "
                        "the reward scorer")
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N records (genai streams "
                        "from the hub and ignores it)")
    p.add_argument("--byte-tokenizer", action="store_true",
                   help="hermetic mode: the dependency-free ByteTokenizer "
                        "in place of an HF tokenizer")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                        "runs the kernels' plain twins)")
    return p


def _load_records(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _tokenizer(args, path):
    """(tokenizer, gating pattern or None for the config's)."""
    if args.byte_tokenizer:
        return load_tokenizer(None)
    return load_tokenizer(args.tokenizer or path)


def _dtype(args):
    import torch

    return torch.bfloat16 if args.bf16 else torch.float32


def _sp_group(args):
    """The ``SequenceGroup`` of ``--sp``: ``--dp`` shards in this process."""
    if not args.sp:
        if args.dp > 1:
            raise NotImplementedError(
                f"--dp {args.dp}: data-parallel scoring is not ported yet: "
                "ROADMAP Queue 1 item 12")
        return None
    if args.dp <= 1:
        raise SystemExit("--sp needs --dp > 1: the number of shards the "
                         "sequence splits into")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "--sp across processes (a distributed sequence group) is not "
            "ported to the CLI yet: ROADMAP Queue 1 item 12")
    from ..parallel.sequence import SequenceGroup

    return SequenceGroup.local(args.dp)


def _make_scorer(args):
    from ..utils.checkpoint import load_reward_model
    from .scorer import RewardScorer

    group = _sp_group(args)
    dtype = _dtype(args)
    cfg, params = load_reward_model(args.model_path, dtype=dtype,
                                    device=resolve_device(args.device))
    tok, pattern = _tokenizer(args, args.model_path)
    if args.byte_tokenizer:
        # The gating text of the checkpoint's template (MJ-VIDEO-4B's
        # phi3-chat has no InternLM2 ChatML boundary to find).
        pattern = tok.gating_pattern(cfg.chat.template)
    kw = {} if args.device_batch is None else {
        "device_batch": args.device_batch}
    return RewardScorer(
        cfg, params, tok, dtype=dtype,
        gating_pattern=cfg.gating_token_pattern if pattern is None
        else pattern,
        device_preprocess=args.device_preprocess,
        device_max_num=args.max_num if args.device_preprocess else 1,
        quant=args.quant, sp=args.sp, sp_group=group, **kw)


def _judge_tokenizer(args, path):
    """The judge's tokenizer: the ``ByteTokenizer`` under
    ``--byte-tokenizer``, else the HF one, its slow class first (InternVL's
    needs it) and the fast one where the checkpoint ships only that
    (Qwen2-family judges), as the JAX CLI loads it (``cli.py:174-185``)."""
    if args.byte_tokenizer:
        return load_tokenizer(None)[0]
    from transformers import AutoTokenizer

    try:
        return AutoTokenizer.from_pretrained(
            args.tokenizer or path, trust_remote_code=True, use_fast=False)
    except (ValueError, OSError):
        return AutoTokenizer.from_pretrained(args.tokenizer or path,
                                             trust_remote_code=True)


def _make_qwen2vl_judge(args, tok, device):
    """The Qwen2-VL judge of ``--judge-model``, in bf16
    (``cli.py:187-199``)."""
    import torch

    from ..models.qwen2vl import import_qwen2vl_params, qwen2vl_config_from_hf
    from ..utils.checkpoint import load_safetensors_dir
    from .judges import Qwen2VLJudge

    path = args.judge_model
    with open(os.path.join(path, "config.json")) as f:
        qcfg = qwen2vl_config_from_hf(json.load(f))
    params = import_qwen2vl_params(load_safetensors_dir(path), qcfg,
                                   dtype=torch.bfloat16, device=device)
    return Qwen2VLJudge(qcfg, params, tok, num_segments=args.num_segments,
                        quant=args.quant, kv_quant=args.kv_quant,
                        prefix_cache=not args.no_prefix_cache)


def _make_minicpmv_judge(args, tok, device):
    """The MiniCPM-V-2.6 judge of ``--judge-model``, in bf16
    (``cli.py:200-214``)."""
    import torch

    from ..models.minicpmv import (
        import_minicpmv_params,
        minicpmv_config_from_hf,
    )
    from ..utils.checkpoint import load_safetensors_dir
    from .judges import MiniCPMVJudge

    path = args.judge_model
    with open(os.path.join(path, "config.json")) as f:
        mcfg = minicpmv_config_from_hf(json.load(f))
    params = import_minicpmv_params(load_safetensors_dir(path), mcfg,
                                    dtype=torch.bfloat16, device=device)
    return MiniCPMVJudge(mcfg, params, tok, num_segments=args.num_segments,
                         quant=args.quant, kv_quant=args.kv_quant,
                         prefix_cache=not args.no_prefix_cache)


def _make_cogvlm2_judge(args, tok, device):
    """The CogVLM2-Video judge of ``--judge-model``: its ``config.json``,
    then its safetensors, imported in bf16 (``cli.py:219-232``)."""
    import torch

    from ..models.cogvlm2 import (
        cogvlm2_config_from_hf,
        import_cogvlm2_params,
    )
    from ..utils.checkpoint import load_safetensors_dir
    from .judges import CogVLM2Judge

    path = args.judge_model
    with open(os.path.join(path, "config.json")) as f:
        ccfg = cogvlm2_config_from_hf(json.load(f))
    params = import_cogvlm2_params(load_safetensors_dir(path), ccfg,
                                   dtype=torch.bfloat16, device=device)
    return CogVLM2Judge(ccfg, params, tok, num_segments=args.num_segments,
                        quant=args.quant, kv_quant=args.kv_quant,
                        prefix_cache=not args.no_prefix_cache)


def _make_videoscore_judge(args):
    """The VideoScore judge of ``--judge-model`` (``cli.py:152-163``), in
    bf16 on ``--device``; its tokenizer the checkpoint's (or
    ``--tokenizer``'s), or under ``--byte-tokenizer`` the ``ByteTokenizer``
    with the config's image-marker ids."""
    from ..data.prompts import ByteTokenizer
    from ..models.videoscore import videoscore_config_from_hf
    from .judges import VideoScoreJudge

    path = args.judge_model
    if path is None:
        raise SystemExit(
            "--judge videoscore needs --judge-model <local VideoScore "
            "checkpoint dir with config.json + safetensors> (plus "
            "--tokenizer if the tokenizer lives elsewhere)")
    if args.byte_tokenizer:
        with open(os.path.join(path, "config.json")) as f:
            vcfg = videoscore_config_from_hf(json.load(f))
        tok = ByteTokenizer(
            pad_token_id=vcfg.text.pad_token_id,
            extra_specials={"<fake_token_around_image>":
                            vcfg.image_token_id - 1,
                            "<image>": vcfg.image_token_id})
    else:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer or path,
                                            trust_remote_code=True)
    return VideoScoreJudge(path, tokenizer=tok,
                           device=resolve_device(args.device))


def _make_judge(args):
    """The judge of ``--judge`` on ``--judge-model``: the InternVL chat
    judge (``config.json`` and safetensors with the LM head), or the
    Qwen2-VL, MiniCPM-V, CogVLM2-Video or VideoScore one."""
    from ..configs import load_config
    from ..data.prompts import rebase_img_context_id
    from ..utils.checkpoint import import_chat_params, load_safetensors_dir
    from .judges import InternVLJudge

    path = args.judge_model
    device = resolve_device(args.device)
    tok = _judge_tokenizer(args, path)
    if args.judge == "qwen2-vl":
        return _make_qwen2vl_judge(args, tok, device)
    if args.judge == "minicpm-v":
        return _make_minicpmv_judge(args, tok, device)
    if args.judge == "cogvlm2":
        return _make_cogvlm2_judge(args, tok, device)
    # The reference's load-time id assignment (README.md:105): a tokenizer
    # whose <IMG_CONTEXT> id differs from the config's would fail
    # prepare_chat_input's scatter-id guard.
    cfg = rebase_img_context_id(
        load_config(os.path.join(path, "config.json")).chat, tok)
    import torch

    params = import_chat_params(load_safetensors_dir(path), cfg,
                                torch.bfloat16, with_lm_head=True,
                                device=device)
    return InternVLJudge(cfg, params, tok, num_segments=args.num_segments,
                         quant=args.quant, kv_quant=args.kv_quant,
                         prefix_cache=not args.no_prefix_cache)


def main(argv=None):
    """Run one benchmark, print its metrics JSON and return them."""
    args = build_parser().parse_args(argv)
    if args.judge in NOT_PORTED_JUDGES:
        raise NotImplementedError(
            f"--judge {args.judge} is not ported yet: ROADMAP Queue 1 item "
            "10 (the API judges)")
    resolve_device(args.device)

    if args.benchmark == "genai":
        from datasets import load_dataset  # HF datasets

        from ..data.video import fetch_remote_video

        ds = load_dataset("TIGER-Lab/GenAI-Bench", "video_generation",
                          split="test_v1")
        if args.judge == "videoscore":
            # Regression scores, good above 2
            # (eval_genai_videoScore.py:160-205).
            from .judges import run_genai_videoscore_benchmark

            res = run_genai_videoscore_benchmark(
                _make_videoscore_judge(args), ds, results_path=args.results,
                fetch=fetch_remote_video)
        elif args.judge:
            # Tie-aware rating comparison (eval_genai_internvl2_2b.py:160-212).
            from .judges import run_genai_benchmark

            res = run_genai_benchmark(_make_judge(args), ds,
                                      results_path=args.results,
                                      fetch=fetch_remote_video)
        else:
            from .preference import evaluate_genai_bench

            res = evaluate_genai_bench(
                _make_scorer(args), ds, num_segments=args.num_segments,
                max_num=args.max_num, results_path=args.results,
                fetch=fetch_remote_video)
    else:
        records = _load_records(args.data_json)
        if args.limit is not None:
            records = records[:args.limit]
        if args.benchmark == "safesora":
            from .preference import filter_safesora_pairs

            records = filter_safesora_pairs(records)
        if args.judge == "videoscore":
            if args.benchmark not in ("overall", "safesora"):
                raise SystemExit(
                    "--judge videoscore supports the overall, safesora and "
                    "genai benchmarks (the reference has no fine-grained "
                    "VideoScore eval)")
            from .judges import run_overall_videoscore_benchmark

            res = run_overall_videoscore_benchmark(
                _make_videoscore_judge(args), records, root=args.video_root,
                results_path=args.results)
        elif args.judge and args.benchmark == "fine-grained":
            from .judges import fine_grained_accuracy, run_fine_grained_benchmark

            res = fine_grained_accuracy(run_fine_grained_benchmark(
                _make_judge(args), records, root=args.video_root,
                results_path=args.results))
        elif args.judge:
            from .judges import run_overall_benchmark

            res = run_overall_benchmark(
                _make_judge(args), records, root=args.video_root,
                results_path=args.results)
        elif args.benchmark in ("aspects", "fine-grained"):
            # Scorer mode: the reward model's criteria and aspect heads are
            # the fine-grained judgment; one forward yields all 33.
            from .preference import evaluate_aspects

            res = evaluate_aspects(
                _make_scorer(args), records, root=args.video_root,
                num_segments=args.num_segments, max_num=args.max_num,
                results_path=args.results)
        else:
            from .preference import evaluate_preference

            res = evaluate_preference(
                _make_scorer(args), records, root=args.video_root,
                num_segments=args.num_segments, max_num=args.max_num,
                results_path=args.results)
    print(json.dumps(res, indent=2, default=float))
    return res


if __name__ == "__main__":
    main()
