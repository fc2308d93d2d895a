"""mjvideo_tpu_torch — the PyTorch and CUDA port of mjvideo_tpu.

The MJ-VIDEO-2B scoring path (``RewardScorer.score_batch`` ->
``reward_forward`` -> ViT -> pixel-shuffle -> projector -> ``<IMG_CONTEXT>``
scatter -> InternLM2 decoder -> reward head) and MJ-VIDEO-4B's (the
Phi-3-mini decoder: the same layer, its own checkpoint layout), the 2B's
training step (``train/``), cached generation with the InternVL2,
Qwen2-VL, MiniCPM-V-2.6 and CogVLM2-Video judges (``models/generate.py``,
``models/qwen2vl.py``, ``models/minicpmv.py``, ``models/cogvlm2.py``,
``eval/judges.py``) and the
VideoScore regression judge (``models/videoscore.py``: the SigLIP tower
the MiniCPM-V judge shares) in PyTorch, with hand-written
CUDA kernels for the attention forwards and backward and the quantized
products (``kernels.py``, ``csrc/``); quantized serving
(``RewardScorer(quant=...)``, ``InternVLJudge(quant=...)``) through
``ops/quant.py`` and ``ops/quant4.py``.  Serving from a checkpoint
directory and a video: ``load_reward_model`` (the HF safetensors importer,
``utils/checkpoint.py``; ``save_reward_checkpoint_dir`` is its exporter)
-> ``RewardScorer`` -> ``score_video`` / ``score_pair``, with the clip's
frames resized and tiled on the device under ``device_preprocess=True``
(``ops/preprocess.py``).  The benchmark harness: the MJ-BENCH-VIDEO
labels and pair dataset (``data/labels.py``, ``data/dataset.py``), the
metrics and reports (``eval/metrics.py``, ``eval/report.py``), the reward
model's drivers for MJ-BENCH-VIDEO, SafeSora and GenAI-Bench
(``eval/preference.py``), the judge's (``eval/judges.py``),
``Trainer.evaluate``, and the two command-line entry points,
``python -m mjvideo_tpu_torch.eval.cli`` and ``python -m
mjvideo_tpu_torch.train.cli``.  The JAX package stays the reference; the
port imports nothing of it and keeps its own copies of the configuration,
prompt, video, label and dataset modules (``configs.py``, ``data/``).
"""

from .configs import (  # noqa: F401
    ASPECT_NAMES,
    CRITERIA_NAMES,
    ChatConfig,
    RewardConfig,
    internvl2_2b_chat_config,
    internvl2_4b_chat_config,
    load_config,
    mjvideo_2b_config,
    mjvideo_4b_config,
    tiny_test_config,
)
from .data.prompts import (  # noqa: F401
    ByteTokenizer,
    build_video_question,
    prepare_chat_input,
)

from .data.dataset import (  # noqa: F401
    PairCollator,
    PreferencePairDataset,
    batched,
    pool_map,
    prefetch,
)
from .data.labels import deal_preference, pair_record_labels  # noqa: F401
from .eval.judges import (  # noqa: F401
    CogVLM2Judge,
    InternVLJudge,
    MiniCPMVJudge,
    Qwen2VLJudge,
    VideoScoreJudge,
    fine_grained_accuracy,
    fine_grained_prompt,
    judge_pair,
    overall_prompt,
    parse_rating,
    run_fine_grained_benchmark,
    run_genai_benchmark,
    run_overall_benchmark,
)
from .eval.metrics import (  # noqa: F401
    binary_dimension_metrics,
    genai_bench_metrics,
    genai_judge_metrics,
    preference_accuracy,
    strict_and_tie_aware,
)
from .eval.preference import (  # noqa: F401
    evaluate_aspects,
    evaluate_genai_bench,
    evaluate_preference,
    filter_safesora_pairs,
)
from .eval.report import format_table, save_report  # noqa: F401
from .eval.scorer import RewardScorer  # noqa: F401
from .models.generate import (  # noqa: F401
    ChatSession,
    GenerationConfig,
    KVCache,
    PrefixState,
    batch_chat,
    chat,
    generate,
    generate_from_prefix,
    prefill_prefix,
    stack_prefix_states,
    stream_chat,
    stream_generate,
)
from .models.cogvlm2 import (  # noqa: F401
    CogVLM2Config,
    CogVLM2VisionConfig,
    cogvlm2_config_from_hf,
    cogvlm2_forward,
    import_cogvlm2_params,
    init_cogvlm2_params,
)
from .models.internvl import extract_feature, init_chat_params  # noqa: F401
from .models.qwen2vl import (  # noqa: F401
    Qwen2VLConfig,
    Qwen2VLVisionConfig,
    greedy_generate_batch,
    import_qwen2vl_params,
    init_qwen2vl_params,
    qwen2vl_7b_config,
    qwen2vl_config_from_hf,
    qwen2vl_forward,
)
from .models.reward import (  # noqa: F401
    RewardOutput,
    init_reward_params,
    reward_forward,
)
from .utils.bridge import from_jax_params, map_state  # noqa: F401
from .utils.checkpoint import load_reward_model  # noqa: F401
from .utils.export import save_reward_checkpoint_dir  # noqa: F401
