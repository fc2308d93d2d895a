"""mjvideo_tpu_torch — the PyTorch and CUDA port of mjvideo_tpu.

The MJ-VIDEO-2B scoring path (``RewardScorer.score_batch`` ->
``reward_forward`` -> ViT -> pixel-shuffle -> projector -> ``<IMG_CONTEXT>``
scatter -> InternLM2 decoder -> reward head), its training step
(``train/``), and cached generation with the InternVL2 judge
(``models/generate.py``, ``eval/judges.py``) in PyTorch, with hand-written
CUDA kernels for the attention forwards and backward and the quantized
products (``kernels.py``, ``csrc/``); quantized serving
(``RewardScorer(quant=...)``, ``InternVLJudge(quant=...)``) through
``ops/quant.py`` and ``ops/quant4.py``.  The JAX package stays the
reference; the port imports nothing of it and keeps its own copies of the
configuration, prompt and video modules (``configs.py``, ``data/``).
"""

from .configs import (  # noqa: F401
    ChatConfig,
    RewardConfig,
    internvl2_2b_chat_config,
    mjvideo_2b_config,
    tiny_test_config,
)
from .data.prompts import (  # noqa: F401
    ByteTokenizer,
    build_video_question,
    prepare_chat_input,
)

from .eval.judges import (  # noqa: F401
    InternVLJudge,
    fine_grained_prompt,
    judge_pair,
    overall_prompt,
    parse_rating,
)
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
from .models.internvl import extract_feature, init_chat_params  # noqa: F401
from .models.reward import (  # noqa: F401
    RewardOutput,
    init_reward_params,
    reward_forward,
)
from .utils.bridge import from_jax_params, map_state  # noqa: F401
