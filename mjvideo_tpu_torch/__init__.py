"""mjvideo_tpu_torch — the PyTorch and CUDA port of mjvideo_tpu.

The MJ-VIDEO-2B scoring path (``RewardScorer.score_batch`` ->
``reward_forward`` -> ViT -> pixel-shuffle -> projector -> ``<IMG_CONTEXT>``
scatter -> InternLM2 decoder -> reward head) in PyTorch, with hand-written
CUDA kernels for the two attention shapes (``kernels.py``, ``csrc/``).  The
JAX package stays the reference; its jax-free configuration and prompt
modules are imported from it rather than copied.
"""

from mjvideo_tpu.configs import (  # noqa: F401
    RewardConfig,
    mjvideo_2b_config,
    tiny_test_config,
)
from mjvideo_tpu.data.prompts import (  # noqa: F401
    ByteTokenizer,
    build_video_question,
    prepare_chat_input,
)

from .eval.scorer import RewardScorer  # noqa: F401
from .models.reward import (  # noqa: F401
    RewardOutput,
    init_reward_params,
    reward_forward,
)
from .utils.bridge import from_jax_params, map_state  # noqa: F401
