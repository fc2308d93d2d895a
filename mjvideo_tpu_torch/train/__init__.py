"""The three-stage reward-model training of ``mjvideo_tpu.train``: losses,
the train step and the ``Trainer`` loop, in PyTorch."""

from .losses import STAGES  # noqa: F401
from .trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    trainable_mask,
    warm_start,
)
