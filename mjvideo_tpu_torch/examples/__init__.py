"""Runnable examples of the port's entry points (``python -m
mjvideo_tpu_torch.examples.<name>``)."""
