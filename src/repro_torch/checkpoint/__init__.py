"""Checkpoints of parameter and optimizer trees, in the reference's npz
format (``checkpoint/ckpt.py``)."""
from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
