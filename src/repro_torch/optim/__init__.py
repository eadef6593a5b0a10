"""Optimizers on flat ``name -> tensor`` dicts, PyTorch port of
``src/repro/optim``."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adamw,
                                          apply_updates, clip_by_global_norm,
                                          constant_schedule, cosine_schedule,
                                          global_norm, momentum, sgd,
                                          warmup_cosine_schedule)
