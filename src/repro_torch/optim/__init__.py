"""Optimizers and learning-rate schedules (counterpart of
``repro.optim``): ``Sgd``, ``Momentum``, ``AdamW`` and the paper's
``DelayAdaptiveOptimizer`` over pytrees of tensors."""
from .optimizers import (AdamW, DelayAdaptiveOptimizer, DelayAdaptiveState,
                         Momentum, Sgd, apply_updates, clip_by_global_norm,
                         global_norm, make_optimizer)
from .schedules import SCHEDULES, constant, cosine_decay, linear_warmup

__all__ = [k for k in dir() if not k.startswith("_")]
