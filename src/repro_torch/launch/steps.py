"""The trainer's step and the serving steps (counterpart of
``repro.launch.steps``).

``Trainer.train_step`` embeds the paper's mechanism end to end: the
gradient for the arriving worker's batch, write-event delay bookkeeping
(Algorithm 1's ``tau = k - s[worker]``), the delay-adaptive step-size
(principle (8) via core.stepsize) and the (optionally proximal) parameter
update.  Parameters are the reference-layout tree of tensors
(``models.param_tree``); gradients come from ``torch.autograd`` with
respect to its leaves.  ``Trainer.state_specs`` is the train state on the
``meta`` device (shapes only), which the sharding planner plans at full
size.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.prox import ProxOp, Zero
from ..core.pytree import tree_flatten, tree_unflatten
from ..core.stepsize import Adaptive1, StepsizePolicy
from ..models import decode_step, forward, loss_fn, param_tree, prefill
from ..models.config import ModelConfig
from ..optim.optimizers import (AdamW, DelayAdaptiveOptimizer,
                                DelayAdaptiveState, Momentum, Sgd)

__all__ = ["TrainState", "Trainer", "make_trainer", "make_prefill_step",
           "make_serve_step", "loss_and_grad"]


class TrainState(NamedTuple):
    params: Any
    opt: DelayAdaptiveState


def loss_and_grad(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``(loss, metrics, grads)`` of ``models.loss_fn`` at a parameter
    tree; ``grads`` has the tree's structure, everything is detached.  A
    leaf the loss does not read (a VLM's text token table under image
    embeddings) gets a zero gradient, as ``jax.grad`` gives it."""
    leaves, spec = tree_flatten(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(spec, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(spec, list(grads)))


@dataclasses.dataclass(frozen=True)
class Trainer:
    cfg: ModelConfig
    optimizer: DelayAdaptiveOptimizer

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> TrainState:
        """Parameters from the port's initializer (``models.init_params``)
        as the reference-layout tree, and a fresh optimizer state."""
        from ..models import init_params
        params = param_tree(init_params(self.cfg, generator, device=device))
        return TrainState(params=params, opt=self.optimizer.init(params))

    def state_specs(self) -> TrainState:
        """The parameters (``models.param_specs``) and ``optimizer.init``
        of them, every leaf on ``meta``: shapes and dtypes, no allocation
        (the reference's ``jax.eval_shape`` of the state)."""
        from ..models import param_specs
        params = param_specs(self.cfg)
        return TrainState(params=params, opt=self.optimizer.init(params))

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   worker) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, metrics, grads = loss_and_grad(state.params, self.cfg, batch)
        params, opt, gamma, tau = self.optimizer.update(
            state.params, grads, state.opt, worker)
        metrics = dict(metrics)
        metrics.update(loss=loss, gamma=gamma, tau=tau)
        return TrainState(params=params, opt=opt), metrics


def make_trainer(cfg: ModelConfig, policy: Optional[StepsizePolicy] = None,
                 base: str = "adamw", prox: ProxOp = Zero(),
                 n_workers: int = 1, lr: float = 1e-3,
                 grad_clip: Optional[float] = 1.0,
                 weight_decay: float = 0.0) -> Trainer:
    """Default production trainer: delay-adaptive AdamW.

    gamma' (the step-size budget of principle (8)) plays the base-LR role;
    the emitted gamma_k scales the AdamW update by the observed staleness."""
    policy = policy or Adaptive1(gamma_prime=lr, alpha=0.9)
    bases = {"adamw": AdamW(weight_decay=weight_decay),
             "momentum": Momentum(), "sgd": Sgd()}
    opt = DelayAdaptiveOptimizer(
        policy=policy, base=bases[base],
        prox=prox, grad_clip=grad_clip, n_workers=n_workers, horizon=1024)
    return Trainer(cfg=cfg, optimizer=opt)


def make_prefill_step(cfg: ModelConfig, window: Optional[int] = None,
                      ring: bool = False) -> Callable:
    if cfg.has_decode:
        def prefill_step(params, batch):
            return prefill(params, cfg, batch, window=window, ring=ring)
        return prefill_step

    @torch.inference_mode()
    def encode_step(params, batch):  # encoder-only: logits, no cache
        logits, _ = forward(params, cfg, batch)
        return logits
    return encode_step


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None,
                    ring: bool = False) -> Callable:
    def serve_step(params, cache, token, pos):
        return decode_step(params, cfg, cache, token, pos, window=window,
                           ring=ring)
    return serve_step
