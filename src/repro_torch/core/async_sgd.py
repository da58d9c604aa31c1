"""Delay-adaptive Asynchronous (Prox-)SGD -- the paper's §5 extension
(counterpart of ``repro.core.async_sgd``).

PIAG's gradient table costs n x |params| memory; the table-free variant
applies each arriving (delayed) gradient directly:

    gamma_k   chosen delay-adaptively from tau_k   (core.stepsize)
    x_{k+1} = prox_{gamma_k R}(x_k - gamma_k d_k)

where ``d_k`` is the (optionally momentum-filtered, weight-decayed) update
direction built from the stale gradient.  Parameters and gradients are
pytrees of tensors (dicts of tensors, ``core.pytree``); every update is
functional (new tensors, nothing written in place) and runs under
``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from .prox import ProxOp, Zero, tree_prox
from .pytree import tree_leaves, tree_map
from .stepsize import StepsizePolicy, StepsizeState, f32

Pytree = Any

__all__ = ["AsyncOptState", "AsyncSGD", "tree_scale_add"]


def tree_scale_add(x: Pytree, y: Pytree, alpha) -> Pytree:
    return tree_map(lambda a, b: a + alpha * b, x, y)


class AsyncOptState(NamedTuple):
    step: torch.Tensor            # master write-event counter k (int32)
    ss: StepsizeState             # delay-adaptive step-size state
    momentum: Optional[Pytree]    # momentum buffer (None if beta == 0)
    worker_stamp: torch.Tensor    # (n_workers,) iterate version each worker read


def _device_of(params: Pytree) -> torch.device:
    leaves = tree_leaves(params)
    if not leaves:
        raise ValueError("parameter tree has no tensors")
    return leaves[0].device


@dataclasses.dataclass(frozen=True)
class AsyncSGD:
    """Delay-adaptive async SGD/momentum with composite prox step.

    ``lr_scale`` rescales the emitted gamma (the theory's gamma' already
    encodes 1/L; for deep nets L is unknown so gamma' is a tuned base LR and
    the *relative* delay adaptation is what the paper contributes).  State
    lives on the parameters' device.
    """

    policy: StepsizePolicy
    prox: ProxOp = Zero()
    beta: float = 0.0            # momentum
    weight_decay: float = 0.0    # decoupled weight decay
    lr_scale: float = 1.0
    n_workers: int = 1
    horizon: int = 4096

    def init(self, params: Pytree) -> AsyncOptState:
        dev = _device_of(params)
        mom = None
        if self.beta > 0:
            mom = tree_map(torch.zeros_like, params)
        return AsyncOptState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            ss=self.policy.init(self.horizon, device=dev),
            momentum=mom,
            worker_stamp=torch.zeros((self.n_workers,), dtype=torch.int32,
                                     device=dev),
        )

    def observe(self, state: AsyncOptState, worker
                ) -> Tuple[torch.Tensor, AsyncOptState]:
        """Algorithm-1-style delay bookkeeping: the arriving gradient from
        ``worker`` was computed at version worker_stamp[worker]; the worker
        then picks up the new iterate (version k+1)."""
        w = torch.as_tensor(worker, dtype=torch.int64,
                            device=state.step.device)
        tau = state.step - state.worker_stamp[w]
        stamps = state.worker_stamp.clone()
        stamps[w] = state.step + 1
        return tau, state._replace(worker_stamp=stamps)

    @torch.no_grad()
    def apply(self, params: Pytree, grads: Pytree, state: AsyncOptState,
              tau) -> Tuple[Pytree, AsyncOptState, torch.Tensor]:
        """One master write event: delay-adaptive gamma, momentum, prox."""
        gamma, ss = self.policy.step(state.ss, tau)
        lr = f32(self.lr_scale, gamma) * gamma
        if self.beta > 0:
            beta = f32(self.beta, gamma)
            mom = tree_map(lambda m, g: beta * m + g, state.momentum, grads)
            direction = mom
        else:
            mom = state.momentum
            direction = grads
        if self.weight_decay > 0:
            wd = f32(self.weight_decay, gamma)
            direction = tree_map(lambda d, p: d + wd * p, direction, params)
        shifted = tree_map(lambda p, d: p - lr * d, params, direction)
        new_params = tree_prox(self.prox, shifted, lr)
        new_state = AsyncOptState(step=state.step + 1, ss=ss, momentum=mom,
                                  worker_stamp=state.worker_stamp)
        return new_params, new_state, gamma

    def update(self, params: Pytree, grads: Pytree, state: AsyncOptState,
               worker) -> Tuple[Pytree, AsyncOptState, torch.Tensor,
                                torch.Tensor]:
        """observe + apply in one call."""
        tau, state = self.observe(state, worker)
        params, state, gamma = self.apply(params, grads, state, tau)
        return params, state, gamma, tau
