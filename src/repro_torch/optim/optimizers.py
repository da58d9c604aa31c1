"""Optimizers over pytrees of tensors (counterpart of
``repro.optim.optimizers``).

``Sgd`` / ``Momentum`` / ``AdamW`` share the reference's functional
(init, update) interface:
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates, lr)

The delay-adaptive learning rate from the paper is deliberately kept
*outside* these rules: ``DelayAdaptiveOptimizer`` composes any base rule with
a ``core.stepsize`` policy -- gamma_k multiplies the update and is chosen
from the observed write-event staleness (the paper's §5).

Every update returns new tensors (nothing is written in place, so a
stale copy of the parameters stays valid) and runs under
``torch.no_grad()``.  State lives on the parameters' device.  Python
constants enter as float32, as in the reference; the reference's
compiled program may contract ``a * b + c`` into FMAs where these are two
roundings, so parameters agree within an envelope (the tests state it),
while taus and gammas are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..core.prox import ProxOp, Zero, tree_prox
from ..core.pytree import tree_leaves, tree_map
from ..core.stepsize import StepsizePolicy, StepsizeState, f32

Pytree = Any

__all__ = ["Sgd", "Momentum", "MomentumState", "AdamW", "AdamState",
           "OPTIMIZERS", "make_optimizer", "apply_updates", "global_norm",
           "clip_by_global_norm", "DelayAdaptiveOptimizer",
           "DelayAdaptiveState"]


def _like(tree: Pytree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("tree has no tensors")
    return leaves[0]


def apply_updates(params: Pytree, updates: Pytree, lr) -> Pytree:
    return tree_map(lambda p, u: (p - lr * u).to(p.dtype), params, updates)


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads: Pytree, max_norm: float) -> Pytree:
    gn = global_norm(grads)
    scale = torch.clamp(f32(max_norm, gn) / torch.clamp(gn, min=1e-12),
                        max=1.0)
    return tree_map(lambda g: g * scale, grads)


@dataclasses.dataclass(frozen=True)
class Sgd:
    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        return grads, state


class MomentumState(NamedTuple):
    mu: Pytree


@dataclasses.dataclass(frozen=True)
class Momentum:
    beta: float = 0.9
    nesterov: bool = False

    def init(self, params):
        return MomentumState(mu=tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(self, grads, state, params=None):
        beta = f32(self.beta, _like(grads))
        mu = tree_map(lambda m, g: beta * m + g.float(), state.mu, grads)
        if self.nesterov:
            upd = tree_map(lambda m, g: beta * m + g.float(), mu, grads)
        else:
            upd = mu
        return upd, MomentumState(mu=mu)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Pytree
    nu: Pytree


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamState(count=torch.zeros((), dtype=torch.int32,
                                           device=_like(params).device),
                         mu=tree_map(z, params), nu=tree_map(z, params))

    def update(self, grads, state, params=None):
        like = state.count
        b1, b2 = f32(self.b1, like), f32(self.b2, like)
        c1, c2 = f32(1 - self.b1, like), f32(1 - self.b2, like)
        c = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + c1 * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + c2 * torch.square(g.float()),
                      state.nu, grads)
        cf = c.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, cf)
        bc2 = 1.0 - torch.pow(b2, cf)
        eps = f32(self.eps, like)
        upd = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps),
                       mu, nu)
        if self.weight_decay and params is not None:
            wd = f32(self.weight_decay, like)
            upd = tree_map(lambda u, p: u + wd * p.float(), upd, params)
        return upd, AdamState(count=c, mu=mu, nu=nu)


OPTIMIZERS = {"sgd": Sgd, "momentum": Momentum, "adamw": AdamW}


def make_optimizer(name: str, **kw):
    return OPTIMIZERS[name](**kw)


# ---------------------------------------------------------------------------
#  Delay-adaptive composition (the paper's contribution, optimizer-agnostic)
# ---------------------------------------------------------------------------


class DelayAdaptiveState(NamedTuple):
    step: torch.Tensor          # master write-event counter
    ss: StepsizeState           # step-size window state (principle (8))
    inner: Any                  # base optimizer state
    worker_stamp: torch.Tensor  # (n_workers,) iterate version each worker read


@dataclasses.dataclass(frozen=True)
class DelayAdaptiveOptimizer:
    """Compose a base optimizer with a delay-adaptive step-size policy.

    The policy's gamma' plays the role of the base learning rate; the emitted
    gamma_k (a function of the true write-event delay tau_k) scales the
    update, and an optional prox handles the composite term R.
    """

    policy: StepsizePolicy
    base: Any = Sgd()
    prox: ProxOp = Zero()
    lr_scale: float = 1.0
    grad_clip: Optional[float] = None
    n_workers: int = 1
    horizon: int = 4096

    def init(self, params: Pytree) -> DelayAdaptiveState:
        dev = _like(params).device
        return DelayAdaptiveState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            ss=self.policy.init(self.horizon, device=dev),
            inner=self.base.init(params),
            worker_stamp=torch.zeros((self.n_workers,), dtype=torch.int32,
                                     device=dev),
        )

    def observe(self, state: DelayAdaptiveState, worker
                ) -> Tuple[torch.Tensor, DelayAdaptiveState]:
        """Write-event delay bookkeeping (Algorithm 1 lines 12/15)."""
        w = torch.as_tensor(worker, dtype=torch.int64,
                            device=state.step.device)
        tau = state.step - state.worker_stamp[w]
        stamps = state.worker_stamp.clone()
        stamps[w] = state.step + 1
        return tau, state._replace(worker_stamp=stamps)

    @torch.no_grad()
    def step_fn(self, params: Pytree, grads: Pytree, state: DelayAdaptiveState,
                tau) -> Tuple[Pytree, DelayAdaptiveState, torch.Tensor]:
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
        upd, inner = self.base.update(grads, state.inner, params)
        gamma, ss = self.policy.step(state.ss, tau)
        lr = f32(self.lr_scale, gamma) * gamma
        params = apply_updates(params, upd, lr)
        params = tree_prox(self.prox, params, lr)
        return params, DelayAdaptiveState(step=state.step + 1, ss=ss,
                                          inner=inner,
                                          worker_stamp=state.worker_stamp), gamma

    def update(self, params, grads, state, worker):
        tau, state = self.observe(state, worker)
        params, state, gamma = self.step_fn(params, grads, state, tau)
        return params, state, gamma, tau
