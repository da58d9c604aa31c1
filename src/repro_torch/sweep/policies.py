"""Step-size policies as tensors (counterpart of ``repro.sweep.policies``).

``PolicyParams`` flattens any ``PolicyParams``-expressible policy into four
scalars (``policy_id`` + three float32 constants); stacked over cells they
are (B,) tensors, the runtime value one batched program (or one fused
kernel launch per event) consumes.  ``ParamPolicy`` is the
``StepsizePolicy``-shaped adapter whose step selects the policy family per
cell with the same branch expressions as the concrete dataclasses, so a
sweep row equals the solo run of its concrete policy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.stepsize import (Adaptive1, Adaptive2, DavisFixed, FixedStepSize,
                             HingeWeight, NaiveAdaptive, PolyWeight,
                             StepsizePolicy, SunDengFixed, _push, init_state,
                             window_sum)
from ..kernels.dispatch import resolve_device

__all__ = ["PolicyParams", "ParamPolicy", "policy_params", "stack_params",
           "POLICY_IDS"]

POLICY_IDS = {
    "fixed_like": 0,   # FixedStepSize / SunDengFixed / DavisFixed
    "naive": 1,
    "adaptive1": 2,
    "adaptive2": 3,
    "hinge": 4,
    "poly": 5,
}


class PolicyParams(NamedTuple):
    """A policy as scalars (or (B,) tensors, one entry per cell).

    ==========  ===========================  =====================  ======
    policy_id   family                       c0                     c1
    ==========  ===========================  =====================  ======
    0           fixed / sun_deng / davis     precomputed gamma_k    --
    1           naive c/(tau+b)              b                      --
    2           adaptive1 (Eq. 13)           alpha                  --
    3           adaptive2 (Eq. 14)           --                     --
    4           hinge weight [Xie'19]        a                      b
    5           poly weight [Xie'19]         a                      --
    ==========  ===========================  =====================  ======
    """

    policy_id: torch.Tensor   # int32
    gamma_prime: torch.Tensor  # float32
    c0: torch.Tensor          # float32
    c1: torch.Tensor          # float32

    def to(self, device) -> "PolicyParams":
        return PolicyParams(*(p.to(device) for p in self))


def policy_params(policy: StepsizePolicy, device=None) -> PolicyParams:
    """Flatten a concrete policy into 0-dim ``PolicyParams`` tensors.

    Fixed-family per-step constants are computed in Python float64 and
    rounded once to float32, the rounding the dataclass itself performs.
    """
    gp, c0, c1 = float(policy.gamma_prime), 0.0, 0.0
    if isinstance(policy, FixedStepSize):
        pid, c0 = POLICY_IDS["fixed_like"], gp / (policy.tau_bound + 1)
    elif isinstance(policy, SunDengFixed):
        pid, c0 = POLICY_IDS["fixed_like"], gp / (policy.tau_bound + 0.5)
    elif isinstance(policy, DavisFixed):
        pid, c0 = (POLICY_IDS["fixed_like"],
                   gp / (1.0 + policy.ratio * policy.tau_bound))
    elif isinstance(policy, NaiveAdaptive):
        pid, c0 = POLICY_IDS["naive"], policy.b
    elif isinstance(policy, Adaptive1):
        pid, c0 = POLICY_IDS["adaptive1"], policy.alpha
    elif isinstance(policy, Adaptive2):
        pid = POLICY_IDS["adaptive2"]
    elif isinstance(policy, HingeWeight):
        pid, c0, c1 = POLICY_IDS["hinge"], policy.a, policy.b
    elif isinstance(policy, PolyWeight):
        pid, c0 = POLICY_IDS["poly"], policy.a
    else:
        raise TypeError(
            f"{type(policy).__name__} has no PolicyParams flattening "
            "(stateful policies like AdaptiveLipschitz carry extra state and "
            "are out of sweep scope)")
    dev = resolve_device(device)
    return PolicyParams(
        policy_id=torch.tensor(pid, dtype=torch.int32, device=dev),
        gamma_prime=torch.tensor(np.float32(gp), device=dev),
        c0=torch.tensor(np.float32(c0), device=dev),
        c1=torch.tensor(np.float32(c1), device=dev),
    )


def stack_params(policies, device=None) -> PolicyParams:
    """Stack per-cell policies (or ``PolicyParams``) into (B,) tensors."""
    dev = resolve_device(device)
    ps = [policy_params(p, dev) if isinstance(p, StepsizePolicy)
          else PolicyParams(*p).to(dev) for p in policies]
    return PolicyParams(*(torch.stack(xs) for xs in zip(*ps)))


class ParamPolicy:
    """``StepsizePolicy``-shaped adapter around ``PolicyParams``; with (B,)
    params it steps a (B,)-batched state, each cell under its own policy."""

    def __init__(self, params: PolicyParams):
        self.params = params

    def init(self, horizon: int = 4096, batch_shape=None, device=None):
        shape = tuple(self.params.policy_id.shape) if batch_shape is None \
            else tuple(batch_shape)
        return init_state(horizon, shape,
                          self.params.policy_id.device if device is None
                          else device)

    def _gamma_total(self, state, tau):
        """(gamma, was_clipped, new_total) without advancing the state."""
        from ..kernels.fused_step import select_gamma_total
        p = self.params
        ws, clip = window_sum(state, tau)
        gamma, new_total = select_gamma_total(
            p.policy_id, p.gamma_prime, p.c0, p.c1, ws, tau, state.total)
        return gamma, clip, new_total

    def step(self, state, tau):
        gamma, clip, new_total = self._gamma_total(state, tau)
        return gamma, _push(state, gamma, clip, new_total)
