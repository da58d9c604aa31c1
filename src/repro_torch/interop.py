"""Carry the reference's state into the port.

Each function takes arrays from ``repro`` as numpy (``np.asarray`` of a
JAX array) and returns the port's object with its tensors on ``device``,
so a test can hand both packages identical state: a problem's data and
constants, an iterate, a step-size state, policy parameters and an event
trace.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.engine import EventTrace
from .core.problems import LogRegProblem
from .core.stepsize import StepsizeState
from .kernels.dispatch import resolve_device
from .sweep.policies import PolicyParams

__all__ = ["logreg_problem", "iterate", "stepsize_state", "policy_params",
           "event_trace"]


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(
        resolve_device(device))


def logreg_problem(A, b, lam1: float, lam2: float, L: float, Lhat: float,
                   n_workers: int, device=None) -> LogRegProblem:
    """A ``LogRegProblem`` from the reference problem's ``A``, ``b``,
    ``lam1``, ``lam2``, ``L``, ``Lhat`` and ``n_workers``."""
    return LogRegProblem(A=_tensor(A, np.float32, device),
                         b=_tensor(b, np.float32, device),
                         lam1=float(lam1), lam2=float(lam2), L=float(L),
                         Lhat=float(Lhat), n_workers=int(n_workers))


def iterate(x0, device=None) -> torch.Tensor:
    """The iterate ``x0`` as a float32 tensor."""
    return _tensor(x0, np.float32, device)


def stepsize_state(k, total, cumbuf, clipped, device=None) -> StepsizeState:
    """A ``StepsizeState`` from the reference state's four leaves."""
    return StepsizeState(k=_tensor(k, np.int32, device),
                         total=_tensor(total, np.float32, device),
                         cumbuf=_tensor(cumbuf, np.float32, device),
                         clipped=_tensor(clipped, np.int32, device))


def policy_params(policy_id, gamma_prime, c0, c1, device=None) -> PolicyParams:
    """``PolicyParams`` from the reference's four fields."""
    return PolicyParams(policy_id=_tensor(policy_id, np.int32, device),
                        gamma_prime=_tensor(gamma_prime, np.float32, device),
                        c0=_tensor(c0, np.float32, device),
                        c1=_tensor(c1, np.float32, device))


def event_trace(worker, tau, t_wall, tau_max=None, read_at=None) -> EventTrace:
    """An ``EventTrace`` (host arrays) from a reference trace's ``worker``,
    ``tau`` and ``t_wall``; ``tau_max`` defaults to ``tau`` (the
    shared-memory form) and ``read_at`` to ``k - tau``."""
    worker = np.asarray(worker, np.int32)
    tau = np.asarray(tau, np.int32)
    tau_max = tau.copy() if tau_max is None else np.asarray(tau_max, np.int32)
    if read_at is None:
        read_at = (np.arange(tau.shape[0]) - tau).astype(np.int32)
    return EventTrace(worker, np.asarray(read_at, np.int32), tau, tau_max,
                      np.asarray(t_wall, np.float64))
