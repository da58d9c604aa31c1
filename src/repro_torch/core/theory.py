"""Numerical instruments for the paper's theory (counterpart of
``repro.core.theory``; numpy, with ``example1``'s step-sizes from the
port's ``policy.run``).

* ``check_principle``      -- verify a (gamma, tau) trace satisfies Eq. (8).
* ``verify_theorem1``      -- check the premises (9)-(10) of Theorem 1 on a
                              concrete sequence realization and verify the
                              conclusions (11)-(12).
* ``example1``             -- the paper's Example 1: the naive step-size (7)
                              diverges on f(x) = x^2/2 with tau_k = k mod T.
* ``prop1_lower_bounds``   -- Proposition 1's step-size-integral bounds.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .stepsize import StepsizePolicy

__all__ = [
    "check_principle", "verify_theorem1", "Theorem1Report",
    "example1", "example1_divergence_threshold", "prop1_lower_bounds",
]


def check_principle(gammas, taus, gamma_prime: float,
                    atol: float = None) -> bool:
    """Eq. (8): 0 <= gamma_k <= max(0, gamma' - sum_{t=k-tau_k}^{k-1} gamma_t).

    Default tolerance scales with gamma' to absorb float32 window-sum
    round-off (the policies are exact in their own f32 arithmetic)."""
    if atol is None:
        atol = 1e-5 * max(gamma_prime, 1.0)
    g = np.asarray(gammas, np.float64)
    t = np.asarray(taus, np.int64)
    cum = np.concatenate([[0.0], np.cumsum(g)])  # cum[j] = S_j
    for k in range(len(g)):
        tau = min(int(t[k]), k)
        wsum = cum[k] - cum[k - tau]
        ub = max(0.0, gamma_prime - wsum)
        if g[k] < -atol or g[k] > ub + atol:
            return False
    return True


class Theorem1Report(NamedTuple):
    premises_hold: bool      # (9) with the given sequences and (10)
    conclusion_V: bool       # V_k <= Q_k V_0 for all k       (Eq. 11)
    conclusion_X: bool       # sum_k X_k / Q_k <= V_0          (Eq. 12)


def verify_theorem1(V, X, W, p, r, q, taus, atol: float = 1e-9) -> Theorem1Report:
    """Check Theorem 1 on concrete non-negative sequences.

    All arrays have length K (V has K+1).  Returns which premises hold and
    whether the conclusions then hold -- used by property tests to probe the
    theorem numerically over random instances.
    """
    V = np.asarray(V, np.float64)
    X = np.asarray(X, np.float64)
    W = np.asarray(W, np.float64)
    p = np.asarray(p, np.float64)
    r = np.asarray(r, np.float64)
    q = np.asarray(q, np.float64)
    taus = np.asarray(taus, np.int64)
    K = len(p)

    Q = np.concatenate([[1.0], np.cumprod(q)])  # Q[k] = prod_{j<k} q_j

    prem = True
    for k in range(K):
        tau = min(int(taus[k]), k)
        lhs = X[k + 1] + V[k + 1]
        rhs = q[k] * V[k] + p[k] * W[k - tau:k].sum() - r[k] * W[k]
        if lhs > rhs + atol:
            prem = False
            break
        if p[k] > 0:
            for l in range(k - tau, k + 1):
                bound = r[l] / Q[l + 1] - sum(p[t] / Q[t + 1] for t in range(l + 1, k))
                if p[k] / Q[k + 1] > bound + atol:
                    prem = False
                    break
        if not prem:
            break

    conc_V = bool(np.all(V[1:] <= Q[1:len(V)] * V[0] + atol))
    conc_X = bool(np.sum(X[1:] / Q[1:len(X)]) <= V[0] + atol)
    return Theorem1Report(prem, conc_V, conc_X)


def example1(policy: StepsizePolicy, T: int, n_periods: int = 40,
             x0: float = 1.0, device=None):
    """Run x_{k+1} = x_k - gamma_k x_{T floor(k/T)} (PIAG/BCD on f = x^2/2
    with tau_k = k mod T) and return |x_{kT}| at period boundaries.  The
    step-sizes come from ``policy.run`` on ``device`` (the CUDA card
    unless ``"cpu"``); the recursion runs in float64 on the host."""
    K = T * n_periods
    taus = np.arange(K) % T
    gammas = policy.run(taus, device=device).cpu().numpy()
    x = float(x0)
    xs = [x]
    for period in range(n_periods):
        s = gammas[period * T:(period + 1) * T].sum()
        x = (1.0 - s) * x
        xs.append(x)
    return np.abs(np.array(xs)), gammas, taus


def example1_divergence_threshold(c: float, b: float) -> int:
    """Example 1 requires T > b (e^{2/c} - 1) for divergence of the naive
    policy gamma_k = c/(tau_k + b)."""
    return int(np.ceil(b * (np.exp(2.0 / c) - 1.0))) + 1


def prop1_lower_bounds(gammas, taus, gamma_prime: float, alpha: float,
                        tau_bound: int):
    """Return (lhs, adaptive1_bound, adaptive2_bound) per Proposition 1:
    sum_{t<=k} gamma_t >= (k+1) alpha gamma'/(tau+1)        (Eq. 15)
    sum_{t<=k} gamma_t >= (k+1) tau gamma'/(tau+1)^2        (Eq. 16)."""
    g = np.asarray(gammas, np.float64)
    k1 = np.arange(1, len(g) + 1)
    lhs = np.cumsum(g)
    b1 = k1 * alpha * gamma_prime / (tau_bound + 1)
    b2 = k1 * tau_bound * gamma_prime / (tau_bound + 1) ** 2
    return lhs, b1, b2
