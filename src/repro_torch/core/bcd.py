"""Async-BCD (asynchronous proximal block-coordinate descent) with delay
tracking (counterpart of ``repro.core.bcd``), the paper's Algorithm 2 /
Eq. (5):

    x_{k+1}^(j) = prox_{gamma_k R_j}(x_k^(j) - gamma_k grad_j f(xhat_k))

as a loop over a shared-memory write-event trace.  The variable is split
into ``m`` blocks of ``ceil(d/m)`` coordinates (the tail padded with
zeros).  At event k worker i_k contributes the block-j_k partial gradient
at the snapshot it read ``tau_k`` writes ago (consistent-but-stale reads,
the worst case the analysis covers), with a delay-adaptive step-size.

The reference ``vmap``s its scan over grid cells; here the cell axis is
written out.  Each event gathers every cell's stale snapshot, evaluates
the full gradient of the smooth part for all B cells at once (two
products with the data for the built-in problems), and keeps each cell's
block.  Under ``engine='fused'`` (the port's default) the policy step and
the block prox update of the whole bucket are ONE launch of the
hand-written kernel (``kernels.fused_step.fused_policy_prox_step``) on the
gathered (B, ceil(d/m)) block rows; ``engine='scan'`` runs them as
composed torch ops.  ``faults=`` switches in the guarded block step
(``repro_torch.faults``) under ``engine='scan'``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..faults.guards import (check_faults, finite_of, guard_event,
                             guarded_gamma, init_faults, poison)
from ..faults.inject import update_fault_codes
from ..faults.spec import normalize_faults
from .engine import EventTrace, solver_loop
from .piag import ENGINES, _solo
from .prox import ProxOp
from .stepsize import (StepsizePolicy, auto_horizon, clipped_count,
                       init_state)

__all__ = ["BCDResult", "bcd_scan", "run_async_bcd", "run_bcd_logreg",
           "sample_blocks"]


class BCDResult(NamedTuple):
    x: torch.Tensor            # final iterate (padding stripped)
    objective: torch.Tensor    # P(x_{k+1}) at recorded events
    gammas: torch.Tensor       # emitted step-sizes
    taus: torch.Tensor         # tau_k fed to the policy
    blocks: torch.Tensor       # block index updated at each recorded event
    clipped: Any = 0           # final horizon-clip count
    telemetry: Any = None      # DelayTelemetry when telemetry= was passed
    faults: Any = None         # FaultState counters when faults= was passed


def _blockify(x: torch.Tensor, m: int):
    """``x`` (..., d) as (..., m, ceil(d/m)) blocks, the tail zero-padded;
    returns the blocks and d."""
    d = x.shape[-1]
    db = -(-d // m)
    return F.pad(x, (0, m * db - d)).reshape(x.shape[:-1] + (m, db)), d


def bcd_scan(
    grad_f: Callable,           # full gradient of the smooth part, (B, d) -> (B, d)
    objective: Callable,        # P(x (B, d)) -> (B,)
    x0: torch.Tensor,           # (d,) initial iterate, shared by all cells
    m: int,
    n_workers: int,
    events,                     # (worker, tau, block), each (B, K) int
    policy,                     # StepsizePolicy or (B,) ParamPolicy
    prox: ProxOp,
    horizon: int = 4096,
    record_every: int = 1,
    telemetry=None,             # telemetry.TelemetryConfig or None
    engine: str = "fused",
    faults=None,                # faults.FaultSpec or None
    fault_codes: torch.Tensor | None = None,  # (B, K) int32 event codes
) -> BCDResult:
    """Algorithm 2 over B cells at once; every result leaf leads with B.

    ``record_every=s`` records (and evaluates the objective on) every s-th
    event only.  Ragged buckets need no worker mask here: no value is
    reduced over workers, so a masked trace (``trace_scan(T, active=...)``)
    never names a padded worker and ``n_workers`` is the bucket width.
    ``telemetry`` threads the in-loop accumulators through a separate step
    body; the solver leaves are bitwise those without it.

    ``faults``/``fault_codes`` switch in the guarded step body (see
    ``piag_scan``): the block gradient is the guarded payload -- corrupt
    events poison it, non-finite or over-stale payloads skip the block
    write -- and ``faults=None`` runs the fault-free body.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'scan' or 'fused', got {engine!r}")
    faults = check_faults(faults, fault_codes, engine)
    worker, taus, blocks = events
    B, K = worker.shape
    dev = x0.device
    fparams, fma_push = None, False
    if engine == "fused":
        from ..kernels.fused_step import (as_policy_params, fused_leaf,
                                          fused_policy_prox_step)
        fparams = as_policy_params(policy, dev)
        # a concrete policy is a compile-time constant in the reference,
        # whose program then contracts the push into an FMA
        fma_push = isinstance(policy, StepsizePolicy)
        fparams = type(fparams)(*(p.to(dev).reshape(-1).expand(B).contiguous()
                                  for p in fparams))
        x0 = fused_leaf(x0, "BCD iterate")
        ss = init_state(horizon, (B,), dev)
    else:
        ss = policy.init(horizon, batch_shape=(B,), device=dev)
    xb0, d = _blockify(x0.to(torch.float32), m)
    db = xb0.shape[-1]
    cells = torch.arange(B, device=dev)
    xb = xb0.expand(B, m, db).clone()
    # the snapshot each worker last read (Algorithm 2 line 4)
    x_read = xb0.expand(B, n_workers, m, db).clone()

    def unpad(xb):
        return xb.reshape(B, m * db)[:, :d]

    def update(ss, tau, xj, gj):
        if engine == "fused":                            # lines 6-7 fused
            return fused_policy_prox_step(fparams, prox, ss, tau, xj, gj,
                                          fma_push)
        gamma, ss = policy.step(ss, tau)                 # line 6
        return gamma, ss, prox.prox(xj - gamma.unsqueeze(-1) * gj, gamma)

    def advance(carry, event):
        xb, x_read, ss = carry
        wl, tau, _, jl = event
        g = grad_f(unpad(x_read[cells, wl]))             # grad at the stale read
        gj = F.pad(g, (0, m * db - d)).view(B, m, db)[cells, jl]
        gamma, ss, xj_new = update(ss, tau, xb[cells, jl], gj)
        xb[cells, jl] = xj_new                           # line 8 (atomic write)
        x_read[cells, wl] = xb                           # line 10 (re-read)
        return (xb, x_read, ss), gamma

    def outputs(old, new, gamma, event):
        return objective(unpad(new[0])), gamma, event[1], event[2]

    def advance_guarded(carry, event):
        xb, x_read, ss, fs = carry
        wl, tau, _, jl, code = event
        g = grad_f(unpad(x_read[cells, wl]))
        gj = poison(F.pad(g, (0, m * db - d)).view(B, m, db)[cells, jl],
                    code, faults)
        accept, mult, fs = guard_event(faults, code, tau,
                                       finite_of(gj, faults), fs)
        gamma, ss, fs = guarded_gamma(policy, ss, tau, mult, faults, fs)
        xj = xb[cells, jl]
        xj_cand = prox.prox(xj - gamma.unsqueeze(-1) * gj, gamma)
        xb[cells, jl] = torch.where(accept.unsqueeze(-1), xj_cand, xj)
        x_read[cells, wl] = xb
        return (xb, x_read, ss, fs), gamma

    xs = (worker.to(torch.int64).T.contiguous(),
          taus.to(torch.int32).T.contiguous(),
          blocks.to(torch.int32).T.contiguous(),
          blocks.to(torch.int64).T.contiguous())
    carry0 = (xb, x_read, ss)
    if faults is not None:
        advance = advance_guarded
        carry0 = carry0 + (init_faults((B,), dev),)
        xs = xs + (fault_codes.to(dev, torch.int32).T.contiguous(),)
    carry, (obj, gam, tau_out, blk), tel = solver_loop(
        advance, outputs, carry0, xs, record_every, telemetry, state_at=2)
    return BCDResult(x=unpad(carry[0]).contiguous(), objective=obj,
                     gammas=gam, taus=tau_out, blocks=blk,
                     clipped=clipped_count(carry[2]), telemetry=tel,
                     faults=None if faults is None else carry[-1])


def run_async_bcd(
    grad_f: Callable,
    objective: Callable,
    x0: torch.Tensor,
    m: int,
    trace: EventTrace,
    blocks: np.ndarray,         # (K,) int32 block choices
    policy: StepsizePolicy,
    prox: ProxOp,
    horizon: int | str = 4096,
    record_every: int = 1,
    telemetry=None,
    engine: str = "fused",
    faults=None,
    fault_seed: int = 0,
) -> BCDResult:
    """Async-BCD over one shared-memory trace (one cell) on ``x0``'s
    device.  ``horizon='auto'`` sizes the window buffer from the trace's
    own delays.  ``faults`` enables the guarded step, its event codes
    drawn from ``fault_seed`` (the cell seed).  Result leaves carry no
    cell axis."""
    faults = normalize_faults(faults)
    n = int(trace.worker.max()) + 1 if trace.n_events else 1
    if horizon == "auto":
        horizon = auto_horizon(int(np.max(trace.tau, initial=0)))
    dev = x0.device

    def col(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)[None]

    codes = None if faults is None else update_fault_codes(
        faults, trace.n_events, [int(fault_seed)], device=dev)
    res = bcd_scan(grad_f, objective, x0, m, n,
                   (col(trace.worker), col(trace.tau), col(blocks)),
                   policy, prox, horizon=int(horizon),
                   record_every=record_every, telemetry=telemetry,
                   engine=engine, faults=faults, fault_codes=codes)
    return _solo(res)


def sample_blocks(m: int, n_events: int, seed: int = 0) -> np.ndarray:
    """The uniform block choices of Algorithm 2 line 5 (the reference's
    numpy draw; shared by solo and batched runs so rows compare)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, m, size=n_events).astype(np.int32)


def run_bcd_logreg(problem, trace, policy, prox, m: int = 20,
                   seed: int = 0, horizon: int = 4096,
                   engine: str = "fused") -> BCDResult:
    """Async-BCD on the paper's l1-regularized logistic regression (§4.2)."""
    blocks = sample_blocks(m, trace.n_events, seed=seed)
    x0 = torch.zeros((problem.dim,), dtype=torch.float32,
                     device=problem.A.device)
    return run_async_bcd(problem.grad_f, problem.P, x0, m, trace, blocks,
                         policy, prox, horizon=horizon, engine=engine)
