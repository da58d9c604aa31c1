"""PIAG (Proximal Incremental Aggregated Gradient) with delay tracking
(counterpart of ``repro.core.piag``).

The paper's Algorithm 1 / Eqs. (3)-(4):

    g_k     = (1/n) sum_i grad f_i(x_{k - tau_k^(i)})
    x_{k+1} = prox_{gamma_k R}(x_k - gamma_k g_k)

as a loop over a write-event trace.  The reference ``vmap``s its scan over
grid cells; here the cell axis is written out: every carry tensor leads
with B cells and each event advances all of them, so the same step code
serves a solo run (B = 1) and a batched sweep.  Under ``engine='fused'``
(the port's default) the policy step and the prox update are ONE launch of
the hand-written kernel per event for all cells
(``kernels.fused_step``); ``engine='scan'`` runs them as composed torch
ops.  ``telemetry=`` threads the in-loop delay accumulators
(``repro_torch.telemetry``) through a separate step body, and
``faults=`` switches in the guarded step body (``repro_torch.faults``).
``run_piag_lipschitz`` runs PIAG with neither the delay bound nor L
known (``AdaptiveLipschitz``), one solo run as a loop over events.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..faults.guards import (check_faults, finite_of, guard_event,
                             guarded_gamma, init_faults, poison)
from ..faults.inject import update_fault_codes
from ..faults.spec import normalize_faults
from .engine import EventTrace, solver_loop
from .prox import ProxOp
from ..kernels.dispatch import resolve_device
from .stepsize import (AdaptiveLipschitz, StepsizePolicy, auto_horizon,
                       clipped_count, init_state)

__all__ = ["PIAGResult", "piag_scan", "run_piag", "run_piag_logreg",
           "run_piag_lipschitz"]

ENGINES = ("scan", "fused")


def _solo(res):
    """A B = 1 result without its cell axis (nested result tuples, such as
    ``telemetry``, too)."""
    def strip(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf[0]
        if isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
            return type(leaf)(*(strip(x) for x in leaf))
        return leaf
    return strip(res)


class PIAGResult(NamedTuple):
    x: torch.Tensor            # final iterate
    objective: torch.Tensor    # P(x_{k+1}) at recorded events
    gammas: torch.Tensor       # emitted step-sizes
    taus: torch.Tensor         # tau_k fed to the policy
    opt_residual: torch.Tensor  # ||x_{k+1} - x_k|| / gamma_k
    clipped: Any = 0           # final horizon-clip count
    telemetry: Any = None      # DelayTelemetry when telemetry= was passed
    faults: Any = None         # FaultState counters when faults= was passed


def default_grad_fn(worker_loss: Callable, worker_data) -> Callable:
    """``grad_fn(xw (B, d), w (B,))`` from a per-worker loss by autograd:
    gathers each cell's worker shard, then ``vmap(grad(worker_loss))``.
    Problems with a closed-form batched gradient pass their own."""
    from torch.func import grad, vmap
    g = vmap(grad(worker_loss))

    def grad_fn(xw, w):
        w = w.to(torch.int64)
        return g(xw, *(leaf[w] for leaf in worker_data))

    return grad_fn


def piag_scan(
    worker_loss: Callable,      # (x, *worker_data_slice) -> scalar, f_i
    x0: torch.Tensor,           # (d,) initial iterate, shared by all cells
    worker_data,                # tuple of tensors, each (n_workers, ...)
    events,                     # (worker (B, K), tau (B, K)) int tensors
    policy,                     # StepsizePolicy or (B,) ParamPolicy
    prox: ProxOp,
    objective: Callable | None = None,  # P(x (B, d)) -> (B,)
    horizon: int = 4096,
    active: torch.Tensor | None = None,  # (B, n) bool ragged-bucket mask
    record_every: int = 1,
    telemetry=None,                     # telemetry.TelemetryConfig or None
    engine: str = "fused",
    grad_fn: Callable | None = None,    # (xw (B, d), w (B,)) -> (B, d)
    faults=None,                        # faults.FaultSpec or None
    fault_codes: torch.Tensor | None = None,  # (B, K) int32 event codes
) -> PIAGResult:
    """Algorithm 1 over B cells at once; every result leaf leads with B.

    ``active`` makes the aggregate a mean over each cell's ACTIVE workers
    (padded rows are multiplied by an exact 0.0).  ``record_every=s``
    records (and evaluates the objective on) every s-th event only; the
    iterate path is unchanged.  ``grad_fn`` is the gradient seam: by
    default the gradient comes from ``worker_loss`` by autograd.
    ``telemetry`` threads the in-loop accumulators through a separate step
    body; the solver leaves are bitwise those without it.

    ``faults=FaultSpec(...)`` with a ``fault_codes`` event column
    (``faults.update_fault_codes``) switches in the guarded step body:
    drop/dup/corrupt codes apply to the returning worker's gradient,
    non-finite or over-stale payloads are rejected (the table keeps the
    worker's previous row), horizon overflow degrades to
    ``gamma'/(tau+1)``, and the ``FaultState`` counters land on
    ``result.faults``.  ``faults=None`` runs the fault-free body.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'scan' or 'fused', got {engine!r}")
    faults = check_faults(faults, fault_codes, engine)
    worker, taus = events
    B, K = worker.shape
    dev = x0.device
    worker_data = tuple(worker_data)
    n = int(worker_data[0].shape[0])
    if engine == "fused":
        from ..kernels.fused_step import (as_policy_params, fused_leaf,
                                          fused_policy_prox_step)
        fparams = as_policy_params(policy, dev)
        # a concrete policy is a compile-time constant in the reference,
        # whose program then contracts the push into an FMA (see
        # kernels.fused_step.select_gamma_total)
        fma_push = isinstance(policy, StepsizePolicy)
        fparams = type(fparams)(*(p.to(dev).reshape(-1).expand(B).contiguous()
                                  for p in fparams))
        x0 = fused_leaf(x0, "PIAG iterate")
    if grad_fn is None:
        grad_fn = default_grad_fn(worker_loss, worker_data)

    if active is None:
        def aggregate(buf):
            return torch.mean(buf, dim=1)
    else:
        amask = active.to(dev, torch.float32)
        n_active = amask.sum(dim=1, keepdim=True)

        def aggregate(buf):
            return torch.sum(buf * amask.unsqueeze(-1), dim=1) / n_active

    if objective is None:
        def objective(x):
            losses = torch.stack([worker_loss(x, *(leaf[i] for leaf in worker_data))
                                  for i in range(n)], dim=1)
            return aggregate(losses.unsqueeze(-1)).squeeze(-1) + prox.value(x)

    cells = torch.arange(B, device=dev)
    d = x0.shape[-1]
    # Algorithm 1 line 3: g^(i) <- grad f_i(x_0)
    g0 = grad_fn(x0.expand(n, d), torch.arange(n, device=dev))
    gtab = g0.unsqueeze(0).expand(B, n, d).clone()
    x_read = x0.expand(B, n, d).clone()
    x = x0.expand(B, d).clone()
    ss = policy.init(horizon, batch_shape=(B,), device=dev) \
        if engine == "scan" else init_state(horizon, (B,), dev)

    def advance(carry, event):
        x, gtab, x_read, ss = carry
        w, tau = event
        wl = w.to(torch.int64)
        # worker w returns grad f_w(x_read[w])  (Algorithm 1 line 12)
        gtab[cells, wl] = grad_fn(x_read[cells, wl], w)
        # line 14: aggregate; line 16: gamma; line 17: prox step
        g = aggregate(gtab)
        if engine == "fused":
            gamma, ss, x_new = fused_policy_prox_step(
                fparams, prox, ss, tau, x, g, fma_push)
        else:
            gamma, ss = policy.step(ss, tau)
            x_new = prox.prox(x - gamma.unsqueeze(-1) * g, gamma)
        # line 20: hand x_{k+1} to the returning worker
        x_read[cells, wl] = x_new
        return (x_new, gtab, x_read, ss), gamma

    def outputs(old, new, gamma, event):
        dx = torch.sqrt(torch.sum(torch.square(new[0] - old[0]), dim=-1))
        res = torch.where(gamma > 0, dx / torch.clamp(gamma, min=1e-30),
                          torch.zeros_like(dx))
        return objective(new[0]), gamma, event[1], res

    def advance_guarded(carry, event):
        x, gtab, x_read, ss, fs = carry
        w, tau, code = event
        wl = w.to(torch.int64)
        # update-level corruption poisons the payload BEFORE the guard
        gw = poison(grad_fn(x_read[cells, wl], w), code, faults)
        accept, mult, fs = guard_event(faults, code, tau,
                                       finite_of(gw, faults), fs)
        # a rejected update keeps the worker's PREVIOUS table row: one
        # corrupt gradient never poisons the aggregate
        acc = accept.unsqueeze(-1)
        gtab[cells, wl] = torch.where(acc, gw, gtab[cells, wl])
        g = aggregate(gtab)
        gamma, ss, fs = guarded_gamma(policy, ss, tau, mult, faults, fs)
        x_cand = prox.prox(x - gamma.unsqueeze(-1) * g, gamma)
        x_new = torch.where(acc, x_cand, x)
        # the worker refetches the latest iterate either way
        x_read[cells, wl] = x_new
        return (x_new, gtab, x_read, ss, fs), gamma

    xs = (worker.T.contiguous(), taus.to(torch.int32).T.contiguous())
    carry0 = (x, gtab, x_read, ss)
    if faults is not None:
        advance = advance_guarded
        carry0 = carry0 + (init_faults((B,), dev),)
        xs = xs + (fault_codes.to(dev, torch.int32).T.contiguous(),)
    carry, (obj, gam, tau_out, res), tel = solver_loop(
        advance, outputs, carry0, xs, record_every, telemetry, state_at=3)
    return PIAGResult(x=carry[0], objective=obj, gammas=gam, taus=tau_out,
                      opt_residual=res, clipped=clipped_count(carry[3]),
                      telemetry=tel,
                      faults=None if faults is None else carry[-1])


def run_piag(
    worker_loss: Callable,
    x0: torch.Tensor,
    worker_data,
    trace: EventTrace,
    policy: StepsizePolicy,
    prox: ProxOp,
    objective: Callable | None = None,
    horizon: int | str = 4096,
    use_tau_max: bool = True,
    record_every: int = 1,
    telemetry=None,
    engine: str = "fused",
    grad_fn: Callable | None = None,
    faults=None,
    fault_seed: int = 0,
) -> PIAGResult:
    """PIAG over one write-event trace (one cell) on ``x0``'s device.

    ``horizon='auto'`` sizes the window buffer from the trace's own delays
    (``auto_horizon``).  ``faults`` enables the guarded step; the per-event
    codes are drawn from ``fault_seed`` (the cell seed), so a solo run
    equals its batched row under faults.  Result leaves carry no cell
    axis."""
    taus = trace.tau_max if use_tau_max else trace.tau
    if horizon == "auto":
        horizon = auto_horizon(int(np.max(taus, initial=0)))
    dev = x0.device
    events = (torch.from_numpy(np.asarray(trace.worker, np.int32)).to(dev)[None],
              torch.from_numpy(np.asarray(taus, np.int32)).to(dev)[None])
    faults = normalize_faults(faults)
    codes = None if faults is None else update_fault_codes(
        faults, events[0].shape[1], [int(fault_seed)], device=dev)
    res = piag_scan(worker_loss, x0, worker_data, events, policy, prox,
                    objective=objective, horizon=int(horizon),
                    record_every=record_every, telemetry=telemetry,
                    engine=engine, grad_fn=grad_fn, faults=faults,
                    fault_codes=codes)
    return _solo(res)


def run_piag_lipschitz(problem, trace, prox, h: float = 0.9,
                       alpha: float = 0.9, gamma0: float = 1.0,
                       horizon: int = 4096, device=None) -> PIAGResult:
    """BEYOND-PAPER: PIAG needing neither the delay bound nor L.

    Uses core.stepsize.AdaptiveLipschitz: per write event, the returning
    worker's (old grad, new grad, old iterate, new iterate) quadruple yields
    a secant curvature sample ||dg||/||dx||; the running max estimates L and
    sets the Eq.-(8) budget gamma' = h / L_est on-line (the paper's §5
    future work, made concrete).  Runs on ``device`` (the CUDA card unless
    ``"cpu"``); ``opt_residual`` holds L_est after each event."""
    dev = resolve_device(device)
    Aw, bw = (t.to(dev) for t in problem.worker_slices())
    n = Aw.shape[0]
    grad_i = getattr(problem, "worker_grad", None)
    if grad_i is None:
        from torch.func import grad
        grad_i = grad(problem.worker_loss)
    pol = AdaptiveLipschitz(gamma_prime=gamma0, h=h, alpha=alpha)
    x = torch.zeros((problem.dim,), dtype=torch.float32, device=dev)

    gtab = torch.stack([grad_i(x, Aw[i], bw[i]) for i in range(n)])
    x_read = x.expand(n, -1).clone()
    x_prev = x_read.clone()
    workers = np.asarray(trace.worker, np.int64)
    taus = torch.as_tensor(np.asarray(trace.tau_max, np.int32), device=dev)
    lip = pol.init(horizon, device=dev)
    obj, gam, L_est = [], [], []
    for k, w in enumerate(workers.tolist()):
        tau = taus[k]
        xw = x_read[w]
        gw = grad_i(xw, Aw[w], bw[w])
        # secant curvature sample from worker w's consecutive gradients
        dg = torch.linalg.vector_norm(gw - gtab[w])
        dx = torch.linalg.vector_norm(xw - x_prev[w])
        lip = pol.observe_curvature(lip, dg, dx)
        gtab[w] = gw
        x_prev[w] = xw
        g = torch.mean(gtab, dim=0)
        gamma, lip = pol.step(lip, tau)
        x = prox.prox(x - gamma * g, gamma)
        x_read[w] = x
        obj.append(problem.P(x))
        gam.append(gamma)
        L_est.append(lip.L_est)
    return PIAGResult(x=x, objective=torch.stack(obj), gammas=torch.stack(gam),
                      taus=taus, opt_residual=torch.stack(L_est),
                      clipped=clipped_count(lip))


def run_piag_logreg(problem, trace, policy, prox, horizon: int = 4096,
                    engine: str = "fused") -> PIAGResult:
    """PIAG on the paper's l1-regularized logistic regression (§4.1), with
    the problem's closed-form batched worker gradient."""
    Aw, bw = problem.worker_slices()
    x0 = torch.zeros((problem.dim,), dtype=torch.float32,
                     device=problem.A.device)
    return run_piag(problem.worker_loss, x0, (Aw, bw), trace, policy, prox,
                    objective=problem.P, horizon=horizon, engine=engine,
                    grad_fn=problem.worker_grads())
