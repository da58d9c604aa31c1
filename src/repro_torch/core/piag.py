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
ops.  Not ported yet: fault injection, telemetry, ``run_piag_lipschitz``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .engine import EventTrace, strided_scan
from .prox import ProxOp
from .stepsize import (StepsizePolicy, auto_horizon, clipped_count,
                       init_state)

__all__ = ["PIAGResult", "piag_scan", "run_piag", "run_piag_logreg"]

ENGINES = ("scan", "fused")


class PIAGResult(NamedTuple):
    x: torch.Tensor            # final iterate
    objective: torch.Tensor    # P(x_{k+1}) at recorded events
    gammas: torch.Tensor       # emitted step-sizes
    taus: torch.Tensor         # tau_k fed to the policy
    opt_residual: torch.Tensor  # ||x_{k+1} - x_k|| / gamma_k
    clipped: Any = 0           # final horizon-clip count
    telemetry: Any = None      # not ported (ROADMAP queue A item 9)
    faults: Any = None         # not ported (ROADMAP queue A item 10)


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
    engine: str = "fused",
    grad_fn: Callable | None = None,    # (xw (B, d), w (B,)) -> (B, d)
) -> PIAGResult:
    """Algorithm 1 over B cells at once; every result leaf leads with B.

    ``active`` makes the aggregate a mean over each cell's ACTIVE workers
    (padded rows are multiplied by an exact 0.0).  ``record_every=s``
    records (and evaluates the objective on) every s-th event only; the
    iterate path is unchanged.  ``grad_fn`` is the gradient seam: by
    default the gradient comes from ``worker_loss`` by autograd.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'scan' or 'fused', got {engine!r}")
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

    def make_step(emit):
        def step(carry, event):
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
            if not emit:
                return (x_new, gtab, x_read, ss), None
            dx = torch.sqrt(torch.sum(torch.square(x_new - x), dim=-1))
            res = torch.where(gamma > 0, dx / torch.clamp(gamma, min=1e-30),
                              torch.zeros_like(dx))
            return (x_new, gtab, x_read, ss), (objective(x_new), gamma, tau,
                                               res)
        return step

    xs = (worker.T.contiguous(), taus.to(torch.int32).T.contiguous())
    (x_fin, _, _, ss_fin), outs = strided_scan(
        make_step, (x, gtab, x_read, ss), xs, record_every)
    obj, gam, tau_out, res = (o.T.contiguous() for o in outs)
    return PIAGResult(x=x_fin, objective=obj, gammas=gam, taus=tau_out,
                      opt_residual=res, clipped=clipped_count(ss_fin))


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
    engine: str = "fused",
    grad_fn: Callable | None = None,
) -> PIAGResult:
    """PIAG over one write-event trace (one cell) on ``x0``'s device.

    ``horizon='auto'`` sizes the window buffer from the trace's own delays
    (``auto_horizon``).  Result leaves carry no cell axis."""
    taus = trace.tau_max if use_tau_max else trace.tau
    if horizon == "auto":
        horizon = auto_horizon(int(np.max(taus, initial=0)))
    dev = x0.device
    events = (torch.from_numpy(np.asarray(trace.worker, np.int32)).to(dev)[None],
              torch.from_numpy(np.asarray(taus, np.int32)).to(dev)[None])
    res = piag_scan(worker_loss, x0, worker_data, events, policy, prox,
                    objective=objective, horizon=int(horizon),
                    record_every=record_every, engine=engine, grad_fn=grad_fn)
    return PIAGResult(*(leaf[0] if isinstance(leaf, torch.Tensor) else leaf
                        for leaf in res))


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
