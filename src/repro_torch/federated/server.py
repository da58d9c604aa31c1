"""Delay-adaptive asynchronous federated servers, FedAsync and FedBuff
(counterpart of ``repro.federated.server``).

Both servers consume the upload rows of a federated trace in a loop over
events.  The reference ``vmap``s its scan over grid cells; here the cell
axis is written out: every carry tensor leads with B cells -- the global
model, the per-client snapshot table (the model each client is training
on), the step-size state -- and each event advances all of them, so the
same step code serves a solo run (B = 1) and a batched sweep.  The mixing
weight ``alpha * s(tau)`` is emitted by the ``core.stepsize`` policies
(``hinge`` / ``poly`` / ``constant``).

* FedAsync [Xie et al. '19]: every upload is a server write,
  ``x <- x + alpha_t (x_c - x)``.
* FedBuff [Nguyen et al. '22]: uploads accumulate staleness-weighted
  deltas; each aggregation applies ``x <- x + (eta/|R|) * delta``.

Under ``engine='fused'`` (the port's default) the weight select and the
server update of an event are ONE launch of a hand-written kernel for all
cells (``kernels.fused_step.fused_policy_mix_step`` /
``fused_policy_buff_step``); ``engine='scan'`` runs them as composed torch
ops.  The reference's compiled program contracts the mix, the delta
accumulate, the buffered apply and the client's ``x - lr * g`` into FMAs;
the port computes each as ``fma32``.  ``telemetry=`` threads the in-loop
delay accumulators (``repro_torch.telemetry``) through a separate step
body, and ``faults=`` switches in the guarded step (``repro_torch.faults``)
under ``engine='scan'``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import solver_loop
from ..core.piag import ENGINES, _solo, default_grad_fn
from ..core.prox import ProxOp
from ..core.stepsize import (StepsizePolicy, auto_horizon, clipped_count, f32,
                             fma32, init_state)
from ..faults.guards import (check_faults, finite_of, guard_event,
                             guarded_gamma, init_faults, poison)
from ..faults.inject import update_fault_codes
from ..faults.spec import normalize_faults
from .events import FederatedTrace

__all__ = ["FedResult", "fedasync_scan", "fedbuff_scan", "run_fedasync",
           "run_fedbuff", "local_prox_sgd", "run_fedasync_problem",
           "run_fedbuff_problem"]


class FedResult(NamedTuple):
    x: torch.Tensor            # final server model
    objective: torch.Tensor    # P(x) after each recorded upload event
    weights: torch.Tensor      # emitted mixing weights alpha * s(tau_k)
    taus: torch.Tensor         # staleness fed to the weight policy
    versions: torch.Tensor     # server version after each recorded event
    clipped: Any = 0           # final horizon-clip count
    telemetry: Any = None      # DelayTelemetry when telemetry= was passed
    faults: Any = None         # FaultState counters when faults= was passed


def local_prox_sgd(worker_loss: Callable, prox: ProxOp, lr: float,
                   grad_fn: Callable | None = None,
                   client_data=None) -> Callable:
    """Client update: local epochs of proximal gradient descent.

    Returns ``update(x (B, d), n_steps (B,), w (B,), max_steps=None)``:
    cell b runs ``n_steps[b]`` epochs on client ``w[b]``'s shard.  The loop
    runs to ``max_steps`` (a host bound on ``n_steps``; read from the
    tensor when None) and cells that are done keep their iterate.
    ``grad_fn(x (B, d), w (B,)) -> (B, d)`` is the gradient seam; without
    it the gradient comes from ``worker_loss`` by autograd over
    ``client_data`` (a tuple of (n_clients, ...) tensors)."""
    if grad_fn is None:
        if client_data is None:
            raise ValueError("local_prox_sgd needs grad_fn or client_data")
        grad_fn = default_grad_fn(worker_loss, tuple(client_data))

    def update(x, n_steps, w, max_steps: Optional[int] = None):
        if max_steps is None:
            max_steps = int(n_steps.max()) if n_steps.numel() else 0
        neg_lr = f32(-lr, x)
        lr_t = f32(lr, x).expand(x.shape[:-1])
        for m in range(int(max_steps)):
            # x - lr * g, contracted as the reference's program computes it
            x_new = prox.prox(fma32(neg_lr, grad_fn(x, w), x), lr_t)
            x = torch.where((n_steps > m).unsqueeze(-1), x_new, x)
        return x

    return update


def _setup(client_data, x0, events, policy, engine, horizon, what):
    """Shared set-up of both servers: cell count, per-event host step
    bounds, the step-size state and the fused kernel's parameters."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'scan' or 'fused', got {engine!r}")
    client, steps = events[0], events[2]
    B, K = client.shape
    dev = x0.device
    n = int(client_data[0].shape[0])
    # one host read of the local-step counts bounds each event's loop
    max_steps = steps.max(dim=0).values.cpu().numpy() if K else \
        np.zeros((0,), np.int64)
    fparams, fma_push = None, False
    if engine == "fused":
        from ..kernels.fused_step import as_policy_params, fused_leaf
        fparams = as_policy_params(policy, dev)
        # a concrete policy is a compile-time constant in the reference,
        # whose program then contracts the push into an FMA
        fma_push = isinstance(policy, StepsizePolicy)
        fparams = type(fparams)(*(p.to(dev).reshape(-1).expand(B).contiguous()
                                  for p in fparams))
        x0 = fused_leaf(x0, what)
        ss = init_state(horizon, (B,), dev)
    else:
        ss = policy.init(horizon, batch_shape=(B,), device=dev)
    d = x0.shape[-1]
    x = x0.expand(B, d).clone()
    x_read = x0.expand(B, n, d).clone()
    return B, x, x_read, ss, max_steps, fparams, fma_push


def _events_xs(events, max_steps, fault_codes=None):
    client, tau, steps, agg, ver = events
    xs = (client.T.contiguous(), tau.to(torch.int32).T.contiguous(),
          steps.T.contiguous(), agg.to(torch.float32).T.contiguous(),
          ver.T.contiguous(), max_steps)
    if fault_codes is None:
        return xs
    return xs + (fault_codes.to(client.device, torch.int32).T.contiguous(),)


def _outputs(objective):
    """The recorded row of a server event: (P(x_new), weight, tau,
    version)."""
    def outputs(old, new, gamma, event):
        obj = objective(new[0]) if objective is not None else \
            torch.full_like(gamma, float("nan"))
        return obj, gamma, event[1], event[4]
    return outputs


def _scan(advance, outputs, carry0, events, max_steps, record_every,
          telemetry, state_at: int, faults=None, fault_codes=None,
          advance_guarded=None) -> FedResult:
    """Run a server loop over the events and pack the ``FedResult``: the
    fault-free body, or with ``faults`` the guarded one, whose
    ``FaultState`` rides as the last leaf of the carry."""
    xs = _events_xs(events, max_steps)
    if faults is not None:
        advance = advance_guarded
        x = carry0[0]
        carry0 = carry0 + (init_faults(x.shape[:1], x.device),)
        xs = _events_xs(events, max_steps, fault_codes)
    carry, (o, g, t, v), tel = solver_loop(
        advance, outputs, carry0, xs, record_every, telemetry, state_at)
    return FedResult(x=carry[0], objective=o, weights=g, taus=t, versions=v,
                     clipped=clipped_count(carry[state_at]), telemetry=tel,
                     faults=None if faults is None else carry[-1])


def fedasync_scan(
    client_update: Callable,    # (x (B,d), n_steps (B,), w (B,), max_steps) -> x_c
    x0: torch.Tensor,           # (d,) initial server model, shared by all cells
    client_data,                # tuple of tensors, each (n_clients, ...)
    events,                     # (client, tau, local_steps, aggregate, version), each (B, K)
    policy,                     # StepsizePolicy or (B,) ParamPolicy
    objective: Optional[Callable] = None,   # P(x (B, d)) -> (B,)
    horizon: int = 4096,
    record_every: int = 1,
    telemetry=None,             # telemetry.TelemetryConfig or None
    engine: str = "fused",
    faults=None,                # faults.FaultSpec or None
    fault_codes: Optional[torch.Tensor] = None,  # (B, K) int32 codes
) -> FedResult:
    """FedAsync over B cells at once; every result leaf leads with B.

    ``record_every=s`` records (and evaluates the objective on) every s-th
    upload only.  The uploading client picks up the freshly written model
    (its row of the snapshot table).  ``telemetry`` threads the in-loop
    accumulators through a separate step body; the server's leaves are
    bitwise those without it.  ``faults``/``fault_codes`` switch in the
    guarded step: the uploaded client model is the guarded payload --
    corrupt events poison it, non-finite or over-stale uploads make no
    server write."""
    faults = check_faults(faults, fault_codes, engine)
    B, x, x_read, ss, max_steps, fparams, fma_push = _setup(
        client_data, x0, events, policy, engine, horizon,
        "FedAsync server model")
    if engine == "fused":
        from ..kernels.fused_step import fused_policy_mix_step
    cells = torch.arange(B, device=x.device)

    def advance(carry, event):
        x, x_read, ss = carry
        w, tau, steps, _, ver, ms = event
        wl = w.to(torch.int64)
        xc = client_update(x_read[cells, wl], steps, w, max_steps=ms)
        if engine == "fused":
            gamma, ss, x_new = fused_policy_mix_step(
                fparams, ss, tau, x, xc, fma_push)
        else:
            gamma, ss = policy.step(ss, tau)
            # x <- x + gamma (x_c - x)
            x_new = fma32(gamma.unsqueeze(-1), xc - x, x)
        x_read[cells, wl] = x_new
        return (x_new, x_read, ss), gamma

    def advance_guarded(carry, event):
        x, x_read, ss, fs = carry
        w, tau, steps, _, ver, ms, code = event
        wl = w.to(torch.int64)
        xc = poison(client_update(x_read[cells, wl], steps, w, max_steps=ms),
                    code, faults)
        accept, mult, fs = guard_event(faults, code, tau,
                                       finite_of(xc, faults), fs)
        gamma, ss, fs = guarded_gamma(policy, ss, tau, mult, faults, fs)
        x_cand = fma32(gamma.unsqueeze(-1), xc - x, x)
        x_new = torch.where(accept.unsqueeze(-1), x_cand, x)
        x_read[cells, wl] = x_new
        return (x_new, x_read, ss, fs), gamma

    return _scan(advance, _outputs(objective), (x, x_read, ss), events,
                 max_steps, record_every, telemetry, state_at=2,
                 faults=faults, fault_codes=fault_codes,
                 advance_guarded=advance_guarded)


def fedbuff_scan(
    client_update: Callable,
    x0: torch.Tensor,
    client_data,
    events,
    policy,                     # per-delta staleness weight s(tau) (gamma'=1)
    eta: float = 1.0,           # server learning rate applied per aggregation
    buffer_size: int = 1,       # |R|; must match the trace's buffer
    objective: Optional[Callable] = None,
    horizon: int = 4096,
    record_every: int = 1,
    telemetry=None,
    engine: str = "fused",
    faults=None,
    fault_codes: Optional[torch.Tensor] = None,
) -> FedResult:
    """FedBuff over B cells at once: uploads accumulate
    ``s(tau_j) * (x_cj - x_read_j)``; where the trace marks the buffer full
    the server applies the buffered delta scaled by ``eta / buffer_size``
    (rounded to float32, as the reference's weakly typed constant).
    ``telemetry`` as in :func:`fedasync_scan`.  ``faults``/``fault_codes``
    guard the buffered delta: a rejected upload adds an exact zero, and
    the trace's aggregation schedule is untouched."""
    faults = check_faults(faults, fault_codes, engine)
    B, x, x_read, ss, max_steps, fparams, fma_push = _setup(
        client_data, x0, events, policy, engine, horizon,
        "FedBuff server model")
    if engine == "fused":
        from ..kernels.fused_step import fused_policy_buff_step
    cells = torch.arange(B, device=x.device)
    scale = float(np.float32(eta / buffer_size))
    scale_t = f32(scale, x)
    delta = torch.zeros_like(x)

    def advance(carry, event):
        x, x_read, delta, ss = carry
        w, tau, steps, agg, ver, ms = event
        wl = w.to(torch.int64)
        xw = x_read[cells, wl]
        xc = client_update(xw, steps, w, max_steps=ms)
        if engine == "fused":
            gamma, ss, x_new, delta = fused_policy_buff_step(
                fparams, ss, tau, x, xc, xw, delta, agg, scale, fma_push)
        else:
            gamma, ss = policy.step(ss, tau)
            delta = fma32(gamma.unsqueeze(-1), xc - xw, delta)
            x_new = fma32((agg * scale_t).unsqueeze(-1), delta, x)
            delta = (1.0 - agg).unsqueeze(-1) * delta
        x_read[cells, wl] = x_new
        return (x_new, x_read, delta, ss), gamma

    def advance_guarded(carry, event):
        x, x_read, delta, ss, fs = carry
        w, tau, steps, agg, ver, ms, code = event
        wl = w.to(torch.int64)
        xw = x_read[cells, wl]
        xc = poison(client_update(xw, steps, w, max_steps=ms), code, faults)
        accept, mult, fs = guard_event(faults, code, tau,
                                       finite_of(xc, faults), fs)
        gamma, ss, fs = guarded_gamma(policy, ss, tau, mult, faults, fs)
        step = gamma.unsqueeze(-1) * (xc - xw)
        delta = delta + torch.where(accept.unsqueeze(-1), step,
                                    torch.zeros_like(step))
        x_new = fma32((agg * scale_t).unsqueeze(-1), delta, x)
        delta = (1.0 - agg).unsqueeze(-1) * delta
        x_read[cells, wl] = x_new
        return (x_new, x_read, delta, ss, fs), gamma

    return _scan(advance, _outputs(objective), (x, x_read, delta, ss),
                 events, max_steps, record_every, telemetry, state_at=3,
                 faults=faults, fault_codes=fault_codes,
                 advance_guarded=advance_guarded)


def _solo_events(trace: FederatedTrace, device):
    def col(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)[None]
    return (col(trace.client, np.int32), col(trace.tau, np.int32),
            col(trace.local_steps, np.int32), col(trace.aggregate, np.float32),
            col(trace.version, np.int32))


def _solo_codes(faults, trace: FederatedTrace, fault_seed: int, device):
    """One cell's (1, K) upload fault codes, or None without faults."""
    if faults is None:
        return None
    return update_fault_codes(faults, trace.n_events, [int(fault_seed)],
                              device=device)


def _solo_horizon(horizon, trace: FederatedTrace) -> int:
    if horizon == "auto":
        return auto_horizon(int(np.max(np.asarray(trace.tau), initial=0)))
    return int(horizon)


def run_fedasync(
    client_update: Callable,
    x0: torch.Tensor,
    client_data,
    trace: FederatedTrace,
    policy: StepsizePolicy,     # gamma_prime = alpha; emits alpha * s(tau)
    objective: Optional[Callable] = None,
    horizon: int | str = 4096,
    record_every: int = 1,
    telemetry=None,
    engine: str = "fused",
    faults=None,
    fault_seed: int = 0,
) -> FedResult:
    """FedAsync over one trace (one cell) on ``x0``'s device; result leaves
    carry no cell axis.  ``horizon='auto'`` sizes the weight-policy buffer
    from the trace's own staleness.  ``faults`` enables the guarded step,
    its upload codes drawn from ``fault_seed`` (the cell seed)."""
    faults = normalize_faults(faults)
    return _solo(fedasync_scan(
        client_update, x0, client_data, _solo_events(trace, x0.device),
        policy, objective=objective, horizon=_solo_horizon(horizon, trace),
        record_every=record_every, telemetry=telemetry, engine=engine,
        faults=faults, fault_codes=_solo_codes(faults, trace, fault_seed,
                                               x0.device)))


def run_fedbuff(
    client_update: Callable,
    x0: torch.Tensor,
    client_data,
    trace: FederatedTrace,
    policy: StepsizePolicy,
    eta: float = 1.0,
    buffer_size: int = 1,
    objective: Optional[Callable] = None,
    horizon: int | str = 4096,
    record_every: int = 1,
    telemetry=None,
    engine: str = "fused",
    faults=None,
    fault_seed: int = 0,
) -> FedResult:
    """FedBuff over one trace (one cell) on ``x0``'s device; ``faults`` /
    ``fault_seed`` as in :func:`run_fedasync`."""
    faults = normalize_faults(faults)
    return _solo(fedbuff_scan(
        client_update, x0, client_data, _solo_events(trace, x0.device),
        policy, eta=eta, buffer_size=buffer_size, objective=objective,
        horizon=_solo_horizon(horizon, trace), record_every=record_every,
        telemetry=telemetry, engine=engine, faults=faults,
        fault_codes=_solo_codes(faults, trace, fault_seed, x0.device)))


def _problem_pieces(problem, prox: ProxOp, local_lr: Optional[float],
                    grad_fn: Callable | None = None):
    """``(update, x0, client_data)`` for a ``core.problems`` problem: local
    prox-SGD at ``local_lr`` (default 0.9 / L) with the problem's
    closed-form batched gradient where it has one."""
    data = problem.worker_slices()
    lr = (0.9 / problem.L) if local_lr is None else local_lr
    if grad_fn is None and hasattr(problem, "worker_grads"):
        grad_fn = problem.worker_grads()
    update = local_prox_sgd(problem.worker_loss, prox, lr, grad_fn=grad_fn,
                            client_data=data)
    x0 = torch.zeros((problem.dim,), dtype=torch.float32,
                     device=problem.A.device)
    return update, x0, data


def run_fedasync_problem(problem, trace, policy, prox,
                         local_lr: Optional[float] = None,
                         horizon: int | str = 4096,
                         engine: str = "fused") -> FedResult:
    """FedAsync on a ``core.problems`` convex problem: clients run local
    prox-SGD epochs on their shard, the server mixes with the
    delay-adaptive weight, and ``objective`` is the true composite P."""
    update, x0, data = _problem_pieces(problem, prox, local_lr)
    return run_fedasync(update, x0, data, trace, policy,
                        objective=problem.P, horizon=horizon, engine=engine)


def run_fedbuff_problem(problem, trace, policy, prox,
                        eta: float = 1.0, buffer_size: int = 1,
                        local_lr: Optional[float] = None,
                        horizon: int | str = 4096,
                        engine: str = "fused") -> FedResult:
    update, x0, data = _problem_pieces(problem, prox, local_lr)
    return run_fedbuff(update, x0, data, trace, policy, eta=eta,
                       buffer_size=buffer_size, objective=problem.P,
                       horizon=horizon, engine=engine)
