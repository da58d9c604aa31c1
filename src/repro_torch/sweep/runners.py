"""Batched PIAG sweeps: every cell of a bucket advanced together (the PIAG
part of ``repro.sweep.runners``).

The reference jits ``vmap(trace_scan + piag_scan)`` into one program per
bucket.  Here a bucket is one pass of the event loop with the cells as the
leading tensor axis: the event race (``core.engine.trace_scan``) runs for
all B cells at once on the device, then ``core.piag.piag_scan`` advances
all B cells per event -- under ``engine='fused'`` with ONE kernel launch
per event for the whole bucket.  Worker data stays one shared
``(W, n_per, d)`` tensor; cells index it (the problem's ``worker_grads``),
never copy it.  Rows are stitched back into grid order.

Not ported yet: Async-BCD and the federated sweeps, the sharded runners,
the program cache, faults, telemetry and checkpoints (ROADMAP queue A).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..core.engine import trace_scan
from ..core.piag import PIAGResult, piag_scan
from ..core.prox import ProxOp
from ..core.stepsize import auto_horizon
from .grid import SweepBucket, SweepGrid
from .policies import ParamPolicy

__all__ = ["make_sweep_piag", "sweep_piag", "sweep_piag_logreg",
           "run_bucketed", "resolve_grid_horizon"]

Horizon = Union[int, str]  # a concrete H or "auto" (measured-delay sizing)


def resolve_grid_horizon(horizon: Horizon, grid: SweepGrid, *,
                         slack: int = 1, bound: Optional[int] = None,
                         device=None) -> int:
    """``horizon='auto'|int`` -> a concrete H: ``'auto'`` sizes the window
    buffer to ``next_pow2(bound + slack)``, measuring the grid's own
    worst-case delay when no ``bound`` is given."""
    if horizon != "auto":
        return int(horizon)
    if bound is None:
        bound = grid.measure_tau_bar(device)
    return auto_horizon(bound, slack)


def run_bucketed(grid: SweepGrid, run_bucket: Callable,
                 bucket_widths: Optional[Sequence[int]] = None):
    """Run ``run_bucket(bucket) -> result`` (a tuple of tensors with a
    leading B_bucket axis) over every bucket of ``grid`` and stitch rows
    back into grid cell order."""
    buckets = grid.buckets(bucket_widths)
    parts = [run_bucket(b) for b in buckets]
    if len(parts) == 1:
        return parts[0]
    order = np.concatenate([b.index for b in buckets])
    inv = torch.from_numpy(np.argsort(order))

    def stitch(*xs):
        if not isinstance(xs[0], torch.Tensor):
            return xs[0]
        return torch.cat(xs, dim=0)[inv.to(xs[0].device)]

    leaves = [stitch(*col) for col in zip(*parts)]
    if hasattr(parts[0], "_fields"):  # a NamedTuple result
        return type(parts[0])(*leaves)
    return tuple(leaves)


def _slice_workers(worker_data, width: int):
    """Rows 0..width-1 of every leaf: the bucket's view of the shared
    worker population."""
    if worker_data[0].shape[0] < width:
        raise ValueError(
            f"worker_data has {worker_data[0].shape[0]} rows < bucket width "
            f"{width}; provide data for the widest cell")
    return tuple(leaf[:width] for leaf in worker_data)


def make_sweep_piag(worker_loss: Callable, x0, worker_data, prox: ProxOp,
                    objective: Optional[Callable] = None, horizon: int = 4096,
                    use_tau_max: bool = True, masked: bool = False,
                    record_every: int = 1, engine: str = "fused",
                    grad_fn: Optional[Callable] = None) -> Callable:
    """Build the batched PIAG program: ``fn(service_times (B, n, K+1),
    params (B,)) -> PIAGResult`` with a leading B on every leaf; with
    ``masked=True`` it takes ``active (B, n) bool`` between the two.
    Inputs go to ``x0``'s device; ``grad_fn`` as in ``piag_scan``."""
    dev = x0.device

    def run(T, *rest):
        active, params = rest if masked else (None, rest[0])
        T = torch.as_tensor(T).to(dev)
        if active is not None:
            active = torch.as_tensor(active).to(dev)
        tr = trace_scan(T, active=active)
        events = (tr.worker, tr.tau_max if use_tau_max else tr.tau)
        return piag_scan(worker_loss, x0, worker_data, events,
                         ParamPolicy(params.to(dev)), prox,
                         objective=objective, horizon=horizon,
                         active=active, record_every=record_every,
                         engine=engine, grad_fn=grad_fn)

    return run


def sweep_piag(worker_loss: Callable, x0, worker_data, grid: SweepGrid,
               prox: ProxOp, objective: Optional[Callable] = None,
               horizon: Horizon = 4096, use_tau_max: bool = True,
               bucket_widths: Optional[Sequence[int]] = None,
               record_every: int = 1, engine: str = "fused",
               grad_fn: Optional[Callable] = None) -> PIAGResult:
    """PIAG on every cell of ``grid``, one batched pass per bucket (a
    homogeneous grid is one pass).  ``grad_fn(xw, w)``, when given, must
    serve the widest bucket; narrower buckets use its first rows."""
    dev = x0.device
    horizon = resolve_grid_horizon(horizon, grid, device=dev)

    def run_bucket(b: SweepBucket):
        fn = make_sweep_piag(
            worker_loss, x0, _slice_workers(worker_data, b.width), prox,
            objective=objective, horizon=horizon, use_tau_max=use_tau_max,
            masked=not b.uniform, record_every=record_every, engine=engine,
            grad_fn=grad_fn)
        T = torch.from_numpy(b.grid.service_times(b.width))
        pp = b.grid.policy_params(dev)
        if b.uniform:
            return fn(T, pp)
        return fn(T, torch.from_numpy(b.grid.active_masks(b.width)), pp)

    return run_bucketed(grid, run_bucket, bucket_widths)


def sweep_piag_logreg(problem, grid: SweepGrid, prox: ProxOp,
                      horizon: int = 4096, engine: str = "fused") -> PIAGResult:
    """Grid analogue of ``core.piag.run_piag_logreg`` (routed through
    ``api.run_components``).  A cell with ``w`` workers runs on the first
    ``w`` shards of the problem's partition."""
    from ..api import run_components
    return run_components("piag", "batched", problem=problem, grid=grid,
                          prox=prox, horizon=horizon, engine=engine).raw
