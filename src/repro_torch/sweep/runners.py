"""Batched sweeps: every cell of a bucket advanced together (the PIAG and
federated parts of ``repro.sweep.runners``).

The reference jits ``vmap(trace + solver scan)`` into one program per
bucket.  Here a bucket is one pass of the event loop with the cells as the
leading tensor axis: the event race (``core.engine.trace_scan`` for PIAG,
``federated.events.federated_trace_scan`` for FedAsync/FedBuff) runs for
all B cells at once on the device, then the solver loop
(``core.piag.piag_scan``, ``federated.server.fedasync_scan`` /
``fedbuff_scan``) advances all B cells per event -- under
``engine='fused'`` with ONE kernel launch per event for the whole bucket.
Worker and client data stay one shared ``(W, n_per, d)`` tensor; cells
index it (the problem's ``worker_grads``), never copy it.  Rows are
stitched back into grid order.

Async-BCD runs the same race (``tau``, the shared-memory delay) with
each cell's block choices replayed from ``core.bcd.sample_blocks``.  Each
bucket's built program is kept in ``sweep.cache`` under its static
configuration (telemetry and faults included), and each bucket's dispatch
is timed for the run ledger.

``faults`` (a ``faults.FaultSpec``) stretches each cell's service times
or client round durations before the race and draws its per-event fault
codes, both keyed by the cell's seed (so a batched row equals its solo
run), and switches the solver loops to their guarded step bodies.
``checkpoint`` (a ``checkpoint.SweepCheckpoint``) makes the bucket loop
resumable.  ``sweep.shard`` runs these bucket programs once per row of a
device mesh.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..core.bcd import BCDResult, bcd_scan, sample_blocks
from ..core.engine import trace_scan
from ..core.piag import PIAGResult, piag_scan
from ..core.prox import ProxOp
from ..core.stepsize import auto_horizon
from ..federated.events import (ClientRounds, client_arrays,
                                default_fed_steps, federated_trace_scan,
                                sample_client_rounds, simulate_federated)
from ..faults.inject import (inject_client_rounds, inject_service_times,
                             update_fault_codes)
from ..faults.spec import normalize_faults
from ..federated.server import FedResult, fedasync_scan, fedbuff_scan
from ..telemetry.timing import timed
from .cache import IdKey, cached_program, tree_key
from .grid import SweepBucket, SweepGrid
from .policies import ParamPolicy

__all__ = ["make_sweep_piag", "sweep_piag", "sweep_piag_logreg",
           "make_sweep_bcd", "sweep_bcd", "sweep_bcd_logreg",
           "make_sweep_fedasync", "make_sweep_fedasync_fused",
           "make_sweep_fedbuff", "sweep_fedasync", "sweep_fedbuff",
           "sweep_fedasync_problem", "sweep_fedbuff_problem",
           "run_bucketed", "resolve_grid_horizon", "measure_fed_tau_bar",
           "fed_bucket_races", "races_tau_bar"]

Horizon = Union[int, str]  # a concrete H or "auto" (measured-delay sizing)


def resolve_grid_horizon(horizon: Horizon, grid: SweepGrid, *,
                         fed: bool = False, buffer_size: int = 1,
                         n_steps: Optional[int] = None,
                         slack: int = 1, bound: Optional[int] = None,
                         device=None) -> int:
    """``horizon='auto'|int`` -> a concrete H: ``'auto'`` sizes the window
    buffer to ``next_pow2(bound + slack)``, measuring the grid's own
    worst-case delay when no ``bound`` is given -- the service-time trace
    delays for PIAG, the upload staleness (``measure_fed_tau_bar``) for the
    federated servers (``fed=True``)."""
    if horizon != "auto":
        return int(horizon)
    if bound is None:
        bound = (measure_fed_tau_bar(grid, buffer_size=buffer_size,
                                     n_steps=n_steps, device=device)
                 if fed else grid.measure_tau_bar(device))
    return auto_horizon(bound, slack)


def run_bucketed(grid: SweepGrid, run_bucket: Callable,
                 bucket_widths: Optional[Sequence[int]] = None,
                 checkpoint=None, prepare: Optional[Callable] = None):
    """Run ``run_bucket(bucket) -> result`` (a tuple of tensors with a
    leading B_bucket axis) over every bucket of ``grid`` and stitch rows
    back into grid cell order.

    ``checkpoint`` (a ``checkpoint.SweepCheckpoint``) makes the loop
    resumable at bucket granularity: a bucket already on disk is loaded
    instead of run, and each fresh bucket is saved (a copy to the host,
    which waits for the device) before the next one starts.  With
    ``prepare`` each bucket that runs is ``run_bucket(bucket,
    prepare(bucket))``, the ``prepare`` call timed in a
    ``bucket_prepare`` span of its own, outside ``bucket_dispatch``."""
    buckets = grid.buckets(bucket_widths)
    parts = []
    for i, b in enumerate(buckets):
        if checkpoint is not None:
            cached = checkpoint.load_bucket(b.width, i)
            if cached is not None:
                parts.append(cached)
                continue
        args = ()
        if prepare is not None:
            with timed("bucket_prepare", width=b.width, cells=len(b.index)):
                args = (prepare(b),)
        # the bucket's host dispatch time (the device may still be busy;
        # api.run's synchronize covers that)
        with timed("bucket_dispatch", width=b.width, cells=len(b.index)):
            part = run_bucket(b, *args)
        if checkpoint is not None:
            checkpoint.save_bucket(b.width, i, part)
        parts.append(part)
    if len(parts) == 1:
        return parts[0]
    order = np.concatenate([b.index for b in buckets])
    inv = torch.from_numpy(np.argsort(order))

    def stitch(*xs):
        if not isinstance(xs[0], torch.Tensor):
            return xs[0]
        return torch.cat(xs, dim=0)[inv.to(xs[0].device)]

    def stitch_tree(*xs):
        if not isinstance(xs[0], tuple):
            return stitch(*xs)
        leaves = [stitch_tree(*col) for col in zip(*xs)]
        if hasattr(xs[0], "_fields"):  # a NamedTuple (result, telemetry)
            return type(xs[0])(*leaves)
        return tuple(leaves)

    return stitch_tree(*parts)


def _slice_workers(worker_data, width: int):
    """Rows 0..width-1 of every leaf: the bucket's view of the shared
    worker population."""
    if worker_data[0].shape[0] < width:
        raise ValueError(
            f"worker_data has {worker_data[0].shape[0]} rows < bucket width "
            f"{width}; provide data for the widest cell")
    return tuple(leaf[:width] for leaf in worker_data)


def _cell_seeds(b: SweepBucket, device) -> torch.Tensor:
    """(B,) per-cell seeds keying the fault streams of a bucket's cells."""
    return torch.tensor([c.seed for c in b.grid.cells], dtype=torch.int64,
                        device=device)


def _inject(T: torch.Tensor, faults, seeds):
    """(service times, per-event fault codes) of a bucket: under
    ``faults`` the times fault-injected and the K codes drawn, both keyed
    by the (B,) cell ``seeds``; else ``(T, None)``."""
    if faults is None:
        return T, None
    seeds = torch.as_tensor(seeds).to(T.device)
    return (inject_service_times(T, faults, seeds),
            update_fault_codes(faults, T.shape[-1] - 1, seeds))


def _split_args(rest, masked: bool, faulted: bool, n: int):
    """A bucket program's trailing arguments: ``[active,] *n [, seeds]``
    -> (active or None, the n middle arguments, seeds or None)."""
    rest = list(rest)
    seeds = rest.pop() if faulted else None
    active = rest.pop(0) if masked else None
    return active, rest[:n], seeds


def make_sweep_piag(worker_loss: Callable, x0, worker_data, prox: ProxOp,
                    objective: Optional[Callable] = None, horizon: int = 4096,
                    use_tau_max: bool = True, masked: bool = False,
                    record_every: int = 1, telemetry=None,
                    engine: str = "fused",
                    grad_fn: Optional[Callable] = None,
                    faults=None) -> Callable:
    """Build the batched PIAG program: ``fn(service_times (B, n, K+1),
    params (B,)) -> PIAGResult`` with a leading B on every leaf; with
    ``masked=True`` it takes ``active (B, n) bool`` between the two, and
    with ``faults`` a trailing ``seeds (B,)`` of cell seeds (the service
    times are fault-injected before the race and the event codes drawn
    from the same seeds).  Inputs go to ``x0``'s device; ``grad_fn`` as
    in ``piag_scan``."""
    dev = x0.device
    faults = normalize_faults(faults)

    def run(T, *rest):
        active, (params,), seeds = _split_args(rest, masked,
                                               faults is not None, 1)
        T = torch.as_tensor(T).to(dev)
        if active is not None:
            active = torch.as_tensor(active).to(dev)
        T, codes = _inject(T, faults, seeds)
        tr = trace_scan(T, active=active)
        events = (tr.worker, tr.tau_max if use_tau_max else tr.tau)
        return piag_scan(worker_loss, x0, worker_data, events,
                         ParamPolicy(params.to(dev)), prox,
                         objective=objective, horizon=horizon,
                         active=active, record_every=record_every,
                         telemetry=telemetry, engine=engine, grad_fn=grad_fn,
                         faults=faults, fault_codes=codes)

    return run


def sweep_piag(worker_loss: Callable, x0, worker_data, grid: SweepGrid,
               prox: ProxOp, objective: Optional[Callable] = None,
               horizon: Horizon = 4096, use_tau_max: bool = True,
               bucket_widths: Optional[Sequence[int]] = None,
               record_every: int = 1, telemetry=None, engine: str = "fused",
               grad_fn: Optional[Callable] = None, faults=None,
               checkpoint=None) -> PIAGResult:
    """PIAG on every cell of ``grid``, one batched pass per bucket (a
    homogeneous grid is one pass).  ``grad_fn(xw, w)``, when given, must
    serve the widest bucket; narrower buckets use its first rows.  Each
    bucket's program is cached (``sweep.cache``) under its static
    configuration and the identity of the captured objects.  ``faults``
    rides the cache key and switches in the fault-injected program;
    ``checkpoint`` makes the bucket loop resumable (``run_bucketed``)."""
    dev = x0.device
    horizon = resolve_grid_horizon(horizon, grid, device=dev)
    faults = normalize_faults(faults)

    def run_bucket(b: SweepBucket):
        key = ("piag", b.width, not b.uniform, horizon, use_tau_max,
               record_every, telemetry, engine, faults, IdKey(worker_loss),
               tree_key(x0), tree_key(worker_data), IdKey(prox),
               IdKey(objective), IdKey(grad_fn))
        fn = cached_program(key, lambda: make_sweep_piag(
            worker_loss, x0, _slice_workers(worker_data, b.width), prox,
            objective=objective, horizon=horizon, use_tau_max=use_tau_max,
            masked=not b.uniform, record_every=record_every,
            telemetry=telemetry, engine=engine, grad_fn=grad_fn,
            faults=faults))
        T = torch.from_numpy(b.grid.service_times(b.width))
        pp = b.grid.policy_params(dev)
        tail = (_cell_seeds(b, dev),) if faults is not None else ()
        if b.uniform:
            return fn(T, pp, *tail)
        return fn(T, torch.from_numpy(b.grid.active_masks(b.width)), pp,
                  *tail)

    return run_bucketed(grid, run_bucket, bucket_widths, checkpoint)


def sweep_piag_logreg(problem, grid: SweepGrid, prox: ProxOp,
                      horizon: int = 4096, engine: str = "fused") -> PIAGResult:
    """Grid analogue of ``core.piag.run_piag_logreg`` (routed through
    ``api.run_components``).  A cell with ``w`` workers runs on the first
    ``w`` shards of the problem's partition."""
    from ..api import run_components
    return run_components("piag", "batched", problem=problem, grid=grid,
                          prox=prox, horizon=horizon, engine=engine).raw


# ----------------------------------------------------------- Async-BCD ----

def make_sweep_bcd(grad_f: Callable, objective: Callable, x0, m: int,
                   n_workers: int, prox: ProxOp, horizon: int = 4096,
                   masked: bool = False, record_every: int = 1,
                   telemetry=None, engine: str = "fused",
                   faults=None) -> Callable:
    """Build the batched Async-BCD program: ``fn(service_times (B, n, K+1)
    [, active (B, n)], blocks (B, K), params (B,)[, seeds (B,)]) ->
    BCDResult`` on ``x0``'s device (``seeds`` with ``faults``, as in
    ``make_sweep_piag``).  BCD reduces nothing over workers, so the mask
    only guards the trace (see ``core.bcd.bcd_scan``)."""
    dev = x0.device
    faults = normalize_faults(faults)

    def run(T, *rest):
        active, (blocks, params), seeds = _split_args(
            rest, masked, faults is not None, 2)
        T = torch.as_tensor(T).to(dev)
        if active is not None:
            active = torch.as_tensor(active).to(dev)
        T, codes = _inject(T, faults, seeds)
        tr = trace_scan(T, active=active)
        events = (tr.worker, tr.tau, torch.as_tensor(blocks).to(dev))
        return bcd_scan(grad_f, objective, x0, m, n_workers, events,
                        ParamPolicy(params.to(dev)), prox, horizon=horizon,
                        record_every=record_every, telemetry=telemetry,
                        engine=engine, faults=faults, fault_codes=codes)

    return run


def sweep_bcd(grad_f: Callable, objective: Callable, x0, m: int,
              grid: SweepGrid, prox: ProxOp, horizon: Horizon = 4096,
              bucket_widths: Optional[Sequence[int]] = None,
              record_every: int = 1, telemetry=None,
              engine: str = "fused", faults=None,
              checkpoint=None) -> BCDResult:
    """Async-BCD on every cell of ``grid``, one batched pass per bucket on
    ``x0``'s device (one kernel launch per event for the bucket under
    ``engine='fused'``).  Block choices replay the solo draw
    (``sample_blocks(m, K, seed=cell seed)``), so batched rows equal solo
    rows.  Programs are cached as in ``sweep_piag``; ``faults`` and
    ``checkpoint`` as there."""
    dev = x0.device
    horizon = resolve_grid_horizon(horizon, grid, device=dev)
    faults = normalize_faults(faults)

    def run_bucket(b: SweepBucket):
        key = ("bcd", b.width, not b.uniform, horizon, m, record_every,
               telemetry, engine, faults, IdKey(grad_f), IdKey(objective),
               tree_key(x0), IdKey(prox))
        fn = cached_program(key, lambda: make_sweep_bcd(
            grad_f, objective, x0, m, b.width, prox, horizon=horizon,
            masked=not b.uniform, record_every=record_every,
            telemetry=telemetry, engine=engine, faults=faults))
        T = torch.from_numpy(b.grid.service_times(b.width))
        blocks = torch.from_numpy(np.stack([
            sample_blocks(m, grid.n_events, seed=c.seed)
            for c in b.grid.cells]))
        pp = b.grid.policy_params(dev)
        tail = (_cell_seeds(b, dev),) if faults is not None else ()
        if b.uniform:
            return fn(T, blocks, pp, *tail)
        return fn(T, torch.from_numpy(b.grid.active_masks(b.width)), blocks,
                  pp, *tail)

    return run_bucketed(grid, run_bucket, bucket_widths, checkpoint)


def sweep_bcd_logreg(problem, grid: SweepGrid, prox: ProxOp, m: int = 20,
                     horizon: int = 4096, engine: str = "fused") -> BCDResult:
    """Grid analogue of ``core.bcd.run_bcd_logreg`` (routed through
    ``api.run_components``)."""
    from ..api import run_components
    return run_components("bcd", "batched", problem=problem, grid=grid,
                          prox=prox, m=m, horizon=horizon, engine=engine).raw


# ------------------------------------------------- FedAsync / FedBuff ----

def _stack_fed_rounds(grid: SweepGrid, width: int, n_steps: int):
    """Per-cell pre-sampled client rounds, lifecycle constants and active
    masks stacked to the bucket width (host numpy): ``(ClientRounds of
    (B, width, n_steps), (p_dropout, rejoin_after, local_epochs) each
    (B, width), active (B, width))``.  Padded client rows carry benign
    constants; the ``active`` mask keeps them out of the race."""
    B = len(grid.cells)
    drop_u = np.zeros((B, width, n_steps), np.float32)
    dur = np.ones((B, width, n_steps), np.float32)
    p_drop = np.zeros((B, width), np.float32)
    rejoin = np.ones((B, width), np.float32)
    epochs = np.ones((B, width), np.int32)
    for i, c in enumerate(grid.cells):
        n = c.n_workers
        r = sample_client_rounds(list(c.workers), n_steps, seed=c.seed)
        drop_u[i, :n], dur[i, :n] = r.drop_u, r.duration
        p_drop[i, :n], rejoin[i, :n], epochs[i, :n] = client_arrays(
            list(c.workers))
    return (ClientRounds(drop_u, dur), (p_drop, rejoin, epochs),
            grid.active_masks(width))


def _inject_rounds(rounds, faults, seeds, device):
    """A bucket's client rounds with fault-injected durations (keyed by
    the (B,) cell ``seeds``), on ``device``."""
    put = (lambda a: torch.as_tensor(a).to(device))
    return inject_client_rounds(ClientRounds(put(rounds.drop_u),
                                             put(rounds.duration)),
                                faults, put(seeds))


def _fed_cell(server_scan: Callable, n_uploads: int, buffer_size: int,
              n_steps: int, device, faults=None) -> Callable:
    """A bucket's federated program: the batched trace race on ``device``,
    then ``server_scan(events, params[, fault_codes]) -> FedResult`` over
    its upload rows.  Returns ``fn(rounds, cparams, active, params[,
    seeds]) -> (FedResult, n_uploads (B,), exhausted (B,))``; the host
    checks the diagnostics.  With ``faults`` the trailing ``seeds`` (B,)
    key the round-duration injection and the upload fault codes."""

    def run(rounds, cparams, active, pp, seeds=None):
        codes = None
        if faults is not None:
            rounds = _inject_rounds(rounds, faults, seeds, device)
            codes = update_fault_codes(faults, n_uploads,
                                       torch.as_tensor(seeds).to(device))
        ftr = federated_trace_scan(rounds, *cparams, n_uploads,
                                   buffer_size=buffer_size, n_steps=n_steps,
                                   active=active, device=device)
        return server_scan(_race_events(ftr), pp.to(device), codes), \
            ftr.n_uploads, ftr.exhausted

    return run


def _race_events(ftr) -> tuple:
    """The event columns a server loop reads from a race's upload rows."""
    return (ftr.client, ftr.tau, ftr.local_steps,
            ftr.aggregate.to(torch.float32), ftr.version)


def _check_fed_diag(n_up: torch.Tensor, exhausted: torch.Tensor,
                    n_uploads: int, n_steps: int) -> None:
    """Raise when a cell's race emitted fewer than ``n_uploads`` uploads or
    ran past its pre-sampled attempts (one host read per bucket)."""
    short = int((n_up < n_uploads).sum())
    if short or bool(exhausted.any()):
        raise RuntimeError(
            f"{short} cell(s) produced fewer than {n_uploads} uploads within "
            f"{n_steps} pops (or exhausted pre-sampled attempts): "
            "dropout/rejoin chains exceeded the scan budget -- pass a larger "
            "n_steps")


def _fedasync_scan_adapter(client_update, x0, client_data, objective,
                           horizon, record_every=1, engine="fused",
                           telemetry=None, faults=None):
    def server_scan(events, pp, fault_codes=None):
        return fedasync_scan(client_update, x0, client_data, events,
                             ParamPolicy(pp), objective=objective,
                             horizon=horizon, record_every=record_every,
                             telemetry=telemetry, engine=engine,
                             faults=faults, fault_codes=fault_codes)
    return server_scan


def _fedbuff_scan_adapter(client_update, x0, client_data, objective, horizon,
                          eta, buffer_size, record_every=1, engine="fused",
                          telemetry=None, faults=None):
    def server_scan(events, pp, fault_codes=None):
        return fedbuff_scan(client_update, x0, client_data, events,
                            ParamPolicy(pp), eta=eta,
                            buffer_size=buffer_size, objective=objective,
                            horizon=horizon, record_every=record_every,
                            telemetry=telemetry, engine=engine,
                            faults=faults, fault_codes=fault_codes)
    return server_scan


def make_sweep_fedasync(client_update: Callable, x0, client_data,
                        objective: Optional[Callable] = None,
                        horizon: int = 4096, record_every: int = 1,
                        engine: str = "fused", telemetry=None,
                        faults=None) -> Callable:
    """The events-driven batched FedAsync program: ``fn(events (5 x
    (B, K)), params (B,)) -> FedResult`` on ``x0``'s device.  The events
    come stacked from the host, e.g. from the heapq twin
    ``_stack_fed_events``; the default sweep path races them on the device
    instead (``make_sweep_fedasync_fused``)."""
    return _fedasync_scan_adapter(client_update, x0, client_data, objective,
                                  horizon, record_every, engine, telemetry,
                                  normalize_faults(faults))


def make_sweep_fedasync_fused(client_update: Callable, x0, client_data,
                              n_uploads: int, buffer_size: int = 1,
                              objective: Optional[Callable] = None,
                              horizon: int = 4096,
                              n_steps: Optional[int] = None,
                              record_every: int = 1,
                              engine: str = "fused",
                              telemetry=None, faults=None) -> Callable:
    """The batched FedAsync program with the trace race fused in:
    ``fn(rounds, cparams, active, params[, seeds]) -> (FedResult,
    n_uploads (B,), exhausted (B,))``, on ``x0``'s device (``seeds`` with
    ``faults``)."""
    S = default_fed_steps(n_uploads) if n_steps is None else int(n_steps)
    faults = normalize_faults(faults)
    return _fed_cell(_fedasync_scan_adapter(client_update, x0, client_data,
                                            objective, horizon, record_every,
                                            engine, telemetry, faults),
                     n_uploads, buffer_size, S, x0.device, faults)


def make_sweep_fedbuff(client_update: Callable, x0, client_data,
                       n_uploads: int, eta: float = 1.0, buffer_size: int = 1,
                       objective: Optional[Callable] = None,
                       horizon: int = 4096, n_steps: Optional[int] = None,
                       record_every: int = 1,
                       engine: str = "fused", telemetry=None,
                       faults=None) -> Callable:
    """The batched FedBuff program (the shape of
    ``make_sweep_fedasync_fused`` with the buffered-delta server)."""
    S = default_fed_steps(n_uploads) if n_steps is None else int(n_steps)
    faults = normalize_faults(faults)
    return _fed_cell(_fedbuff_scan_adapter(client_update, x0, client_data,
                                           objective, horizon, eta,
                                           buffer_size, record_every, engine,
                                           telemetry, faults),
                     n_uploads, buffer_size, S, x0.device, faults)


def _race_bucket(b: SweepBucket, n_uploads: int, buffer_size: int,
                 n_steps: int, device, faults=None):
    """One bucket's batched trace race on ``device`` (round durations
    fault-injected by cell seed under ``faults``)."""
    rounds, cparams, active = _stack_fed_rounds(b.grid, b.width, n_steps)
    if faults is not None:
        rounds = _inject_rounds(rounds, faults, _cell_seeds(b, device),
                                device)
    return federated_trace_scan(rounds, *cparams, n_uploads,
                                buffer_size=buffer_size, n_steps=n_steps,
                                active=active, device=device)


def fed_bucket_races(grid: SweepGrid, buffer_size: int = 1,
                     n_steps: Optional[int] = None, device=None,
                     bucket_widths: Optional[Sequence[int]] = None,
                     faults=None) -> list:
    """The batched trace race of every bucket of ``grid``
    (``grid.buckets(bucket_widths)`` order) on ``device``: a list of
    ``FederatedTraceArrays``.  The federated sweeps run their servers over
    these rows, and ``horizon='auto'`` sizes the weight buffer from their
    staleness, so a run races each bucket once.  ``faults`` injects the
    round durations first.  Adds the wall seconds it took, up to the end
    of the device work, to ``fed_bucket_races.seconds``."""
    K = grid.n_events
    S = default_fed_steps(K) if n_steps is None else int(n_steps)
    return _race_buckets(grid.buckets(bucket_widths), K, buffer_size, S,
                         device, normalize_faults(faults))


def _race_buckets(buckets, n_uploads: int, buffer_size: int, n_steps: int,
                  device, faults=None) -> list:
    """``_race_bucket`` over ``buckets``, adding the wall seconds up to the
    end of the device work to ``fed_bucket_races.seconds`` (every race of
    a federated sweep is counted there, whether raced up front or as its
    bucket runs)."""
    t0 = time.perf_counter()
    races = [_race_bucket(b, n_uploads, buffer_size, n_steps, device, faults)
             for b in buckets]
    if races and races[-1].tau.is_cuda:
        torch.cuda.synchronize(races[-1].tau.device)
    fed_bucket_races.seconds += time.perf_counter() - t0
    return races


fed_bucket_races.seconds = 0.0


def races_tau_bar(races: Sequence) -> int:
    """Worst-case upload staleness over ``fed_bucket_races`` rows."""
    return max((int(r.tau.max()) for r in races if r.tau.numel()),
               default=0)


def measure_fed_tau_bar(grid: SweepGrid, buffer_size: int = 1,
                        n_steps: Optional[int] = None, device=None) -> int:
    """Worst-case upload staleness over a federated grid's pre-sampled
    traces (what ``horizon='auto'`` sizes the weight buffer from): the
    batched trace race only, one pass per bucket, on ``device``."""
    return races_tau_bar(fed_bucket_races(grid, buffer_size, n_steps,
                                          device))


def _stack_fed_events(grid: SweepGrid, buffer_size: int,
                      n_steps: Optional[int] = None, device=None):
    """The heapq twin of the device race: one ``simulate_federated`` trace
    per cell, driven by the same pre-sampled rounds, stacked into the
    (B, K) event columns the server loop reads (on ``device``)."""
    S = default_fed_steps(grid.n_events) if n_steps is None else int(n_steps)
    traces = [simulate_federated(
        c.n_workers, grid.n_events, clients=list(c.workers),
        buffer_size=buffer_size, seed=c.seed,
        client_rounds=sample_client_rounds(list(c.workers), S, seed=c.seed))
        for c in grid.cells]
    return tuple(
        torch.from_numpy(np.stack([np.asarray(getattr(t, f), dt)
                                   for t in traces])).to(device)
        for f, dt in [("client", np.int32), ("tau", np.int32),
                      ("local_steps", np.int32), ("aggregate", np.float32),
                      ("version", np.int32)])


def _sweep_fed(make_server: Callable, grid: SweepGrid, client_data,
               buffer_size: int, reference: bool, n_steps: Optional[int],
               device, bucket_widths: Optional[Sequence[int]] = None,
               races: Optional[Sequence] = None,
               cache_key: tuple = (), faults=None,
               checkpoint=None) -> FedResult:
    """The common body of ``sweep_fedasync`` and ``sweep_fedbuff``: the
    server loop (``make_server(client_data) -> server_scan``) of each
    bucket over its race (``races``, from ``fed_bucket_races`` with the
    same ``bucket_widths`` and ``faults``, or raced here in the bucket's
    ``bucket_prepare`` span -- a bucket loaded from ``checkpoint`` is not
    raced).  Each bucket's server is cached under ``cache_key + (width,
    n_steps)``; under ``faults`` it draws the bucket's upload fault codes
    by cell seed."""
    K = grid.n_events
    S = default_fed_steps(K) if n_steps is None else int(n_steps)
    if reference:
        if faults is not None:
            raise TypeError(
                "reference=True does not support fault injection (the heapq "
                "reference path has no per-cell seed stream); use the fused "
                "path")
        return make_server(client_data)(
            _stack_fed_events(grid, buffer_size, n_steps=S, device=device),
            grid.policy_params(device))
    by_width = {} if races is None else {
        b.width: r for b, r in zip(grid.buckets(bucket_widths), races)}

    def race(b: SweepBucket):
        ftr = by_width.get(b.width)
        if ftr is None:
            ftr = _race_buckets([b], K, buffer_size, S, device, faults)[0]
        return ftr

    def run_bucket(b: SweepBucket, ftr):
        _check_fed_diag(ftr.n_uploads, ftr.exhausted, K, S)
        server = cached_program(cache_key + (b.width, S), lambda: make_server(
            _slice_workers(client_data, b.width)))
        codes = None if faults is None else update_fault_codes(
            faults, K, _cell_seeds(b, device))
        return server(_race_events(ftr), b.grid.policy_params(device), codes)

    return run_bucketed(grid, run_bucket, bucket_widths, checkpoint,
                        prepare=race)


def _fed_horizon(horizon: Horizon, grid: SweepGrid, buffer_size: int,
                 n_steps: Optional[int], reference: bool, device,
                 bucket_widths: Optional[Sequence[int]], races,
                 faults=None):
    """(concrete H, the bucket races to reuse or None): ``'auto'`` sizes H
    from the races the sweep then runs its servers over.  Under
    ``faults`` the bound comes from the fault-free races, as in the
    reference, and the sweep races its buckets anew with the faults."""
    if horizon != "auto" or reference:
        return resolve_grid_horizon(horizon, grid, fed=True,
                                    buffer_size=buffer_size, n_steps=n_steps,
                                    device=device), races
    if races is None:
        races = fed_bucket_races(grid, buffer_size, n_steps, device,
                                 bucket_widths)
    H = auto_horizon(races_tau_bar(races), 1)
    return H, (None if faults is not None else races)


def sweep_fedasync(client_update: Callable, x0, client_data, grid: SweepGrid,
                   objective: Optional[Callable] = None,
                   buffer_size: int = 1, horizon: Horizon = 4096,
                   reference: bool = False,
                   n_steps: Optional[int] = None,
                   bucket_widths: Optional[Sequence[int]] = None,
                   record_every: int = 1,
                   engine: str = "fused",
                   races: Optional[Sequence] = None,
                   telemetry=None, faults=None,
                   checkpoint=None) -> FedResult:
    """FedAsync on every cell of a grid whose topologies are
    ``ClientModel`` lists, one batched pass per bucket on ``x0``'s device:
    the client round-trip race, then the server loop (one kernel launch
    per upload for the bucket under ``engine='fused'``).
    ``reference=True`` takes the events from the heapq twin instead
    (bitwise the same events).  ``horizon='auto'`` sizes the weight buffer
    from the grid's measured upload staleness.  ``races``: the buckets'
    ``fed_bucket_races`` (same ``bucket_widths`` and ``faults``), when
    already run.  ``faults`` / ``checkpoint`` as in ``sweep_piag``."""
    dev = x0.device
    faults = normalize_faults(faults)
    horizon, races = _fed_horizon(horizon, grid, buffer_size, n_steps,
                                  reference, dev, bucket_widths, races,
                                  faults)

    def make_server(cd):
        return make_sweep_fedasync(client_update, x0, cd, objective, horizon,
                                   record_every, engine, telemetry, faults)

    key = ("fedasync", grid.n_events, buffer_size, horizon, record_every,
           telemetry, engine, faults, IdKey(client_update), tree_key(x0),
           tree_key(client_data), IdKey(objective))
    return _sweep_fed(make_server, grid, client_data, buffer_size,
                      reference, n_steps, dev, bucket_widths=bucket_widths,
                      races=races, cache_key=key, faults=faults,
                      checkpoint=checkpoint)


def sweep_fedbuff(client_update: Callable, x0, client_data, grid: SweepGrid,
                  eta: float = 1.0, buffer_size: int = 1,
                  objective: Optional[Callable] = None,
                  horizon: Horizon = 4096, reference: bool = False,
                  n_steps: Optional[int] = None,
                  bucket_widths: Optional[Sequence[int]] = None,
                  record_every: int = 1,
                  engine: str = "fused",
                  races: Optional[Sequence] = None,
                  telemetry=None, faults=None,
                  checkpoint=None) -> FedResult:
    """FedBuff on every cell: the batched race + buffered delta
    aggregation, one pass per bucket; ``reference`` / ``horizon`` /
    ``races`` / ``faults`` / ``checkpoint`` as in ``sweep_fedasync``."""
    dev = x0.device
    faults = normalize_faults(faults)
    horizon, races = _fed_horizon(horizon, grid, buffer_size, n_steps,
                                  reference, dev, bucket_widths, races,
                                  faults)

    def make_server(cd):
        return _fedbuff_scan_adapter(client_update, x0, cd, objective,
                                     horizon, eta, buffer_size, record_every,
                                     engine, telemetry, faults)

    key = ("fedbuff", grid.n_events, eta, buffer_size, horizon, record_every,
           telemetry, engine, faults, IdKey(client_update), tree_key(x0),
           tree_key(client_data), IdKey(objective))
    return _sweep_fed(make_server, grid, client_data, buffer_size,
                      reference, n_steps, dev, bucket_widths=bucket_widths,
                      races=races, cache_key=key, faults=faults,
                      checkpoint=checkpoint)


def sweep_fedasync_problem(problem, grid: SweepGrid, prox: ProxOp,
                           local_lr: Optional[float] = None,
                           horizon: int = 4096, reference: bool = False,
                           n_steps: Optional[int] = None,
                           engine: str = "fused") -> FedResult:
    """Grid analogue of ``federated.server.run_fedasync_problem`` (routed
    through ``api.run_components``)."""
    from ..api import run_components
    return run_components("fedasync", "batched", problem=problem, grid=grid,
                          prox=prox, local_lr=local_lr, horizon=horizon,
                          reference=reference, n_steps=n_steps,
                          engine=engine).raw


def sweep_fedbuff_problem(problem, grid: SweepGrid, prox: ProxOp,
                          eta: float = 1.0, buffer_size: int = 1,
                          local_lr: Optional[float] = None,
                          horizon: int = 4096, reference: bool = False,
                          n_steps: Optional[int] = None,
                          engine: str = "fused") -> FedResult:
    """Grid analogue of ``federated.server.run_fedbuff_problem``."""
    from ..api import run_components
    return run_components("fedbuff", "batched", problem=problem, grid=grid,
                          prox=prox, eta=eta, buffer_size=buffer_size,
                          local_lr=local_lr, horizon=horizon,
                          reference=reference, n_steps=n_steps,
                          engine=engine).raw
