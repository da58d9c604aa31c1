"""Route an ``ExperimentSpec`` to the port's runners (counterpart of
``repro.api.run``).

``resolve(spec)`` materializes the declarative axes -- problem, prox,
policies (with the paper's tau-bar tuning protocol for the fixed family),
topology factories, the ``SweepGrid`` -- on the spec's device and performs
the build-time horizon validation.  ``run(spec)`` then dispatches:

========  ==================================  ================================
solver    solo                                batched
========  ==================================  ================================
piag      ``core.piag.run_piag``              ``sweep.runners.sweep_piag``
bcd       ``core.bcd.run_async_bcd``          ``sweep.runners.sweep_bcd``
fedasync  ``federated.server.run_fedasync``   ``sweep.runners.sweep_fedasync``
fedbuff   ``federated.server.run_fedbuff``    ``sweep.runners.sweep_fedbuff``
========  ==================================  ================================

Every run also builds a ``telemetry.RunRecord`` (on ``Results.telemetry``;
appended to the JSONL ledger when one is set).  ``spec.faults`` (a
``faults.FaultSpec``, under ``engine='scan'``) injects faults into every
solver, solo and batched, with the counters on ``RunRecord.faults``;
``run(spec, resume=dir)`` resumes a killed run from its bucket (or cell)
checkpoints.  What is not ported yet raises ``NotImplementedError`` naming
its ROADMAP queue A item: the sharded backend (item 12).
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import analysis
from ..core.bcd import run_async_bcd, sample_blocks
from ..core.engine import generate_trace, sample_service_times
from ..core.piag import run_piag
from ..core.problems import make_lasso, make_logreg
from ..core.prox import make_prox
from ..core.stepsize import make_policy
from ..checkpoint.sweep import SweepCheckpoint
from ..faults.guards import summarize_faults
from ..faults.inject import inject_service_times
from ..federated.events import (generate_federated_trace,
                                heterogeneous_clients)
from ..federated.server import _problem_pieces, run_fedasync, run_fedbuff
from ..kernels.dispatch import resolve_device
from ..sweep.grid import (SweepGrid, make_grid, measure_tau_bar,
                          standard_topology_factories)
from ..sweep.cache import LRU, IdKey, program_cache_stats
from ..sweep.runners import (fed_bucket_races, races_tau_bar,
                             resolve_grid_horizon, sweep_bcd, sweep_fedasync,
                             sweep_fedbuff, sweep_piag)
from ..telemetry.accumulators import TelemetryConfig, summarize_telemetry
from ..telemetry.ledger import (RunRecord, append_record, cache_delta,
                                estimate_carry_bytes, spec_fingerprint)
from ..telemetry.timing import COMPILE_EVENT_NAMES, drain_timings
from .results import Results
from .spec import (FIXED_FAMILY, ExecutionSpec, ExperimentSpec, ProblemSpec,
                   SolverSpec, check_horizon)

__all__ = ["Resolved", "resolve", "run", "run_components", "component_spec"]

# resolve-time memos: repeated runs of value-equal specs on one device
# reuse the same problem (the 60 000-sample build and its power iterations
# cost seconds), prox and runner pieces, so the program cache
# (``sweep.cache``) sees the same captured objects and serves its programs
_PROBLEM_MEMO = LRU(4)
_PROX_MEMO = LRU(32)
_PIECES_MEMO = LRU(32)


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue A item "
        f"{item}); run it with the reference package `repro`")


class Resolved(NamedTuple):
    """The concrete objects a spec compiles to (pre-dispatch); ``horizon``
    is the concrete window-buffer size."""

    spec: ExperimentSpec
    problem: Any
    prox: Any
    grid: SweepGrid
    tau_bar: Optional[int]
    horizon: int
    device: torch.device
    races: Optional[list] = None  # a batched federated run's bucket races


# -------------------------------------------------------------- resolve ----

def _build_problem(spec: ExperimentSpec, device: torch.device):
    ps = spec.problem
    if ps.problem is not None:
        return ps.problem
    maker = make_logreg if ps.kind == "logreg" else make_lasso
    kwargs = dict(ps.params)
    kwargs.setdefault("n_workers", spec.topology.width_max)
    try:
        key = (ps.kind, tuple(sorted(kwargs.items())), str(device))
        hash(key)
    except TypeError:  # exotic params: build fresh, skip memoization
        return maker(device=device, **kwargs)
    return _PROBLEM_MEMO.get(key, lambda: maker(device=device, **kwargs))


def _build_prox(spec: ExperimentSpec, problem):
    ps = spec.problem
    if ps.prox_op is not None:
        return ps.prox_op
    kwargs = dict(ps.prox_params)
    if ps.prox == "l1":
        kwargs.setdefault("lam", problem.lam1)
    try:
        key = (ps.prox, tuple(sorted(kwargs.items())))
        hash(key)
    except TypeError:
        return make_prox(ps.prox, **kwargs)
    return _PROX_MEMO.get(key, lambda: make_prox(ps.prox, **kwargs))


def _build_topologies(spec: ExperimentSpec):
    ts = spec.topology
    if ts.kind == "custom":
        topos = dict(ts.topologies)
    elif ts.kind == "edge":
        params = dict(ts.params)
        seed = params.pop("seed", ts.seed)  # params may pin its own seed
        topos = {"edge": lambda n, _p=params: heterogeneous_clients(
            n, seed=seed, **_p)}
    else:
        topos = standard_topology_factories(ts.seed)
    if ts.names is not None:
        unknown = set(ts.names) - set(topos)
        if unknown:
            raise ValueError(f"unknown topology names {sorted(unknown)}; "
                             f"available: {sorted(topos)}")
        topos = {n: topos[n] for n in ts.names}
    return topos


def _measure_tau_bar(spec: ExperimentSpec, topos, device) -> int:
    """Worst-case trace delay over every (topology, width, seed) cell --
    the paper's protocol for tuning the fixed family, reused for horizon
    validation and ``'auto'`` sizing."""
    ts = spec.topology
    if ts.n_workers is not None:
        menu = {f"{tn}/w{int(w)}": f(int(w))
                for tn, f in topos.items() for w in ts.n_workers}
    else:
        menu = {tn: ws for tn, ws in topos.items()}
    return measure_tau_bar(menu, list(spec.policies.seeds), spec.n_events,
                           device=device)


def _auto_gamma_prime(spec: ExperimentSpec, problem) -> float:
    if spec.solver.name == "piag":
        return 0.99 / problem.L
    if spec.solver.name == "bcd":
        return 0.99 / problem.block_smoothness(spec.solver.m)
    return 0.6  # federated base mixing weight alpha


def _build_policies(spec: ExperimentSpec, problem, tau_bar: Optional[int]):
    pg = spec.policies
    if pg.policies is not None:
        return dict(pg.policies)
    gp = pg.gamma_prime if pg.gamma_prime is not None \
        else _auto_gamma_prime(spec, problem)
    out = {}
    for name in pg.names:
        kwargs = dict(pg.policy_kwargs.get(name, {}))
        if name in FIXED_FAMILY and "tau_bound" not in kwargs:
            bound = pg.tau_bound if pg.tau_bound is not None else tau_bar
            if bound is None:
                raise ValueError(
                    f"policy {name!r} needs a worst-case delay bound: set "
                    "PolicyGridSpec.tau_bound or enable DelaySpec.measure")
            kwargs["tau_bound"] = int(bound)
        out[name] = make_policy(name, gp, **kwargs)
    return out


def _validate_horizon(spec: ExperimentSpec, tau_bar: Optional[int]) -> None:
    exp = spec.delay.expected_max_delay
    check_horizon(spec.solver.horizon, tau_bar if exp is None else exp)


def _check_ported(spec: ExperimentSpec) -> None:
    """Refuse, before any work, what the port cannot run yet."""
    if spec.execution.backend == "sharded":
        raise _not_ported("backend='sharded'", 12)


def _resolve_horizon(spec: ExperimentSpec, grid: SweepGrid,
                     tau_bar: Optional[int], device):
    """(the concrete window-buffer size, the bucket races to reuse or
    None): integer horizons pass through; ``'auto'`` sizes from the
    declared ``expected_max_delay``, the already-measured worker tau-bar
    (PIAG), or the federated upload staleness of the buckets' races, with
    the spec's ``horizon_slack``.  A batched federated run keeps those
    races, so its sweep runs the server loops over them and races each
    bucket once.  The races never see ``spec.faults`` (as in the
    reference): a faulted run races its buckets anew with the faults."""
    sv, ex = spec.solver, spec.execution
    bound = spec.delay.expected_max_delay
    if bound is None and not sv.federated:
        bound = tau_bar
    bs = sv.buffer_size if sv.name == "fedbuff" else 1
    races = None
    if sv.federated and sv.horizon == "auto" and bound is None:
        races = fed_bucket_races(
            grid, bs, sv.n_steps, device,
            ex.bucket_widths if ex.backend == "batched" else None)
        bound = races_tau_bar(races)
        if ex.backend != "batched" or ex.reference \
                or spec.faults is not None:
            races = None
    return resolve_grid_horizon(
        sv.horizon, grid, fed=sv.federated, buffer_size=bs,
        n_steps=sv.n_steps, slack=spec.delay.horizon_slack, bound=bound,
        device=device), races


def resolve(spec: ExperimentSpec) -> Resolved:
    """Materialize problem, prox, policies and grid on the spec's device
    (``ExecutionSpec.device``; None = the CUDA card, raising when there is
    none); validate the horizon."""
    _check_ported(spec)
    device = resolve_device(spec.execution.device)
    problem = _build_problem(spec, device)
    prox = _build_prox(spec, problem)

    if spec.grid is not None:
        if spec.validate_horizon:
            _validate_horizon(spec, None)
        horizon, races = _resolve_horizon(spec, spec.grid, None, device)
        return Resolved(spec, problem, prox, spec.grid, None, horizon, device,
                        races)

    topos = _build_topologies(spec)
    pg = spec.policies
    needs_bound = (pg.policies is None and pg.tau_bound is None
                   and any(n in FIXED_FAMILY for n in pg.names))
    worker_solver = not spec.solver.federated
    auto = spec.solver.horizon == "auto"
    needs_measure = worker_solver and (
        (needs_bound and spec.delay.measure)
        or (spec.validate_horizon and spec.delay.measure
            and spec.delay.expected_max_delay is None)
        or (auto and spec.delay.expected_max_delay is None))
    tau_bar = _measure_tau_bar(spec, topos, device) if needs_measure else None
    if spec.solver.federated:
        tau_bar = 0  # fixed baselines are not the federated story
    elif needs_bound and tau_bar is None:
        raise ValueError(
            "fixed-family policies need tau_bound (or DelaySpec.measure)")

    policies = _build_policies(spec, problem, tau_bar)
    grid = make_grid(policies, list(pg.seeds), topos, spec.n_events,
                     n_workers=(list(spec.topology.n_workers)
                                if spec.topology.n_workers is not None
                                else None))
    if spec.validate_horizon:
        _validate_horizon(spec, tau_bar if worker_solver else None)
    horizon, races = _resolve_horizon(
        spec, grid, tau_bar if worker_solver else None, device)
    return Resolved(spec, problem, prox, grid, tau_bar, horizon, device,
                    races)


# ------------------------------------------------------------- dispatch ----

def _piag_pieces(problem):
    """(loss, x0, worker_data, objective, grad_fn) for PIAG, memoized per
    problem; problems with a closed-form batched gradient
    (``worker_grads``) use it."""
    def build():
        x0 = torch.zeros((problem.dim,), dtype=torch.float32,
                         device=problem.A.device)
        grad_fn = problem.worker_grads() \
            if hasattr(problem, "worker_grads") else None
        return (problem.worker_loss, x0, problem.worker_slices(), problem.P,
                grad_fn)

    return _PIECES_MEMO.get(("piag", IdKey(problem)), build)


def _bcd_pieces(problem):
    """(grad_f, objective, x0) for Async-BCD, memoized per problem."""
    def build():
        return (problem.grad_f, problem.P,
                torch.zeros((problem.dim,), dtype=torch.float32,
                            device=problem.A.device))

    return _PIECES_MEMO.get(("bcd", IdKey(problem)), build)


def _fed_pieces(problem, prox, local_lr):
    """(update, x0, client_data, objective), memoized per problem, prox
    and local step size."""
    def build():
        update, x0, data = _problem_pieces(problem, prox, local_lr)
        return update, x0, data, problem.P

    return _PIECES_MEMO.get(("fed", IdKey(problem), IdKey(prox), local_lr),
                            build)


def _telemetry_cfg(spec: ExperimentSpec) -> Optional[TelemetryConfig]:
    """The in-loop accumulator config: None (the telemetry-off step body)
    unless the spec opts in."""
    ex = spec.execution
    return TelemetryConfig(delay_bins=ex.telemetry_bins) \
        if ex.telemetry else None


def _inject_T(T: np.ndarray, faults, cell_seed: int, device) -> np.ndarray:
    """A solo cell's fault-injected service times: the transform its
    batched row applies, on ``device``, keyed by the cell seed."""
    return inject_service_times(torch.from_numpy(T).to(device), faults,
                                int(cell_seed)).cpu().numpy()


def _solo_cells(grid, ckpt, run_cell):
    """The solo per-cell loop with optional per-cell checkpoints (cell
    files keyed on (width = n_workers, idx = cell index) through the
    ``SweepCheckpoint`` the bucketed runners use)."""
    rows = []
    for i, c in enumerate(grid.cells):
        if ckpt is not None:
            cached = ckpt.load_bucket(c.n_workers, i)
            if cached is not None:
                rows.append(cached)
                continue
        row = run_cell(c)
        if ckpt is not None:
            ckpt.save_bucket(c.n_workers, i, row)
        rows.append(row)
    return _stack_rows(rows)


def _run_piag(r: Resolved, ckpt=None):
    spec = r.spec
    loss, x0, wd, objective, grad_fn = _piag_pieces(r.problem)
    h, utm = r.horizon, spec.delay.use_tau_max
    s = spec.execution.record_every
    tel = _telemetry_cfg(spec)
    eng = spec.execution.engine
    fl = spec.faults
    if spec.execution.backend == "batched":
        return sweep_piag(loss, x0, wd, r.grid, r.prox, objective=objective,
                          horizon=h, use_tau_max=utm,
                          bucket_widths=spec.execution.bucket_widths,
                          record_every=s, telemetry=tel, engine=eng,
                          grad_fn=grad_fn, faults=fl, checkpoint=ckpt)

    def run_cell(c):
        T = sample_service_times(c.workers, r.grid.n_events + 1, seed=c.seed)
        if fl is not None:
            T = _inject_T(T, fl, c.seed, r.device)
        tr = generate_trace(T, device=r.device)
        return run_piag(loss, x0, tuple(leaf[:c.n_workers] for leaf in wd),
                        tr, c.policy, r.prox, objective=objective,
                        horizon=h, use_tau_max=utm, record_every=s,
                        telemetry=tel, engine=eng, grad_fn=grad_fn,
                        faults=fl, fault_seed=c.seed)

    return _solo_cells(r.grid, ckpt, run_cell)


def _run_bcd(r: Resolved, ckpt=None):
    spec = r.spec
    m, h = spec.solver.m, r.horizon
    grad_f, objective, x0 = _bcd_pieces(r.problem)
    s = spec.execution.record_every
    tel = _telemetry_cfg(spec)
    eng = spec.execution.engine
    fl = spec.faults
    if spec.execution.backend == "batched":
        return sweep_bcd(grad_f, objective, x0, m, r.grid, r.prox,
                         horizon=h, bucket_widths=spec.execution.bucket_widths,
                         record_every=s, telemetry=tel, engine=eng,
                         faults=fl, checkpoint=ckpt)

    def run_cell(c):
        T = sample_service_times(c.workers, r.grid.n_events + 1, seed=c.seed)
        if fl is not None:
            T = _inject_T(T, fl, c.seed, r.device)
        tr = generate_trace(T, kind="shared_memory", device=r.device)
        blocks = sample_blocks(m, r.grid.n_events, seed=c.seed)
        return run_async_bcd(grad_f, objective, x0, m, tr, blocks,
                             c.policy, r.prox, horizon=h, record_every=s,
                             telemetry=tel, engine=eng, faults=fl,
                             fault_seed=c.seed)

    return _solo_cells(r.grid, ckpt, run_cell)


def _run_fed(r: Resolved, ckpt=None):
    spec = r.spec
    sv = spec.solver
    update, x0, data, objective = _fed_pieces(r.problem, r.prox, sv.local_lr)
    h, n_steps = r.horizon, sv.n_steps
    bs = sv.buffer_size if sv.name == "fedbuff" else 1
    s = spec.execution.record_every
    tel = _telemetry_cfg(spec)
    eng = spec.execution.engine
    fl = spec.faults
    if spec.execution.backend == "batched":
        if sv.name == "fedasync":
            return sweep_fedasync(update, x0, data, r.grid,
                                  objective=objective, horizon=h,
                                  reference=spec.execution.reference,
                                  n_steps=n_steps,
                                  bucket_widths=spec.execution.bucket_widths,
                                  record_every=s, engine=eng, races=r.races,
                                  telemetry=tel, faults=fl, checkpoint=ckpt)
        return sweep_fedbuff(update, x0, data, r.grid, eta=sv.eta,
                             buffer_size=bs, objective=objective, horizon=h,
                             reference=spec.execution.reference,
                             n_steps=n_steps,
                             bucket_widths=spec.execution.bucket_widths,
                             record_every=s, engine=eng, races=r.races,
                             telemetry=tel, faults=fl, checkpoint=ckpt)

    def run_cell(c):
        tr = generate_federated_trace(c.n_workers, r.grid.n_events,
                                      clients=list(c.workers),
                                      buffer_size=bs, seed=c.seed,
                                      n_steps=n_steps, faults=fl,
                                      device=r.device)
        cd = tuple(leaf[:c.n_workers] for leaf in data)
        if sv.name == "fedasync":
            return run_fedasync(update, x0, cd, tr, c.policy,
                                objective=objective, horizon=h,
                                record_every=s, telemetry=tel, engine=eng,
                                faults=fl, fault_seed=c.seed)
        return run_fedbuff(update, x0, cd, tr, c.policy, eta=sv.eta,
                           buffer_size=bs, objective=objective, horizon=h,
                           record_every=s, telemetry=tel, engine=eng,
                           faults=fl, fault_seed=c.seed)

    return _solo_cells(r.grid, ckpt, run_cell)


_SOLVER_DISPATCH = {"piag": _run_piag, "bcd": _run_bcd,
                    "fedasync": _run_fed, "fedbuff": _run_fed}


def _stack_rows(rows):
    """Stack solo rows along a new cell axis (nested result tuples, such
    as ``telemetry``, leaf by leaf)."""
    first = rows[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(rows)
    if isinstance(first, tuple):
        return type(first)(*(_stack_rows(list(col)) for col in zip(*rows)))
    return first


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _build_record(spec: ExperimentSpec, r: Resolved, raw: Any,
                  elapsed: float, cache: dict, timings) -> RunRecord:
    """Fold one dispatched run into the ledger's ``RunRecord`` (host-side
    bookkeeping on results already synchronized)."""
    grid, bins = r.grid, spec.execution.telemetry_bins
    tel = getattr(raw, "telemetry", None)
    if tel is not None:
        summ = summarize_telemetry(tel)
        delay_hist, hist_source = summ["hist"], "accumulator"
        tau_stats, gamma_stats = summ["tau"], summ["gamma"]
    else:
        taus = _host(raw.taus).reshape(-1)
        gam = _host(raw.weights if "weights" in raw._fields
                    else raw.gammas).astype(np.float64).reshape(-1)
        delay_hist = np.bincount(np.clip(taus, 0, bins - 1),
                                 minlength=bins).astype(np.int64).tolist()
        hist_source = "recorded"
        tau_stats = {"min": int(taus.min()), "max": int(taus.max()),
                     "mean": float(taus.mean()), "std": float(taus.std())}
        gamma_stats = {"min": float(gam.min()), "max": float(gam.max()),
                       "mean": float(gam.mean()), "std": float(gam.std())}
    compile_ms = sum(ev["ms"] for ev in timings
                     if ev["name"] in COMPILE_EVENT_NAMES)
    width = max(c.n_workers for c in grid.cells)
    return RunRecord(
        ts=time.time(),
        fingerprint=spec_fingerprint(spec, grid),
        solver=spec.solver.name,
        backend=spec.execution.backend,
        n_cells=len(grid.cells),
        n_events=int(grid.n_events),
        record_every=int(spec.execution.record_every),
        horizon=int(r.horizon),
        tau_bar=None if r.tau_bar is None else int(r.tau_bar),
        devices=1,
        mesh_shape=None,
        carry_bytes=estimate_carry_bytes(spec.solver.name,
                                         int(getattr(r.problem, "dim", 0)),
                                         width, r.horizon, len(grid.cells)),
        elapsed_ms=elapsed * 1e3,
        compile_ms=float(compile_ms),
        warm_ms=max(elapsed * 1e3 - compile_ms, 0.0),
        cache=cache,
        delay_hist=list(delay_hist),
        hist_source=hist_source,
        tau_stats=tau_stats,
        gamma_stats=gamma_stats,
        clipped=analysis.clipped_summary(raw.clipped),
        policies=sorted({c.policy_name for c in grid.cells}),
        timings=list(timings),
        faults=summarize_faults(getattr(raw, "faults", None)) or None,
    )


def run(spec: ExperimentSpec, resume=None) -> Results:
    """The single entry point: resolve the spec, dispatch to the runner for
    (solver, backend), return the unified ``Results`` table.

    Runs on ``spec.execution.device``: the CUDA card unless the spec names
    ``"cpu"``; with no card and no device named it raises.  Under the
    default ``engine='fused'`` every event of the run is one launch of a
    hand-written kernel on the card (per bucket, for the batched
    backend).  Every run builds a ``telemetry.RunRecord`` on
    ``Results.telemetry``: the timing buffer is drained around the
    dispatch, so its compile-side events are this run's, and the program
    cache's counters are read before and after it.

    ``resume`` names a checkpoint directory: buckets (batched) or cells
    (solo) finished by an earlier -- possibly killed -- run of the SAME
    spec are loaded from disk instead of recomputed, and fresh ones are
    saved there as they complete.  Files are fingerprint-stamped; resuming
    a different spec into the same directory raises."""
    r = resolve(spec)
    ckpt = None
    if resume is not None:
        ckpt = SweepCheckpoint(
            resume, spec_fingerprint(spec, r.grid),
            tag=f"{spec.solver.name}_{spec.execution.backend}",
            device=r.device)
    drain_timings()  # drop events from unrelated earlier activity
    cache_before = program_cache_stats()
    t0 = time.perf_counter()
    raw = _SOLVER_DISPATCH[spec.solver.name](r, ckpt)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    elapsed = time.perf_counter() - t0
    record = _build_record(
        spec, r, raw, elapsed,
        cache_delta(cache_before, program_cache_stats()), drain_timings())
    append_record(record)
    return Results(solver=spec.solver.name, backend=spec.execution.backend,
                   grid=r.grid, raw=raw, elapsed_s=elapsed,
                   tau_bar=r.tau_bar, spec=spec, horizon=r.horizon,
                   record_every=spec.execution.record_every,
                   telemetry=record, cache_stats=record.cache)


# -------------------------------------------------- component escape ----

def component_spec(solver: str, backend: str, *, problem, grid, prox,
                   reference: bool = False, record_every: int = 1,
                   telemetry: bool = False, telemetry_bins: int = 64,
                   engine: str = "fused", device=None, faults=None,
                   **solver_kwargs) -> ExperimentSpec:
    """A spec from prebuilt components (problem + grid + prox), bypassing
    the declarative build; horizon validation and tau-bar measurement are
    off, as in the reference.  ``device`` defaults to the problem's."""
    from .spec import DelaySpec
    if device is None:
        device = str(problem.A.device)
    return ExperimentSpec(
        problem=ProblemSpec(kind="custom", problem=problem, prox_op=prox),
        solver=SolverSpec(name=solver, **solver_kwargs),
        execution=ExecutionSpec(backend=backend, reference=reference,
                                record_every=record_every,
                                telemetry=telemetry,
                                telemetry_bins=telemetry_bins, engine=engine,
                                device=device),
        delay=DelaySpec(measure=False),
        n_events=grid.n_events,
        grid=grid,
        validate_horizon=False,
        faults=faults,
    )


def run_components(solver: str, backend: str, *, problem, grid, prox,
                   reference: bool = False, record_every: int = 1,
                   telemetry: bool = False, telemetry_bins: int = 64,
                   engine: str = "fused", device=None, faults=None,
                   resume=None, **solver_kwargs) -> Results:
    """``run`` over prebuilt components (see ``component_spec``)."""
    return run(component_spec(solver, backend, problem=problem, grid=grid,
                              prox=prox, reference=reference,
                              record_every=record_every, telemetry=telemetry,
                              telemetry_bins=telemetry_bins, engine=engine,
                              device=device, faults=faults,
                              **solver_kwargs),
               resume=resume)
