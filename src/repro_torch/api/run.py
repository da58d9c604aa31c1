"""Route an ``ExperimentSpec`` to the port's runners (counterpart of
``repro.api.run``).

``resolve(spec)`` materializes the declarative axes -- problem, prox,
policies (with the paper's tau-bar tuning protocol for the fixed family),
topology factories, the ``SweepGrid`` -- on the spec's device and performs
the build-time horizon validation.  ``run(spec)`` then dispatches:

=========  ==========================  ===========================
solver     solo                        batched
=========  ==========================  ===========================
piag       ``core.piag.run_piag``      ``sweep.runners.sweep_piag``
=========  ==========================  ===========================

What is not ported yet raises ``NotImplementedError`` naming its ROADMAP
queue A item: the BCD and federated solvers, the sharded backend, faults,
telemetry and checkpointed resume.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import torch

from ..core.engine import generate_trace, sample_service_times
from ..core.piag import run_piag
from ..core.problems import make_lasso, make_logreg
from ..core.prox import make_prox
from ..core.stepsize import make_policy
from ..kernels.dispatch import resolve_device
from ..sweep.grid import (SweepGrid, make_grid, measure_tau_bar,
                          standard_topology_factories)
from ..sweep.runners import resolve_grid_horizon, sweep_piag
from .results import Results
from .spec import (FIXED_FAMILY, ExecutionSpec, ExperimentSpec, ProblemSpec,
                   SolverSpec, check_horizon)

__all__ = ["Resolved", "resolve", "run", "run_components", "component_spec"]

# resolve-time memo: repeated runs of value-equal problem specs on one
# device reuse the same problem (the 60 000-sample build and its power
# iterations cost seconds); bounded, oldest evicted first
_PROBLEM_MEMO: dict = {}
_PROBLEM_MEMO_SIZE = 4


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
    if key not in _PROBLEM_MEMO:
        if len(_PROBLEM_MEMO) >= _PROBLEM_MEMO_SIZE:
            _PROBLEM_MEMO.pop(next(iter(_PROBLEM_MEMO)))
        _PROBLEM_MEMO[key] = maker(device=device, **kwargs)
    return _PROBLEM_MEMO[key]


def _build_prox(spec: ExperimentSpec, problem):
    ps = spec.problem
    if ps.prox_op is not None:
        return ps.prox_op
    kwargs = dict(ps.prox_params)
    if ps.prox == "l1":
        kwargs.setdefault("lam", problem.lam1)
    return make_prox(ps.prox, **kwargs)


def _build_topologies(spec: ExperimentSpec):
    ts = spec.topology
    if ts.kind == "custom":
        topos = dict(ts.topologies)
    elif ts.kind == "edge":
        raise _not_ported("the federated 'edge' topology", 8)
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


def _build_policies(spec: ExperimentSpec, problem, tau_bar: Optional[int]):
    pg = spec.policies
    if pg.policies is not None:
        return dict(pg.policies)
    gp = pg.gamma_prime if pg.gamma_prime is not None \
        else 0.99 / problem.L
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


def _check_ported(spec: ExperimentSpec, resume=None) -> None:
    """Refuse, before any work, what the port cannot run yet."""
    sv, ex = spec.solver, spec.execution
    if sv.name == "bcd":
        raise _not_ported("solver='bcd' (Async-BCD)", 5)
    if sv.federated:
        raise _not_ported(f"solver={sv.name!r} (federated)", 8)
    if ex.backend == "sharded":
        raise _not_ported("backend='sharded'", 12)
    if spec.faults is not None:
        raise _not_ported("fault injection (faults=...)", 10)
    if ex.telemetry:
        raise _not_ported("telemetry=True", 9)
    if resume is not None:
        raise _not_ported("checkpointed resume (resume=...)", 11)


def resolve(spec: ExperimentSpec) -> Resolved:
    """Materialize problem, prox, policies and grid on the spec's device
    (``ExecutionSpec.device``; None = the CUDA card, raising when there is
    none); validate the horizon."""
    _check_ported(spec)
    device = resolve_device(spec.execution.device)
    problem = _build_problem(spec, device)
    prox = _build_prox(spec, problem)
    slack = spec.delay.horizon_slack

    if spec.grid is not None:
        if spec.validate_horizon:
            _validate_horizon(spec, None)
        horizon = resolve_grid_horizon(
            spec.solver.horizon, spec.grid, slack=slack,
            bound=spec.delay.expected_max_delay, device=device)
        return Resolved(spec, problem, prox, spec.grid, None, horizon, device)

    topos = _build_topologies(spec)
    pg = spec.policies
    needs_bound = (pg.policies is None and pg.tau_bound is None
                   and any(n in FIXED_FAMILY for n in pg.names))
    auto = spec.solver.horizon == "auto"
    needs_measure = (
        (needs_bound and spec.delay.measure)
        or (spec.validate_horizon and spec.delay.measure
            and spec.delay.expected_max_delay is None)
        or (auto and spec.delay.expected_max_delay is None))
    tau_bar = _measure_tau_bar(spec, topos, device) if needs_measure else None
    if needs_bound and tau_bar is None:
        raise ValueError(
            "fixed-family policies need tau_bound (or DelaySpec.measure)")

    policies = _build_policies(spec, problem, tau_bar)
    grid = make_grid(policies, list(pg.seeds), topos, spec.n_events,
                     n_workers=(list(spec.topology.n_workers)
                                if spec.topology.n_workers is not None
                                else None))
    if spec.validate_horizon:
        _validate_horizon(spec, tau_bar)
    bound = spec.delay.expected_max_delay
    horizon = resolve_grid_horizon(
        spec.solver.horizon, grid, slack=slack,
        bound=tau_bar if bound is None else bound, device=device)
    return Resolved(spec, problem, prox, grid, tau_bar, horizon, device)


# ------------------------------------------------------------- dispatch ----

def _piag_pieces(problem, device):
    """(loss, x0, worker_data, objective, grad_fn) for PIAG; problems with
    a closed-form batched gradient (``worker_grads``) use it."""
    Aw, bw = problem.worker_slices()
    x0 = torch.zeros((problem.dim,), dtype=torch.float32, device=device)
    grad_fn = problem.worker_grads() if hasattr(problem, "worker_grads") \
        else None
    return problem.worker_loss, x0, (Aw, bw), problem.P, grad_fn


def _run_piag(r: Resolved):
    spec = r.spec
    loss, x0, wd, objective, grad_fn = _piag_pieces(r.problem, r.device)
    h, utm = r.horizon, spec.delay.use_tau_max
    s = spec.execution.record_every
    eng = spec.execution.engine
    if spec.execution.backend == "batched":
        return sweep_piag(loss, x0, wd, r.grid, r.prox, objective=objective,
                          horizon=h, use_tau_max=utm,
                          bucket_widths=spec.execution.bucket_widths,
                          record_every=s, engine=eng, grad_fn=grad_fn)

    rows = []
    for c in r.grid.cells:
        T = sample_service_times(c.workers, r.grid.n_events + 1, seed=c.seed)
        tr = generate_trace(T, device=r.device)
        rows.append(run_piag(loss, x0, tuple(leaf[:c.n_workers] for leaf in wd),
                             tr, c.policy, r.prox, objective=objective,
                             horizon=h, use_tau_max=utm, record_every=s,
                             engine=eng, grad_fn=grad_fn))
    return type(rows[0])(*(
        torch.stack(leaves) if isinstance(leaves[0], torch.Tensor)
        else leaves[0] for leaves in zip(*rows)))


def run(spec: ExperimentSpec, resume=None) -> Results:
    """The single entry point: resolve the spec, dispatch to the runner for
    (solver, backend), return the unified ``Results`` table.

    Runs on ``spec.execution.device``: the CUDA card unless the spec names
    ``"cpu"``; with no card and no device named it raises.  Under the
    default ``engine='fused'`` every event of the run is one launch of the
    hand-written kernel on the card."""
    _check_ported(spec, resume)
    r = resolve(spec)
    t0 = time.perf_counter()
    raw = _run_piag(r)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    elapsed = time.perf_counter() - t0
    return Results(solver=spec.solver.name, backend=spec.execution.backend,
                   grid=r.grid, raw=raw, elapsed_s=elapsed,
                   tau_bar=r.tau_bar, spec=spec, horizon=r.horizon,
                   record_every=spec.execution.record_every)


# -------------------------------------------------- component escape ----

def component_spec(solver: str, backend: str, *, problem, grid, prox,
                   record_every: int = 1, engine: str = "fused",
                   device=None, **solver_kwargs) -> ExperimentSpec:
    """A spec from prebuilt components (problem + grid + prox), bypassing
    the declarative build; horizon validation and tau-bar measurement are
    off, as in the reference.  ``device`` defaults to the problem's."""
    from .spec import DelaySpec
    if device is None:
        device = str(problem.A.device)
    return ExperimentSpec(
        problem=ProblemSpec(kind="custom", problem=problem, prox_op=prox),
        solver=SolverSpec(name=solver, **solver_kwargs),
        execution=ExecutionSpec(backend=backend, record_every=record_every,
                                engine=engine, device=device),
        delay=DelaySpec(measure=False),
        n_events=grid.n_events,
        grid=grid,
        validate_horizon=False,
    )


def run_components(solver: str, backend: str, *, problem, grid, prox,
                   record_every: int = 1, engine: str = "fused",
                   device=None, **solver_kwargs) -> Results:
    """``run`` over prebuilt components (see ``component_spec``)."""
    return run(component_spec(solver, backend, problem=problem, grid=grid,
                              prox=prox, record_every=record_every,
                              engine=engine, device=device, **solver_kwargs))
