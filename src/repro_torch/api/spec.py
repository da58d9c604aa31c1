"""The declarative experiment-spec family (counterpart of `repro.api.spec`).

Every experiment in this repo has one shape -- (problem, solver, delay
model / topology, step-size policy grid) -> convergence traces.  The spec
family expresses the WHOLE experiment as data:

* ``ProblemSpec``    -- which convex problem (or a prebuilt one) + prox.
* ``SolverSpec``     -- piag | bcd | fedasync | fedbuff + solver knobs.
* ``TopologySpec``   -- worker/client population regimes x worker counts.
* ``DelaySpec``      -- how delays are measured (tau vs tau_max) and the
                        delay model's expected maximum (horizon validation).
* ``PolicyGridSpec`` -- the step-size policy x seed axes of the grid.
* ``ExecutionSpec``  -- backend = solo | batched | sharded + device knobs.
* ``ExperimentSpec`` -- the product; ``repro_torch.api.run(spec)`` routes it
                        to the solo or batched runner and returns a unified
                        ``Results`` table.

The classes and fields are the reference's, so a spec reads the same in
both packages.  The port changes one default and adds one field, both on
``ExecutionSpec``: ``engine`` defaults to ``"fused"`` (the hand-written
kernel on the card) and ``device`` names where the run happens (``None``
= the CUDA card).  The spec layer only routes; it never re-implements
numerics.

Specs are plain frozen dataclasses: hashable-free config containers that
compare by value and ``dataclasses.replace`` cleanly (sweep one axis by
replacing one field).  Build-time validation catches horizon misconfigs
early: a declared ``DelaySpec.expected_max_delay`` that the solver horizon
cannot represent (the ``window_sum`` H - 1 cap) raises at CONSTRUCTION,
and a measured delay bound that exceeds it raises at resolve time --
instead of relying on the post-hoc per-row ``clipped`` counter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple, Union

__all__ = ["ProblemSpec", "SolverSpec", "TopologySpec", "DelaySpec",
           "PolicyGridSpec", "ExecutionSpec", "ExperimentSpec",
           "SOLVERS", "BACKENDS", "FIXED_FAMILY", "SPEC_FAMILY"]

SOLVERS = ("piag", "bcd", "fedasync", "fedbuff")
BACKENDS = ("solo", "batched", "sharded")

# policy names whose constructor takes the worst-case delay bound; the grid
# resolver injects the measured (or declared) tau-bar for these
FIXED_FAMILY = ("fixed", "sun_deng", "davis")


def _freeze(seq) -> Tuple:
    return tuple(seq) if seq is not None else None


def check_horizon(horizon, expected_max_delay: Optional[int]) -> None:
    """The one home of the horizon-representability rule: ``window_sum``
    caps delays at H - 1, so an expected max delay beyond that silently
    truncates window sums.  Shared by spec construction (declared bounds)
    and resolve (measured tau-bar).  ``horizon='auto'`` is exempt: the
    resolver sizes it FROM the measured/declared bound, so it represents
    every expected delay by construction."""
    if horizon == "auto":
        return
    exp = expected_max_delay
    if exp is not None and exp > horizon - 1:
        raise ValueError(
            f"horizon {horizon} cannot represent the delay model's "
            f"expected max delay {exp}: window sums clip at H - 1 = "
            f"{horizon - 1} (core.stepsize.window_sum); raise "
            f"SolverSpec.horizon to at least {exp + 1} or declare a "
            "smaller DelaySpec.expected_max_delay")


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Which problem the experiment optimizes, plus its prox operator.

    ``kind``:   ``"logreg"`` | ``"lasso"`` (built via ``core.problems.make_*``
                with ``params`` forwarded and ``n_workers`` taken from the
                topology's widest cell) or ``"custom"`` (use ``problem``).
    ``params``: forwarded verbatim to ``make_logreg`` / ``make_lasso``.
    ``prox``:   name from ``core.prox.PROX_OPS``; ``prox_params`` forwarded.
                Default ``"l1"`` with ``lam = problem.lam1``.
    ``problem`` / ``prox_op``: prebuilt objects (the component escape hatch
                the legacy shims use); they bypass the declarative build.
    """

    kind: str = "logreg"
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    prox: str = "l1"
    prox_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    problem: Any = None
    prox_op: Any = None

    def __post_init__(self):
        if self.problem is None and self.kind not in ("logreg", "lasso"):
            raise ValueError(
                f"unknown problem kind {self.kind!r} (logreg | lasso | "
                "pass a prebuilt `problem`)")


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Which solver consumes the event trace, and its knobs.

    ``m`` is the Async-BCD block count; ``eta`` / ``buffer_size`` are the
    FedBuff server rate and |R| (FedAsync forces ``buffer_size = 1``);
    ``local_lr`` is the federated clients' local prox-SGD rate (``None`` ->
    ``0.9 / L``); ``n_steps`` is the federated trace-scan pop budget
    (``None`` -> ``default_fed_steps``).  ``horizon`` is the step-size
    window-sum horizon H -- the largest representable delay is H - 1 --
    or ``'auto'``: size H to ``next_pow2(measured tau-bar + slack)`` at
    resolve time (``DelaySpec.horizon_slack``), bitwise-identical to the
    4096 default whenever delays fit, at a fraction of the scan carry.
    """

    name: str = "piag"
    horizon: Union[int, str] = 4096
    m: int = 20
    eta: float = 1.0
    buffer_size: int = 1
    local_lr: Optional[float] = None
    n_steps: Optional[int] = None

    def __post_init__(self):
        if self.name not in SOLVERS:
            raise ValueError(f"unknown solver {self.name!r}; one of {SOLVERS}")
        if isinstance(self.horizon, str):
            if self.horizon != "auto":
                raise ValueError(
                    f"horizon must be an int >= 2 or 'auto', "
                    f"got {self.horizon!r}")
        elif self.horizon < 2:
            raise ValueError(f"horizon must be >= 2, got {self.horizon}")
        if self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")

    @property
    def federated(self) -> bool:
        return self.name in ("fedasync", "fedbuff")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The worker/client population axis of the grid.

    ``kind``:      ``"standard"`` -- the four worker regimes of
                   ``sweep.standard_topology_factories`` (PIAG/BCD);
                   ``"edge"``     -- heterogeneous federated clients
                   (``federated.heterogeneous_clients`` with ``params``;
                   ``params`` may pin its own ``seed``);
                   ``"custom"``   -- use ``topologies`` directly.
    ``names``:     optional subset of the regime names.
    ``n_workers``: worker counts; more than one grows the ragged
                   worker-count axis (bucketed sweeps).  ``None`` is only
                   valid for ``custom`` topologies given as concrete worker
                   lists.
    ``topologies``: custom mapping name -> width factory (or concrete list
                   when ``n_workers`` is None).
    """

    kind: str = "standard"
    names: Optional[Tuple[str, ...]] = None
    n_workers: Optional[Tuple[int, ...]] = (8,)
    seed: int = 0
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    topologies: Optional[Mapping[str, Any]] = None

    def __post_init__(self):
        if self.kind not in ("standard", "edge", "custom"):
            raise ValueError(f"unknown topology kind {self.kind!r}")
        if self.kind == "custom" and self.topologies is None:
            raise ValueError("custom topology needs `topologies`")
        object.__setattr__(self, "names", _freeze(self.names))
        object.__setattr__(self, "n_workers", _freeze(self.n_workers))
        if self.n_workers is not None and not self.n_workers:
            raise ValueError("n_workers must be non-empty or None")
        if self.n_workers is None:
            bad = [] if self.topologies is None else \
                [n for n, v in self.topologies.items() if callable(v)]
            if self.kind != "custom" or bad:
                raise ValueError(
                    "n_workers=None needs custom topologies given as "
                    "concrete worker lists" +
                    (f" (factories: {bad})" if bad else ""))

    @property
    def width_max(self) -> int:
        if self.n_workers is not None:
            return max(int(w) for w in self.n_workers)
        widths = {len(ws) for ws in self.topologies.values()}
        return max(widths)


@dataclasses.dataclass(frozen=True)
class DelaySpec:
    """How delays are measured and what the delay model is expected to do.

    ``use_tau_max``:       PIAG feeds the table-wide max staleness (the
                           paper's tau_k) when True, the returning worker's
                           own staleness when False.
    ``expected_max_delay``: a declared bound on the delay model's maximum
                           delay.  If set, spec CONSTRUCTION fails when the
                           solver horizon cannot represent it (H - 1 cap).
    ``measure``:           when no bound is declared, measure tau-bar from
                           the grid's own traces at resolve time (PIAG/BCD)
                           and validate the horizon against it.
    ``horizon_slack``:     headroom (>= 1) added to the measured/declared
                           bound when ``SolverSpec.horizon='auto'`` sizes
                           the window buffer (``stepsize.auto_horizon``).
    """

    use_tau_max: bool = True
    expected_max_delay: Optional[int] = None
    measure: bool = True
    horizon_slack: int = 1

    def __post_init__(self):
        if self.horizon_slack < 1:
            raise ValueError(
                f"horizon_slack must be >= 1, got {self.horizon_slack}")


@dataclasses.dataclass(frozen=True)
class PolicyGridSpec:
    """The step-size policy x seed axes.

    ``names``:        policy names from ``core.stepsize.POLICIES``; the
                      fixed family (``fixed`` / ``sun_deng`` / ``davis``)
                      gets ``tau_bound`` injected (measured tau-bar when
                      ``tau_bound`` is None -- the paper's tuning protocol).
    ``gamma_prime``:  gamma' = h/L.  ``None`` -> auto: ``0.99 / L`` (PIAG),
                      ``0.99 / block_smoothness(m)`` (BCD), ``0.6`` (the
                      federated base mixing weight).
    ``policy_kwargs``: per-name extra constructor kwargs.
    ``policies``:     escape hatch: concrete name -> ``StepsizePolicy``.
    """

    names: Tuple[str, ...] = ("adaptive1", "adaptive2", "fixed")
    seeds: Tuple[int, ...] = (0, 1, 2, 3)
    gamma_prime: Optional[float] = None
    tau_bound: Optional[int] = None
    policy_kwargs: Mapping[str, Mapping[str, Any]] = dataclasses.field(
        default_factory=dict)
    policies: Optional[Mapping[str, Any]] = None

    def __post_init__(self):
        object.__setattr__(self, "names", _freeze(self.names))
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        if not self.seeds:
            raise ValueError("need at least one seed")


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """Where and how the grid executes.

    ``backend``: ``"solo"``    -- one run per cell (the per-cell path);
                 ``"batched"`` -- one batched pass per bucket
                 (``sweep.runners``);
                 ``"sharded"`` -- the cell axis across devices (not ported
                 yet, ROADMAP queue A item 12).
    ``devices`` / ``mesh`` / ``mesh_shape`` / ``coordinator`` /
                 ``num_processes`` / ``process_id``: sharded-backend knobs,
                 kept so specs read as in the reference.
    ``bucket_widths``: explicit ragged-bucket width menu (None = pow-2).
    ``reference``: federated batched sweeps only: take the events from
                 the heapq twin (``simulate_federated`` on the same
                 pre-sampled rounds) instead of the device race; bitwise
                 the same events.
    ``record_every``: decimated trace recording -- materialize (and compute
                 the objective for) only every s-th event row; rows
                 ``s-1, 2s-1, ...`` of the stride-1 run.  Must divide
                 ``n_events``.
    ``telemetry`` / ``telemetry_bins``: the in-loop delay accumulators
                 (``repro_torch.telemetry``) and their histogram width.
    ``engine``:  per-event inner loop.  ``"fused"`` (the PORT's default)
                 runs the policy update (window sum / select / push) and
                 the solver update (PIAG's prox step, the FedAsync mix, the
                 FedBuff buffer step) as ONE launch of a hand-written CUDA
                 kernel per event for all cells (``kernels.fused_step``);
                 ``"scan"`` runs them as composed torch ops, the counterpart
                 of the reference's default scan engine.  On the CPU both
                 run plain PyTorch.  ``AdaptiveLipschitz`` is refused under
                 ``"fused"``.
    ``device``:  port-only: where the run happens.  ``None`` means the CUDA
                 card and raises when there is none; ``"cpu"`` is the only
                 way onto the CPU (``kernels.dispatch``).
    """

    backend: str = "batched"
    devices: Optional[int] = None
    mesh: Any = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    coordinator: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    bucket_widths: Optional[Tuple[int, ...]] = None
    reference: bool = False
    record_every: int = 1
    telemetry: bool = False
    telemetry_bins: int = 64
    engine: str = "fused"
    device: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.engine not in ("scan", "fused"):
            raise ValueError(
                f"engine must be 'scan' or 'fused', got {self.engine!r}")
        if self.record_every < 1:
            raise ValueError(
                f"record_every must be >= 1, got {self.record_every}")
        if self.telemetry_bins < 2:
            raise ValueError(
                f"telemetry_bins must be >= 2, got {self.telemetry_bins}")
        if self.mesh_shape is not None:
            if self.mesh is not None:
                raise ValueError(
                    "mesh and mesh_shape are mutually exclusive: a prebuilt "
                    "mesh already fixes the topology")
            shape = tuple(int(s) for s in self.mesh_shape)
            if not 1 <= len(shape) <= 2 or any(s < 1 for s in shape):
                raise ValueError(
                    f"mesh_shape must be (cells,) or (cells, data) with "
                    f"positive entries, got {self.mesh_shape!r}")
            object.__setattr__(self, "mesh_shape", shape)
            if self.backend != "sharded":
                raise ValueError(
                    f"mesh_shape requires backend='sharded', got "
                    f"{self.backend!r}")
        if self.num_processes < 1:
            raise ValueError(
                f"num_processes must be >= 1, got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id must be in [0, num_processes), got "
                f"{self.process_id} with num_processes={self.num_processes}")
        if self.coordinator is not None and self.backend != "sharded":
            raise ValueError(
                "coordinator (multi-host init) requires backend='sharded'")
        object.__setattr__(self, "bucket_widths", _freeze(self.bucket_widths))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One declarative experiment: the product of the five axes above.

    ``n_events`` is the trace length K (write events for PIAG/BCD, uploads
    for the federated servers).  ``grid`` is a component escape hatch: a
    prebuilt ``sweep.SweepGrid`` bypasses the declarative topology/policy
    build entirely (used by the legacy shims).  ``validate_horizon``
    controls resolve-time horizon validation (see ``DelaySpec``).

    ``faults`` (a ``faults.FaultSpec``, or None) injects deterministic
    fault processes -- crash/rejoin chains and straggler spikes into the
    delay traces, drop/duplicate/corrupt codes into the server updates --
    and arms the in-loop guards (NaN/Inf rejection, staleness cutoff,
    horizon-overflow degradation).  ``faults=None`` (or a disabled spec)
    runs the fault-free step bodies on every solver and backend; a set
    spec rides every sweep-program cache key.  The fused engine (the
    port's default) refuses faults, as the reference does: a spec with
    faults sets ``engine='scan'``.
    """

    problem: ProblemSpec = dataclasses.field(default_factory=ProblemSpec)
    solver: SolverSpec = dataclasses.field(default_factory=SolverSpec)
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    policies: PolicyGridSpec = dataclasses.field(
        default_factory=PolicyGridSpec)
    delay: DelaySpec = dataclasses.field(default_factory=DelaySpec)
    execution: ExecutionSpec = dataclasses.field(default_factory=ExecutionSpec)
    n_events: int = 1000
    grid: Any = None
    validate_horizon: bool = True
    faults: Any = None

    def __post_init__(self):
        if self.n_events < 1:
            raise ValueError("n_events must be >= 1")
        if self.solver.federated and self.execution.reference \
                and self.execution.backend == "sharded":
            raise ValueError(
                "reference=True (heapq twin) cannot shard; use backend="
                "'batched'")
        if self.n_events % self.execution.record_every:
            raise ValueError(
                f"record_every={self.execution.record_every} must divide "
                f"n_events={self.n_events}")
        check_horizon(self.solver.horizon, self.delay.expected_max_delay)
        if self.faults is not None:
            from ..faults.spec import normalize_faults
            object.__setattr__(self, "faults", normalize_faults(self.faults))
        if self.faults is not None:
            if self.execution.engine == "fused":
                raise ValueError(
                    "engine='fused' does not support fault injection; use "
                    "engine='scan'")
            if self.execution.reference:
                raise ValueError(
                    "reference=True (heapq twin) does not support fault "
                    "injection; use the fused federated trace path")

    def validate(self) -> "ExperimentSpec":
        """Resolve problem + grid and run the horizon validation without
        executing anything; returns self for chaining."""
        from .run import resolve
        resolve(self)
        return self

    def replace(self, **kwargs) -> "ExperimentSpec":
        return dataclasses.replace(self, **kwargs)


SPEC_FAMILY = (ExperimentSpec, ProblemSpec, SolverSpec, TopologySpec,
               DelaySpec, PolicyGridSpec, ExecutionSpec)
