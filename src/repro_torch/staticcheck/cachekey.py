"""Cache-key completeness checking for the sweep-program cache (the port's
counterpart of ``repro.staticcheck.cachekey``).

The stale-program bug class: a spec knob that changes what a sweep
program runs but does NOT ride the ``sweep.cache`` key makes
``cached_program`` serve a program built for a different configuration.
This module closes the class mechanically, as the reference does, with
the op trace (``staticcheck.optrace``) in place of the jaxpr:

* :func:`capture` runs ``api.run(spec)`` with a ``sweep.cache`` capture
  hook installed -- the hook builds the program the cache would have
  built, records the op trace of its first call, and aborts with the
  ``(cache key, op trace, input shapes)`` triple (nothing is cached).
* :func:`check_completeness` perturbs every registered spec knob one at
  a time against a tiny base spec and classifies the effect.  The
  violation predicate is the reference's: a perturbation is a stale-reuse
  hazard iff it leaves the cache key AND the input shapes unchanged while
  changing the op trace.
* the registry is a FORCING FUNCTION: every field of every class in
  ``api.spec.SPEC_FAMILY`` (the port-only ``ExecutionSpec.device``
  included), plus ``FaultSpec`` and ``TelemetryConfig``, carries either a
  perturbation or an explicit skip-with-reason; an unregistered field
  fails the check.
* :func:`check_retrace_budget` captures a representative spec matrix and
  gates the number of distinct ``cached_program`` builds (and asserts
  value-equal specs reuse one key).

Every check runs on one device (``device=None``: the card; ``"cpu"``
only when asked).  CLI: ``python -m repro_torch.staticcheck.cachekey
[--device cpu]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api.run import run
from ..api.spec import (SPEC_FAMILY, DelaySpec, ExecutionSpec,
                        ExperimentSpec, PolicyGridSpec, ProblemSpec,
                        SolverSpec, TopologySpec)
from ..faults.spec import FaultSpec
from ..sweep import cache as _cache
from ..telemetry.accumulators import TelemetryConfig
from . import optrace as _optrace

__all__ = ["ProgramCapture", "Captured", "capture", "base_spec", "BASES",
           "REGISTRY", "Perturb", "Skip", "Outcome", "check_completeness",
           "check_retrace_budget", "strip_faults_from_key",
           "unregistered_fields", "RETRACE_BUDGET", "REPRESENTATIVE",
           "main"]


# ------------------------------------------------------------- capture ----

class ProgramCapture(Exception):
    """Abort signal carrying one intercepted ``cached_program`` dispatch."""

    def __init__(self, key, trace):
        self.key = key
        self.trace = trace
        super().__init__("cached_program dispatch captured")


@dataclasses.dataclass(frozen=True)
class Captured:
    """What one dispatch looked like: the cache key, the program's input
    and output shapes, the op trace's fingerprint (lines kept for diffs)
    and the kernel launches of its first call."""

    key: Any
    in_shapes: Tuple[str, ...]
    out_shapes: Tuple[str, ...]
    fingerprint: str
    lines: Tuple[str, ...]
    launches: Dict[str, int]

    def trace_equal(self, other: "Captured") -> bool:
        return self.fingerprint == other.fingerprint


def capture(spec: ExperimentSpec,
            key_filter: Optional[Callable[[tuple], tuple]] = None
            ) -> Optional[Captured]:
    """Record the first sweep program ``api.run(spec)`` would dispatch.

    Returns ``None`` when the run never consults ``cached_program`` (solo
    backend, federated ``reference=True``) -- those paths build fresh per
    call, so they cannot serve a stale program; the run then executes for
    real (keep such specs tiny).

    ``key_filter`` post-processes the observed cache key before it is
    recorded -- the seam the seeded-mutation self-test uses to simulate
    "someone removed knob X from the key".
    """

    def hook(key, build):
        fn = build()

        def recorder(*args, **kwargs):
            _, trace = _optrace.record(fn, *args, **kwargs)
            raise ProgramCapture(
                key if key_filter is None else key_filter(key), trace)

        return recorder

    prev = _cache.set_capture_hook(hook)
    try:
        try:
            run(spec)
        except ProgramCapture as pc:
            t = pc.trace
            return Captured(key=pc.key, in_shapes=t.in_shapes,
                            out_shapes=t.out_shapes,
                            fingerprint=_optrace.fingerprint(t),
                            lines=t.lines, launches=dict(t.launches))
        return None
    finally:
        _cache.set_capture_hook(prev)


def strip_faults_from_key(key: tuple) -> tuple:
    """A seeded mutation: drop the ``FaultSpec`` element from a cache key,
    simulating a runner that forgot to thread ``faults`` through -- under
    this filter :func:`check_completeness` MUST report violations."""
    return tuple(el for el in key if not isinstance(el, FaultSpec))


# ---------------------------------------------------------- base specs ----

_TINY_PROBLEM = dict(n_samples=48, dim=6, seed=0)


def base_spec(solver: str = "piag", device: Optional[str] = None,
              engine: str = "fused", **over) -> ExperimentSpec:
    """The reference's deliberately tiny spec -- 3 workers, 6 dims, 12
    events, horizon 32 -- on ``device`` under ``engine`` (the port's
    default, the fused kernels)."""
    fed = solver in ("fedasync", "fedbuff")
    fields: Dict[str, Any] = dict(
        problem=ProblemSpec(kind="logreg", params=dict(_TINY_PROBLEM)),
        solver=SolverSpec(name=solver, horizon=32, m=3),
        topology=TopologySpec(kind="edge" if fed else "standard",
                              names=None if fed else ("uniform",),
                              n_workers=(3,)),
        policies=PolicyGridSpec(names=("adaptive1",), seeds=(0,)),
        delay=DelaySpec(measure=False),
        execution=ExecutionSpec(backend="batched", engine=engine,
                                device=device),
        n_events=12,
        validate_horizon=False,
    )
    fields.update(over)
    return ExperimentSpec(**fields)


_FAULTED = FaultSpec(p_crash=0.05, p_spike=0.1, p_drop=0.1, p_dup=0.05,
                     p_corrupt=0.05, seed=0)


def _with_execution(device, **ex) -> ExecutionSpec:
    return ExecutionSpec(**{"backend": "batched", "device": device, **ex})


# named bases so registry entries (and reports) reference them by string;
# each takes the device.  Faults need the scan engine (the fused kernels
# refuse them, as the reference's fused engine does).
BASES: Dict[str, Callable[[Optional[str]], ExperimentSpec]] = {
    "piag": lambda dev: base_spec("piag", dev),
    "bcd": lambda dev: base_spec("bcd", dev),
    "fedasync": lambda dev: base_spec("fedasync", dev),
    "fedbuff": lambda dev: base_spec("fedbuff", dev),
    "piag/faulted": lambda dev: base_spec("piag", dev, engine="scan",
                                          faults=_FAULTED),
    "piag/telemetry": lambda dev: base_spec(
        "piag", dev, execution=_with_execution(dev, telemetry=True)),
    "piag/sharded": lambda dev: base_spec(
        "piag", dev, execution=_with_execution(dev, backend="sharded")),
}


# ------------------------------------------------------------ registry ----

@dataclasses.dataclass(frozen=True)
class Perturb:
    """One knob perturbation: run ``apply(BASES[base](device))`` and
    compare the captured (key, shapes, op trace) against the base's."""

    base: str
    apply: Callable[[ExperimentSpec], ExperimentSpec]


@dataclasses.dataclass(frozen=True)
class Skip:
    """Explicit opt-out; the reason is part of the report (and the point:
    a skip must argue why the knob cannot cause stale reuse)."""

    reason: str


def _re(spec: ExperimentSpec, **kw) -> ExperimentSpec:
    return spec.replace(**kw)


def _sub(attr: str):
    def inner(spec: ExperimentSpec, **kw) -> ExperimentSpec:
        return spec.replace(
            **{attr: dataclasses.replace(getattr(spec, attr), **kw)})
    return inner


_ex, _sv, _tp, _dl, _pg, _pb = (_sub("execution"), _sub("solver"),
                                _sub("topology"), _sub("delay"),
                                _sub("policies"), _sub("problem"))


def _fl(spec: ExperimentSpec, **kw) -> ExperimentSpec:
    return spec.replace(faults=dataclasses.replace(spec.faults, **kw))


_COMPOUND = Skip("compound spec object; its fields are enumerated "
                 "individually below")

REGISTRY: Dict[Tuple[str, str], Any] = {
    # ExperimentSpec ----------------------------------------------------
    ("ExperimentSpec", "problem"): _COMPOUND,
    ("ExperimentSpec", "solver"): _COMPOUND,
    ("ExperimentSpec", "topology"): _COMPOUND,
    ("ExperimentSpec", "policies"): _COMPOUND,
    ("ExperimentSpec", "delay"): _COMPOUND,
    ("ExperimentSpec", "execution"): _COMPOUND,
    ("ExperimentSpec", "faults"): Skip(
        "compound FaultSpec; fields enumerated individually (it rides "
        "every key by value -- frozen hashable dataclass)"),
    ("ExperimentSpec", "n_events"): Perturb(
        "piag", lambda s: _re(s, n_events=24)),
    ("ExperimentSpec", "grid"): Skip(
        "prebuilt-SweepGrid escape hatch: its service times / policy "
        "params are program INPUTS, and captured worker data is "
        "identity-keyed (IdKey) -- a different grid object never aliases "
        "a cached program's captures"),
    ("ExperimentSpec", "validate_horizon"): Skip(
        "resolve-time validation toggle; raises or passes before any "
        "program is built, never reaches the program"),
    # ProblemSpec -------------------------------------------------------
    ("ProblemSpec", "kind"): Perturb(
        "piag", lambda s: _pb(s, kind="lasso")),
    ("ProblemSpec", "params"): Perturb(
        "piag", lambda s: _pb(s, params=dict(_TINY_PROBLEM, seed=1))),
    ("ProblemSpec", "prox"): Perturb(
        "piag", lambda s: _pb(s, prox="l2", prox_params=dict(lam=0.01))),
    ("ProblemSpec", "prox_params"): Perturb(
        "piag", lambda s: _pb(s, prox_params=dict(lam=0.05))),
    ("ProblemSpec", "problem"): Skip(
        "prebuilt-object escape hatch; the object itself is captured and "
        "identity-keyed (IdKey) through the runner pieces"),
    ("ProblemSpec", "prox_op"): Skip(
        "prebuilt-object escape hatch; identity-keyed like `problem`"),
    # SolverSpec --------------------------------------------------------
    ("SolverSpec", "name"): Perturb(
        "piag", lambda s: _sv(s, name="bcd")),
    ("SolverSpec", "horizon"): Perturb(
        "piag", lambda s: _sv(s, horizon=64)),
    ("SolverSpec", "m"): Perturb(
        "bcd", lambda s: _sv(s, m=2)),
    ("SolverSpec", "eta"): Perturb(
        "fedbuff", lambda s: _sv(s, eta=0.5)),
    ("SolverSpec", "buffer_size"): Perturb(
        "fedbuff", lambda s: _sv(s, buffer_size=2)),
    ("SolverSpec", "local_lr"): Perturb(
        "fedbuff", lambda s: _sv(s, local_lr=0.05)),
    ("SolverSpec", "n_steps"): Perturb(
        "fedasync", lambda s: _sv(s, n_steps=40)),
    # TopologySpec ------------------------------------------------------
    ("TopologySpec", "kind"): Skip(
        "selects the worker/client factory family; reaches the program "
        "only through sampled service-time VALUES (program inputs) and the "
        "width axis, both covered by `names` / `n_workers`"),
    ("TopologySpec", "names"): Perturb(
        "piag", lambda s: _tp(s, names=("hetero2",))),
    ("TopologySpec", "n_workers"): Perturb(
        "piag", lambda s: _tp(s, n_workers=(4,))),
    ("TopologySpec", "seed"): Perturb(
        "piag", lambda s: _tp(s, seed=1)),
    ("TopologySpec", "params"): Skip(
        "forwarded to the topology factory; like `seed`, it only changes "
        "sampled service-time values (program inputs), never the program"),
    ("TopologySpec", "topologies"): Skip(
        "custom escape hatch (concrete worker lists / factories); "
        "service-time values only, as above"),
    # DelaySpec ---------------------------------------------------------
    ("DelaySpec", "use_tau_max"): Perturb(
        "piag", lambda s: _dl(s, use_tau_max=False)),
    ("DelaySpec", "expected_max_delay"): Perturb(
        "piag", lambda s: _dl(s, expected_max_delay=20)),
    ("DelaySpec", "measure"): Perturb(
        "piag", lambda s: _dl(s, measure=True)),
    ("DelaySpec", "horizon_slack"): Perturb(
        "piag", lambda s: _dl(s, horizon_slack=2)),
    # PolicyGridSpec ----------------------------------------------------
    ("PolicyGridSpec", "names"): Perturb(
        "piag", lambda s: _pg(s, names=("adaptive2",))),
    ("PolicyGridSpec", "seeds"): Perturb(
        "piag", lambda s: _pg(s, seeds=(0, 1))),
    ("PolicyGridSpec", "gamma_prime"): Perturb(
        "piag", lambda s: _pg(s, gamma_prime=0.5)),
    ("PolicyGridSpec", "tau_bound"): Perturb(
        "piag", lambda s: _pg(s, tau_bound=8)),
    ("PolicyGridSpec", "policy_kwargs"): Skip(
        "forwarded to policy constructors; lands in PolicyParams, which "
        "are program inputs (the fused select chain dispatches on a "
        "policy-id tensor, not on the program structure)"),
    ("PolicyGridSpec", "policies"): Skip(
        "prebuilt-StepsizePolicy escape hatch; params are program inputs "
        "as above"),
    # ExecutionSpec -----------------------------------------------------
    ("ExecutionSpec", "backend"): Perturb(
        "piag", lambda s: _ex(s, backend="solo")),
    ("ExecutionSpec", "devices"): Perturb(
        "piag/sharded", lambda s: _ex(s, backend="sharded", devices=1)),
    ("ExecutionSpec", "mesh"): Skip(
        "prebuilt-Mesh escape hatch; meshes ride the sharded cache keys by "
        "TOPOLOGY (repro_torch.mesh.mesh_topology: axis names + shape + "
        "device kind + process count) and each row's program by its "
        "devices, so any mesh with a different topology keys fresh while "
        "same-topology meshes deliberately share the program"),
    # a (1, 1) grid mesh works on one device: the data-parallel gradient
    # is a distinct program AND a distinct mesh_topology, so the key must
    # move
    ("ExecutionSpec", "mesh_shape"): Perturb(
        "piag/sharded", lambda s: _ex(s, backend="sharded",
                                      mesh_shape=(1, 1))),
    ("ExecutionSpec", "coordinator"): Skip(
        "multi-host bootstrap address, consumed ONCE by "
        "torch.distributed.init_process_group before the mesh is built; it "
        "never reaches a program, and the resulting process count rides "
        "every sharded cache key via mesh_topology"),
    ("ExecutionSpec", "num_processes"): Skip(
        "multi-host process-grid size, consumed by "
        "torch.distributed.init_process_group only; the live process count "
        "is keyed via mesh_topology, so a different world size keys fresh"),
    ("ExecutionSpec", "process_id"): Skip(
        "selects THIS host's rank at initialization; never reaches a "
        "program and must NOT key programs (every process must build the "
        "same program for the same spec)"),
    # padding a 3-worker grid to width-4 buckets needs 4 rows of worker
    # data, so the problem is widened alongside (both changes ride the key)
    ("ExecutionSpec", "bucket_widths"): Perturb(
        "piag", lambda s: _ex(
            _pb(s, params=dict(_TINY_PROBLEM, n_workers=4)),
            bucket_widths=(4,))),
    ("ExecutionSpec", "reference"): Perturb(
        "fedasync", lambda s: _ex(s, reference=True)),
    ("ExecutionSpec", "record_every"): Perturb(
        "piag", lambda s: _ex(s, record_every=2)),
    ("ExecutionSpec", "telemetry"): Perturb(
        "piag", lambda s: _ex(s, telemetry=True)),
    ("ExecutionSpec", "telemetry_bins"): Perturb(
        "piag/telemetry", lambda s: _ex(s, telemetry=True,
                                        telemetry_bins=8)),
    ("ExecutionSpec", "engine"): Perturb(
        "piag", lambda s: _ex(s, engine="scan")),
    ("ExecutionSpec", "device"): Skip(
        "port-only: where the problem is built and the program runs.  The "
        "resolve memo keys problems by device, so a spec on another device "
        "captures other data tensors, and those are identity-keyed (IdKey): "
        "the key moves with the device.  One check runs on one device, so "
        "there is no second device to perturb to"),
    # FaultSpec ---------------------------------------------------------
    ("FaultSpec", "p_crash"): Perturb(
        "piag/faulted", lambda s: _fl(s, p_crash=0.2)),
    ("FaultSpec", "p_rejoin"): Perturb(
        "piag/faulted", lambda s: _fl(s, p_rejoin=0.5)),
    ("FaultSpec", "crash_scale"): Perturb(
        "piag/faulted", lambda s: _fl(s, crash_scale=10.0)),
    ("FaultSpec", "p_spike"): Perturb(
        "piag/faulted", lambda s: _fl(s, p_spike=0.3)),
    ("FaultSpec", "spike_scale"): Perturb(
        "piag/faulted", lambda s: _fl(s, spike_scale=4.0)),
    ("FaultSpec", "spike_tail"): Perturb(
        "piag/faulted", lambda s: _fl(s, spike_tail=2.0)),
    ("FaultSpec", "p_drop"): Perturb(
        "piag/faulted", lambda s: _fl(s, p_drop=0.3)),
    ("FaultSpec", "p_dup"): Perturb(
        "piag/faulted", lambda s: _fl(s, p_dup=0.2)),
    ("FaultSpec", "p_corrupt"): Perturb(
        "piag/faulted", lambda s: _fl(s, p_corrupt=0.2)),
    ("FaultSpec", "corrupt_mode"): Perturb(
        "piag/faulted", lambda s: _fl(s, corrupt_mode="inf")),
    ("FaultSpec", "guard_nonfinite"): Perturb(
        "piag/faulted", lambda s: _fl(s, guard_nonfinite=False)),
    ("FaultSpec", "staleness_cutoff"): Perturb(
        "piag/faulted", lambda s: _fl(s, staleness_cutoff=8)),
    ("FaultSpec", "degrade_on_clip"): Perturb(
        "piag/faulted", lambda s: _fl(s, degrade_on_clip=False)),
    ("FaultSpec", "seed"): Perturb(
        "piag/faulted", lambda s: _fl(s, seed=1)),
    ("FaultSpec", "enabled"): Perturb(
        "piag/faulted", lambda s: _fl(s, enabled=False)),
    # TelemetryConfig ---------------------------------------------------
    ("TelemetryConfig", "delay_bins"): Perturb(
        "piag/telemetry", lambda s: _ex(s, telemetry=True,
                                        telemetry_bins=16)),
}

# the classes whose fields the forcing function enumerates
_ENUMERATED = tuple(SPEC_FAMILY) + (FaultSpec, TelemetryConfig)


def unregistered_fields(classes=_ENUMERATED) -> List[Tuple[str, str]]:
    """Fields of ``classes`` with neither a perturbation nor a skip -- the
    forcing function's output; non-empty fails the check."""
    missing = []
    for cls in classes:
        for f in dataclasses.fields(cls):
            if (cls.__name__, f.name) not in REGISTRY:
                missing.append((cls.__name__, f.name))
    return missing


# ------------------------------------------------------- completeness ----

@dataclasses.dataclass(frozen=True)
class Outcome:
    """The classified effect of one knob perturbation."""

    cls: str
    field: str
    base: str
    status: str  # key-changed | value-only | shape-retrace | uncached |
    #              skip | VIOLATION
    detail: str = ""

    @property
    def violation(self) -> bool:
        return self.status == "VIOLATION"


def _classify(name: Tuple[str, str], base_name: str, a: Optional[Captured],
              b: Optional[Captured]) -> Outcome:
    cls, field = name
    if a is None or b is None:
        which = [w for w, c in (("base", a), ("perturbed", b)) if c is None]
        return Outcome(cls, field, base_name, "uncached",
                       f"{'/'.join(which)} run never consulted "
                       "cached_program (solo / heapq reference path: "
                       "built fresh per call, no stale-reuse surface)")
    key_same = a.key == b.key
    shapes_same = a.in_shapes == b.in_shapes
    if a.trace_equal(b):
        return Outcome(cls, field, base_name, "value-only",
                       "program unchanged (knob reaches it as an input "
                       "value, or not at all)"
                       + ("" if key_same else "; key changed anyway"))
    if not key_same:
        return Outcome(cls, field, base_name, "key-changed",
                       "program changed and so did the cache key")
    if not shapes_same:
        return Outcome(cls, field, base_name, "shape-retrace",
                       "program changed under the SAME key, but input "
                       "shapes changed too -- the program's ops follow its "
                       "inputs' shapes, no stale reuse")
    return Outcome(cls, field, base_name, "VIOLATION",
                   "op trace changed while cache key AND input shapes "
                   "stayed equal -- cached_program would serve the stale "
                   "program")


def check_completeness(
        device: Optional[str] = None,
        key_filter: Optional[Callable[[tuple], tuple]] = None,
        only: Optional[List[Tuple[str, str]]] = None) -> List[Outcome]:
    """Run every registered perturbation on ``device`` and classify it;
    see the module docstring for the violation predicate.  ``only``
    restricts to a subset of ``(class, field)`` names (tests);
    ``key_filter`` simulates a key mutation (the self-test seam)."""
    missing = unregistered_fields()
    if missing and only is None:
        raise AssertionError(
            "spec knobs with no cache-key coverage registered in "
            f"repro_torch.staticcheck.cachekey.REGISTRY: {missing}.  "
            "Register a Perturb (or an explicit Skip with a reason) for "
            "each.")
    base_caps: Dict[str, Optional[Captured]] = {}
    outcomes: List[Outcome] = []
    for name, entry in REGISTRY.items():
        if only is not None and name not in only:
            continue
        if isinstance(entry, Skip):
            outcomes.append(Outcome(name[0], name[1], "-", "skip",
                                    entry.reason))
            continue
        if entry.base not in base_caps:
            base_caps[entry.base] = capture(BASES[entry.base](device),
                                            key_filter=key_filter)
        a = base_caps[entry.base]
        b = capture(entry.apply(BASES[entry.base](device)),
                    key_filter=key_filter)
        outcomes.append(_classify(name, entry.base, a, b))
    return outcomes


# ----------------------------------------------------- retrace budget ----

# the representative matrix whose distinct cached_program builds are
# counted; entries are (label, spec factory) -- note the deliberate
# duplicate of the plain piag spec, asserting value-equal specs land on
# ONE key
REPRESENTATIVE: List[Tuple[str, Callable[[Optional[str]], ExperimentSpec]]] = [
    ("piag", BASES["piag"]),
    ("piag (repeat)", BASES["piag"]),
    ("piag telemetry", BASES["piag/telemetry"]),
    ("piag record_every=2",
     lambda dev: base_spec("piag", dev, execution=_with_execution(
         dev, record_every=2))),
    ("bcd", BASES["bcd"]),
    ("fedasync", BASES["fedasync"]),
    ("fedbuff", BASES["fedbuff"]),
    # 2-D mesh representative: (1, 1) builds on one device; the
    # data-parallel gradient and the reshaped mesh_topology make this a
    # distinct program from the plain sharded base by design
    ("piag sharded 2-D mesh",
     lambda dev: base_spec("piag", dev, execution=_with_execution(
         dev, backend="sharded", mesh_shape=(1, 1)))),
]

# exact number of distinct (key, input shapes) programs the matrix may
# build; raising it needs a deliberate edit here (a retrace regression
# otherwise).  7, as the reference's.
RETRACE_BUDGET = 7


def check_retrace_budget(device: Optional[str] = None
                         ) -> Tuple[int, List[str]]:
    """Capture the representative matrix; return (distinct program count,
    failure messages).  Failures: budget exceeded, or a repeated
    value-equal spec failing to reuse its key (a resolve-memoization
    regression -- api.run's memos must hand the cache identical captured
    objects)."""
    captures = [(label, capture(build(device)))
                for label, build in REPRESENTATIVE]
    errors: List[str] = []
    seen: Dict[Any, str] = {}
    for label, cap in captures:
        if cap is None:
            errors.append(f"{label}: unexpectedly uncached")
            continue
        seen.setdefault((cap.key, cap.in_shapes), label)
    distinct = len(seen)
    by_label = dict(captures)
    a, b = by_label.get("piag"), by_label.get("piag (repeat)")
    if a is None or b is None or a.key != b.key:
        errors.append(
            "value-equal piag specs produced DIFFERENT cache keys -- the "
            "resolve memoization (api.run _PROBLEM_MEMO/_PIECES_MEMO) is "
            "no longer handing cached_program identical captured objects")
    if distinct > RETRACE_BUDGET:
        errors.append(
            f"representative matrix built {distinct} distinct programs > "
            f"budget {RETRACE_BUDGET}; if the growth is intentional, raise "
            "RETRACE_BUDGET in repro_torch/staticcheck/cachekey.py")
    return distinct, errors


# ----------------------------------------------------------------- CLI ----

def main(argv=None) -> int:
    import argparse

    from ..kernels.dispatch import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck.cachekey",
        description="cache-key completeness + retrace-budget checks")
    p.add_argument("--verbose", action="store_true",
                   help="print every outcome, not just failures")
    p.add_argument("--device", default=None,
                   help="device to run on (default: the CUDA card)")
    args = p.parse_args(argv)
    device = str(resolve_device(args.device))

    outcomes = check_completeness(device)
    violations = [o for o in outcomes if o.violation]
    counts: Dict[str, int] = {}
    for o in outcomes:
        counts[o.status] = counts.get(o.status, 0) + 1
    print("cache-key completeness:",
          ", ".join(f"{v} {k}" for k, v in sorted(counts.items())),
          f"({len(outcomes) - counts.get('skip', 0)} knobs perturbed, "
          f"{counts.get('skip', 0)} skipped, "
          f"{len(unregistered_fields())} unregistered)")
    for o in outcomes:
        if args.verbose or o.violation:
            print(f"  [{o.status}] {o.cls}.{o.field} (base {o.base}): "
                  f"{o.detail}")

    distinct, errors = check_retrace_budget(device)
    print(f"retrace budget: {distinct} distinct programs "
          f"(budget {RETRACE_BUDGET})")
    for e in errors:
        print(f"  [FAIL] {e}")

    ok = not violations and not errors
    print("cachekey:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
