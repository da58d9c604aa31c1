"""Op-trace contract verifier: the engine's prose invariants as machine
checks (the port's counterpart of ``repro.staticcheck.contracts``).

The reference checks its structural contracts on jaxprs; the port checks
the same ones on op traces (``staticcheck.optrace``):

* **off-is-absent** -- ``faults=None`` / a disabled ``FaultSpec`` and
  ``telemetry=None`` run EXACTLY the ops of the program without the
  feature (the solver loops branch on ``x is None`` on the host, never on
  a value), and passing the kwargs explicitly as ``None`` is identical to
  omitting them (default-drift guard);
* **on-is-live** -- enabling faults / telemetry changes the op trace (a
  dead knob would silently pin nothing);
* **engine parity** -- ``engine='fused'`` (the hand-written kernels) and
  ``engine='scan'`` (composed torch ops) agree on input AND output
  shapes and dtypes: same interface, different body.  On the card every
  fused event is ONE kernel launch for all cells (B1 for PIAG and BCD,
  B2 for FedAsync, B3 for FedBuff) and the scan engine launches nothing;
  on the CPU the kernels' plain versions run, so neither launches.

Verified at two levels:

* **scan level**: ``piag_scan`` / ``bcd_scan`` / ``fedasync_scan`` /
  ``fedbuff_scan`` called directly on one cell -- this exercises the
  in-loop ``check_faults`` and keyword defaults;
* **program level** (batched / sharded backends on a one-device mesh):
  the exact programs ``api.run`` would cache, intercepted by
  :func:`repro_torch.staticcheck.cachekey.capture`, compared by
  fingerprint -- and their cache keys must agree or differ in lockstep
  with the traces.

Every check runs on one device (``device=None``: the card).  The problem
defaults to the reference's tiny logistic regression (48 x 6, 3 workers,
12 events); ``python -m repro_torch.staticcheck.contracts --device cpu``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from ..api.spec import ExecutionSpec, ProblemSpec, SolverSpec
from ..core.bcd import bcd_scan
from ..core.piag import piag_scan
from ..core.problems import make_logreg
from ..core.prox import make_prox
from ..core.stepsize import make_policy
from ..faults.inject import update_fault_codes
from ..faults.spec import FaultSpec
from ..federated.server import _problem_pieces, fedasync_scan, fedbuff_scan
from ..telemetry.accumulators import TelemetryConfig
from . import cachekey as _ck
from . import optrace as _ot

__all__ = ["Check", "Problem", "TINY", "verify_scan_level",
           "verify_program_level", "verify", "SOLVERS", "KERNEL_OF", "main"]

SOLVERS = ("piag", "bcd", "fedasync", "fedbuff")
# the kernel each solver's fused event launches (B1, B1, B2, B3)
KERNEL_OF = {"piag": "fused_policy_prox_step",
             "bcd": "fused_policy_prox_step",
             "fedasync": "fused_policy_mix_step",
             "fedbuff": "fused_policy_buff_step"}

_FAULTED = FaultSpec(p_crash=0.05, p_spike=0.1, p_drop=0.1, p_corrupt=0.05,
                     seed=0)
_DISABLED = FaultSpec(p_drop=0.9, p_corrupt=0.9, staleness_cutoff=2,
                      enabled=False)  # loud knobs that must all be inert


@dataclasses.dataclass(frozen=True)
class Problem:
    """The problem the checks trace: logistic regression of ``n_samples``
    x ``dim`` over ``n_workers``, ``n_events`` events (uploads), ``m``
    BCD blocks, window horizon ``horizon``, the objective recorded every
    ``record_every`` events."""

    n_samples: int = 48
    dim: int = 6
    n_workers: int = 3
    n_events: int = 12
    m: int = 3
    horizon: int = 32
    record_every: int = 1


TINY = Problem()


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    ok: bool
    detail: str = ""
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


def _expected_launches(solver: str, device: torch.device,
                       events: int) -> Dict[str, int]:
    """One launch of the solver's kernel per event on the card; none on the
    CPU, where the plain versions run."""
    return {KERNEL_OF[solver]: events} if device.type == "cuda" else {}


# ----------------------------------------------------------- scan level ----

def _scan_caller(solver: str, problem, pb: Problem
                 ) -> Callable[..., _ot.Trace]:
    """A closure ``call(**extra) -> Trace`` recording the solver's scan over
    one cell of ``pb`` on ``problem``'s device; ``extra`` kwargs are
    forwarded verbatim so callers can compare explicit ``None`` against
    kwargs left out."""
    device = problem.A.device
    prox = make_prox("l1", lam=0.01)
    policy = make_policy("adaptive1", 0.1)
    K, H = pb.n_events, dict(horizon=pb.horizon,
                             record_every=pb.record_every)
    z = torch.zeros((1, K), dtype=torch.int32, device=device)
    x0 = torch.zeros((pb.dim,), dtype=torch.float32, device=device)

    def traced(fn, *events):
        return _ot.record(fn, *events)[1]

    if solver == "piag":
        wd = problem.worker_slices()
        gf = problem.worker_grads()

        def call(**extra):
            return traced(lambda w, tau: piag_scan(
                problem.worker_loss, x0, wd, (w, tau), policy, prox,
                objective=problem.P, grad_fn=gf, **H, **extra), z, z)
        return call
    if solver == "bcd":
        def call(**extra):
            return traced(lambda w, tau, blk: bcd_scan(
                problem.grad_f, problem.P, x0, pb.m, pb.n_workers,
                (w, tau, blk), policy, prox, **H, **extra), z, z, z)
        return call
    update, fx0, data = _problem_pieces(problem, prox, None)
    scan = fedasync_scan if solver == "fedasync" else fedbuff_scan
    fed_kw = {} if solver == "fedasync" else dict(eta=1.0, buffer_size=1)
    ones = torch.ones((1, K), dtype=torch.int32, device=device)
    agg = torch.ones((1, K), dtype=torch.float32, device=device)

    def call(**extra):
        return traced(lambda *ev: scan(
            update, fx0, data, ev, policy, objective=problem.P, **fed_kw,
            **H, **extra), z, z, ones, agg, z)
    return call


def verify_scan_level(solvers=SOLVERS, device=None,
                      pb: Problem = TINY) -> List[Check]:
    from ..kernels.dispatch import resolve_device
    dev = resolve_device(device)
    problem = make_logreg(pb.n_samples, pb.dim, n_workers=pb.n_workers,
                          seed=0, device=dev)
    checks: List[Check] = []
    for s in solvers:
        call = _scan_caller(s, problem, pb)
        base = call()   # the port's default engine, fused

        def add(name: str, ok: bool, detail: str = "", launches=None):
            checks.append(Check(f"scan/{s}/{name}", ok, detail,
                                launches or {}))

        explicit = call(faults=None, telemetry=None)
        add("explicit-none-is-omitted",
            _ot.fingerprint(explicit) == _ot.fingerprint(base),
            _ot.diff(base, explicit, "omitted", "explicit None"))

        disabled = call(faults=_DISABLED)
        add("disabled-faults-are-none",
            _ot.fingerprint(disabled) == _ot.fingerprint(base),
            _ot.diff(base, disabled, "faults=None", "disabled FaultSpec"))

        # faults run only under the scan engine (as in the reference)
        scan = call(engine="scan")
        codes = update_fault_codes(_FAULTED, pb.n_events,
                                   torch.zeros(1, dtype=torch.int64,
                                               device=dev))
        faulted = call(engine="scan", faults=_FAULTED, fault_codes=codes)
        add("faults-live",
            _ot.fingerprint(faulted) != _ot.fingerprint(scan),
            "enabling faults did not change the op trace (dead knob)")

        telem = call(telemetry=TelemetryConfig())
        add("telemetry-live",
            _ot.fingerprint(telem) != _ot.fingerprint(base),
            "enabling telemetry did not change the op trace")

        add("fused-scan-io-parity",
            _ot.io_shapes(base) == _ot.io_shapes(scan),
            f"fused {_ot.io_shapes(base)} != scan {_ot.io_shapes(scan)}")
        add("fused-is-a-different-body",
            _ot.fingerprint(base) != _ot.fingerprint(scan),
            "engine='fused' ran the ops of 'scan'")
        want = _expected_launches(s, dev, pb.n_events)
        add("fused-launches",
            base.launches == want and scan.launches == {},
            f"fused launched {base.launches} (want {want}), scan "
            f"{scan.launches} (want none)", base.launches)
    return checks


# -------------------------------------------------------- program level ----

def _spec(solver: str, backend: str, device: str, pb: Problem,
          engine: str = "fused", **over):
    ex = dict(backend=backend, engine=engine, device=device,
              record_every=pb.record_every, **over.pop("execution_kw", {}))
    if backend == "sharded":
        ex["devices"] = 1   # a one-device mesh
    spec = _ck.base_spec(solver, device, engine,
                         execution=ExecutionSpec(**ex),
                         n_events=pb.n_events, **over)
    return spec.replace(
        problem=ProblemSpec(kind="logreg", params=dict(
            n_samples=pb.n_samples, dim=pb.dim, n_workers=pb.n_workers,
            seed=0)),
        solver=SolverSpec(name=solver, horizon=pb.horizon, m=pb.m),
        topology=dataclasses.replace(spec.topology,
                                     n_workers=(pb.n_workers,)))


def _lockstep(a: _ck.Captured, b: _ck.Captured) -> bool:
    """Keys agree exactly where the traces do."""
    return (a.key == b.key) == (a.fingerprint == b.fingerprint)


def verify_program_level(solvers=SOLVERS, backends=("batched", "sharded"),
                         device=None, pb: Problem = TINY) -> List[Check]:
    from ..kernels.dispatch import resolve_device
    dev = resolve_device(device)
    checks: List[Check] = []
    for s in solvers:
        for b in backends:
            def cap(engine="fused", **over):
                return _ck.capture(_spec(s, b, str(dev), pb, engine, **over))

            base = cap()

            def add(name: str, ok: bool, detail: str = "", launches=None):
                checks.append(Check(f"{b}/{s}/{name}", ok, detail,
                                    launches or {}))

            if base is None:
                add("captured", False,
                    f"backend {b} unexpectedly bypassed cached_program")
                continue

            # a disabled FaultSpec normalizes to None where the spec is
            # built; a spec equal to the base's is the base's run (capture
            # is deterministic: value-equal specs give one key and one
            # trace), so only a spec that differs is captured anew
            spec = _spec(s, b, str(dev), pb, faults=_DISABLED)
            disabled = base if spec == _spec(s, b, str(dev), pb) \
                else _ck.capture(spec)
            add("disabled-faults-are-none",
                disabled is not None
                and disabled.fingerprint == base.fingerprint
                and disabled.key == base.key,
                "disabled FaultSpec must reuse the faults=None program AND "
                "its cache key (normalize_faults chain)")

            scan = cap("scan")
            faulted = cap("scan", faults=_FAULTED)
            add("faults-live",
                scan is not None and faulted is not None
                and faulted.fingerprint != scan.fingerprint
                and _lockstep(scan, faulted),
                "enabling faults must change program and key")

            telem = cap(execution_kw=dict(telemetry=True))
            add("telemetry-live",
                telem is not None and telem.fingerprint != base.fingerprint
                and _lockstep(base, telem),
                "enabling telemetry must change program and key")

            add("fused-scan-io-parity",
                scan is not None
                and scan.in_shapes == base.in_shapes
                and scan.out_shapes == base.out_shapes
                and scan.fingerprint != base.fingerprint
                and _lockstep(base, scan),
                "fused and scan programs must agree on input/output "
                "shapes while differing in body and key")
            want = _expected_launches(s, dev, pb.n_events)
            add("fused-launches",
                base.launches == want
                and scan is not None and scan.launches == {},
                f"fused launched {base.launches} (want {want}), scan "
                f"{None if scan is None else scan.launches} (want none)",
                base.launches)
    return checks


def verify(quick: bool = False, device=None,
           pb: Problem = TINY) -> List[Check]:
    """The full contract matrix on ``device``; ``quick=True`` restricts to
    PIAG + FedBuff and the batched backend (the test-suite subset)."""
    solvers = ("piag", "fedbuff") if quick else SOLVERS
    backends = ("batched",) if quick else ("batched", "sharded")
    return (verify_scan_level(solvers, device, pb)
            + verify_program_level(solvers, backends, device, pb))


# ----------------------------------------------------------------- CLI ----

def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck.contracts",
        description="op-trace contract verifier (solvers x backends)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default=None,
                   help="device to run on (default: the CUDA card)")
    args = p.parse_args(argv)

    checks = verify(quick=args.quick, device=args.device)
    failed = [c for c in checks if not c.ok]
    for c in checks:
        if args.verbose or not c.ok:
            status = "ok" if c.ok else "FAIL"
            print(f"[{status}] {c.name}"
                  + (f" launches {c.launches}" if c.launches else ""))
            if not c.ok and c.detail:
                head = "\n".join(c.detail.splitlines()[:40])
                print(f"       {head}")
    print(f"contracts: {len(checks) - len(failed)}/{len(checks)} ok")
    return 0 if not failed else 1


if __name__ == "__main__":
    raise SystemExit(main())
