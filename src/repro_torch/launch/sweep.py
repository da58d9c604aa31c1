"""Spec-driven CLI for policy x seed x topology (x worker-count) sweeps
(counterpart of ``repro.launch.sweep``).

Flags build a ``repro_torch.api.ExperimentSpec`` (or ``--spec`` loads one
from a Python file), ``repro_torch.api.run`` executes it on the requested
backend, and the per-policy summary comes from ``repro_torch.analysis``.
The flags and the printed summary are the reference's; ``--device`` is
the port's own (the CUDA cards by default, ``cpu`` for the plain PyTorch
path).  Runs take the port's default engine, the hand-written kernel
(``engine='fused'``), and ``engine='scan'`` under ``--faults``.

    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --solver piag --policies adaptive1,adaptive2,fixed \
        --seeds 4 --events 1000 --workers 8 [--json sweep.json]

    # ragged worker-count axis + sharding over every CUDA card
    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --solver piag --n-workers 4,8,16 --backend sharded

    # the same on the CPU (a one-device mesh)
    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --solver piag --n-workers 4,8 --backend sharded --device cpu

    # a spec file: any Python file defining SPEC (a repro_torch
    # ExperimentSpec) or make_spec() -> ExperimentSpec; flags are ignored
    # except --json, --ledger and --resume
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec my_spec.py
"""
from __future__ import annotations

import argparse
import json
import runpy
from pathlib import Path

from .. import analysis, api, telemetry
from ..faults import parse_faults
from ..kernels.dispatch import resolve_device
from ..mesh import default_devices


def load_spec(path: str) -> api.ExperimentSpec:
    """Load an ``ExperimentSpec`` from a Python file: either a module-level
    ``SPEC`` or a ``make_spec()`` factory."""
    ns = runpy.run_path(path)
    spec = ns.get("SPEC")
    if spec is None and callable(ns.get("make_spec")):
        spec = ns["make_spec"]()
    if not isinstance(spec, api.ExperimentSpec):
        raise SystemExit(
            f"{path} must define SPEC (a repro_torch.api.ExperimentSpec) or "
            "make_spec() returning one")
    return spec


def parse_horizon(value: str):
    """``'auto'`` (measured-delay sizing) or a concrete integer H."""
    return "auto" if value == "auto" else int(value)


def spec_from_flags(a: argparse.Namespace) -> api.ExperimentSpec:
    federated = a.solver in ("fedasync", "fedbuff")
    policy_names = tuple((a.policies or
                          ("hinge,poly,constant" if federated
                           else "adaptive1,adaptive2,fixed")).split(","))
    widths = tuple(int(w) for w in a.n_workers.split(",")) \
        if a.n_workers else (a.workers,)
    return api.ExperimentSpec(
        problem=api.ProblemSpec(
            kind="logreg",
            params=dict(n_samples=a.samples, dim=a.dim, seed=0)),
        solver=api.SolverSpec(name=a.solver,
                              horizon=parse_horizon(a.horizon), m=a.blocks,
                              eta=a.eta, buffer_size=a.buffer_size),
        topology=api.TopologySpec(kind="edge" if federated else "standard",
                                  n_workers=widths),
        policies=api.PolicyGridSpec(names=policy_names,
                                    seeds=tuple(range(a.seeds))),
        execution=api.ExecutionSpec(backend=a.backend,
                                    record_every=a.record_every,
                                    telemetry=a.telemetry,
                                    telemetry_bins=a.telemetry_bins,
                                    # the fused engine refuses faults
                                    engine="scan" if a.faults else "fused",
                                    device=a.device),
        n_events=a.events,
        faults=parse_faults(a.faults))


def print_summary(res: api.Results) -> None:
    summaries = analysis.summarize(res)
    clip = analysis.clipped_summary(res.clipped)
    # the clip-pressure path: a RuntimeWarning whose message also lands in
    # the printed output and, through clipped_summary, in --json
    msg = telemetry.warn_clip_pressure(clip, horizon=res.horizon)
    if msg:
        print(f"WARNING: {msg}")
    print(f"{'policy':<16} {'mean P_final':>12} {'min P_final':>12} "
          f"{'mean sum(gamma)':>16} {'clipped':>8}")
    for pn, s in summaries.items():
        print(f"{pn:<16} {s.mean_final:>12.5f} {s.min_final:>12.5f} "
              f"{s.mean_sum_gamma:>16.3f} {s.clipped_events:>8}")


def device_count(res: api.Results) -> int:
    """The devices the summary names: the mesh's size on the sharded
    backend, else every device of the run's kind (the reference prints
    ``len(jax.devices())``)."""
    if res.backend == "sharded":
        return int(res.telemetry.devices)
    dev = resolve_device(res.spec.execution.device)
    return len(default_devices(dev.type)[0])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spec", default=None,
                    help="Python file defining SPEC or make_spec(); "
                    "overrides every flag except --json, --ledger, --resume")
    ap.add_argument("--solver", choices=list(api.SOLVERS), default="piag")
    ap.add_argument("--backend", choices=list(api.BACKENDS),
                    default="batched")
    ap.add_argument("--shard", action="store_true",
                    help="alias for --backend sharded (back-compat)")
    ap.add_argument("--policies", default=None,
                    help="comma-separated names from core.stepsize.POLICIES "
                    "(default: adaptive1,adaptive2,fixed; federated: "
                    "hinge,poly,constant)")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--events", type=int, default=1000)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--n-workers", default=None,
                    help="comma-separated worker counts: grows the ragged "
                    "n_workers grid axis (overrides --workers)")
    ap.add_argument("--samples", type=int, default=800)
    ap.add_argument("--dim", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=20, help="bcd only")
    ap.add_argument("--eta", type=float, default=0.5,
                    help="fedbuff server rate")
    ap.add_argument("--buffer-size", type=int, default=1,
                    help="fedbuff |R| (fedasync forces 1)")
    ap.add_argument("--horizon", default="4096",
                    help="step-size window-sum horizon H (largest "
                    "representable delay is H - 1; specs whose measured "
                    "delay bound exceeds it fail fast), or 'auto': size H "
                    "to next_pow2(measured tau-bar + 1)")
    ap.add_argument("--record-every", type=int, default=1,
                    help="decimated trace recording stride s: keep only "
                    "every s-th event row; must divide --events")
    ap.add_argument("--telemetry", action="store_true",
                    help="the in-loop delay/step-size accumulators (no "
                    "solver leaf changes; exact histogram under "
                    "--record-every)")
    ap.add_argument("--telemetry-bins", type=int, default=64,
                    help="delay-histogram buckets (last bin = overflow)")
    ap.add_argument("--ledger", default=None,
                    help="append this run's RunRecord to a JSONL ledger "
                    "file (also honored with --spec; see launch/report.py)")
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec: a preset name "
                    "(crash/straggler/corrupt/chaos) optionally followed by "
                    "comma-separated key=value overrides, or bare key=value "
                    "pairs (see repro_torch.faults.FaultSpec); a faulted "
                    "sweep runs engine='scan'")
    ap.add_argument("--resume", default=None,
                    help="checkpoint directory: finished sweep buckets are "
                    "saved here and loaded on a re-run, so a killed sweep "
                    "resumes instead of recomputing")
    ap.add_argument("--device", default=None,
                    help="where the sweep runs: the CUDA cards by default "
                    "(raising without one), 'cpu' for the plain PyTorch path")
    ap.add_argument("--json", default=None, help="write per-cell results here")
    a = ap.parse_args(argv)
    if a.shard:
        a.backend = "sharded"
    if a.ledger:
        telemetry.set_ledger_path(a.ledger)

    spec = load_spec(a.spec) if a.spec else spec_from_flags(a)

    res = api.run(spec, resume=a.resume)
    grid, n_dev = res.grid, device_count(res)
    policy_names = list(dict.fromkeys(c.policy_name for c in grid.cells))
    widths = sorted({c.n_workers for c in grid.cells})
    auto = spec.solver.horizon == "auto"
    print(f"sweep[{res.solver}/{res.backend}]: {len(grid)} cells "
          f"({','.join(policy_names)} x "
          f"{len({c.seed for c in grid.cells})} seeds x widths {widths}), "
          f"{grid.n_events} events, tau_bar={res.tau_bar}, "
          f"horizon={res.horizon}{' (auto)' if auto else ''}, "
          f"record_every={res.record_every}, devices={n_dev}")
    rec = res.telemetry
    print(f"{res.backend} backend: {res.elapsed_s:.2f}s "
          f"({res.elapsed_s / len(grid) * 1e3:.1f} ms/cell incl. compile; "
          f"compile {rec.compile_ms:.0f}ms / warm {rec.warm_ms:.0f}ms, "
          f"cache {rec.cache['hits']}h/{rec.cache['misses']}m)")
    print_summary(res)
    if spec.execution.telemetry:
        dp = analysis.delay_profile(res)
        print(f"delay profile ({dp['source']}): {dp['count']} events, "
              f"tau in [{dp['tau']['min']}, {dp['tau']['max']}], "
              f"mean {dp['tau']['mean']:.2f} +/- {dp['tau']['std']:.2f}")
    if rec.faults:
        print("faults: " + ", ".join(f"{k}={v}"
                                     for k, v in sorted(rec.faults.items())))
    if a.ledger:
        print(f"appended RunRecord to {a.ledger}")

    if a.json:
        Path(a.json).write_text(json.dumps(
            {"solver": res.solver, "backend": res.backend,
             "events": grid.n_events, "tau_bar": res.tau_bar,
             "horizon": res.horizon, "horizon_auto": auto,
             "record_every": res.record_every,
             "devices": n_dev, "seconds": res.elapsed_s,
             "clipped": analysis.clipped_summary(res.clipped),
             "clipped_summary": analysis.clip_pressure(res),
             "telemetry": {"compile_ms": rec.compile_ms,
                           "warm_ms": rec.warm_ms, "cache": rec.cache,
                           "delay_hist": rec.delay_hist,
                           "hist_source": rec.hist_source},
             "faults": rec.faults,
             "cells": res.to_rows()}, indent=2) + "\n")
        print(f"wrote {a.json}")


if __name__ == "__main__":
    main()
