"""Sweep-level analysis (counterpart of ``repro.analysis``; numpy-only).

Per-policy aggregation, time-to-tolerance, best-fixed-vs-adaptive gaps and
clipped-horizon summaries.  Everything operates on plain arrays + the
grid's ``SweepCell`` coordinate list, so the functions work on
``api.Results`` columns and on raw ``PIAGResult`` leaves alike; device
tensors are copied to the host first.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, NamedTuple, Optional

import json

import numpy as np

__all__ = ["PolicySummary", "policy_rows", "per_policy_summary",
           "mean_final_objective", "time_to_tolerance",
           "best_fixed_vs_adaptive", "clipped_summary", "summarize",
           "delay_profile", "clip_pressure", "run_timeline"]


def _host(a) -> np.ndarray:
    """An array-like (numpy, or a tensor on any device) as host numpy."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class PolicySummary(NamedTuple):
    """Aggregates over all cells (seeds x topologies x widths) of a policy."""

    policy: str
    n_cells: int
    mean_final: float        # mean final objective
    min_final: float         # best final objective
    mean_sum_gamma: float    # mean total step-size / mixing-weight budget
    clipped_cells: int       # cells with any horizon-clipped delay
    clipped_events: int      # total horizon-clipped events


def policy_rows(cells) -> Dict[str, List[int]]:
    """Cell indices grouped by policy name, in first-seen (grid) order."""
    rows: Dict[str, List[int]] = {}
    for i, c in enumerate(cells):
        rows.setdefault(c.policy_name, []).append(i)
    return rows


def per_policy_summary(cells, objective, gammas=None,
                       clipped=None) -> Dict[str, PolicySummary]:
    """The per-policy table the sweep CLI prints: mean/min final
    objective, mean summed step-size, clip counts, keyed by policy name in
    grid order.

    Stride-aware by construction: final objective and clip counts are exact
    under decimated recording (the last event is always recorded and
    ``clipped`` comes from the scan carry); ``mean_sum_gamma`` sums the
    RECORDED gamma samples, i.e. ~1/s of the full-budget value at stride s
    -- comparable within a sweep, not across strides."""
    obj = _host(objective)
    gam = None if gammas is None else _host(gammas)
    clp = None if clipped is None else _host(clipped)
    out = {}
    for pn, rows in policy_rows(cells).items():
        rows = np.asarray(rows)
        out[pn] = PolicySummary(
            policy=pn,
            n_cells=int(rows.size),
            mean_final=float(obj[rows, -1].mean()),
            min_final=float(obj[rows, -1].min()),
            mean_sum_gamma=(float(gam[rows].sum(1).mean())
                            if gam is not None else float("nan")),
            clipped_cells=(int(np.sum(clp[rows] > 0))
                           if clp is not None else 0),
            clipped_events=(int(clp[rows].sum()) if clp is not None else 0),
        )
    return out


def mean_final_objective(cells, objective) -> Dict[str, float]:
    """Mean final objective per policy, keyed in grid order."""
    obj = _host(objective)
    return {pn: float(np.mean(obj[rows, -1]))
            for pn, rows in policy_rows(cells).items()}


def time_to_tolerance(objective, target: float, p_star: float = 0.0,
                      record_every: int = 1):
    """First event index where ``objective - p_star <= target``; -1 when
    the tolerance is never reached.

    1-D input -> int (the events-to-target metric); 2-D (B, K) input ->
    (B,) int array, one per cell.

    ``record_every=s`` declares the input as a DECIMATED trajectory
    (columns are events ``s-1, 2s-1, ...``, see ``ExecutionSpec``): the
    returned index is mapped back to event units, ``j*s + s - 1`` for the
    first hit column j, so thresholds stay comparable across strides (a
    decimated run can only report a hit at or after the stride-1 event).
    """
    s = int(record_every)
    if s < 1:
        raise ValueError(f"record_every must be >= 1, got {record_every}")
    sub = _host(objective) - p_star
    hit = sub <= target
    if sub.ndim == 1:
        return (int(np.argmax(hit)) * s + (s - 1)) if hit.any() else -1
    first = np.argmax(hit, axis=-1) * s + (s - 1)
    return np.where(hit.any(axis=-1), first, -1).astype(np.int64)


def best_fixed_vs_adaptive(events_to_target: Mapping[str, Optional[int]],
                           fixed: Optional[Iterable[str]] = None,
                           adaptive: Optional[Iterable[str]] = None) -> dict:
    """The paper's headline derived metric: best (fewest events to the
    tolerance) fixed-family policy vs best adaptive policy.

    ``events_to_target`` maps policy name -> event count (-1 or None =
    never reached).  ``fixed`` defaults to names starting with ``"fixed"``
    plus the other worst-case-bound baselines (``sun_deng`` / ``davis`` /
    ``constant``, the non-adaptive families of ``core.stepsize``);
    ``adaptive`` defaults to every other name.  Returns ``best_fixed``,
    ``best_adaptive`` (-1 = never) and ``speedup`` (fixed / adaptive; None
    unless both reached the tolerance).
    """
    names = list(events_to_target)
    fixed = set(fixed) if fixed is not None \
        else {n for n in names
              if n.startswith("fixed") or n in ("sun_deng", "davis",
                                                "constant")}
    adaptive = set(adaptive) if adaptive is not None \
        else set(names) - fixed

    def best(group):
        vals = [int(events_to_target[n]) for n in names
                if n in group and events_to_target[n] is not None
                and int(events_to_target[n]) >= 0]
        return min(vals, default=-1)

    bf, ba = best(fixed), best(adaptive)
    speedup = (bf / ba) if bf > 0 and ba > 0 else None
    return {"best_fixed": bf, "best_adaptive": ba, "speedup": speedup}


def clipped_summary(clipped) -> dict:
    """Horizon-clipping across a sweep: how many cells silently truncated
    window sums (delay > H - 1) and how badly.  ``cells_clipped > 0`` means
    the horizon was undersized for some cells -- raise it."""
    clp = _host(clipped)
    return {
        "cells": int(clp.size),
        "cells_clipped": int(np.sum(clp > 0)),
        "events_clipped": int(clp.sum()),
        "max_events_clipped": int(clp.max()) if clp.size else 0,
    }


def summarize(results) -> Dict[str, PolicySummary]:
    """Per-policy aggregation straight off an ``api.Results`` table."""
    return per_policy_summary(results.cells, results.objective,
                              results.gammas, results.clipped)


# ------------------------------------------------ telemetry bridges ----

def delay_profile(results) -> dict:
    """The run's delay distribution off an ``api.Results`` table (or its
    ``RunRecord``): histogram (last bin = overflow bucket when the source
    is the in-scan accumulator), tau min/max/mean/std, and the source tag
    (``"accumulator"`` = exact over every event; ``"recorded"`` = binned
    from the recorded 1/s sample)."""
    rec = getattr(results, "telemetry", results)
    hist = [int(h) for h in _rec_get(rec, "delay_hist")]
    return {
        "hist": hist,
        "count": int(sum(hist)),
        "tau": dict(_rec_get(rec, "tau_stats")),
        "gamma": dict(_rec_get(rec, "gamma_stats")),
        "source": _rec_get(rec, "hist_source"),
    }


def clip_pressure(results) -> dict:
    """Horizon-clip pressure with the run's horizon attached: the
    ``clipped_summary`` block plus ``horizon`` and the fraction of events
    clipped, off an ``api.Results`` table or a ledger record."""
    rec = getattr(results, "telemetry", results)
    clip = dict(_rec_get(rec, "clipped"))
    total = int(_rec_get(rec, "n_cells")) * int(_rec_get(rec, "n_events"))
    clip["horizon"] = _rec_get(rec, "horizon")
    clip["clip_fraction"] = (clip.get("events_clipped", 0) / total
                             if total else 0.0)
    return clip


def run_timeline(records) -> List[dict]:
    """Chronological per-run timing rows from a ledger: pass an iterable of
    record dicts / ``RunRecord`` objects, or a ledger file path.  Each row
    carries the compile/warm split and the cache delta, so a sequence of
    runs shows cache warm-up as compile-ms collapsing to ~0."""
    if isinstance(records, (str, bytes)) or hasattr(records, "__fspath__"):
        with open(records) as fh:
            records = [json.loads(line) for line in fh if line.strip()]
    rows = [{
        "ts": _rec_get(r, "ts"),
        "fingerprint": _rec_get(r, "fingerprint"),
        "solver": _rec_get(r, "solver"),
        "backend": _rec_get(r, "backend"),
        "n_cells": _rec_get(r, "n_cells"),
        "elapsed_ms": _rec_get(r, "elapsed_ms"),
        "compile_ms": _rec_get(r, "compile_ms"),
        "warm_ms": _rec_get(r, "warm_ms"),
        "cache": _rec_get(r, "cache"),
    } for r in records]
    rows.sort(key=lambda row: row["ts"])
    return rows


def _rec_get(rec, field):
    """Field access across the three record shapes analysis accepts:
    ``RunRecord`` dataclasses, raw ledger dicts, and ``Results`` proxies."""
    if isinstance(rec, dict):
        return rec[field]
    return getattr(rec, field)
