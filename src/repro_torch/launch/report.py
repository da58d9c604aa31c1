"""Render a telemetry run ledger into a terminal report (counterpart of
``repro.launch.report``; the same text for the same ledger).

The ledger is the JSONL file ``repro_torch.api.run`` (or the reference's)
appends to when ``REPRO_TELEMETRY_LEDGER`` (or
``telemetry.set_ledger_path`` / ``launch.sweep --ledger``) names one --
one ``RunRecord`` per run.  This CLI is the human-facing side of that
file:

    PYTHONPATH=src python -m repro_torch.launch.report ledger.jsonl
    PYTHONPATH=src python -m repro_torch.launch.report ledger.jsonl --last 10
    PYTHONPATH=src python -m repro_torch.launch.report ledger.jsonl \
        --json out.json

Per run: a delay-histogram sparkline (last bucket = overflow), the
compile-ms vs warm-ms split and the program-cache delta.  Across runs: a
solver x backend timing table and the aggregate cache efficiency -- a
healthy repeated-spec workflow shows compile-ms collapsing to ~0 as the
program cache warms.
"""
from __future__ import annotations

import argparse
import datetime
import json
from pathlib import Path
from typing import Any, Dict, List

from ..telemetry.ledger import read_ledger

SPARKS = "▁▂▃▄▅▆▇█"


def sparkline(hist: List[int], width: int = 32) -> str:
    """Fixed-width sparkline of a histogram: bins are folded down to at
    most ``width`` columns (summing adjacent buckets) and scaled to the
    tallest column; empty columns render as the lowest tick."""
    if not hist:
        return ""
    n = len(hist)
    cols = min(width, n)
    folded = [sum(hist[i * n // cols:(i + 1) * n // cols])
              for i in range(cols)]
    peak = max(folded)
    if peak <= 0:
        return SPARKS[0] * cols
    return "".join(SPARKS[min((v * len(SPARKS)) // (peak + 1),
                              len(SPARKS) - 1)] for v in folded)


def _fmt_ms(ms: float) -> str:
    return f"{ms / 1e3:.2f}s" if ms >= 1e3 else f"{ms:.0f}ms"


def render_runs(records: List[Dict[str, Any]]) -> List[str]:
    lines = [f"{'when':<9}{'solver':<10}{'backend':<9}{'cells':>6}"
             f"{'events':>8}{'elapsed':>9}{'compile':>9}{'warm':>9}"
             f"{'cache':>8}  delay histogram (tau 0..overflow)"]
    for r in records:
        when = datetime.datetime.fromtimestamp(r["ts"]).strftime("%H:%M:%S")
        cache = r.get("cache", {})
        tau = r.get("tau_stats", {})
        clip = r.get("clipped", {})
        spark = sparkline(r.get("delay_hist", []))
        mark = "*" if r.get("hist_source") == "recorded" else ""
        warn = (f"  CLIPPED x{clip['events_clipped']}"
                if clip.get("events_clipped") else "")
        lines.append(
            f"{when:<9}{r['solver']:<10}{r['backend']:<9}"
            f"{r['n_cells']:>6}{r['n_events']:>8}"
            f"{_fmt_ms(r['elapsed_ms']):>9}{_fmt_ms(r['compile_ms']):>9}"
            f"{_fmt_ms(r['warm_ms']):>9}"
            f"{cache.get('hits', 0):>4}h{cache.get('misses', 0):>2}m"
            f"  {spark}{mark} tau<={tau.get('max', '?')}{warn}")
    if any(r.get("hist_source") == "recorded" for r in records):
        lines.append("  (* histogram binned from recorded rows only -- a "
                     "1/record_every sample; run with telemetry for exact)")
    return lines


def render_timing_table(records: List[Dict[str, Any]]) -> List[str]:
    """solver x backend aggregate: run count, mean elapsed/compile/warm."""
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for r in records:
        groups.setdefault((r["solver"], r["backend"]), []).append(r)
    lines = [f"{'solver':<10}{'backend':<9}{'runs':>5}{'policies':>20}"
             f"{'mean elapsed':>13}{'mean compile':>13}{'mean warm':>11}"]
    for (solver, backend), rs in sorted(groups.items()):
        pols: List[str] = []
        for r in rs:
            for p in r.get("policies", []):
                if p not in pols:
                    pols.append(p)
        mean = lambda k: sum(r[k] for r in rs) / len(rs)
        ptxt = ",".join(pols)
        if len(ptxt) > 19:
            ptxt = ptxt[:16] + "..."
        lines.append(f"{solver:<10}{backend:<9}{len(rs):>5}{ptxt:>20}"
                     f"{_fmt_ms(mean('elapsed_ms')):>13}"
                     f"{_fmt_ms(mean('compile_ms')):>13}"
                     f"{_fmt_ms(mean('warm_ms')):>11}")
    return lines


def render_cache(records: List[Dict[str, Any]]) -> str:
    hits = sum(r.get("cache", {}).get("hits", 0) for r in records)
    misses = sum(r.get("cache", {}).get("misses", 0) for r in records)
    evict = sum(r.get("cache", {}).get("evictions", 0) for r in records)
    total = hits + misses
    rate = f"{100.0 * hits / total:.0f}%" if total else "n/a"
    compile_ms = sum(r["compile_ms"] for r in records)
    elapsed_ms = sum(r["elapsed_ms"] for r in records)
    frac = f"{100.0 * compile_ms / elapsed_ms:.0f}%" if elapsed_ms else "n/a"
    return (f"program cache: {hits} hits / {misses} misses ({rate} hit "
            f"rate), {evict} evictions; compile time {_fmt_ms(compile_ms)} "
            f"= {frac} of {_fmt_ms(elapsed_ms)} total")


def report(records: List[Dict[str, Any]]) -> str:
    records = sorted(records, key=lambda r: r.get("ts", 0.0))
    out = [f"== runs ({len(records)}) =="]
    out += render_runs(records)
    out += ["", "== solver x backend timing =="]
    out += render_timing_table(records)
    out += ["", render_cache(records)]
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ledger", help="JSONL run ledger (one RunRecord/line)")
    ap.add_argument("--last", type=int, default=None,
                    help="only the most recent N records")
    ap.add_argument("--json", default=None,
                    help="also write the analysis.run_timeline rows here")
    a = ap.parse_args(argv)
    records = list(read_ledger(a.ledger))
    if not records:
        raise SystemExit(f"{a.ledger}: no records")
    records.sort(key=lambda r: r.get("ts", 0.0))
    if a.last is not None:
        records = records[-a.last:]
    print(report(records))
    if a.json:
        from .. import analysis
        Path(a.json).write_text(
            json.dumps(analysis.run_timeline(records), indent=2) + "\n")
        print(f"wrote {a.json}")


if __name__ == "__main__":
    main()
