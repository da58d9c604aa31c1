"""The structured run ledger (counterpart of ``repro.telemetry.ledger``).

Every ``repro_torch.api.run`` builds one ``RunRecord`` -- spec
fingerprint, solver and backend, the horizon, the measured tau-bar, the
delay histogram, compile ms against warm ms, the program cache's
hit/miss/evict deltas and a scan-carry size estimate -- returns it on
``Results.telemetry`` and, when a ledger path is set, appends it as one
JSON line.  The format, the environment variable and the fingerprint are
the reference's, so a ledger written by either package reads in the
other, and a spec fingerprints to the same digest in both.

Nothing is written unless ``set_ledger_path(path)`` was called or the
``REPRO_TELEMETRY_LEDGER`` environment variable names a file.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Union

__all__ = ["RunRecord", "set_ledger_path", "get_ledger_path",
           "append_record", "read_ledger", "spec_fingerprint",
           "estimate_carry_bytes", "cache_delta", "warn_clip_pressure"]

LEDGER_ENV = "REPRO_TELEMETRY_LEDGER"

_LEDGER_PATH: Optional[str] = None

# spec fields the port adds to the reference's dataclasses; the
# fingerprint leaves them out so value-equal specs hash alike in both
_PORT_ONLY_FIELDS = ("device",)


def set_ledger_path(path: Optional[Union[str, Path]]) -> None:
    """Route ``append_record`` to ``path`` (None restores the default: no
    writes unless ``REPRO_TELEMETRY_LEDGER`` is set)."""
    global _LEDGER_PATH
    _LEDGER_PATH = None if path is None else str(path)


def get_ledger_path() -> Optional[str]:
    return _LEDGER_PATH if _LEDGER_PATH is not None \
        else (os.environ.get(LEDGER_ENV) or None)


@dataclasses.dataclass
class RunRecord:
    """One ``api.run`` as a flat, JSON-able record (the reference's fields).

    ``delay_hist`` is summed over cells: with ``hist_source ==
    "accumulator"`` the exact in-scan histogram (it sums to ``n_cells *
    n_events`` whatever ``record_every``), with ``"recorded"`` binned on
    the host from the RECORDED tau rows (exact at stride 1 only).
    ``compile_ms`` sums the run's ``program_build`` / first-dispatch
    timing events; ``warm_ms = max(elapsed - compile, 0)``.  Solo runs
    bypass the program cache, so their compile share is 0.
    """

    ts: float
    fingerprint: str
    solver: str
    backend: str
    n_cells: int
    n_events: int
    record_every: int
    horizon: Optional[int]
    tau_bar: Optional[int]
    devices: int
    mesh_shape: Optional[List[int]]
    carry_bytes: int
    elapsed_ms: float
    compile_ms: float
    warm_ms: float
    cache: Dict[str, Any]
    delay_hist: List[int]
    hist_source: str
    tau_stats: Dict[str, float]
    gamma_stats: Dict[str, float]
    clipped: Dict[str, int]
    policies: List[str]
    timings: List[Dict[str, Any]]
    # fault counters summed over cells; None when the run had no faults
    faults: Optional[Dict[str, int]] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def append_record(record: RunRecord,
                  path: Optional[Union[str, Path]] = None) -> bool:
    """Append one JSON line; False (and nothing written) when no ledger
    path is set."""
    p = str(path) if path is not None else get_ledger_path()
    if not p:
        return False
    with open(p, "a") as fh:
        fh.write(record.to_json() + "\n")
    return True


def read_ledger(path: Union[str, Path]) -> Iterator[Dict[str, Any]]:
    """Yield one dict per ledger line (blank lines skipped)."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield json.loads(line)


class _Text:
    """An object whose repr is the given text (a field-filtered repr)."""

    __slots__ = ("text",)

    def __init__(self, text: str):
        self.text = text

    def __repr__(self) -> str:
        return self.text


def _reference_repr(obj: Any) -> Any:
    """``obj``'s dataclass repr without the port-only fields, i.e. the
    repr of the value-equal reference dataclass."""
    if not dataclasses.is_dataclass(obj):
        return obj
    body = ", ".join(f"{f.name}={getattr(obj, f.name)!r}"
                     for f in dataclasses.fields(obj)
                     if f.repr and f.name not in _PORT_ONLY_FIELDS)
    return _Text(f"{type(obj).__qualname__}({body})")


def spec_fingerprint(spec: Any, grid: Any = None) -> str:
    """A short stable digest of the experiment configuration, built from
    the spec's declarative knobs (never from array contents).  Value-equal
    specs fingerprint alike, in this package and in the reference: the
    port-only ``ExecutionSpec.device`` is left out.  Component specs fall
    back to the grid's cell labels."""
    try:
        faults = getattr(spec, "faults", None)
        if spec is not None and getattr(spec.problem, "problem", None) is None:
            desc = repr((spec.problem, spec.solver, spec.topology,
                         spec.policies, spec.delay,
                         _reference_repr(spec.execution), spec.n_events,
                         faults))
        elif grid is not None:
            desc = repr((type(spec).__name__ if spec is not None else None,
                         tuple(grid.labels()), grid.n_events, faults))
        else:
            desc = repr(spec)
    except Exception:  # never let fingerprinting break a run
        desc = "unfingerprintable"
    return hashlib.sha1(desc.encode()).hexdigest()[:12]


def estimate_carry_bytes(solver: str, dim: int, width: int, horizon: int,
                         n_cells: int) -> int:
    """Order-of-magnitude loop-carry footprint of a batched run: the
    iterate-shaped leaves per cell plus the step-size buffer, in float32
    bytes (an estimate for trend lines, not an allocator reading)."""
    per_cell = {
        "piag": dim * (1 + 2 * width),        # x + g_table + x_read
        "bcd": dim * (1 + width),             # x + x_read snapshots
        "fedasync": dim * (1 + width),        # x + client snapshot table
        "fedbuff": dim * (2 + width),         # + the delta buffer
    }.get(solver, dim * (1 + width))
    return int(4 * (per_cell + int(horizon) + 4) * int(n_cells))


def cache_delta(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, Any]:
    """Per-run ``program_cache_stats()`` delta, reset-scoped: when
    ``clear_program_cache()`` ran between the snapshots (a generation
    bump), the after-side counters ARE the delta since the clear, flagged
    ``reset``."""
    reset = before.get("generation") != after.get("generation")
    base = {k: 0 for k in ("hits", "misses", "evictions")} if reset else before
    return {
        "hits": int(after.get("hits", 0)) - int(base.get("hits", 0)),
        "misses": int(after.get("misses", 0)) - int(base.get("misses", 0)),
        "evictions": (int(after.get("evictions", 0))
                      - int(base.get("evictions", 0))),
        "size": int(after.get("size", 0)),
        "reset": bool(reset),
    }


def warn_clip_pressure(clip: Dict[str, int],
                       horizon: Optional[int] = None) -> Optional[str]:
    """Given an ``analysis.clipped_summary`` block, emit a
    ``RuntimeWarning`` and return its message when any cell clipped a
    delay at the policy horizon; None when clean."""
    import warnings

    if not clip.get("cells_clipped"):
        return None
    h = f" (H={horizon})" if horizon is not None else ""
    msg = (f"{clip['cells_clipped']}/{clip['cells']} cells clipped "
           f"{clip['events_clipped']} delays at the policy horizon{h}; "
           "window sums were silently truncated -- raise the horizon")
    warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return msg
