"""Delay telemetry (counterpart of ``repro.telemetry``).

Three layers, smallest first:

- ``accumulators``: in-loop aggregates (delay histogram, tau/gamma
  running moments, per-window clip counters) threaded through the solver
  loops as an extra carry element, with a leading cell axis.  Bitwise
  neutral: enabling telemetry changes no solver output bit.
- ``timing``: a host-side buffer of timing events (program cache,
  bucketed runners).
- ``ledger``: the per-run ``RunRecord`` every ``api.run`` builds, returned
  on ``Results.telemetry`` and appended as JSON lines when a ledger path
  is set (``REPRO_TELEMETRY_LEDGER`` or ``set_ledger_path``), in the
  reference's format.
"""
from .accumulators import (DelayTelemetry, TelemetryConfig, TelemetryState,
                           emit_window, finalize, init_telemetry, observe,
                           summarize_telemetry)
from .ledger import (LEDGER_ENV, RunRecord, append_record, cache_delta,
                     estimate_carry_bytes, get_ledger_path, read_ledger,
                     set_ledger_path, spec_fingerprint, warn_clip_pressure)
from .timing import (COMPILE_EVENT_NAMES, drain_timings, peek_timings,
                     record_timing, timed)

__all__ = [
    "TelemetryConfig", "TelemetryState", "DelayTelemetry",
    "init_telemetry", "observe", "emit_window", "finalize",
    "summarize_telemetry",
    "record_timing", "drain_timings", "peek_timings", "timed",
    "COMPILE_EVENT_NAMES",
    "RunRecord", "set_ledger_path", "get_ledger_path", "append_record",
    "read_ledger", "spec_fingerprint", "estimate_carry_bytes",
    "cache_delta", "warn_clip_pressure", "LEDGER_ENV",
]
