"""`FaultSpec`: the declarative fault-injection and guard configuration
(counterpart of ``repro.faults.spec``; the port keeps its own copy).

One frozen, hashable dataclass describes everything the fault layer does:

* trace-level injection (crash/rejoin Markov chains over worker service
  times, heavy-tail straggler spikes), applied by ``faults.inject`` before
  the event race (``core.engine.trace_scan`` /
  ``federated.events.federated_trace_scan``);
* update-level injection (dropped / duplicated / NaN- or Inf-corrupted
  updates): a per-event int32 fault code riding the solver event columns;
* in-loop guards (non-finite rejection, staleness-cutoff rejection,
  horizon-overflow degradation), applied by the solver loops.

``faults=None`` (or a disabled spec, via :func:`normalize_faults`) runs
the solver loops' fault-free step bodies unchanged, and a ``FaultSpec``
rides every program-cache key.  Class name, fields, defaults, presets and
messages are the reference's, so ``telemetry.spec_fingerprint`` of a spec
carrying a ``FaultSpec`` equals the reference's digest.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["FaultSpec", "normalize_faults", "CORRUPT_MODES", "FAULT_PRESETS",
           "parse_faults"]

CORRUPT_MODES = ("nan", "inf")

# Update fault codes (per event, int32): the order encodes precedence when
# probabilities are checked against one uniform draw.
CODE_OK = 0
CODE_DROP = 1
CODE_DUP = 2
CODE_CORRUPT = 3


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Deterministic fault process + guard knobs for one experiment.

    Trace-level (service-time) injection:
      p_crash:      per-completed-task probability a worker goes down
                    (two-state Markov chain over the worker's task index).
      p_rejoin:     per-task probability a down worker comes back
                    (geometric downtime of mean ``1/p_rejoin`` tasks).
      crash_scale:  service-time multiplier while down -- the in-flight
                    task stalls, so the worker produces no event for a long
                    virtual-time stretch and its NEXT completion lands with
                    a large measured staleness (the rejoin spike).
      p_spike:      per-task heavy-tail straggler probability.
      spike_scale / spike_tail:  Pareto spike ``scale * u^(-1/tail)``.

    Update-level injection (per server event):
      p_drop:       update silently lost (no server write).
      p_dup:        update applied twice (one prox/mix step at 2*gamma).
      p_corrupt:    payload poisoned with NaN (``corrupt_mode='nan'``) or
                    Inf before the server consumes it.

    Guards (active whenever a FaultSpec is present, even with all
    injection probabilities zero):
      guard_nonfinite:   reject non-finite payloads (skip-and-count)
                         instead of letting NaN/Inf poison the iterate.
      staleness_cutoff:  reject updates with tau > cutoff (None = off).
      degrade_on_clip:   on horizon overflow (delay beyond the window
                         buffer) fall back to the worst-case-bound step
                         ``gamma' / (tau + 1)`` instead of trusting the
                         silently-truncated window sum.

    ``seed`` keys the fault randomness; it is folded with the per-cell
    seed so solo/batched/sharded runs of the same cell are bitwise equal.
    """

    # trace-level
    p_crash: float = 0.0
    p_rejoin: float = 0.25
    crash_scale: float = 25.0
    p_spike: float = 0.0
    spike_scale: float = 8.0
    spike_tail: float = 1.5
    # update-level
    p_drop: float = 0.0
    p_dup: float = 0.0
    p_corrupt: float = 0.0
    corrupt_mode: str = "nan"
    # guards
    guard_nonfinite: bool = True
    staleness_cutoff: Optional[int] = None
    degrade_on_clip: bool = True
    # randomness / master switch
    seed: int = 0
    enabled: bool = True

    def __post_init__(self):
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"corrupt_mode must be one of {CORRUPT_MODES}, "
                f"got {self.corrupt_mode!r}")
        for name in ("p_crash", "p_rejoin", "p_spike", "p_drop", "p_dup",
                     "p_corrupt"):
            v = getattr(self, name)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"{name} must be a probability, got {v}")
        if self.p_crash > 0.0 and self.p_rejoin <= 0.0:
            raise ValueError("p_crash > 0 requires p_rejoin > 0 "
                             "(a crashed worker must eventually rejoin)")
        if self.staleness_cutoff is not None and int(self.staleness_cutoff) < 0:
            raise ValueError("staleness_cutoff must be >= 0 or None")

    # ------------------------------------------------------------------
    @property
    def injects_traces(self) -> bool:
        """True when service times / round durations get transformed."""
        return self.p_crash > 0.0 or self.p_spike > 0.0

    @property
    def injects_updates(self) -> bool:
        """True when per-event drop/dup/corrupt codes can be nonzero."""
        return self.p_drop > 0.0 or self.p_dup > 0.0 or self.p_corrupt > 0.0

    def replace(self, **kw) -> "FaultSpec":
        return dataclasses.replace(self, **kw)


def normalize_faults(faults: Optional[FaultSpec]) -> Optional[FaultSpec]:
    """Collapse "no faults" to None -- THE switch the bitwise-off contract
    hangs on.  ``None`` and ``FaultSpec(enabled=False)`` both normalize to
    None, and every consumer (solver scans, sweep runners, cache keys)
    branches on ``faults is None`` only."""
    if faults is None:
        return None
    if not isinstance(faults, FaultSpec):
        raise TypeError(f"faults must be a FaultSpec or None, "
                        f"got {type(faults).__name__}")
    return faults if faults.enabled else None


# Named regimes for the CLI (--faults crash) and benchmarks.  Values are
# kwargs over the FaultSpec defaults.
FAULT_PRESETS = {
    # crash/rejoin staleness spikes: rare long outages
    "crash": dict(p_crash=0.05, p_rejoin=0.2, crash_scale=40.0),
    # heavy-tail stragglers, no outright crashes
    "straggler": dict(p_spike=0.1, spike_scale=8.0, spike_tail=1.2),
    # corrupt payloads exercising the non-finite guard
    "corrupt": dict(p_corrupt=0.05),
    # a bit of everything
    "chaos": dict(p_crash=0.03, p_rejoin=0.25, crash_scale=30.0,
                  p_spike=0.05, p_drop=0.02, p_dup=0.02, p_corrupt=0.02),
}


def parse_faults(text: Optional[str]) -> Optional[FaultSpec]:
    """CLI mini-grammar: a preset name, optionally followed by
    ``key=value`` overrides, comma-separated.

        --faults crash
        --faults crash,seed=7,staleness_cutoff=64
        --faults p_drop=0.1,p_corrupt=0.05
    """
    if not text:
        return None
    kw: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            if part not in FAULT_PRESETS:
                raise ValueError(
                    f"unknown fault preset {part!r}; options: "
                    f"{sorted(FAULT_PRESETS)} or key=value pairs")
            kw.update(FAULT_PRESETS[part])
            continue
        key, val = part.split("=", 1)
        key = key.strip()
        fields = {f.name: f for f in dataclasses.fields(FaultSpec)}
        if key not in fields:
            raise ValueError(f"unknown FaultSpec field {key!r}")
        if key == "corrupt_mode":
            kw[key] = val.strip()
        elif key in ("seed",):
            kw[key] = int(val)
        elif key in ("staleness_cutoff",):
            kw[key] = None if val.strip().lower() == "none" else int(val)
        elif key in ("guard_nonfinite", "degrade_on_clip", "enabled"):
            kw[key] = val.strip().lower() in ("1", "true", "yes", "on")
        else:
            kw[key] = float(val)
    return FaultSpec(**kw)
