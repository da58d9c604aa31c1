"""Fault injection and resilience (counterpart of ``repro.faults``).

Chaos-testing layer for the delay-adaptive solvers: deterministic fault
processes (crash/rejoin staleness spikes, heavy-tail stragglers, dropped /
duplicated / corrupted updates) injected into the event races and the
solver loops, drawn from the reference's threefry bits, plus in-loop guards
(non-finite rejection, staleness cutoff, horizon-overflow degradation)
with counters riding the loop carry.

``faults=None`` -- or a spec normalized away by :func:`normalize_faults` --
runs the solver loops' fault-free step bodies, and a ``FaultSpec`` rides
every program-cache key.  The fused engine refuses faults, as in the
reference: a faulted run sets ``engine='scan'``.
"""
from .spec import FAULT_PRESETS, FaultSpec, normalize_faults, parse_faults
from .inject import (corrupt_value, inject_client_rounds,
                     inject_service_times, update_fault_codes)
from .guards import (FaultState, fault_gamma_prime, guard_event,
                     guarded_gamma, init_faults, payload_finite,
                     summarize_faults)

__all__ = [
    "FaultSpec", "normalize_faults", "parse_faults", "FAULT_PRESETS",
    "inject_service_times", "inject_client_rounds", "update_fault_codes",
    "corrupt_value",
    "FaultState", "init_faults", "guard_event", "guarded_gamma",
    "payload_finite", "fault_gamma_prime", "summarize_faults",
]
