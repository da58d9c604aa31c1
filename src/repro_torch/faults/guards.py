"""In-loop guards: reject, degrade, count (counterpart of
``repro.faults.guards``).

The solver loops call these helpers per event when a ``FaultSpec`` is
present, for all B cells at once:

* :func:`poison` and :func:`finite_of` -- the update payload after
  update-level corruption, and its finiteness as the guard sees it;
* :func:`guard_event` -- given the event's fault code, payload finiteness
  and delay, decide acceptance and the step multiplier (0 = skip, 1 =
  normal, 2 = duplicated update);
* :func:`guarded_gamma` -- compute gamma WITHOUT pushing (the policy's
  ``_gamma_total`` split), degrade on horizon overflow (fall back to the
  worst-case-bound ``gamma' / (tau + 1)`` instead of trusting a silently
  truncated window sum), scale by the multiplier, and push ONCE.

Counters ride the loop carry as a :class:`FaultState` (int32, one entry
per cell), the last leaf of the solver's own carry, and are summed over
cells on the host by :func:`summarize_faults`.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from .inject import corrupt_value
from .spec import (CODE_CORRUPT, CODE_DROP, CODE_DUP, FaultSpec,
                   normalize_faults)

__all__ = ["FaultState", "init_faults", "guard_event", "guarded_gamma",
           "payload_finite", "summarize_faults", "fault_gamma_prime"]


class FaultState(NamedTuple):
    """Per-cell fault counters (int32, leading cell axis) riding the loop
    carry; the reference's field names and order."""

    injected: torch.Tensor            # corrupt codes seen (payload poisoned)
    dropped: torch.Tensor             # drop codes seen (update lost)
    duplicated: torch.Tensor          # dup codes applied (2*gamma steps)
    rejected_nonfinite: torch.Tensor  # guard: non-finite payload skipped
    rejected_stale: torch.Tensor      # guard: tau > staleness_cutoff skipped
    degraded: torch.Tensor            # guard: worst-case-bound gamma fallback


def init_faults(batch_shape=(), device=None) -> FaultState:
    """Zero counters of ``batch_shape`` (the cells) on ``device`` (the
    card unless the caller names the CPU)."""
    dev = resolve_device(device)
    return FaultState(*(torch.zeros(tuple(batch_shape), dtype=torch.int32,
                                    device=dev) for _ in range(6)))


def check_faults(faults, fault_codes, engine: str):
    """Normalize ``faults`` and refuse what the guarded step cannot run:
    the fused engine (as the reference does) and missing event codes."""
    faults = normalize_faults(faults)
    if faults is not None:
        if engine == "fused":
            raise TypeError("engine='fused' does not support fault "
                            "injection; use engine='scan'")
        if fault_codes is None:
            raise ValueError("faults is set but fault_codes is None; build "
                             "the event codes with "
                             "repro_torch.faults.update_fault_codes")
    return faults


def poison(x: torch.Tensor, code: torch.Tensor, spec: FaultSpec
           ) -> torch.Tensor:
    """The update payload ``x`` (B, ...) after update-level corruption:
    ``x + poison`` on the cells whose event code is corrupt, ``x + 0``
    elsewhere."""
    p = corrupt_value(spec, x.device)
    add = torch.where(code == CODE_CORRUPT, p, torch.zeros_like(p))
    return x + add.reshape((-1,) + (1,) * (x.ndim - 1))


def payload_finite(x: torch.Tensor) -> torch.Tensor:
    """(B,) bool: every element of cell b's update payload is finite (the
    payload leads with the cell axis)."""
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


def finite_of(x: torch.Tensor, spec: FaultSpec) -> torch.Tensor:
    """(B,) payload finiteness as the guard sees it (all True with the
    non-finite guard off)."""
    if spec.guard_nonfinite:
        return payload_finite(x)
    return torch.ones(x.shape[0], dtype=torch.bool, device=x.device)


def guard_event(spec: FaultSpec, code, tau, finite, fs: FaultState
                ) -> Tuple[torch.Tensor, torch.Tensor, FaultState]:
    """Acceptance decision for one event of every cell.

    Returns ``(accept, mult, fs)``: ``accept`` bool (apply a server write
    at all), ``mult`` float32 in {0, 1, 2} (step multiplier), and the
    advanced counters.  ``finite`` is the payload finiteness AFTER
    corruption; with ``guard_nonfinite`` off, non-finite payloads pass
    through (NaN then propagates, the failure the guard exists to
    prevent)."""
    dev = fs.injected.device
    code = torch.as_tensor(code, dtype=torch.int32, device=dev)
    finite = torch.as_tensor(finite, dtype=torch.bool, device=dev)
    is_drop = code == CODE_DROP
    is_dup = code == CODE_DUP
    is_corrupt = code == CODE_CORRUPT

    finite_ok = finite if spec.guard_nonfinite else torch.ones_like(finite)
    if spec.staleness_cutoff is not None:
        tau = torch.as_tensor(tau, dtype=torch.int32, device=dev)
        fresh = tau <= int(spec.staleness_cutoff)
    else:
        fresh = torch.ones_like(finite)

    accept = ~is_drop & finite_ok & fresh
    one = torch.ones((), dtype=torch.float32, device=dev)
    mult = torch.where(accept, torch.where(is_dup, one + one, one),
                       torch.zeros_like(one))

    def count(flag):
        return flag.to(torch.int32)

    fs = FaultState(
        injected=fs.injected + count(is_corrupt),
        dropped=fs.dropped + count(is_drop),
        duplicated=fs.duplicated + count(is_dup & accept),
        rejected_nonfinite=fs.rejected_nonfinite
        + count(~is_drop & ~finite_ok),
        rejected_stale=fs.rejected_stale
        + count(~is_drop & finite_ok & ~fresh),
        degraded=fs.degraded,
    )
    return accept, mult, fs


def fault_gamma_prime(policy, like: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The policy's gamma' as float32: the (B,) params field of a
    ``ParamPolicy``, else the concrete dataclass's float (on ``like``'s
    device, else on the card)."""
    params = getattr(policy, "params", None)
    if params is not None:
        return params.gamma_prime.to(torch.float32)
    dev = resolve_device() if like is None else like.device
    return torch.tensor(np.float32(policy.gamma_prime), device=dev)


def guarded_gamma(policy, ss, tau, mult, spec: FaultSpec, fs: FaultState
                  ) -> Tuple[torch.Tensor, Any, FaultState]:
    """Gamma with guards, pushed once.

    Splits the policy step via ``_gamma_total`` (every sweep-able policy
    has one; ``AdaptiveLipschitz`` does not and is refused), then:

    * horizon overflow (``was_clipped``): with ``degrade_on_clip``, fall
      back to the worst-case-bound step ``gamma' / (tau + 1)`` -- the
      FixedStepSize rule at the OBSERVED delay;
    * scale by ``mult`` (0 skip / 1 normal / 2 duplicate) -- the scaled
      gamma is what enters the cumulative window buffer.

    The push is the plain sum ``total + gamma_eff``: the reference's
    program pushes the product ``gamma * mult`` after a select, and since
    ``mult`` is 0, 1 or 2 that product is exact, so no family's contracted
    push (``fma32(a, b, total)`` of the fault-free step) applies here.
    Returns ``(gamma_eff, new_ss, fs)``."""
    from ..core.stepsize import _as_tau, _push

    gamma_fn = getattr(policy, "_gamma_total", None)
    if gamma_fn is None:
        raise TypeError(
            f"{type(policy).__name__} exposes no _gamma split; fault guards "
            "cannot intercept its step (use a window/fixed-family policy, "
            "or run without faults)")
    gamma, was_clipped, _ = gamma_fn(ss, tau)
    gamma = gamma.to(torch.float32).expand(ss.k.shape)
    if spec.degrade_on_clip:
        clipped_b = was_clipped > 0
        t = _as_tau(tau, ss.k).to(torch.float32)
        fallback = fault_gamma_prime(policy, ss.total) / (t + 1.0)
        gamma = torch.where(clipped_b, fallback, gamma)
        fs = fs._replace(degraded=fs.degraded + clipped_b.to(torch.int32))
    gamma_eff = gamma * mult
    return gamma_eff, _push(ss, gamma_eff, was_clipped), fs


def summarize_faults(fs) -> dict:
    """Host-side dict of totals (summed over any leading cell axes)."""
    if fs is None:
        return {}

    def total(v):
        if isinstance(v, torch.Tensor):
            return int(v.sum())
        return int(np.asarray(v).sum())

    return {name: total(getattr(fs, name)) for name in FaultState._fields}
