"""In-scan metric accumulators (counterpart of
``repro.telemetry.accumulators``).

Aggregate statistics that ride in the solver loops' carries: a
fixed-bucket delay histogram, running min/max and Welford mean/M2 moments
of the delay tau and of the emitted step-size gamma, and a
per-recording-window horizon-clip counter.  The accumulator observes EVERY
event -- silent decimated steps included (``core.engine.strided_scan``) --
so the aggregates are exact under ``record_every=s``.

Every leaf leads with the B cells of the loop, as the solver carries do;
the histogram is a (B, bins) int32 ``scatter_add``.  The moments of tau
and gamma sit side by side in one (B, 2) tensor, so each event updates
both with one ``fma32``: the reference's compiled program contracts
``m2 + d*(v - mean)`` into an FMA.

Bitwise neutrality: nothing here feeds back into a solver value, so the
solver outputs with telemetry on are bitwise those with it off.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.stepsize import fma32

__all__ = ["TelemetryConfig", "TelemetryState", "DelayTelemetry",
           "init_telemetry", "observe", "emit_window", "finalize",
           "summarize_telemetry"]

_I32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static accumulator configuration (hashable: it rides the program
    cache keys of ``sweep.cache``).

    ``delay_bins``: histogram buckets.  Bin ``i < delay_bins - 1`` counts
    events with ``tau == i``; the LAST bin is the overflow bucket counting
    every ``tau >= delay_bins - 1``, so the histogram always sums to the
    event count.
    """

    delay_bins: int = 64

    def __post_init__(self):
        if self.delay_bins < 2:
            raise ValueError(
                f"delay_bins must be >= 2, got {self.delay_bins}")


class TelemetryState(NamedTuple):
    """The in-carry accumulator of B cells.  ``mean`` and ``m2`` hold the
    Welford moments of tau (column 0) and gamma (column 1)."""

    hist: torch.Tensor      # (B, delay_bins) int32 delay histogram
    count: torch.Tensor     # (B,) int32 events observed
    tau_min: torch.Tensor   # (B,) int32 (INT32_MAX before any event)
    tau_max: torch.Tensor   # (B,) int32 (-1 before any event)
    mean: torch.Tensor      # (B, 2) float32 running means of tau, gamma
    m2: torch.Tensor        # (B, 2) float32 sums of squared deviations
    g_min: torch.Tensor     # (B,) float32 (+inf before any event)
    g_max: torch.Tensor     # (B,) float32 (-inf before any event)
    win_clip: torch.Tensor  # (B,) int32 horizon clips since the last emit

    @property
    def tau_mean(self) -> torch.Tensor:
        return self.mean[..., 0]

    @property
    def tau_m2(self) -> torch.Tensor:
        return self.m2[..., 0]

    @property
    def g_mean(self) -> torch.Tensor:
        return self.mean[..., 1]

    @property
    def g_m2(self) -> torch.Tensor:
        return self.m2[..., 1]


class DelayTelemetry(NamedTuple):
    """Finalized per-cell aggregates on a solver result's ``telemetry``
    field, each leaf with the leading cell axis.  ``window_clips`` is
    (B, K // s): entry j counts the horizon-clipped delays of the window
    ending at recorded event ``j*s + s - 1``."""

    hist: torch.Tensor
    count: torch.Tensor
    tau_min: torch.Tensor
    tau_max: torch.Tensor
    tau_mean: torch.Tensor
    tau_m2: torch.Tensor
    gamma_min: torch.Tensor
    gamma_max: torch.Tensor
    gamma_mean: torch.Tensor
    gamma_m2: torch.Tensor
    window_clips: torch.Tensor


def init_telemetry(cfg: TelemetryConfig, batch_shape=(),
                   device=None) -> TelemetryState:
    """A fresh accumulator for ``batch_shape`` cells on ``device``."""
    shape = tuple(batch_shape)
    i32, f32 = torch.int32, torch.float32

    def full(value, dtype, extra=()):
        return torch.full(shape + extra, value, dtype=dtype, device=device)

    return TelemetryState(
        hist=full(0, i32, (cfg.delay_bins,)), count=full(0, i32),
        tau_min=full(_I32_MAX, i32), tau_max=full(-1, i32),
        mean=full(0.0, f32, (2,)), m2=full(0.0, f32, (2,)),
        g_min=full(float("inf"), f32), g_max=full(float("-inf"), f32),
        win_clip=full(0, i32))


def observe(state: TelemetryState, tau: torch.Tensor, gamma: torch.Tensor,
            was_clipped: torch.Tensor) -> TelemetryState:
    """Fold one event of every cell into the accumulator: ``tau`` (B,)
    int, ``gamma`` (B,) float32, ``was_clipped`` (B,) int, the delta of the
    policy state's ``clipped`` counter across the step."""
    tau = tau.to(torch.int32)
    v = torch.stack((tau.to(torch.float32), gamma), dim=-1)
    count = state.count + 1
    d = v - state.mean
    mean = state.mean + d / count.to(torch.float32).unsqueeze(-1)
    bins = state.hist.shape[-1]
    idx = torch.clamp(tau, max=bins - 1).to(torch.int64).unsqueeze(-1)
    return TelemetryState(
        hist=state.hist.scatter_add(-1, idx, torch.ones_like(state.hist[..., :1])),
        count=count,
        tau_min=torch.minimum(state.tau_min, tau),
        tau_max=torch.maximum(state.tau_max, tau),
        mean=mean,
        m2=fma32(d, v - mean, state.m2),
        g_min=torch.minimum(state.g_min, gamma),
        g_max=torch.maximum(state.g_max, gamma),
        win_clip=state.win_clip + was_clipped.to(torch.int32))


def emit_window(state: TelemetryState
                ) -> Tuple[TelemetryState, torch.Tensor]:
    """Close the recording window: the clips since the previous emit
    (B,), and the state with the window counter reset."""
    return (state._replace(win_clip=torch.zeros_like(state.win_clip)),
            state.win_clip)


def finalize(state: TelemetryState,
             window_clips: torch.Tensor) -> DelayTelemetry:
    """The final carry plus the (B, K // s) window-clip column as the
    result-side ``DelayTelemetry``."""
    return DelayTelemetry(
        hist=state.hist, count=state.count,
        tau_min=state.tau_min, tau_max=state.tau_max,
        tau_mean=state.tau_mean.contiguous(),
        tau_m2=state.tau_m2.contiguous(),
        gamma_min=state.g_min, gamma_max=state.g_max,
        gamma_mean=state.g_mean.contiguous(),
        gamma_m2=state.g_m2.contiguous(),
        window_clips=window_clips)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def summarize_telemetry(tel: DelayTelemetry) -> dict:
    """Host-side merge of a (cell-batched) ``DelayTelemetry`` into one
    aggregate dict: histograms sum, min/max reduce, and the Welford
    moments combine with the parallel update (exact mean and std, not
    means of means)."""
    hist = _host(tel.hist)
    hist = hist.reshape(-1, hist.shape[-1])
    counts = _host(tel.count).astype(np.float64).reshape(-1)
    total = counts.sum()

    def merge_moments(means, m2s):
        means = _host(means).astype(np.float64).reshape(-1)
        m2s = _host(m2s).astype(np.float64).reshape(-1)
        if total <= 0:
            return 0.0, 0.0
        mean = float((counts * means).sum() / total)
        m2 = float(m2s.sum() + (counts * (means - mean) ** 2).sum())
        return mean, float(np.sqrt(m2 / total))

    tau_mean, tau_std = merge_moments(tel.tau_mean, tel.tau_m2)
    g_mean, g_std = merge_moments(tel.gamma_mean, tel.gamma_m2)
    wc = _host(tel.window_clips)
    return {
        "count": int(total),
        "hist": hist.sum(axis=0).astype(np.int64).tolist(),
        "tau": {"min": int(_host(tel.tau_min).min()),
                "max": int(_host(tel.tau_max).max()),
                "mean": tau_mean, "std": tau_std},
        "gamma": {"min": float(_host(tel.gamma_min).min()),
                  "max": float(_host(tel.gamma_max).max()),
                  "mean": g_mean, "std": g_std},
        "window_clips": {"total": int(wc.sum()),
                         "max": int(wc.max()) if wc.size else 0,
                         "windows_clipped": int((wc > 0).sum())},
    }
