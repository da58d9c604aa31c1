"""The unified results table returned by ``repro_torch.api.run``
(counterpart of ``repro.api.results``).

``Results`` replaces the ad-hoc ``PIAGResult`` / ``BCDResult`` /
``FedResult`` divergence at the API surface with one table of common
columns -- objective trace, step-sizes/weights (``gammas``), delays
(``taus``), horizon-clip counts (``clipped``), wall/virtual time, and cell
coordinates -- while keeping the raw solver tuple available (``raw``) so
comparisons against the underlying runners stay possible.  ``raw`` holds
device tensors; the derived views move what they read to the host.
Solver-specific columns (``opt_residual``, ``versions``) live in
``extras``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Results"]


def _host(a) -> np.ndarray:
    """A result leaf as a host numpy array (device tensors are copied)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class Results:
    """One row per grid cell, one column family per common output.

    Attributes:
      solver / backend: how the spec was dispatched.
      grid:       the resolved ``sweep.SweepGrid`` (cell coordinates).
      raw:        the underlying solver result tuple with a leading cell
                  axis -- EXACTLY what the dispatched runner returned
                  (``PIAGResult`` / ``BCDResult`` / ``FedResult``).
      elapsed_s:  host wall-clock of the dispatched run, to the device's
                  completion.
      tau_bar:    the measured worst-case delay bound, when the resolver
                  computed one (fixed-family tuning / horizon validation).
      spec:       the originating ``ExperimentSpec`` (None for component
                  runs that bypassed the declarative build).
      horizon:    the CONCRETE window-buffer size the run used -- the
                  resolved value when the spec said ``'auto'``.
      record_every: the trace-recording stride s: objective/gammas/taus
                  columns hold rows ``s-1, 2s-1, ...`` of the event
                  trajectory ((B, K // s) leaves).
      telemetry / cache_stats: kept for the reference's shape; None until
                  telemetry is ported (ROADMAP queue A item 9).
    """

    solver: str
    backend: str
    grid: Any
    raw: Any
    elapsed_s: float
    tau_bar: Optional[int] = None
    spec: Any = None
    horizon: Optional[int] = None
    record_every: int = 1
    telemetry: Any = None
    cache_stats: Optional[Dict[str, Any]] = None

    # ------------------------------------------------- common columns ----

    @property
    def cells(self):
        return self.grid.cells

    @property
    def n_cells(self) -> int:
        return len(self.grid.cells)

    @property
    def n_events(self) -> int:
        return int(self.grid.n_events)

    @property
    def n_samples(self) -> int:
        """Recorded samples per cell: n_events // record_every."""
        return self.n_events // int(self.record_every)

    def sample_events(self) -> np.ndarray:
        """(n_samples,) event index of each recorded column: with stride s,
        column j holds event ``j*s + s - 1``."""
        s = int(self.record_every)
        return np.arange(self.n_samples) * s + (s - 1)

    @property
    def objective(self):
        """(B, K // record_every) objective P(x_{k+1}) at recorded events."""
        return self.raw.objective

    @property
    def gammas(self):
        """(B, K) emitted step-sizes (PIAG/BCD) or mixing weights (fed)."""
        return self.raw.weights if "weights" in self.raw._fields \
            else self.raw.gammas

    @property
    def taus(self):
        """(B, K) delay fed to the policy at each event."""
        return self.raw.taus

    @property
    def clipped(self):
        """(B,) events whose delay exceeded the policy horizon (H - 1)."""
        return self.raw.clipped

    @property
    def x(self):
        """Final iterates, leading cell axis."""
        return self.raw.x

    @property
    def extras(self) -> Dict[str, Any]:
        """Solver-specific columns not shared across the four solvers."""
        common = {"x", "objective", "gammas", "taus", "clipped", "telemetry"}
        return {f: getattr(self.raw, f) for f in self.raw._fields
                if f not in common and f != "weights"}

    def labels(self) -> List[str]:
        return self.grid.labels()

    def __len__(self) -> int:
        return self.n_cells

    # ---------------------------------------------------- derived views ----

    def final_objective(self) -> np.ndarray:
        """(B,) final objective per cell."""
        return _host(self.objective)[:, -1]

    def virtual_time(self) -> np.ndarray:
        """(B, K // record_every) simulated wall-clock time of each RECORDED
        event (column j is event ``j*s + s - 1``), recomputed from the
        grid's own pre-sampled randomness with the event race on the
        device of the run (PIAG per bucket, federated per cell)."""
        import torch

        from ..core.engine import trace_scan
        from ..sweep.runners import run_bucketed

        s = int(self.record_every)
        device = self.raw.x.device
        if self.solver in ("fedasync", "fedbuff"):
            from ..federated.events import generate_federated_trace
            bs, n_steps = 1, None
            if self.spec is not None:
                if self.solver == "fedbuff":
                    bs = self.spec.solver.buffer_size
                n_steps = self.spec.solver.n_steps
            return np.stack([generate_federated_trace(
                c.n_workers, self.n_events, clients=list(c.workers),
                buffer_size=bs, seed=c.seed, n_steps=n_steps,
                device=device).t_wall[s - 1::s] for c in self.cells])
        if self.solver != "piag":
            raise NotImplementedError(
                f"virtual_time for solver={self.solver!r} is not ported yet")

        def run_bucket(b):
            T = torch.from_numpy(b.grid.service_times(b.width)).to(device)
            act = None if b.uniform else torch.from_numpy(
                b.grid.active_masks(b.width)).to(device)
            return (trace_scan(T, active=act).t_wall[:, s - 1::s],)

        return _host(run_bucketed(self.grid, run_bucket)[0])

    def to_rows(self) -> List[Dict[str, Any]]:
        """Per-cell records (the JSON shape ``launch.sweep`` emits)."""
        obj = _host(self.objective)
        gam = _host(self.gammas)
        taus = _host(self.taus)
        clipped = _host(self.clipped)
        return [{
            "label": lab,
            "policy": c.policy_name,
            "seed": c.seed,
            "topology": c.topology_name,
            "n_workers": c.n_workers,
            "final_objective": float(obj[i, -1]),
            "sum_gamma": float(gam[i].sum()),
            "max_tau": int(taus[i].max()),
            "clipped": int(clipped[i]),
        } for i, (lab, c) in enumerate(zip(self.labels(), self.cells))]

    # ------------------------------------------------ analysis bridges ----

    def per_policy(self):
        """Per-policy aggregation (see ``analysis``)."""
        from .. import analysis
        return analysis.per_policy_summary(self.cells, self.objective,
                                           self.gammas, self.clipped)

    def clipped_summary(self):
        from .. import analysis
        return analysis.clipped_summary(self.clipped)

    def time_to_tolerance(self, target: float, p_star: float = 0.0):
        """First EVENT index reaching the tolerance (stride-aware: recorded
        column j maps back to event ``j*s + s - 1``; -1 = never)."""
        from .. import analysis
        return analysis.time_to_tolerance(self.objective, target,
                                          p_star=p_star,
                                          record_every=self.record_every)
