"""Sweep grids: the cartesian product of policies x seeds x topologies
(x worker counts) (counterpart of ``repro.sweep.grid``).

A ``SweepGrid`` is a flat list of cells, each pinning one policy instance,
one seed and one worker topology.  It materializes the batched inputs the
runners consume: a stacked (B, width, K+1) service-time array and (B,)
``PolicyParams``.  Ragged worker counts are bucketed: each cell is padded
to its bucket's width (next power of two, capped at the widest cell) with
``+inf`` service times, and an ``active`` mask keeps padded workers out of
the event race, out of ``tau_max`` and out of the gradient mean, so a
bucketed cell is the same computation as its exact-width run.  A cell with
``w`` workers uses the first ``w`` shards of the shared worker data.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import (WorkerModel, heterogeneous_workers,
                           sample_service_times, trace_scan)
from ..core.stepsize import StepsizePolicy, next_pow2
from ..kernels.dispatch import resolve_device
from .policies import PolicyParams, stack_params

__all__ = ["SweepCell", "SweepGrid", "SweepBucket", "make_grid",
           "measure_tau_bar", "next_pow2", "standard_topologies",
           "standard_topology_factories"]


def _max_tau_max(Ts: np.ndarray, device) -> int:
    """Largest ``tau_max`` over the traces of a stack of service-time
    matrices, with the event race run on ``device``."""
    T = torch.from_numpy(Ts).to(resolve_device(device))
    return int(trace_scan(T).tau_max.max())


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid cell: (policy, seed, topology)."""

    policy_name: str
    policy: StepsizePolicy
    seed: int
    topology_name: str
    workers: Tuple = ()

    @property
    def n_workers(self) -> int:
        return len(self.workers)


class SweepBucket(NamedTuple):
    """One rectangular slice of a (possibly ragged) grid: the padded
    ``width``, the cells' positions ``index`` in the parent grid, and the
    sub-``grid`` of exactly those cells."""

    width: int
    index: np.ndarray
    grid: "SweepGrid"

    @property
    def uniform(self) -> bool:
        """True iff no cell needs padding (runners then pass no mask)."""
        return all(c.n_workers == self.width for c in self.grid.cells)


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """A flat batch of sweep cells plus the shared event count."""

    cells: Tuple[SweepCell, ...]
    n_events: int

    def __len__(self) -> int:
        return len(self.cells)

    def measure_tau_bar(self, device=None) -> int:
        """Worst-case trace delay over the grid's own (topology, seed)
        cells, measured per worker-count group on ``device``."""
        seen = {}
        for c in self.cells:
            seen.setdefault((c.topology_name, c.seed), c)
        by_width: Dict[int, list] = {}
        for c in seen.values():
            by_width.setdefault(c.n_workers, []).append(c)
        worst = 0
        for cs in by_width.values():
            Ts = np.stack([sample_service_times(c.workers, self.n_events + 1,
                                                seed=c.seed) for c in cs])
            worst = max(worst, _max_tau_max(Ts, device))
        return worst

    @property
    def is_ragged(self) -> bool:
        return len({c.n_workers for c in self.cells}) > 1

    @property
    def n_workers(self) -> int:
        ns = {c.n_workers for c in self.cells}
        if len(ns) > 1:
            raise ValueError(
                f"ragged grid (worker counts {sorted(ns)}); use "
                "n_workers_max or iterate buckets()")
        return next(iter(ns))

    @property
    def n_workers_max(self) -> int:
        return max(c.n_workers for c in self.cells)

    def subset(self, index: Sequence[int]) -> "SweepGrid":
        return SweepGrid(cells=tuple(self.cells[int(i)] for i in index),
                         n_events=self.n_events)

    def buckets(self, bucket_widths: Optional[Sequence[int]] = None
                ) -> Tuple[SweepBucket, ...]:
        """Group cells into rectangular buckets by padded worker count
        (each cell lands in the smallest width >= its worker count).
        Default: one exact-width bucket for a homogeneous grid; for a
        ragged one, next power of two capped at the widest cell."""
        if bucket_widths is None:
            if not self.is_ragged:
                widths = [self.n_workers_max]
            else:
                widths = sorted({min(next_pow2(c.n_workers),
                                     self.n_workers_max)
                                 for c in self.cells})
        else:
            widths = sorted(int(w) for w in bucket_widths)
        out = []
        for w in widths:
            idx = np.asarray([i for i, c in enumerate(self.cells)
                              if c.n_workers <= w
                              and not any(c.n_workers <= v for v in widths
                                          if v < w)], np.int64)
            if idx.size:
                out.append(SweepBucket(width=w, index=idx,
                                       grid=self.subset(idx)))
        placed = sum(b.index.size for b in out)
        if placed != len(self.cells):
            big = max(c.n_workers for c in self.cells)
            raise ValueError(
                f"bucket_widths {widths} cannot hold all cells "
                f"(max worker count {big})")
        return tuple(out)

    def policy_params(self, device=None) -> PolicyParams:
        """Stacked (B,) ``PolicyParams`` on ``device``."""
        return stack_params([c.policy for c in self.cells], device)

    def service_times(self, width: Optional[int] = None) -> np.ndarray:
        """(B, width, n_events + 1) float32, one matrix per cell from the
        cell's seed; padded rows are ``+inf``."""
        w = self.n_workers if width is None else int(width)
        out = np.full((len(self.cells), w, self.n_events + 1), np.inf,
                      np.float32)
        for i, c in enumerate(self.cells):
            if c.n_workers > w:
                raise ValueError(
                    f"cell {i} has {c.n_workers} workers > width {w}")
            out[i, :c.n_workers] = sample_service_times(
                c.workers, self.n_events + 1, seed=c.seed)
        return out

    def active_masks(self, width: Optional[int] = None) -> np.ndarray:
        """(B, width) bool: True where a worker row is real."""
        w = self.n_workers if width is None else int(width)
        return np.asarray([
            np.arange(w) < c.n_workers for c in self.cells])

    def labels(self) -> List[str]:
        return [f"{c.policy_name}/s{c.seed}/{c.topology_name}"
                for c in self.cells]


def standard_topologies(n_workers: int, seed: int = 0) -> Dict[str, list]:
    """The four worker regimes of the paper's figures: homogeneous, mildly
    and strongly heterogeneous speeds, and straggler-dominated."""
    return {name: factory(n_workers)
            for name, factory in standard_topology_factories(seed).items()}


def standard_topology_factories(seed: int = 0) -> Dict[str, Callable]:
    """The four regimes as width -> worker-list factories."""
    return {
        "uniform": lambda n: [WorkerModel() for _ in range(n)],
        "hetero2": lambda n: heterogeneous_workers(n, spread=2.0, seed=seed),
        "hetero4": lambda n: heterogeneous_workers(n, spread=4.0,
                                                   seed=seed + 1),
        "straggler": lambda n: [WorkerModel(mean=1.0, p_straggle=0.1,
                                            straggle_x=12.0)
                                for _ in range(n)],
    }


def measure_tau_bar(topologies: Dict[str, Sequence], seeds: Sequence[int],
                    n_events: int, device=None) -> int:
    """The worst-case delay bound tau-bar over every (topology, seed) trace
    of a prospective grid, one batched event race per worker count."""
    by_width: Dict[int, list] = {}
    for ws in topologies.values():
        by_width.setdefault(len(ws), []).append(ws)
    worst = 0
    for groups in by_width.values():
        Ts = np.stack([
            sample_service_times(ws, n_events + 1, seed=int(s))
            for ws in groups for s in seeds])
        worst = max(worst, _max_tau_max(Ts, device))
    return worst


def make_grid(policies: Dict[str, StepsizePolicy],
              seeds: Sequence[int],
              topologies: Dict[str, Sequence],
              n_events: int,
              n_workers: Optional[Sequence[int]] = None) -> SweepGrid:
    """Cartesian product in deterministic (policy, seed, topology[, width])
    order; with ``n_workers``, topology values are width -> workers
    factories and each (topology, width) becomes ``{name}/w{width}``."""
    if n_workers is None:
        topo_items = [(tn, tuple(ws)) for tn, ws in topologies.items()]
    else:
        topo_items = []
        for tn, factory in topologies.items():
            if not callable(factory):
                raise TypeError(
                    f"topology {tn!r} must be a width -> workers factory "
                    "when n_workers is given (got a concrete sequence)")
            for w in n_workers:
                topo_items.append((f"{tn}/w{int(w)}",
                                   tuple(factory(int(w)))))
    cells = tuple(
        SweepCell(policy_name=pn, policy=pol, seed=int(s),
                  topology_name=tn, workers=ws)
        for (pn, pol), s, (tn, ws) in itertools.product(
            policies.items(), seeds, topo_items))
    return SweepGrid(cells=cells, n_events=n_events)
