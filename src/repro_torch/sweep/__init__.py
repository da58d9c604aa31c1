"""Batched sweeps: policies as tensors, grids of cells, and the PIAG,
FedAsync and FedBuff runners that advance every cell of a bucket with one
kernel launch per event (counterpart of ``repro.sweep``).

Quick taste::

    from repro_torch.core import Adaptive1, Adaptive2, L1, make_logreg
    from repro_torch.sweep import (make_grid, standard_topology_factories,
                                   sweep_piag_logreg)

    prob = make_logreg(800, 100, n_workers=8, seed=0)
    grid = make_grid({"a1": Adaptive1(gamma_prime=0.99 / prob.L),
                      "a2": Adaptive2(gamma_prime=0.99 / prob.L)},
                     seeds=range(8),
                     topologies=standard_topology_factories(),
                     n_events=2000, n_workers=[4, 8])
    res = sweep_piag_logreg(prob, grid, L1(lam=prob.lam1))

Not ported yet (ROADMAP queue A): the Async-BCD runners (item 5), the
program cache (item 6 residue) and the sharded runners (item 12).
"""
from .grid import (SweepBucket, SweepCell, SweepGrid, make_grid,
                   measure_tau_bar, next_pow2, standard_topologies,
                   standard_topology_factories)
from .policies import (POLICY_IDS, ParamPolicy, PolicyParams, policy_params,
                       stack_params)
from .runners import (make_sweep_fedasync, make_sweep_fedasync_fused,
                      make_sweep_fedbuff, make_sweep_piag,
                      measure_fed_tau_bar, resolve_grid_horizon,
                      run_bucketed, sweep_fedasync, sweep_fedasync_problem,
                      sweep_fedbuff, sweep_fedbuff_problem, sweep_piag,
                      sweep_piag_logreg)

__all__ = [
    "SweepBucket", "SweepCell", "SweepGrid", "make_grid", "measure_tau_bar",
    "next_pow2", "standard_topologies", "standard_topology_factories",
    "POLICY_IDS", "ParamPolicy", "PolicyParams", "policy_params",
    "stack_params",
    "make_sweep_fedasync", "make_sweep_fedasync_fused", "make_sweep_fedbuff",
    "make_sweep_piag", "measure_fed_tau_bar", "resolve_grid_horizon",
    "run_bucketed", "sweep_fedasync", "sweep_fedasync_problem",
    "sweep_fedbuff", "sweep_fedbuff_problem", "sweep_piag",
    "sweep_piag_logreg",
]
