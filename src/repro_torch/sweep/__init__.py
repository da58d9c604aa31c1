"""Batched sweeps: policies as tensors, grids of cells, the PIAG,
Async-BCD, FedAsync and FedBuff runners that advance every cell of a
bucket with one kernel launch per event, their sharded twins that cut
the cell axis across the rows of a device mesh (``shard``), and the
cache of built bucket programs (counterpart of ``repro.sweep``).

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
"""
from .cache import clear_program_cache, program_cache_stats
from .grid import (SweepBucket, SweepCell, SweepGrid, make_grid,
                   measure_tau_bar, next_pow2, standard_topologies,
                   standard_topology_factories)
from .policies import (POLICY_IDS, ParamPolicy, PolicyParams, policy_params,
                       stack_params)
from .runners import (make_sweep_bcd, make_sweep_fedasync,
                      make_sweep_fedasync_fused, make_sweep_fedbuff,
                      make_sweep_piag, measure_fed_tau_bar,
                      resolve_grid_horizon, run_bucketed, sweep_bcd,
                      sweep_bcd_logreg, sweep_fedasync,
                      sweep_fedasync_problem, sweep_fedbuff,
                      sweep_fedbuff_problem, sweep_piag, sweep_piag_logreg)
from .shard import (cell_mesh, grid_mesh, make_sharded_sweep_bcd,
                    make_sharded_sweep_piag, mesh_topology, round_robin_pad,
                    shard_cells, sharded_sweep_bcd, sharded_sweep_fedasync,
                    sharded_sweep_fedbuff, sharded_sweep_piag,
                    sharded_sweep_piag_logreg)

__all__ = [
    "SweepBucket", "SweepCell", "SweepGrid", "make_grid", "measure_tau_bar",
    "next_pow2", "standard_topologies", "standard_topology_factories",
    "POLICY_IDS", "ParamPolicy", "PolicyParams", "policy_params",
    "stack_params",
    "clear_program_cache", "program_cache_stats",
    "make_sweep_bcd", "sweep_bcd", "sweep_bcd_logreg",
    "make_sweep_fedasync", "make_sweep_fedasync_fused", "make_sweep_fedbuff",
    "make_sweep_piag", "measure_fed_tau_bar", "resolve_grid_horizon",
    "run_bucketed", "sweep_fedasync", "sweep_fedasync_problem",
    "sweep_fedbuff", "sweep_fedbuff_problem", "sweep_piag",
    "sweep_piag_logreg",
    "cell_mesh", "grid_mesh", "mesh_topology",
    "make_sharded_sweep_bcd", "make_sharded_sweep_piag",
    "round_robin_pad", "shard_cells", "sharded_sweep_bcd",
    "sharded_sweep_fedasync", "sharded_sweep_fedbuff", "sharded_sweep_piag",
    "sharded_sweep_piag_logreg",
]
