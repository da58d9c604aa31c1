"""`repro_torch.api` -- the declarative entry point (counterpart of
``repro.api``).

    from repro_torch import api

    spec = api.ExperimentSpec(
        problem=api.ProblemSpec(kind="logreg",
                                params=dict(n_samples=800, dim=100)),
        solver=api.SolverSpec(name="piag", horizon="auto"),
        topology=api.TopologySpec(kind="standard", n_workers=(4, 8)),
        policies=api.PolicyGridSpec(names=("adaptive1", "adaptive2",
                                           "fixed"), seeds=range(4)),
        execution=api.ExecutionSpec(backend="batched"),
        n_events=1000)
    res = api.run(spec)   # on the CUDA card, one fused kernel launch per event
    res.per_policy()

``ExecutionSpec(device="cpu")`` runs the same spec with the plain PyTorch
versions on the CPU; ``engine="scan"`` runs composed torch ops instead of
the kernel.
"""
from .results import Results
from .run import Resolved, component_spec, resolve, run, run_components
from .spec import (BACKENDS, FIXED_FAMILY, SOLVERS, DelaySpec,
                   ExecutionSpec, ExperimentSpec, PolicyGridSpec,
                   ProblemSpec, SolverSpec, TopologySpec)

__all__ = [
    "ExperimentSpec", "ProblemSpec", "SolverSpec", "TopologySpec",
    "DelaySpec", "PolicyGridSpec", "ExecutionSpec", "Results", "Resolved",
    "run", "resolve", "run_components", "component_spec",
    "SOLVERS", "BACKENDS", "FIXED_FAMILY",
]
