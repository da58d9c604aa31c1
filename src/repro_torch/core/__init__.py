"""Core library: step-size policies, prox operators, problems, the event
engine and PIAG (counterparts of ``repro.core`` modules of the same name).

Public API (the ported part of ``repro.core``'s)::

    from repro_torch.core import (
        make_policy, Adaptive1, Adaptive2, FixedStepSize, NaiveAdaptive,
        make_prox, run_piag, simulate_parameter_server, make_logreg,
    )

Not ported yet (ROADMAP queue A): Async-BCD (item 5), ``delay``,
``runtime``, ``async_sgd``, ``theory``, ``Quadratic`` and
``run_piag_lipschitz`` (item 13), ``simulate_shared_memory`` (item 5).
"""
from .engine import (EventHeap, EventTrace, TraceArrays, WorkerModel,
                     generate_trace, heterogeneous_workers,
                     sample_service_times, simulate_parameter_server,
                     trace_scan)
from .piag import PIAGResult, piag_scan, run_piag, run_piag_logreg
from .problems import (LassoProblem, LogRegProblem, make_lasso, make_logreg,
                       solve_centralized)
from .prox import (PROX_OPS, Box, ElasticNet, GroupL2, L1, L2Squared, ProxOp,
                   Zero, make_prox)
from .stepsize import (POLICIES, Adaptive1, Adaptive2, AdaptiveLipschitz,
                       DavisFixed, FixedStepSize, HingeWeight, NaiveAdaptive,
                       PolyWeight, StepsizePolicy, StepsizeState,
                       SunDengFixed, init_state, make_policy, window_sum)

__all__ = [
    "EventHeap", "EventTrace", "TraceArrays", "WorkerModel",
    "generate_trace", "heterogeneous_workers", "sample_service_times",
    "simulate_parameter_server", "trace_scan",
    "PIAGResult", "piag_scan", "run_piag", "run_piag_logreg",
    "LassoProblem", "LogRegProblem", "make_lasso", "make_logreg",
    "solve_centralized",
    "PROX_OPS", "Box", "ElasticNet", "GroupL2", "L1", "L2Squared", "ProxOp",
    "Zero", "make_prox",
    "POLICIES", "Adaptive1", "Adaptive2", "AdaptiveLipschitz", "DavisFixed",
    "FixedStepSize", "HingeWeight", "NaiveAdaptive", "PolyWeight",
    "StepsizePolicy", "StepsizeState", "SunDengFixed", "init_state",
    "make_policy", "window_sum",
    "engine", "piag", "problems", "prox", "stepsize",
]
