"""Core library: step-size policies, prox operators, problems, the event
engine, PIAG and Async-BCD (counterparts of ``repro.core`` modules of the
same name).

Public API (the ported part of ``repro.core``'s)::

    from repro_torch.core import (
        make_policy, Adaptive1, Adaptive2, FixedStepSize, NaiveAdaptive,
        make_prox, run_piag, run_async_bcd, simulate_parameter_server,
        simulate_shared_memory, make_logreg,
    )

Not ported yet (ROADMAP queue A item 13): ``delay``, ``runtime``,
``async_sgd``, ``theory``, ``Quadratic`` and ``run_piag_lipschitz``.
"""
from .bcd import (BCDResult, bcd_scan, run_async_bcd, run_bcd_logreg,
                  sample_blocks)
from .engine import (EventHeap, EventTrace, TraceArrays, WorkerModel,
                     generate_trace, heterogeneous_workers,
                     sample_service_times, simulate_parameter_server,
                     simulate_shared_memory, trace_scan)
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
    "BCDResult", "bcd_scan", "run_async_bcd", "run_bcd_logreg",
    "sample_blocks",
    "EventHeap", "EventTrace", "TraceArrays", "WorkerModel",
    "generate_trace", "heterogeneous_workers", "sample_service_times",
    "simulate_parameter_server", "simulate_shared_memory", "trace_scan",
    "PIAGResult", "piag_scan", "run_piag", "run_piag_logreg",
    "LassoProblem", "LogRegProblem", "make_lasso", "make_logreg",
    "solve_centralized",
    "PROX_OPS", "Box", "ElasticNet", "GroupL2", "L1", "L2Squared", "ProxOp",
    "Zero", "make_prox",
    "POLICIES", "Adaptive1", "Adaptive2", "AdaptiveLipschitz", "DavisFixed",
    "FixedStepSize", "HingeWeight", "NaiveAdaptive", "PolyWeight",
    "StepsizePolicy", "StepsizeState", "SunDengFixed", "init_state",
    "make_policy", "window_sum",
    "bcd", "engine", "piag", "problems", "prox", "stepsize",
]
