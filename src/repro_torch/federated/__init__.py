"""Delay-adaptive asynchronous federated learning (counterpart of
``repro.federated``).

* ``events`` -- round-trip client simulation (local epochs, upload jitter,
  dropout/rejoin): the heapq reference ``simulate_federated`` and the
  device race ``federated_trace_scan``, bitwise-equal on the same
  pre-sampled ``ClientRounds``.
* ``server`` -- FedAsync staleness-weighted mixing and FedBuff buffered
  aggregation over B cells at once; under ``engine='fused'`` each upload
  event is one launch of a hand-written CUDA kernel.
"""
from .events import (ClientModel, ClientRounds, FederatedTrace,
                     FederatedTraceArrays, client_arrays, default_fed_steps,
                     federated_trace_scan, generate_federated_trace,
                     heterogeneous_clients, sample_client_rounds,
                     simulate_federated)
from .server import (FedResult, fedasync_scan, fedbuff_scan, local_prox_sgd,
                     run_fedasync, run_fedasync_problem, run_fedbuff,
                     run_fedbuff_problem)

__all__ = [
    "ClientModel", "ClientRounds", "FederatedTrace", "FederatedTraceArrays",
    "client_arrays", "default_fed_steps", "federated_trace_scan",
    "generate_federated_trace", "heterogeneous_clients",
    "sample_client_rounds", "simulate_federated", "FedResult",
    "fedasync_scan", "fedbuff_scan", "local_prox_sgd", "run_fedasync",
    "run_fedasync_problem", "run_fedbuff", "run_fedbuff_problem",
]
