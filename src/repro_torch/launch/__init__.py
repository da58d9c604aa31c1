"""Drivers (counterpart of ``repro.launch``): ``serve`` (batched
generation), ``train`` (the asynchronous delay-adaptive LM trainer and
the model presets), ``train_bcd`` (Async-BCD over parameter blocks),
``train_federated`` (FedAsync / FedBuff on the convex problems and on a
transformer preset), ``steps`` (the trainer's step), ``sweep`` (the
spec-driven sweep CLI, every backend) and ``report`` (the run ledger's
terminal report).  The mesh / sharding planner and ``run_distributed``
come with ROADMAP item 12b; the XLA tooling with item 15."""
