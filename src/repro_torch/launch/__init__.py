"""Drivers (counterpart of ``repro.launch``): ``serve`` (batched
generation), ``train`` (the asynchronous delay-adaptive LM trainer and
the model presets), ``train_bcd`` (Async-BCD over parameter blocks),
``steps`` (the trainer's step), ``sweep`` (the spec-driven sweep CLI,
every backend) and ``report`` (the run ledger's terminal report).
``train_federated`` comes with ROADMAP item 14c; the mesh / sharding
planner and ``run_distributed`` with item 12b; the XLA tooling with item
15."""
