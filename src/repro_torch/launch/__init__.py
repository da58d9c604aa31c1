"""Drivers (counterpart of ``repro.launch``): ``serve`` (batched
generation), ``train`` (the asynchronous delay-adaptive LM trainer and
the model presets), ``train_bcd`` (Async-BCD over parameter blocks),
``train_federated`` (FedAsync / FedBuff on the convex problems and on a
transformer preset), ``steps`` (the trainer's step), ``sweep`` (the
spec-driven sweep CLI, every backend), ``report`` (the run ledger's
terminal report), ``run_distributed`` (the trainer with the model sharded
over a ("data", "model") mesh), ``recipes`` (the per-shape knob table),
and ``mesh`` / ``sharding``, which re-export the production meshes and
the sharding planner of ``repro_torch.mesh``.  The dry-run, cost,
roofline and probe tooling is ROADMAP item 15's remainder (its
static-analysis half is ``repro_torch.staticcheck``)."""
