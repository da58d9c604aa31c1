"""Drivers (counterpart of ``repro.launch``): ``serve`` (batched
generation), ``train`` (the asynchronous delay-adaptive LM trainer and
the model presets), ``train_bcd`` (Async-BCD over parameter blocks),
``train_federated`` (FedAsync / FedBuff on the convex problems and on a
transformer preset), ``steps`` (the trainer's step), ``sweep`` (the
spec-driven sweep CLI, every backend), ``report`` (the run ledger's
terminal report), ``run_distributed`` (the trainer with the model sharded
over a ("data", "model") mesh), ``recipes`` (the per-shape knob table),
``mesh`` / ``sharding``, which re-export the production meshes and
the sharding planner of ``repro_torch.mesh``, and the cost tooling:
``dryrun`` (every (arch, shape) step built on ``meta`` and counted),
``op_cost`` (FLOPs and bytes from the aten ops a call runs: the
counterpart of ``hlo_cost``), ``roofline`` (model FLOPs, roofline terms
and the sharded step's moved bytes) and ``perf_probe`` (the top ops of
one step)."""
