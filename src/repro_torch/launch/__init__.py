"""Drivers (counterpart of ``repro.launch``): ``serve`` (batched
generation), ``train`` (the asynchronous delay-adaptive LM trainer and
the model presets), ``train_bcd`` (Async-BCD over parameter blocks) and
``steps`` (the trainer's step).  ``train_federated`` and the other CLIs
come with ROADMAP item 14c; the XLA tooling with item 15."""
