"""Drivers (counterpart of ``repro.launch``): ``serve`` (batched
generation) and the model presets of ``train``.  The trainers and the
other CLIs come with ROADMAP item 14c; the XLA tooling with item 15."""
