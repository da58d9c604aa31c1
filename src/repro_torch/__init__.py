"""`repro_torch` -- the PyTorch/CUDA port of `repro`.

Mirrors `repro`'s subpackage layout and public names
(``repro_torch.core.stepsize.Adaptive1``, ``repro_torch.api.run``, ...).
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``kernels.dispatch``); on the card the per-event policy +
prox step is a hand-written CUDA kernel (``kernels.fused_step``).  The
package imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
