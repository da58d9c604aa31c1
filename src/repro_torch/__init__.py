"""`repro_torch` -- the PyTorch/CUDA port of `repro`.

Mirrors `repro`'s subpackage layout and public names
(``repro_torch.core.stepsize.Adaptive1``, ``repro_torch.api.run``, ...).
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``kernels.dispatch``).  On the card the per-event policy
step and solver update (PIAG's prox step, the FedAsync mix, the FedBuff
buffer step) and the prefill attention of the serving path are
hand-written CUDA kernels (``kernels.fused_step``,
``kernels.flash_attention``).  The package imports ``torch`` and numpy,
never ``jax`` or ``repro``.

Subpackages are imported lazily (PEP 562), as in ``repro``, so
``import repro_torch`` stays light and ``repro_torch.api`` works after it.
"""
import importlib

__all__ = ["api", "analysis", "core", "federated", "sweep", "models",
           "kernels", "serving", "configs", "launch", "interop",
           "telemetry", "faults", "checkpoint", "optim", "data", "mesh",
           "staticcheck"]


def __getattr__(name):
    if name in __all__:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
