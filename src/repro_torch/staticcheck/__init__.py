"""Static analysis for the port (`repro_torch.staticcheck`; counterpart of
``repro.staticcheck``).

Three layers, each turning one of the port's prose rules into a machine
check:

* :mod:`repro_torch.staticcheck.lint` / ``rules`` -- the kernel-dispatch
  lint (``python -m repro_torch.staticcheck.lint src/repro_torch``): no
  fallback from a kernel to its plain version, an explicit device on every
  tensor a kernel reads, explicit random generators, no host read of a
  card value on a launch path or in a loop, frozen cache captures.  Each
  rule carries a known-bad fixture under ``staticcheck/fixtures/``; three
  of them are the counterparts of the reference's Pallas fixtures (F1-F3).
* :mod:`repro_torch.staticcheck.optrace` -- the op trace of one call: every
  aten op as a canonical line (torch has no jaxpr; this is the substrate
  the reference's ``jaxpr`` module is), plus the hand-written kernels'
  launches from their wrappers' counters.
* :mod:`repro_torch.staticcheck.contracts` -- off-is-absent (faults and
  telemetry off give the op trace of the program without them), on-is-live
  and engine parity, at scan level and program level.
* :mod:`repro_torch.staticcheck.cachekey` -- cache-key completeness: every
  spec knob that changes a sweep program's op trace must change its
  ``sweep.cache`` key; plus a retrace budget.

``python -m repro_torch.staticcheck`` runs all of them (on the card unless
``--device cpu``); the lint imports no torch and needs no device.  The
submodules load on first use.
"""
import importlib

__all__ = ["optrace", "contracts", "cachekey", "lint", "rules"]


def __getattr__(name):
    if name in __all__:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
