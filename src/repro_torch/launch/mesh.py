"""Re-export shim (counterpart of ``repro.launch.mesh``): the production
mesh builders live in :mod:`repro_torch.mesh`."""
from __future__ import annotations

from ..mesh import (  # noqa: F401
    dp_axes,
    dp_size,
    make_mesh,
    make_production_mesh,
    model_size,
)

__all__ = ["make_production_mesh", "make_mesh", "dp_axes", "dp_size",
           "model_size"]
