"""Re-export shim (counterpart of ``repro.launch.sharding``): the
parameter / batch / cache sharding planner lives in
:mod:`repro_torch.mesh`."""
from __future__ import annotations

from ..mesh import (  # noqa: F401
    _key_names,
    _param_spec,
    batch_shardings,
    cache_shardings,
    describe_shardings,
    param_shardings,
    replicated,
)

__all__ = ["param_shardings", "batch_shardings", "cache_shardings",
           "replicated", "describe_shardings"]
