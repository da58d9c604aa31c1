"""Known-bad fixture for KRN003 (F3's counterpart): kernel launches not
routed through ``kernels.dispatch``.

The reference's F3 (``repro/staticcheck/fixtures/bad_unrouted_pallas.py``)
copies x through ``pallas_call`` with ``interpret=`` missing, hard-coded,
or not resolved by dispatch.  The port's three shapes of the same fault,
each a copy of x: a public wrapper with no ``kernel_route``, a device
literal on the launch path, and a ``try`` whose ``except`` falls back to
the plain version.

Never imported, built or run.
"""
import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.dispatch import current_stream_handle, kernel_route

SOURCE = r"""
extern "C" __global__ void copy_kernel(const float* x, float* o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i];
}
"""

_FNS: dict = {}


def _fns() -> dict:
    if not _FNS:
        fn = _FNS["copy_launch"] = load("bad_unrouted_launch").lib.copy_launch
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    return _FNS


def _launch(x: torch.Tensor, out: torch.Tensor) -> None:
    _fns()["copy_launch"](x.data_ptr(), out.data_ptr(), x.numel(),
                          current_stream_handle(x.get_device()))


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def copy_unrouted(x: torch.Tensor) -> torch.Tensor:
    # BAD: launches whatever the device of x; a CPU tensor's pointer goes
    # to the card.
    out = torch.empty_like(x)
    _launch(x, out)
    return out


def copy_literal(x: torch.Tensor) -> torch.Tensor:
    if kernel_route(x) == "plain":
        return copy_ref(x)
    # BAD: a hard-coded device; the tensors' own card decides.
    out = torch.empty_like(x, device="cuda")
    _launch(x, out)
    return out


def copy_fallback(x: torch.Tensor) -> torch.Tensor:
    if kernel_route(x) == "plain":
        return copy_ref(x)
    out = torch.empty_like(x)
    try:
        _launch(x, out)
    except RuntimeError:
        # BAD: a kernel that fails to build or launch must raise, never
        # switch the card's path to the plain version.
        return copy_ref(x)
    return out
