"""Known-bad fixture for KRN002 (F1's counterpart): a launcher handed the
pointer of a tensor made on the host.

The reference's F1 (``repro/staticcheck/fixtures/bad_scalar_ref.py``)
sums x into a 0-d ``ShapeDtypeStruct(())`` out-shape.  The port's
counterpart makes that 0-d output with ``torch.zeros(())`` -- no
``device=`` -- and passes its ``data_ptr()`` to the launcher: the plain
CPU path works, the kernel on the card gets a host pointer.

Never imported, built or run.  The launch is otherwise routed correctly
so that ONLY KRN002 triggers here.
"""
import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.dispatch import current_stream_handle, kernel_route

SOURCE = r"""
extern "C" __global__ void sum_kernel(const float* x, float* o, int n) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += x[i];
  atomicAdd(o, s);
}
"""

_FNS: dict = {}


def _fns() -> dict:
    if not _FNS:
        fn = _FNS["sum_launch"] = load("bad_host_alloc").lib.sum_launch
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    return _FNS


def total_ref(x: torch.Tensor) -> torch.Tensor:
    return x.sum()


def total(x: torch.Tensor) -> torch.Tensor:
    if kernel_route(x) == "plain":
        return total_ref(x)
    # BAD: made on the host (no device=); the kernel writes through a host
    # pointer.  torch.zeros((), device=x.device) or x.new_zeros(()).
    out = torch.zeros(())
    _fns()["sum_launch"](x.data_ptr(), out.data_ptr(), x.numel(),
                         current_stream_handle(x.get_device()))
    return out
