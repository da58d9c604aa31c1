"""Known-bad fixture for KRN001 (F2's counterpart): a kernel wrapper that
picks its kernel by reading a card tensor on the host.

The reference's F2 (``repro/staticcheck/fixtures/bad_switch_in_kernel.py``)
computes ``x + 1`` or ``x - 1`` by ``lax.switch(idx[0], ...)`` inside a
Pallas kernel.  The port's bug class is the host read that picks between
two kernels: ``int(idx[0])`` waits for the stream on every call.

Never imported, built or run.  The launch is otherwise routed correctly
(``kernel_route``, outputs made by ``torch.empty_like``) so that ONLY
KRN001 triggers here.
"""
import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.dispatch import current_stream_handle, kernel_route

SOURCE = r"""
extern "C" __global__ void add_one(const float* x, float* o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.f;
}
extern "C" __global__ void sub_one(const float* x, float* o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] - 1.f;
}
"""

_FNS: dict = {}


def _fns() -> dict:
    if not _FNS:
        lib = load("bad_host_select").lib
        for name in ("add_one_launch", "sub_one_launch"):
            fn = _FNS[name] = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                   ctypes.c_void_p]
    return _FNS


def step_ref(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(idx[0] == 0, x + 1.0, x - 1.0)


def step(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if kernel_route(idx, x) == "plain":
        return step_ref(idx, x)
    out = torch.empty_like(x)
    # BAD: reads the card tensor idx on the host to pick the kernel --
    # every call waits for the stream; select inside one kernel instead.
    name = "add_one_launch" if int(idx[0]) == 0 else "sub_one_launch"
    _fns()[name](x.data_ptr(), out.data_ptr(), x.numel(),
                 current_stream_handle(x.get_device()))
    return out
