"""Device rule for the port (counterpart of ``repro.kernels.dispatch``).

The reference resolves an *interpret* flag per backend.  The port has no
interpreter: a hand-written CUDA kernel runs on the card or not at all.
The rule is therefore about devices, and it has no override:

* ``device=None`` means ``cuda``.  With no card present,
  :func:`resolve_device` raises -- it never falls back to the CPU.
* ``device="cpu"`` is the only way onto the CPU (the tests pass it).
* A kernel wrapper decides by the device of its tensors
  (:func:`kernel_route`): CPU tensors take the kernel's plain PyTorch
  version, CUDA tensors take the kernel, anything else raises.  A kernel
  that fails to build or launch raises; nothing switches the card's path
  back to the plain version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "kernel_route"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one; raises when the named device (or the default card) is
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def kernel_route(*tensors: torch.Tensor) -> str:
    """``"cuda"`` (launch the kernel) or ``"plain"`` (CPU reference) for a
    kernel call on ``tensors``; they must all share one device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return "cuda"
    if dev.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel or plain version for device {dev}")
