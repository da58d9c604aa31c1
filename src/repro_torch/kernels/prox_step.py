"""The fused proximal update ``x <- prox_{gamma R}(x - gamma g)`` (counterpart
of ``repro.kernels.prox_step``; TPU kernel B4).

This is the paper's inner update (Eq. 4), for any input shape, in float32
or bfloat16, with ``gamma`` a Python float or a 0-d float32 tensor on the
inputs' device (the kernel reads it there: no ``.item()`` and no copy to
the card per call).  ``kind`` is ``none``, ``l1``, ``l2`` or ``box`` with
``lam`` a Python float.

The arithmetic is the reference kernel's as its compiled program runs it:
float32 throughout, one rounding to ``x``'s dtype at the end, and the two
sums that the compiler contracts computed as FMAs:

* ``y = x - gamma*g`` as ``fma(-gamma, g, x)`` (it differs from the
  unfused ``repro.kernels.ref.prox_step_ref`` by one float32 ulp on about
  one element in seven);
* ``l1``: ``sign(y) * max(|y| - t, 0)`` with ``t = gamma*lam`` a float32
  product; ``l2``: ``y / fma(gamma, lam, 1)``; ``box``: ``clip(y, -lam,
  lam)``.

On the card :func:`prox_step` launches the hand-written CUDA kernel of
``csrc/prox_step.cu`` (one launch); on the CPU it runs
:func:`prox_step_ref`, the same arithmetic in plain PyTorch ops, with the
FMAs as ``core.stepsize.fma32``.  Other dtypes, or a ``gamma`` tensor that
is not a 0-d float32 on the inputs' device, raise on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.stepsize import fma32
from .dispatch import kernel_route

__all__ = ["KINDS", "prox_step", "prox_step_ref", "prox_step_tree"]

KINDS = ("none", "l1", "l2", "box")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kind_code(kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"prox_step: unknown kind {kind!r}; one of {KINDS}")
    return KINDS.index(kind)


def _gamma_tensor(gamma, device) -> torch.Tensor:
    """``gamma`` as a 0-d float32 tensor (a Python float rounds to nearest,
    as ``jnp.asarray(gamma, jnp.float32)`` does)."""
    if torch.is_tensor(gamma):
        return gamma.to(torch.float32).reshape(())
    return torch.tensor(gamma, dtype=torch.float32, device=device)


def prox_step_ref(x: torch.Tensor, g: torch.Tensor, gamma,
                  kind: str = "l1", lam: float = 1e-4) -> torch.Tensor:
    """The plain PyTorch version: the kernel's float32 arithmetic (module
    docstring), returned in ``x``'s dtype."""
    _kind_code(kind)
    gam = _gamma_tensor(gamma, x.device)
    lam32 = float(np.float32(lam))
    y = fma32(-gam, g.float(), x.float())
    if kind == "l1":
        t = gam * lam32
        y = torch.sign(y) * torch.clamp_min(y.abs() - t, 0.0)
    elif kind == "l2":
        y = y / fma32(gam, torch.full_like(gam, lam32), torch.ones_like(gam))
    elif kind == "box":
        y = torch.clamp(y, -lam32, lam32)
    return y.to(x.dtype)


def _lib():
    from .build import load
    lib = load("prox_step").lib
    if lib.prox_step_error_string.restype is not ctypes.c_char_p:
        fn = lib.prox_step_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.prox_step_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _check_inputs(x, g, gamma) -> None:
    """Raise unless the inputs are what the kernel reads."""
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise ValueError("prox_step: the kernel takes x and g both float32 or "
                         f"both bfloat16; got {x.dtype}, {g.dtype}")
    if x.shape != g.shape:
        raise ValueError(f"prox_step: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in shape")
    if torch.is_tensor(gamma) and (gamma.dtype != torch.float32
                                   or gamma.dim() != 0):
        raise ValueError("prox_step: a gamma tensor must be a 0-d float32 on "
                         f"the inputs' device; got {gamma.dtype} "
                         f"{tuple(gamma.shape)}")


def prox_step(x: torch.Tensor, g: torch.Tensor, gamma, kind: str = "l1",
              lam: float = 1e-4) -> torch.Tensor:
    """``prox_{gamma R}(x - gamma g)`` elementwise, in ``x``'s dtype and
    shape.  CUDA tensors launch the kernel (one launch; none for an empty
    ``x``); CPU tensors run :func:`prox_step_ref`."""
    code = _kind_code(kind)
    tensors = (x, g, gamma) if torch.is_tensor(gamma) else (x, g)
    if kernel_route(*tensors) == "plain":
        return prox_step_ref(x, g, gamma, kind=kind, lam=lam)
    _check_inputs(x, g, gamma)
    xc, gc = x.contiguous(), g.contiguous()
    out = torch.empty_like(xc)
    n = xc.numel()
    if n == 0:
        return out
    gamma_ptr = gamma.data_ptr() if torch.is_tensor(gamma) else None
    gamma_val = 0.0 if torch.is_tensor(gamma) else float(gamma)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.prox_step_launch(xc.data_ptr(), gc.data_ptr(),
                                  out.data_ptr(), n, _DTYPE_CODES[x.dtype],
                                  code, gamma_ptr, gamma_val, float(lam),
                                  stream)
    if rc != 0:
        raise RuntimeError("prox_step launch failed: "
                           f"{lib.prox_step_error_string(rc).decode()} ({rc})")
    prox_step.launches += 1
    return out


def prox_step_tree(params, grads, gamma, kind: str = "l1",
                   lam: float = 1e-4):
    """:func:`prox_step` leafwise over matching dicts, lists and tuples of
    tensors (one launch per leaf on the card), the structure kept."""
    if isinstance(params, dict):
        if params.keys() != grads.keys():
            raise ValueError("prox_step_tree: params and grads have other "
                             f"keys: {sorted(params)} vs {sorted(grads)}")
        return {k: prox_step_tree(params[k], grads[k], gamma, kind, lam)
                for k in params}
    if isinstance(params, (list, tuple)):
        if len(params) != len(grads):
            raise ValueError("prox_step_tree: params and grads differ in "
                             "length")
        leaves = [prox_step_tree(p, q, gamma, kind, lam)
                  for p, q in zip(params, grads)]
        return type(params)(leaves)
    return prox_step(params, grads, gamma, kind=kind, lam=lam)


# kernel launches since the last reset (the wrapper counts only launches)
prox_step.launches = 0
