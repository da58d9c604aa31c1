"""Fused RMSNorm (counterpart of ``repro.kernels.rmsnorm``; TPU kernel B5),
exported by ``kernels.ops`` as ``rmsnorm_fused``.

``x (..., D)``, ``scale (D,)`` -> ``x * rsqrt(mean(x^2) + eps) * scale``
in ``x``'s dtype, with float32 statistics.  The kernel's order, kept on
both routes: cast ``x`` to float32, scale by the float32 ``scale``, cast
once at the end.  ``models.layers.rmsnorm`` casts before it scales, so in
bfloat16 the two differ by up to one bf16 ulp; no model calls this kernel.

On the card :func:`rmsnorm` launches the hand-written CUDA kernel of
``csrc/rmsnorm.cu`` (one block per row, one launch); on the CPU it runs
:func:`rmsnorm_ref`, the same arithmetic in plain PyTorch ops.  Both take
``1 / sqrt(var + eps)`` with IEEE roundings, so they differ only in the
order of the row sum.  The kernel takes ``x`` and ``scale`` both in
float32 or both in bfloat16; other dtypes raise on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .dispatch import kernel_route

__all__ = ["rmsnorm", "rmsnorm_ref"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version (port of ``repro.kernels.ref.rmsnorm_ref``):
    float32 sum of squares over the last axis divided by D, ``1 /
    sqrt(var + eps)``, ``(x * r) * scale`` in float32, one cast."""
    x32 = x.float()
    var = x32.square().sum(dim=-1, keepdim=True) / x.shape[-1]
    r = torch.reciprocal(torch.sqrt(var + eps))
    return ((x32 * r) * scale.float()).to(x.dtype)


def _lib():
    from .build import load
    lib = load("rmsnorm").lib
    if lib.rmsnorm_error_string.restype is not ctypes.c_char_p:
        fn = lib.rmsnorm_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_float]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.rmsnorm_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x``.  CUDA tensors launch the kernel
    (one launch; none for an empty ``x``); CPU tensors run
    :func:`rmsnorm_ref`."""
    if kernel_route(x, scale) == "plain":
        return rmsnorm_ref(x, scale, eps)
    if x.dtype not in _DTYPE_CODES or scale.dtype != x.dtype:
        raise ValueError("rmsnorm: the kernel takes x and scale both float32 "
                         f"or both bfloat16; got {x.dtype}, {scale.dtype}")
    if x.dim() < 1 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"rmsnorm: scale must be ({x.shape[-1]},) for x "
                         f"{tuple(x.shape)}; got {tuple(scale.shape)}")
    xc, sc = x.contiguous(), scale.contiguous()
    out = torch.empty_like(xc)
    D = x.shape[-1]
    rows = xc.numel() // D if D else 0
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rmsnorm_launch(xc.data_ptr(), sc.data_ptr(), out.data_ptr(),
                                rows, D, _DTYPE_CODES[x.dtype], float(eps),
                                stream)
    if rc != 0:
        raise RuntimeError("rmsnorm launch failed: "
                           f"{lib.rmsnorm_error_string(rc).decode()} ({rc})")
    rmsnorm.launches += 1
    return out


# kernel launches since the last reset (the wrapper counts only launches)
rmsnorm.launches = 0
