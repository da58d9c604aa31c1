"""Blocked online-softmax attention with position masks (counterpart of
``repro.kernels.flash_attention``; TPU kernel B6).

:func:`flash_attention_bhsd` takes ``q (BH, Sq, d)``, ``k``/``v``
``(BH, Sk, d)`` and int32 absolute positions ``qpos (Sq,)``, ``kpos (Sk,)``
(-1 marks an empty slot: ring-cache holes, padding).  A key is visible to
a query row when both positions are ``>= 0``, and (causal) ``kpos <=
qpos``, and (window) ``kpos > qpos - window``.  Fully masked rows return
zeros.

On the card it launches the hand-written CUDA kernel of
``csrc/flash_attention.cu`` (one block per (bh, 64-row query tile),
float32 online softmax; see the source for the design).  On the CPU it
runs :func:`flash_attention_bhsd_ref`, the same function in plain PyTorch
ops: the port of ``repro.kernels.ref.flash_attention_ref`` with the
kernel's ``qpos >= 0`` mask added (the reference oracle omits it; the two
differ only for negative query positions, which neither the model nor
the reference's tests produce).  The kernel takes bfloat16 and float32 and
head dims 48, 64 and 128 (those of the dense configs and presets); other
inputs on the card raise -- they are never sent to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .dispatch import kernel_route

__all__ = ["NEG_INF", "SUPPORTED_HEAD_DIMS", "flash_attention_bhsd",
           "flash_attention_bhsd_ref"]

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (48, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535   # BH is the grid's y dimension


def _visible(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) bool: the keys each query row may attend to."""
    valid = (kpos[None, :] >= 0) & (qpos[:, None] >= 0)
    if causal:
        valid &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        valid &= kpos[None, :] > qpos[:, None] - window
    return valid


def flash_attention_bhsd_ref(q, k, v, qpos, kpos, *, causal: bool = True,
                             window: Optional[int] = None,
                             scale: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version: all (Sq, Sk) scores at once in float32,
    masked to ``NEG_INF``, softmax with the kernel's ``s > NEG_INF/2``
    test, ``out / max(l, 1e-30)`` in ``v``'s dtype."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = torch.where(_visible(qpos, kpos, causal, window)[None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return (out / torch.clamp(l, min=1e-30)).to(v.dtype)


def _lib():
    from .build import load
    lib = load("flash_attention").lib
    if lib.flash_attention_error_string.restype is not ctypes.c_char_p:
        fn = lib.flash_attention_bhsd_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.flash_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _check_inputs(q, k, v, qpos, kpos) -> None:
    """Raise unless the inputs are what the kernel reads."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention_bhsd: q, k, v must be 3-D "
                         f"(BH, S, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention_bhsd: the kernel takes q, k, v all "
                         "bfloat16 or all float32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_bhsd: no kernel for head dim {d}; "
                         f"supported: {SUPPORTED_HEAD_DIMS}")
    if tuple(k.shape) != (BH, Sk, d) or tuple(v.shape) != (BH, Sk, d):
        raise ValueError(f"flash_attention_bhsd: k and v must be "
                         f"({BH}, Sk, {d}); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if BH > _MAX_GRID_Y:
        raise ValueError(f"flash_attention_bhsd: BH={BH} exceeds "
                         f"{_MAX_GRID_Y}")
    for name, t, shape in (("qpos", qpos, (Sq,)), ("kpos", kpos, (Sk,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"flash_attention_bhsd: {name} must be int32 of "
                             f"shape {shape}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("qpos", qpos),
                    ("kpos", kpos)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bhsd: {name} must be "
                             "contiguous")


def flash_attention_bhsd(q, k, v, qpos, kpos, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: float = 1.0) -> torch.Tensor:
    """q (BH, Sq, d), k/v (BH, Sk, d), qpos (Sq,), kpos (Sk,) int32 ->
    (BH, Sq, d) in ``v``'s dtype.  CUDA tensors launch the kernel (one
    launch); CPU tensors run :func:`flash_attention_bhsd_ref`."""
    if kernel_route(q, k, v, qpos, kpos) == "plain":
        return flash_attention_bhsd_ref(q, k, v, qpos, kpos, causal=causal,
                                        window=window, scale=scale)
    _check_inputs(q, k, v, qpos, kpos)
    BH, Sq, d = q.shape
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_bhsd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            kpos.data_ptr(), out.data_ptr(), BH, Sq, k.shape[1], d,
            _DTYPE_CODES[q.dtype], float(scale), int(causal),
            int(window is not None), int(window or 0), stream)
    if code != 0:
        raise RuntimeError(
            "flash_attention_bhsd launch failed: "
            f"{lib.flash_attention_error_string(code).decode()} ({code})")
    flash_attention_bhsd.launches += 1
    return out


# kernel launches since the last reset (the wrapper counts only launches)
flash_attention_bhsd.launches = 0

