"""Blocked online-softmax attention with position masks (counterpart of
``repro.kernels.flash_attention``; TPU kernel B6).

:func:`flash_attention_bhsd` takes ``q (BH, Sq, d)``, ``k (BH, Sk, d)``,
``v (BH, Sk, dv)`` and int32 absolute positions ``qpos (Sq,)``, ``kpos
(Sk,)`` (-1 marks an empty slot: ring-cache holes, padding).  A key is
visible to a query row when both positions are ``>= 0``, and (causal)
``kpos <= qpos``, and (window) ``kpos > qpos - window``.  Fully masked
rows return zeros.  ``dv`` is ``d`` everywhere but MLA's prefill, where
q and k carry the nope and rope parts (128 + 64) over a v of 128.

On the card it launches one of the two hand-written CUDA kernels of
``csrc/flash_attention.cu`` (see the source for both designs), chosen by
dtype and head dims alone (:func:`card_route`): bfloat16 at equal dims of
64 and 128 takes the tensor-core kernel (``wgmma`` fed by TMA, P split
into bf16 hi + lo), every other supported case the SIMT kernel (float32
FMAs on the CUDA cores).  On the CPU it runs
:func:`flash_attention_bhsd_ref`, the same function in plain PyTorch ops:
the port of ``repro.kernels.ref.flash_attention_ref`` with the kernel's
``qpos >= 0`` mask added (the reference oracle omits it; the two differ
only for negative query positions, which neither the model nor the
reference's tests produce).  The kernels take bfloat16 and float32 and
the ``(d, dv)`` pairs of :data:`SUPPORTED_HEAD_DIMS` (those of the
configs and presets); other inputs on the card raise -- they are never
sent to the plain version, and a failed build or launch raises, never
falls back to the other route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .dispatch import kernel_route

__all__ = ["NEG_INF", "SUPPORTED_HEAD_DIMS", "TC_HEAD_DIMS", "card_route",
           "flash_attention_bhsd", "flash_attention_bhsd_ref"]

NEG_INF = -1e30
# (q/k head dim, v head dim) pairs with a kernel, in both dtypes
SUPPORTED_HEAD_DIMS = ((48, 48), (64, 64), (80, 80), (128, 128), (192, 128))
TC_HEAD_DIMS = (64, 128)   # bfloat16 head dims (q/k = v) of the tensor-core kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535   # BH is the y dimension of the SIMT kernel's grid


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


def card_route(dtype: torch.dtype, d: int, dv: Optional[int] = None) -> str:
    """The kernel a CUDA call takes: ``"tc"`` (tensor cores) for bfloat16
    with q/k and v at one head dim of :data:`TC_HEAD_DIMS`, else
    ``"simt"``.  ``dv`` defaults to ``d``."""
    dv = d if dv is None else dv
    return ("tc" if dtype == torch.bfloat16 and d == dv
            and d in TC_HEAD_DIMS else "simt")


def _tc_local_bytes(lib) -> dict:
    """Local memory per thread (spills and stack) of each tensor-core
    instance, by head dim, as the runtime reports it; -1 where it could
    not say."""
    return {d: lib.flash_attention_tc_local_bytes(d) for d in TC_HEAD_DIMS}


def simt_instances():
    """``(dtype, d, dv)`` of every SIMT instance of the kernel: float32 at
    each supported pair, bfloat16 at those the tensor-core kernel does
    not take."""
    return tuple((dt, d, dv) for dt in _DTYPE_CODES
                 for d, dv in SUPPORTED_HEAD_DIMS
                 if card_route(dt, d, dv) == "simt")


def _simt_local_bytes(lib) -> dict:
    """Local memory per thread (spills and stack) of each SIMT instance,
    by ``(dtype name, d, dv)``, as the runtime reports it; -1 where it
    could not say."""
    return {(str(dt)[6:], d, dv): lib.flash_attention_simt_local_bytes(
        _DTYPE_CODES[dt], d, dv) for dt, d, dv in simt_instances()}


def _bind(lib):
    """Set the C signatures of a loaded ``flash_attention`` library."""
    fn = lib.flash_attention_bhsd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tc = lib.flash_attention_bhsd_tc_launch
    tc.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    tc.restype = ctypes.c_int
    err = lib.flash_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    local = lib.flash_attention_tc_local_bytes
    local.argtypes = [ctypes.c_int]
    local.restype = ctypes.c_int
    simt = lib.flash_attention_simt_local_bytes
    simt.argtypes = [ctypes.c_int] * 3
    simt.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    """The built library with its C signatures bound.  Raises when any
    instance, tensor-core or SIMT, uses local memory: spilling builds of
    an earlier form of the tensor-core design gave wrong outputs on the
    card, for a cause not found, and spilling instances ran slower, so
    such a build never launches (the check reruns on every call until a
    build passes)."""
    from .build import load
    lib = _bind(load("flash_attention").lib)
    used = {**_tc_local_bytes(lib), **_simt_local_bytes(lib)}
    if any(used.values()):
        raise RuntimeError(
            "flash_attention_bhsd: this build uses local memory (bytes per "
            f"thread by tensor-core head dim and by SIMT (dtype, d, dv): "
            f"{used}, -1 = unknown); spilling builds of this kernel gave "
            "wrong outputs on the card, so it is refused")
    return lib


def _check_inputs(q, k, v, qpos, kpos) -> None:
    """Raise unless the inputs are what the kernel reads."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention_bhsd: q, k, v must be 3-D "
                         f"(BH, S, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, d = q.shape
    Sk, dv = k.shape[1], v.shape[2]
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention_bhsd: the kernel takes q, k, v all "
                         "bfloat16 or all float32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (d, dv) not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_bhsd: no kernel for head dim {d} "
                         f"(q, k) over {dv} (v); supported (q/k, v): "
                         f"{SUPPORTED_HEAD_DIMS}")
    if tuple(k.shape) != (BH, Sk, d) or tuple(v.shape) != (BH, Sk, dv):
        raise ValueError(f"flash_attention_bhsd: k must be ({BH}, Sk, {d}) "
                         f"and v ({BH}, Sk, dv); got {tuple(k.shape)}, "
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
    """q (BH, Sq, d), k (BH, Sk, d), v (BH, Sk, dv), qpos (Sq,), kpos (Sk,)
    int32 -> (BH, Sq, dv) in ``v``'s dtype.  CUDA tensors launch the
    kernel of :func:`card_route` (one launch); CPU tensors run
    :func:`flash_attention_bhsd_ref`."""
    if kernel_route(q, k, v, qpos, kpos) == "plain":
        return flash_attention_bhsd_ref(q, k, v, qpos, kpos, causal=causal,
                                        window=window, scale=scale)
    _check_inputs(q, k, v, qpos, kpos)
    BH, Sq, d = q.shape
    dv = v.shape[2]
    route = card_route(q.dtype, d, dv)
    out = torch.empty((BH, Sq, dv), dtype=v.dtype, device=v.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
                kpos.data_ptr(), out.data_ptr(), BH, Sq, k.shape[1], d)
        tail = (float(scale), int(causal), int(window is not None),
                int(window or 0), stream)
        if route == "tc":
            code = lib.flash_attention_bhsd_tc_launch(*ptrs, *tail)
        else:
            code = lib.flash_attention_bhsd_launch(
                *ptrs, dv, _DTYPE_CODES[q.dtype], *tail)
    if code != 0:
        raise RuntimeError(
            f"flash_attention_bhsd launch failed ({route} kernel): "
            f"{lib.flash_attention_error_string(code).decode()} ({code})")
    flash_attention_bhsd.launches += 1
    if route == "tc":
        flash_attention_bhsd.launches_tc += 1
    return out


# kernel launches since the last reset (the wrapper counts only launches):
# all of them, and those of the tensor-core route (the SIMT route has the
# rest)
flash_attention_bhsd.launches = 0
flash_attention_bhsd.launches_tc = 0

