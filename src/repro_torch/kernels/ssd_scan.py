"""Mamba2 SSD intra-chunk compute (counterpart of ``repro.kernels.ssd_scan``;
TPU kernel B7).

The chunked SSD algorithm (``models.ssm.ssd_chunked``) has a sequential
cross-chunk scan, left to the host graph (``kernels.ops.ssd_scan_pallas``),
and the per-chunk quadratic compute, which :func:`ssd_intra_chunk` does for
every (chunk, head) cell:

    y     = ((C B^T) * L * dt) x          L = exp(segsum), masked before exp
    state = (B * exp(cums[-1] - cums) dt)^T x

On the card it launches the hand-written CUDA kernel of
``csrc/ssd_scan.cu`` (one launch for all cells, every product on the
tensor cores in split TF32; see the source for the design); on the CPU it
runs :func:`ssd_intra_chunk_ref`, the same function in plain PyTorch ops,
a batched form of ``repro.kernels.ref.ssd_intra_ref``
(:func:`ssd_intra_ref` is that one-chunk oracle under its own name).  The
kernel takes ``x`` in float32 or bfloat16 and float32 ``dt``, ``dA``,
``B``, ``C``, with P <= 128, H a multiple of G, and Q small enough for a
block's shared memory (110 KB at Q 256, N 128, P 64 with bf16 x; Q past
256 walks the strip in windows); other inputs raise on the card.  The
wrapper refuses a build in which ptxas gave any kernel instance local
memory (:func:`local_bytes`).
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import Dict, Tuple

import torch

from .dispatch import kernel_route

__all__ = ["local_bytes", "ssd_intra_chunk", "ssd_intra_chunk_ref",
           "ssd_intra_ref"]

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P = 128
_PROPS = re.compile(r"Function properties for (\S+)\s+(\d+) bytes stack "
                    r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                    r"loads")


def ssd_intra_ref(x, dt, dA, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk (port of ``repro.kernels.ref.ssd_intra_ref``): x (Q, P),
    dt/dA (Q,), B/C (Q, N) -> (y (Q, P), state (N, P)), all float32."""
    y, st = ssd_intra_chunk_ref(x[None, :, None], dt[None, :, None],
                                dA[None, :, None], B[None, :, None],
                                C[None, :, None])
    return y[0, :, 0], st[0, 0]


def ssd_intra_chunk_ref(x, dt, dA, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`ssd_intra_chunk`: every cell at
    once, in float32, with the decay mask applied before ``exp``."""
    BC, Q, H, P = x.shape
    G = B.shape[2]
    rep = H // G
    x32 = x.float()
    dt32, dA32 = dt.float(), dA.float()
    Bh = B.float().repeat_interleave(rep, dim=2)          # (BC, Q, H, N)
    Ch = C.float().repeat_interleave(rep, dim=2)
    cums = torch.cumsum(dA32, dim=1)                      # (BC, Q, H)
    decay = cums[:, :, None, :] - cums[:, None, :, :]     # (BC, t, s, H)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri[None, :, :, None], decay,
                              torch.full_like(decay, NEG_INF)))
    CB = torch.einsum("bthn,bshn->btsh", Ch, Bh)
    W = CB * L * dt32[:, None, :, :]
    y = torch.einsum("btsh,bshp->bthp", W, x32)
    w2 = torch.exp(cums[:, -1:, :] - cums) * dt32          # (BC, Q, H)
    st = torch.einsum("bshn,bshp->bhnp", Bh * w2[..., None], x32)
    return y, st


def _lib():
    from .build import load
    lib = load("ssd_scan").lib
    if lib.ssd_intra_chunk_error_string.restype is not ctypes.c_char_p:
        fn = lib.ssd_intra_chunk_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.ssd_intra_chunk_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def local_bytes(report: str) -> Dict[str, int]:
    """``{kernel instance: stack frame + spill bytes}`` of every
    ``ssd_intra_kernel`` instance in a ``ptxas -v`` report."""
    return {m.group(1): sum(int(v) for v in m.groups()[1:])
            for m in _PROPS.finditer(report)
            if "ssd_intra_kernel" in m.group(1)}


@functools.lru_cache(maxsize=None)
def _check_build() -> None:
    """Raise if ptxas gave any instance local memory (once a process)."""
    from .build import load
    used = local_bytes(load("ssd_scan").ptxas)
    if not used or any(used.values()):
        raise RuntimeError("ssd_intra_chunk: refusing a build whose kernel "
                           f"instances use local memory (bytes: {used})")


def _check_inputs(x, dt, dA, B, C) -> None:
    """Raise unless the inputs are what the kernel reads."""
    if x.ndim != 4 or B.ndim != 4:
        raise ValueError("ssd_intra_chunk: x must be (BC, Q, H, P) and B, C "
                         f"(BC, Q, G, N); got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    BC, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd_intra_chunk: x must be float32 or bfloat16; "
                         f"got {x.dtype}")
    for name, t, shape in (("dt", dt, (BC, Q, H)), ("dA", dA, (BC, Q, H)),
                           ("B", B, (BC, Q, G, N)), ("C", C, (BC, Q, G, N))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"ssd_intra_chunk: {name} must be float32 of "
                             f"shape {shape}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if P > _MAX_P or G <= 0 or H % G:
        raise ValueError(f"ssd_intra_chunk: no kernel for P={P} (<= {_MAX_P})"
                         f" with H={H} over G={G} groups")


def ssd_intra_chunk(x, dt, dA, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BC, Q, H, P), dt/dA (BC, Q, H), B/C (BC, Q, G, N) -> (y (BC, Q, H,
    P), state (BC, H, N, P)), both float32.  CUDA tensors launch the kernel
    (one launch); CPU tensors run :func:`ssd_intra_chunk_ref`."""
    if kernel_route(x, dt, dA, B, C) == "plain":
        return ssd_intra_chunk_ref(x, dt, dA, B, C)
    _check_inputs(x, dt, dA, B, C)
    BC, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    lib = _lib()
    _check_build()
    xc, dtc, dAc, Bc, Cc = (t.contiguous() for t in (x, dt, dA, B, C))
    y = torch.empty(BC, Q, H, P, dtype=torch.float32, device=x.device)
    st = torch.empty(BC, H, N, P, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_intra_chunk_launch(
            xc.data_ptr(), dtc.data_ptr(), dAc.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(), st.data_ptr(), BC, Q, H, P, G, N,
            _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            "ssd_intra_chunk launch failed: "
            f"{lib.ssd_intra_chunk_error_string(rc).decode()} ({rc})")
    ssd_intra_chunk.launches += 1
    return y, st


# kernel launches since the last reset (the wrapper counts only launches)
ssd_intra_chunk.launches = 0
