"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface; it is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``kernels/_build/`` at first use and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
library file name carries a hash of the source and the flags, so an edited
source or changed flag builds anew and a stale library is never loaded.  A
failed build raises with the compiler's output; the ``-Xptxas -v`` report
(registers, shared memory, spills) is kept beside the library.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuiltLibrary", "load", "nvcc_path", "CSRC_DIR", "BUILD_DIR",
           "NVCC_FLAGS"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library plus what its build reported."""

    name: str
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an earlier build was reused
    ptxas: str               # nvcc/ptxas output of the build


_LOADED: dict = {}


def nvcc_path() -> str:
    """``nvcc`` on ``PATH``, else under PyTorch's resolved CUDA home."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the CUDA "
                       "toolkit is needed to build the port's kernels")


def load(name: str) -> BuiltLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    nvcc = nvcc_path()
    digest = hashlib.sha256(
        src.read_bytes() + " ".join((nvcc,) + NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log = BUILD_DIR / f"lib{name}-{digest}.log"
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    built = BuiltLibrary(name=name, lib=ctypes.CDLL(str(out)), path=out,
                         build_seconds=seconds,
                         ptxas=log.read_text() if log.exists() else "")
    _LOADED[name] = built
    return built
