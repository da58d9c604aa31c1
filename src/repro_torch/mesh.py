"""Sweep meshes, topology keys and data-parallel gradients (the sweep half
of ``repro.mesh``).

* :class:`Mesh` -- a numpy object array of ``torch.device`` with named
  axes, ``("cells",)`` or ``("cells", "data")``, and the
  ``torch.distributed`` rank that owns each entry;
* :func:`cell_mesh` / :func:`grid_mesh` -- the sweep meshes of the sharded
  backend (``sweep.shard``).  By default they span every CUDA card (of
  every process, once ``torch.distributed`` is up) and raise without one;
  they never go to the CPU on their own.  An explicit device list may name
  a device more than once (``cell_mesh([torch.device("cpu")] * 4)``): the
  sharding then runs each shard in turn on that device, which is how the
  sharding logic is exercised on a host with one device;
* :func:`mesh_topology` -- the hashable token that stands for a mesh in
  program-cache keys: axis names, shape, device kind, process count, never
  the mesh's identity;
* :func:`pmean_grad` / :func:`data_parallel_grad` -- a gradient computed
  data-parallel over the ``"data"`` axis: the sample axis is cut into
  ``size`` contiguous slices, slice j's gradient is taken on data device j,
  and the partial gradients are summed in index order on the first device
  and divided by ``size``;
* :func:`init_distributed` / :func:`maybe_init_distributed` -- the
  ``torch.distributed`` bootstrap behind ``ExecutionSpec``'s multi-host
  knobs (NCCL for the cards, gloo for the CPU).

Exactness contract (as the reference's): for a loss that is a mean over a
leading sample axis plus x-only terms, the data-parallel gradient equals
the full one up to the order of the float sums; the sample count must
divide by ``size``, else ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["CELL_AXIS", "DATA_AXIS", "Mesh", "cell_mesh", "grid_mesh",
           "cell_axis_size", "data_axis_size", "mesh_topology",
           "default_devices", "pmean_grad", "data_parallel_grad",
           "split_samples", "init_distributed", "maybe_init_distributed",
           "process_count", "process_index"]

CELL_AXIS = "cells"
DATA_AXIS = "data"


def _object_array(items: Sequence[Any]) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    for i, it in enumerate(items):
        out[i] = it
    return out


class Mesh:
    """Devices on named axes (the port's ``jax.sharding.Mesh``).

    ``devices`` is a numpy object array of ``torch.device`` whose shape
    matches ``axis_names``; ``processes`` (same shape) holds the
    ``torch.distributed`` rank that owns each entry (this process's rank
    for a mesh built from an explicit device list)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 processes=None):
        arr = np.asarray(devices, dtype=object)
        arr = _object_array([torch.device(d)
                             for d in arr.reshape(-1)]).reshape(arr.shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {arr.shape} do not fit the "
                             f"axes {self.axis_names}")
        self.devices = arr
        self.processes = (np.full(arr.shape, process_index(), np.int64)
                          if processes is None else
                          np.asarray(processes, np.int64).reshape(arr.shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def rows(self) -> List[List[torch.device]]:
        """The devices of each cells-axis row: the first runs the row's
        shard, all of them (one per data-axis entry) its gradients."""
        n = cell_axis_size(self)
        return [list(self.devices.reshape(n, -1)[r]) for r in range(n)]

    def row_process(self, r: int) -> int:
        """The rank that runs row ``r`` (a row lives in one process)."""
        procs = set(self.processes.reshape(cell_axis_size(self), -1)[r])
        if len(procs) != 1:
            raise ValueError(f"mesh row {r} spans processes {sorted(procs)}; "
                             "a cells-axis row must live in one process")
        return int(procs.pop())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


# ---------------------------------------------------------------------------
# multi-host bootstrap
# ---------------------------------------------------------------------------

_DISTRIBUTED_INITIALIZED = False


def process_count() -> int:
    """The ``torch.distributed`` world size, or 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def process_index() -> int:
    """This process's ``torch.distributed`` rank, or 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str = "nccl") -> None:
    """``torch.distributed.init_process_group`` over
    ``tcp://{coordinator}`` (idempotent per process)."""
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED or torch.distributed.is_initialized():
        _DISTRIBUTED_INITIALIZED = True
        return
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id))
    _DISTRIBUTED_INITIALIZED = True


def maybe_init_distributed(execution, device=None) -> bool:
    """Bring ``torch.distributed`` up from an ``ExecutionSpec``-like
    object: NCCL when the run is on the cards (``device`` None or CUDA),
    gloo on the CPU.  No-op (False) unless ``execution.coordinator`` is
    set; the knobs reach no program, only ``mesh_topology``'s process
    count."""
    coordinator = getattr(execution, "coordinator", None)
    if not coordinator:
        return False
    kind = torch.device("cuda" if device is None else device).type
    init_distributed(coordinator, getattr(execution, "num_processes", 1),
                     getattr(execution, "process_id", 0),
                     backend="gloo" if kind == "cpu" else "nccl")
    return True


# ---------------------------------------------------------------------------
# sweep meshes
# ---------------------------------------------------------------------------

def default_devices(kind: str = "cuda") -> Tuple[List[torch.device],
                                                 List[int]]:
    """``(devices, owning ranks)`` a default mesh spans: every CUDA card
    (``kind="cuda"``, raising without one) or the one CPU, of every
    process in rank order once ``torch.distributed`` is up."""
    if kind == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "a default mesh spans the CUDA cards and none is available; "
                "list the devices, e.g. cell_mesh([torch.device('cpu')])")
        local = [torch.device("cuda", i) for i in range(n)]
    elif kind == "cpu":
        local = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device kind {kind!r}")
    if process_count() == 1:
        return local, [process_index()] * len(local)
    gathered: List[Any] = [None] * process_count()
    torch.distributed.all_gather_object(gathered, [str(d) for d in local])
    devs, procs = [], []
    for rank, names in enumerate(gathered):
        devs += [torch.device(n) for n in names]
        procs += [rank] * len(names)
    return devs, procs


def _device_list(devices, processes) -> Tuple[List[torch.device],
                                              List[int]]:
    if devices is None:
        return default_devices("cuda")
    devs = [torch.device(d) for d in devices]
    return devs, (list(processes) if processes is not None
                  else [process_index()] * len(devs))


def cell_mesh(devices: Optional[Sequence[Any]] = None,
              processes: Optional[Sequence[int]] = None) -> Mesh:
    """1-D mesh ``("cells",)`` over ``devices`` (default: every CUDA
    card; an explicit list may repeat a device).  ``processes``: the
    rank owning each listed device (default this process)."""
    devs, procs = _device_list(devices, processes)
    return Mesh(_object_array(devs), (CELL_AXIS,), np.asarray(procs))


def grid_mesh(mesh_shape: Tuple[int, ...],
              devices: Optional[Sequence[Any]] = None,
              processes: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh with axes ``("cells",)`` or ``("cells", "data")`` over the
    first ``prod(mesh_shape)`` of ``devices`` (default: every CUDA card;
    ``processes`` as in ``cell_mesh``); raises when fewer are listed -- a
    silent fallback would serialize the data axis quietly."""
    shape = tuple(int(s) for s in mesh_shape)
    if not 1 <= len(shape) <= 2 or any(s < 1 for s in shape):
        raise ValueError(
            f"mesh_shape must be (cells,) or (cells, data) with positive "
            f"entries, got {mesh_shape!r}")
    need = int(np.prod(shape))
    devs, procs = _device_list(devices, processes)
    if len(devs) < need:
        raise ValueError(f"mesh_shape {shape} needs {need} devices, only "
                         f"{len(devs)} available")
    axes = (CELL_AXIS,) if len(shape) == 1 else (CELL_AXIS, DATA_AXIS)
    return Mesh(_object_array(devs[:need]).reshape(shape), axes,
                np.asarray(procs[:need]).reshape(shape))


def cell_axis_size(mesh: Mesh) -> int:
    """Size of the "cells" axis (the grid-partition axis)."""
    if CELL_AXIS not in mesh.axis_names:
        raise ValueError(
            f"sweep meshes need a {CELL_AXIS!r} axis; got axes "
            f"{tuple(mesh.axis_names)} -- build one with cell_mesh() or "
            f"grid_mesh()")
    return int(mesh.shape[CELL_AXIS])


def data_axis_size(mesh: Mesh) -> int:
    """Size of the "data" axis; 1 when the mesh has no data axis."""
    return int(mesh.shape.get(DATA_AXIS, 1))


def _device_kind(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def mesh_topology(mesh: Mesh) -> Tuple[Any, ...]:
    """Hashable cache-key token for a mesh: its topology, not its identity:
    ``("mesh", axis names, shape, device kind, process count)``.  Meshes
    of one kind with the same axes and shape share programs; a reshape of
    the same devices from (2,) to (1, 2) keys fresh."""
    return ("mesh", tuple(mesh.axis_names),
            tuple(int(s) for s in mesh.devices.shape),
            _device_kind(mesh.devices.flat[0]), process_count())


# ---------------------------------------------------------------------------
# data-parallel gradients
# ---------------------------------------------------------------------------

def split_samples(data: Sequence[torch.Tensor], size: int,
                  axis: str = DATA_AXIS, sample_axis: int = 0) -> list:
    """``size`` contiguous slices of every leaf's ``sample_axis``: a list
    (one entry per data shard) of tuples of views; raises when the sample
    count does not divide by ``size``."""
    slices = [[] for _ in range(size)]
    for leaf in data:
        s = int(leaf.shape[sample_axis])
        if s % size:
            raise ValueError(
                f"pmean_grad: leading sample axis ({s}) must divide by "
                f"the {axis!r} mesh axis size ({size}); pad the worker "
                f"slices or pick a mesh_shape whose data axis divides "
                f"the per-worker sample count")
        loc = s // size
        for j in range(size):
            slices[j].append(leaf.narrow(sample_axis, j * loc, loc))
    return [tuple(s) for s in slices]


def _pmean(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The partial gradients summed in index order on the first one's
    device, over their count."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total / len(parts)


def data_parallel_grad(build: Callable[..., Callable], data,
                       devices: Sequence[Any], sample_axis: int = 0,
                       axis: str = DATA_AXIS) -> Callable:
    """``grad_fn(x, *args)``: the mean over the data axis of the
    gradients ``build(*slice_j)(x, *args)``, slice j of ``data`` (cut
    along ``sample_axis``) living and computed on ``devices[j]``; the
    result is on ``devices[0]``.  ``build`` makes a gradient from a slice
    of the data (a closed form where the problem has one).  With one
    device it is ``build`` over the whole data on that device."""
    devs = [torch.device(d) for d in devices]
    if len(devs) == 1:
        return build(*(leaf.to(devs[0]) for leaf in data))
    grads = [build(*(leaf.to(d) for leaf in part))
             for d, part in zip(devs, split_samples(data, len(devs), axis,
                                                    sample_axis))]

    def grad_fn(x, *args):
        return _pmean([g(x.to(d), *(a.to(d) for a in args))
                       for g, d in zip(grads, devs)])

    return grad_fn


def pmean_grad(loss_fn: Callable, axis: str = DATA_AXIS, size: int = 1,
               devices: Optional[Sequence[Any]] = None) -> Callable:
    """Data-parallel ``torch.func.grad(loss_fn)``: ``grad_fn(x, *data)``
    cuts each data leaf's leading sample axis into ``size`` contiguous
    slices, differentiates the loss on slice j on ``devices[j]`` (default:
    x's device for every slice), sums the partial gradients in index order
    on the first of them and divides by ``size``.  ``S % size != 0``
    raises ``ValueError``."""
    grad = torch.func.grad(loss_fn)
    if size <= 1:
        return grad

    def grad_fn(x, *data):
        devs = ([x.device] * size if devices is None
                else [torch.device(d) for d in devices])
        return _pmean([grad(x.to(d), *(leaf.to(d) for leaf in part))
                       for d, part in zip(devs, split_samples(data, size,
                                                              axis))])

    return grad_fn
