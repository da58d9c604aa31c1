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

The model half (the reference's production meshes and sharding planner):

* :class:`PartitionSpec` (``P``), :class:`NamedSharding` and
  :class:`AbstractMesh` (axis names and sizes, no devices: the 256- and
  512-device production meshes are planned without them);
* :func:`make_production_mesh` / :func:`make_mesh` -- ``("data",
  "model")`` meshes (``"pod"`` in front for three axes) over every CUDA
  card (of every process) by default, raising when there are fewer; an
  explicit device list may repeat a device, and ``processes`` names the
  rank that owns each.  A data-parallel row of a model mesh (the
  positions that share their "pod" and "data" coordinates,
  :func:`dp_rows`) lives in one rank, and a mesh over several ranks spans
  every rank of the ``torch.distributed`` group; an explicit list that
  gives one CUDA device to two ranks raises before any process group is
  made (:func:`check_one_rank_a_card`: NCCL refuses two ranks on one
  card);
* the planner -- :func:`param_shardings`, :func:`batch_shardings`,
  :func:`cache_shardings`, :func:`replicated`, :func:`describe_shardings`
  -- with the reference's rules, over the port's pytrees; leaves may be
  tensors on any device (``meta`` too) or anything with a ``shape``;
* ``with mesh:`` -- the ambient model mesh that ``models.act_constraint``
  checks its spec against (:func:`current_mesh`);
* :func:`device_put` / :func:`gather` -- a tensor cut by its sharding
  into one block a mesh position (a :class:`ShardedTensor`; a position
  another rank owns holds no tensor here) and put back together bitwise
  (across ranks an all-gather); :func:`gather_model_blocks` /
  :func:`put_model_blocks` -- the same over the data axes alone, each
  "model" block whole (tensor parallelism's FSDP gather and cut);
* :func:`rows_gather` / :func:`sum_in_order` / :func:`block_values` --
  the cross-rank exchanges of a data-parallel step: every row's tensor
  in row order on every rank, summed in that order, so one mesh run in
  one process and in several gives bitwise the same numbers.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.pytree import (tree_flatten_with_path, tree_leaves, tree_map,
                          tree_map_with_path)

__all__ = ["CELL_AXIS", "DATA_AXIS", "Mesh", "cell_mesh", "grid_mesh",
           "cell_axis_size", "data_axis_size", "mesh_topology",
           "default_devices", "pmean_grad", "data_parallel_grad",
           "split_samples", "init_distributed", "maybe_init_distributed",
           "shutdown_distributed",
           "process_count", "process_index", "PartitionSpec", "P",
           "NamedSharding", "AbstractMesh", "ShardedTensor", "current_mesh",
           "make_production_mesh", "make_mesh", "dp_axes", "dp_size",
           "model_size", "param_shardings", "batch_shardings",
           "cache_shardings", "replicated", "describe_shardings",
           "device_put", "gather", "position_bytes", "dp_rows",
           "model_dim", "gather_model_blocks", "put_model_blocks",
           "row_positions",
           "check_one_rank_a_card", "rows_gather", "sum_in_order",
           "block_values"]

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

    def __enter__(self) -> "Mesh":
        """``with mesh:`` makes this the ambient model mesh
        (:func:`current_mesh`), as the reference's ``with mesh:``."""
        _check_ranks(self)
        _ambient_stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ambient_stack().pop()

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


def shutdown_distributed() -> None:
    """Destroy the process group :func:`init_distributed` made (no-op
    without one), so a later ``init_distributed`` makes a new one."""
    global _DISTRIBUTED_INITIALIZED
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _DISTRIBUTED_INITIALIZED = False


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


# ---------------------------------------------------------------------------
# model meshes: specs, shardings and the ambient mesh
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dim, each ``None``
    (replicated), an axis name, or a tuple of axis names (major first);
    dims past the last entry are replicated."""

    def __new__(cls, *entries):
        for e in entries:
            if not (e is None or isinstance(e, str) or (
                    isinstance(e, tuple)
                    and all(isinstance(a, str) for a in e))):
                raise TypeError(f"a PartitionSpec entry is None, an axis "
                                f"name or a tuple of them; got {e!r}")
        return super().__new__(cls, entries)

    def __repr__(self) -> str:  # jax's text, ``PartitionSpec('model',)``
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class AbstractMesh:
    """Axis names and sizes without devices (``jax.sharding.AbstractMesh``):
    enough to plan a mesh that is not here."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        self.axis_names: Tuple[str, ...] = tuple(names)
        self._sizes = tuple(int(s) for s in sizes)
        if len(self._sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self._sizes} do not fit the axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self._sizes, dtype=np.int64))

    def __enter__(self) -> "AbstractMesh":
        """``with mesh:`` makes this the ambient mesh that
        ``models.act_constraint`` checks its specs against (a dry run
        plans the production meshes without their devices)."""
        _ambient_stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ambient_stack().pop()

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


_AMBIENT = threading.local()


def _ambient_stack() -> list:
    if not hasattr(_AMBIENT, "stack"):
        _AMBIENT.stack = []
    return _AMBIENT.stack


def current_mesh() -> Optional[Any]:
    """The innermost ``with mesh:`` of this thread (a ``Mesh`` or an
    ``AbstractMesh``), or None."""
    stack = _ambient_stack()
    return stack[-1] if stack else None


def _check_ranks(mesh: Mesh) -> None:
    """A model mesh's ranks: one rank that is this process's, or every
    rank of the ``torch.distributed`` group with each data-parallel row
    (:func:`dp_rows`) in one of them; raise otherwise."""
    procs = sorted(set(int(p) for p in np.asarray(mesh.processes).flat))
    if len(procs) == 1:
        if procs != [process_index()]:
            raise ValueError(f"this mesh's devices belong to rank "
                             f"{procs[0]}; this process is rank "
                             f"{process_index()}")
        return
    dp_rows(mesh)  # raises where a row spans ranks
    if procs != list(range(process_count())):
        raise ValueError(
            f"a model mesh over several ranks spans every rank of the "
            f"torch.distributed group; this one spans the ranks {procs} of "
            f"a group of {process_count()} (bring the group up first: "
            "init_distributed)")


def check_one_rank_a_card(devices: Sequence[Any],
                          processes: Sequence[int]) -> None:
    """Raise ``ValueError`` where two ranks of an explicit device list
    name one CUDA device: NCCL refuses two ranks on one card (a device
    list names the devices of one host).  Call it before
    ``init_distributed``; it makes no process group."""
    owner: Dict[str, int] = {}
    for d, p in zip(devices, processes):
        d = torch.device(d)
        if d.type != "cuda":
            continue
        key = str(d if d.index is not None else torch.device("cuda", 0))
        if owner.setdefault(key, int(p)) != int(p):
            raise ValueError(
                f"ranks {owner[key]} and {int(p)} both name {key}: NCCL "
                "refuses two ranks on one card; give each rank its own "
                "card (one card a process), or run the mesh in one process")


def dp_rows(mesh) -> List[Tuple[Tuple[int, ...], torch.device, int]]:
    """The data-parallel rows of a model mesh in mesh index order: for
    each combination of "pod" and "data" coordinates, the position of
    its first entry (the other coordinates 0), that position's device
    and the rank that owns the row.  Raises where a row's positions
    belong to several ranks."""
    names = tuple(mesh.axis_names)
    dps = [i for i, a in enumerate(names) if a in ("pod", "data")]
    procs = np.moveaxis(np.asarray(mesh.processes), dps,
                        list(range(len(dps))))
    lead = procs.shape[:len(dps)]
    procs = procs.reshape(int(np.prod(lead, dtype=np.int64)), -1)
    rows = []
    for r, coords in enumerate(np.ndindex(*lead)):
        ranks = sorted(set(int(p) for p in procs[r]))
        if len(ranks) != 1:
            raise ValueError(
                f"data-parallel row {coords} of the mesh spans the ranks "
                f"{ranks}; a row of a model mesh lives in one process "
                "(one rank)")
        first = [0] * len(names)
        for i, c in zip(dps, coords):
            first[i] = c
        rows.append((tuple(first), mesh.devices[tuple(first)], ranks[0]))
    return rows


def row_positions(mesh) -> List[List[Tuple[int, ...]]]:
    """Each data-parallel row's mesh positions in "model" order, the rows
    in :func:`dp_rows`'s order (a ``Mesh`` or an ``AbstractMesh``)."""
    names = tuple(mesh.axis_names)
    sizes = [mesh.shape[a] for a in names]
    dps = [i for i, a in enumerate(names) if a in ("pod", "data")]
    mi = names.index("model") if "model" in names else None
    out = []
    for coords in np.ndindex(*[sizes[i] for i in dps]):
        first = [0] * len(names)
        for i, c in zip(dps, coords):
            first[i] = c
        if mi is None:
            out.append([tuple(first)])
        else:
            out.append([tuple(first[:mi] + [m] + first[mi + 1:])
                        for m in range(sizes[mi])])
    return out


def _check_spec(mesh, spec: PartitionSpec) -> None:
    seen = []
    for e in spec:
        for a in _axes_of(e):
            if a not in mesh.axis_names:
                raise ValueError(f"axis {a!r} of {spec!r} is not in the mesh "
                                 f"{tuple(mesh.axis_names)}")
            if a in seen:
                raise ValueError(f"axis {a!r} appears twice in {spec!r}")
            seen.append(a)


class NamedSharding:
    """A ``PartitionSpec`` over a mesh (``jax.sharding.NamedSharding``):
    dim i is cut into the product of the sizes of ``spec[i]``'s axes."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = (spec if isinstance(spec, PartitionSpec)
                     else PartitionSpec(*spec))
        _check_spec(mesh, self.spec)

    def _factors(self, ndim: int) -> List[int]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec!r} has more entries than the "
                             f"{ndim} dims it shards")
        sizes = self.mesh.shape
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [int(np.prod([sizes[a] for a in _axes_of(e)], dtype=np.int64))
                for e in spec]

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one block; raises when a dim does not divide."""
        shape = tuple(int(n) for n in global_shape)
        out = []
        for i, (n, f) in enumerate(zip(shape, self._factors(len(shape)))):
            if n % f:
                raise ValueError(
                    f"{self!r} cuts dim {i} of {shape} into {f} blocks, "
                    f"which does not divide {n}")
            out.append(n // f)
        return tuple(out)

    def block_index(self, pos: Tuple[int, ...], ndim: int) -> Tuple[int, ...]:
        """The block that mesh position ``pos`` holds: for each dim, the
        position's coordinates along that dim's axes in mixed radix
        (the first axis major)."""
        coords = dict(zip(self.mesh.axis_names, pos))
        sizes = self.mesh.shape
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        out = []
        for e in spec:
            b = 0
            for a in _axes_of(e):
                b = b * sizes[a] + coords[a]
            out.append(b)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"


# ---------------------------------------------------------------------------
# production meshes
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Single pod 16x16 ("data","model"); multi-pod 2x16x16 adds "pod"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              devices: Optional[Sequence[Any]] = None,
              processes: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (default: every CUDA card of every process, raising without enough of
    them; a list may repeat a device, e.g. ``["cpu"] * 8`` for (2, 4));
    ``processes`` the rank owning each listed device (default this
    process); ``axes`` default to the last ``len(shape)`` of ("pod",
    "data", "model")."""
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    if not shape or len(axes) != len(shape) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} does not fit the axes {axes}")
    need = int(np.prod(shape))
    devs, procs = _device_list(devices, processes)
    if len(devs) < need:
        raise ValueError(f"mesh shape {shape} needs {need} devices, only "
                         f"{len(devs)} available")
    if devices is not None:
        check_one_rank_a_card(devs[:need], procs[:need])
    mesh = Mesh(_object_array(devs[:need]).reshape(shape), axes,
                np.asarray(procs[:need]).reshape(shape))
    _check_ranks(mesh)
    return mesh


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism (pod folds into data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_size(mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def model_size(mesh) -> int:
    return mesh.shape.get("model", 1)


# ---------------------------------------------------------------------------
# sharding planner
#
# Rules (divisibility-checked -- any dim not divisible by its axis size is
# left replicated rather than unevenly sharded):
#
# * parameters: the largest divisible feature dim goes to "model" (ties
#   break toward the *later* dim, i.e. column-parallel for up-projections
#   and row-parallel for down-projections); a second divisible dim goes to
#   the data axes (FSDP/ZeRO-3).  The leading stacked-layers axis is never
#   sharded.
# * MoE expert tensors: the expert dim goes to "model" when divisible
#   (expert parallelism); otherwise the feature rule (qwen2-moe's 60
#   experts on a 16-way model axis).
# * batches: the global-batch dim is sharded over ("pod","data");
#   everything else replicated.  Batch 1 shards the cache sequence dim
#   over the data axes instead (context parallelism).
# * optimizer state: same rule as its parameter (identical shapes).
# ---------------------------------------------------------------------------

def _key_names(path) -> Tuple[str, ...]:
    names = []
    for k in path:
        if hasattr(k, "key"):
            names.append(str(k.key))
        elif hasattr(k, "name"):
            names.append(str(k.name))
        elif hasattr(k, "idx"):
            names.append(f"#{k.idx}")
    return tuple(names)


def _param_spec(names: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                fsdp: bool = True, small_out_threshold: int = 0
                ) -> PartitionSpec:
    md = model_size(mesh)
    dps = dp_axes(mesh)
    dsz = dp_size(mesh)
    ndim = len(shape)
    spec: list = [None] * ndim

    # the leading stacked-layers axis (L or G) is never sharded
    start = 1 if ("layers" in names and ndim >= 2) else 0
    cand = list(range(start, ndim))

    # expert parallelism: 4-D (L, E, D, F) expert tensors
    model_dim: Optional[int] = None
    if any("w" in n for n in names) and "moe" in names and ndim >= 4:
        e_dim = start
        if shape[e_dim] % md == 0:
            model_dim = e_dim
    if model_dim is None:
        best = -1
        for i in cand:
            if md > 1 and shape[i] % md == 0 and shape[i] >= md:
                if shape[i] >= best:
                    best = shape[i]
                    model_dim = i
    # a row-parallel projection with a small output (MLA's w_dkv: 5120 ->
    # 576) would all-reduce partial sums larger than the weight: replicate
    # it over "model" (FSDP still shards it over data)
    if (small_out_threshold and model_dim is not None and ndim >= 2 and
            model_dim == ndim - 2 and shape[-1] <= small_out_threshold):
        model_dim = None
    if model_dim is not None and md > 1:
        spec[model_dim] = "model"

    if fsdp and dps:
        best = -1
        fsdp_dim = None
        for i in cand:
            if i == model_dim:
                continue
            if shape[i] % dsz == 0 and shape[i] >= dsz:
                if shape[i] > best:
                    best = shape[i]
                    fsdp_dim = i
        if fsdp_dim is not None:
            spec[fsdp_dim] = dps if len(dps) > 1 else dps[0]
    return PartitionSpec(*spec)


def param_shardings(tree: Any, mesh, fsdp: bool = True,
                    small_out_threshold: int = 0):
    """NamedShardings for a parameter-shaped pytree (params or opt state)."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return NamedSharding(mesh, PartitionSpec())
        return NamedSharding(mesh, _param_spec(
            _key_names(path), shape, mesh, fsdp=fsdp,
            small_out_threshold=small_out_threshold))
    return tree_map_with_path(one, tree)


def _dp_entry(mesh):
    dps = dp_axes(mesh)
    return dps if len(dps) > 1 else (dps[0] if dps else None)


def batch_shardings(tree: Any, mesh, global_batch: int):
    """Shard the global-batch dim over ("pod","data")."""
    dsz = dp_size(mesh)
    dp = _dp_entry(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if global_batch % max(dsz, 1) == 0 and dsz > 1:
            for i, s in enumerate(shape):
                if s == global_batch:
                    spec[i] = dp
                    break
        return NamedSharding(mesh, PartitionSpec(*spec))
    return tree_map(one, tree)


def cache_shardings(tree: Any, mesh, global_batch: int, seq_len: int,
                    context_parallel: bool = False):
    """Decode-cache sharding.

    Baseline: batch dim -> data axes; a KV/feature dim -> "model" when
    divisible; batch=1 -> cache sequence dim -> data axes.

    ``context_parallel=True``: the cache *sequence* dim is sharded over
    "model" instead of the feature dim, so a decode token gathers only
    O(B*H*S) score statistics instead of the whole cache."""
    dsz = dp_size(mesh)
    md = model_size(mesh)
    dp = _dp_entry(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec: list = [None] * ndim
        if ndim <= 1:
            return NamedSharding(mesh, PartitionSpec(*spec))
        dp_dim = None
        if dsz > 1 and global_batch % dsz == 0 and global_batch > 1:
            for i in range(1, ndim):
                if shape[i] == global_batch:
                    dp_dim = i
                    spec[i] = dp
                    break
        elif dsz > 1:
            # batch too small: context-parallel the sequence dim over data
            for i in range(1, ndim):
                if shape[i] == seq_len and seq_len % dsz == 0:
                    dp_dim = i
                    spec[i] = dp
                    break
        if md > 1:
            mdim = None
            if context_parallel:
                for i in range(1, ndim):
                    if i != dp_dim and shape[i] == seq_len and \
                            seq_len % md == 0:
                        mdim = i
                        break
            if mdim is None and not context_parallel:
                best = -1
                for i in range(1, ndim):
                    if i == dp_dim or shape[i] == seq_len:
                        continue
                    if shape[i] % md == 0 and shape[i] >= md and \
                            shape[i] > best:
                        best = shape[i]
                        mdim = i
            if mdim is not None:
                spec[mdim] = "model"
        return NamedSharding(mesh, PartitionSpec(*spec))
    return tree_map(one, tree)


def replicated(tree: Any, mesh):
    return tree_map(lambda _: NamedSharding(mesh, PartitionSpec()), tree)


def describe_shardings(tree, shardings, max_rows: int = 0):
    """Human-readable (path, shape, spec) rows."""
    rows = []
    flat_t = tree_flatten_with_path(tree)[0]
    flat_s = tree_leaves(shardings)
    for (path, leaf), sh in zip(flat_t, flat_s):
        rows.append(("/".join(_key_names(path)), tuple(leaf.shape),
                     str(sh.spec)))
    if max_rows:
        rows = rows[:max_rows]
    return rows


# ---------------------------------------------------------------------------
# sharded tensors
# ---------------------------------------------------------------------------

class ShardedTensor:
    """A global tensor of ``shape`` cut by ``sharding`` onto its mesh:
    ``shards[pos]`` is the block that mesh position ``pos`` holds, on that
    position's device, or None where another ``torch.distributed`` rank
    owns the position (:meth:`is_local`).  Positions that hold one block
    on one device share one tensor (replicas along the axes the spec
    leaves out)."""

    def __init__(self, sharding: NamedSharding, shape: Tuple[int, ...],
                 shards: np.ndarray):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        return next(t for t in self.shards.flat if t is not None).dtype

    @property
    def n_blocks(self) -> int:
        """The number of distinct blocks (the product of the cut factors)."""
        return int(np.prod(self.sharding._factors(len(self.shape)),
                           dtype=np.int64))

    def is_local(self, pos: Tuple[int, ...]) -> bool:
        """Whether this rank holds position ``pos``'s block."""
        return self.shards[pos] is not None

    def _positions(self):
        """The positions this rank holds, in mesh index order."""
        return (pos for pos in np.ndindex(*self.shards.shape)
                if self.shards[pos] is not None)

    def blocks(self) -> List[torch.Tensor]:
        """One tensor a distinct block this rank holds (every block in one
        process), in mesh index order (the first position that holds
        it)."""
        seen: Dict[tuple, torch.Tensor] = {}
        for pos in self._positions():
            b = self.sharding.block_index(pos, len(self.shape))
            seen.setdefault(b, self.shards[pos])
        return list(seen.values())

    def with_blocks(self, blocks: Sequence[torch.Tensor]) -> "ShardedTensor":
        """This sharding holding ``blocks`` (as :meth:`blocks` orders them)
        in place of its own, each on its positions' devices."""
        order: Dict[tuple, int] = {}
        for pos in self._positions():
            order.setdefault(self.sharding.block_index(pos, len(self.shape)),
                             len(order))
        return _place(self.sharding, self.shape,
                      lambda b, dev: blocks[order[b]].to(dev))

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"sharding={self.sharding!r})")


def _block_slices(sharding: NamedSharding, shape, block) -> tuple:
    sub = sharding.shard_shape(shape)
    return tuple(slice(b * n, (b + 1) * n) for b, n in zip(block, sub))


def _place(sharding: NamedSharding, shape, make_block) -> ShardedTensor:
    """A ``ShardedTensor`` whose position ``pos`` holds ``make_block(block
    index, device)``, made once per (device, block), at the positions
    this rank owns (None at the others)."""
    mesh = sharding.mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{mesh!r} holds no devices to put a tensor on")
    _check_ranks(mesh)
    sharding.shard_shape(shape)  # raises where a dim does not divide
    made: Dict[tuple, torch.Tensor] = {}
    shards = np.empty(mesh.devices.shape, dtype=object)
    me = process_index()
    for pos in np.ndindex(*mesh.devices.shape):
        if int(mesh.processes[pos]) != me:
            continue
        dev = mesh.devices[pos]
        b = sharding.block_index(pos, len(shape))
        if (str(dev), b) not in made:
            made[(str(dev), b)] = make_block(b, dev)
        shards[pos] = made[(str(dev), b)]
    return ShardedTensor(sharding, shape, shards)


def _put(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    shape = tuple(x.shape)

    def cut(block, dev):
        piece = x[_block_slices(sharding, shape, block)]
        return torch.empty(piece.shape, dtype=piece.dtype,
                           device=dev).copy_(piece)
    return _place(sharding, shape, cut)


def device_put(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` cut by the ``NamedSharding`` at the same
    place of ``shardings`` into a :class:`ShardedTensor`: one block a mesh
    position, copied onto that position's device.  A dim that does not
    divide into its axes raises."""
    return tree_map(_put, tree, shardings)


def _first_holders(x: ShardedTensor) -> Dict[tuple, Tuple[tuple, int]]:
    """Each distinct block of ``x`` (in mesh index order): the first
    position that holds it and that position's rank."""
    mesh = x.sharding.mesh
    out: Dict[tuple, Tuple[tuple, int]] = {}
    for pos in np.ndindex(*mesh.devices.shape):
        out.setdefault(x.sharding.block_index(pos, len(x.shape)),
                       (pos, int(mesh.processes[pos])))
    return out


def _everywhere(x: ShardedTensor) -> bool:
    """Whether every rank of ``x``'s mesh holds every block (the same
    answer on every rank: it reads the mesh, not the tensors)."""
    mesh = x.sharding.mesh
    ranks = set(int(p) for p in mesh.processes.flat)
    if len(ranks) == 1:
        return True
    held: Dict[tuple, set] = {}
    for pos in np.ndindex(*mesh.devices.shape):
        held.setdefault(x.sharding.block_index(pos, len(x.shape)),
                        set()).add(int(mesh.processes[pos]))
    return all(h == ranks for h in held.values())


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _all_gather_bytes(buf: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's uint8 ``buf`` (of one length), in rank order."""
    out = [torch.empty_like(buf) for _ in range(process_count())]
    torch.distributed.all_gather(out, buf)
    return out


def _all_blocks(x: ShardedTensor) -> Dict[tuple, torch.Tensor]:
    """Every distinct block of ``x`` by its block index, in mesh index
    order: this rank's own tensors, and where some rank lacks a block
    (every rank of the mesh calls it then) the blocks all-gathered from
    the rank of each block's first position, as bytes."""
    if _everywhere(x):
        seen: Dict[tuple, torch.Tensor] = {}
        for pos in x._positions():
            seen.setdefault(x.sharding.block_index(pos, len(x.shape)),
                            x.shards[pos])
        return seen
    holders = _first_holders(x)
    me = process_index()
    mine = [x.shards[pos] for pos, r in holders.values() if r == me]
    per_rank = [sum(1 for _, r in holders.values() if r == k)
                for k in range(process_count())]
    sub = x.sharding.shard_shape(x.shape)
    local = x.shards[next(x._positions())]
    nbytes = int(np.prod(sub, dtype=np.int64)) * local.element_size()
    buf = torch.zeros(max(per_rank) * nbytes, dtype=torch.uint8,
                      device=local.device)
    for j, t in enumerate(mine):
        buf[j * nbytes:(j + 1) * nbytes].copy_(_as_bytes(t))
    parts = _all_gather_bytes(buf)
    taken = [0] * process_count()
    out: Dict[tuple, torch.Tensor] = {}
    for b, (_, r) in holders.items():
        j = taken[r]
        taken[r] += 1
        out[b] = parts[r][j * nbytes:(j + 1) * nbytes].view(
            x.dtype).reshape(sub)
    return out


def gather(x: ShardedTensor, device=None) -> torch.Tensor:
    """The all-gather: ``x``'s blocks put together in mesh index order on
    ``device`` (default the mesh's first); bitwise the tensor that was
    cut.  Where some rank lacks a block, every rank of the mesh must call
    it (a ``torch.distributed`` all-gather of each block from the rank of
    its first position)."""
    dev = torch.device(device if device is not None
                       else x.sharding.mesh.devices.flat[0])
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    for b, t in _all_blocks(x).items():
        out[_block_slices(x.sharding, x.shape, b)].copy_(t)
    return out


def model_dim(sharding: NamedSharding, ndim: int) -> Optional[int]:
    """The dim ``sharding`` cuts over "model" (None where it leaves the
    leaf whole over it); raises where "model" shares a dim with another
    axis, which the planner never does."""
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    dims = [i for i, e in enumerate(spec) if "model" in _axes_of(e)]
    if not dims:
        return None
    if _axes_of(spec[dims[0]]) != ("model",):
        raise ValueError(f"{sharding.spec!r} cuts one dim over 'model' and "
                         "another axis")
    return dims[0]


def _in_model_block(sharding: NamedSharding, shape, block, mdim) -> tuple:
    """Where ``block`` lies inside its "model" block (the leaf cut over
    "model" alone)."""
    sub = sharding.shard_shape(shape)
    return tuple(slice(0, n) if d == mdim else slice(b * n, (b + 1) * n)
                 for d, (b, n) in enumerate(zip(block, sub)))


def gather_model_blocks(x: ShardedTensor, wanted: Sequence[Tuple[int, Any]]
                        ) -> List[torch.Tensor]:
    """The FSDP gather of tensor parallelism: for each ``(m, device)`` of
    ``wanted``, ``x``'s block ``m`` over "model" (the whole leaf where
    ``x`` is not cut over it), whole over the other axes, on ``device``;
    bitwise the slices of the tensor that was cut.  Where some rank lacks
    a block every rank of the mesh must call it (as :func:`gather`)."""
    mdim = model_dim(x.sharding, len(x.shape))
    shape = list(x.shape)
    if mdim is not None:
        shape[mdim] //= model_size(x.sharding.mesh)
    blocks = _all_blocks(x)
    out = []
    for m, dev in wanted:
        t = torch.empty(shape, dtype=x.dtype, device=torch.device(dev))
        for b, block in blocks.items():
            if mdim is None or b[mdim] == m:
                t[_in_model_block(x.sharding, x.shape, b, mdim)].copy_(block)
        out.append(t)
    return out


def put_model_blocks(blocks: Sequence[torch.Tensor],
                     sharding: NamedSharding, shape) -> ShardedTensor:
    """The inverse of :func:`gather_model_blocks`: a tensor of ``shape``
    given as its blocks over "model" (one, the whole tensor, where
    ``sharding`` does not cut it over "model"), cut by ``sharding`` onto
    the positions this rank owns, one copy a distinct (device, block)
    pair as :func:`device_put` makes them."""
    shape = tuple(shape)
    mdim = model_dim(sharding, len(shape))

    def cut(block, dev):
        piece = blocks[0 if mdim is None else block[mdim]][
            _in_model_block(sharding, shape, block, mdim)]
        return torch.empty(piece.shape, dtype=piece.dtype,
                           device=dev).copy_(piece)
    return _place(sharding, shape, cut)


def position_bytes(tree: Any) -> np.ndarray:
    """The bytes each mesh position holds of the ``ShardedTensor`` leaves
    of ``tree`` (an array of the mesh's shape; a tensor that several
    positions share counts once for each); -1 at the positions another
    rank owns."""
    total = None
    for leaf in tree_leaves(tree):
        sizes = np.vectorize(
            lambda t: -1 if t is None else t.numel() * t.element_size(),
            otypes=[np.int64])(leaf.shards)
        total = sizes if total is None else np.where(sizes < 0, -1,
                                                     total + sizes)
    return total


# ---------------------------------------------------------------------------
# cross-rank exchanges of a data-parallel step
# ---------------------------------------------------------------------------

def rows_gather(mesh: Mesh, mine: Dict[int, torch.Tensor]
                ) -> List[torch.Tensor]:
    """Every data-parallel row's tensor in row order, on every rank:
    ``mine`` maps the index (in :func:`dp_rows`) of each row this rank
    owns to its tensor; every row's tensor has one shape and dtype.  In
    one process it is ``mine``'s values in row order; across ranks an
    all-gather (of the bytes, so any dtype crosses bitwise) that every
    rank of the mesh calls, with the same number of rows in each rank.
    The tensors come back on the device of this rank's first row's."""
    rows = dp_rows(mesh)
    if len(set(r for _, _, r in rows)) == 1:
        return [mine[i] for i in range(len(rows))]
    me = process_index()
    owned = {k: [i for i, (_, _, r) in enumerate(rows) if r == k]
             for k in range(process_count())}
    if len({len(v) for v in owned.values()}) != 1:
        raise ValueError(f"the ranks own unequal numbers of rows: {owned}")
    first = mine[owned[me][0]]
    parts = _all_gather_bytes(torch.cat([_as_bytes(mine[i])
                                         for i in owned[me]]))
    n = first.numel() * first.element_size()
    out: List[Optional[torch.Tensor]] = [None] * len(rows)
    for k, idx in owned.items():
        for j, i in enumerate(idx):
            out[i] = mine[i] if k == me else parts[k][
                j * n:(j + 1) * n].view(first.dtype).reshape(first.shape)
    return out


def sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``((p0 + p1) + p2) + ...`` on ``p0``'s device: the one order every
    rank and a one-process run take."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def block_values(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]
                 ) -> List[torch.Tensor]:
    """``fn`` (a 0-d float32 tensor) of every distinct block of the
    ``ShardedTensor`` leaves of ``tree``: leaves in tree order, each
    leaf's blocks in mesh index order, every block counted once however
    many positions or ranks hold it.  Each block's value is computed by
    the rank of its first position and all-gathered, so every rank gets
    the one-process run's values bitwise (every rank of the mesh calls
    it)."""
    leaves = tree_leaves(tree)
    if all(_everywhere(x) for x in leaves):
        return [fn(b) for x in leaves for b in x.blocks()]
    me = process_index()
    order: List[Tuple[int, int]] = []           # (rank, index in its list)
    counts = [0] * process_count()
    mine: List[torch.Tensor] = []
    for x in leaves:
        for b, (pos, r) in _first_holders(x).items():
            order.append((r, counts[r]))
            counts[r] += 1
            if r == me:
                mine.append(fn(x.shards[pos]).reshape(1))
    dev = mine[0].device if mine else next(
        leaves[0].shards[p] for p in leaves[0]._positions()).device
    buf = torch.zeros(max(counts), dtype=torch.float32, device=dev)
    if mine:
        buf[:len(mine)] = torch.cat(mine)
    parts = [p.view(torch.float32) for p in _all_gather_bytes(_as_bytes(buf))]
    return [parts[r][j] for r, j in order]
