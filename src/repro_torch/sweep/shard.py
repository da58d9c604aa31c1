"""Sharded mega-grid sweeps (counterpart of ``repro.sweep.shard``).

The batched runners (``.runners``) advance a bucket's cells together on
one device.  This module partitions the **cell axis** of a bucket across
the rows of a ``("cells",)`` or ``("cells", "data")`` mesh
(``repro_torch.mesh``):

* the padded stacked inputs (service times or client rounds, masks,
  policy parameters, fault seeds) are cut into C contiguous blocks along
  the cell axis, one per cells-axis row; each block is gathered from the
  host and moved to its row's device on its own, so the whole padded
  batch never sits on one card (the port's counterpart of the
  reference's argument donation);
* each row runs the port's batched program of the bucket
  (``make_sweep_piag`` / ``make_sweep_bcd`` / the federated race + server
  loop), built once per row device (cached under the bucket's key, the
  mesh's topology and the row's devices) on that device's replica of the
  captured ``x0``, worker data and problem; under ``engine='fused'`` each
  row launches the event kernel once an event on its own card, with that
  card current;
* the rows come back to the first device in cell order and the padding
  is dropped, so a sharded row is the same computation as a batched row;
* on a 2-D mesh each row's gradients run data-parallel over the row's
  data devices (``mesh.data_parallel_grad``): the per-worker sample axis
  is cut in contiguous slices, one per data device, and the partial
  gradients are summed in index order on the row's device.  Integer
  leaves and gammas stay exact; objectives move within float rounding;
* ``round_robin_pad`` keeps the reference's index map (at least 2 cells
  a shard when C > 1), so bucket shapes and cache keys match it;
* with several processes (``torch.distributed``) each process runs the
  rows whose devices it owns and the rows are all-gathered in cell order.

Shards run in turn from one thread: the launches are asynchronous, so
rows on different cards overlap on the devices while the host launches
the next row.  Captured objects reach a row's device through ``replicate``:
tensors are copied, bound methods of dataclass problems are rebound to a
copy of the problem on the device, and a ``PerDevice`` capture is built
anew for each row from the row's devices.  Any other capture is used as
it is and must not hold tensors of another device (a kernel or a product
over two devices raises).  Two parts of the reference have no
counterpart here: ``_settle_replicas`` (a jax-0.4 workaround) and
argument donation (replaced as above).
"""
from __future__ import annotations

import dataclasses
import types
import warnings
from contextlib import nullcontext
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.bcd import BCDResult, sample_blocks
from ..core.pytree import tree_leaves, tree_map
from ..core.piag import PIAGResult, default_grad_fn
from ..core.prox import ProxOp
from ..federated.events import default_fed_steps
from ..federated.server import FedResult
from ..faults.spec import normalize_faults
from ..mesh import (Mesh, cell_axis_size, cell_mesh,
                    data_axis_size, data_parallel_grad, grid_mesh,
                    mesh_topology, process_count, process_index)
from ..telemetry.timing import timed
from .cache import LRU, IdKey, cached_program, tree_key
from .grid import SweepBucket, SweepGrid
from .runners import (Horizon, _cell_seeds, _check_fed_diag, _fed_cell,
                      _fedasync_scan_adapter, _fedbuff_scan_adapter,
                      _slice_workers, _stack_fed_rounds, make_sweep_bcd,
                      make_sweep_piag, resolve_grid_horizon, run_bucketed)

__all__ = ["cell_mesh", "grid_mesh", "mesh_topology", "round_robin_pad",
           "shard_cells", "PerDevice", "replicate",
           "make_sharded_sweep_piag", "sharded_sweep_piag",
           "sharded_sweep_piag_logreg",
           "make_sharded_sweep_bcd", "sharded_sweep_bcd",
           "sharded_sweep_fedasync", "sharded_sweep_fedbuff"]


def round_robin_pad(n_cells: int, n_cell_shards: int) -> np.ndarray:
    """Index map of length ``max(ceil(B / C), 2) * C`` (the 2 only when
    ``C > 1``) cycling through the B cells, where C is the size of the
    mesh's **cells axis** -- not the device count: a (2, 4) mesh pads
    like a (2,) mesh.  Padding replays real cells, so every shard has
    the same shape and live work; callers drop rows ``>= n_cells``.  The
    minimum of 2 cells a shard is the reference's rule, kept so bucket
    shapes and cache keys agree with it."""
    if n_cells < 1:
        raise ValueError("empty grid")
    per_shard = max(-(-n_cells // n_cell_shards),
                    2 if n_cell_shards > 1 else 1)
    return np.arange(per_shard * n_cell_shards) % n_cells


# ------------------------------------------------------ replication ----

class PerDevice:
    """A capture built anew for each mesh row: ``build(devices)`` gets
    the row's devices (the first runs the row's program, all of them its
    data-parallel gradient) and returns the object to use there."""

    __slots__ = ("build",)

    def __init__(self, build: Callable[[List[torch.device]], Any]):
        self.build = build


_REPLICAS = LRU(64)


def _problem_replica(obj, device: torch.device):
    """``obj`` (a dataclass) with its tensor fields on ``device``; ``obj``
    itself when they already are."""
    moves = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
             if f.init and isinstance(getattr(obj, f.name), torch.Tensor)}
    moves = {k: v for k, v in moves.items() if v.device != device}
    if not moves:
        return obj
    return _REPLICAS.get((IdKey(obj), str(device)), lambda: dataclasses.replace(
        obj, **{k: v.to(device) for k, v in moves.items()}))


def replicate(obj, device):
    """``obj`` as a program on ``device`` captures it: tensors (in tuples,
    lists and NamedTuples) copied there, bound methods of dataclasses
    rebound to a copy of their instance there, dataclasses with tensor
    fields copied, ``PerDevice`` built for ``[device]``; anything else as
    it is.  On the device the objects already live on, the same objects
    come back."""
    device = torch.device(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, PerDevice):
        return obj.build([device])
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(replicate(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(replicate(v, device) for v in obj)
    if isinstance(obj, types.MethodType) and \
            dataclasses.is_dataclass(obj.__self__):
        rep = _problem_replica(obj.__self__, device)
        return obj if rep is obj.__self__ else getattr(rep,
                                                       obj.__func__.__name__)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _problem_replica(obj, device)
    return obj


def _on_row(capture, row: List[torch.device]):
    """A per-row capture: ``PerDevice`` built for the row, anything else
    replicated onto the row's device."""
    if isinstance(capture, PerDevice):
        return capture.build(row)
    return replicate(capture, row[0])


# --------------------------------------------------------- dispatch ----

def _device_ctx(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _take(a, index: np.ndarray, dev: torch.device):
    """Rows ``index`` of a leaf (numpy on the host, or a tensor) as a
    tensor on ``dev``; non-array leaves pass through."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a[index])).to(dev)
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(index, device=a.device)].to(dev)
    return a


def _gather_processes(outs: list, rows: Sequence[int], dest: torch.device):
    """Every process's row outputs in row order, on ``dest`` (an
    all-gather of host copies when the rows live in several processes)."""
    if process_count() == 1:
        return [o for _, o in sorted(zip(rows, outs), key=lambda t: t[0])]
    mine = [(r, tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor)
                         else t, o)) for r, o in zip(rows, outs)]
    gathered: List[Any] = [None] * process_count()
    torch.distributed.all_gather_object(gathered, mine)
    flat = sorted((p for part in gathered for p in part), key=lambda t: t[0])
    return [tree_map(lambda t: t.to(dest) if isinstance(t, torch.Tensor)
                     else t, o) for _, o in flat]


def _cat_rows(outs: list, dest: torch.device):
    def cat(*xs):
        if not isinstance(xs[0], torch.Tensor):
            return xs[0]
        return torch.cat([x.to(dest) for x in xs], dim=0)

    return outs[0] if len(outs) == 1 else tree_map(cat, *outs)


def shard_cells(build: Callable[[List[torch.device]], Callable], mesh: Mesh,
                n_args: Optional[int] = None,
                cache_key: Optional[tuple] = None) -> Callable:
    """The sharded form of a batched program: ``fn(*args, index=None)``
    cuts the cell axis of every argument into one contiguous block per
    cells-axis row of ``mesh`` (the batch must be a multiple of the row
    count; ``index``, when given, is the padded row order to gather the
    blocks by, on the host), runs ``build(row_devices)`` -- the batched
    program of that row, cached once per row device under ``cache_key`` --
    on each block with the row's card current, and returns the outputs
    concatenated in cell order on the first device this process owns."""
    rows = mesh.rows()
    me = process_index()
    mine = [r for r in range(len(rows)) if mesh.row_process(r) == me]
    if not mine:
        raise ValueError(f"process {me} owns no row of {mesh!r}")
    dest = rows[mine[0]][0]

    def program(r: int):
        row = rows[r]
        if cache_key is None:
            return build(row)
        return cached_program(cache_key + (tuple(str(d) for d in row),),
                              lambda: build(row))

    def fn(*args, index: Optional[np.ndarray] = None):
        if n_args is not None and len(args) != n_args:
            raise TypeError(f"sharded program takes {n_args} arguments, "
                            f"got {len(args)}")
        B = len(index) if index is not None else _batch(args)
        if B % len(rows):
            raise ValueError(f"batch {B} is not a multiple of the cells "
                             f"axis ({len(rows)}); pad with round_robin_pad")
        per = B // len(rows)
        order = np.arange(B) if index is None else np.asarray(index)
        outs = []
        for r in mine:
            dev = rows[r][0]
            block = tree_map(lambda a: _take(a, order[r * per:(r + 1) * per],
                                             dev), args)
            with _device_ctx(dev):
                outs.append(program(r)(*block))
        return _cat_rows(_gather_processes(outs, mine, dest), dest)

    return fn


def _batch(args) -> int:
    for leaf in tree_leaves(args):
        if isinstance(leaf, (np.ndarray, torch.Tensor)):
            return int(leaf.shape[0])
    raise ValueError("no array argument to take the batch size from")


def _unpad(tree, n: int):
    return tree_map(lambda x: x[:n] if isinstance(x, torch.Tensor) else x,
                    tree)


def _run_sharded_bucket(build, mesh: Mesh, args, n_cells: int,
                        n_args: int, cache_key: Optional[tuple] = None):
    """Pad the stacked host inputs to a cells-axis multiple (replaying
    cells), run each row's program on its block, drop the padding."""
    idx = round_robin_pad(n_cells, cell_axis_size(mesh))
    fn = shard_cells(build, mesh, n_args=n_args, cache_key=cache_key)
    # telemetry: dispatch wall time across the mesh
    with timed("sharded_dispatch", devices=int(mesh.size),
               data_shards=data_axis_size(mesh), cells=int(n_cells)):
        out = fn(*args, index=idx)
    return _unpad(out, n_cells)


# ---------------------------------------------------------------- PIAG ----

def _row_worker_grad(grad_fn, worker_loss, worker_data, row):
    """The batched worker gradient ``(xw, w) -> (B, d)`` of one row:
    ``grad_fn`` built for the row (``PerDevice``) or as given (a plain
    one runs on the row's first device); without it autograd of
    ``worker_loss``, data-parallel over the row's data devices when there
    are several."""
    if grad_fn is not None:
        return _on_row(grad_fn, row)
    if len(row) == 1:
        return None  # piag_scan's autograd default on the row's replica
    return data_parallel_grad(
        lambda *part: default_grad_fn(replicate(worker_loss,
                                                part[0].device), part),
        worker_data, row, sample_axis=1)


def _piag_row_build(worker_loss, x0, worker_data, prox, objective, horizon,
                    use_tau_max, masked, record_every, telemetry, engine,
                    faults, grad_fn, width: Optional[int] = None):
    def build(row):
        dev = row[0]
        wd = replicate(worker_data, dev)
        if width is not None:
            wd = _slice_workers(wd, width)
        return make_sweep_piag(
            replicate(worker_loss, dev), replicate(x0, dev), wd,
            replicate(prox, dev), objective=replicate(objective, dev),
            horizon=horizon, use_tau_max=use_tau_max, masked=masked,
            record_every=record_every, telemetry=telemetry, engine=engine,
            grad_fn=_row_worker_grad(grad_fn, worker_loss, wd, row),
            faults=faults)

    return build


def make_sharded_sweep_piag(worker_loss: Callable, x0, worker_data,
                            prox: ProxOp, objective: Optional[Callable] = None,
                            horizon: int = 4096, use_tau_max: bool = True,
                            masked: bool = False,
                            mesh: Optional[Mesh] = None,
                            record_every: int = 1, telemetry=None,
                            engine: str = "fused", faults=None,
                            grad_fn=None) -> Callable:
    """Sharded twin of ``make_sweep_piag``: the same arguments and row
    values, with the batch cut across ``mesh``'s cells axis (a multiple of
    it; see ``round_robin_pad``).  On a 2-D mesh the worker gradients run
    data-parallel over each row's data devices.  ``grad_fn`` is the
    batched gradient seam of ``make_sweep_piag`` (a ``PerDevice`` to build
    it for each row)."""
    mesh = cell_mesh() if mesh is None else mesh
    faults = normalize_faults(faults)
    n_args = (3 if masked else 2) + (1 if faults is not None else 0)
    return shard_cells(_piag_row_build(
        worker_loss, x0, worker_data, prox, objective, horizon, use_tau_max,
        masked, record_every, telemetry, engine, faults, grad_fn), mesh,
        n_args=n_args)


def sharded_sweep_piag(worker_loss: Callable, x0, worker_data,
                       grid: SweepGrid, prox: ProxOp,
                       objective: Optional[Callable] = None,
                       horizon: Horizon = 4096, use_tau_max: bool = True,
                       mesh: Optional[Mesh] = None,
                       bucket_widths: Optional[Sequence[int]] = None,
                       record_every: int = 1, telemetry=None,
                       engine: str = "fused", faults=None,
                       checkpoint=None, grad_fn=None) -> PIAGResult:
    """``sweep_piag`` with the cell axis sharded across the mesh's cells
    axis; a 2-D ``(cells, data)`` mesh adds data-parallel worker
    gradients.  Rows equal ``sweep_piag``'s in every integer leaf and
    gamma."""
    mesh = cell_mesh() if mesh is None else mesh
    horizon = resolve_grid_horizon(horizon, grid, device=x0.device)
    faults = normalize_faults(faults)

    def run_bucket(b: SweepBucket):
        key = ("piag/sharded", b.width, not b.uniform, horizon, use_tau_max,
               record_every, telemetry, engine, faults, mesh_topology(mesh),
               IdKey(worker_loss), tree_key(x0), tree_key(worker_data),
               IdKey(prox), IdKey(objective), IdKey(grad_fn))
        pp = b.grid.policy_params("cpu")
        T = b.grid.service_times(b.width)
        args = ((T, pp) if b.uniform else
                (T, b.grid.active_masks(b.width), pp))
        if faults is not None:
            args = args + (_cell_seeds(b, "cpu"),)
        return _run_sharded_bucket(
            _piag_row_build(worker_loss, x0, worker_data, prox, objective,
                            horizon, use_tau_max, not b.uniform,
                            record_every, telemetry, engine, faults, grad_fn,
                            width=b.width),
            mesh, args, len(b.grid), n_args=len(args), cache_key=key)

    return run_bucketed(grid, run_bucket, bucket_widths,
                        checkpoint=checkpoint)


def sharded_sweep_piag_logreg(problem, grid: SweepGrid, prox: ProxOp,
                              horizon: int = 4096,
                              mesh: Optional[Mesh] = None,
                              engine: str = "fused") -> PIAGResult:
    """Sharded twin of ``sweep_piag_logreg`` (routed through
    ``api.run_components``)."""
    from ..api import run_components
    return run_components("piag", "sharded", problem=problem, grid=grid,
                          prox=prox, horizon=horizon, mesh=mesh,
                          engine=engine).raw


# ----------------------------------------------------------- Async-BCD ----

def _pick_bcd_grad(grad_f: Callable, dp_grad_f, mesh: Mesh):
    """On a 2-D mesh, the data-parallel full gradient when given.

    BCD's ``grad_f`` is an opaque x -> grad closure, so the runner cannot
    rebuild it data-parallel itself; the api layer builds ``dp_grad_f``
    (a ``PerDevice`` over ``mesh.data_parallel_grad``).  A 2-D mesh
    without one still computes correct rows on each row's first device,
    so it warns instead of raising."""
    if data_axis_size(mesh) <= 1:
        return grad_f
    if dp_grad_f is None:
        warnings.warn(
            "sharded BCD on a (cells, data) mesh without dp_grad_f: the "
            "gradient runs replicated on the row's first device (correct "
            "but no data parallelism); pass dp_grad_f (a sweep.shard."
            "PerDevice built with repro_torch.mesh.data_parallel_grad) or "
            "use the repro_torch.api spec path",
            RuntimeWarning, stacklevel=3)
        return grad_f
    return dp_grad_f


def _bcd_row_build(gf, objective, x0, m, n_workers, prox, horizon, masked,
                   record_every, telemetry, engine, faults):
    def build(row):
        dev = row[0]
        return make_sweep_bcd(
            _on_row(gf, row), replicate(objective, dev), replicate(x0, dev),
            m, n_workers, replicate(prox, dev), horizon=horizon,
            masked=masked, record_every=record_every, telemetry=telemetry,
            engine=engine, faults=faults)

    return build


def make_sharded_sweep_bcd(grad_f: Callable, objective: Callable, x0, m: int,
                           n_workers: int, prox: ProxOp, horizon: int = 4096,
                           masked: bool = False,
                           mesh: Optional[Mesh] = None,
                           record_every: int = 1, telemetry=None,
                           engine: str = "fused", faults=None,
                           dp_grad_f=None) -> Callable:
    """Sharded twin of ``make_sweep_bcd`` (the batch a cells-axis
    multiple).  ``dp_grad_f`` replaces ``grad_f`` on 2-D meshes (see
    ``_pick_bcd_grad``)."""
    mesh = cell_mesh() if mesh is None else mesh
    faults = normalize_faults(faults)
    gf = _pick_bcd_grad(grad_f, dp_grad_f, mesh)
    n_args = (4 if masked else 3) + (1 if faults is not None else 0)
    return shard_cells(_bcd_row_build(gf, objective, x0, m, n_workers, prox,
                                      horizon, masked, record_every,
                                      telemetry, engine, faults), mesh,
                       n_args=n_args)


def sharded_sweep_bcd(grad_f: Callable, objective: Callable, x0, m: int,
                      grid: SweepGrid, prox: ProxOp, horizon: Horizon = 4096,
                      mesh: Optional[Mesh] = None,
                      bucket_widths: Optional[Sequence[int]] = None,
                      record_every: int = 1, telemetry=None,
                      engine: str = "fused", faults=None,
                      checkpoint=None, dp_grad_f=None) -> BCDResult:
    """``sweep_bcd`` with the cell axis sharded; on a 2-D mesh pass
    ``dp_grad_f`` to partition the gradient (see ``_pick_bcd_grad``)."""
    mesh = cell_mesh() if mesh is None else mesh
    horizon = resolve_grid_horizon(horizon, grid, device=x0.device)
    faults = normalize_faults(faults)
    gf = _pick_bcd_grad(grad_f, dp_grad_f, mesh)

    def run_bucket(b: SweepBucket):
        key = ("bcd/sharded", b.width, not b.uniform, horizon, m,
               record_every, telemetry, engine, faults, mesh_topology(mesh),
               IdKey(gf), IdKey(objective), tree_key(x0), IdKey(prox))
        T = b.grid.service_times(b.width)
        blocks = np.stack([sample_blocks(m, grid.n_events, seed=c.seed)
                           for c in b.grid.cells])
        pp = b.grid.policy_params("cpu")
        args = ((T, blocks, pp) if b.uniform else
                (T, b.grid.active_masks(b.width), blocks, pp))
        if faults is not None:
            args = args + (_cell_seeds(b, "cpu"),)
        return _run_sharded_bucket(
            _bcd_row_build(gf, objective, x0, m, b.width, prox, horizon,
                           not b.uniform, record_every, telemetry, engine,
                           faults),
            mesh, args, len(b.grid), n_args=len(args), cache_key=key)

    return run_bucketed(grid, run_bucket, bucket_widths,
                        checkpoint=checkpoint)


# ------------------------------------------------- FedAsync / FedBuff ----

def _sharded_sweep_fed(adapter_for, grid: SweepGrid, client_update, x0,
                       client_data, objective, buffer_size: int,
                       n_steps: Optional[int], mesh: Optional[Mesh],
                       bucket_widths: Optional[Sequence[int]] = None,
                       cache_key: Optional[tuple] = None, faults=None,
                       checkpoint=None) -> FedResult:
    mesh = cell_mesh() if mesh is None else mesh
    K = grid.n_events
    S = default_fed_steps(K) if n_steps is None else int(n_steps)

    def run_bucket(b: SweepBucket):
        key = None if cache_key is None else \
            cache_key + (b.width, S, mesh_topology(mesh))
        rounds, cparams, active = _stack_fed_rounds(b.grid, b.width, S)
        args = (rounds, cparams, active, b.grid.policy_params("cpu"))
        if faults is not None:
            args = args + (_cell_seeds(b, "cpu"),)

        def build(row):
            dev = row[0]
            cd = _slice_workers(replicate(client_data, dev), b.width)
            return _fed_cell(adapter_for(_on_row(client_update, row),
                                         replicate(x0, dev), cd,
                                         replicate(objective, dev)),
                             K, buffer_size, S, dev, faults)

        res, n_up, exhausted = _run_sharded_bucket(
            build, mesh, args, len(b.grid), n_args=len(args), cache_key=key)
        _check_fed_diag(n_up, exhausted, K, S)
        return res

    return run_bucketed(grid, run_bucket, bucket_widths,
                        checkpoint=checkpoint)


def sharded_sweep_fedasync(client_update: Callable, x0, client_data,
                           grid: SweepGrid,
                           objective: Optional[Callable] = None,
                           buffer_size: int = 1, horizon: Horizon = 4096,
                           n_steps: Optional[int] = None,
                           mesh: Optional[Mesh] = None,
                           bucket_widths: Optional[Sequence[int]] = None,
                           record_every: int = 1, telemetry=None,
                           engine: str = "fused", faults=None,
                           checkpoint=None) -> FedResult:
    """``sweep_fedasync`` with the cell axis sharded: each row races its
    cells' client rounds and runs the server loop on its device.  On a
    2-D mesh pass a ``PerDevice`` ``client_update`` whose gradient is
    data-parallel (as the api path builds it); a plain update runs on
    each row's first device."""
    horizon = resolve_grid_horizon(horizon, grid, fed=True,
                                   buffer_size=buffer_size, n_steps=n_steps,
                                   device=x0.device)
    faults = normalize_faults(faults)

    def adapter_for(update, x0_r, cd, obj):
        return _fedasync_scan_adapter(update, x0_r, cd, obj, horizon,
                                      record_every, engine, telemetry,
                                      faults)

    key = ("fedasync/sharded", grid.n_events, buffer_size, horizon,
           record_every, telemetry, engine, faults, IdKey(client_update),
           tree_key(x0), tree_key(client_data), IdKey(objective))
    return _sharded_sweep_fed(adapter_for, grid, client_update, x0,
                              client_data, objective, buffer_size, n_steps,
                              mesh, bucket_widths=bucket_widths,
                              cache_key=key, faults=faults,
                              checkpoint=checkpoint)


def sharded_sweep_fedbuff(client_update: Callable, x0, client_data,
                          grid: SweepGrid, eta: float = 1.0,
                          buffer_size: int = 1,
                          objective: Optional[Callable] = None,
                          horizon: Horizon = 4096,
                          n_steps: Optional[int] = None,
                          mesh: Optional[Mesh] = None,
                          bucket_widths: Optional[Sequence[int]] = None,
                          record_every: int = 1, telemetry=None,
                          engine: str = "fused", faults=None,
                          checkpoint=None) -> FedResult:
    """``sweep_fedbuff`` with the cell axis sharded (``client_update`` as
    in ``sharded_sweep_fedasync``)."""
    horizon = resolve_grid_horizon(horizon, grid, fed=True,
                                   buffer_size=buffer_size, n_steps=n_steps,
                                   device=x0.device)
    faults = normalize_faults(faults)

    def adapter_for(update, x0_r, cd, obj):
        return _fedbuff_scan_adapter(update, x0_r, cd, obj, horizon, eta,
                                     buffer_size, record_every, engine,
                                     telemetry, faults)

    key = ("fedbuff/sharded", grid.n_events, eta, buffer_size, horizon,
           record_every, telemetry, engine, faults, IdKey(client_update),
           tree_key(x0), tree_key(client_data), IdKey(objective))
    return _sharded_sweep_fed(adapter_for, grid, client_update, x0,
                              client_data, objective, buffer_size, n_steps,
                              mesh, bucket_widths=bucket_widths,
                              cache_key=key, faults=faults,
                              checkpoint=checkpoint)
