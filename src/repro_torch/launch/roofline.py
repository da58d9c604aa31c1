"""Roofline terms, analytic model FLOPs and the bytes the sharded step
moves (counterpart of ``repro.launch.roofline``).

Hardware is data: a :class:`Hardware` record of peak FLOP/s, memory
bandwidth and link bandwidth.  The port defines one, :data:`H100`, from
NVIDIA's H100 SXM data sheet (dense bf16 tensor-core peak, HBM3
bandwidth, NVLink bandwidth).

Terms (seconds, one step, on the hardware given):
    compute    = flops            / peak_flops
    memory     = hbm_bytes        / hbm_bw
    collective = collective_bytes / link_bw

The reference reads its collective bytes from optimized HLO
(``parse_collective_bytes``); torch has no HLO.  The port's collectives
are ``launch.run_distributed``'s copies, so :func:`moved_bytes` counts
them from the plan: the gather of the parameters onto each data-parallel
row's device, the rows' gradient sum and its cut into blocks, and the
copies of each updated block onto the other positions that hold it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core.pytree import tree_flatten_with_path, tree_leaves, tree_map
from ..mesh import (Mesh, NamedSharding, P, dp_rows, dp_size, model_dim,
                    model_size, param_shardings, row_positions)

__all__ = ["Hardware", "H100", "RooflineTerms", "count_params",
           "model_flops", "moved_bytes", "moved_rows", "MOVED_KINDS"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # FLOP/s
    hbm_bw: float      # B/s
    link_bw: float     # B/s, one direction of one device's links


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# NVLink 4 at 900 GB/s both directions together (450 GB/s each way).
H100 = Hardware("NVIDIA H100 SXM", 989e12, 3.35e12, 450e9)


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # FLOPs the device computes in the step
    hbm_bytes: float             # bytes it reads and writes
    collective_bytes: float      # bytes it moves between positions
    model_flops_total: float     # analytic 6ND / 2ND (whole step)
    chips: int
    hardware: Hardware = H100

    @property
    def t_compute(self) -> float:
        return self.flops / self.hardware.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hardware.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.hardware.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs a device computes x chips)."""
        total = self.flops * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def step_time(self) -> float:
        """Simple max-of-terms bound (no overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "hardware": self.hardware.name,
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops_total": self.model_flops_total,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flop_ratio": self.useful_ratio,
            "step_time_bound_s": self.step_time,
        }


def count_params(cfg) -> Tuple[float, float]:
    """(total, active) parameter counts of ``models.param_specs`` (on
    ``meta``): an expert weight (a path through "moe" with a name that
    starts with "w" and is not "shared") is active for top_k of n_experts
    tokens."""
    from ..models import param_specs

    total = 0.0
    active = 0.0
    for path, leaf in tree_flatten_with_path(param_specs(cfg))[0]:
        n = float(np.prod(leaf.shape))
        total += n
        names = [getattr(k, "key", getattr(k, "name", "")) for k in path]
        if cfg.n_experts and "moe" in names and any(
                str(nm).startswith("w") and "shared" not in str(nm)
                for nm in names):
            active += n * (cfg.top_k / cfg.n_experts)
        else:
            active += n
    return total, active


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for
    inference, D = tokens processed this step."""
    _, n_active = count_params(cfg)
    tokens = shape.global_batch * (shape.seq if shape.kind in
                                   ("train", "prefill") else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


MOVED_KINDS = ("gather", "cut", "replicate")


def _position_keys(mesh) -> list:
    """The device at each mesh position (each its own device on an
    ``AbstractMesh``), in mesh index order."""
    shape = tuple(mesh.shape.values())
    if isinstance(mesh, Mesh):
        return [(pos, str(mesh.devices[pos])) for pos in np.ndindex(*shape)]
    return [(pos, pos) for pos in np.ndindex(*shape)]


def _leaf_moves(leaf, sharding: NamedSharding, positions) -> Tuple[int, int]:
    """(bytes of the distinct blocks, bytes of the distinct (device,
    block) pairs) of one leaf under its sharding."""
    shape = tuple(leaf.shape)
    block = int(np.prod(sharding.shard_shape(shape), dtype=np.int64)) \
        * leaf.element_size()
    blocks = {sharding.block_index(pos, len(shape)) for pos, _ in positions}
    placed = {(dev, sharding.block_index(pos, len(shape)))
              for pos, dev in positions}
    return block * len(blocks), block * len(placed)


def _path_text(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                    for k in path)


def _tp_moves(leaf, sharding: NamedSharding, mesh) -> Tuple[int, int]:
    """(gather, running-sum hop) bytes of one leaf on the tensor-parallel
    route: its "model" block onto each distinct (device, block) of the
    rows' positions, and each block's gradient sum onto the next row's
    tensor wherever consecutive rows hold that block on another device."""
    shape = tuple(leaf.shape)
    mdim = model_dim(sharding, len(shape))
    m = model_size(mesh) if mdim is not None else 1
    block = int(np.prod(shape, dtype=np.int64)) // m * leaf.element_size()
    mi = (list(mesh.axis_names).index("model")
          if "model" in mesh.axis_names else None)

    def key(pos):
        return (str(mesh.devices[pos]) if isinstance(mesh, Mesh) else pos,
                0 if mdim is None else pos[mi])

    rows = [[key(pos) for pos in row] for row in row_positions(mesh)]
    made = {k for row in rows for k in row}
    # the running sum lives on each block's tensor (the first position's
    # where every position holds the leaf whole)
    hops = sum(a != b for r0, r1 in zip(rows, rows[1:])
               for a, b in zip(r0[:m], r1[:m]))
    return block * len(made), block * hops


def moved_rows(state, mesh, *, fsdp: bool = True, small_out: int = 0,
               tensor_parallel: bool = False
               ) -> List[Tuple[int, str, str, tuple]]:
    """:func:`moved_bytes` leaf by leaf: ``(bytes, kind, path, shape)``
    rows, one a leaf and kind that moves anything."""
    positions = _position_keys(mesh)
    rows = []

    def add(kind, tree, shardings, prefix, pick):
        flat = tree_flatten_with_path(tree)[0]
        for (path, leaf), sh in zip(flat, tree_leaves(shardings)):
            n = pick(leaf, sh, *_leaf_moves(leaf, sh, positions))
            if n:
                rows.append((n, kind, prefix + _path_text(path),
                             tuple(leaf.shape)))

    row_devs = ([str(d) for _, d, _ in dp_rows(mesh)]
                if isinstance(mesh, Mesh) else list(range(dp_size(mesh))))
    hops = sum(a != b for a, b in zip(row_devs, row_devs[1:]))
    p_sh = param_shardings(state.params, mesh, fsdp=fsdp,
                           small_out_threshold=small_out)
    if tensor_parallel:
        add("gather", state.params, p_sh, "params/",
            lambda leaf, sh, d, p: _tp_moves(leaf, sh, mesh)[0])
        add("cut", state.params, p_sh, "params/",
            lambda leaf, sh, d, p: p + _tp_moves(leaf, sh, mesh)[1])
    else:
        add("gather", state.params, p_sh, "params/",
            lambda leaf, sh, d, p: d * len(set(row_devs)))
        add("cut", state.params, p_sh, "params/",
            lambda leaf, sh, d, p: p + d * hops)
    add("replicate", state.params, p_sh, "params/",
        lambda leaf, sh, d, p: p - d)
    opt = state.opt._replace(inner=param_shardings(
        state.opt.inner, mesh, fsdp=fsdp, small_out_threshold=small_out))
    o_sh = tree_map(lambda s: s if isinstance(s, NamedSharding)
                    else NamedSharding(mesh, P()), opt)
    add("replicate", state.opt, o_sh, "opt/", lambda leaf, sh, d, p: p - d)
    return rows


def moved_bytes(state, mesh, *, fsdp: bool = True, small_out: int = 0,
                tensor_parallel: bool = False) -> Dict[str, int]:
    """The bytes one ``launch.run_distributed.sharded_train_step`` copies
    on ``mesh`` (a ``Mesh``, whose repeated devices share their blocks, or
    an ``AbstractMesh``, a device a position), from the plan alone:

    * ``gather``: every distinct block of the parameters onto each
      distinct device that is a data-parallel row's first, once (the
      batch moves nothing: each row reads the block it holds);
    * ``cut``: the running gradient sum onto the next row's device
      wherever consecutive rows change device, and every gradient block
      onto each device that holds it (one copy a distinct (device, block)
      pair, as ``mesh.device_put`` makes);
    * ``replicate``: each updated block of the parameters and the
      optimizer state onto the devices that hold it besides the one it
      was updated on.

    ``state`` is a ``TrainState`` (tensors on any device, ``meta`` too)
    planned as ``shard_state`` plans it (the optimizer's scalar state
    replicated).  With ``tensor_parallel`` the gather is the step's on
    that route (``models.tensor_parallel.route``): each row position's
    "model" block, whole over the data axes, once a distinct (device,
    block), and the running sum moves block by block."""
    out = {k: 0 for k in MOVED_KINDS}
    for n, kind, _, _ in moved_rows(state, mesh, fsdp=fsdp,
                                    small_out=small_out,
                                    tensor_parallel=tensor_parallel):
        out[kind] += n
    return out
