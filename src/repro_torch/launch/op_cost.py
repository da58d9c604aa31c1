"""FLOPs and bytes of one call from the aten ops it runs (the port's
counterpart of ``repro.launch.hlo_cost``; torch has no HLO).

:func:`trace` runs a call under a ``TorchDispatchMode`` and keeps one
:class:`OpRecord` an aten op, on ``meta`` tensors (no storage: a
full-size step) or on real ones.  Whatever Python runs is recorded:
layers in a loop, the checkpoint recompute in the backward pass, the
optimizer.  So the counts are exact per step, with nothing to multiply by
trip counts.

* FLOPs: ``torch.utils.flop_counter``'s formulas, which count the
  matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, fused attention): the counterpart of the reference's
  ``dot`` FLOPs.  Other ops count 0, as the reference's do.
* Bytes: operand plus result bytes of each op, the eager traffic (the
  port runs unfused, so this is its HBM proxy, as the post-fusion graph is
  the reference's).  Views and metadata ops move nothing (the reference's
  ``SKIP_BYTES_OPS``).  An op that writes into an argument counts that
  write, plus the argument's bytes again where it also reads it (``add_``)
  and not where it only overwrites it (``copy_``, ``fill_``); an indexed
  write (``index_put_``) counts the region it writes, not the buffer.
* ``uncounted``: ops with no FLOP formula outside aten (a custom op, by
  name, with its calls) and the hand-written kernels launched during the
  call (their launch counters: ``ctypes`` launches do not pass the
  dispatcher), never silently counted as 0.
* ``position``: in a trace given the tensor-parallel groups of the call
  (``models.tensor_parallel.ModelGroup``), the position whose work an op
  is (its forward ops, a checkpoint's recompute of them and the backward
  of the autograd nodes they made), None for the row's own;
  :meth:`OpTrace.by_position` splits a trace by it.

Moved bytes (the reference's collective bytes) are not ops of the step:
``launch.roofline.moved_bytes`` counts them from the plan, and
:class:`Cost` carries them by kind.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _flat
from torch.utils.flop_counter import flop_registry

from .roofline import MOVED_KINDS

__all__ = ["Cost", "OpRecord", "OpTrace", "trace", "analyze",
           "top_contributors"]

aten = torch.ops.aten

# ops that move no data: shape and metadata queries, views, aliasing
_SKIP = {aten.detach.default, aten.detach_.default, aten.lift_fresh.default,
         aten.alias.default, aten.empty.memory_format,
         aten.empty_strided.default, aten.empty_like.default,
         aten._local_scalar_dense.default}

# in-place ops that overwrite their first argument without reading it
_OVERWRITE = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
              aten.zero_.default}

# indexed writes: the first argument is the buffer, the write its region
_INDEXED = {aten.index_put_.default, aten.index_copy_.default,
            aten.scatter_.src, aten.scatter_.value}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(obj) -> List[torch.Tensor]:
    return [t for t in _flat(obj)[0] if isinstance(t, torch.Tensor)]


def _indexed_bytes(func, args, kwargs) -> Tuple[int, int]:
    """(read, written) bytes of an indexed write into ``args[0]``: the
    indices and the values read, the region written (read too when
    ``accumulate``)."""
    buf = args[0]
    if func is aten.index_put_.default:
        idx = [i for i in args[1] if i is not None]
        shapes = [tuple(i.shape) for i in idx]
        n = math.prod(torch.broadcast_shapes(*shapes)) if shapes else 1
        rest = math.prod(buf.shape[len(args[1]):])
        region = n * rest * buf.element_size()
        acc = len(args) > 3 and bool(args[3]) or kwargs.get("accumulate")
        read = sum(_nbytes(t) for t in idx) + _nbytes(args[2])
        return read + (region if acc else 0), region
    if func is aten.index_copy_.default:
        src = args[3]
        return _nbytes(args[2]) + _nbytes(src), _nbytes(src)
    index = args[2]
    read = _nbytes(index) + sum(_nbytes(t) for t in _tensors(args[3:]))
    return read, index.numel() * buf.element_size()


def _op_bytes(func, args, kwargs, out) -> int:
    if func in _SKIP or func.is_view:
        return 0
    if func in _INDEXED:
        return sum(_indexed_bytes(func, args, kwargs))
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if func in _OVERWRITE:
        ins = ins[1:]
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


def _shape_text(args) -> str:
    return ", ".join(f"{str(t.dtype).replace('torch.', '')}"
                     f"[{','.join(map(str, t.shape))}]"
                     for t in _tensors(args))


@dataclasses.dataclass
class OpRecord:
    op: str      # the aten overload, ``aten.mm.default``
    where: str   # "forward", or the autograd node running it
    flops: int
    bytes: int
    shapes: str  # the operands' dtypes and shapes
    position: Optional[int] = None  # the tensor-parallel position's op


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    moved_bytes: float = 0.0
    moved_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in MOVED_KINDS})
    uncounted: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.moved_bytes += o.moved_bytes
        for k in MOVED_KINDS:
            self.moved_breakdown[k] += o.moved_breakdown[k]
        for k, n in o.uncounted.items():
            self.uncounted[k] = self.uncounted.get(k, 0) + n
        return self

    def with_moved(self, moved: Dict[str, float]) -> "Cost":
        """This cost with ``launch.roofline.moved_bytes``' counts."""
        return dataclasses.replace(
            self, moved_bytes=float(sum(moved.values())),
            moved_breakdown={k: float(moved.get(k, 0)) for k in MOVED_KINDS},
            uncounted=dict(self.uncounted))


@dataclasses.dataclass
class OpTrace:
    records: List[OpRecord]
    uncounted: Dict[str, int]
    result: Any = None

    def cost(self) -> Cost:
        return Cost(flops=float(sum(r.flops for r in self.records)),
                    bytes=float(sum(r.bytes for r in self.records)),
                    uncounted=dict(self.uncounted))

    def by_position(self) -> Dict[Optional[int], Cost]:
        """The cost of each tensor-parallel position's ops, and under
        None the rest (the rows' own work, every op of an untagged
        call)."""
        out: Dict[Optional[int], Cost] = {None: Cost()}
        for r in self.records:
            c = out.setdefault(r.position, Cost())
            c.flops += r.flops
            c.bytes += r.bytes
        return out


def _launch_counts() -> Dict[str, int]:
    """The hand-written kernels' launch counters, by wrapper name (the
    modules imported here: importing one builds nothing)."""
    from ..staticcheck.optrace import _counters
    return {name: int(getattr(fn, attr)) for name, fn, attr in _counters()}


# the autograd-node metadata key that holds a tensor-parallel position
NODE_KEY = "tp_position"


def _tag(p: int, args, out) -> None:
    """A ``ModelGroup`` hook: tag the autograd graph of position ``p``'s
    work ``out`` with ``p``, back to the nodes of its inputs ``args`` or to
    nodes tagged already."""
    if not torch.is_grad_enabled():
        return
    outs = out if isinstance(out, (tuple, list)) else [out]
    stop = {id(t.grad_fn) for t in args
            if isinstance(t, torch.Tensor) and t.grad_fn is not None}
    todo = [t.grad_fn for t in outs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or id(node) in stop or NODE_KEY in node.metadata:
            continue
        node.metadata[NODE_KEY] = p
        todo.extend(n for n, _ in node.next_functions)


class _Recorder(TorchDispatchMode):
    def __init__(self, groups=()):
        super().__init__()
        self.records: List[OpRecord] = []
        self.uncounted: Dict[str, int] = {}
        self.groups = list(groups)

    def _position(self, node) -> Optional[int]:
        for g in self.groups:
            if g.position is not None:
                return g.position
        if node is not None and not torch.is_grad_enabled():
            # a backward op: the position that made its node
            return node.metadata.get(NODE_KEY)
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and func.namespace == "aten":
            # a composite op: record the ops it is made of
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if func.namespace not in ("aten", "prim") and \
                packet not in flop_registry:
            name = str(packet)
            self.uncounted[name] = self.uncounted.get(name, 0) + 1
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        nbytes = _op_bytes(func, args, kwargs, out)
        if flops or nbytes:
            node = torch._C._current_autograd_node()
            self.records.append(OpRecord(
                str(func), "forward" if node is None else node.name(),
                int(flops), int(nbytes), _shape_text(args),
                self._position(node)))
        return out


def trace(fn: Callable, *args, groups=(), **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` and record every aten op it dispatches,
    backward passes included; the trace holds the call's result.  Each op
    of the work of a position of one of ``groups`` (tensor-parallel
    ``ModelGroup``s the call computes with) records that position."""
    before = _launch_counts()
    rec = _Recorder(groups)
    for g in rec.groups:
        g.hook = _tag
    try:
        with rec:
            result = fn(*args, **kwargs)
    finally:
        for g in rec.groups:
            g.hook = None
    uncounted = dict(rec.uncounted)
    for name, n in _launch_counts().items():
        if n > before[name]:
            uncounted[f"launch {name}"] = n - before[name]
    return OpTrace(rec.records, uncounted, result)


def analyze(fn: Callable, *args, **kwargs) -> Cost:
    """The :class:`Cost` of ``fn(*args, **kwargs)``."""
    return trace(fn, *args, **kwargs).cost()


def top_contributors(tr: OpTrace, metric: str = "bytes", k: int = 25):
    """The ops that dominate a term, summed over the calls of each (op,
    where, operand shapes).  metric: "bytes" | "flops".  Returns [(cost,
    where, op, "<n> calls", shapes)], largest first (the reference's
    (cost, computation, op, name, shape) rows)."""
    if metric not in ("bytes", "flops"):
        raise ValueError(f"metric {metric!r}: 'bytes' or 'flops' (moved "
                         "bytes come from launch.roofline.moved_bytes)")
    agg: Dict[tuple, list] = {}
    for r in tr.records:
        v = r.flops if metric == "flops" else r.bytes
        if v:
            a = agg.setdefault((r.where, r.op, r.shapes), [0, 0])
            a[0] += v
            a[1] += 1
    rows = [(float(v), where, op, f"{n} calls", shapes[:80])
            for (where, op, shapes), (v, n) in agg.items()]
    rows.sort(key=lambda row: row[0], reverse=True)
    return rows[:k]
