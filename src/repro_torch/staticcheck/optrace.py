"""Canonical op traces of one call, for structural comparison (the port's
counterpart of ``repro.staticcheck.jaxpr``).

Torch has no jaxpr: a program is what it runs.  :func:`record` runs a
call under a ``TorchDispatchMode`` and renders every aten op it
dispatches as one deterministic line, so two runs of semantically
identical programs give identical text:

* tensors are named ``t0, t1, ...`` in first-appearance order (the
  call's tensor inputs first, then each op's arguments and outputs), each
  shown with its dtype, shape and device TYPE (``t3:f32[4,6]@cuda``) --
  never its address, its card index or its values;
* an op is its overload (``aten.add.Tensor``), its arguments in order and
  its keyword arguments sorted by name; numbers, dtypes and flags are
  rendered, devices by type, anything else by type name;
* the hand-written kernels launch through ``ctypes``, which the dispatch
  mode does not see.  Their wrappers count every launch
  (``kernels.fused_step``, ``flash_attention``, ``prox_step``,
  ``rmsnorm``, ``ssd_scan``); the counters are read at every op, and
  each launch since the last read becomes a ``launch <kernel>`` line in
  its place in the sequence.  On the CPU the wrappers run their plain
  versions, so the trace shows those versions' aten ops instead.

The lines feed :func:`fingerprint` (sha1) for cheap equality and
:func:`diff` (unified diff) for readable contract-violation reports;
:func:`io_shapes` is the interface two engines must agree on.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
import weakref
from difflib import unified_diff
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Trace", "record", "canonical_lines", "canonical_text",
           "fingerprint", "diff", "assert_identical", "io_shapes"]

_ADDR = re.compile(r"0x[0-9a-fA-F]+")

_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32",
           torch.int16: "i16", torch.int8: "i8", torch.uint8: "u8",
           torch.bool: "bool"}

# (module, wrapper, counter attribute) of every hand-written kernel; the
# name of a launch line is the wrapper's, or ``<wrapper>.tc`` for B6's
# tensor-core route (its ``launches`` counts both routes)
_KERNEL_COUNTERS = (
    ("fused_step", "fused_policy_prox_step", "launches"),
    ("fused_step", "fused_policy_mix_step", "launches"),
    ("fused_step", "fused_policy_buff_step", "launches"),
    ("flash_attention", "flash_attention_bhsd", "launches"),
    ("flash_attention", "flash_attention_bhsd", "launches_tc"),
    ("prox_step", "prox_step", "launches"),
    ("rmsnorm", "rmsnorm", "launches"),
    ("ssd_scan", "ssd_intra_chunk", "launches"),
)


def _counters() -> List[Tuple[str, Any, str]]:
    import importlib
    out = []
    for module, name, attr in _KERNEL_COUNTERS:
        fn = getattr(importlib.import_module(
            f"repro_torch.kernels.{module}"), name)
        out.append((name + (".tc" if attr == "launches_tc" else ""), fn,
                    attr))
    return out


def _tensors(obj: Any) -> List[torch.Tensor]:
    """The tensor leaves of nested tuples, lists, dicts and dataclasses
    (the solvers' result types), in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors(v)]
    if isinstance(obj, dict):
        return [t for k in sorted(obj, key=str) for t in _tensors(obj[k])]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in _tensors(getattr(obj, f.name))]
    return []


_AVALS: Dict[tuple, str] = {}


def _aval(t: torch.Tensor) -> str:
    """``f32[4,6]@cuda``: dtype, shape and device type (memoized by
    them; a trace meets few distinct ones)."""
    key = (t.dtype, t.shape, t.is_cuda)
    text = _AVALS.get(key)
    if text is None:
        dt = _DTYPES.get(t.dtype, str(t.dtype).replace("torch.", ""))
        text = _AVALS[key] = \
            f"{dt}[{','.join(map(str, t.shape))}]@{t.device.type}"
    return text


class _Namer:
    """Tensor -> ``t<n>:<aval>`` in first-appearance order.  Entries hold
    weak references, so a long trace keeps no intermediate alive; an id
    whose tensor died and was reused names the new tensor afresh.  The
    text is kept per tensor and renewed where the tensor is an op's output
    (only an op that returns a tensor -- in place or ``out=`` -- can
    change its shape or dtype)."""

    def __init__(self):
        self.names: Dict[int, list] = {}
        self.count = 0

    def __call__(self, t: torch.Tensor, fresh: bool = False) -> str:
        entry = self.names.get(id(t))
        if entry is not None and not fresh and entry[1]() is t:
            return entry[2]
        if entry is None or entry[1]() is not t:
            entry = [f"t{self.count}", weakref.ref(t), None]
            self.count += 1
            self.names[id(t)] = entry
        entry[2] = f"{entry[0]}:{_aval(t)}"
        return entry[2]


_Tensor = torch.Tensor
_PLAIN = (int, float, bool, type(None))


def _render(val: Any, name: _Namer, fresh: bool = False) -> str:
    tp = type(val)
    if tp is _Tensor:
        return name(val, fresh)
    if tp in _PLAIN:
        return repr(val)
    if tp is list:
        return "[" + ", ".join([_render(v, name, fresh) for v in val]) + "]"
    if isinstance(val, torch.Tensor):
        return name(val, fresh)
    if isinstance(val, (tuple, list)):
        body = ", ".join(_render(v, name, fresh) for v in val)
        return ("(" + body + ")") if isinstance(val, tuple) \
            else ("[" + body + "]")
    if isinstance(val, dict):
        return "{" + ", ".join(f"{k}={_render(v, name)}" for k, v in
                               sorted(val.items(), key=lambda kv: str(kv[0]))
                               ) + "}"
    if isinstance(val, torch.dtype):
        return _DTYPES.get(val, str(val))
    if isinstance(val, torch.device):
        return f"@{val.type}"
    if isinstance(val, (bool, int, float, complex, str, bytes)) or val is None:
        return repr(val)
    if isinstance(val, (torch.layout, torch.memory_format)):
        return str(val)
    return _ADDR.sub("0x~", f"<{type(val).__name__}>")


class _Recorder(TorchDispatchMode):
    def __init__(self, namer: _Namer):
        super().__init__()
        self.name = namer
        self.lines: List[str] = []
        self.counters = _counters()
        self.fns = [fn for _, fn, _ in self.counters]
        self.attrs = [a for _, _, a in self.counters]
        self.now = list(map(getattr, self.fns, self.attrs))
        self.start = list(self.now)
        self.ops: Dict[Any, str] = {}   # op overload -> its name

    def poll(self) -> None:
        """A ``launch`` line for every kernel launch since the last op."""
        now = list(map(getattr, self.fns, self.attrs))
        if now != self.now:
            for (n, _, _), a, b in zip(self.counters, self.now, now):
                self.lines.extend([f"launch {n}"] * (b - a))
            self.now = now

    def launches(self) -> Dict[str, int]:
        return {n: b - a for (n, _, _), a, b in
                zip(self.counters, self.start, self.now) if b != a}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.poll()
        name = self.name
        ins = ", ".join([name(a) if type(a) is _Tensor else _render(a, name)
                         for a in args])
        if kwargs:
            ins += "".join(f", {k}={_render(v, name)}"
                           for k, v in sorted(kwargs.items()))
            out = func(*args, **kwargs)
        else:
            out = func(*args)
        op = self.ops.get(func)
        if op is None:
            op = self.ops[func] = str(func)
        self.lines.append(f"{_render(out, name, True)} = {op}({ins})")
        return out


@dataclasses.dataclass(frozen=True)
class Trace:
    """One recorded call: its canonical lines (``in``, the ops and kernel
    launches in order, ``out``), its kernel launches by name, and its
    tensor inputs' and outputs' dtypes, shapes and device types."""

    lines: Tuple[str, ...]
    launches: Dict[str, int]
    in_shapes: Tuple[str, ...]
    out_shapes: Tuple[str, ...]


def record(fn: Callable, *args, **kwargs) -> Tuple[Any, Trace]:
    """Run ``fn(*args, **kwargs)`` once under the op recorder; return its
    result and the :class:`Trace` of the call."""
    name = _Namer()
    inputs = _tensors((args, kwargs))
    head = "in  (" + ", ".join(name(t) for t in inputs) + ")"
    rec = _Recorder(name)
    with rec:
        out = fn(*args, **kwargs)
    rec.poll()
    outputs = _tensors(out)
    lines = [head] + rec.lines + [
        "out (" + ", ".join(name(t, True) for t in outputs) + ")"]
    return out, Trace(tuple(lines), rec.launches(),
                      tuple(_aval(t) for t in inputs),
                      tuple(_aval(t) for t in outputs))


def canonical_lines(trace: Trace) -> List[str]:
    return list(trace.lines)


def canonical_text(trace: Trace) -> str:
    return "\n".join(trace.lines)


def fingerprint(trace: Trace) -> str:
    """sha1 of the canonical text -- equal iff structurally identical."""
    return hashlib.sha1(canonical_text(trace).encode()).hexdigest()


def diff(a: Trace, b: Trace, label_a: str = "a", label_b: str = "b") -> str:
    """Unified diff of two canonical traces ('' when identical)."""
    return "\n".join(unified_diff(list(a.lines), list(b.lines),
                                  fromfile=label_a, tofile=label_b,
                                  lineterm=""))


def assert_identical(a: Trace, b: Trace,
                     label: str = "op-trace contract") -> None:
    d = diff(a, b)
    if d:
        head = "\n".join(d.splitlines()[:60])
        raise AssertionError(f"{label}: canonical op traces differ\n{head}")


def io_shapes(trace: Trace) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(input shapes, output shapes) -- the interface signature two
    engines must agree on even when their bodies differ."""
    return trace.in_shapes, trace.out_shapes
