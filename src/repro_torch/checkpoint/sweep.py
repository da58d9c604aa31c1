"""Sweep checkpointing: resume a killed grid run (counterpart of
``repro.checkpoint.sweep``).

``api.run(spec, resume=path)`` threads a :class:`SweepCheckpoint` through
the sweep runners into ``sweep.runners.run_bucketed``: every completed
bucket's stacked result is written to ``{dir}/{tag}_w{width}_b{idx}.npz``
(atomic temp + rename), and a re-run of the same spec loads finished
buckets instead of recomputing them, so a killed sweep resumes at its
first unfinished bucket.  The solo backend checkpoints per cell through
the same object.

Bucket files are self-describing, in the reference's format: a JSON
``__meta__`` records the originating spec fingerprint, the tag and the
result's structure (NamedTuple classes by name with their field lists,
nested tuples, ``None`` leaves), beside the arrays as numpy.  The class
names are the reference's, so a bucket written by either package resumes
in the other; decoding puts every array on the caller's device as a
tensor.  Resuming into a directory written by a DIFFERENT spec raises.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

__all__ = ["SweepCheckpoint", "encode_tree", "decode_tree"]


def _registry() -> Dict[str, type]:
    """NamedTuple classes a sweep result can contain, by class name
    (imported lazily: the checkpoint package must not import the solvers
    at package-import time)."""
    from ..core.bcd import BCDResult
    from ..core.piag import PIAGResult
    from ..core.stepsize import LipschitzState, StepsizeState
    from ..faults.guards import FaultState
    from ..federated.server import FedResult
    from ..telemetry import accumulators as acc
    reg: Dict[str, type] = {}
    for cls in (PIAGResult, BCDResult, FedResult, StepsizeState,
                LipschitzState, FaultState):
        reg[cls.__name__] = cls
    for name in dir(acc):  # TelemetryState and the finalized tuples
        obj = getattr(acc, name)
        if isinstance(obj, type) and issubclass(obj, tuple) \
                and hasattr(obj, "_fields"):
            reg[obj.__name__] = obj
    return reg


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def encode_tree(tree: Any):
    """Flatten a result tree into (numpy arrays dict, JSON-able
    descriptor)."""
    arrays: Dict[str, np.ndarray] = {}

    def rec(obj):
        if obj is None:
            return {"t": "none"}
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return {"t": "nt", "cls": type(obj).__name__,
                    "items": [rec(getattr(obj, f)) for f in obj._fields],
                    "fields": list(obj._fields)}
        if isinstance(obj, (tuple, list)):
            return {"t": "tuple" if isinstance(obj, tuple) else "list",
                    "items": [rec(v) for v in obj]}
        if isinstance(obj, dict):
            keys = sorted(obj)
            return {"t": "dict", "keys": keys,
                    "items": [rec(obj[k]) for k in keys]}
        key = f"a{len(arrays)}"
        arrays[key] = _host(obj)
        return {"t": "arr", "key": key}

    return arrays, rec(tree)


def decode_tree(arrays, desc: Dict[str, Any], device=None) -> Any:
    """Inverse of :func:`encode_tree` (NamedTuples resolved by name);
    arrays become tensors on ``device`` (the CPU when None)."""
    reg = _registry()

    def rec(d):
        t = d["t"]
        if t == "none":
            return None
        if t == "arr":
            return torch.from_numpy(np.array(arrays[d["key"]])).to(device)
        if t == "nt":
            cls = reg.get(d["cls"])
            if cls is None:
                raise ValueError(
                    f"checkpoint references unknown result type {d['cls']!r} "
                    "(written by an incompatible version?)")
            if list(cls._fields) != d["fields"]:
                raise ValueError(
                    f"checkpointed {d['cls']} fields {d['fields']} do not "
                    f"match the current definition {list(cls._fields)}")
            return cls(*[rec(i) for i in d["items"]])
        if t == "tuple":
            return tuple(rec(i) for i in d["items"])
        if t == "list":
            return [rec(i) for i in d["items"]]
        if t == "dict":
            return {k: rec(i) for k, i in zip(d["keys"], d["items"])}
        raise ValueError(f"unknown checkpoint node type {t!r}")

    return rec(desc)


class SweepCheckpoint:
    """Bucket-granular sweep persistence rooted at ``directory``.

    ``tag`` namespaces files within the directory (``api.run`` sets it to
    ``{solver}_{backend}``); ``fingerprint`` (``telemetry.spec_fingerprint``)
    is stamped into every file and verified on load; loaded buckets land on
    ``device``.
    """

    def __init__(self, directory: Union[str, Path], fingerprint: str = "",
                 tag: str = "", device=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fingerprint = fingerprint
        self.tag = tag
        self.device = device
        self.loaded = 0   # buckets resumed from disk (observability)
        self.saved = 0

    def _path(self, width: int, idx: int) -> Path:
        tag = self.tag or "sweep"
        return self.dir / f"{tag}_w{int(width)}_b{int(idx)}.npz"

    def load_bucket(self, width: int, idx: int) -> Optional[Any]:
        """The bucket's decoded result, or None when not yet checkpointed.
        Raises when the file belongs to a different spec fingerprint."""
        path = self._path(width, idx)
        if not path.exists():
            return None
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if self.fingerprint and meta.get("fingerprint") \
                    and meta["fingerprint"] != self.fingerprint:
                raise ValueError(
                    f"resume checkpoint {path} was written by a different "
                    f"spec (fingerprint {meta['fingerprint']} != "
                    f"{self.fingerprint}); use a fresh --resume directory")
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        self.loaded += 1
        return decode_tree(arrays, meta["tree"], self.device)

    def save_bucket(self, width: int, idx: int, tree: Any) -> Path:
        path = self._path(width, idx)
        arrays, desc = encode_tree(tree)   # copies to the host: a sync
        meta = json.dumps({"fingerprint": self.fingerprint, "tree": desc,
                           "tag": self.tag})
        fd, tmp = tempfile.mkstemp(dir=str(self.dir),
                                   prefix=path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, __meta__=np.asarray(meta), **arrays)
            os.replace(tmp, path)  # atomic: a killed run never half-writes
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.saved += 1
        return path

    def stats(self) -> Dict[str, int]:
        return {"loaded": self.loaded, "saved": self.saved}
