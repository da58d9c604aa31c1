"""Minimal npz pytree checkpointing (counterpart of
``repro.checkpoint.checkpoint``).

Saves a flattened pytree (tensors, arrays, scalars in nested tuples,
lists, dicts and NamedTuples) under the reference's keypath names -- dict
keys, ``#i`` for sequence positions, field names for NamedTuples, joined
by ``/`` -- plus JSON metadata.  Atomic via write-to-temp + rename.  A
file written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "/"


def _is_leaf(obj) -> bool:
    return not isinstance(obj, (tuple, list, dict)) and obj is not None


def _leaves_with_paths(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(keypath, leaf) pairs in JAX's flattening order (dict keys sorted,
    ``None`` a node without leaves)."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(name, getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, v in items:
        out.extend(_leaves_with_paths(v, prefix + (key,)))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiubc":
        arr = arr.astype(np.float32)
    return arr


def save_checkpoint(path: str, tree: Any,
                    metadata: Optional[dict] = None) -> None:
    flat: Dict[str, np.ndarray] = {
        SEP.join(p): _host(leaf) for p, leaf in _leaves_with_paths(tree)}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __metadata__=json.dumps(metadata or {}), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (shapes must match); tensor
    leaves come back as tensors of ``like``'s dtype and device."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__metadata__"]))
        flat = {k: z[k] for k in z.files if k != "__metadata__"}

    def rebuild(tree, prefix=()):
        if tree is None:
            return None
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(rebuild(getattr(tree, f), prefix + (f,))
                                for f in tree._fields))
        if isinstance(tree, (tuple, list)):
            vals = [rebuild(v, prefix + (f"#{i}",))
                    for i, v in enumerate(tree)]
            return type(tree)(vals)
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], prefix + (str(k),)) for k in tree}
        arr = flat[SEP.join(prefix)]
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(tree.device, tree.dtype)
        if hasattr(tree, "dtype"):
            return arr.astype(tree.dtype)
        return arr

    return rebuild(like), meta
