"""Known-bad fixture for CACHE001: in-place mutation of a tensor after it
was captured by ``IdKey`` / ``tree_key`` for a ``cached_program`` key.

Never imported or executed.  Both function-local and module-level capture
scopes are exercised.
"""
import torch

from repro_torch.sweep.cache import IdKey, cached_program, tree_key

_DATA = torch.ones(4)
_KEY = ("fixture", IdKey(_DATA))
_DATA[:] = 0.0  # BAD: the key above now points at different contents


def build_and_mutate(data, x0):
    key = ("fixture", IdKey(data), tree_key(x0))
    prog = cached_program(key, lambda: None)
    data[0] = 0.0  # BAD: mutates a captured tensor after keying
    data.add_(1.0)  # BAD: ditto, through an in-place method
    return prog
