"""Deterministic fault-process injection (counterpart of
``repro.faults.inject``).

Two entry points, both pure functions of ``(spec, cell seeds)``:

* :func:`inject_service_times` transforms a pre-sampled service-time
  tensor before the event race -- per-worker crash/rejoin Markov chains
  (the in-flight task of a "down" worker is stretched by ``crash_scale``,
  so its next completion lands with a large measured staleness: the
  rejoin spike) and heavy-tail Pareto straggler spikes.  The same
  transform stretches federated round durations
  (:func:`inject_client_rounds`).
* :func:`update_fault_codes` draws the per-event drop/dup/corrupt codes the
  solver loops consume as an extra event column.

The randomness is the reference's, bit for bit: JAX's threefry2x32 in its
partitionable counter layout (the layout ``jax_threefry_partitionable``
selects, the default of jax 0.9), keyed ``fold_in(fold_in(PRNGKey(
spec.seed), cell_seed), stream)`` with one stream tag per draw site,
written here in torch integer ops.  uint32 words live in int64 tensors
(torch has no complete uint32 arithmetic on CUDA) and every add and
shift is masked back to 32 bits.  Every draw is vectorised over a (B,)
tensor of cell seeds: a bucket draws all its cells in one pass, and each
cell draws the bits of its own shape, so a solo cell draws the same bits
as its batched row.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels.dispatch import resolve_device
from .spec import CODE_CORRUPT, CODE_DROP, CODE_DUP, FaultSpec

__all__ = ["inject_service_times", "inject_client_rounds",
           "update_fault_codes", "corrupt_value", "threefry2x32",
           "prng_key", "fold_in", "split", "random_bits", "uniform"]

# Static stream tags keeping the three draw sites independent.
_STREAM_CRASH = 0x5EED0001
_STREAM_SPIKE = 0x5EED0002
_STREAM_CODES = 0x5EED0003

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[torch.Tensor, torch.Tensor]  # (k1, k2) uint32 words in int64


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds, JAX's ``threefry2x32_p``) of the
    counter words ``(x1, x2)`` under the key ``(k1, k2)``: int64 tensors
    holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(a, device) -> torch.Tensor:
    """Integers (Python or tensor) as uint32 words in int64 (two's
    complement wrap, as JAX's conversion to uint32)."""
    return torch.as_tensor(a, dtype=torch.int64, device=device) & _MASK


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``(0, seed)``, on
    ``device`` (the card unless the caller names the CPU)."""
    dev = resolve_device(device)
    return (torch.zeros((), dtype=torch.int64, device=dev),
            _words(int(seed), dev))


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: the hash of the counter ``(0, data)``;
    ``data`` may be a tensor of per-cell values, giving one key each."""
    k1, k2 = key
    d = _words(data, k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` (the fold-like split of the
    partitionable layout): key j hashes the counter ``(0, j)``."""
    k1, k2 = key
    j = torch.arange(num, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1.unsqueeze(-1), k2.unsqueeze(-1),
                          torch.zeros_like(j), j)
    return tuple((b1[..., i], b2[..., i]) for i in range(num))


def random_bits(key: Key, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (partitionable layout: the
    element's flat index as a 64-bit counter, the two hash words XORed);
    with keys of shape (B,) the result is (B,) + shape."""
    k1, k2 = key
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=k1.device).reshape(shape)
    lead = k1.shape
    k1 = k1.reshape(lead + (1,) * len(shape))
    k2 = k2.reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return b1 ^ b2


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def uniform(key: Key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1.0, then ``max(minval, u * (maxval -
    minval) + minval)`` with the sum rounded once, as the reference's
    compiled program contracts it (``fma32``)."""
    from ..core.stepsize import fma32
    bits = random_bits(key, shape)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    if float(minval) == 0.0 and float(maxval) == 1.0:
        return floats   # u * 1 + 0 and max(0, u) are exact
    dev = floats.device
    lo, hi = _f32(minval, dev), _f32(maxval, dev)
    return torch.maximum(lo, fma32(floats, hi - lo, lo))


def _cell_seeds(cell_seed, device) -> torch.Tensor:
    """Per-cell seeds as a (B,) tensor (a scalar seed is one cell)."""
    return torch.as_tensor(cell_seed, dtype=torch.int64,
                           device=device).reshape(-1)


def _key(spec: FaultSpec, seeds: torch.Tensor, stream: int) -> Key:
    k = fold_in(prng_key(spec.seed, seeds.device), seeds)
    return fold_in(k, stream)


def _down_mask(spec: FaultSpec, key: Key, shape) -> torch.Tensor:
    """(B, n, T) float32 {0,1} per-worker down-state Markov chain over
    tasks: up -> down w.p. ``p_crash``, down -> up w.p. ``p_rejoin``;
    workers start up.  One uniform per (worker, task); the chain steps
    every cell and worker at once, one (B, n) step per task."""
    u = uniform(key, shape)
    dev = u.device
    # the comparisons of each step, precomputed task-major
    stay = (u >= _f32(spec.p_rejoin, dev)).permute(2, 0, 1).contiguous()
    fall = (u < _f32(spec.p_crash, dev)).permute(2, 0, 1).contiguous()
    down = torch.zeros_like(stay[0])
    out = torch.empty_like(stay)
    for t in range(stay.shape[0]):
        down = torch.where(down, stay[t], fall[t])
        out[t] = down
    return out.permute(1, 2, 0).to(torch.float32)


_LIBM = None


def _powf_host(u: torch.Tensor, y: float) -> torch.Tensor:
    """float32 ``u ** y`` on the host through the C library's ``powf``,
    the function the reference's XLA:CPU program calls (bitwise its
    ``jnp.power`` there)."""
    global _LIBM
    if _LIBM is None:
        import ctypes
        import ctypes.util
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        lib.powf.restype = ctypes.c_float
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        _LIBM = lib
    powf = _LIBM.powf
    vals = [powf(v, y) for v in u.tolist()]
    return torch.tensor(vals, dtype=torch.float32)


def _pow(u: torch.Tensor, y: float) -> torch.Tensor:
    """float32 ``u ** y`` (``y`` a float32 value).  On the CPU the C
    library's ``powf``, bitwise the reference's; on the card no such
    function exists (CUDA's ``powf`` differs from it), so the power is
    taken in float64 and rounded once: the correctly rounded value, within
    one float32 ulp of the C library's (ROADMAP queue C)."""
    if u.device.type == "cpu":
        return _powf_host(u, y)
    return torch.pow(u.double(), y).float()


def inject_service_times(T, spec: FaultSpec, cell_seed) -> torch.Tensor:
    """Transform service times: ``(B, n_workers, n_tasks)`` with ``B`` cell
    seeds, or one cell's ``(n_workers, n_tasks)`` with a scalar seed.

    Applied before the event race; the event *selection* stays the
    untouched lexicographic argmin, only durations change.  Returns
    float32 of the same shape on ``T``'s device.  With
    ``spec.injects_traces`` False it still runs (the multipliers are
    identically 1); callers gate on the spec being present."""
    T = torch.as_tensor(T).to(torch.float32)
    single = T.ndim == 2
    if single:
        T = T.unsqueeze(0)
    dev = T.device
    seeds = _cell_seeds(cell_seed, dev)
    shape = tuple(T.shape[1:])
    scale = torch.ones_like(T)
    if spec.p_crash > 0.0:
        down = _down_mask(spec, _key(spec, seeds, _STREAM_CRASH), shape)
        scale = scale * (1.0 + down * _f32(spec.crash_scale - 1.0, dev))
    if spec.p_spike > 0.0:
        k_hit, k_mag = split(_key(spec, seeds, _STREAM_SPIKE))
        hit = uniform(k_hit, shape) < _f32(spec.p_spike, dev)
        u = uniform(k_mag, shape, minval=1e-6, maxval=1.0)
        # the Pareto magnitude matters only where a spike hits, so only
        # those elements take the power
        y = float(torch.tensor(-1.0 / spec.spike_tail, dtype=torch.float32))
        factor = torch.ones_like(u)
        factor[hit] = _f32(spec.spike_scale, dev) * _pow(u[hit], y).to(dev)
        scale = scale * factor
    out = T * scale
    return out[0] if single else out


def inject_client_rounds(rounds, spec: FaultSpec, cell_seed):
    """Federated twin: stretch ``ClientRounds.duration`` ((B, n_clients,
    n_attempts), or one cell's (n_clients, n_attempts)) by the same
    crash-chain / spike processes; the dropout coins stay untouched."""
    return rounds._replace(
        duration=inject_service_times(rounds.duration, spec, cell_seed))


def update_fault_codes(spec: FaultSpec, n_events: int, cell_seed,
                       device=None) -> torch.Tensor:
    """Per-event int32 fault codes, (B, n_events) for B cell seeds or
    (n_events,) for a scalar seed: 0 ok, 1 drop, 2 dup, 3 corrupt.  One
    uniform per event, thresholded corrupt < drop < dup (the precedence
    partitions [0, 1)).  The codes land on ``device``, else on a tensor
    seed's device, else on the card."""
    if device is None and isinstance(cell_seed, torch.Tensor):
        device = cell_seed.device
    device = resolve_device(device)
    seeds = _cell_seeds(cell_seed, device)
    u = uniform(_key(spec, seeds, _STREAM_CODES), (int(n_events),))
    dev = u.device
    pc, pdr, pdu = spec.p_corrupt, spec.p_drop, spec.p_dup
    zero = torch.zeros_like(u, dtype=torch.int32)
    codes = torch.where(
        u < _f32(pc, dev), zero + CODE_CORRUPT,
        torch.where(u < _f32(pc + pdr, dev), zero + CODE_DROP,
                    torch.where(u < _f32(pc + pdr + pdu, dev),
                                zero + CODE_DUP, zero)))
    return codes[0] if torch.as_tensor(cell_seed).ndim == 0 else codes


def corrupt_value(spec: FaultSpec, device=None) -> torch.Tensor:
    """The poison payload a corrupt event adds into the update, on
    ``device`` (the card unless the caller names one)."""
    v = float("nan") if spec.corrupt_mode == "nan" else float("inf")
    dev = resolve_device() if device is None else device
    return torch.tensor(v, dtype=torch.float32, device=dev)
