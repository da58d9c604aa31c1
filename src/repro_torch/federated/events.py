"""Round-trip federated client simulation (counterpart of
``repro.federated.events``).

A client reads the current server model (recording the server version,
Algorithm 1's stamp), runs ``local_epochs`` of local training, pays upload
jitter on the way back, and may drop out mid-round and rejoin later.  The
server version advances only on *aggregation* events, so with a FedBuff
buffer of size ``|R| >= 1`` the staleness of an upload is measured in
server writes -- the paper's write-event delay ``tau_k = k - s^(i)``.

Two interchangeable trace paths, as in the reference:

* the reference path, :func:`simulate_federated`: a Python ``heapq``
  discrete-event loop over START/UPLOAD events.  Handed a pre-sampled
  :class:`ClientRounds` it accumulates times in float32 and is the bitwise
  ground truth for the device path; without one it keeps the legacy
  on-the-fly float64 sampling.
* the device path, :func:`federated_trace_scan` /
  :func:`generate_federated_trace`: every client has exactly one in-flight
  event at all times (its pending START or its pending UPLOAD), so the heap
  collapses to per-client ``(time, seq, kind)`` tensors and a pop is the
  lexicographic ``(time, seq)`` argmin.  It is written as a loop over pops
  batched over a leading cell axis on the tensors' device.

The numpy parts (client models, substream sampling, the heapq loop) are the
reference's code.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.engine import EventHeap, WorkerModel
from ..kernels.dispatch import resolve_device

__all__ = ["ClientModel", "ClientRounds", "FederatedTrace",
           "FederatedTraceArrays", "client_arrays", "default_fed_steps",
           "federated_trace_scan", "generate_federated_trace",
           "heterogeneous_clients", "sample_client_rounds",
           "simulate_federated"]

# event kinds inside the heap
_START, _UPLOAD = 0, 1


@dataclasses.dataclass(frozen=True)
class ClientModel:
    """One federated client's timing/lifecycle model.

    compute:       service-time model for ONE local epoch.
    upload:        service-time model for the upload leg (network jitter).
    local_epochs:  local training epochs per round.
    p_dropout:     probability a started round is lost.
    rejoin_after:  offline time before a dropped client re-reads the server
                   model and starts a fresh round.
    """

    compute: WorkerModel = WorkerModel()
    upload: WorkerModel = WorkerModel(mean=0.1, sigma=0.5)
    local_epochs: int = 1
    p_dropout: float = 0.0
    rejoin_after: float = 5.0

    def round_duration(self, rng: np.random.Generator) -> float:
        dt = sum(self.compute.sample(rng) for _ in range(self.local_epochs))
        return dt + self.upload.sample(rng)


def heterogeneous_clients(
    n: int,
    spread: float = 4.0,
    seed: int = 0,
    p_straggle: float = 0.05,
    straggle_x: float = 8.0,
    p_dropout: float = 0.02,
    rejoin_after: float = 5.0,
    local_epochs: int = 1,
    upload_mean: float = 0.1,
) -> list:
    """n clients with epoch times log-spaced over [1, spread]."""
    rng = np.random.default_rng(seed)
    means = np.geomspace(1.0, spread, n)
    rng.shuffle(means)
    return [ClientModel(
        compute=WorkerModel(mean=float(m), p_straggle=p_straggle,
                            straggle_x=straggle_x),
        upload=WorkerModel(mean=upload_mean, sigma=0.5),
        local_epochs=local_epochs,
        p_dropout=p_dropout,
        rejoin_after=rejoin_after,
    ) for m in means]


class ClientRounds(NamedTuple):
    """Pre-sampled per-client round randomness, indexed by START attempt.

    ``drop_u[i, a]`` is the dropout coin and ``duration[i, a]`` the full
    round duration (``local_epochs`` compute legs + the upload leg) of
    client ``i``'s ``a``-th START attempt, float32 (host numpy arrays).
    """

    drop_u: np.ndarray      # (n_clients, n_attempts) float32 in [0, 1)
    duration: np.ndarray    # (n_clients, n_attempts) float32

    @property
    def n_attempts(self) -> int:
        return int(np.shape(self.drop_u)[-1])


def sample_client_rounds(clients: Sequence[ClientModel], n_attempts: int,
                         seed: int = 0) -> ClientRounds:
    """Pre-sample every client's dropout coins and round durations.

    Client ``i`` draws from five substreams ``default_rng([seed, i, j])``
    (dropout coins, compute lognormals, compute straggle coins, upload
    lognormals, upload straggle coins), each consumed attempt-major, so
    the first A attempts of a larger draw equal the A-attempt draw."""
    def leg(model: WorkerModel, rng_ln, rng_st, shape):
        mu = np.log(model.mean) - 0.5 * model.sigma ** 2
        t = rng_ln.lognormal(mu, model.sigma, size=shape)
        if model.p_straggle > 0:
            t = np.where(rng_st.random(shape) < model.p_straggle,
                         t * model.straggle_x, t)
        return t

    n = len(clients)
    drop_u = np.empty((n, n_attempts), np.float32)
    duration = np.empty((n, n_attempts), np.float32)
    for i, cm in enumerate(clients):
        streams = [np.random.default_rng([seed, i, j]) for j in range(5)]
        drop_u[i] = streams[0].random(n_attempts).astype(np.float32)
        compute = leg(cm.compute, streams[1], streams[2],
                      (n_attempts, cm.local_epochs)).sum(axis=1)
        upload = leg(cm.upload, streams[3], streams[4], (n_attempts,))
        duration[i] = (compute + upload).astype(np.float32)
    return ClientRounds(drop_u=drop_u, duration=duration)


def client_arrays(clients: Sequence[ClientModel]):
    """The per-client lifecycle constants :func:`federated_trace_scan`
    consumes: ``(p_dropout (n,) f32, rejoin_after (n,) f32, local_epochs
    (n,) i32)`` as numpy arrays."""
    return (np.asarray([c.p_dropout for c in clients], np.float32),
            np.asarray([c.rejoin_after for c in clients], np.float32),
            np.asarray([c.local_epochs for c in clients], np.int32))


class FederatedTrace(NamedTuple):
    """One row per client *upload* event (host numpy arrays).

    client:      (K,) int32 -- uploading client.
    read_at:     (K,) int32 -- server version the client's round started from.
    tau:         (K,) int32 -- staleness in server versions at arrival.
    aggregate:   (K,) int32 -- 1 iff this upload triggers a server write.
    version:     (K,) int32 -- server version AFTER processing the event.
    local_steps: (K,) int32 -- local epochs the client ran this round.
    t_wall:      (K,) float64 -- simulated wall-clock arrival time.
    """

    client: np.ndarray
    read_at: np.ndarray
    tau: np.ndarray
    aggregate: np.ndarray
    version: np.ndarray
    local_steps: np.ndarray
    t_wall: np.ndarray

    @property
    def n_events(self) -> int:
        return int(self.client.shape[0])

    @property
    def n_writes(self) -> int:
        return int(self.aggregate.sum())

    def max_delay(self) -> int:
        return int(self.tau.max(initial=0))


def simulate_federated(
    n_clients: int,
    n_uploads: int,
    clients: Optional[Sequence[ClientModel]] = None,
    buffer_size: int = 1,
    seed: int = 0,
    client_rounds: Optional[ClientRounds] = None,
) -> FederatedTrace:
    """The event structure of async federated aggregation (heapq reference).

    ``buffer_size = 1`` is FedAsync (every upload is a server write);
    ``buffer_size = |R| > 1`` is FedBuff's buffer.  ``client_rounds``, if
    given, replaces on-the-fly sampling and event times accumulate in
    float32 (the twin of :func:`federated_trace_scan`); without it the
    legacy float64 shared-stream sampling is used."""
    if clients is None:
        clients = heterogeneous_clients(n_clients, seed=seed)
    assert len(clients) == n_clients
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be >= 1 (|R| >= 1), got {buffer_size}")
    rng = np.random.default_rng(seed + 3)
    cursor = np.zeros((n_clients,), np.int64)  # attempt index per client

    heap = EventHeap()  # payload: (kind, client, read_version, epochs)
    for i in range(n_clients):
        heap.push(0.0, _START, i, 0, 0)

    client = np.zeros((n_uploads,), np.int32)
    read_at = np.zeros((n_uploads,), np.int32)
    tau = np.zeros((n_uploads,), np.int32)
    aggregate = np.zeros((n_uploads,), np.int32)
    version_arr = np.zeros((n_uploads,), np.int32)
    local_steps = np.zeros((n_uploads,), np.int32)
    t_wall = np.zeros((n_uploads,), np.float64)

    version = 0
    buffered = 0
    k = 0
    while k < n_uploads:
        t, kind, i, v, epochs = heap.pop()
        cm = clients[i]
        if kind == _START:
            if client_rounds is not None:
                a = cursor[i]
                if a >= client_rounds.n_attempts:
                    raise ValueError(
                        f"client {i} exhausted its {client_rounds.n_attempts} "
                        "pre-sampled attempts; enlarge n_attempts in "
                        "sample_client_rounds")
                cursor[i] += 1
                if client_rounds.drop_u[i, a] < cm.p_dropout:
                    heap.push(np.float32(t) + np.float32(cm.rejoin_after),
                              _START, i, 0, 0)
                else:
                    heap.push(np.float32(t) + client_rounds.duration[i, a],
                              _UPLOAD, i, version, cm.local_epochs)
            elif cm.p_dropout > 0 and rng.random() < cm.p_dropout:
                heap.push(t + cm.rejoin_after, _START, i, 0, 0)
            else:
                heap.push(t + cm.round_duration(rng), _UPLOAD, i, version,
                          cm.local_epochs)
            continue
        client[k] = i
        read_at[k] = v
        tau[k] = version - v
        local_steps[k] = epochs
        t_wall[k] = t
        buffered += 1
        if buffered >= buffer_size:
            version += 1
            buffered = 0
            aggregate[k] = 1
        version_arr[k] = version
        heap.push(t, _START, i, 0, 0)
        k += 1
    return FederatedTrace(client, read_at, tau, aggregate, version_arr,
                          local_steps, t_wall)


class FederatedTraceArrays(NamedTuple):
    """``FederatedTrace`` columns as device tensors, each (B, K) with a
    leading cell axis (or (K,) for one cell); ``t_wall`` is float32.

    n_uploads:  (B,) int32 -- uploads actually emitted (short when the pop
                budget ran out; trailing rows are then zero).
    exhausted:  (B,) bool -- some client ran past its pre-sampled attempts.
    """

    client: torch.Tensor
    read_at: torch.Tensor
    tau: torch.Tensor
    aggregate: torch.Tensor
    version: torch.Tensor
    local_steps: torch.Tensor
    t_wall: torch.Tensor
    n_uploads: torch.Tensor
    exhausted: torch.Tensor


def default_fed_steps(n_uploads: int) -> int:
    """Default pop budget: every upload costs two pops (its successful START
    and the UPLOAD itself) plus slack for dropout/rejoin chains."""
    return 2 * n_uploads + max(64, n_uploads // 4)


_I32_MAX = torch.iinfo(torch.int32).max


def federated_trace_scan(
    rounds: ClientRounds,             # (B, n, A) or (n, A) leaves
    p_dropout,                        # (B, n) / (n,) f32
    rejoin_after,                     # (B, n) / (n,) f32
    local_epochs,                     # (B, n) / (n,) i32
    n_uploads: int,
    buffer_size: int = 1,
    n_steps: Optional[int] = None,
    active: Optional[torch.Tensor] = None,   # (B, n) / (n,) bool
    device=None,
) -> FederatedTraceArrays:
    """The federated event race for B cells at once, on ``device`` (the
    device of ``rounds`` when it holds tensors; else resolved).

    One loop iteration is one heap pop in every cell: the client with the
    smallest ``(t, seq)`` key (initial STARTs carry seq 0..n-1; the single
    push of pop p carries n + p).  A START pop consumes attempt ``a``'s
    dropout coin and duration; an UPLOAD pop writes its row straight into
    K-sized output tensors at the cell's upload count (rows past K drop)
    and re-reads at once.  ``active`` keeps padded clients of ragged buckets
    out of the race.  ``n_steps`` bounds the pops (default
    :func:`default_fed_steps`); callers check ``n_uploads`` and
    ``exhausted``.
    """
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be >= 1 (|R| >= 1), got {buffer_size}")
    drop_u, dur = rounds
    if device is None:
        device = drop_u.device if isinstance(drop_u, torch.Tensor) else None
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a, dtype=dtype).to(dev)

    drop_u, dur = put(drop_u, torch.float32), put(dur, torch.float32)
    single = drop_u.ndim == 2
    p_drop = put(p_dropout, torch.float32)
    rejoin = put(rejoin_after, torch.float32)
    epochs = put(local_epochs, torch.int32)
    act = None if active is None else put(active, torch.bool)
    if single:
        drop_u, dur, p_drop, rejoin, epochs = (
            t.unsqueeze(0) for t in (drop_u, dur, p_drop, rejoin, epochs))
        act = None if act is None else act.unsqueeze(0)
    B, n, A = drop_u.shape
    K = int(n_uploads)
    S = default_fed_steps(K) if n_steps is None else int(n_steps)
    i32 = torch.int32
    cells = torch.arange(B, device=dev)

    t = torch.zeros((B, n), dtype=torch.float32, device=dev)
    seq = torch.arange(n, dtype=i32, device=dev).repeat(B, 1)
    kind = torch.zeros((B, n), dtype=i32, device=dev)
    stamp = torch.zeros((B, n), dtype=i32, device=dev)
    attempt = torch.zeros((B, n), dtype=torch.int64, device=dev)
    version = torch.zeros((B,), dtype=i32, device=dev)
    buffered = torch.zeros((B,), dtype=i32, device=dev)
    exhausted = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_up = torch.zeros((B,), dtype=i32, device=dev)
    # compacted upload rows; slot K catches non-uploads and overflow
    rows = torch.zeros((B, K + 1, 6), dtype=i32, device=dev)
    t_rows = torch.zeros((B, K + 1), dtype=torch.float32, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    big = torch.full((), _I32_MAX, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    K_t = torch.full((), K, dtype=torch.int64, device=dev)

    for p in range(S):
        t_race = t if act is None else torch.where(act, t, inf)
        at_min = t_race == t_race.min(dim=1, keepdim=True).values
        i = torch.argmin(torch.where(at_min, seq, big), dim=1)
        ti = t[cells, i]
        stamp_i = stamp[cells, i]
        is_start = kind[cells, i] == _START
        a = attempt[cells, i]
        a_c = torch.clamp(a, max=A - 1)
        dropped = is_start & (drop_u[cells, i, a_c] < p_drop[cells, i])
        started = is_start & ~dropped
        uploaded = ~is_start
        exhausted |= is_start & (a >= A)
        # the single push of this pop: rejoin START, in-flight UPLOAD, or
        # the next round's START at the same time
        t[cells, i] = ti + torch.where(
            dropped, rejoin[cells, i], torch.where(started, dur[cells, i, a_c],
                                                   zero))
        kind[cells, i] = started.to(i32)
        stamp[cells, i] = torch.where(started, version, stamp_i)
        attempt[cells, i] = a + is_start
        seq[cells, i] = n + p
        # upload bookkeeping: the row, and (maybe) an aggregation
        buffered += uploaded.to(i32)
        agg = uploaded & (buffered >= buffer_size)
        version_new = version + agg.to(i32)
        buffered = torch.where(agg, 0, buffered)
        slot = torch.where(uploaded & (n_up < K), n_up.long(), K_t)
        rows[cells, slot] = torch.stack(
            (i.to(i32), stamp_i, version - stamp_i, agg.to(i32), version_new,
             epochs[cells, i]), dim=1)
        t_rows[cells, slot] = ti
        n_up += uploaded.to(i32)
        version = version_new

    cols = [rows[:, :K, j] for j in range(6)] + [t_rows[:, :K]]
    out = FederatedTraceArrays(*cols, n_uploads=torch.clamp(n_up, max=K),
                               exhausted=exhausted)
    if single:
        out = FederatedTraceArrays(*(c[0] for c in out))
    return out


def generate_federated_trace(
    n_clients: int,
    n_uploads: int,
    clients: Optional[Sequence[ClientModel]] = None,
    buffer_size: int = 1,
    seed: int = 0,
    n_steps: Optional[int] = None,
    max_doublings: int = 4,
    faults=None,
    device=None,
) -> FederatedTrace:
    """Host-side wrapper: :func:`federated_trace_scan` on ``device`` (the
    CUDA card unless named), returned as a ``FederatedTrace`` -- bitwise
    ``simulate_federated(..., client_rounds=...)`` on the same pre-sampled
    rounds.  If the pops run out (or a client runs out of pre-sampled
    attempts) the budget doubles and the race re-runs; larger budgets
    extend the same realization.

    ``faults`` (a ``faults.FaultSpec``) stretches the round durations
    (crash/rejoin slowdowns, straggler spikes) with ``seed`` as the fault
    cell seed -- the transform the batched sweep applies to its cells, so
    the solo trace is bitwise the batched cell's row."""
    from ..faults.inject import inject_client_rounds
    from ..faults.spec import normalize_faults
    faults = normalize_faults(faults)
    if clients is None:
        clients = heterogeneous_clients(n_clients, seed=seed)
    assert len(clients) == n_clients
    dev = resolve_device(device)
    consts = client_arrays(clients)
    S = default_fed_steps(n_uploads) if n_steps is None else int(n_steps)
    for _ in range(max_doublings + 1):
        rounds = sample_client_rounds(clients, S, seed=seed)
        if faults is not None:
            rounds = inject_client_rounds(ClientRounds(*(
                torch.from_numpy(a).to(dev) for a in rounds)), faults, seed)
        out = federated_trace_scan(rounds, *consts, n_uploads,
                                   buffer_size=buffer_size, n_steps=S,
                                   device=dev)
        if int(out.n_uploads) >= n_uploads and not bool(out.exhausted):
            c = [col.cpu().numpy() for col in out[:7]]
            return FederatedTrace(*c[:6], c[6].astype(np.float64))
        S *= 2
    raise RuntimeError(
        f"federated trace did not produce {n_uploads} uploads within "
        f"{S // 2} pops; dropout/rejoin chains are extreme -- pass a larger "
        "n_steps explicitly")
