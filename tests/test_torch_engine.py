"""repro_torch.core.engine held against repro.core.engine.

Service times come from the same numpy substreams, so they must be bitwise
equal; the event race (worker, read_at, tau, tau_max) is integer and
t_wall is a chain of float32 adds, so every trace column is held bitwise,
ragged masks included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro_torch.core import engine as te
from repro_torch.sweep.grid import standard_topologies


def _topologies(n):
    return standard_topologies(n, seed=0)


@pytest.mark.parametrize("name", ["uniform", "hetero2", "hetero4", "straggler"])
def test_service_times_bitwise(name):
    workers = _topologies(6)[name]
    ref = je.sample_service_times(workers, 301, seed=4)
    got = te.sample_service_times(workers, 301, seed=4)
    np.testing.assert_array_equal(got, ref)


def test_heterogeneous_workers_equal_reference():
    assert te.heterogeneous_workers(7, spread=3.0, seed=2) == [
        te.WorkerModel(**w.__dict__)
        for w in je.heterogeneous_workers(7, spread=3.0, seed=2)]


@pytest.mark.parametrize("with_matrix", [False, True])
@pytest.mark.parametrize("seed", [3, 11])
def test_heapq_simulator_matches_reference(with_matrix, seed):
    T = te.sample_service_times(te.heterogeneous_workers(5), 401, seed=1) \
        if with_matrix else None
    ref = je.simulate_parameter_server(5, 400, seed=seed, service_times=T)
    got = te.simulate_parameter_server(5, 400, seed=seed, service_times=T)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got.max_delay() == ref.max_delay()


def test_trace_scan_batched_matches_reference_vmap():
    Ts = np.stack([te.sample_service_times(ws, 257, seed=s)
                   for ws in _topologies(6).values() for s in (0, 1)])
    ref = jax.jit(jax.vmap(je.trace_scan))(jnp.asarray(Ts))
    got = te.trace_scan(torch.from_numpy(Ts))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_trace_scan_ragged_masks_match_reference_and_exact_width():
    """Cells padded to width 8 with +inf rows and masked: bitwise the
    reference's masked scan, and bitwise each cell's exact-width trace."""
    widths = (3, 5, 8)
    width, K = 8, 200
    topo = _topologies(8)["hetero4"]
    Ts = np.full((len(widths), width, K + 1), np.inf, np.float32)
    act = np.zeros((len(widths), width), bool)
    for i, w in enumerate(widths):
        Ts[i, :w] = te.sample_service_times(topo[:w], K + 1, seed=i)
        act[i, :w] = True
    ref = jax.jit(jax.vmap(je.trace_scan))(jnp.asarray(Ts), jnp.asarray(act))
    got = te.trace_scan(torch.from_numpy(Ts), torch.from_numpy(act))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i, w in enumerate(widths):
        solo = te.trace_scan(torch.from_numpy(Ts[i, :w]))
        for a, b in zip(solo, got):
            np.testing.assert_array_equal(a.numpy(), b[i].numpy())


@pytest.mark.parametrize("kind", ["parameter_server", "shared_memory"])
def test_generate_trace_matches_reference_and_heapq(kind):
    T = te.sample_service_times(_topologies(4)["straggler"], 301, seed=7)
    ref = je.generate_trace(T, kind=kind)
    got = te.generate_trace(T, kind=kind, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    heap = te.simulate_parameter_server(4, 300, service_times=T)
    np.testing.assert_array_equal(got.worker, heap.worker)
    np.testing.assert_array_equal(got.tau, heap.tau)


def test_generate_trace_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown trace kind"):
        te.generate_trace(np.ones((2, 3), np.float32), kind="ring",
                          device="cpu")


@pytest.mark.parametrize("every", [1, 2, 5])
def test_strided_scan_records_rows_of_the_stride1_run(every):
    xs = (torch.arange(20),)

    def make_step(emit):
        def step(c, e):
            c = c + e[0]
            return c, ((c * 2,) if emit else None)
        return step

    c1, full = te.strided_scan(make_step, torch.tensor(0), xs, 1)
    cs, part = te.strided_scan(make_step, torch.tensor(0), xs, every)
    assert int(c1) == int(cs)
    np.testing.assert_array_equal(part[0].numpy(),
                                  full[0].numpy()[every - 1::every])


def test_strided_scan_rejects_bad_stride():
    with pytest.raises(ValueError):
        te.strided_scan(lambda e: None, 0, (torch.arange(10),), 3)
    with pytest.raises(ValueError):
        te.strided_scan(lambda e: None, 0, (torch.arange(10),), 0)


def test_event_heap_breaks_ties_by_insertion():
    h = te.EventHeap()
    h.push(1.0, "a")
    h.push(0.5, "b")
    h.push(1.0, "c")
    assert [h.pop()[1] for _ in range(3)] == ["b", "a", "c"]
    assert len(h) == 0
