"""The port's sweep meshes (``repro_torch.mesh``) and the 2-D sharded
backend, mirroring every case of ``tests/test_mesh2d.py``.

The reference's cases run on forced host devices; the port's CPU has one
device, so its meshes list the CPU 1, 2, 4 or 8 times (a caller's
explicit list may repeat a device; a default never does).  Each row of
such a mesh runs in turn on the CPU, so the sharding logic -- the padding,
the blocks, the per-row programs, the data-parallel gradient sums, the
cell-order gather -- is exercised exactly.  Exact: every integer leaf
(taus, clipped, blocks, versions, fault counters) and the gammas, 1-D
against 2-D against batched.  A data axis > 1 sums the gradient in
another order: objectives within OBJ_REL of their start.
"""
import numpy as np
import pytest
import torch

import repro_torch.mesh as tmesh
from repro_torch.api import ExecutionSpec, run_components
from repro_torch.core.engine import (WorkerModel, heterogeneous_workers,
                                     sample_service_times, trace_scan)
from repro_torch.core.piag import default_grad_fn, piag_scan
from repro_torch.core.problems import make_logreg
from repro_torch.core.prox import L1
from repro_torch.core.pytree import tree_leaves
from repro_torch.core.stepsize import Adaptive1, FixedStepSize, HingeWeight
from repro_torch.faults import FaultSpec
from repro_torch.federated.events import heterogeneous_clients
from repro_torch.federated.server import _problem_pieces, local_prox_sgd
from repro_torch.mesh import (DATA_AXIS, Mesh, cell_axis_size, cell_mesh,
                              data_axis_size, data_parallel_grad, grid_mesh,
                              mesh_topology, pmean_grad)
from repro_torch.sweep import (clear_program_cache, make_grid,
                               program_cache_stats, round_robin_pad,
                               sharded_sweep_bcd, sharded_sweep_fedasync,
                               sharded_sweep_fedbuff, sharded_sweep_piag,
                               standard_topology_factories, sweep_bcd_logreg,
                               sweep_piag_logreg)
from repro_torch.sweep.cache import IdKey, _key_fingerprints
from repro_torch.sweep.shard import PerDevice

CPU = torch.device("cpu")
OBJ_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpus(n):
    return [CPU] * n


@pytest.fixture(scope="module")
def problem():
    # 32 samples per worker: divisible by every data-axis size used here
    return make_logreg(256, 30, n_workers=8, seed=0, device="cpu")


def _mesh_2d(data: int = 2, cells: int = 2):
    return grid_mesh((cells, data), cpus(cells * data))


def _grid(gp, n_events=48, widths=None):
    topos = (standard_topology_factories() if widths is not None else
             {"uniform": [WorkerModel() for _ in range(8)],
              "hetero": heterogeneous_workers(8, seed=1)})
    kw = {} if widths is None else {"n_workers": list(widths)}
    return make_grid(
        policies={"a1": Adaptive1(gamma_prime=gp),
                  "fx": FixedStepSize(gamma_prime=gp, tau_bound=12)},
        seeds=[0, 1], topologies=topos, n_events=n_events, **kw)


def _assert_int_leaves_equal(a, b, fields):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _assert_obj_close(a, b):
    env = OBJ_REL * float(a.objective[:, :1].abs().min())
    assert float((a.objective - b.objective).abs().max()) <= env


def _loss(problem):
    return lambda x, A, b: problem.worker_loss(x, A, b)


def _x0(problem):
    return torch.zeros((problem.dim,), dtype=torch.float32)


# ----------------------------------------------------- mesh construction ----

def test_grid_mesh_shapes_and_validation():
    m1 = grid_mesh((1,), cpus(1))
    assert tuple(m1.axis_names) == ("cells",)
    m2 = grid_mesh((1, 1), cpus(1))
    assert tuple(m2.axis_names) == ("cells", "data")
    assert cell_axis_size(m2) == 1 and data_axis_size(m2) == 1
    assert data_axis_size(m1) == 1
    m22 = grid_mesh((2, 2), cpus(4))
    assert m22.shape == {"cells": 2, "data": 2} and m22.size == 4
    assert m22.rows() == [cpus(2), cpus(2)]
    with pytest.raises(ValueError, match="positive"):
        grid_mesh((0, 2), cpus(4))
    with pytest.raises(ValueError, match="mesh_shape"):
        grid_mesh((1, 2, 3), cpus(6))
    with pytest.raises(ValueError, match="devices"):
        grid_mesh((2, 2), cpus(3))
    # a sweep mesh without a "cells" axis is rejected loudly
    with pytest.raises(ValueError, match="cells"):
        cell_axis_size(Mesh(np.array(cpus(1), dtype=object), ("data",)))


def test_default_meshes_take_the_cards_and_never_the_cpu(monkeypatch):
    """``cell_mesh()`` / ``grid_mesh(shape)`` span the CUDA cards; with
    none they raise instead of going to the CPU.  A repeated device comes
    only from an explicit list."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cell_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        grid_mesh((1,))
    assert [str(d) for d in cell_mesh(["cpu", "cpu"]).devices] == \
        ["cpu", "cpu"]


def test_execution_spec_mesh_shape_validation():
    ex = ExecutionSpec(backend="sharded", mesh_shape=(1, 1))
    assert ex.mesh_shape == (1, 1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ExecutionSpec(backend="sharded", mesh=cell_mesh(cpus(1)),
                      mesh_shape=(1, 1))
    with pytest.raises(ValueError, match="sharded"):
        ExecutionSpec(backend="batched", mesh_shape=(1, 1))
    with pytest.raises(ValueError, match="positive"):
        ExecutionSpec(backend="sharded", mesh_shape=(1, 0))
    with pytest.raises(ValueError, match="process_id"):
        ExecutionSpec(backend="sharded", num_processes=2, process_id=2)
    with pytest.raises(ValueError, match="sharded"):
        ExecutionSpec(backend="batched", coordinator="localhost:1234")


def test_api_mesh_needs_the_devices_it_names(problem):
    """On the CPU a spec's default mesh is the one CPU: ``mesh_shape`` or
    ``devices`` asking for more raise (as the reference's ``grid_mesh``),
    and (1,) / (1, 1) run."""
    grid = _grid(0.99 / problem.L, n_events=8)
    prox = L1(lam=problem.lam1)
    with pytest.raises(ValueError, match="needs 2 devices"):
        run_components("piag", "sharded", problem=problem, grid=grid,
                       prox=prox, mesh_shape=(2,))
    spec_kw = dict(problem=problem, grid=grid, prox=prox)
    for shape in ((1,), (1, 1)):
        res = run_components("piag", "sharded", mesh_shape=shape, **spec_kw)
        assert res.telemetry.devices == 1
        assert res.telemetry.mesh_shape == list(shape)


# ------------------------------------------------- topology cache keying ----

def test_mesh_topology_distinct_1d_vs_2d():
    t1 = mesh_topology(cell_mesh(cpus(1)))
    t2 = mesh_topology(grid_mesh((1, 1), cpus(1)))
    assert t1 != t2  # same device, reshaped: must key fresh
    # same topology, distinct Mesh objects: must key equal
    assert mesh_topology(grid_mesh((1, 1), cpus(1))) == t2
    assert t1 == ("mesh", ("cells",), (1,), "cpu", 1)
    tops = {mesh_topology(cell_mesh(cpus(8))),
            mesh_topology(grid_mesh((4, 2), cpus(8))),
            mesh_topology(grid_mesh((2, 4), cpus(8)))}
    assert len(tops) == 3


def test_key_fingerprints_meshes_by_topology():
    """Meshes inside cache keys fingerprint by (axis names, shape, device
    kind, process count), raw or IdKey-wrapped."""
    m_a = cell_mesh(cpus(1))
    m_b = cell_mesh(cpus(1))   # distinct object, same topology
    m_2d = grid_mesh((1, 1), cpus(1))
    fp = _key_fingerprints(("tag", m_a, IdKey(m_2d)))
    assert len(fp) == 2
    assert all("cells" in print_ for _, print_ in fp)
    assert _key_fingerprints(("tag", m_a)) == _key_fingerprints(("tag", m_b))
    assert _key_fingerprints(("tag", m_a)) != _key_fingerprints(("tag", m_2d))


def test_program_cache_keys_distinct_1d_vs_2d(problem):
    """A 1-D and a (reshaped) 2-D mesh over the same devices build distinct
    programs; a same-topology mesh rebuild reuses the cached ones; the
    rows of a mesh that lists one device twice share one program."""
    gp = 0.99 / problem.L
    prox = L1(lam=problem.lam1)
    grid = _grid(gp, n_events=16)
    loss, obj, x0 = _loss(problem), problem.P, _x0(problem)
    wd = problem.worker_slices()
    clear_program_cache()
    sharded_sweep_piag(loss, x0, wd, grid, prox, objective=obj,
                       mesh=cell_mesh(cpus(2)))
    stats_1d = program_cache_stats()
    assert stats_1d["misses"] == 1 and stats_1d["hits"] == 1  # two rows
    sharded_sweep_piag(loss, x0, wd, grid, prox, objective=obj,
                       mesh=grid_mesh((1, 2), cpus(2)))
    stats = program_cache_stats()
    assert stats["misses"] == stats_1d["misses"] + 1  # 2-D keys fresh
    sharded_sweep_piag(loss, x0, wd, grid, prox, objective=obj,
                       mesh=cell_mesh(cpus(2)))  # fresh Mesh object
    stats2 = program_cache_stats()
    assert stats2["misses"] == stats["misses"]  # same topology: cache hits
    assert stats2["hits"] == stats["hits"] + 2


# ------------------------------------------------------ round-robin rule ----

def test_round_robin_pad_keys_on_cells_axis():
    """The >= 2-cells-per-shard rule applies to the cells axis only: 3
    cells on a (2, 4) mesh pad to 4 rows (2 shards x 2), not to 8 x 2."""
    np.testing.assert_array_equal(round_robin_pad(3, 2), [0, 1, 2, 0])
    assert round_robin_pad(3, 2).shape == (4,)
    np.testing.assert_array_equal(round_robin_pad(3, 1), [0, 1, 2])
    with pytest.raises(ValueError, match="empty"):
        round_robin_pad(0, 2)


def test_round_robin_pad_2x4_mesh_regression(problem):
    """A 3-cell grid on a (2, 4) mesh pads on the 2-wide cells axis and
    reproduces the batched rows: integer leaves and gammas exact."""
    mesh = grid_mesh((2, 4), cpus(8))
    assert cell_axis_size(mesh) == 2 and data_axis_size(mesh) == 4
    gp = 0.99 / problem.L
    prox = L1(lam=problem.lam1)
    grid = make_grid(
        policies={"a1": Adaptive1(gamma_prime=gp)},
        seeds=[0, 1, 2],
        topologies={"uniform": [WorkerModel() for _ in range(8)]},
        n_events=32)
    assert len(grid) == 3
    batched = sweep_piag_logreg(problem, grid, prox)
    sharded = sharded_sweep_piag(_loss(problem), _x0(problem),
                                 problem.worker_slices(), grid, prox,
                                 objective=problem.P, mesh=mesh)
    _assert_int_leaves_equal(batched, sharded, ("taus", "clipped", "gammas"))
    _assert_obj_close(batched, sharded)


# --------------------------------------- solo vs 1-D vs 2-D: all solvers ----

def test_piag_2d_rows_equal_1d_and_solo(problem):
    gp = 0.99 / problem.L
    prox = L1(lam=problem.lam1)
    grid = _grid(gp)
    loss, x0, wd = _loss(problem), _x0(problem), problem.worker_slices()
    one_d = sharded_sweep_piag(loss, x0, wd, grid, prox,
                               objective=problem.P, mesh=cell_mesh(cpus(4)))
    two_d = sharded_sweep_piag(loss, x0, wd, grid, prox,
                               objective=problem.P, mesh=_mesh_2d(2))
    _assert_int_leaves_equal(one_d, two_d, ("taus", "clipped", "gammas"))
    _assert_obj_close(one_d, two_d)
    assert float((one_d.x - two_d.x).abs().max()) <= 1e-6
    # 2-D vs solo (dataclass policy): taus exact, objective in the envelope
    for i in (0, len(grid) // 2, len(grid) - 1):
        cell = grid.cells[i]
        T = sample_service_times(cell.workers, grid.n_events + 1,
                                 seed=cell.seed)
        tr = trace_scan(torch.from_numpy(T))
        solo = piag_scan(loss, x0, wd, (tr.worker[None], tr.tau_max[None]),
                         cell.policy, prox, objective=problem.P)
        assert torch.equal(solo.taus[0], two_d.taus[i])
        assert torch.equal(solo.clipped[0], two_d.clipped[i])
        env = OBJ_REL * float(solo.objective[0, 0].abs())
        assert float((solo.objective[0] - two_d.objective[i]).abs().max()) \
            <= env


def test_piag_2d_ragged_and_chaos_rows_equal(problem):
    """Ragged bucket widths and chaos faults: taus, clipped, gammas and the
    fault counters exact across 1-D and 2-D meshes."""
    gp = 0.99 / problem.L
    prox = L1(lam=problem.lam1)
    chaos = FaultSpec(p_crash=0.05, p_rejoin=0.3, crash_scale=20.0,
                      p_spike=0.1, spike_scale=10.0, p_drop=0.1,
                      p_dup=0.05, p_corrupt=0.05, seed=7)
    grid = _grid(gp, n_events=40, widths=(4, 8))
    loss, x0, wd = _loss(problem), _x0(problem), problem.worker_slices()
    kw = dict(objective=problem.P, faults=chaos, engine="scan")
    one_d = sharded_sweep_piag(loss, x0, wd, grid, prox,
                               mesh=cell_mesh(cpus(2)), **kw)
    two_d = sharded_sweep_piag(loss, x0, wd, grid, prox, mesh=_mesh_2d(2),
                               **kw)
    _assert_int_leaves_equal(one_d, two_d, ("taus", "clipped", "gammas"))
    for la, lb in zip(tree_leaves(one_d.faults), tree_leaves(two_d.faults)):
        assert torch.equal(la, lb)
    assert int(sum(t.sum() for t in tree_leaves(one_d.faults))) > 0
    _assert_obj_close(one_d, two_d)


def _bcd_dp(problem, mesh):
    """The api path's data-parallel BCD gradient: each data device's
    ``grad_f`` over its slice of the samples."""
    import dataclasses
    return PerDevice(lambda row: data_parallel_grad(
        lambda A, b: dataclasses.replace(problem, A=A, b=b).grad_f,
        (problem.A, problem.b), row))


def test_bcd_2d_rows_equal(problem):
    m = 6
    gp = 0.99 / problem.block_smoothness(m)
    prox = L1(lam=problem.lam1)
    grid = _grid(gp, n_events=40)
    mesh2 = _mesh_2d(2)
    batched = sweep_bcd_logreg(problem, grid, prox, m=m)
    two_d = sharded_sweep_bcd(problem.grad_f, problem.P, _x0(problem), m,
                              grid, prox, mesh=mesh2,
                              dp_grad_f=_bcd_dp(problem, mesh2))
    _assert_int_leaves_equal(batched, two_d,
                             ("taus", "blocks", "clipped", "gammas"))
    _assert_obj_close(batched, two_d)


def test_bcd_2d_without_dp_grad_warns_but_matches(problem):
    """A 2-D mesh with an opaque grad_f computes on each row's first
    device: a RuntimeWarning fires and the rows are bitwise the 1-D
    mesh's."""
    m = 6
    gp = 0.99 / problem.block_smoothness(m)
    prox = L1(lam=problem.lam1)
    grid = _grid(gp, n_events=32)
    x0 = _x0(problem)
    one_d = sharded_sweep_bcd(problem.grad_f, problem.P, x0, m, grid, prox,
                              mesh=cell_mesh(cpus(2)))
    with pytest.warns(RuntimeWarning, match="replicated"):
        two_d = sharded_sweep_bcd(problem.grad_f, problem.P, x0, m, grid,
                                  prox, mesh=_mesh_2d(2))
    _assert_int_leaves_equal(one_d, two_d, ("taus", "blocks", "clipped"))
    assert torch.equal(one_d.objective, two_d.objective)


def test_fed_2d_rows_equal(problem):
    prox = L1(lam=problem.lam1)
    lr = 0.5 / problem.L
    grid = make_grid(
        policies={"hinge": HingeWeight(gamma_prime=0.6)},
        seeds=[0, 1, 2],
        topologies={"edge": heterogeneous_clients(8, seed=5)},
        n_events=40)
    update, x0, data = _problem_pieces(problem, prox, lr)
    mesh2 = _mesh_2d(2)
    dp_update = PerDevice(lambda row: local_prox_sgd(
        problem.worker_loss, prox, lr, grad_fn=data_parallel_grad(
            lambda *part: problem.worker_grads(part), data, row,
            sample_axis=1)))
    for solver, kw in (("fedasync", {}),
                       ("fedbuff", dict(eta=0.4, buffer_size=2))):
        runner = (sharded_sweep_fedasync if solver == "fedasync"
                  else sharded_sweep_fedbuff)
        one_d = runner(update, x0, data, grid, objective=problem.P,
                       mesh=cell_mesh(cpus(2)), **kw)
        two_d = runner(dp_update, x0, data, grid, objective=problem.P,
                       mesh=mesh2, **kw)
        _assert_int_leaves_equal(one_d, two_d,
                                 ("taus", "versions", "clipped", "weights"))
        _assert_obj_close(one_d, two_d)


@pytest.mark.parametrize("solver", ["piag", "bcd", "fedasync", "fedbuff"])
def test_api_mesh_routes_2d_for_all_solvers(problem, solver):
    """The spec path on a 2-D mesh builds the data-parallel gradient (the
    closed form for PIAG and the federated clients, each data device's
    ``grad_f`` slice for BCD) and reproduces the 1-D rows with exact
    integer leaves and gammas."""
    prox = L1(lam=problem.lam1)
    if solver == "bcd":
        gp = 0.99 / problem.block_smoothness(6)
    elif solver == "piag":
        gp = 0.99 / problem.L
    else:
        gp = 0.6
    if solver in ("fedasync", "fedbuff"):
        grid = make_grid(
            policies={"hinge": HingeWeight(gamma_prime=gp)},
            seeds=[0, 1],
            topologies={"edge": heterogeneous_clients(8, seed=5)},
            n_events=32)
    else:
        grid = _grid(gp, n_events=32)
    kw = {"m": 6} if solver == "bcd" else {}
    if solver == "fedbuff":
        kw = dict(eta=0.4, buffer_size=2)
    one_d = run_components(solver, "sharded", problem=problem, grid=grid,
                           prox=prox, mesh=cell_mesh(cpus(4)), **kw)
    two_d = run_components(solver, "sharded", problem=problem, grid=grid,
                           prox=prox, mesh=_mesh_2d(2), **kw)
    ints = {"piag": ("taus", "clipped"), "bcd": ("taus", "blocks", "clipped"),
            "fedasync": ("taus", "versions", "clipped"),
            "fedbuff": ("taus", "versions", "clipped")}[solver]
    _assert_int_leaves_equal(one_d.raw, two_d.raw, ints)
    assert torch.equal(one_d.gammas, two_d.gammas)
    _assert_obj_close(one_d.raw, two_d.raw)
    assert two_d.telemetry.devices == 4
    assert two_d.telemetry.mesh_shape == [2, 2]


# ------------------------------------------------------------ guard rails ----

def test_pmean_grad_rejects_indivisible_sample_axis():
    """30 samples per worker on a 4-wide data axis: a loud error, never a
    silent sample drop."""
    prob = make_logreg(240, 20, n_workers=8, seed=0, device="cpu")
    prox = L1(lam=prob.lam1)
    grid = _grid(0.99 / prob.L, n_events=8)
    with pytest.raises(ValueError, match="divide"):
        sharded_sweep_piag(_loss(prob), _x0(prob), prob.worker_slices(),
                           grid, prox, objective=prob.P,
                           mesh=grid_mesh((1, 4), cpus(4)))


def test_pmean_grad_is_the_mean_of_slice_gradients(problem):
    """``pmean_grad`` over 1, 2 and 4 slices against the full gradient
    (a sample-mean loss plus an x-only term), and ``data_parallel_grad``
    of the closed form against ``default_grad_fn``."""
    x = torch.linspace(-0.5, 0.5, problem.dim)
    A, b = problem.A, problem.b
    loss = _loss(problem)
    full = torch.func.grad(loss)(x, A, b)
    for size in (1, 2, 4):
        g = pmean_grad(loss, DATA_AXIS, size, devices=cpus(size))(x, A, b)
        assert float((g - full).abs().max()) <= 1e-6 * float(
            full.abs().max())
    with pytest.raises(ValueError, match="divide"):
        pmean_grad(loss, DATA_AXIS, 3)(x, A, b)
    wd = problem.worker_slices()
    xw = torch.stack([x, -x, 0.5 * x])
    w = torch.tensor([0, 3, 7])
    want = default_grad_fn(problem.worker_loss, wd)(xw, w)
    for row in (cpus(1), cpus(2), cpus(4)):
        got = data_parallel_grad(lambda *part: problem.worker_grads(part),
                                 wd, row, sample_axis=1)(xw, w)
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


def test_maybe_init_distributed_consumes_knobs_once(monkeypatch):
    """The multi-host knobs call ``torch.distributed.init_process_group``
    exactly once per process (gloo on the CPU, NCCL on the cards) and are
    otherwise inert (no coordinator -> no-op)."""
    calls = []
    monkeypatch.setattr(tmesh, "_DISTRIBUTED_INITIALIZED", False)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(
        torch.distributed, "init_process_group",
        lambda backend, init_method, world_size, rank:
            calls.append((backend, init_method, world_size, rank)))
    ex = ExecutionSpec(backend="sharded", coordinator="localhost:9876",
                       num_processes=1, process_id=0)
    assert tmesh.maybe_init_distributed(ex, "cpu") is True
    assert calls == [("gloo", "tcp://localhost:9876", 1, 0)]
    assert tmesh.maybe_init_distributed(ex, "cpu") is True  # idempotent
    assert len(calls) == 1
    assert tmesh.maybe_init_distributed(
        ExecutionSpec(backend="sharded")) is False
    monkeypatch.setattr(tmesh, "_DISTRIBUTED_INITIALIZED", False)
    tmesh.maybe_init_distributed(ex)  # device None: the cards
    assert calls[-1][0] == "nccl" and len(calls) == 2
