"""The sharded backend (``repro_torch.sweep.shard`` and
``api.run(backend="sharded")``) against the port's batched rows and the
reference's batched and sharded rows.

The port's CPU has one device, so its meshes list the CPU 1, 2 or 4 times
(rows run in turn there); the reference runs in this process on its one
host device, and in a subprocess on 4 forced host devices for the (4,)
and (2, 2) meshes.  Exact: worker ids, taus, clipped, blocks, versions and
fault counters.  Bitwise: the gammas of the fixed / naive / adaptive1 /
adaptive2 families and the federated ``constant`` weights; hinge / poly
within GAMMA_ULPS ulps across packages; within the port bitwise but for
poly on the CPU (``_gammas_equal``).  The
objective within OBJ_REL of its start (the port's sharded rows run the
batched program on blocks of the cells, whose products may sum in
another order; XLA:CPU contracts FMAs the port does not, ROADMAP queue
C).  A multi-process test runs one spec over two gloo processes.
"""
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch.core.engine import WorkerModel, heterogeneous_workers
from repro_torch.core.problems import make_logreg
from repro_torch.core.prox import L1
from repro_torch.core.pytree import tree_leaves
from repro_torch.core.stepsize import Adaptive1, FixedStepSize, HingeWeight
from repro_torch.faults import parse_faults
from repro_torch.federated.events import heterogeneous_clients
from repro_torch.federated.server import _problem_pieces
from repro_torch.mesh import cell_mesh, grid_mesh
from repro_torch.sweep import (make_grid, make_sharded_sweep_piag, next_pow2,
                               round_robin_pad, sharded_sweep_bcd,
                               sharded_sweep_fedbuff,
                               sharded_sweep_piag_logreg,
                               standard_topology_factories, sweep_bcd_logreg,
                               sweep_fedbuff_problem, sweep_piag_logreg)
from repro_torch.telemetry.timing import drain_timings

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GAMMA_ULPS = 4
OBJ_REL = 1e-5
EXACT = ("adaptive1", "adaptive2", "fixed", "naive", "constant")
INTS = {"piag": ("taus", "clipped"), "bcd": ("taus", "blocks", "clipped"),
        "fedasync": ("taus", "versions", "clipped"),
        "fedbuff": ("taus", "versions", "clipped")}


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


MESHES = {"(1,)": lambda: cell_mesh(cpus(1)),
          "(2,)": lambda: cell_mesh(cpus(2)),
          "(4,)": lambda: cell_mesh(cpus(4)),
          "(1, 2)": lambda: grid_mesh((1, 2), cpus(2)),
          "(2, 2)": lambda: grid_mesh((2, 2), cpus(4))}


@pytest.fixture(scope="module")
def problem():
    return make_logreg(240, 30, n_workers=8, seed=0, device="cpu")


def _ragged_grid(gp, n_events=48, widths=(4, 8)):
    return make_grid(
        policies={"a1": Adaptive1(gamma_prime=gp),
                  "fx": FixedStepSize(gamma_prime=gp, tau_bound=12)},
        seeds=[0, 1],
        topologies=standard_topology_factories(),
        n_events=n_events,
        n_workers=list(widths))


def _obj_close(a, b):
    env = OBJ_REL * float(a.objective[:, :1].abs().min())
    return float((a.objective - b.objective).abs().max()) <= env


def _gammas_equal(a, b):
    """Two port runs' gammas (``Results``): bitwise for the families that
    depend on the delays alone and for hinge; poly's ``torch.pow`` on the
    CPU rounds a lane of its vector loop and its scalar tail apart, so a
    cell's gamma moves by an ulp with its position in a block (ROADMAP
    queue C): within GAMMA_ULPS ulps."""
    poly = torch.tensor([c.policy_name == "poly" for c in a.cells])
    assert torch.equal(a.gammas[~poly], b.gammas[~poly])
    ulps = (a.gammas[poly].view(torch.int32)
            - b.gammas[poly].view(torch.int32)).abs()
    assert not ulps.numel() or int(ulps.max()) <= GAMMA_ULPS


# ---------------------------------------- the reference's shard tests ----

def test_next_pow2_and_round_robin_pad():
    assert [next_pow2(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    idx = round_robin_pad(5, 4)
    assert idx.shape == (8,)
    np.testing.assert_array_equal(idx, [0, 1, 2, 3, 4, 0, 1, 2])


@pytest.mark.parametrize("mesh", ["(1,)", "(2,)", "(4,)"])
def test_sharded_sweep_piag_rows_equal_single_device(problem, mesh):
    """Sharded vs batched rows; on (4,) the 12 cells pad to 16 and cross
    shard boundaries.  Integer leaves and gammas exact, objective and
    iterate within the envelope."""
    gp = 0.99 / problem.L
    prox = L1(lam=problem.lam1)
    grid = make_grid(
        policies={"a1": Adaptive1(gamma_prime=gp),
                  "fx": FixedStepSize(gamma_prime=gp, tau_bound=12)},
        seeds=[0, 1, 2],
        topologies={"uniform": [WorkerModel() for _ in range(4)],
                    "hetero": heterogeneous_workers(4, seed=1)},
        n_events=40)
    assert len(grid) == 12
    batched = sweep_piag_logreg(problem, grid, prox)
    sharded = sharded_sweep_piag_logreg(problem, grid, prox,
                                        mesh=MESHES[mesh]())
    for f in ("taus", "clipped", "gammas"):
        assert torch.equal(getattr(batched, f), getattr(sharded, f)), f
    assert _obj_close(batched, sharded)
    assert float((batched.x - sharded.x).abs().max()) <= 1e-6


def test_multi_device_sharded_ragged_and_fed_rows(problem):
    """On a (4,) mesh: ragged sharded PIAG and sharded FedBuff reproduce
    the batched rows across shard boundaries."""
    gp = 0.99 / problem.L
    prox = L1(lam=problem.lam1)
    grid = _ragged_grid(gp, n_events=40)
    mesh = cell_mesh(cpus(4))
    batched = sweep_piag_logreg(problem, grid, prox)
    sharded = sharded_sweep_piag_logreg(problem, grid, prox, mesh=mesh)
    for f in ("taus", "clipped", "gammas"):
        assert torch.equal(getattr(batched, f), getattr(sharded, f)), f
    assert _obj_close(batched, sharded)

    gridf = make_grid(
        policies={"hinge": HingeWeight(gamma_prime=0.6)},
        seeds=[0, 1, 2],
        topologies={"edge": heterogeneous_clients(4, seed=5)},
        n_events=40)
    update, x0, data = _problem_pieces(problem, prox, None)
    batched_f = sweep_fedbuff_problem(problem, gridf, prox, eta=0.4,
                                      buffer_size=2)
    sharded_f = sharded_sweep_fedbuff(update, x0, data, gridf, eta=0.4,
                                      buffer_size=2, objective=problem.P,
                                      mesh=mesh)
    for f in ("taus", "versions", "clipped", "weights"):
        assert torch.equal(getattr(batched_f, f), getattr(sharded_f, f)), f
    assert _obj_close(batched_f, sharded_f)


def test_multi_device_sharded_bcd_rows(problem):
    m = 6
    gp = 0.99 / problem.block_smoothness(m)
    prox = L1(lam=problem.lam1)
    grid = _ragged_grid(gp, n_events=40)
    x0 = torch.zeros((problem.dim,), dtype=torch.float32)
    batched = sweep_bcd_logreg(problem, grid, prox, m=m)
    sharded = sharded_sweep_bcd(problem.grad_f, problem.P, x0, m, grid, prox,
                                mesh=cell_mesh(cpus(4)))
    for f in ("taus", "blocks", "clipped", "gammas"):
        assert torch.equal(getattr(batched, f), getattr(sharded, f)), f
    assert _obj_close(batched, sharded)


def test_make_sharded_sweep_piag_needs_a_cells_axis_multiple(problem):
    """The ``make_sharded_*`` functions take a batch that divides by the
    cells axis (pad it with ``round_robin_pad``) and raise otherwise."""
    gp = 0.99 / problem.L
    grid = make_grid({"a1": Adaptive1(gamma_prime=gp)}, [0, 1, 2],
                     {"u": [WorkerModel() for _ in range(4)]}, n_events=16)
    x0 = torch.zeros((problem.dim,), dtype=torch.float32)
    wd = tuple(leaf[:4] for leaf in problem.worker_slices())
    fn = make_sharded_sweep_piag(problem.worker_loss, x0, wd,
                                 L1(lam=problem.lam1), objective=problem.P,
                                 mesh=cell_mesh(cpus(2)))
    T, pp = grid.service_times(4), grid.policy_params("cpu")
    with pytest.raises(ValueError, match="multiple"):
        fn(T, pp)
    idx = round_robin_pad(3, 2)
    out = fn(T[idx], pp.__class__(*(t[torch.from_numpy(idx)] for t in pp)))
    assert out.taus.shape[0] == 4
    assert torch.equal(out.taus[3], out.taus[0])  # the replayed cell


# ------------------------------------------ against the reference ----

def _spec(mod, solver, backend, engine, ragged=None, **ex):
    """A small spec of ``mod`` (either package): PIAG and BCD on a ragged
    grid (3 and 4 workers) unless ``ragged=False``, the federated servers
    on 4 edge clients unless ``ragged=True`` (4 and 6)."""
    fed = solver in ("fedasync", "fedbuff")
    ragged = (not fed) if ragged is None else ragged
    if fed:
        topo = mod.TopologySpec(kind="edge",
                                n_workers=(4, 6) if ragged else (4,), seed=1,
                                params=dict(spread=4.0, p_dropout=0.1))
        pols = mod.PolicyGridSpec(
            names=("hinge", "poly", "constant"), seeds=(3, 4),
            policy_kwargs={"hinge": dict(a=0.5, b=4.0), "poly": dict(a=0.3)})
    else:
        topo = mod.TopologySpec(names=("uniform", "straggler"),
                                n_workers=(3, 4) if ragged else (4,))
        pols = mod.PolicyGridSpec(names=("adaptive1", "adaptive2", "fixed",
                                         "hinge"), seeds=(0, 1))
    return mod.ExperimentSpec(
        problem=mod.ProblemSpec(kind="logreg",
                                params=dict(n_samples=240, dim=30)),
        solver=mod.SolverSpec(name=solver, horizon="auto", m=5, eta=0.4,
                              buffer_size=3 if solver == "fedbuff" else 1),
        topology=topo, policies=pols,
        execution=mod.ExecutionSpec(backend=backend, engine=engine,
                                    record_every=4, **ex),
        n_events=32)


def _assert_matches_reference(ref, got, solver):
    """Port rows against reference rows (arrays or a reference Results)."""
    names = np.array([c.policy_name for c in got.cells])
    exact = np.isin(names, EXACT)
    for f in INTS[solver]:
        np.testing.assert_array_equal(getattr(got.raw, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    g_r, g_p = np.asarray(ref.gammas), got.gammas.numpy()
    np.testing.assert_array_equal(g_p[exact], g_r[exact])
    assert np.all(np.abs(g_p - g_r)[~exact] <= GAMMA_ULPS
                  * np.finfo(np.float32).eps * np.abs(g_r)[~exact])
    o_r, o_p = np.asarray(ref.objective), got.objective.numpy()
    assert np.all(np.abs(o_p - o_r) <= OBJ_REL * np.abs(o_r[:, :1]))


class _Rows:
    """A reference ``Results``' rows as plain arrays (fed ``versions``
    lives in ``extras``)."""

    def __init__(self, res):
        self.taus, self.clipped = res.taus, res.clipped
        self.gammas, self.objective = res.gammas, res.objective
        for f in ("blocks", "versions"):
            if f in res.extras:
                setattr(self, f, res.extras[f])


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("solver", ["piag", "bcd", "fedasync", "fedbuff"])
def test_sharded_rows_match_reference(solver, engine):
    """The port's sharded rows on (1,), (2,) and (4,) meshes against the
    reference's batched rows and its sharded rows on its one-device mesh,
    and against the port's batched rows (bitwise in the gammas)."""
    ref_b = _Rows(japi.run(_spec(japi, solver, "batched", engine)))
    ref_s = _Rows(japi.run(_spec(japi, solver, "sharded", engine)))
    port_b = tapi.run(_spec(tapi, solver, "batched", engine, device="cpu"))
    for name in ("(1,)", "(2,)", "(4,)"):
        got = tapi.run(_spec(tapi, solver, "sharded", engine, device="cpu",
                             mesh=MESHES[name]()))
        assert got.labels() == port_b.labels()
        _assert_matches_reference(ref_b, got, solver)
        _assert_matches_reference(ref_s, got, solver)
        for f in INTS[solver]:
            assert torch.equal(getattr(got.raw, f), getattr(port_b.raw, f))
        _gammas_equal(port_b, got)
        assert _obj_close(port_b.raw, got.raw)


_FORCED = r"""
import json, sys
import numpy as np
sys.path.insert(0, {test_dir!r})
from repro import api as japi
from test_torch_shard import _spec
import jax
assert len(jax.devices()) == 4, jax.devices()
out = {{}}
for solver in ("piag", "fedasync"):
    for shape in ((4,), (2, 2)):
        res = japi.run(_spec(japi, solver, "sharded", "scan", ragged=False,
                             mesh_shape=shape))
        rows = {{"taus": res.taus, "clipped": res.clipped,
                 "gammas": res.gammas, "objective": res.objective}}
        if "versions" in res.extras:
            rows["versions"] = res.extras["versions"]
        out[f"{{solver}}{{shape}}"] = {{k: np.asarray(v).tolist()
                                       for k, v in rows.items()}}
print(json.dumps(out))
"""


def test_sharded_rows_match_reference_on_four_forced_devices():
    """The reference on 4 forced host devices (a subprocess) against the
    port on the same (4,) and (2, 2) meshes, PIAG and FedAsync."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", _FORCED.format(test_dir=str(ROOT / "tests"))],
        capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for solver in ("piag", "fedasync"):
        for shape in ((4,), (2, 2)):
            mesh = cell_mesh(cpus(4)) if shape == (4,) \
                else grid_mesh((2, 2), cpus(4))
            got = tapi.run(_spec(tapi, solver, "sharded", "scan",
                                 ragged=False, device="cpu", mesh=mesh))
            rows = type("Rows", (), {k: np.asarray(v) for k, v in
                                     ref[f"{solver}{shape}"].items()})
            _assert_matches_reference(rows, got, solver)


# ------------------------------------------------ through api.run ----

@pytest.mark.parametrize("solver", ["piag", "bcd", "fedasync", "fedbuff"])
def test_sharded_telemetry_on_and_off(solver):
    """Telemetry on changes no row; the record carries the accumulator's
    histogram, the mesh's devices and shape, and one ``sharded_dispatch``
    span per bucket with the reference's fields."""
    mesh = grid_mesh((2, 2), cpus(4))
    off = tapi.run(_spec(tapi, solver, "sharded", "fused", device="cpu",
                         mesh=mesh))
    drain_timings()
    on = tapi.run(_spec(tapi, solver, "sharded", "fused", device="cpu",
                        mesh=mesh, telemetry=True))
    for f in off.raw._fields:
        if isinstance(getattr(off.raw, f), torch.Tensor):
            assert torch.equal(getattr(off.raw, f), getattr(on.raw, f)), f
    rec = on.telemetry
    assert rec.hist_source == "accumulator" and rec.backend == "sharded"
    assert rec.devices == 4 and rec.mesh_shape == [2, 2]
    spans = [ev for ev in rec.timings if ev["name"] == "sharded_dispatch"]
    assert len(spans) == len(on.grid.buckets())
    assert {(ev["devices"], ev["data_shards"]) for ev in spans} == {(4, 2)}
    assert sum(ev["cells"] for ev in spans) == len(on)


@pytest.mark.parametrize("solver", ["piag", "bcd", "fedasync", "fedbuff"])
def test_sharded_chaos_faults_match_batched(solver):
    """Under the chaos preset (scan engine) the sharded rows equal the
    batched rows: integer leaves, fault counters and gammas exact."""
    chaos = parse_faults("chaos")
    base = _spec(tapi, solver, "batched", "scan", device="cpu").replace(
        faults=chaos)
    batched = tapi.run(base)
    sharded = tapi.run(base.replace(execution=dataclasses.replace(
        base.execution, backend="sharded", mesh=cell_mesh(cpus(2)))))
    for f in INTS[solver]:
        assert torch.equal(getattr(batched.raw, f), getattr(sharded.raw, f))
    _gammas_equal(batched, sharded)
    for a, b in zip(tree_leaves(batched.raw.faults),
                    tree_leaves(sharded.raw.faults)):
        assert torch.equal(a, b)
    assert sharded.telemetry.faults == batched.telemetry.faults
    assert sum(sharded.telemetry.faults.values()) > 0
    assert _obj_close(batched.raw, sharded.raw)


@pytest.mark.parametrize("solver", ["piag", "fedasync"])
def test_sharded_lasso_rows_equal_batched(solver):
    """A problem without a closed-form worker gradient (lasso): each data
    device differentiates ``worker_loss`` on its sample slice by
    autograd; integer leaves and gammas equal the batched rows on (2,)
    and (2, 2)."""
    base = _spec(tapi, solver, "batched", "fused", device="cpu").replace(
        problem=tapi.ProblemSpec(kind="lasso",
                                 params=dict(n_samples=240, dim=30)))
    batched = tapi.run(base)
    for name in ("(2,)", "(2, 2)"):
        sharded = tapi.run(base.replace(execution=dataclasses.replace(
            base.execution, backend="sharded", mesh=MESHES[name]())))
        for f in INTS[solver]:
            assert torch.equal(getattr(batched.raw, f),
                               getattr(sharded.raw, f)), (name, f)
        _gammas_equal(batched, sharded)
        assert _obj_close(batched.raw, sharded.raw)


def test_sharded_without_a_card_raises():
    """``device=None`` means the CUDA cards: a sharded spec without one
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.run(_spec(tapi, "piag", "sharded", "fused"))


# ------------------------------------------------------ multi-host ----

_HOST = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import api as tapi
rank = int(sys.argv[1])
spec = tapi.ExperimentSpec(  # _spec(tapi, "piag", "sharded", "fused", ...)
    problem=tapi.ProblemSpec(kind="logreg",
                             params=dict(n_samples=240, dim=30)),
    solver=tapi.SolverSpec(name="piag", horizon="auto", m=5, eta=0.4),
    topology=tapi.TopologySpec(names=("uniform", "straggler"),
                               n_workers=(3, 4)),
    policies=tapi.PolicyGridSpec(names=("adaptive1", "adaptive2", "fixed",
                                        "hinge"), seeds=(0, 1)),
    execution=tapi.ExecutionSpec(backend="sharded", engine="fused",
                                 record_every=4, device="cpu",
                                 coordinator="127.0.0.1:{port}",
                                 num_processes=2, process_id=rank),
    n_events=32)
res = tapi.run(spec)
assert res.telemetry.devices == 2, res.telemetry.devices
np.savez(sys.argv[2], taus=res.taus.numpy(), gammas=res.gammas.numpy(),
         objective=res.objective.numpy(), clipped=res.clipped.numpy())
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            return int(s.getsockname()[1])
    except OSError as e:
        pytest.skip(f"loopback sockets are refused here: {e}")


def test_two_gloo_processes_give_the_single_process_rows():
    """Two processes on the CPU, gloo over 127.0.0.1: each runs the mesh
    row its CPU owns and the rows are all-gathered in cell order; both
    get the single-process batched rows (integer leaves and gammas
    exact).  The processes have 60 s."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    code = _HOST.format(port=port)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                                   outs[r]], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            results = [p.communicate(timeout=60) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (_, err) in zip(procs, results):
            assert p.returncode == 0, err[-3000:]
        rows = [dict(np.load(o)) for o in outs]
    want = tapi.run(_spec(tapi, "piag", "batched", "fused", device="cpu"))
    for got in rows:
        for f in ("taus", "clipped", "gammas"):
            np.testing.assert_array_equal(got[f], getattr(want, f).numpy())
        env_ = OBJ_REL * np.abs(want.objective.numpy()[:, :1])
        assert np.all(np.abs(got["objective"] - want.objective.numpy())
                      <= env_)
