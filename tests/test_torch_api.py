"""The slice end to end: ``repro_torch.api.run`` against ``repro.api.run``,
plus the port's hygiene (no JAX, no reference imports, no CPU fallback).

One small spec goes through both packages with backends solo and batched
and engines scan and fused (ragged worker counts in the batched grid).
Exact: worker ids, taus (= tau_max), clipped and t_wall.  Bitwise: gammas
of the fixed / naive / adaptive1 / adaptive2 families, which do not depend
on the iterate.  Hinge / poly gammas within GAMMA_ULPS ulps; the objective
within OBJ_REL of its starting value.
"""
import ast
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analysis as janalysis
from repro import api as japi
from repro.configs import paper_logreg as jcfg
from repro.core.engine import trace_scan as j_trace_scan
from repro_torch import analysis as tanalysis
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.configs import paper_logreg as tcfg
from repro_torch.core.engine import trace_scan
from repro_torch.core.piag import run_piag_logreg
from repro_torch.core.problems import make_logreg
from repro_torch.core.prox import L1
from repro_torch.core.stepsize import Adaptive1

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
GAMMA_ULPS = 4
OBJ_REL = 1e-5
EXACT = ("adaptive1", "adaptive2", "fixed", "naive")


def _spec(mod, backend, engine, **ex):
    if backend == "solo":
        topo = mod.TopologySpec(names=("hetero2",), n_workers=(4,))
        pols = mod.PolicyGridSpec(names=("adaptive1", "adaptive2", "fixed",
                                         "hinge"), seeds=(0,))
    else:
        topo = mod.TopologySpec(names=("uniform", "straggler"),
                                n_workers=(3, 4))
        pols = mod.PolicyGridSpec(names=("adaptive1", "adaptive2", "fixed",
                                         "naive", "hinge", "poly"),
                                  seeds=(0, 1))
    return mod.ExperimentSpec(
        problem=mod.ProblemSpec(kind="logreg",
                                params=dict(n_samples=240, dim=40)),
        solver=mod.SolverSpec(name="piag", horizon="auto"),
        topology=topo, policies=pols,
        execution=mod.ExecutionSpec(backend=backend, engine=engine,
                                    record_every=4, **ex),
        n_events=64)


def _port(backend, engine):
    return tapi.run(_spec(tapi, backend, engine, device="cpu"))


def _assert_matches(ref, got):
    assert got.labels() == ref.labels()
    assert got.horizon == ref.horizon and got.tau_bar == ref.tau_bar
    np.testing.assert_array_equal(got.taus.numpy(), np.asarray(ref.taus))
    np.testing.assert_array_equal(got.clipped.numpy(), np.asarray(ref.clipped))
    np.testing.assert_array_equal(got.virtual_time(),
                                  np.asarray(ref.virtual_time(), np.float32))
    names = np.array([c.policy_name for c in ref.cells])
    exact = np.isin(names, EXACT)
    g_r, g_p = np.asarray(ref.gammas), got.gammas.numpy()
    np.testing.assert_array_equal(g_p[exact], g_r[exact])
    assert np.all(np.abs(g_p - g_r)[~exact] <= GAMMA_ULPS
                  * np.finfo(np.float32).eps * np.abs(g_r)[~exact])
    o_r, o_p = np.asarray(ref.objective), got.objective.numpy()
    assert np.all(np.abs(o_p - o_r) <= OBJ_REL * np.abs(o_r[:, :1]))


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("backend", ["solo", "batched"])
def test_api_run_matches_reference(backend, engine):
    ref = japi.run(_spec(japi, backend, engine))
    _assert_matches(ref, _port(backend, engine))


def test_worker_ids_of_every_bucket_match_reference():
    """The traces behind the batched rows: worker, read_at, tau, tau_max
    and t_wall of every (ragged) bucket, bitwise."""
    grid = tapi.resolve(_spec(tapi, "batched", "fused", device="cpu")).grid
    for b in grid.buckets():
        T = b.grid.service_times(b.width)
        act = b.grid.active_masks(b.width)
        ref = jax.vmap(j_trace_scan)(jnp.asarray(T), jnp.asarray(act))
        got = trace_scan(torch.from_numpy(T), torch.from_numpy(act))
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_port_batched_rows_equal_port_solo_rows():
    """Integer leaves exact; the fixed / naive / adaptive2 gammas bitwise.
    (adaptive1's push is an FMA in a solo run and a plain add in a sweep,
    as in the reference, so its later window sums may differ by an ulp.)"""
    spec = _spec(tapi, "batched", "fused", device="cpu")
    batched = tapi.run(spec)
    solo = tapi.run(spec.replace(execution=dataclasses.replace(
        spec.execution, backend="solo")))
    for f in ("taus", "clipped"):
        assert torch.equal(getattr(batched, f), getattr(solo, f))
    names = [c.policy_name for c in batched.cells]
    rows = [i for i, n in enumerate(names) if n in ("fixed", "naive",
                                                    "adaptive2")]
    assert torch.equal(batched.gammas[rows], solo.gammas[rows])


def test_results_views_and_analysis_match_reference():
    ref = japi.run(_spec(japi, "batched", "scan"))
    got = _port("batched", "scan")
    rows_r, rows_p = ref.to_rows(), got.to_rows()
    for a, b in zip(rows_p, rows_r):
        for key in ("label", "policy", "seed", "topology", "n_workers",
                    "max_tau", "clipped"):
            assert a[key] == b[key]
        assert abs(a["final_objective"] - b["final_objective"]) <= \
            OBJ_REL * abs(b["final_objective"])
    for name, s in got.per_policy().items():
        r = ref.per_policy()[name]
        assert (s.n_cells, s.clipped_cells, s.clipped_events) == \
            (r.n_cells, r.clipped_cells, r.clipped_events)
    assert got.clipped_summary() == ref.clipped_summary()
    np.testing.assert_array_equal(got.sample_events(), ref.sample_events())


def test_analysis_functions_match_reference():
    rng = np.random.default_rng(0)
    obj = np.sort(rng.random((6, 40)), axis=1)[:, ::-1].copy()
    for fn, args in (("time_to_tolerance", (obj, 0.3)),
                     ("clipped_summary", (rng.integers(0, 3, 6),))):
        r = getattr(janalysis, fn)(*args)
        p = getattr(tanalysis, fn)(*args)
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))
    assert tanalysis.time_to_tolerance(torch.from_numpy(obj), 0.3,
                                       record_every=4).tolist() == \
        janalysis.time_to_tolerance(obj, 0.3, record_every=4).tolist()
    ett = {"fixed": 300, "adaptive1": 120, "hinge": -1}
    assert tanalysis.best_fixed_vs_adaptive(ett) == \
        janalysis.best_fixed_vs_adaptive(ett)


def test_spec_family_mirrors_reference_with_port_defaults():
    for name in ("ProblemSpec", "SolverSpec", "TopologySpec", "DelaySpec",
                 "PolicyGridSpec", "ExecutionSpec", "ExperimentSpec"):
        ref = [f.name for f in dataclasses.fields(getattr(japi, name))]
        got = [f.name for f in dataclasses.fields(getattr(tapi, name))]
        assert got == ref + (["device"] if name == "ExecutionSpec" else [])
    assert tapi.ExecutionSpec().engine == "fused"
    assert tapi.ExecutionSpec().device is None
    with pytest.raises(ValueError, match="engine"):
        tapi.ExecutionSpec(engine="xla")


def test_horizon_validation_matches_reference():
    with pytest.raises(ValueError, match="cannot represent"):
        tapi.ExperimentSpec(solver=tapi.SolverSpec(horizon=8),
                            delay=tapi.DelaySpec(expected_max_delay=8))
    spec = _spec(tapi, "batched", "fused", device="cpu")
    tight = spec.replace(solver=tapi.SolverSpec(horizon=4))
    with pytest.raises(ValueError, match="cannot represent"):
        tapi.resolve(tight)
    with pytest.raises(ValueError, match="cannot represent"):
        japi.resolve(_spec(japi, "batched", "fused").replace(
            solver=japi.SolverSpec(horizon=4)))


@pytest.mark.parametrize("change, item", [
    (dict(solver=tapi.SolverSpec(name="bcd")), 5),
    (dict(solver=tapi.SolverSpec(name="fedasync")), 8),
    (dict(execution=tapi.ExecutionSpec(backend="sharded", device="cpu")), 12),
    (dict(execution=tapi.ExecutionSpec(telemetry=True, device="cpu")), 9),
    (dict(faults=object(), execution=tapi.ExecutionSpec(engine="scan",
                                                        device="cpu")), 10),
])
def test_unported_paths_raise_naming_their_roadmap_item(change, item):
    spec = _spec(tapi, "batched", "fused", device="cpu").replace(**change)
    with pytest.raises(NotImplementedError, match=f"queue A item {item}"):
        tapi.run(spec)


def test_resume_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        tapi.run(_spec(tapi, "batched", "fused", device="cpu"),
                 resume="somewhere")


def test_run_without_device_needs_a_card():
    """``device=None`` means the CUDA card; without one, api.run raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule is moot")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tapi.run(_spec(tapi, "batched", "fused"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_logreg(40, 5)


def test_interop_feeds_reference_state_to_the_port():
    from repro.core.problems import make_logreg as j_make
    from repro.core.engine import simulate_parameter_server as j_sim
    jp = j_make(200, 30, n_workers=4, seed=5)
    tp = interop.logreg_problem(np.asarray(jp.A), np.asarray(jp.b), jp.lam1,
                                jp.lam2, jp.L, jp.Lhat, jp.n_workers,
                                device="cpu")
    own = make_logreg(200, 30, n_workers=4, seed=5, device="cpu")
    assert torch.equal(tp.A, own.A) and torch.equal(tp.b, own.b)
    tr = j_sim(4, 100, seed=1)
    tr_p = interop.event_trace(tr.worker, tr.tau, tr.t_wall,
                               tau_max=tr.tau_max, read_at=tr.read_at)
    for a, b in zip(tr_p, tr):
        np.testing.assert_array_equal(a, b)
    x0 = interop.iterate(np.zeros(30, np.float32), device="cpu")
    assert x0.dtype == torch.float32 and x0.shape == (30,)
    a = run_piag_logreg(tp, tr_p, Adaptive1(gamma_prime=0.5), L1(lam=tp.lam1))
    b = run_piag_logreg(own, tr, Adaptive1(gamma_prime=0.5), L1(lam=tp.lam1))
    assert torch.equal(a.objective, b.objective)


def test_paper_workloads_match_reference():
    for name in ("RCV1_LIKE", "MNIST_LIKE"):
        r, p = getattr(jcfg, name), getattr(tcfg, name)
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
    small = dataclasses.replace(tcfg.MNIST_LIKE, n_samples=400)
    ref = dataclasses.replace(jcfg.MNIST_LIKE, n_samples=400).build(seed=1)
    got = small.build(seed=1, device="cpu")
    np.testing.assert_array_equal(got.A.numpy(), np.asarray(ref.A))


# ------------------------------------------------------------- hygiene ----

def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_import_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = "
            "None; import repro_torch.api, repro_torch.interop, "
            "repro_torch.analysis, repro_torch.configs.paper_logreg; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_refuses_to_run_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    lone = subprocess.run([sys.executable, str(alone)], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert lone.returncode != 0 and '"ok"' not in lone.stdout
