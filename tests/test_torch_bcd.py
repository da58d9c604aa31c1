"""Async-BCD in the port (``repro_torch.core.bcd``, ``sweep_bcd``,
``api.run(solver="bcd")``) against the reference ``repro``.

The same numpy inputs go through both packages.  Exact: the shared-memory
trace, the block draws, worker ids, taus, blocks and clipped counts, and
``virtual_time``.  Bitwise: the gammas of the fixed / naive / adaptive1 /
adaptive2 / Sun-Deng / Davis policies, which depend only on the integer
delays.  The objective within OBJ_REL of its start: XLA:CPU contracts
``xb[j] - gamma*gj`` into an FMA in the reference's scan, the port's scan
does not (ROADMAP queue C, "FMA contraction").  Port scan vs port fused is
bitwise on the CPU (both run the plain version there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import bcd as jbcd
from repro.core import engine as jengine
from repro.core import problems as jproblems
from repro.core import stepsize as jstepsize
from repro.core.prox import L1 as JL1
from repro.core.stepsize import (Adaptive1 as JAdaptive1,
                                 DavisFixed as JDavisFixed,
                                 SunDengFixed as JSunDengFixed)
from repro.sweep.policies import ParamPolicy as JParamPolicy
from repro.sweep.policies import stack_params as j_stack_params
from repro_torch import api as tapi
from repro_torch.core import bcd, engine, problems
from repro_torch.core.prox import L1
from repro_torch.core.stepsize import (Adaptive1, Adaptive2, DavisFixed,
                                       FixedStepSize, NaiveAdaptive,
                                       SunDengFixed)
from repro_torch.sweep.policies import ParamPolicy, stack_params

OBJ_REL = 1e-5
EXACT = ("adaptive1", "adaptive2", "fixed", "naive", "sun", "davis")


# ---------------------------------------------------------- traces ----

@pytest.mark.parametrize("n, K, seed, given", [(4, 300, 0, False),
                                               (7, 500, 3, False),
                                               (5, 400, 2, True)])
def test_simulate_shared_memory_matches_reference(n, K, seed, given):
    T = None
    if given:
        T = engine.sample_service_times(
            engine.heterogeneous_workers(n, seed=seed), K + 1, seed=seed)
    ref = jengine.simulate_shared_memory(n, K, 10, seed=seed, service_times=T)
    got = engine.simulate_shared_memory(n, K, 10, seed=seed, service_times=T)
    for a, b, f in zip(got, ref, got._fields):
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(got.tau_max, got.tau)


@pytest.mark.parametrize("n, seed", [(4, 0), (6, 5)])
def test_shared_memory_device_trace_matches_heapq_reference(n, seed):
    """``generate_trace(kind="shared_memory")`` (the port's event race)
    and ``trace_scan`` give the reference's shared-memory delays."""
    K = 300
    T = engine.sample_service_times(engine.heterogeneous_workers(n, seed=1),
                                    K + 1, seed=seed)
    ref = jengine.simulate_shared_memory(n, K, 5, seed=seed, service_times=T)
    got = engine.generate_trace(T, kind="shared_memory", device="cpu")
    for f in ("worker", "read_at", "tau", "tau_max"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.t_wall, ref.t_wall.astype(np.float32))
    tr = engine.trace_scan(torch.from_numpy(T))
    np.testing.assert_array_equal(tr.tau.numpy(), ref.tau)


@pytest.mark.parametrize("m, K, seed", [(20, 2500, 0), (7, 64, 3)])
def test_sample_blocks_matches_reference(m, K, seed):
    got = bcd.sample_blocks(m, K, seed=seed)
    ref = jbcd.sample_blocks(m, K, seed=seed)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("m", [1, 7, 20])
def test_block_smoothness_matches_reference(m):
    jp = jproblems.make_logreg(300, 40, n_workers=4, sparse_like=False,
                               seed=1)
    tp = problems.make_logreg(300, 40, n_workers=4, sparse_like=False,
                              seed=1, device="cpu")
    assert tp.block_smoothness(m) == jp.block_smoothness(m)
    lasso = problems.make_lasso(200, 30, n_workers=4, seed=2, device="cpu")
    A = lasso.A.numpy()
    db = -(-30 // m)
    want = max(problems.power_iteration_sq(A[:, j * db:(j + 1) * db], seed=j)
               for j in range(m) if A[:, j * db:(j + 1) * db].size) / 200
    assert lasso.block_smoothness(m) == want


# ------------------------------------------------------------ scans ----

def _events(B, n, K, m, seed0=0):
    """(worker, tau, block) (B, K) int32 numpy columns of B cells."""
    cols = []
    for b in range(B):
        T = engine.sample_service_times(
            engine.heterogeneous_workers(n, seed=b), K + 1, seed=seed0 + b)
        tr = jengine.simulate_shared_memory(n, K, m, seed=seed0 + b,
                                            service_times=T)
        cols.append((tr.worker, tr.tau, jbcd.sample_blocks(m, K, seed=b)))
    return tuple(np.stack(c).astype(np.int32) for c in zip(*cols))


def _policies(gp, tau_bound):
    return [("adaptive1", Adaptive1(gamma_prime=gp)),
            ("adaptive2", Adaptive2(gamma_prime=gp)),
            ("fixed", FixedStepSize(gamma_prime=gp, tau_bound=tau_bound)),
            ("naive", NaiveAdaptive(gamma_prime=gp)),
            ("sun", SunDengFixed(gamma_prime=gp, tau_bound=tau_bound)),
            ("davis", DavisFixed(gamma_prime=gp, tau_bound=tau_bound,
                                 ratio=0.5))]


def _reference_policy(p):
    """The reference's policy of the same class and fields."""
    return getattr(jstepsize, type(p).__name__)(**dataclasses.asdict(p))


@pytest.fixture(scope="module")
def small():
    jp = jproblems.make_logreg(240, 30, n_workers=4, sparse_like=False,
                               seed=0)
    tp = problems.make_logreg(240, 30, n_workers=4, sparse_like=False,
                              seed=0, device="cpu")
    return jp, tp


@pytest.mark.parametrize("record_every", [1, 4])
@pytest.mark.parametrize("engine_", ["scan", "fused"])
@pytest.mark.parametrize("B, m", [(1, 7), (6, 7), (6, 5)])
def test_bcd_scan_matches_reference_jitted_scan(small, B, m, engine_,
                                                record_every):
    """The port's ``bcd_scan`` over B cells against the reference's jitted
    scan (``vmap`` over the same cells), one policy per cell: m 7 on d 30
    gives a padded tail (db 5, no float4 rows), m 5 no padding (db 6)."""
    jp, tp = small
    n, K, H = 4, 64, 64
    worker, tau, blocks = _events(B, n, K, m)
    gp = 0.99 / jp.block_smoothness(m)
    pols = _policies(gp, int(tau.max()))[:B]
    names = [p for p, _ in pols]
    x0j = jnp.zeros((30,), jnp.float32)
    jpp = j_stack_params([_reference_policy(p) for _, p in pols])

    def cell(w, t, j, pp):
        return jbcd.bcd_scan(jp.grad_f, jp.P, x0j, m, n, (w, t, j),
                             JParamPolicy(pp), JL1(lam=jp.lam1), horizon=H,
                             record_every=record_every, engine=engine_)

    ref = jax.jit(jax.vmap(cell))(jnp.asarray(worker), jnp.asarray(tau),
                                  jnp.asarray(blocks), jpp)
    got = bcd.bcd_scan(tp.grad_f, tp.P, torch.zeros(30), m, n,
                       tuple(map(torch.from_numpy, (worker, tau, blocks))),
                       ParamPolicy(stack_params([p for _, p in pols], "cpu")),
                       L1(lam=tp.lam1), horizon=H, record_every=record_every,
                       engine=engine_)
    for f in ("taus", "blocks", "clipped"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    exact = np.isin(names, EXACT)
    np.testing.assert_array_equal(got.gammas.numpy()[exact],
                                  np.asarray(ref.gammas)[exact])
    o_r, o_p = np.asarray(ref.objective), got.objective.numpy()
    assert np.all(np.abs(o_p - o_r) <= OBJ_REL * np.abs(o_r[:, :1]))
    assert got.x.shape == (B, 30)
    assert np.all(np.abs(got.x.numpy() - np.asarray(ref.x)) <= 1e-5)
    assert got.telemetry is None and got.faults is None


def test_bcd_scan_engines_are_bitwise_on_the_cpu(small):
    _, tp = small
    worker, tau, blocks = _events(6, 4, 64, 7)
    pols = [p for _, p in _policies(0.99 / tp.block_smoothness(7), 30)]
    ev = tuple(map(torch.from_numpy, (worker, tau, blocks)))
    runs = [bcd.bcd_scan(tp.grad_f, tp.P, torch.zeros(30), 7, 4, ev,
                         ParamPolicy(stack_params(pols, "cpu")),
                         L1(lam=tp.lam1), horizon=64, engine=e)
            for e in ("scan", "fused")]
    for a, b, f in zip(*runs, bcd.BCDResult._fields):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f


def test_run_async_bcd_solo_matches_reference(small):
    jp, tp = small
    tr = jengine.simulate_shared_memory(4, 200, 7, seed=2)
    blocks = jbcd.sample_blocks(7, 200, seed=2)
    gp = 0.99 / jp.block_smoothness(7)
    ref = jbcd.run_async_bcd(jp.grad_f, jp.P, jnp.zeros(30, jnp.float32), 7,
                             tr, blocks, JAdaptive1(gamma_prime=gp),
                             JL1(lam=jp.lam1), horizon="auto")
    got = bcd.run_async_bcd(tp.grad_f, tp.P, torch.zeros(30), 7, tr, blocks,
                            Adaptive1(gamma_prime=gp), L1(lam=tp.lam1),
                            horizon="auto")
    np.testing.assert_array_equal(got.gammas.numpy(), np.asarray(ref.gammas))
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(ref.blocks))
    assert int(got.clipped) == int(ref.clipped) == 0
    o_r = np.asarray(ref.objective)
    assert np.all(np.abs(got.objective.numpy() - o_r) <= OBJ_REL * o_r[0])
    with pytest.raises(TypeError, match="faults must be a FaultSpec"):
        bcd.run_async_bcd(tp.grad_f, tp.P, torch.zeros(30), 7, tr, blocks,
                          Adaptive1(gamma_prime=gp), L1(lam=tp.lam1),
                          faults=object())


# -------------------------------------------------------------- api ----

def _spec(mod, backend, engine_, kind="logreg", **ex):
    if backend == "solo":
        topo = mod.TopologySpec(names=("hetero2",), n_workers=(4,))
        pols = mod.PolicyGridSpec(names=("adaptive1", "adaptive2", "fixed"),
                                  seeds=(0,))
    else:
        topo = mod.TopologySpec(names=("uniform", "straggler"),
                                n_workers=(3, 4))
        pols = mod.PolicyGridSpec(names=("adaptive1", "adaptive2", "fixed",
                                         "naive"), seeds=(0, 1))
    params = dict(n_samples=240, dim=40) if kind == "logreg" else \
        dict(n_samples=240, dim=40, seed=3)
    if kind == "lasso":  # the reference's lasso has no block_smoothness
        pols = dataclasses.replace(pols, gamma_prime=0.5)
    return mod.ExperimentSpec(
        problem=mod.ProblemSpec(kind=kind, params=params),
        solver=mod.SolverSpec(name="bcd", horizon="auto", m=7),
        topology=topo, policies=pols,
        execution=mod.ExecutionSpec(backend=backend, engine=engine_,
                                    record_every=4, **ex),
        n_events=64)


def _assert_matches(ref, got):
    assert got.labels() == ref.labels()
    assert got.horizon == ref.horizon and got.tau_bar == ref.tau_bar
    assert sorted(got.extras) == sorted(ref.extras) == ["blocks", "faults"]
    for f in ("taus", "clipped"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(got.extras["blocks"].numpy(),
                                  np.asarray(ref.extras["blocks"]))
    np.testing.assert_array_equal(got.virtual_time(),
                                  np.asarray(ref.virtual_time(), np.float32))
    np.testing.assert_array_equal(got.gammas.numpy(), np.asarray(ref.gammas))
    o_r, o_p = np.asarray(ref.objective), got.objective.numpy()
    assert np.all(np.abs(o_p - o_r) <= OBJ_REL * np.abs(o_r[:, :1]))
    assert got.telemetry.fingerprint == ref.telemetry.fingerprint


@pytest.mark.parametrize("engine_", ["scan", "fused"])
@pytest.mark.parametrize("backend", ["solo", "batched"])
def test_api_run_bcd_matches_reference(backend, engine_):
    ref = japi.run(_spec(japi, backend, engine_))
    _assert_matches(ref, tapi.run(_spec(tapi, backend, engine_,
                                        device="cpu")))


def test_api_run_bcd_lasso_matches_reference():
    ref = japi.run(_spec(japi, "batched", "fused", kind="lasso"))
    _assert_matches(ref, tapi.run(_spec(tapi, "batched", "fused",
                                        kind="lasso", device="cpu")))


def test_bcd_auto_gamma_prime_is_the_block_rule():
    spec = _spec(tapi, "batched", "fused", device="cpu")
    r = tapi.resolve(spec)
    gp = 0.99 / r.problem.block_smoothness(7)
    assert all(float(c.policy.gamma_prime) == gp for c in r.grid.cells)


def test_bcd_batched_rows_equal_solo_rows():
    """Block draws replay per cell, so a batched row is its solo run:
    integer leaves exact, the fixed / naive / adaptive2 gammas bitwise
    (adaptive1's push is an FMA only in a solo run, as in the reference)."""
    spec = _spec(tapi, "batched", "fused", device="cpu")
    batched = tapi.run(spec)
    solo = tapi.run(spec.replace(execution=dataclasses.replace(
        spec.execution, backend="solo")))
    for f in ("taus", "clipped"):
        assert torch.equal(getattr(batched, f), getattr(solo, f))
    assert torch.equal(batched.extras["blocks"], solo.extras["blocks"])
    rows = [i for i, c in enumerate(batched.cells)
            if c.policy_name in ("fixed", "naive", "adaptive2")]
    assert torch.equal(batched.gammas[rows], solo.gammas[rows])


def test_fig4_comparison_matches_reference():
    """Paper Fig. 4 at a small size: adaptive1 against the Sun-Deng and
    Davis fixed step-sizes on one shared-memory trace.  The port's final
    objectives order the policies as the reference's do."""
    jp = jproblems.make_logreg(600, 60, n_workers=8, sparse_like=False,
                               seed=0)
    tp = problems.make_logreg(600, 60, n_workers=8, sparse_like=False,
                              seed=0, device="cpu")
    m = 10
    tr = jengine.simulate_shared_memory(8, 800, m, seed=4)
    tb = tr.max_delay()
    lh = jp.block_smoothness(m)
    gp = 0.99 / lh
    ratio = float(2.0 * jp.L / (lh * np.sqrt(m)))
    final = {}
    for name, jpol, tpol in [
            ("adaptive1", JAdaptive1(gamma_prime=gp, alpha=0.9),
             Adaptive1(gamma_prime=gp, alpha=0.9)),
            ("sun", JSunDengFixed(gamma_prime=gp, tau_bound=tb),
             SunDengFixed(gamma_prime=gp, tau_bound=tb)),
            ("davis", JDavisFixed(gamma_prime=gp, tau_bound=tb, ratio=ratio),
             DavisFixed(gamma_prime=gp, tau_bound=tb, ratio=ratio))]:
        r = jbcd.run_bcd_logreg(jp, tr, jpol, JL1(lam=jp.lam1), m=m)
        g = bcd.run_bcd_logreg(tp, tr, tpol, L1(lam=tp.lam1), m=m)
        np.testing.assert_array_equal(g.gammas.numpy(), np.asarray(r.gammas))
        o_r = np.asarray(r.objective)
        assert np.all(np.abs(g.objective.numpy() - o_r) <= OBJ_REL * o_r[0])
        final[name] = (float(o_r[-1]), float(g.objective[-1]))
    for fixed in ("sun", "davis"):
        assert (final["adaptive1"][1] < final[fixed][1]) == \
            (final["adaptive1"][0] < final[fixed][0])
    assert final["adaptive1"][0] < min(final["sun"][0], final["davis"][0])
