"""repro_torch.core.problems / core.piag held against the reference.

Data is drawn by the same numpy code, so it is held bitwise.  PIAG runs
through both packages on the same trace: taus and clipped exact; gammas
bitwise for the fixed / naive / adaptive1 / adaptive2 families (they do
not depend on the iterate), hinge / poly within GAMMA_ULPS ulps; the
objective within OBJ_REL of its starting value (float32 products and sums
in another order, and the reference contracts x - gamma * g into an FMA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import piag as jpiag
from repro.core import problems as jprob
from repro.core import prox as jprox
from repro.core import stepsize as jss
from repro.core.engine import simulate_parameter_server as j_sim
from repro_torch.core import piag as tpiag
from repro_torch.core import problems as tprob
from repro_torch.core import prox as tprox
from repro_torch.core import stepsize as tss
from repro_torch.core.engine import simulate_parameter_server

GAMMA_ULPS = 4
OBJ_REL = 1e-5
GRAD_REL = 1e-5
CPU = "cpu"
POLICIES = ("adaptive1", "adaptive2", "fixed", "naive", "hinge", "poly")
EXACT = ("adaptive1", "adaptive2", "fixed", "naive")


@pytest.fixture(scope="module")
def problems():
    return (jprob.make_logreg(200, 30, n_workers=4, seed=0),
            tprob.make_logreg(200, 30, n_workers=4, seed=0, device=CPU))


@pytest.fixture(scope="module")
def trace():
    return j_sim(4, 300, seed=3)


def _policy(mod, name, gp, trace):
    kw = {"tau_bound": trace.max_delay()} if name == "fixed" else {}
    return mod.make_policy(name, gp, **kw)


@pytest.fixture(scope="module")
def reference_runs(problems, trace):
    jp, _ = problems
    gp = 0.99 / jp.L
    return {n: jpiag.run_piag_logreg(jp, trace, _policy(jss, n, gp, trace),
                                     jprox.L1(lam=jp.lam1))
            for n in POLICIES}


def _assert_rows(name, ref, got):
    np.testing.assert_array_equal(got.taus.numpy(), np.asarray(ref.taus))
    assert int(got.clipped) == int(ref.clipped)
    g_r, g_p = np.asarray(ref.gammas), got.gammas.numpy()
    if name in EXACT:
        np.testing.assert_array_equal(g_p, g_r)
    else:
        assert np.all(np.abs(g_p - g_r)
                      <= GAMMA_ULPS * np.finfo(np.float32).eps * np.abs(g_r))
    o_r, o_p = np.asarray(ref.objective), got.objective.numpy()
    assert np.max(np.abs(o_p - o_r)) <= OBJ_REL * abs(o_r[0])


@pytest.mark.parametrize("sparse_like", [True, False])
def test_make_logreg_data_bitwise(sparse_like):
    ref = jprob.make_logreg(300, 40, n_workers=5, sparse_like=sparse_like,
                            seed=2)
    got = tprob.make_logreg(300, 40, n_workers=5, sparse_like=sparse_like,
                            seed=2, device=CPU)
    np.testing.assert_array_equal(got.A.numpy(), np.asarray(ref.A))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(ref.b))
    assert (got.L, got.Lhat, got.lam1, got.lam2) == \
        (ref.L, ref.Lhat, ref.lam1, ref.lam2)


def test_make_lasso_data_bitwise():
    ref = jprob.make_lasso(200, 30, n_workers=4, seed=1)
    got = tprob.make_lasso(200, 30, n_workers=4, seed=1, device=CPU)
    np.testing.assert_array_equal(got.A.numpy(), np.asarray(ref.A))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(ref.y))
    assert got.L == ref.L
    X = np.random.default_rng(0).normal(size=(3, 30)).astype(np.float32)
    np.testing.assert_allclose(got.P(torch.from_numpy(X)).numpy(),
                               np.asarray(jax.vmap(ref.P)(jnp.asarray(X))),
                               rtol=GRAD_REL)


def test_objective_and_gradients_match_reference(problems):
    jp, tp = problems
    X = np.random.default_rng(1).normal(size=(5, 30)).astype(np.float32) * 0.3
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(tp.P(Xt).numpy(),
                               np.asarray(jax.vmap(jp.P)(jnp.asarray(X))),
                               rtol=GRAD_REL)
    np.testing.assert_allclose(tp.grad_f(Xt).numpy(),
                               np.asarray(jax.vmap(jp.grad_f)(jnp.asarray(X))),
                               rtol=GRAD_REL, atol=1e-7)
    w = np.array([0, 3, 1, 1, 2])
    Aw, bw = jp.worker_slices()
    ref = np.stack([np.asarray(jax.grad(jp.worker_loss)(
        jnp.asarray(X[i]), Aw[w[i]], bw[w[i]])) for i in range(5)])
    closed = tp.worker_grads()(Xt, torch.from_numpy(w))
    auto = tpiag.default_grad_fn(tp.worker_loss, tp.worker_slices())(
        Xt, torch.from_numpy(w))
    np.testing.assert_allclose(closed.numpy(), ref, rtol=GRAD_REL, atol=1e-7)
    np.testing.assert_allclose(auto.numpy(), ref, rtol=GRAD_REL, atol=1e-7)


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("name", POLICIES)
def test_run_piag_logreg_matches_reference(problems, trace, reference_runs,
                                           name, engine):
    _, tp = problems
    gp = 0.99 / tp.L
    got = tpiag.run_piag_logreg(tp, trace, _policy(tss, name, gp, trace),
                                tprox.L1(lam=tp.lam1), engine=engine)
    _assert_rows(name, reference_runs[name], got)


def test_generic_loss_path_matches_reference(problems, trace):
    """No objective and no grad_fn: the mean worker loss + R by autograd,
    as the reference's defaults."""
    jp, tp = problems
    gp = 0.99 / jp.L
    ref = jpiag.run_piag(lambda x, A, b: jp.worker_loss(x, A, b),
                         jnp.zeros(30), jp.worker_slices(), trace,
                         jss.Adaptive2(gamma_prime=gp), jprox.L1(lam=jp.lam1))
    got = tpiag.run_piag(tp.worker_loss, torch.zeros(30), tp.worker_slices(),
                         trace, tss.Adaptive2(gamma_prime=gp),
                         tprox.L1(lam=tp.lam1))
    _assert_rows("adaptive2", ref, got)


def test_record_every_keeps_rows_of_the_stride1_run(problems, trace):
    _, tp = problems
    pol = tss.Adaptive1(gamma_prime=0.99 / tp.L)
    Aw, bw = tp.worker_slices()
    x0 = torch.zeros(30)
    kw = dict(objective=tp.P, grad_fn=tp.worker_grads(), horizon="auto")
    full = tpiag.run_piag(tp.worker_loss, x0, (Aw, bw), trace, pol,
                          tprox.L1(lam=tp.lam1), **kw)
    dec = tpiag.run_piag(tp.worker_loss, x0, (Aw, bw), trace, pol,
                         tprox.L1(lam=tp.lam1), record_every=6, **kw)
    for f in ("objective", "gammas", "taus", "opt_residual"):
        np.testing.assert_array_equal(getattr(dec, f).numpy(),
                                      getattr(full, f).numpy()[5::6])
    np.testing.assert_array_equal(dec.x.numpy(), full.x.numpy())


def test_adaptive_lipschitz_runs_under_scan_and_is_refused_by_fused(
        problems, trace):
    jp, tp = problems
    ref = jpiag.run_piag_logreg(jp, trace, jss.AdaptiveLipschitz(
        gamma_prime=1.0), jprox.L1(lam=jp.lam1))
    got = tpiag.run_piag_logreg(tp, trace, tss.AdaptiveLipschitz(
        gamma_prime=1.0), tprox.L1(lam=tp.lam1), engine="scan")
    _assert_rows("adaptive1", ref, got)
    with pytest.raises(TypeError, match="AdaptiveLipschitz"):
        tpiag.run_piag_logreg(tp, trace, tss.AdaptiveLipschitz(
            gamma_prime=1.0), tprox.L1(lam=tp.lam1), engine="fused")


def test_piag_scan_rejects_unknown_engine(problems, trace):
    _, tp = problems
    with pytest.raises(ValueError, match="engine"):
        tpiag.run_piag_logreg(tp, trace, tss.Adaptive1(gamma_prime=0.1),
                              tprox.L1(), engine="xla")


def test_solve_centralized_matches_reference(problems):
    jp, tp = problems
    _, ref = jprob.solve_centralized(jp, jprox.L1(lam=jp.lam1), iters=300)
    _, got = tprob.solve_centralized(tp, tprox.L1(lam=tp.lam1), iters=300)
    assert abs(float(got[-1]) - float(ref[-1])) <= OBJ_REL * abs(float(ref[0]))


def test_paper_headline_piag_speedup_on_the_port():
    """The reference's headline (tests/test_system.py) on the port alone:
    adaptive1 reaches the fixed policy's final objective in < 60% of the
    events of the same trace."""
    prob = tprob.make_logreg(1200, 150, n_workers=8, seed=0, device=CPU)
    trace = simulate_parameter_server(8, 2500, seed=3)
    gp = 0.99 / prob.L
    prox = tprox.L1(lam=prob.lam1)
    res_a = tpiag.run_piag_logreg(prob, trace, tss.Adaptive1(gamma_prime=gp),
                                  prox)
    res_f = tpiag.run_piag_logreg(prob, trace, tss.FixedStepSize(
        gamma_prime=gp, tau_bound=trace.max_delay()), prox)
    target = float(res_f.objective[-1])
    it_a = int(np.argmax(res_a.objective.numpy() <= target))
    assert float(res_a.objective[-1]) <= target + 1e-9
    assert 0 < it_a < 0.6 * trace.n_events
