"""The port's delay models, ``Quadratic``, the theory instruments and
``run_piag_lipschitz`` against the reference (``repro.core.delay``,
``.problems``, ``.theory``, ``.piag``).

Delay traces, ``Quadratic``, ``check_principle``, ``verify_theorem1``,
``prop1_lower_bounds`` and the divergence threshold are numpy or exact
float32, and must be bitwise.  ``example1``'s gammas come from the port's
``policy.run``, bitwise the reference's; its iterates are float64 host
products of them, held within ``EX1_REL`` of each value.
``run_piag_lipschitz``: taus exact, L_est, gammas and objective within
``LIP_REL`` (the worker gradients are closed form in the port, autodiff in
the reference).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delay as jd
from repro.core import theory as jth
from repro.core import (Adaptive1 as JA1, Adaptive2 as JA2, L1 as JL1,
                        NaiveAdaptive as JNaive, Quadratic as JQuad,
                        make_logreg as jml, run_piag_lipschitz as jlip,
                        simulate_parameter_server as jsim)
from repro_torch.core import delay as td
from repro_torch.core import theory as tth
from repro_torch.core import (Adaptive1, Adaptive2, L1, NaiveAdaptive,
                              Quadratic, make_logreg, run_piag_lipschitz,
                              simulate_parameter_server)

EX1_REL = 1e-12   # example1's |x| per period (float64 products of equal gammas)
LIP_REL = 1e-5    # run_piag_lipschitz: L_est, gammas, objective
QUAD_SUM_ULPS = 2  # Quadratic.f past d = 1: float32 sums in another order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", sorted(jd.DELAY_MODELS))
@pytest.mark.parametrize("seed,tau", [(0, 7), (3, 40)])
def test_delay_models_bitwise(model, seed, tau):
    kw = {"period": 13} if model == "burst" else {}
    a = jd.make_delays(model, 500, tau, seed=seed, **kw)
    b = td.make_delays(model, 500, tau, seed=seed, **kw)
    assert b.dtype == a.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    assert sorted(td.DELAY_MODELS) == sorted(jd.DELAY_MODELS)


def test_delay_tracker_matches_reference():
    j, t = jd.DelayTracker(), td.DelayTracker()
    out_j, out_t = [], []
    for tr, out in ((j, out_j), (t, out_t)):
        for w in range(3):
            tr.stamp(w, 0)
        for k in range(12):
            tr.advance()
            w = k % 3
            out.append((tr.delay(w), tr.max_delay(), dict(tr.delays())))
            tr.stamp(w)
        with pytest.raises(KeyError, match="no stamp"):
            tr.delay(7)
    assert out_j == out_t
    assert (j.k, j.max_seen, j.stamps) == (t.k, t.max_seen, t.stamps)


def test_quadratic_bitwise():
    """Example 1's problem (d = 1) bitwise: f, grad_f and L.  Past d = 1,
    grad_f stays bitwise (elementwise) and f's float32 sum runs in another
    order than XLA:CPU's, within ``QUAD_SUM_ULPS``."""
    rng = np.random.default_rng(0)
    for c in (1.0, 0.37):
        jq, tq = JQuad(curvature=c), Quadratic(curvature=c)
        assert jq.L == tq.L == c
        for d in (1, 1, 1, 9):
            x = rng.normal(size=(d,)).astype(np.float32)
            jf = np.float32(jq.f(jnp.asarray(x)))
            tf = tq.f(torch.from_numpy(x)).numpy()
            ulps = abs(int(jf.view(np.int32)) - int(tf.view(np.int32)))
            assert ulps <= (0 if d == 1 else QUAD_SUM_ULPS), (d, ulps)
            np.testing.assert_array_equal(
                np.asarray(jq.grad_f(jnp.asarray(x))).view(np.int32),
                tq.grad_f(torch.from_numpy(x)).numpy().view(np.int32))


def _gamma_trace(seed, n=300, tau_hi=9):
    rng = np.random.default_rng(seed)
    taus = np.minimum(rng.integers(0, tau_hi, size=n), np.arange(n))
    g = np.asarray(JA1(gamma_prime=0.8).run(taus.astype(np.int32)))
    return g, taus


@pytest.mark.parametrize("seed", [0, 1])
def test_check_principle_and_prop1_bitwise(seed):
    g, taus = _gamma_trace(seed)
    bad = g.copy()
    bad[50] += 0.5
    for gammas in (g, bad):
        for gp in (0.8, 0.3):
            assert jth.check_principle(gammas, taus, gp) == \
                tth.check_principle(gammas, taus, gp)
    assert tth.check_principle(g, taus, 0.8)
    assert not tth.check_principle(bad, taus, 0.8)
    for a, b in zip(jth.prop1_lower_bounds(g, taus, 0.8, 0.9, 8),
                    tth.prop1_lower_bounds(g, taus, 0.8, 0.9, 8)):
        np.testing.assert_array_equal(a, b)
    for c, b in ((0.5, 1.0), (1.0, 2.0), (0.3, 0.5)):
        assert jth.example1_divergence_threshold(c, b) == \
            tth.example1_divergence_threshold(c, b)


@pytest.mark.parametrize("seed", [0, 5])
def test_verify_theorem1_bitwise(seed):
    rng = np.random.default_rng(seed)
    K = 40
    taus = np.minimum(rng.integers(0, 6, size=K), np.arange(K))
    V, X = rng.random(K + 1) * 3, rng.random(K + 1)
    W, p = rng.random(K), np.full(K, 0.05)
    r, q = np.full(K, 2.0), np.full(K, 0.97)
    args = (V, X, W, p, r, q, taus)
    assert tuple(jth.verify_theorem1(*args)) == tuple(tth.verify_theorem1(*args))
    assert tth.Theorem1Report._fields == jth.Theorem1Report._fields


@pytest.mark.parametrize("pair", [
    (JNaive(gamma_prime=0.5, b=1.0), NaiveAdaptive(gamma_prime=0.5, b=1.0)),
    (JA1(gamma_prime=0.9, alpha=0.9), Adaptive1(gamma_prime=0.9, alpha=0.9)),
    (JA2(gamma_prime=0.9), Adaptive2(gamma_prime=0.9))],
    ids=["naive", "adaptive1", "adaptive2"])
def test_example1_matches_reference(pair):
    """Gammas bitwise; |x| per period within ``EX1_REL``; taus exact; and
    the paper's claims hold on the port (naive diverges, adaptive
    converges)."""
    jp, tp = pair
    T = jth.example1_divergence_threshold(0.5, 1.0)
    xj, gj, tj = jth.example1(jp, T, 40)
    xt, gt, tt = tth.example1(tp, T, 40, device="cpu")
    np.testing.assert_array_equal(tj, tt)
    np.testing.assert_array_equal(np.asarray(gj).view(np.int32),
                                  gt.view(np.int32))
    np.testing.assert_allclose(xt, xj, rtol=EX1_REL, atol=0)
    if isinstance(tp, NaiveAdaptive):
        assert xt[-1] > 1e3 * xt[0]
    else:
        assert xt[-1] < 1e-6


def _lipschitz_pair(g0, **problem):
    jp = jml(240, 40, n_workers=4, seed=0, **problem)
    tp = make_logreg(240, 40, n_workers=4, seed=0, device="cpu", **problem)
    jtr, ttr = jsim(4, 300, seed=1), simulate_parameter_server(4, 300, seed=1)
    np.testing.assert_array_equal(jtr.tau_max, ttr.tau_max)
    jr = jlip(jp, jtr, JL1(lam=jp.lam1), gamma0=g0, horizon=256)
    tr = run_piag_lipschitz(tp, ttr, L1(lam=tp.lam1), gamma0=g0, horizon=256,
                            device="cpu")
    np.testing.assert_array_equal(np.asarray(jr.taus), tr.taus.numpy())
    assert int(jr.clipped) == int(tr.clipped)
    jo, to = np.asarray(jr.objective), tr.objective.numpy()
    assert np.abs(jo - to).max() <= LIP_REL * abs(jo[0])
    return jr, tr


@pytest.mark.parametrize("g0", [1.0, 30.0])
def test_run_piag_lipschitz_matches_reference(g0):
    """Where every secant sample stays under the start estimate, L_est and
    the gammas follow the reference within ``LIP_REL`` (measured: equal)."""
    jr, tr = _lipschitz_pair(g0)
    for f in ("opt_residual", "gammas"):
        a, b = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert np.abs(a - b).max() <= LIP_REL * np.abs(a).max(), f
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x),
                               atol=LIP_REL * np.abs(np.asarray(jr.x)).max())


def test_run_piag_lipschitz_estimate_grows_in_both():
    """With lam2 = 0.5 every secant is at least lam2, so L_est rises from
    h/gamma0 = 0.09 in both packages.  Its running max also takes secants of
    nearly equal iterates, whose rounding noise is amplified by 1/||dx||:
    the two packages' L_est differ (ROADMAP queue C), the objective stays
    within ``LIP_REL`` of its start."""
    jr, tr = _lipschitz_pair(10.0, lam2=0.5)
    for L in (np.asarray(jr.opt_residual), tr.opt_residual.numpy()):
        assert L[0] == np.float32(0.09)
        assert np.all(np.diff(L) >= 0) and L[-1] >= 0.5


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_without_a_card_raise():
    """``device=None`` means the card: every entry point of the slice
    raises without one instead of falling back to the CPU."""
    from repro_torch.core import PIAGServer, SharedMemoryBCD
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import PRESETS, run_training
    from repro_torch.launch.train_bcd import run_bcd_training
    tp = make_logreg(240, 40, n_workers=4, seed=0, device="cpu")
    cfg = dataclasses.replace(PRESETS["25m"], n_layers=1, d_model=32,
                              n_heads=2, n_kv_heads=1, head_dim=16, d_ff=32,
                              vocab=64, attention_impl="chunked")
    calls = [
        lambda: tth.example1(Adaptive1(gamma_prime=0.9), 4, 2),
        lambda: PIAGServer(tp, Adaptive1(gamma_prime=0.1), L1()),
        lambda: SharedMemoryBCD(tp, Adaptive1(gamma_prime=0.1), L1()),
        lambda: run_piag_lipschitz(tp, simulate_parameter_server(4, 5), L1()),
        lambda: TokenStream(vocab=64, batch=1, seq=4).batch_at(0),
        lambda: run_training(cfg, steps=1, batch=1, seq=4),
        lambda: run_bcd_training(cfg, Adaptive1(gamma_prime=0.1), steps=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="none is available"):
            call()
