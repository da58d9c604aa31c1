"""repro_torch.federated.server against repro.federated.server: FedAsync
and FedBuff over the same trace and the same problem data, both engines.

Inputs are made by the reference (numpy-seeded problem data and client
traces) and carried over with ``interop``.  Tolerances:

* taus, versions, clipped: exact;
* weights: bitwise for ``constant``; ``hinge`` / ``poly`` within
  GAMMA_ULPS ulps (their pow / FMA-contracted denominator);
* objective: within OBJ_REL of its starting value -- the client gradient
  is a product in another order than the reference's ``jax.grad``;
* server arithmetic alone (a client update that returns stored rows):
  bitwise, with the reference's FMA contractions reproduced by ``fma32``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import WorkerModel as JWorker
from repro.core.problems import make_logreg as j_make_logreg
from repro.core.prox import L1 as JL1
from repro.core.stepsize import make_policy as j_policy
from repro.federated import events as je
from repro.federated import server as js
from repro.sweep.policies import ParamPolicy as JParamPolicy
from repro.sweep.policies import stack_params as j_stack
from repro_torch import interop
from repro_torch.analysis import best_fixed_vs_adaptive, time_to_tolerance
from repro_torch.core.prox import L1
from repro_torch.core.stepsize import make_policy
from repro_torch.federated import server as ts
from repro_torch.sweep.policies import ParamPolicy, stack_params

GAMMA_ULPS = 4
OBJ_REL = 1e-5
POLICIES = {"hinge": dict(a=0.5, b=4.0), "poly": dict(a=0.3), "constant": {}}


@pytest.fixture(scope="module")
def problems():
    jp = j_make_logreg(200, 30, n_workers=6, seed=0)
    tp = interop.logreg_problem(np.asarray(jp.A), np.asarray(jp.b), jp.lam1,
                                jp.lam2, jp.L, jp.Lhat, jp.n_workers,
                                device="cpu")
    return jp, tp


def _check(ref, got, name, where=""):
    for f in ("taus", "versions", "clipped"):
        a, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert np.array_equal(a, r), f"{where}{f}: {np.sum(a != r)} differ"
    w_p, w_r = got.weights.numpy(), np.asarray(ref.weights)
    ulps = np.abs(w_p - w_r) / (np.finfo(np.float32).eps * np.abs(w_r))
    if name == "constant":
        assert np.array_equal(w_p, w_r), f"{where}weights: max {ulps.max()} ulp"
    assert ulps.max() <= GAMMA_ULPS, f"{where}weights: {ulps.max()} ulp"
    o_p, o_r = got.objective.numpy(), np.asarray(ref.objective)
    rel = np.max(np.abs(o_p - o_r)) / abs(float(o_r[0]))
    assert rel <= OBJ_REL, f"{where}objective: {rel:.3g} of its start"


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_fedasync_matches_reference(problems, name, engine):
    jp, tp = problems
    tr = je.simulate_federated(6, 300, seed=2)
    ref = js.run_fedasync_problem(jp, tr, j_policy(name, 0.6,
                                                   **POLICIES[name]),
                                  JL1(lam=jp.lam1), horizon="auto")
    got = ts.run_fedasync_problem(tp, interop.federated_trace(*tr),
                                  make_policy(name, 0.6, **POLICIES[name]),
                                  L1(lam=tp.lam1), horizon="auto",
                                  engine=engine)
    _check(ref, got, name, f"{name}/{engine}/")


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("buffer_size", [1, 3])
def test_fedbuff_matches_reference(problems, buffer_size, engine):
    jp, tp = problems
    tr = je.simulate_federated(6, 300, buffer_size=buffer_size, seed=4)
    kw = dict(eta=0.4, buffer_size=buffer_size, local_lr=0.5 / jp.L,
              horizon="auto")
    ref = js.run_fedbuff_problem(jp, tr, j_policy("poly", 1.0, a=0.5),
                                 JL1(lam=jp.lam1), **kw)
    got = ts.run_fedbuff_problem(tp, interop.federated_trace(*tr),
                                 make_policy("poly", 1.0, a=0.5),
                                 L1(lam=tp.lam1), engine=engine, **kw)
    _check(ref, got, "poly", f"fedbuff {buffer_size}/{engine}/")
    assert int(np.asarray(ref.versions)[-1]) == 300 // buffer_size


def test_mixed_local_epochs_match_reference(problems):
    """Clients with 1, 2 and 3 local epochs: the batched update loops to the
    bucket's largest count and masks the cells that are done."""
    jp, tp = problems
    clients = [je.ClientModel(compute=JWorker(mean=1.0 + i / 3),
                              local_epochs=1 + i % 3, p_dropout=0.05)
               for i in range(6)]
    tr = je.simulate_federated(6, 200, clients, buffer_size=2, seed=1)
    assert set(np.unique(tr.local_steps)) == {1, 2, 3}
    kw = dict(eta=0.4, buffer_size=2, horizon=64)
    for engine in ("scan", "fused"):
        ref = js.run_fedbuff_problem(jp, tr, j_policy("hinge", 1.0),
                                     JL1(lam=jp.lam1), **kw)
        got = ts.run_fedbuff_problem(tp, interop.federated_trace(*tr),
                                     make_policy("hinge", 1.0),
                                     L1(lam=tp.lam1), engine=engine, **kw)
        _check(ref, got, "hinge", f"mixed epochs/{engine}/")


def test_local_prox_sgd_matches_reference_per_cell(problems):
    """Cells at 0, 1, 2 and 4 local steps on four clients in one call:
    0 steps returns the iterate unchanged; the others agree with the
    reference's ``fori_loop`` within 1e-6 of max |x|."""
    jp, tp = problems
    lr = 0.9 / jp.L
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 30)).astype(np.float32)
    steps = np.array([0, 1, 2, 4], np.int32)
    w = np.array([3, 0, 5, 1], np.int32)
    j_up = js.local_prox_sgd(lambda x, A, b: jp.worker_loss(x, A, b),
                             JL1(lam=jp.lam1), lr)
    Aw, bw = jp.worker_slices()
    ref = np.stack([np.asarray(j_up(jnp.asarray(x[i]), int(steps[i]),
                                    Aw[w[i]], bw[w[i]])) for i in range(4)])
    for grad_fn in (tp.worker_grads(), None):
        up = ts.local_prox_sgd(tp.worker_loss, L1(lam=tp.lam1), lr,
                               grad_fn=grad_fn, client_data=tp.worker_slices())
        got = up(torch.from_numpy(x), torch.from_numpy(steps),
                 torch.from_numpy(w)).numpy()
        assert np.array_equal(got[0], x[0])
        err = np.max(np.abs(got - ref))
        assert err <= 1e-6 * np.abs(ref).max(), err


def _row_update(rows_t):
    """A client update that returns stored rows: ``xc = rows[w, n_steps]``
    (the reference's gets client w's rows as its data), so the server's own
    arithmetic is all that is compared."""
    def j_update(x, n_steps, rows):
        return rows[n_steps]

    def t_update(x, n_steps, w, max_steps=None):
        return rows_t[w.long(), n_steps.long()]

    return j_update, t_update


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("solver", ["fedasync", "fedbuff"])
def test_server_arithmetic_is_bitwise(solver, engine):
    """With identical client models, the final server model is bitwise the
    reference's: the mix ``x + g*(xc - x)``, the delta accumulate
    ``d + g*(xc - xw)`` and the apply ``x + (agg*scale)*d`` are FMAs in
    the reference's compiled program on every path, and ``fma32`` here."""
    rng = np.random.default_rng(1)
    n, d, K = 4, 257, 80
    rows = rng.normal(size=(n, 8, d)).astype(np.float32)
    x0 = rng.normal(size=d).astype(np.float32)
    tr = je.simulate_federated(n, K, buffer_size=3 if solver == "fedbuff"
                               else 1, seed=6)
    tr = tr._replace(local_steps=(np.arange(K) % 8).astype(np.int32))
    j_up, t_up = _row_update(torch.from_numpy(rows))
    jpol = j_policy("hinge", 0.6, a=0.5, b=2.0)
    tpol = make_policy("hinge", 0.6, a=0.5, b=2.0)
    if solver == "fedasync":
        ref = js.run_fedasync(j_up, jnp.asarray(x0), (jnp.asarray(rows),),
                              tr, jpol, horizon=32, engine=engine)
        got = ts.run_fedasync(t_up, torch.from_numpy(x0),
                              (torch.from_numpy(rows),),
                              interop.federated_trace(*tr), tpol, horizon=32,
                              engine=engine)
    else:
        ref = js.run_fedbuff(j_up, jnp.asarray(x0), (jnp.asarray(rows),), tr,
                             jpol, eta=0.4, buffer_size=3, horizon=32,
                             engine=engine)
        got = ts.run_fedbuff(t_up, torch.from_numpy(x0),
                             (torch.from_numpy(rows),),
                             interop.federated_trace(*tr), tpol, eta=0.4,
                             buffer_size=3, horizon=32, engine=engine)
    x_r, x_p = np.asarray(ref.x), got.x.numpy()
    assert np.array_equal(x_p, x_r), \
        f"{int(np.sum(x_p != x_r))} of {d} differ, max {np.abs(x_p - x_r).max()}"
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(ref.weights))


@pytest.mark.slow
def test_fig5_headline_matches_reference():
    """fig5 at its own sizes (500 x 50 logreg, 8 clients, 3000 uploads,
    seed-1 trace, local_lr 0.5/L): uploads to 0.2 x the initial gap for
    hinge, poly and the three fixed weights, both packages running the five
    policies as one batched grid over the same trace.  Tolerance: equal
    counts; best adaptive < best fixed."""
    jp = j_make_logreg(n_samples=500, dim=50, n_workers=8, seed=0)
    tp = interop.logreg_problem(np.asarray(jp.A), np.asarray(jp.b), jp.lam1,
                                jp.lam2, jp.L, jp.Lhat, jp.n_workers,
                                device="cpu")
    from repro.core.problems import solve_centralized
    _, objs = solve_centralized(jp, JL1(lam=jp.lam1), iters=3000)
    p_star = float(objs[-1])
    target = 0.2 * (float(jp.P(jnp.zeros(jp.dim))) - p_star)
    clients = je.heterogeneous_clients(8, spread=4.0, seed=1,
                                       p_straggle=0.05, p_dropout=0.02)
    tr = je.simulate_federated(8, 3000, clients, seed=1)
    tau_max, alpha = tr.max_delay(), 0.4
    specs = {"hinge": ("hinge", alpha, dict(a=0.5, b=16.0)),
             "poly": ("poly", alpha, dict(a=0.3)),
             "fixed_taubound": ("constant", alpha / (tau_max + 1), {}),
             "fixed_taubound_sqrt": ("constant",
                                     alpha / float(np.sqrt(tau_max + 1)), {}),
             "fixed_taubound_x4": ("constant", 4 * alpha / (tau_max + 1), {})}
    H = 256
    lr = 0.5 / jp.L
    # reference: vmap over the five policies, one trace
    j_up = js.local_prox_sgd(lambda x, A, b: jp.worker_loss(x, A, b),
                             JL1(lam=jp.lam1), lr)
    _, _, events = js._prep(jnp.zeros(jp.dim), jp.worker_slices(), tr)
    jpp = j_stack([j_policy(n, g, **k) for n, g, k in specs.values()])
    ref = jax.jit(jax.vmap(lambda pp: js.fedasync_scan(
        j_up, jnp.zeros(jp.dim, jnp.float32), jp.worker_slices(), events,
        JParamPolicy(pp), objective=jp.P, horizon=H)))(jpp)
    # port: the same five cells as one batched pass
    t_up = ts.local_prox_sgd(tp.worker_loss, L1(lam=tp.lam1), lr,
                             grad_fn=tp.worker_grads())
    ev = tuple(torch.from_numpy(np.asarray(c, dt)).expand(5, -1).contiguous()
               for c, dt in ((tr.client, np.int32), (tr.tau, np.int32),
                             (tr.local_steps, np.int32),
                             (tr.aggregate, np.float32),
                             (tr.version, np.int32)))
    got = ts.fedasync_scan(t_up, torch.zeros(tp.dim), tp.worker_slices(), ev,
                           ParamPolicy(stack_params(
                               [make_policy(n, g, **k)
                                for n, g, k in specs.values()], "cpu")),
                           objective=tp.P, horizon=H, engine="fused")
    hits_r = time_to_tolerance(np.asarray(ref.objective), target,
                               p_star=p_star)
    hits_p = time_to_tolerance(got.objective, target, p_star=p_star)
    names = list(specs)
    assert list(hits_p) == list(hits_r), dict(zip(names, zip(hits_p, hits_r)))
    gap = best_fixed_vs_adaptive(dict(zip(names, map(int, hits_p))),
                                 fixed={n for n in names if "fixed" in n},
                                 adaptive={"hinge", "poly"})
    assert 0 <= gap["best_adaptive"] < gap["best_fixed"], gap


def test_interop_carries_federated_state():
    tr = je.simulate_federated(4, 50, buffer_size=2, seed=0)
    trace = interop.federated_trace(*tr)
    for a, b in zip(trace, tr):
        np.testing.assert_array_equal(a, np.asarray(b))
    rounds = je.sample_client_rounds(je.heterogeneous_clients(4), 20)
    arr = je.federated_trace_scan(
        je.ClientRounds(*map(jnp.asarray, rounds)),
        *map(jnp.asarray, je.client_arrays(je.heterogeneous_clients(4))), 10)
    got = interop.federated_trace_arrays(*map(np.asarray, arr), device="cpu")
    for a, b in zip(got, arr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    res = js.FedResult(x=jnp.ones(3), objective=jnp.arange(4.0),
                       weights=jnp.full(4, 0.5), taus=jnp.arange(4),
                       versions=jnp.arange(1, 5), clipped=jnp.int32(0))
    fr = interop.fed_result(*(np.asarray(leaf) for leaf in res[:6]),
                            device="cpu")
    assert fr.taus.dtype == torch.int32 and fr.x.dtype == torch.float32
    np.testing.assert_array_equal(fr.versions.numpy(), np.arange(1, 5))
    clients = interop.client_models(
        [dataclasses.asdict(c) for c in je.heterogeneous_clients(3, seed=2)])
    assert [c.compute.mean for c in clients] == \
        [c.compute.mean for c in je.heterogeneous_clients(3, seed=2)]
