"""repro_torch.federated.events and the federated sweeps against the
reference (the counterpart of ``tests/test_fed_scan.py``).

Client models are built in the reference and handed to the port as plain
numbers (``interop.client_models``); pre-sampled rounds come from each
package's own ``sample_client_rounds`` (pinned equal) or, where a test
says so, from the reference through ``interop.client_rounds``.

Tolerance: none.  Every trace column is compared bitwise -- client,
read_at, tau, aggregate, version, local_steps, and t_wall (float32 on the
device path, float64 on the heapq paths) -- including ragged ``active``
masks, simultaneous-upload ties, dropout/rejoin chains and short budgets.
Sweep rows: integer leaves exact, weights bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import WorkerModel as JWorker
from repro.federated import events as je
from repro_torch import interop
from repro_torch.core.problems import make_logreg
from repro_torch.core.prox import L1
from repro_torch.core.stepsize import HingeWeight, PolyWeight, make_policy
from repro_torch.federated import events as te
from repro_torch.federated.server import local_prox_sgd, run_fedasync
from repro_torch.sweep import grid as tgrid
from repro_torch.sweep import runners as trun

COLS = ("client", "read_at", "tau", "aggregate", "version", "local_steps")

J_CLIENTS = {
    "hetero": je.heterogeneous_clients(6, seed=3, p_dropout=0.0),
    "hetero_dropout": je.heterogeneous_clients(6, seed=3, p_dropout=0.1,
                                               rejoin_after=2.0),
    "heavy_dropout": je.heterogeneous_clients(5, seed=1, p_dropout=0.35,
                                              rejoin_after=1.0),
    "two_epochs": je.heterogeneous_clients(4, seed=2, p_dropout=0.05,
                                           local_epochs=2),
    # deterministic timings: every completion collides
    "ties": [je.ClientModel(compute=JWorker(mean=1.0, sigma=0.0),
                            upload=JWorker(mean=0.5, sigma=0.0))
             for _ in range(4)],
    "ties_rejoin": [je.ClientModel(compute=JWorker(mean=1.0, sigma=0.0),
                                   upload=JWorker(mean=1.0, sigma=0.0),
                                   p_dropout=0.4, rejoin_after=2.0)
                    for _ in range(4)],
}


def _port_clients(name):
    return interop.client_models(
        [dataclasses.asdict(c) for c in J_CLIENTS[name]])


def _assert_trace_equal(got, ref, t_dtype=np.float64, what=""):
    for f in COLS:
        a, r = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert np.array_equal(a, r), \
            f"{what}{f}: {int(np.sum(a != r))} of {r.size} entries differ"
    a = np.asarray(got.t_wall, t_dtype)
    r = np.asarray(ref.t_wall, t_dtype)
    assert np.array_equal(a, r), \
        f"{what}t_wall: max abs diff {float(np.max(np.abs(a - r)))}"


@pytest.mark.parametrize("model", sorted(J_CLIENTS))
def test_client_models_and_rounds_carry_over(model):
    """The port's clients from plain numbers draw the reference's rounds
    (the numpy substreams ``[seed, i, j]``) and its lifecycle constants."""
    clients = _port_clients(model)
    r_p = te.sample_client_rounds(clients, 300, seed=7)
    r_j = je.sample_client_rounds(J_CLIENTS[model], 300, seed=7)
    np.testing.assert_array_equal(r_p.drop_u, r_j.drop_u)
    np.testing.assert_array_equal(r_p.duration, r_j.duration)
    for a, b in zip(te.client_arrays(clients),
                    je.client_arrays(J_CLIENTS[model])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", sorted(J_CLIENTS))
@pytest.mark.parametrize("buffer_size", [1, 3])
def test_fed_scan_matches_heapq_reference(model, buffer_size):
    """The device race equals the reference's heapq simulator on the same
    pre-sampled rounds, and the port's heapq simulator equals it too."""
    K, S = 250, 1200
    clients = _port_clients(model)
    rj = je.sample_client_rounds(J_CLIENTS[model], S, seed=7)
    rounds = interop.client_rounds(rj.drop_u, rj.duration)
    out = te.federated_trace_scan(rounds, *te.client_arrays(clients), K,
                                  buffer_size=buffer_size, n_steps=S,
                                  device="cpu")
    assert int(out.n_uploads) == K and not bool(out.exhausted)
    ref = je.simulate_federated(len(clients), K, J_CLIENTS[model],
                                buffer_size=buffer_size, seed=7,
                                client_rounds=rj)
    _assert_trace_equal(out, ref, np.float32, f"{model}/scan/")
    heap = te.simulate_federated(len(clients), K, clients,
                                 buffer_size=buffer_size, seed=7,
                                 client_rounds=rounds)
    _assert_trace_equal(heap, ref, np.float64, f"{model}/heapq/")


@pytest.mark.parametrize("buffer_size", [1, 4])
def test_legacy_float64_simulation_matches_reference(buffer_size):
    """Without pre-sampled rounds both heapq simulators draw the legacy
    float64 shared stream (fig5's traces)."""
    clients = _port_clients("hetero_dropout")
    got = te.simulate_federated(6, 400, clients, buffer_size=buffer_size,
                                seed=1)
    ref = je.simulate_federated(6, 400, J_CLIENTS["hetero_dropout"],
                                buffer_size=buffer_size, seed=1)
    _assert_trace_equal(got, ref)
    assert got.n_writes == ref.n_writes and got.max_delay() == ref.max_delay()
    default = te.simulate_federated(5, 100, seed=3)
    _assert_trace_equal(default, je.simulate_federated(5, 100, seed=3))


def test_simultaneous_uploads_resolve_by_push_order():
    clients = _port_clients("ties")
    rounds = te.sample_client_rounds(clients, 200, seed=0)
    out = te.federated_trace_scan(rounds, *te.client_arrays(clients), 40,
                                  n_steps=200, device="cpu")
    np.testing.assert_array_equal(out.client[:4].numpy(), np.arange(4))
    assert float(out.t_wall[0]) == float(out.t_wall[3])


def test_dropout_rejoin_is_exercised():
    flaky = _port_clients("heavy_dropout")
    steady = [dataclasses.replace(c, p_dropout=0.0) for c in flaky]
    last = []
    for cs in (flaky, steady):
        rounds = te.sample_client_rounds(cs, 1000, seed=2)
        last.append(float(te.federated_trace_scan(
            rounds, *te.client_arrays(cs), 200, n_steps=1000,
            device="cpu").t_wall[-1]))
    assert last[0] > last[1]


def test_short_budget_reports_truncation_like_the_reference():
    clients = _port_clients("hetero")
    rounds = te.sample_client_rounds(clients, 100, seed=0)
    got = te.federated_trace_scan(rounds, *te.client_arrays(clients), 300,
                                  n_steps=100, device="cpu")
    rj = je.sample_client_rounds(J_CLIENTS["hetero"], 100, seed=0)
    ref = je.federated_trace_scan(
        je.ClientRounds(jnp.asarray(rj.drop_u), jnp.asarray(rj.duration)),
        *map(jnp.asarray, je.client_arrays(J_CLIENTS["hetero"])), 300,
        n_steps=100)
    assert int(got.n_uploads) == int(ref.n_uploads) < 300
    assert bool(got.exhausted) == bool(ref.exhausted)
    _assert_trace_equal(got, jax.tree_util.tree_map(np.asarray, ref),
                        np.float32)


def test_ragged_active_masks_match_reference_vmap():
    """A bucket of cells with 3, 5 and 6 clients padded to 6: every column
    of every cell, bitwise, and each padded cell equals its exact-width
    trace."""
    base = J_CLIENTS["hetero_dropout"]
    widths, seeds = (3, 5, 6), (0, 1, 2)
    grid = tgrid.make_grid(
        {"hinge": HingeWeight(gamma_prime=0.6)}, list(seeds),
        {f"w{w}": _port_clients("hetero_dropout")[:w] for w in widths}, 120)
    K, S, width = 120, te.default_fed_steps(120), 6
    rounds, cparams, active = trun._stack_fed_rounds(grid, width, S)
    got = te.federated_trace_scan(rounds, *cparams, K, buffer_size=2,
                                  n_steps=S, active=active, device="cpu")
    ref = jax.vmap(lambda r, p, q, e, a: je.federated_trace_scan(
        je.ClientRounds(*r), p, q, e, K, buffer_size=2, n_steps=S,
        active=a))(tuple(map(jnp.asarray, rounds)),
                   *map(jnp.asarray, cparams), jnp.asarray(active))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    _assert_trace_equal(got, ref, np.float32, "ragged/")
    np.testing.assert_array_equal(got.n_uploads.numpy(), ref.n_uploads)
    for b, c in enumerate(grid.cells):
        solo = je.simulate_federated(
            c.n_workers, K, base[:c.n_workers], buffer_size=2, seed=c.seed,
            client_rounds=je.sample_client_rounds(base[:c.n_workers], S,
                                                  seed=c.seed))
        _assert_trace_equal(te.FederatedTraceArrays(*(x[b] for x in got)),
                            solo, np.float32, f"cell {b}/")


def test_generate_federated_trace_matches_reference_and_budget():
    clients = _port_clients("hetero_dropout")
    K = 300
    tr = te.generate_federated_trace(6, K, clients, seed=9, device="cpu")
    _assert_trace_equal(tr, je.generate_federated_trace(
        6, K, J_CLIENTS["hetero_dropout"], seed=9))
    big = te.generate_federated_trace(6, K, clients, seed=9, device="cpu",
                                      n_steps=4 * te.default_fed_steps(K))
    _assert_trace_equal(big, tr)


def test_generate_federated_trace_autogrows_budget_like_the_reference():
    clients = _port_clients("heavy_dropout")
    tr = te.generate_federated_trace(5, 200, clients, seed=4, n_steps=64,
                                     device="cpu")
    assert tr.n_events == 200 and np.all(np.diff(tr.t_wall) >= 0)
    _assert_trace_equal(tr, je.generate_federated_trace(
        5, 200, J_CLIENTS["heavy_dropout"], seed=4, n_steps=64))


def test_generate_federated_trace_refuses_faults():
    """Faults are ported: a ``faults`` that is not a ``FaultSpec`` is
    refused with the reference's ``TypeError``, in both packages."""
    with pytest.raises(TypeError, match="faults must be a FaultSpec"):
        te.generate_federated_trace(4, 10, seed=0, device="cpu",
                                    faults=object())
    with pytest.raises(TypeError, match="faults must be a FaultSpec"):
        je.generate_federated_trace(4, 10, seed=0, faults=object())


def test_default_fed_steps_matches_reference():
    for k in (1, 10, 255, 2500, 10_000):
        assert te.default_fed_steps(k) == je.default_fed_steps(k)


# ------------------------------------------------------------- sweeps ----

@pytest.fixture(scope="module")
def problem():
    return make_logreg(240, 40, n_workers=4, seed=0, device="cpu")


def _fed_grid(n_events=120, seeds=(0, 1)):
    return tgrid.make_grid(
        {"poly": PolyWeight(gamma_prime=1.0, a=0.5),
         "hinge": HingeWeight(gamma_prime=1.0, a=2.0, b=2.0)},
        list(seeds), {"edge": _port_clients("two_epochs")}, n_events)


def test_sweep_fedbuff_rows_equal_port_solo_rows(problem):
    """A batched ``sweep_fedbuff`` row equals the solo ``run_fedbuff`` of
    that cell over the same trace: taus, versions, clipped exact, weights
    bitwise, objective within 1e-6 of its start (one GEMM shape per cell
    against one per bucket)."""
    from repro_torch.federated.server import run_fedbuff
    prox = L1(lam=problem.lam1)
    grid = _fed_grid()
    res = trun.sweep_fedbuff_problem(problem, grid, prox, eta=0.4,
                                     buffer_size=3,
                                     local_lr=0.5 / problem.L)
    assert res.objective.shape == (len(grid), 120)
    update = local_prox_sgd(problem.worker_loss, prox, 0.5 / problem.L,
                            grad_fn=problem.worker_grads())
    x0 = torch.zeros(problem.dim)
    for i, cell in enumerate(grid.cells):
        trace = te.generate_federated_trace(4, 120, list(cell.workers),
                                            buffer_size=3, seed=cell.seed,
                                            device="cpu")
        solo = run_fedbuff(update, x0, problem.worker_slices(), trace,
                           cell.policy, eta=0.4, buffer_size=3,
                           objective=problem.P)
        for f in ("taus", "versions", "clipped", "weights"):
            assert torch.equal(getattr(solo, f), getattr(res, f)[i]), f
        diff = float((solo.objective - res.objective[i]).abs().max())
        assert diff <= 1e-6 * abs(float(solo.objective[0])), diff


def test_sweep_fedasync_reference_hatch_is_bitwise_twin(problem):
    prox = L1(lam=problem.lam1)
    grid = tgrid.make_grid(
        {"hinge": HingeWeight(gamma_prime=0.6)}, [0, 1, 2],
        {"edge": _port_clients("hetero_dropout")[:4]}, 100)
    fused = trun.sweep_fedasync_problem(problem, grid, prox)
    ref = trun.sweep_fedasync_problem(problem, grid, prox, reference=True)
    for f in ("taus", "versions", "clipped", "weights", "objective", "x"):
        assert torch.equal(getattr(fused, f), getattr(ref, f)), f


def test_measure_fed_tau_bar_and_auto_horizon_match_reference(problem):
    from repro.sweep import grid as jgrid
    from repro.sweep import runners as jrun
    from repro.core.stepsize import make_policy as jmake
    jg = jgrid.make_grid({"hinge": jmake("hinge", 0.6)}, [0, 1],
                         {"edge": J_CLIENTS["heavy_dropout"]}, 150)
    tg = tgrid.make_grid({"hinge": make_policy("hinge", 0.6)}, [0, 1],
                         {"edge": _port_clients("heavy_dropout")}, 150)
    for bs in (1, 3):
        got = trun.measure_fed_tau_bar(tg, buffer_size=bs, device="cpu")
        assert got == jrun.measure_fed_tau_bar(jg, buffer_size=bs)
        assert trun.resolve_grid_horizon("auto", tg, fed=True,
                                         buffer_size=bs, device="cpu") == \
            jrun.resolve_grid_horizon("auto", jg, fed=True, buffer_size=bs)


@pytest.mark.parametrize("solver", ["fedasync", "fedbuff"])
def test_auto_horizon_run_races_each_bucket_once(problem, solver,
                                                 monkeypatch):
    """Under ``horizon='auto'`` a batched ``api.run`` sizes H from the
    buckets' races and runs its servers over those same rows: one race per
    bucket, and rows bitwise those of a run at that H given outright."""
    from repro_torch import api as tapi
    calls = []
    real = trun.federated_trace_scan

    def counting(*args, **kwargs):
        calls.append(kwargs.get("active").shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(trun, "federated_trace_scan", counting)
    grid = tgrid.make_grid(
        {"hinge": HingeWeight(gamma_prime=0.6, a=2.0, b=2.0)}, [0, 1],
        {"four": _port_clients("two_epochs"),
         "three": _port_clients("hetero_dropout")[:3]}, 90)
    kw = dict(problem=problem, grid=grid, prox=L1(lam=problem.lam1),
              device="cpu", local_lr=0.5 / problem.L)
    if solver == "fedbuff":
        kw.update(eta=0.4, buffer_size=3)

    def run(horizon):
        spec = tapi.component_spec(solver, "batched", horizon=horizon, **kw)
        return tapi.run(dataclasses.replace(spec, execution=dataclasses.replace(
            spec.execution, bucket_widths=(3, 4))))

    auto = run("auto")
    assert len(calls) == len(grid.buckets((3, 4))) == 2, calls
    given = run(auto.horizon)
    for f in ("taus", "versions", "clipped", "weights", "objective", "x"):
        assert torch.equal(getattr(auto.raw, f), getattr(given.raw, f)), f


@pytest.mark.parametrize("solver", ["fedasync", "fedbuff"])
def test_bucket_program_equals_sweep_rows(problem, solver):
    """``make_sweep_fedasync_fused`` / ``make_sweep_fedbuff`` (the race
    inside the bucket program) give the sweep's rows bitwise, and its
    diagnostics say every cell uploaded ``K`` times."""
    prox = L1(lam=problem.lam1)
    grid = _fed_grid(n_events=90)
    update = local_prox_sgd(problem.worker_loss, prox, 0.5 / problem.L,
                            grad_fn=problem.worker_grads())
    x0, data = torch.zeros(problem.dim), problem.worker_slices()
    kw = dict(objective=problem.P, horizon=64)
    if solver == "fedbuff":
        kw.update(eta=0.4, buffer_size=3)
        make, sweep = trun.make_sweep_fedbuff, trun.sweep_fedbuff
    else:
        make, sweep = trun.make_sweep_fedasync_fused, trun.sweep_fedasync
    (b,) = grid.buckets()
    S = te.default_fed_steps(90)
    rounds, cparams, active = trun._stack_fed_rounds(b.grid, b.width, S)
    res, n_up, exhausted = make(update, x0, data, 90, **kw)(
        rounds, cparams, active, grid.policy_params("cpu"))
    assert torch.equal(n_up, torch.full((len(grid),), 90, dtype=n_up.dtype))
    assert not bool(exhausted.any())
    rows = sweep(update, x0, data, grid, **kw)
    for f in ("taus", "versions", "clipped", "weights", "objective", "x"):
        assert torch.equal(getattr(res, f), getattr(rows, f)), f


def test_clipped_counter_in_federated_rows(problem):
    """An undersized horizon shows in ``clipped``: the count of uploads
    whose staleness exceeded H - 1."""
    prox = L1(lam=problem.lam1)
    grid = _fed_grid(n_events=80, seeds=(0,))
    tight = trun.sweep_fedasync_problem(problem, grid, prox, horizon=2)
    roomy = trun.sweep_fedasync_problem(problem, grid, prox, horizon=4096)
    assert torch.equal(roomy.clipped, torch.zeros(len(grid), dtype=torch.int32))
    assert torch.equal(tight.clipped, (roomy.taus > 1).sum(dim=1).to(
        torch.int32))
    assert int(tight.clipped.sum()) > 0


def test_short_budget_raises_in_a_sweep(problem):
    with pytest.raises(RuntimeError, match="fewer than 120 uploads"):
        trun.sweep_fedasync_problem(problem, _fed_grid(seeds=(0,)),
                                    L1(lam=problem.lam1), n_steps=50)


def test_solo_run_uses_the_trace_it_is_given(problem):
    """``run_fedasync`` on a trace carried over from the reference reads
    its columns as they are (``interop.federated_trace``)."""
    tr = je.simulate_federated(4, 60, J_CLIENTS["two_epochs"], seed=5)
    trace = interop.federated_trace(*tr)
    update = local_prox_sgd(problem.worker_loss, L1(lam=problem.lam1),
                            0.5 / problem.L, grad_fn=problem.worker_grads())
    res = run_fedasync(update, torch.zeros(problem.dim),
                       problem.worker_slices(), trace,
                       make_policy("poly", 0.5, a=0.5), engine="scan")
    np.testing.assert_array_equal(res.taus.numpy(), tr.tau)
    np.testing.assert_array_equal(res.versions.numpy(), tr.version)
    assert torch.isnan(res.objective).all()
