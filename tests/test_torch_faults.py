"""The port's fault layer (``repro_torch.faults``) against the reference's
(``repro.faults``).

Randomness: threefry2x32, ``fold_in``, ``split``, the raw bits and
``uniform`` (with and without ``minval``) are bitwise ``jax.random``'s
under jax's partitionable layout, on seeds and shapes with odd element
counts.  Injection: ``inject_service_times`` (crash chains, spikes),
``inject_client_rounds`` and ``update_fault_codes`` are bitwise the
reference's on the CPU, where the spike power is the C library's
``powf`` as in the reference's XLA:CPU program; a cell drawn in a bucket
equals the cell drawn alone.  Guards: the unit cases of
``tests/test_faults.py``.  Solvers: PIAG, Async-BCD, FedAsync and FedBuff,
solo and batched, under the reference suite's chaos spec at its sizes
(logreg 240 x 40, 4 workers, 100 events / 80 uploads), each against the
reference's batched run: workers' taus, blocks, versions, clip counts,
all six fault counters and ``RunRecord.faults`` exact; gammas bitwise (the guarded push is the plain
sum, ROADMAP queue C); the objective within 1e-5 of its start; the port's
solo rows equal its batched rows.  Fault-off: ``None`` and a disabled
spec give bitwise the same rows; telemetry on and off are bitwise under
faults.  Each reference program runs once per module.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import faults as jf
from repro.core import (Adaptive1 as JAdaptive1, FixedStepSize as JFixed,
                        L1 as JL1, make_logreg as j_make_logreg)
from repro.core.engine import (WorkerModel as JWorkerModel,
                               heterogeneous_workers as j_hetero)
from repro.core.stepsize import HingeWeight as JHinge
from repro.federated import events as je
from repro.sweep import make_grid as j_make_grid
from repro.telemetry import spec_fingerprint as j_fingerprint
from repro_torch import api as tapi
from repro_torch import faults as tf
from repro_torch.core import (Adaptive1, FixedStepSize, L1, make_logreg)
from repro_torch.core.engine import WorkerModel, heterogeneous_workers
from repro_torch.core.stepsize import HingeWeight
from repro_torch.faults import inject as ti
from repro_torch.federated import events as te
from repro_torch.sweep import make_grid
from repro_torch.telemetry import spec_fingerprint as t_fingerprint

N_EVENTS = 100
N_EVENTS_FED = 80
SOLVERS = ("piag", "bcd", "fedasync", "fedbuff")
SOLVER_KW = {"piag": {}, "bcd": {"m": 8}, "fedasync": {},
             "fedbuff": {"eta": 0.5, "buffer_size": 2}}
# the reference suite's chaos spec (tests/test_faults.py)
CHAOS = dict(p_crash=0.05, p_rejoin=0.3, crash_scale=20.0, p_spike=0.05,
             p_drop=0.05, p_dup=0.05, p_corrupt=0.05, staleness_cutoff=64,
             seed=3)
OBJ_REL = 1e-5   # objective, relative to its start (ROADMAP queue C)
INT_LEAVES = ("taus", "clipped", "blocks", "versions")


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- threefry ----

FOLD_DATA = (0, 1, 77, 0x5EED0003, 2**32 - 1)
DRAW_SHAPES = ((1,), (7,), (3, 5), (4, 101), (2, 3, 5))


@jax.jit
def _jax_draws(seed):
    """Every ``jax.random`` draw the threefry test compares, as one
    program of the seed."""
    jk = jax.random.PRNGKey(seed)
    return (jk, [jax.random.fold_in(jk, np.uint32(d)) for d in FOLD_DATA],
            jax.random.split(jk),
            [(jax.random.bits(jk, shape, jnp.uint32),
              jax.random.uniform(jk, shape, jnp.float32),
              jax.random.uniform(jk, shape, jnp.float32, minval=1e-6,
                                 maxval=1.0)) for shape in DRAW_SHAPES])


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 - 1, -5])
def test_threefry_keys_bits_and_uniform_match_jax(seed):
    jk, folds, halves, draws = jax.tree.map(np.asarray,
                                            _jax_draws(np.int32(seed)))
    tk = ti.prng_key(seed, "cpu")
    assert [int(w) for w in tk] == jk.astype(np.int64).tolist()
    for data, want in zip(FOLD_DATA, folds):
        got = ti.fold_in(tk, data)
        assert [int(w) for w in got] == want.astype(np.int64).tolist()
    got = ti.split(tk)
    assert [[int(w) for w in k] for k in got] == \
        halves.astype(np.int64).tolist()
    for shape, (bits, u, u_min) in zip(DRAW_SHAPES, draws):
        np.testing.assert_array_equal(ti.random_bits(tk, shape).numpy(),
                                      bits.astype(np.int64))
        np.testing.assert_array_equal(_bits(ti.uniform(tk, shape)), _bits(u))
        np.testing.assert_array_equal(
            _bits(ti.uniform(tk, shape, minval=1e-6, maxval=1.0)),
            _bits(u_min))


def test_uniform_with_minval_is_the_contracted_sum():
    """The reference's program rounds ``u * (max - min) + min`` once; the
    unfused sum differs from it on about a quarter of the draws."""
    jk, tk = jax.random.PRNGKey(0), ti.prng_key(0, "cpu")
    want = _bits(jax.random.uniform(jk, (4_000,), jnp.float32,
                                    minval=1e-6, maxval=1.0))
    np.testing.assert_array_equal(
        _bits(ti.uniform(tk, (4_000,), minval=1e-6, maxval=1.0)), want)
    bits = ti.random_bits(tk, (4_000,))
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = torch.tensor(1e-6), torch.tensor(1.0)
    unfused = torch.maximum(lo, u * (hi - lo) + lo)
    assert np.mean(_bits(unfused) != want) > 0.1


def test_batched_keys_draw_each_cells_own_bits():
    seeds = [0, 1, 5, 9]
    k = ti.fold_in(ti.prng_key(3, "cpu"), torch.tensor(seeds))
    got = ti.uniform(k, (3, 5)).numpy()
    for i, s in enumerate(seeds):
        jk = jax.random.fold_in(jax.random.PRNGKey(3), jnp.uint32(s))
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.uniform(jk, (3, 5))))


# ---------------------------------------------------------- injection ----

SPECS = {
    "chaos": dict(jf.FAULT_PRESETS["chaos"]),
    "suite": CHAOS,
    "straggler": dict(p_spike=0.3, spike_tail=1.2, seed=9),
    "crash": dict(p_crash=0.04, p_rejoin=0.15, crash_scale=60.0, seed=0),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_inject_service_times_matches_reference(name):
    kw = SPECS[name]
    js, ts = jf.FaultSpec(**kw), tf.FaultSpec(**kw)
    rng = np.random.default_rng(0)
    T = rng.lognormal(0.0, 0.3, size=(3, 5, 101)).astype(np.float32)
    ref = jax.jit(lambda t, s: jf.inject_service_times(t, js, s))
    batched = tf.inject_service_times(torch.from_numpy(T), ts,
                                      torch.tensor([0, 1, 5]))
    for i, seed in enumerate((0, 1, 5)):
        want = _bits(ref(jnp.asarray(T[i]), jnp.int32(seed)))
        np.testing.assert_array_equal(_bits(batched[i]), want)
        np.testing.assert_array_equal(
            _bits(tf.inject_service_times(torch.from_numpy(T[i]), ts, seed)),
            want)
    codes = tf.update_fault_codes(ts, N_EVENTS, torch.tensor([0, 1, 5]))
    assert codes.dtype == torch.int32 and codes.shape == (3, N_EVENTS)
    for i, seed in enumerate((0, 1, 5)):
        want = np.asarray(jf.update_fault_codes(js, N_EVENTS,
                                                jnp.int32(seed)))
        np.testing.assert_array_equal(codes[i].numpy(), want)
        np.testing.assert_array_equal(
            tf.update_fault_codes(ts, N_EVENTS, seed, "cpu").numpy(), want)


def test_inject_client_rounds_and_faulted_trace_match_reference():
    kw = SPECS["suite"]
    clients = te.heterogeneous_clients(4, seed=2)
    rounds = te.sample_client_rounds(clients, 300, seed=1)
    want = jf.inject_client_rounds(je.ClientRounds(*map(jnp.asarray, rounds)),
                                   jf.FaultSpec(**kw), jnp.int32(1))
    got = tf.inject_client_rounds(te.ClientRounds(
        *(torch.from_numpy(a) for a in rounds)), tf.FaultSpec(**kw), 1)
    np.testing.assert_array_equal(_bits(got.duration), _bits(want.duration))
    np.testing.assert_array_equal(got.drop_u.numpy(), np.asarray(rounds[0]))
    ref = je.generate_federated_trace(4, N_EVENTS_FED, seed=1,
                                      faults=jf.FaultSpec(**kw))
    port = te.generate_federated_trace(4, N_EVENTS_FED, seed=1,
                                       faults=tf.FaultSpec(**kw),
                                       device="cpu")
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)


def test_faults_only_slow_workers():
    T = torch.ones((4, 64))
    spec = tf.FaultSpec(p_crash=0.1, p_rejoin=0.3, crash_scale=25.0, seed=0)
    Tf = tf.inject_service_times(T, spec, 0)
    assert Tf.shape == T.shape and bool((Tf >= T).all())
    assert float(Tf.sum()) > float(T.sum()) * 1.5
    codes = tf.update_fault_codes(tf.FaultSpec(p_drop=0.2, p_dup=0.2,
                                               p_corrupt=0.2, seed=5),
                                  512, 7, "cpu").numpy()
    assert set(np.unique(codes)) <= {0, 1, 2, 3} and (codes > 0).mean() > 0.3


DEVICE_CALLS = {
    "codes": lambda: tf.update_fault_codes(tf.FaultSpec(p_drop=0.1), 8, 0),
    "key": lambda: ti.prng_key(0),
    "counters": lambda: tf.init_faults((2,)),
    "poison": lambda: tf.corrupt_value(tf.FaultSpec()),
    "gamma_prime": lambda: tf.fault_gamma_prime(
        FixedStepSize(gamma_prime=0.1, tau_bound=4)),
}


@pytest.mark.parametrize("call", sorted(DEVICE_CALLS))
def test_entry_points_run_on_the_card_unless_told(call, monkeypatch):
    """With no device named and no tensor to fix one, the fault layer
    runs on the card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        DEVICE_CALLS[call]()
    # a tensor seed fixes the device
    codes = tf.update_fault_codes(tf.FaultSpec(p_drop=0.1), 8,
                                  torch.tensor(0))
    assert codes.device.type == "cpu" and codes.shape == (8,)


# -------------------------------------------------------- guard units ----

def test_guard_event_drop_dup_and_staleness():
    spec = tf.FaultSpec(staleness_cutoff=8)
    fs = tf.init_faults(device="cpu")
    acc, mult, fs = tf.guard_event(spec, 0, 2, True, fs)
    assert bool(acc) and float(mult) == 1.0
    acc, mult, fs = tf.guard_event(spec, 1, 2, True, fs)
    assert not bool(acc) and int(fs.dropped) == 1
    acc, mult, fs = tf.guard_event(spec, 2, 2, True, fs)
    assert bool(acc) and float(mult) == 2.0 and int(fs.duplicated) == 1
    acc, mult, fs = tf.guard_event(spec, 0, 2, False, fs)
    assert not bool(acc) and int(fs.rejected_nonfinite) == 1
    acc, mult, fs = tf.guard_event(spec, 0, 9, True, fs)
    assert not bool(acc) and int(fs.rejected_stale) == 1
    # the reference's counters on the same five events
    jfs = jf.init_faults()
    for code, tau, fin in ((0, 2, True), (1, 2, True), (2, 2, True),
                           (0, 2, False), (0, 9, True)):
        _, _, jfs = jf.guard_event(jf.FaultSpec(staleness_cutoff=8),
                                   jnp.int32(code), jnp.int32(tau),
                                   jnp.bool_(fin), jfs)
    assert jf.summarize_faults(jfs) == tf.summarize_faults(fs)


def test_guarded_gamma_degrades_on_clip():
    policy = Adaptive1(gamma_prime=0.5)
    ss = policy.init(horizon=4, device="cpu")
    fs = tf.init_faults(device="cpu")
    gamma, ss2, fs = tf.guarded_gamma(policy, ss, torch.tensor(100),
                                      torch.tensor(1.0),
                                      tf.FaultSpec(degrade_on_clip=True), fs)
    assert int(fs.degraded) == 1 and int(ss2.clipped) == 1
    np.testing.assert_allclose(float(gamma),
                               float(tf.fault_gamma_prime(policy, ss.total)) / 101,
                               rtol=1e-6)
    assert float(ss2.total) == float(gamma)
    jpol = JAdaptive1(gamma_prime=0.5)
    jg, _, _ = jf.guarded_gamma(jpol, jpol.init(horizon=4), jnp.int32(100),
                                jnp.int32(1), jf.FaultSpec(), jf.init_faults())
    assert _bits(gamma.reshape(())) == _bits(np.float32(jg))


def test_summarize_faults_none_and_zero():
    assert tf.summarize_faults(None) == {}
    z = tf.summarize_faults(tf.init_faults((3,), "cpu"))
    assert set(z) == set(tf.FaultState._fields) and not any(z.values())
    assert tf.FaultState._fields == jf.FaultState._fields


# ------------------------------------------------------- spec, parse ----

def test_parse_faults_validation_and_fingerprint():
    for text in (None, "", "chaos,staleness_cutoff=64,seed=7", "p_drop=0.1",
                 "crash,corrupt_mode=inf,guard_nonfinite=off",
                 "staleness_cutoff=none"):
        assert repr(tf.parse_faults(text)) == repr(jf.parse_faults(text))
    for bad, err in (("warp", "unknown fault preset"),
                     ("bogus=1", "unknown FaultSpec field")):
        with pytest.raises(ValueError, match=err):
            tf.parse_faults(bad)
    for kw, err in ((dict(corrupt_mode="zero"), "corrupt_mode"),
                    (dict(p_drop=1.5), "p_drop must be a probability"),
                    (dict(p_crash=0.1, p_rejoin=0.0), "p_rejoin > 0"),
                    (dict(staleness_cutoff=-1), "staleness_cutoff")):
        with pytest.raises(ValueError, match=err):
            tf.FaultSpec(**kw)
    assert tf.FAULT_PRESETS == jf.FAULT_PRESETS
    assert tf.normalize_faults(tf.FaultSpec(enabled=False)) is None
    with pytest.raises(TypeError, match="faults must be a FaultSpec"):
        tf.normalize_faults(object())
    a, b = tf.FaultSpec(**CHAOS), tf.FaultSpec(**CHAOS)
    assert a == b and hash(a) == hash(b) and a.replace(seed=4) != a
    tspec = tapi.ExperimentSpec(execution=tapi.ExecutionSpec(
        engine="scan", device="cpu"), faults=tf.FaultSpec(**CHAOS))
    jspec = japi.ExperimentSpec(execution=japi.ExecutionSpec(engine="scan"),
                                faults=jf.FaultSpec(**CHAOS))
    assert t_fingerprint(tspec) == j_fingerprint(jspec)
    assert t_fingerprint(tspec) != t_fingerprint(tspec.replace(
        faults=tf.FaultSpec(**dict(CHAOS, seed=4))))
    with pytest.raises(ValueError, match="fused"):
        tapi.ExperimentSpec(faults=tf.FaultSpec(p_drop=0.1))
    with pytest.raises(ValueError, match="reference"):
        tapi.ExperimentSpec(
            solver=tapi.SolverSpec(name="fedasync"),
            execution=tapi.ExecutionSpec(engine="scan", reference=True),
            faults=tf.FaultSpec(p_drop=0.1))


# ----------------------------------------------------- the four solvers ----

@pytest.fixture(scope="module")
def problems():
    return (j_make_logreg(240, 40, n_workers=4, seed=0),
            make_logreg(240, 40, n_workers=4, seed=0, device="cpu"))


def _worker_grid(mg, A1, Fx, WM, hw, gp):
    return mg(policies={"a1": A1(gamma_prime=gp),
                        "fx": Fx(gamma_prime=gp, tau_bound=40)},
              seeds=[0, 1],
              topologies={"uniform": [WM() for _ in range(4)],
                          "hetero": hw(4, seed=1)},
              n_events=N_EVENTS)


def _fed_grid(mg, Hinge, clients):
    return mg(policies={"hinge": Hinge(gamma_prime=0.6)}, seeds=[0, 1],
              topologies={"edge": clients(4, seed=2)},
              n_events=N_EVENTS_FED)


@pytest.fixture(scope="module")
def grids(problems):
    gp = 0.99 / problems[0].L
    return {
        "worker": (_worker_grid(j_make_grid, JAdaptive1, JFixed,
                                JWorkerModel, j_hetero, gp),
                   _worker_grid(make_grid, Adaptive1, FixedStepSize,
                                WorkerModel, heterogeneous_workers, gp)),
        "fed": (_fed_grid(j_make_grid, JHinge, je.heterogeneous_clients),
                _fed_grid(make_grid, HingeWeight, te.heterogeneous_clients)),
    }


def _run(pkg, solver, backend, problems, grids, faults, horizon=4096,
         **kw):
    fed = solver.startswith("fed")
    i = 0 if pkg is japi else 1
    grid = grids["fed" if fed else "worker"][i]
    problem = problems[i]
    lam = problem.lam1
    extra = {} if pkg is japi else {"device": "cpu"}
    return pkg.run_components(
        solver, backend, problem=problem, grid=grid,
        prox=(JL1 if pkg is japi else L1)(lam=lam), horizon=horizon,
        faults=faults, engine="scan", **{**SOLVER_KW[solver], **extra, **kw})


@pytest.fixture(scope="module")
def chaos_runs(problems, grids):
    """Each (solver, backend) of the port under the chaos spec, beside the
    reference's batched run of the solver.  The reference's solo rows
    equal its batched rows in every leaf compared here
    (``tests/test_faults.py::test_chaos_solo_matches_batched`` holds its
    taus and counters), so its batched run pins both of the port's."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = {s: _run(japi, s, "batched", problems, grids,
                       jf.FaultSpec(**CHAOS)) for s in SOLVERS}
        return {(s, b): (ref[s], _run(tapi, s, b, problems, grids,
                                      tf.FaultSpec(**CHAOS)))
                for s in SOLVERS for b in ("batched", "solo")}


@pytest.mark.parametrize("backend", ["batched", "solo"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_chaos_matches_reference(solver, backend, chaos_runs):
    ref, got = chaos_runs[(solver, backend)]
    R, T = ref.raw, got.raw
    for f in INT_LEAVES:
        if f in R._fields:
            np.testing.assert_array_equal(getattr(T, f).numpy(),
                                          np.asarray(getattr(R, f)),
                                          err_msg=f)
    gam = "weights" if "weights" in R._fields else "gammas"
    np.testing.assert_array_equal(_bits(getattr(T, gam)),
                                  _bits(getattr(R, gam)))
    o_r = np.asarray(R.objective)
    err = np.abs(T.objective.numpy() - o_r)
    assert np.all(err <= OBJ_REL * np.abs(o_r[:, :1])), float(err.max())
    counters = tf.summarize_faults(T.faults)
    assert counters == jf.summarize_faults(R.faults)
    assert got.telemetry.faults == ref.telemetry.faults == counters
    assert counters["injected"] > 0 and counters["dropped"] > 0
    assert bool(torch.isfinite(T.objective).all())


@pytest.mark.parametrize("solver", SOLVERS)
def test_chaos_solo_equals_batched(solver, chaos_runs):
    """The fault keys fold the cell seed, never the bucket layout: integer
    leaves, counters and gammas are equal; the floats that pass through
    the batched gradient products agree within the objective envelope."""
    solo, batched = chaos_runs[(solver, "solo")][1].raw, \
        chaos_runs[(solver, "batched")][1].raw
    for f in solo._fields:
        if f in ("telemetry", "x"):
            continue
        a, b = getattr(solo, f), getattr(batched, f)
        if f == "faults":
            for name in tf.FaultState._fields:
                assert torch.equal(getattr(a, name), getattr(b, name)), name
        elif f in ("objective", "opt_residual"):
            scale = float(batched.objective[:, 0].abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=OBJ_REL * scale, err_msg=f)
        else:
            assert torch.equal(a, b), f


@pytest.mark.parametrize("solver", ["fedasync", "fedbuff"])
def test_faulted_federated_race_is_timed_outside_the_dispatch(solver,
                                                              problems,
                                                              grids):
    """A faulted federated bucket is raced as it runs: its race is
    counted in ``fed_bucket_races.seconds`` and timed in a
    ``bucket_prepare`` span just before its ``bucket_dispatch``."""
    from repro_torch.sweep.runners import fed_bucket_races
    before = fed_bucket_races.seconds
    got = _run(tapi, solver, "batched", problems, grids,
               tf.FaultSpec(**CHAOS))
    assert fed_bucket_races.seconds > before
    names = [ev["name"] for ev in got.telemetry.timings
             if ev["name"].startswith("bucket_")]
    n = len(got.grid.buckets())
    assert names == ["bucket_prepare", "bucket_dispatch"] * n


def test_degradation_on_horizon_overflow_matches_reference(problems, grids):
    """A horizon far below the faulted delays: the guard degrades clipped
    events to gamma'/(tau+1), event for event as the reference does."""
    spec = dict(CHAOS, staleness_cutoff=None)
    ref = _run(japi, "piag", "batched", problems, grids,
               jf.FaultSpec(**spec), horizon=8)
    got = _run(tapi, "piag", "batched", problems, grids,
               tf.FaultSpec(**spec), horizon=8)
    counters = tf.summarize_faults(got.raw.faults)
    assert counters == jf.summarize_faults(ref.raw.faults)
    assert counters["degraded"] > 0
    np.testing.assert_array_equal(_bits(got.raw.gammas),
                                  _bits(ref.raw.gammas))
    np.testing.assert_array_equal(got.raw.clipped.numpy(),
                                  np.asarray(ref.raw.clipped))


# ----------------------------------------------------------- fault-off ----

@pytest.mark.parametrize("backend", ["batched", "solo"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_faults_off_is_bitwise(solver, backend, problems, grids):
    off = _run(tapi, solver, backend, problems, grids, None)
    disabled = _run(tapi, solver, backend, problems, grids,
                    tf.FaultSpec(enabled=False, p_drop=0.5, p_crash=0.5,
                                 p_rejoin=0.5))
    assert off.raw.faults is None and disabled.raw.faults is None
    assert off.telemetry.faults is None
    assert off.spec.faults is None and disabled.spec.faults is None
    for f in off.raw._fields:
        if f in ("telemetry", "faults"):
            continue
        assert torch.equal(getattr(off.raw, f), getattr(disabled.raw, f)), f


@pytest.mark.parametrize("solver", SOLVERS)
def test_telemetry_is_neutral_under_faults(solver, problems, grids,
                                           chaos_runs):
    off = chaos_runs[(solver, "batched")][1]
    on = _run(tapi, solver, "batched", problems, grids,
              tf.FaultSpec(**CHAOS), telemetry=True)
    assert on.raw.telemetry is not None
    assert int(on.raw.telemetry.count.sum()) == len(on.grid.cells) * \
        on.grid.n_events
    for f in off.raw._fields:
        if f in ("telemetry", "faults"):
            continue
        assert torch.equal(getattr(off.raw, f), getattr(on.raw, f)), f
    for name in tf.FaultState._fields:
        assert torch.equal(getattr(off.raw.faults, name),
                           getattr(on.raw.faults, name))


@pytest.mark.parametrize("guard", [False, True])
def test_corruption_with_and_without_the_guard(guard, problems, grids):
    """The non-finite guard is the difference between a poisoned iterate
    and a counted skip, as in the reference."""
    spec = dict(p_corrupt=0.3, seed=1, guard_nonfinite=guard)
    got = _run(tapi, "piag", "batched", problems, grids, tf.FaultSpec(**spec))
    finite = bool(torch.isfinite(got.raw.objective).all())
    counters = tf.summarize_faults(got.raw.faults)
    if guard:
        assert finite and counters["rejected_nonfinite"] > 0
        assert counters["rejected_nonfinite"] == counters["injected"]
    else:
        assert not finite and counters["rejected_nonfinite"] == 0
    codes = tf.update_fault_codes(tf.FaultSpec(**spec), N_EVENTS,
                                  [c.seed for c in got.grid.cells], "cpu")
    assert counters["injected"] == int((codes == 3).sum())


def test_fused_engine_refuses_faults(problems, grids):
    with pytest.raises(ValueError, match="fused"):
        tapi.component_spec("piag", "batched", problem=problems[1],
                            grid=grids["worker"][1], prox=L1(lam=0.1),
                            engine="fused", faults=tf.FaultSpec(p_drop=0.1))
    with pytest.raises(dataclasses.FrozenInstanceError):
        tf.FaultSpec().seed = 1
