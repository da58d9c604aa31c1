"""The port's telemetry (``repro_torch.telemetry``), program cache
(``repro_torch.sweep.cache``) and run ledger against the reference's.

Accumulators: the same (tau, gamma, clip) streams go through the
reference's jitted ``observe`` scan and the port's (B,)-batched one.  The
histogram (with its overflow bin), counts, min/max and window clips are
exact; the Welford moments are bitwise (both packages contract ``m2 +
d*(v - mean)`` into one FMA).  Through the four solvers: telemetry-on
solver leaves are bitwise the telemetry-off ones (port, all four solvers,
solo and batched, scan and fused), and the finalized aggregates equal the
reference's on the same spec.  Fingerprints: a value-equal spec hashes to
the reference's 12 hex digits.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import telemetry as jtel
from repro.sweep import cache as jcache
from repro_torch import api as tapi
from repro_torch import telemetry as ttel
from repro_torch.sweep import cache as tcache

EXACT_GAMMA = ("adaptive1", "adaptive2", "fixed", "naive", "constant")
# gammas of the form a * b: the reference's solo program contracts them
# into the moments' first subtraction (ROADMAP queue C)
PRODUCT_FORM = ("adaptive1", "hinge", "poly")
GAMMA_MOMENT_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- accumulators ----

def _streams(B, K, seed, tau_hi=90):
    rng = np.random.default_rng(seed)
    tau = rng.integers(0, tau_hi, (B, K)).astype(np.int32)
    gam = rng.lognormal(-3, 1.5, (B, K)).astype(np.float32)
    clip = (rng.random((B, K)) < 0.1).astype(np.int32)
    return tau, gam, clip


def _reference_accumulate(cfg, tau, gam, clip, every):
    def cell(t, g, c):
        def step(carry, e):
            s, k = carry
            s = jtel.observe(s, e[0], e[1], e[2])
            emit = (k + 1) % every == 0
            s2, wc = jtel.emit_window(s)
            s = jax.tree_util.tree_map(lambda a, b: jnp.where(emit, a, b),
                                       s2, s)
            return (s, k + 1), jnp.where(emit, wc, -1)
        (s, _), wc = jax.lax.scan(step, (jtel.init_telemetry(cfg),
                                         jnp.int32(0)), (t, g, c))
        return s, wc
    s, wc = jax.jit(jax.vmap(cell))(jnp.asarray(tau), jnp.asarray(gam),
                                    jnp.asarray(clip))
    wc = np.asarray(wc)
    return jtel.finalize(s, wc[wc >= 0].reshape(tau.shape[0], -1))


def _port_accumulate(cfg, tau, gam, clip, every):
    B, K = tau.shape
    s = ttel.init_telemetry(cfg, (B,), "cpu")
    wcs = []
    for k in range(K):
        s = ttel.observe(s, torch.from_numpy(tau[:, k]),
                         torch.from_numpy(gam[:, k]),
                         torch.from_numpy(clip[:, k]))
        if (k + 1) % every == 0:
            s, wc = ttel.emit_window(s)
            wcs.append(wc)
    return ttel.finalize(s, torch.stack(wcs, dim=1))


@pytest.mark.parametrize("bins, every, tau_hi", [(64, 1, 90), (8, 4, 40),
                                                 (2, 5, 3), (128, 10, 90)])
def test_accumulators_match_reference(bins, every, tau_hi):
    cfg_j, cfg_t = jtel.TelemetryConfig(bins), ttel.TelemetryConfig(bins)
    tau, gam, clip = _streams(5, 200, bins + every, tau_hi)
    ref = _reference_accumulate(cfg_j, tau, gam, clip, every)
    got = _port_accumulate(cfg_t, tau, gam, clip, every)
    assert got._fields == ref._fields
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert np.all(got.hist.numpy().sum(axis=1) == 200)
    assert ttel.summarize_telemetry(got) == jtel.summarize_telemetry(ref)


def test_telemetry_config_matches_reference():
    assert repr(ttel.TelemetryConfig()) == repr(jtel.TelemetryConfig())
    with pytest.raises(ValueError, match="delay_bins"):
        ttel.TelemetryConfig(delay_bins=1)
    fresh = ttel.init_telemetry(ttel.TelemetryConfig(4), (3,), "cpu")
    ref = jtel.init_telemetry(jtel.TelemetryConfig(4))
    for f in ("hist", "count", "tau_min", "tau_max", "tau_mean", "tau_m2",
              "g_min", "g_max", "g_mean", "g_m2", "win_clip"):
        np.testing.assert_array_equal(getattr(fresh, f)[0].numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


# --------------------------------------------------------- solvers ----

def _spec(mod, solver, backend, engine, telemetry, **ex):
    fed = solver in ("fedasync", "fedbuff")
    if fed:
        topo = mod.TopologySpec(kind="edge", n_workers=(4, 6)
                                if backend == "batched" else (4,), seed=1,
                                params=dict(spread=4.0, p_dropout=0.1))
        pols = mod.PolicyGridSpec(names=("hinge", "constant"), seeds=(3,),
                                  policy_kwargs={"hinge": dict(a=0.5, b=4.0)})
    else:
        topo = mod.TopologySpec(names=("uniform", "straggler"),
                                n_workers=(3, 4) if backend == "batched"
                                else (4,))
        pols = mod.PolicyGridSpec(names=("adaptive1", "fixed", "hinge"),
                                  seeds=(0,) if backend == "solo" else (0, 1))
    return mod.ExperimentSpec(
        problem=mod.ProblemSpec(kind="logreg",
                                params=dict(n_samples=200, dim=30)),
        solver=mod.SolverSpec(name=solver, horizon="auto", eta=0.4, m=7,
                              buffer_size=3 if solver == "fedbuff" else 1),
        topology=topo, policies=pols,
        execution=mod.ExecutionSpec(backend=backend, engine=engine,
                                    record_every=4, telemetry=telemetry,
                                    telemetry_bins=16, **ex),
        n_events=32)


SOLVERS = ("piag", "bcd", "fedasync", "fedbuff")


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("backend", ["solo", "batched"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_telemetry_is_bitwise_neutral(solver, backend, engine):
    off = tapi.run(_spec(tapi, solver, backend, engine, False, device="cpu"))
    on = tapi.run(_spec(tapi, solver, backend, engine, True, device="cpu"))
    assert off.raw.telemetry is None and on.raw.telemetry is not None
    for f in off.raw._fields:
        if f in ("telemetry", "faults"):
            continue
        a, b = getattr(off.raw, f), getattr(on.raw, f)
        assert torch.equal(a, b), f"{solver}/{backend}/{engine}/{f}"
    tel = on.raw.telemetry
    assert torch.all(tel.hist.sum(dim=1) == on.n_events)
    assert torch.all(tel.count == on.n_events)
    assert on.telemetry.hist_source == "accumulator"
    assert off.telemetry.hist_source == "recorded"
    assert sum(on.telemetry.delay_hist) == on.n_cells * on.n_events


@pytest.mark.parametrize("backend", ["solo", "batched"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_telemetry_matches_reference(solver, backend):
    """The finalized aggregates of a run against the reference's on the
    value-equal spec: integer leaves exact; tau moments bitwise; gamma
    moments bitwise where the gammas are (the exact policies), except the
    product-form gammas of a solo run (ROADMAP queue C: the reference
    contracts ``alpha*budget - mean`` there), else within GAMMA_MOMENT_REL;
    the run record's histogram and fingerprint."""
    ref = japi.run(_spec(japi, solver, backend, "scan", True))
    got = tapi.run(_spec(tapi, solver, backend, "scan", True, device="cpu"))
    rt, gt = ref.raw.telemetry, got.raw.telemetry
    for f in ("hist", "count", "tau_min", "tau_max", "tau_mean", "tau_m2",
              "window_clips"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(rt, f)), err_msg=f)
    names = [c.policy_name for c in got.cells]
    exact = np.isin(names, EXACT_GAMMA)
    moments_exact = exact & ~(np.isin(names, PRODUCT_FORM)
                              & (backend == "solo"))
    for f in ("gamma_min", "gamma_max", "gamma_mean", "gamma_m2"):
        a, b = getattr(gt, f).numpy(), np.asarray(getattr(rt, f))
        keep = exact if f in ("gamma_min", "gamma_max") else moments_exact
        np.testing.assert_array_equal(a[keep], b[keep], err_msg=f)
        assert np.all(np.abs(a - b) <= GAMMA_MOMENT_REL * np.abs(b)), f
    rec_t, rec_j = got.telemetry, ref.telemetry
    for f in ("fingerprint", "solver", "backend", "n_cells", "n_events",
              "record_every", "horizon", "tau_bar", "devices", "mesh_shape",
              "carry_bytes", "delay_hist", "hist_source", "clipped",
              "policies", "faults"):
        assert getattr(rec_t, f) == getattr(rec_j, f), f
    assert rec_t.tau_stats == rec_j.tau_stats
    assert set(rec_t.cache) == set(rec_j.cache)


def test_recorded_histogram_matches_reference_when_off():
    ref = japi.run(_spec(japi, "piag", "batched", "scan", False))
    got = tapi.run(_spec(tapi, "piag", "batched", "scan", False,
                         device="cpu"))
    assert got.telemetry.hist_source == ref.telemetry.hist_source == \
        "recorded"
    assert got.telemetry.delay_hist == ref.telemetry.delay_hist
    assert got.telemetry.tau_stats == ref.telemetry.tau_stats


# ------------------------------------------------------ fingerprints ----

def _fp_specs(mod):
    """Value-equal declarative specs of every kind the port runs (the
    engine named explicitly: the packages' defaults differ)."""
    base = _spec(mod, "piag", "batched", "fused", False)
    return {
        "piag": base,
        "bcd": _spec(mod, "bcd", "solo", "scan", False),
        "fedasync": _spec(mod, "fedasync", "batched", "fused", False),
        "fedbuff": _spec(mod, "fedbuff", "solo", "scan", False),
        "lasso": base.replace(problem=mod.ProblemSpec(
            kind="lasso", params=dict(n_samples=120, dim=20))),
        "telemetry": _spec(mod, "bcd", "batched", "fused", True),
        "defaults": mod.ExperimentSpec(
            execution=mod.ExecutionSpec(engine="fused")),
    }


@pytest.mark.parametrize("kind", ["piag", "bcd", "fedasync", "fedbuff",
                                  "lasso", "telemetry", "defaults"])
def test_spec_fingerprint_equals_reference(kind):
    t = _fp_specs(tapi)[kind]
    j = _fp_specs(japi)[kind]
    assert ttel.spec_fingerprint(t) == jtel.spec_fingerprint(j)
    # the port-only device field stays out of the digest
    moved = t.replace(execution=dataclasses.replace(t.execution,
                                                    device="cpu"))
    assert ttel.spec_fingerprint(moved) == ttel.spec_fingerprint(t)
    other = t.replace(n_events=t.n_events * 2)
    assert ttel.spec_fingerprint(other) != ttel.spec_fingerprint(t)


def test_component_spec_fingerprint_uses_grid_labels():
    r = tapi.resolve(_spec(tapi, "bcd", "batched", "fused", False,
                           device="cpu"))
    spec = tapi.component_spec("bcd", "batched", problem=r.problem,
                               grid=r.grid, prox=r.prox, m=7)
    want = jtel.spec_fingerprint(
        spec, type("G", (), {"labels": r.grid.labels,
                             "n_events": r.grid.n_events})())
    assert ttel.spec_fingerprint(spec, r.grid) == want


# ---------------------------------------------------- ledger, cache ----

def test_ledger_round_trips_across_packages(tmp_path):
    path = tmp_path / "ledger.jsonl"
    ttel.set_ledger_path(path)
    try:
        res = tapi.run(_spec(tapi, "bcd", "batched", "fused", True,
                             device="cpu"))
    finally:
        ttel.set_ledger_path(None)
    lines = path.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert ttel.RunRecord.from_dict(rec) == res.telemetry
    assert [f.name for f in dataclasses.fields(ttel.RunRecord)] == \
        [f.name for f in dataclasses.fields(jtel.RunRecord)]
    back = jtel.RunRecord.from_dict(next(jtel.read_ledger(path)))
    assert back.fingerprint == res.telemetry.fingerprint
    assert back.delay_hist == res.telemetry.delay_hist
    jtel.append_record(back, tmp_path / "ref.jsonl")
    assert next(ttel.read_ledger(tmp_path / "ref.jsonl")) == \
        json.loads(back.to_json())
    assert ttel.LEDGER_ENV == jtel.LEDGER_ENV
    assert not ttel.append_record(res.telemetry)  # no path: nothing written


def test_cache_delta_is_reset_scoped():
    spec = _spec(tapi, "piag", "batched", "fused", False, device="cpu")
    n = len(tapi.resolve(spec).grid.buckets())
    tcache.clear_program_cache()
    first = tapi.run(spec).cache_stats
    second = tapi.run(spec).cache_stats
    assert first["misses"] == n and first["hits"] == 0
    assert second["hits"] == n and second["misses"] == 0
    assert not second["reset"]
    before = tcache.program_cache_stats()
    tcache.clear_program_cache()
    after = tcache.program_cache_stats()
    delta = ttel.cache_delta(before, after)
    assert delta["reset"] and delta["hits"] == 0 and delta["size"] == 0
    assert delta == jtel.cache_delta(before, after)
    rec = tapi.run(spec).telemetry
    assert rec.compile_ms > 0 and rec.cache["misses"] == n
    names = [ev["name"] for ev in rec.timings]
    assert names.count("program_build") == n
    assert names.count("program_first_call") == n
    assert names.count("bucket_dispatch") == n


@pytest.mark.parametrize("solver", SOLVERS)
def test_cache_key_separates_telemetry_variants(solver):
    """A telemetry-on run after a telemetry-off one of the same spec
    builds its own programs (reuse is pinned by the reset-scope test)."""
    tcache.clear_program_cache()
    off = _spec(tapi, solver, "batched", "fused", False, device="cpu")
    n = len(tapi.resolve(off).grid.buckets())
    first = tapi.run(off)
    assert first.cache_stats["misses"] == n and first.raw.telemetry is None
    on = tapi.run(_spec(tapi, solver, "batched", "fused", True,
                        device="cpu"))
    assert on.cache_stats["misses"] == n and on.cache_stats["hits"] == 0
    assert on.raw.telemetry is not None


def test_lru_and_id_keys_match_reference_semantics():
    for mod in (tcache, jcache):
        lru = mod.LRU(2)
        for k in (1, 2, 1, 3):
            lru.get(k, lambda k=k: k * 10)
        assert (lru.hits, lru.misses, lru.evictions) == (1, 3, 1)
        assert list(lru.data) == [1, 3]
    a = torch.zeros(3)
    assert tcache.IdKey(a) == tcache.IdKey(a)
    assert tcache.IdKey(a) != tcache.IdKey(torch.zeros(3))
    assert tcache.tree_key((a, (a,))) == (tcache.IdKey(a),) * 2
    assert set(tcache.program_cache_stats()) == \
        set(jcache.program_cache_stats())


def test_timing_sink_records_and_drains():
    ttel.drain_timings()
    ttel.record_timing("a", 1.5, key="x")
    with ttel.timed("b", width=4):
        pass
    peek = ttel.peek_timings()
    assert [e["name"] for e in peek] == ["a", "b"]
    assert peek[0] == {"name": "a", "ms": 1.5, "key": "x"}
    assert peek[1]["width"] == 4 and peek[1]["ms"] >= 0.0
    assert ttel.drain_timings() == peek and ttel.peek_timings() == []
    assert ttel.COMPILE_EVENT_NAMES == jtel.COMPILE_EVENT_NAMES


def test_warn_clip_pressure_matches_reference():
    clean = {"cells": 4, "cells_clipped": 0, "events_clipped": 0,
             "max_events_clipped": 0}
    assert ttel.warn_clip_pressure(clean) is None
    hot = dict(clean, cells_clipped=2, events_clipped=7)
    with pytest.warns(RuntimeWarning, match="raise the horizon"):
        msg = ttel.warn_clip_pressure(hot, horizon=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert msg == jtel.warn_clip_pressure(hot, horizon=8)


def test_estimate_carry_bytes_matches_reference():
    for solver in SOLVERS + ("other",):
        assert ttel.estimate_carry_bytes(solver, 784, 10, 256, 96) == \
            jtel.estimate_carry_bytes(solver, 784, 10, 256, 96)
