"""The port's dynamic static-analysis layers on the CPU: op traces
(``repro_torch.staticcheck.optrace``), the contracts, cache-key
completeness, and the ``sweep.cache`` capture hook they stand on.

The reference's dynamic layers do not import under this JAX (its
``staticcheck.jaxpr`` imports ``jax.core.ClosedJaxpr``), so these layers
are held to the reference's contracts as written: the same checks, the
same violation predicate, the same registry (every field of both
packages' spec family), the same seeded-mutation self-test.  Specs are
tiny (logistic regression 40 x 8 over 4 workers for the contracts, the
reference's 48 x 6 base for the cache keys, 12 events).
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro.api import spec as ref_spec
from repro.faults.spec import FaultSpec as RefFaultSpec
from repro.sweep import cache as ref_cache
from repro.telemetry.accumulators import TelemetryConfig as RefTelemetry
from repro_torch.api import spec as port_spec
from repro_torch.staticcheck import cachekey as ck
from repro_torch.staticcheck import contracts
from repro_torch.staticcheck import optrace as ot
from repro_torch.sweep import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SMALL = contracts.Problem(n_samples=40, dim=8, n_workers=4, n_events=12)


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ optrace ----

def _program(x, w, shift: float = 1.0):
    y = torch.nn.functional.relu(x @ w) + shift
    y.mul_(2.0)
    return y.sum(dim=1), y


def _trace(seed: int, shift: float = 1.0):
    g = torch.Generator().manual_seed(seed)
    x, w = torch.randn(5, 4, generator=g), torch.randn(4, 3, generator=g)
    return ot.record(_program, x, w, shift=shift)[1]


def test_optrace_canonicalises_two_runs_alike():
    """Two runs on other values (other tensors, other addresses) give one
    text; the inputs, each op and the outputs are named by first
    appearance, with dtype, shape and device type."""
    a, b = _trace(0), _trace(1)
    assert ot.canonical_lines(a) == ot.canonical_lines(b)
    assert ot.fingerprint(a) == ot.fingerprint(b)
    assert ot.diff(a, b) == ""
    ot.assert_identical(a, b)
    assert a.lines[0] == "in  (t0:f32[5,4]@cpu, t1:f32[4,3]@cpu)"
    assert a.lines[-1] == "out (t5:f32[5]@cpu, t4:f32[5,3]@cpu)"
    assert any("aten.mm.default(t0:f32[5,4]@cpu, t1:f32[4,3]@cpu)" in ln
               for ln in a.lines)
    # the in-place op keeps its tensor's name
    assert "t4:f32[5,3]@cpu = aten.mul_.Tensor(t4:f32[5,3]@cpu, 2.0)" \
        in a.lines
    assert ot.io_shapes(a) == (("f32[5,4]@cpu", "f32[4,3]@cpu"),
                               ("f32[5]@cpu", "f32[5,3]@cpu"))
    assert a.launches == {}


def test_optrace_separates_a_changed_op():
    """A changed scalar is a changed op; the diff names it."""
    a, b = _trace(0), _trace(0, shift=2.0)
    assert ot.fingerprint(a) != ot.fingerprint(b)
    d = ot.diff(a, b, "shift 1", "shift 2")
    assert "-" in d and "2.0" in d
    with pytest.raises(AssertionError, match="canonical op traces differ"):
        ot.assert_identical(a, b)


def test_optrace_counts_launches_in_place(monkeypatch):
    """A kernel launch, invisible to the dispatch mode, becomes a
    ``launch`` line where its wrapper's counter moved."""
    from repro_torch.kernels import fused_step

    def fake_kernel(x):
        y = x + 1.0
        fused_step.fused_policy_prox_step.launches += 1
        return y * 2.0

    monkeypatch.setattr(fused_step.fused_policy_prox_step, "launches", 0)
    _, t = ot.record(fake_kernel, torch.zeros(3))
    assert t.launches == {"fused_policy_prox_step": 1}
    assert t.lines[1].endswith("aten.add.Tensor(t0:f32[3]@cpu, 1.0)")
    assert t.lines[2] == "launch fused_policy_prox_step"


# ------------------------------------------------------ capture hook ----

def test_capture_hook_bypasses_and_restores_the_cache():
    """As the reference's: ``None`` by default, returns the previous hook,
    and while installed ``cached_program`` returns ``hook(key, build)``
    without touching the LRU or REPRO_CACHE_CHECK."""
    assert cache._CAPTURE_HOOK is None
    cache.clear_program_cache()
    seen = []

    def hook(key, build):
        seen.append(key)
        return ("hooked", build())

    assert cache.set_capture_hook(hook) is None
    try:
        out = cache.cached_program(("k", 1), lambda: "built")
        assert out == ("hooked", "built") and seen == [("k", 1)]
        assert cache.program_cache_stats()["size"] == 0
        assert cache.program_cache_stats()["misses"] == 0
    finally:
        assert cache.set_capture_hook(None) is hook
    assert cache._CAPTURE_HOOK is None
    assert cache.cached_program(("k", 1), lambda: "built") == "built"
    assert cache.program_cache_stats()["size"] == 1
    cache.clear_program_cache()


def test_capture_hook_matches_the_reference_seam():
    assert "set_capture_hook" in cache.__all__
    assert ref_cache._CAPTURE_HOOK is None and cache._CAPTURE_HOOK is None
    prev = ref_cache.set_capture_hook(lambda k, b: None)
    assert ref_cache.set_capture_hook(prev) is not None


# --------------------------------------------------------- contracts ----

@pytest.mark.parametrize("solver", contracts.SOLVERS)
def test_contracts_hold_on_the_cpu(solver):
    """Scan level, and program level under the batched backend and the
    one-device sharded backend; on the CPU the fused engine runs the
    kernels' plain versions, so nothing launches."""
    checks = (contracts.verify_scan_level((solver,), CPU, SMALL)
              + contracts.verify_program_level((solver,),
                                               ("batched", "sharded"), CPU,
                                               SMALL))
    failed = [c for c in checks if not c.ok]
    assert not failed, "\n".join(f"{c.name}: {c.detail[:2000]}"
                                 for c in failed)
    names = {c.name for c in checks}
    assert {n.rsplit("/", 1)[-1] for n in names if n.startswith("scan/")} \
        == {"explicit-none-is-omitted", "disabled-faults-are-none",
            "faults-live", "telemetry-live", "fused-scan-io-parity",
            "fused-is-a-different-body", "fused-launches"}
    for b in ("batched", "sharded"):
        assert {n.rsplit("/", 1)[-1] for n in names
                if n.startswith(f"{b}/")} == {
            "disabled-faults-are-none", "faults-live", "telemetry-live",
            "fused-scan-io-parity", "fused-launches"}
    assert all(c.launches == {} for c in checks)


def test_a_dead_knob_fails_its_contract(monkeypatch):
    """If telemetry stopped reaching the program, ``telemetry-live``
    fails: the checks are not vacuous."""
    real = contracts._scan_caller

    def deaf(solver, problem, pb):
        call = real(solver, problem, pb)
        return lambda **kw: call(**{k: v for k, v in kw.items()
                                    if k != "telemetry"})

    monkeypatch.setattr(contracts, "_scan_caller", deaf)
    checks = contracts.verify_scan_level(("piag",), CPU, SMALL)
    bad = {c.name for c in checks if not c.ok}
    assert bad == {"scan/piag/telemetry-live"}


# ------------------------------------------------------- cache keys ----

def test_registry_covers_both_spec_families():
    """Every field of the port's and of the reference's spec family (the
    port's one field more, ``ExecutionSpec.device``, included), of
    ``FaultSpec`` and of ``TelemetryConfig`` has a Perturb or a Skip."""
    assert ck.unregistered_fields() == []
    ref_classes = tuple(ref_spec.SPEC_FAMILY) + (RefFaultSpec, RefTelemetry)
    assert ck.unregistered_fields(ref_classes) == []
    assert ("ExecutionSpec", "device") in ck.REGISTRY
    port_fields = {(c.__name__, f.name) for c in port_spec.SPEC_FAMILY
                   for f in dataclasses.fields(c)}
    ref_fields = {(c.__name__, f.name) for c in ref_spec.SPEC_FAMILY
                  for f in dataclasses.fields(c)}
    assert port_fields - ref_fields == {("ExecutionSpec", "device")}


def test_forcing_function_flags_missing_entry(monkeypatch):
    pruned = {k: v for k, v in ck.REGISTRY.items()
              if k != ("FaultSpec", "p_drop")}
    monkeypatch.setattr(ck, "REGISTRY", pruned)
    assert ("FaultSpec", "p_drop") in ck.unregistered_fields()
    with pytest.raises(AssertionError, match="no cache-key coverage"):
        ck.check_completeness(CPU)


def test_capture_returns_key_and_trace():
    a = ck.capture(ck.BASES["piag"](CPU))
    b = ck.capture(ck.BASES["piag"](CPU))
    assert a is not None and a.key[0] == "piag"
    assert a.fingerprint and a.in_shapes and a.lines
    assert a.key == b.key and a.trace_equal(b)
    solo = ck.base_spec("piag", CPU, execution=port_spec.ExecutionSpec(
        backend="solo", device=CPU))
    assert ck.capture(solo) is None   # builds fresh per call
    assert cache._CAPTURE_HOOK is None


def test_completeness_finds_no_violation():
    outcomes = ck.check_completeness(CPU)
    violations = [o for o in outcomes if o.violation]
    assert not violations, violations
    assert len(outcomes) == len(ck.REGISTRY)
    status = {(o.cls, o.field): o.status for o in outcomes}
    assert status[("SolverSpec", "horizon")] == "key-changed"
    assert status[("ExecutionSpec", "engine")] == "key-changed"
    assert status[("ExperimentSpec", "n_events")] == "shape-retrace"
    assert status[("ExecutionSpec", "backend")] == "uncached"
    assert status[("TopologySpec", "seed")] == "value-only"


def _drop_horizon(key: tuple) -> tuple:
    """The seeded mutation: a PIAG bucket key without its horizon (the
    element after tag, width and mask flag)."""
    return key[:3] + key[4:]


def test_seeded_key_mutation_is_caught():
    """The self-test the checker's value rests on: a key filter that drops
    a knob the trace depends on (the horizon; faults) MUST surface a
    VIOLATION."""
    for field, mutation in ((("SolverSpec", "horizon"), _drop_horizon),
                            (("FaultSpec", "staleness_cutoff"),
                             ck.strip_faults_from_key)):
        clean = ck.check_completeness(CPU, only=[field])
        assert [o.status for o in clean] == ["key-changed"]
        mutated = ck.check_completeness(CPU, key_filter=mutation,
                                        only=[field])
        assert [o.status for o in mutated] == ["VIOLATION"], mutated


def test_retrace_budget_holds():
    distinct, errors = ck.check_retrace_budget(CPU)
    assert not errors, errors
    assert distinct == ck.RETRACE_BUDGET


def test_gate_refuses_to_run_without_a_card():
    """``python -m repro_torch.staticcheck`` defaults to the card and
    raises without one -- it never carries on on the CPU unasked."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.staticcheck"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the gate runs on it")
    assert out.returncode != 0
    assert "none is available" in out.stderr
    assert "== lint" not in out.stdout
