"""The port's package namespaces against the reference's, and its config
registry.

Every name in the ``__all__`` of the reference's ``core``, ``sweep``,
``federated``, ``api``, ``models``, ``serving`` and ``configs`` either
resolves in the port's package of the same name or is listed in
``UNPORTED`` under the numbered ROADMAP queue A item that will bring it.
A name that resolves must not also be listed.  ``get_config`` matches the
reference field by field for every architecture, except the port's
deliberate ``attention_impl`` default; and importing every module of the
port loads neither JAX nor the reference.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import sweep as jsweep
from repro.federated.server import local_prox_sgd as j_local_prox_sgd
from repro_torch import configs as tconfigs
from repro_torch.core.problems import make_logreg
from repro_torch.core.prox import L1
from repro_torch.federated.server import local_prox_sgd
from repro_torch.sweep import runners as trun

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("core", "sweep", "federated", "api", "models", "serving",
            "configs")

# name -> the ROADMAP queue A item that ports it
_ITEMS = {
    "item 5 (Async-BCD)": [
        "core.BCDResult", "core.bcd", "core.bcd_scan", "core.run_async_bcd",
        "core.run_bcd_logreg", "core.sample_blocks",
        "core.simulate_shared_memory", "sweep.make_sweep_bcd",
        "sweep.sweep_bcd", "sweep.sweep_bcd_logreg"],
    "item 6 residue (sweep.cache)": [
        "sweep.clear_program_cache", "sweep.program_cache_stats"],
    "item 12 (mesh + sweep.shard)": [
        "sweep.cell_mesh", "sweep.grid_mesh", "sweep.mesh_topology",
        "sweep.make_sharded_sweep_bcd", "sweep.make_sharded_sweep_piag",
        "sweep.round_robin_pad", "sweep.shard_cells",
        "sweep.sharded_sweep_bcd", "sweep.sharded_sweep_fedasync",
        "sweep.sharded_sweep_fedbuff", "sweep.sharded_sweep_piag",
        "sweep.sharded_sweep_piag_logreg"],
    "item 13 (threaded runtimes, theory, remaining core)": [
        "core.AsyncOptState", "core.AsyncSGD", "core.async_sgd",
        "core.DELAY_MODELS", "core.DelayTracker", "core.delay",
        "core.make_delays", "core.PIAGServer", "core.RunLog",
        "core.SharedMemoryBCD", "core.runtime", "core.Quadratic",
        "core.run_piag_lipschitz", "core.check_principle", "core.example1",
        "core.example1_divergence_threshold", "core.prop1_lower_bounds",
        "core.verify_theorem1", "core.theory"],
    "item 14c (trainers, the other model families)": ["models.loss_fn"],
    "item 15 (XLA/TPU tooling: dry-run)": [
        "models.param_specs", "configs.SHAPES", "configs.InputShape",
        "configs.applicable", "configs.input_specs"],
}
UNPORTED = {name: item for item, names in _ITEMS.items() for name in names}


def _reference_names():
    for pkg in PACKAGES:
        ref = importlib.import_module(f"repro.{pkg}")
        for name in ref.__all__:
            yield pkg, name


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_reference_name_resolves_or_names_its_item(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref = importlib.import_module(f"repro.{pkg}")
    missing, listed_but_present = [], []
    for name in ref.__all__:
        key = f"{pkg}.{name}"
        present = hasattr(port, name)
        if not present and key not in UNPORTED:
            missing.append(name)
        if present and key in UNPORTED:
            listed_but_present.append(name)
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    assert not listed_but_present, (
        f"repro_torch.{pkg} has {listed_but_present}; drop them from "
        "UNPORTED")


def test_unported_list_names_only_reference_names():
    names = {f"{p}.{n}" for p, n in _reference_names()}
    assert set(UNPORTED) <= names, sorted(set(UNPORTED) - names)


@pytest.fixture(scope="module")
def fresh_import():
    """One fresh interpreter: first the names whose absence ROADMAP queue C
    logged at re-anchor (``repro_torch.api`` before any submodule import,
    so only the package's lazy ``__getattr__`` can supply it), then every
    module of the port, then what of JAX or the reference got loaded."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "try:\n"
        "    import repro_torch; repro_torch.api.run\n"
        "    from repro_torch.core import (make_policy, run_piag, "
        "trace_scan, make_logreg)\n"
        "    from repro_torch.sweep import (sweep_piag, make_grid, "
        "SweepGrid, make_sweep_fedasync)\n"
        "    queue_c = 'ok'\n"
        "except Exception as e:\n"
        "    queue_c = repr(e)\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'queue_c': queue_c, 'mods': len(mods), "
        "'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_queue_c_fault_is_repaired(fresh_import):
    """The names whose absence ROADMAP queue C logged at re-anchor."""
    assert fresh_import["queue_c"] == "ok", fresh_import["queue_c"]


def test_every_port_module_imports_without_jax_or_the_reference(
        fresh_import):
    assert fresh_import["bad"] == [] and fresh_import["mods"] >= 40, \
        fresh_import


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_get_config_matches_reference(arch):
    """Field by field, dtypes as the same strings; the one deliberate
    difference is the default ``attention_impl`` (the port's kernel)."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    j = dataclasses.asdict(jconfigs.get_config(arch))
    t = dataclasses.asdict(tconfigs.get_config(arch))
    assert j.pop("attention_impl") == "chunked"
    assert t.pop("attention_impl") == "pallas"
    assert t == j
    jr = dataclasses.asdict(jconfigs.get_config(arch).reduced())
    tr = dataclasses.asdict(tconfigs.get_config(arch).reduced())
    jr.pop("attention_impl"), tr.pop("attention_impl")
    assert tr == jr


def test_validate_raises_where_the_reference_asserts():
    from repro_torch.models.config import ModelConfig
    with pytest.raises(ValueError, match="GQA group"):
        ModelConfig(n_heads=4, n_kv_heads=3).validate()
    with pytest.raises(ValueError, match="encoder-only"):
        ModelConfig(causal=False).validate()
    assert ModelConfig().pdtype == torch.float32
    assert tconfigs.get_config("qwen2.5-32b").cdtype == torch.bfloat16


def test_make_sweep_fedasync_matches_reference_program():
    """The events-driven builder: the port's heapq-stacked events through
    ``make_sweep_fedasync`` against the reference's builder on its own
    stacked events -- the events exact, taus / versions / clipped exact,
    weights bitwise, the objective within 1e-6 of its start."""
    import jax.numpy as jnp
    from repro.core.problems import make_logreg as j_make_logreg
    from repro.core.prox import L1 as JL1
    from repro.core.stepsize import HingeWeight as JHinge
    from repro.federated.events import heterogeneous_clients as j_clients
    from repro.sweep.runners import _stack_fed_events as j_stack
    from repro_torch.core.stepsize import HingeWeight
    from repro_torch.federated.events import heterogeneous_clients
    from repro_torch.sweep import grid as tgrid

    jprob = j_make_logreg(240, 40, n_workers=4, seed=0)
    tprob = make_logreg(240, 40, n_workers=4, seed=0, device="cpu")
    jgrid = jsweep.make_grid({"hinge": JHinge(gamma_prime=0.6)}, [0, 1],
                             {"edge": j_clients(4, seed=1)}, 60)
    tgr = tgrid.make_grid({"hinge": HingeWeight(gamma_prime=0.6)}, [0, 1],
                          {"edge": heterogeneous_clients(4, seed=1)}, 60)
    j_ev = j_stack(jgrid, 1)
    t_ev = trun._stack_fed_events(tgr, 1, device="cpu")
    for a, b in zip(j_ev, t_ev):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    lr = 0.5 / float(tprob.L)
    j_upd = j_local_prox_sgd(jprob.worker_loss, JL1(lam=jprob.lam1), lr)
    t_upd = local_prox_sgd(tprob.worker_loss, L1(lam=tprob.lam1), lr,
                           grad_fn=tprob.worker_grads())
    jfn = jsweep.make_sweep_fedasync(j_upd, jnp.zeros(40),
                                     jprob.worker_slices(),
                                     objective=jprob.P, horizon=64)
    tfn = trun.make_sweep_fedasync(t_upd, torch.zeros(40),
                                   tprob.worker_slices(), objective=tprob.P,
                                   horizon=64, engine="scan")
    jres = jfn(j_ev, jgrid.policy_params())
    tres = tfn(t_ev, tgr.policy_params("cpu"))
    for f in ("taus", "versions", "clipped"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      getattr(tres, f).numpy())
    np.testing.assert_array_equal(np.asarray(jres.weights),
                                  tres.weights.numpy())
    jo, to = np.asarray(jres.objective), tres.objective.numpy()
    assert np.abs(jo - to).max() <= 1e-6 * np.abs(jo[:, :1]).max()
