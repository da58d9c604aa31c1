"""The port's package namespaces against the reference's, and its config
registry.

Every name in the ``__all__`` of the reference's ``core``, ``sweep``,
``federated``, ``api``, ``models``, ``serving``, ``configs``,
``kernels``, ``telemetry``, ``faults``, ``checkpoint``, ``optim``,
``data`` and ``staticcheck`` (and of ``sweep.cache``) either resolves in the port's package of the same name or is
listed in ``UNPORTED`` under the numbered ROADMAP queue A item that will
bring it, or with the reason it has no counterpart; so does every module
of the reference's ``launch``.
A name that resolves must not also be listed.  ``get_config`` matches the
reference field by field for every architecture, except the port's
deliberate ``attention_impl`` default; and importing every module of the
port loads neither JAX nor the reference.
"""
import dataclasses
import importlib
import importlib.util
import json
import os
import pathlib
import pkgutil
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
            "configs", "kernels", "telemetry", "faults", "checkpoint",
            "optim", "data", "staticcheck")

# name -> its counterpart under another name, or why it has none (every
# ROADMAP queue A item that listed names here is ported)
_ITEMS = {
    "counterpart: `launch.op_cost` (torch has no HLO)": [
        "launch.hlo_cost"],
    "no counterpart (the port has no interpreter; kernels.dispatch "
    "resolve_device and kernel_route route by device)": [
        "kernels.default_interpret", "kernels.resolve_interpret"],
    "counterpart: `staticcheck.optrace` (torch has no jaxpr)": [
        "staticcheck.jaxpr"],
}
UNPORTED = {name: item for item, names in _ITEMS.items() for name in names}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_every_sweep_cache_name_resolves():
    """The subpackages' ``__all__`` above does not reach ``sweep.cache``;
    every name of the reference's resolves in the port's
    (``set_capture_hook`` is the seam of ``staticcheck.cachekey``)."""
    from repro.sweep import cache as ref_cache
    from repro_torch.sweep import cache as port_cache
    missing = [n for n in ref_cache.__all__ if not hasattr(port_cache, n)]
    assert not missing, f"repro_torch.sweep.cache lacks {missing}"
    assert set(ref_cache.__all__) <= set(port_cache.__all__)


def _reference_launch_modules():
    return sorted(m.name for m in pkgutil.iter_modules(
        [str(ROOT / "src" / "repro" / "launch")]))


def test_unported_list_names_only_reference_names():
    names = {f"{p}.{n}" for p, n in _reference_names()}
    names |= {f"launch.{m}" for m in _reference_launch_modules()}
    assert set(UNPORTED) <= names, sorted(set(UNPORTED) - names)


def test_every_reference_launch_module_has_a_counterpart_or_its_item():
    """``repro.launch`` has no ``__all__``: its modules are the names.
    Each has a module of the same name in ``repro_torch.launch`` or is
    listed under its item, and not both."""
    for m in _reference_launch_modules():
        present = importlib.util.find_spec(f"repro_torch.launch.{m}") \
            is not None
        assert present != (f"launch.{m}" in UNPORTED), m


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
        "import repro_torch.kernels as k\n"
        "names = [getattr(k, n) for n in k.__all__]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'queue_c': queue_c, 'mods': mods, "
        "'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_queue_c_fault_is_repaired(fresh_import):
    """The names whose absence ROADMAP queue C logged at re-anchor."""
    assert fresh_import["queue_c"] == "ok", fresh_import["queue_c"]


NEW_MODULES = ("repro_torch.kernels.ops", "repro_torch.kernels.ref",
               "repro_torch.kernels.prox_step", "repro_torch.kernels.rmsnorm",
               "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
               "repro_torch.core.runtime", "repro_torch.core.async_sgd",
               "repro_torch.optim.optimizers", "repro_torch.data.synthetic",
               "repro_torch.launch.train_bcd", "repro_torch.launch.steps",
               "repro_torch.models.moe", "repro_torch.launch.train_federated",
               "repro_torch.configs.shapes", "repro_torch.launch.mesh",
               "repro_torch.launch.sharding", "repro_torch.launch.recipes",
               "repro_torch.launch.run_distributed",
               "repro_torch.launch.roofline", "repro_torch.launch.op_cost",
               "repro_torch.launch.dryrun", "repro_torch.launch.perf_probe")


def test_every_port_module_imports_without_jax_or_the_reference(
        fresh_import):
    """Every module, the kernel slice's (``NEW_MODULES``) among them, and
    every lazy name of ``repro_torch.kernels``."""
    mods = fresh_import["mods"]
    assert fresh_import["bad"] == [] and len(mods) >= 45, fresh_import
    assert set(NEW_MODULES) <= set(mods), sorted(set(NEW_MODULES) - set(mods))


@pytest.mark.parametrize("first", ["lazy name", "kernels.ops"])
def test_kernels_module_names_are_modules_in_any_import_order(first):
    """``repro_torch.kernels.prox_step`` and ``.flash_attention`` are the B4
    and B6 modules whether the package's lazy ``__getattr__`` or an import
    of ``kernels.ops`` binds them first, and stay so: a lazily bound
    function of a submodule's name would give the one or the other
    depending on import order."""
    probe = ("kinds += [inspect.ismodule(k.prox_step), "
             "inspect.ismodule(k.flash_attention)]\n")
    ops = "import repro_torch.kernels.ops\n"
    code = ("import inspect, json\nimport repro_torch.kernels as k\n"
            "kinds = []\n" + (probe + ops if first == "lazy name"
                               else ops + probe) + probe
            + "print(json.dumps(kinds))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True] * 4


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
