"""``REPRO_CACHE_CHECK`` in the port's program cache
(``repro_torch.sweep.cache``): the five cases of
``tests/test_cache_check.py``, on numpy arrays and on tensors, and the
check on a real sweep program's captured tensors."""
import numpy as np
import pytest
import torch

from repro_torch.core.problems import make_logreg
from repro_torch.core.prox import L1
from repro_torch.core.stepsize import Adaptive1
from repro_torch.core.engine import WorkerModel
from repro_torch.mesh import cell_mesh, grid_mesh
from repro_torch.sweep import cache, make_grid, sharded_sweep_piag, sweep_piag


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_cache():
    cache.clear_program_cache()
    yield
    cache.clear_program_cache()


def _program(key):
    return cache.cached_program(key, lambda: "program")


ARRAYS = {"numpy": lambda shape: np.ones(shape),
          "tensor": lambda shape: torch.ones(shape),
          "bf16": lambda shape: torch.ones(shape, dtype=torch.bfloat16)}


@pytest.mark.parametrize("kind", sorted(ARRAYS))
def test_mutated_capture_raises_on_hit(clean_cache, monkeypatch, kind):
    monkeypatch.setenv("REPRO_CACHE_CHECK", "1")
    data = ARRAYS[kind](16)
    key = ("tag", 3, cache.IdKey(data))
    assert _program(key) == "program"
    assert _program(key) == "program"  # unchanged: the hit checks silently
    data[0] = 42.0  # in-place mutation after capture
    with pytest.raises(RuntimeError, match="REPRO_CACHE_CHECK"):
        _program(key)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_tree_key_captures_are_fingerprinted(clean_cache, monkeypatch, kind):
    monkeypatch.setenv("REPRO_CACHE_CHECK", "1")
    x = ARRAYS[kind]((4, 2))
    key = ("tag",) + cache.tree_key((x,))
    _program(key)
    x.fill_(7.0) if kind == "tensor" else x.fill(7.0)
    with pytest.raises(RuntimeError, match="mutated in place"):
        _program(key)


def test_big_captures_are_sampled_and_still_checked(clean_cache,
                                                    monkeypatch):
    """Past 65 536 elements the fingerprint hashes a strided sample: a
    mutation of a sampled element raises."""
    monkeypatch.setenv("REPRO_CACHE_CHECK", "1")
    data = torch.zeros(200_000)
    key = ("tag", cache.IdKey(data))
    _program(key)
    data[0] = 1.0
    with pytest.raises(RuntimeError, match="key\\[1\\]"):
        _program(key)


def test_disabled_by_default_is_silent(clean_cache, monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_CHECK", raising=False)
    data = torch.ones(8)
    key = ("tag", cache.IdKey(data))
    _program(key)
    data[0] = 5.0
    assert _program(key) == "program"  # the documented stale-reuse contract
    assert not cache._FINGERPRINTS  # off: nothing is hashed or kept


def test_clear_program_cache_resets_fingerprints(clean_cache, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_CHECK", "1")
    data = torch.ones(8)
    key = ("tag", cache.IdKey(data))
    _program(key)
    data[0] = 5.0
    cache.clear_program_cache()  # the sanctioned intentional-mutation path
    assert _program(key) == "program"


def test_eviction_prunes_fingerprints(monkeypatch):
    evicted = []
    lru = cache.LRU(1, on_evict=evicted.append)
    lru.get("a", lambda: 1)
    lru.get("b", lambda: 2)
    assert evicted == ["a"]
    assert list(lru.data) == ["b"]
    # the program cache's own LRU drops an evicted key's fingerprints
    monkeypatch.setenv("REPRO_CACHE_CHECK", "1")
    cache.clear_program_cache()
    monkeypatch.setattr(cache._PROGRAMS, "maxsize", 1)
    first = ("tag", cache.IdKey(torch.ones(2)))
    _program(first)
    _program(("tag", cache.IdKey(torch.ones(3))))
    assert first not in cache._FINGERPRINTS and len(cache._FINGERPRINTS) == 1
    cache.clear_program_cache()


def test_sweep_programs_check_their_captured_tensors(clean_cache,
                                                     monkeypatch):
    """A batched and a sharded sweep's programs capture ``x0`` and the
    worker data by identity: under the check a rerun after mutating the
    worker data in place raises instead of serving the old program."""
    monkeypatch.setenv("REPRO_CACHE_CHECK", "1")
    prob = make_logreg(64, 6, n_workers=4, seed=0, device="cpu")
    grid = make_grid({"a1": Adaptive1(gamma_prime=0.99 / prob.L)}, [0, 1],
                     {"u": [WorkerModel() for _ in range(4)]}, n_events=8)
    x0 = torch.zeros(prob.dim)
    Aw, bw = prob.worker_slices()
    wd = (Aw.clone(), bw.clone())
    prox = L1(lam=prob.lam1)
    loss = prob.worker_loss  # one bound-method object: one key
    runs = (lambda: sweep_piag(loss, x0, wd, grid, prox),
            lambda: sharded_sweep_piag(loss, x0, wd, grid, prox,
                                       mesh=cell_mesh(["cpu"])))
    for run in runs:
        run()
        run()
    wd[0][0, 0, 0] += 1.0
    for run in runs:
        with pytest.raises(RuntimeError, match="REPRO_CACHE_CHECK"):
            run()


def test_sharded_keys_follow_topology_not_identity(clean_cache):
    """Sharded program keys differ between a 1-D and a 2-D mesh of the
    same devices and agree across meshes of equal topology (a fresh mesh
    object hits); each row's program key ends in its devices."""
    prob = make_logreg(64, 6, n_workers=4, seed=0, device="cpu")
    grid = make_grid({"a1": Adaptive1(gamma_prime=0.99 / prob.L)}, [0, 1],
                     {"u": [WorkerModel() for _ in range(4)]}, n_events=8)
    x0, wd, prox = torch.zeros(prob.dim), prob.worker_slices(), L1(lam=0.0)
    loss = prob.worker_loss
    keys = []
    for mesh in (cell_mesh(["cpu"] * 2), grid_mesh((1, 2), ["cpu"] * 2),
                 cell_mesh(["cpu"] * 2)):
        sharded_sweep_piag(loss, x0, wd, grid, prox, mesh=mesh)
        keys.append(list(cache._PROGRAMS.data))
    assert len(keys[0]) == 1 and len(keys[1]) == 2
    assert set(keys[2]) == set(keys[1])  # the fresh 1-D mesh hit
    one_d, two_d = keys[1]
    assert one_d[:9] == two_d[:9] and one_d[10:-1] == two_d[10:-1]
    assert one_d[9] == ("mesh", ("cells",), (2,), "cpu", 1)
    assert two_d[9] == ("mesh", ("cells", "data"), (1, 2), "cpu", 1)
    assert one_d[-1] == ("cpu",) and two_d[-1] == ("cpu", "cpu")
    stats = cache.program_cache_stats()
    assert stats["misses"] == 2 and stats["hits"] == 3  # rows share
