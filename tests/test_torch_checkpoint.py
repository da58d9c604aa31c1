"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``).

``encode_tree`` / ``decode_tree`` round-trip every result shape a sweep
returns (NamedTuples by class name, nested telemetry and fault tuples,
``None`` leaves, lists and dicts) and put the arrays on the caller's
device; the npz pytree checkpoint round-trips and reads in the other
package.  ``api.run(spec, resume=dir)``: a resumed sweep is bitwise the
uninterrupted one and reruns only the bucket (or solo cell) whose file is
missing; a bucket file written by ``repro`` resumes in ``repro_torch``;
one written by ``repro_torch`` carries the reference's format (its
fingerprint is accepted by ``repro``, and it decodes through the
reference's class registry); a checkpoint of another spec is refused by
both packages.
"""
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import faults as jf
from repro.checkpoint import (SweepCheckpoint as JSweepCheckpoint,
                              load_checkpoint as j_load,
                              save_checkpoint as j_save)
from repro.checkpoint import sweep as jsweepck
from repro.core import (Adaptive1 as JAdaptive1, FixedStepSize as JFixed,
                        L1 as JL1, make_logreg as j_make_logreg)
from repro.core.engine import heterogeneous_workers as j_hetero
from repro.core.stepsize import HingeWeight as JHinge
from repro.federated.events import heterogeneous_clients as j_clients
from repro.sweep import make_grid as j_make_grid
from repro_torch import api as tapi
from repro_torch import faults as tf
from repro_torch.checkpoint import (SweepCheckpoint, decode_tree,
                                    encode_tree, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import sweep as tsweepck
from repro_torch.core import (Adaptive1, FixedStepSize, L1, make_logreg)
from repro_torch.core.engine import heterogeneous_workers
from repro_torch.core.piag import PIAGResult
from repro_torch.core.stepsize import HingeWeight, StepsizeState
from repro_torch.federated.events import heterogeneous_clients
from repro_torch.sweep import make_grid

N_EVENTS = 100
N_EVENTS_FED = 80
CHAOS = dict(p_crash=0.05, p_rejoin=0.3, crash_scale=20.0, p_spike=0.05,
             p_drop=0.05, p_dup=0.05, p_corrupt=0.05, staleness_cutoff=64,
             seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- encode / decode ----

def _tree():
    fs = tf.FaultState(*(torch.arange(3, dtype=torch.int32) + i
                         for i in range(6)))
    return PIAGResult(
        x=torch.randn(3, 5), objective=torch.randn(3, 4),
        gammas=torch.rand(3, 4), taus=torch.arange(12, dtype=torch.int32
                                                   ).reshape(3, 4),
        opt_residual=torch.zeros(3, 4), clipped=torch.zeros(3,
                                                           dtype=torch.int32),
        telemetry=None, faults=fs)


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    return a == b


def test_encode_decode_round_trip():
    tree = _tree()
    arrays, desc = encode_tree(tree)
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
    json.dumps(desc)
    back = decode_tree(arrays, desc, device="cpu")
    assert type(back) is PIAGResult and type(back.faults) is tf.FaultState
    assert _equal(back, tree)
    nested = ({"b": [torch.ones(2), None], "a": (torch.tensor(3),)},
              StepsizeState(torch.zeros(2, dtype=torch.int32), torch.ones(2),
                            torch.ones(2, 4), torch.zeros(2,
                                                          dtype=torch.int32)))
    assert _equal(decode_tree(*encode_tree(nested)), nested)
    # the reference's descriptor of the same tree, built from numpy leaves
    ref_arrays, ref_desc = jsweepck.encode_tree(
        jf.FaultState(*(np.asarray(x) for x in tree.faults)))
    assert ref_desc == encode_tree(tree.faults)[1]


def test_decode_refuses_unknown_and_changed_classes():
    arrays, desc = encode_tree(_tree())
    bad = json.loads(json.dumps(desc))
    bad["cls"] = "NoSuchResult"
    with pytest.raises(ValueError, match="unknown result type"):
        decode_tree(arrays, bad)
    bad = json.loads(json.dumps(desc))
    bad["fields"] = bad["fields"][:-1]
    with pytest.raises(ValueError, match="do not match"):
        decode_tree(arrays, bad)


def test_registry_matches_the_reference():
    """Every class a bucket file may name has the reference's name and
    field list, so a file decodes in either package."""
    ours, theirs = tsweepck._registry(), jsweepck._registry()
    for name in ("PIAGResult", "BCDResult", "FedResult", "StepsizeState",
                 "LipschitzState", "FaultState", "DelayTelemetry"):
        assert ours[name]._fields == theirs[name]._fields, name


def test_npz_checkpoint_round_trip_across_packages(tmp_path):
    tree = {"params": (torch.randn(3, 2), torch.arange(4)),
            "state": _tree().faults, "step": torch.tensor(7)}
    p = str(tmp_path / "port.npz")
    save_checkpoint(p, tree, {"step": 7})
    back, meta = load_checkpoint(p, tree)
    assert meta == {"step": 7} and _equal(back, tree)
    like = {"params": (jnp.zeros((3, 2)), jnp.zeros(4, jnp.int32)),
            "state": jf.FaultState(*(jnp.zeros(3, jnp.int32)
                                     for _ in range(6))),
            "step": jnp.int32(0)}
    ref_back, ref_meta = j_load(p, like)
    assert ref_meta == {"step": 7}
    np.testing.assert_array_equal(np.asarray(ref_back["params"][0]),
                                  tree["params"][0].numpy())
    np.testing.assert_array_equal(np.asarray(ref_back["state"].degraded),
                                  tree["state"].degraded.numpy())
    q = str(tmp_path / "ref.npz")
    j_save(q, {"step": jnp.int32(7)}, {"by": "repro"})
    got, meta = load_checkpoint(q, {"step": torch.tensor(0)})
    assert meta == {"by": "repro"} and int(got["step"]) == 7


# ------------------------------------------------------------- resume ----

@pytest.fixture(scope="module")
def pieces():
    jp = j_make_logreg(240, 40, n_workers=4, seed=0)
    tp = make_logreg(240, 40, n_workers=4, seed=0, device="cpu")
    gp = 0.99 / jp.L

    def grid(mg, A1, Fx, hw):
        # n_workers (2, 4): a ragged grid of two buckets
        return mg(policies={"a1": A1(gamma_prime=gp),
                            "fx": Fx(gamma_prime=gp, tau_bound=40)},
                  seeds=[0, 1],
                  topologies={"hetero": lambda n: hw(n, seed=1)},
                  n_events=N_EVENTS, n_workers=[2, 4])

    def fgrid(mg, H, cl):
        return mg(policies={"hinge": H(gamma_prime=0.6)}, seeds=[0, 1],
                  topologies={"edge": lambda n: cl(n, seed=2)},
                  n_events=N_EVENTS_FED,
                  n_workers=[2, 4])

    return {"j": (jp, grid(j_make_grid, JAdaptive1, JFixed, j_hetero),
                  fgrid(j_make_grid, JHinge, j_clients), JL1(lam=jp.lam1)),
            "t": (tp, grid(make_grid, Adaptive1, FixedStepSize,
                           heterogeneous_workers),
                  fgrid(make_grid, HingeWeight, heterogeneous_clients),
                  L1(lam=tp.lam1))}


def _run(side, pieces, solver="piag", backend="batched", faults=CHAOS,
         resume=None, **kw):
    problem, grid, fgrid, prox = pieces[side]
    fed = solver.startswith("fed")
    if side == "j":
        return japi.run_components(
            solver, backend, problem=problem, grid=fgrid if fed else grid,
            prox=prox, horizon=4096, engine="scan", resume=resume,
            faults=None if faults is None else jf.FaultSpec(**faults), **kw)
    return tapi.run_components(
        solver, backend, problem=problem, grid=fgrid if fed else grid,
        prox=prox, horizon=4096, engine="scan", device="cpu", resume=resume,
        faults=None if faults is None else tf.FaultSpec(**faults), **kw)


@pytest.fixture(scope="module")
def port_run(pieces, tmp_path_factory):
    """The port's PIAG batched chaos run with ``resume``: its result and
    its checkpoint directory (two bucket files), shared read-only."""
    ck = tmp_path_factory.mktemp("port") / "ck"
    return _run("t", pieces, resume=str(ck)), ck


@pytest.fixture
def load_count(monkeypatch):
    """Counts the bucket files ``repro_torch`` actually loads."""
    counts = {"loaded": 0}
    orig = SweepCheckpoint.load_bucket

    def load_bucket(self, width, idx):
        out = orig(self, width, idx)
        counts["loaded"] += out is not None
        return out

    monkeypatch.setattr(SweepCheckpoint, "load_bucket", load_bucket)
    return counts


def _assert_rows_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "faults":
            assert tf.summarize_faults(x) == tf.summarize_faults(y)
            for name in tf.FaultState._fields if x is not None else ():
                assert torch.equal(getattr(x, name), getattr(y, name))
        elif f != "telemetry":
            assert torch.equal(x, y), f


@pytest.mark.parametrize("solver, backend", [
    ("piag", "batched"), ("piag", "solo"), ("bcd", "batched"),
    ("fedasync", "batched"), ("fedbuff", "batched")])
def test_resume_is_bitwise_and_reruns_only_the_missing_bucket(
        solver, backend, pieces, port_run, tmp_path, load_count):
    """The first run, uninterrupted, writes every file; the rerun after
    deleting the last one loads the others and recomputes it."""
    kw = {"bcd": {"m": 8}, "fedbuff": {"eta": 0.5, "buffer_size": 2}}.get(
        solver, {})
    ck = tmp_path / "ck"
    if (solver, backend) == ("piag", "batched"):
        first = port_run[0]
        shutil.copytree(port_run[1], ck)
    else:
        first = _run("t", pieces, solver, backend, resume=str(ck), **kw)
    files = sorted(ck.glob("*.npz"))
    n = 2 if backend == "batched" else len(first.grid.cells)
    assert len(files) == n, [f.name for f in files]
    assert all(f.name.startswith(f"{solver}_{backend}_w") for f in files)
    files[-1].unlink()
    again = _run("t", pieces, solver, backend, resume=str(ck), **kw)
    assert load_count["loaded"] == n - 1
    assert len(list(ck.glob("*.npz"))) == n
    _assert_rows_equal(first.raw, again.raw)
    assert again.telemetry.faults == first.telemetry.faults


def test_resume_across_packages(pieces, port_run, tmp_path, load_count):
    """A bucket written by ``repro`` resumes in ``repro_torch`` (the rows
    are the reference's own, bit for bit); one written by
    ``repro_torch`` is accepted by the reference's fingerprint check and
    decodes through the reference's registry into the port's rows."""
    ck = tmp_path / "from_ref"
    ref = _run("j", pieces, resume=str(ck))
    got = _run("t", pieces, resume=str(ck))
    assert load_count["loaded"] == 2
    for f in ("objective", "gammas", "taus", "opt_residual", "clipped"):
        np.testing.assert_array_equal(getattr(got.raw, f).numpy(),
                                      np.asarray(getattr(ref.raw, f)),
                                      err_msg=f)
    assert tf.summarize_faults(got.raw.faults) == \
        jf.summarize_faults(ref.raw.faults)

    port, ck2 = port_run
    fp = port.telemetry.fingerprint
    jck = JSweepCheckpoint(ck2, fp, tag="piag_batched")
    for i, b in enumerate(pieces["j"][1].buckets()):
        jck.load_bucket(b.width, i)   # the reference accepts the file
        with np.load(jck._path(b.width, i)) as z:
            meta = json.loads(str(z["__meta__"]))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        assert meta["fingerprint"] == fp and meta["tag"] == "piag_batched"
        row = _decode_with(jsweepck._registry(), arrays, meta["tree"])
        assert type(row).__module__ == "repro.core.piag"
        assert type(row.faults).__module__ == "repro.faults.guards"
        idx = torch.from_numpy(b.index)
        np.testing.assert_array_equal(row.objective,
                                      port.raw.objective[idx].numpy())
        np.testing.assert_array_equal(row.faults.dropped,
                                      port.raw.faults.dropped[idx].numpy())


def _decode_with(registry, arrays, desc):
    """The reference's decoding rule (NamedTuples by class name with their
    field lists) over ``registry``."""
    t = desc["t"]
    if t == "none":
        return None
    if t == "arr":
        return arrays[desc["key"]]
    items = [_decode_with(registry, arrays, d) for d in desc["items"]]
    if t == "nt":
        cls = registry[desc["cls"]]
        assert list(cls._fields) == desc["fields"]
        return cls(*items)
    return tuple(items) if t == "tuple" else items


def test_checkpoint_of_another_spec_is_refused(pieces, port_run):
    ck = str(port_run[1])
    with pytest.raises(ValueError, match="different spec"):
        _run("t", pieces, faults=dict(CHAOS, seed=99), resume=ck)
    with pytest.raises(ValueError, match="different spec"):
        _run("j", pieces, faults=dict(CHAOS, seed=99), resume=ck)
    # fault-free and faulted specs fingerprint apart too
    with pytest.raises(ValueError, match="different spec"):
        _run("t", pieces, faults=None, resume=ck)


def test_resume_without_faults_and_fused_engine(pieces, tmp_path,
                                                load_count):
    """Resume is independent of faults and of the engine (the fused
    engine runs the plain versions of its kernels on the CPU)."""
    problem, grid, _, prox = pieces["t"]
    ck = str(tmp_path / "ck")
    runs = [tapi.run_components("piag", "batched", problem=problem,
                                grid=grid, prox=prox, horizon=4096,
                                device="cpu", resume=ck) for _ in range(2)]
    assert load_count["loaded"] == 2
    _assert_rows_equal(runs[0].raw, runs[1].raw)
    assert runs[1].raw.faults is None and runs[1].telemetry.faults is None
