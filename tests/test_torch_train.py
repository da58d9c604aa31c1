"""The slice whole: the asynchronous LM trainer (``launch.train``) and its
Async-BCD twin (``launch.train_bcd``) against the reference's, at
``tests/test_system.py``'s tiny configs, and checkpoints resumed across
packages in both directions.

Both packages start from the same parameters: the port's
``init_params`` returns ``interop.model_params`` of the reference's
``init_params(cfg, PRNGKey(seed))``.  Worker order (the trace), taus,
blocks and batches are exact, gammas bitwise, and the logged losses within
``LOSS_REL`` of the first loss: float32 matmul and softmax sums run in
other orders, and AdamW's ``m / (sqrt(v) + eps)`` turns the rounding
difference of a gradient element near zero into an update difference of
up to the learning rate (measured: 4.3e-7 at the tiny config, 2.4e-5 at
the checkpoint config, d_model 64).  A checkpoint's step-size state is
bitwise, its other float leaves within ``CKPT_NORM_REL`` in norm (AdamW's
moments carry those update differences: 3.2e-3 measured).
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
import repro.launch.train_bcd as jbcd
from repro.core.stepsize import Adaptive1 as JA1
from repro.models import init_params as j_init
import repro_torch.launch.train as ttrain
import repro_torch.launch.train_bcd as tbcd
from repro_torch import interop
from repro_torch.core.stepsize import Adaptive1

LOSS_REL = 1e-4
CKPT_NORM_REL = 1e-2
TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
            d_ff=256, vocab=512)
CKPT = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, shape):
    jc = jtrain.PRESETS["25m"].replace(name=name, **shape)
    tc = ttrain.PRESETS["25m"].replace(name=name, attention_impl="chunked",
                                       **shape)
    return jc, tc


def _reference_init(jc):
    """The port's ``init_params`` replaced by the reference's parameters
    carried across (the reference's PRNGKey draw for the same seed)."""
    def init_params(cfg, generator=None, device=None):
        seed = int(generator.initial_seed()) if generator is not None else 0
        pj = jax.tree_util.tree_map(np.asarray,
                                    j_init(jc, jax.random.PRNGKey(seed)))
        return interop.model_params(pj, cfg, device=device)
    return init_params


def _compare_logs(lj, lt, keys=("step", "tau")):
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        for k in keys:
            assert a[k] == b[k], (k, a, b)
        assert np.float32(a["gamma"]).view(np.int32) == \
            np.float32(b["gamma"]).view(np.int32), (a, b)
        assert abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(lj[0]["loss"]), \
            (a, b)


@pytest.fixture(scope="module")
def trained():
    jc, tc = _configs("lm-tiny", TINY)
    kw = dict(steps=20, batch=4, seq=64, policy_name="adaptive1", lr=3e-3,
              n_workers=3, log_every=1)
    lj = jtrain.run_training(jc, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "init_params", _reference_init(jc))
        lt = ttrain.run_training(tc, device="cpu", **kw)
    return lj, lt


def test_run_training_matches_reference(trained):
    lj, lt = trained
    _compare_logs(lj, lt)
    assert [r["step"] for r in lt] == list(range(20))
    assert lt[-1]["loss"] < lt[0]["loss"] - 0.3


def test_run_training_worker_order_is_the_reference_trace(trained):
    """The logged taus are the trace's: ``k - read_at`` of the reference's
    ``simulate_parameter_server`` with the trainer's workers."""
    from repro.core.engine import (heterogeneous_workers,
                                   simulate_parameter_server)
    _, lt = trained
    trace = simulate_parameter_server(
        3, 20, heterogeneous_workers(3, spread=2.0, seed=0, p_straggle=0.05,
                                     straggle_x=8.0), seed=0)
    assert [r["tau"] for r in lt] == trace.tau.tolist()


@pytest.mark.parametrize("policy", ["adaptive2", "fixed"])
def test_run_training_other_policies(policy):
    jc, tc = _configs("lm-ck", CKPT)
    kw = dict(steps=8, batch=2, seq=32, policy_name=policy, n_workers=2,
              log_every=1)
    lj = jtrain.run_training(jc, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "init_params", _reference_init(jc))
        lt = ttrain.run_training(tc, device="cpu", **kw)
    _compare_logs(lj, lt)


def test_run_bcd_training_matches_reference():
    jc, tc = _configs("lm-bcd", TINY)
    kw = dict(steps=20, batch=4, seq=64, m_blocks=4, n_workers=3,
              log_every=1)
    lj = jbcd.run_bcd_training(jc, JA1(gamma_prime=0.5), **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbcd, "init_params", _reference_init(jc))
        lt = tbcd.run_bcd_training(tc, Adaptive1(gamma_prime=0.5),
                                   device="cpu", **kw)
    _compare_logs(lj, lt, keys=("step", "tau", "block"))
    assert lt[-1]["loss"] < lt[0]["loss"]


def test_block_partition_is_the_references():
    jc, tc = _configs("lm-bcd", TINY)
    pj = jax.tree_util.tree_map(np.asarray, j_init(jc, jax.random.PRNGKey(0)))
    from repro_torch.models import param_tree
    tree = param_tree(interop.model_params(pj, tc, device="cpu"))
    for m in (1, 3, 4, 7):
        assert tbcd.block_partition(tree, m) == jbcd.block_partition(pj, m)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """10 steps in each package from the same parameters, each writing its
    ``final.npz``."""
    jc, tc = _configs("lm-ck", CKPT)
    kw = dict(steps=10, batch=2, seq=32, n_workers=2, log_every=5)
    jdir = str(tmp_path_factory.mktemp("ref"))
    tdir = str(tmp_path_factory.mktemp("port"))
    jtrain.run_training(jc, out_dir=jdir, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "init_params", _reference_init(jc))
        ttrain.run_training(tc, out_dir=tdir, device="cpu", **kw)
    return jc, tc, kw, jdir, tdir


def test_final_checkpoints_agree(checkpoints):
    """The two ``final.npz`` hold the same keys, shapes and dtypes; integer
    leaves equal, the step-size state bitwise, the other float leaves
    within ``CKPT_NORM_REL`` in norm."""
    *_, jdir, tdir = checkpoints
    with np.load(f"{jdir}/final.npz") as a, np.load(f"{tdir}/final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k == "__metadata__":
                ma, mb = json.loads(str(a[k])), json.loads(str(b[k]))
                assert ma["steps"] == mb["steps"] == 10
                continue
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if a[k].dtype.kind in "iu" or k.split("/")[2:3] == ["ss"]:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                err = np.linalg.norm(a[k] - b[k])
                assert err <= CKPT_NORM_REL * np.linalg.norm(a[k]), k


@pytest.mark.parametrize("direction", ["reference file -> port",
                                       "port file -> reference"])
def test_resume_across_packages(checkpoints, direction):
    """A ``final.npz`` written by one package resumes in the other: the
    resumed run matches the writer's own resume (steps 10-19, taus exact,
    gammas bitwise, losses within the envelope)."""
    jc, tc, kw, jdir, tdir = checkpoints
    src = jdir if direction.startswith("reference") else tdir
    path = f"{src}/final.npz"
    lj = jtrain.run_training(jc, resume_from=path, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "init_params", _reference_init(jc))
        lt = ttrain.run_training(tc, resume_from=path, device="cpu", **kw)
    assert lt[-1]["step"] == 19
    _compare_logs(lj, lt)


def test_training_refuses_pallas_attention():
    """B6 has no backward: both trainers raise instead of switching to
    another attention."""
    _, tc = _configs("lm-ck", CKPT)
    cfg = tc.replace(attention_impl="pallas")
    with pytest.raises(ValueError, match="forward-only"):
        ttrain.run_training(cfg, steps=1, batch=1, seq=8, device="cpu")
    with pytest.raises(ValueError, match="forward-only"):
        tbcd.run_bcd_training(cfg, Adaptive1(gamma_prime=0.5), steps=1,
                              device="cpu")


def test_cli_trains_with_chunked_attention_and_says_so(capsys, monkeypatch):
    """The CLI takes the reference trainer's attention for every config and
    its first line says so; ``launch.train.PRESETS`` stay as serving reads
    them (the port's ``pallas`` default)."""
    seen = {}

    def fake_run(cfg, **kw):
        seen["cfg"], seen["kw"] = cfg, kw
        return []

    monkeypatch.setattr(ttrain, "run_training", fake_run)
    ttrain.main(["--preset", "100m", "--steps", "3", "--device", "cpu"])
    first = capsys.readouterr().out.splitlines()[0]
    assert "attention=chunked" in first
    assert seen["cfg"].attention_impl == "chunked"
    assert seen["cfg"].replace(attention_impl="pallas") == ttrain.PRESETS["100m"]
    assert seen["kw"]["n_workers"] == 4 and seen["kw"]["batch"] == 8
    assert ttrain.PRESETS["100m"].attention_impl == "pallas"
