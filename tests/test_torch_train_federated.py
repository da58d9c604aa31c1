"""The federated trainer (``launch.train_federated``) against the
reference's, on the CPU.

* ``make_weight_policy``: the five names emit the reference's weights,
  bitwise, on one staleness trace.
* ``run_convex_federated`` at CI's settings (logreg, 400 uploads, hinge;
  ``.github/workflows/ci.yml``) and FedBuff (``--buffer 4``) on lasso:
  ``max_tau`` exact, the trace the reference's, ``p_star`` and the final
  and best suboptimality within ``OBJ_REL`` of the starting objective
  P(0) (the federated servers' envelope: the reference contracts
  ``x - lr*g`` into an FMA, the port rounds twice).
* ``run_transformer_federated`` at ``tests/test_system.py``'s tiny config
  from the reference's parameters (the port's ``init_params`` returns
  ``interop.model_params`` of the reference's draw): the trace's clients
  and the logged taus exact, gammas bitwise, losses within ``LOSS_REL`` of
  the first loss (the trainers' envelope, ROADMAP queue C).
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.launch.train_federated as jfed
from repro.federated import heterogeneous_clients as j_clients
from repro.federated import simulate_federated as j_simulate
from repro.launch.train import PRESETS as J_PRESETS
from repro.models import init_params as j_init
import repro_torch.launch.train_federated as tfed
from repro_torch import interop
from repro_torch.core import make_lasso, make_logreg

OBJ_REL = 1e-5
LOSS_REL = 1e-4
TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
            d_ff=256, vocab=512, name="lm-tiny")
POLICY_NAMES = ("hinge", "poly", "constant", "fixed_taubound",
                "fixed_taubound_sqrt")
TRACE_COLS = ("client", "read_at", "tau", "aggregate", "version",
              "local_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", POLICY_NAMES)
def test_make_weight_policy_matches_reference(name):
    taus = np.random.default_rng(3).integers(0, 40, 300)
    want = np.asarray(jfed.make_weight_policy(name, 0.4, 39).run(taus))
    got = tfed.make_weight_policy(name, 0.4, 39).run(taus,
                                                     device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_make_weight_policy_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown weight policy"):
        tfed.make_weight_policy("adaptive1", 0.4)


def _p0(problem_name, n_clients=8, seed=0):
    """P(0), the objective the servers start from."""
    make = make_logreg if problem_name == "logreg" else make_lasso
    dim = 50 if problem_name == "logreg" else 100
    prob = make(n_samples=500, dim=dim, n_workers=n_clients, seed=seed,
                device="cpu")
    return float(prob.P(torch.zeros(dim)))


@pytest.mark.parametrize("problem,buffer", [("logreg", 1), ("lasso", 4)])
def test_run_convex_federated_matches_reference(problem, buffer, tmp_path):
    kw = dict(uploads=400, policy_name="hinge", buffer_size=buffer)
    lj = jfed.run_convex_federated(problem, **kw)
    lt = tfed.run_convex_federated(problem, device="cpu",
                                   out_dir=str(tmp_path), **kw)
    env = OBJ_REL * _p0(problem)
    for k in ("problem", "policy", "uploads", "buffer", "max_tau"):
        assert lt[k] == lj[k], k
    for k in ("p_star", "final_subopt", "best_subopt"):
        assert abs(lt[k] - lj[k]) <= env, (k, lt[k], lj[k])
    assert lt["final_subopt"] < 0.05 * _p0(problem)
    jtrace = j_simulate(8, 400, j_clients(8, spread=4.0, seed=1,
                                          p_straggle=0.05, p_dropout=0.02),
                        buffer_size=buffer, seed=1)
    for col in TRACE_COLS:
        np.testing.assert_array_equal(getattr(lt["trace"], col),
                                      np.asarray(getattr(jtrace, col)))
    res = lt["result"]
    assert res.objective.shape == (400,)
    if buffer == 1:
        np.testing.assert_array_equal(res.taus.numpy(), jtrace.tau)
    with open(tmp_path / "federated_log.json") as f:
        assert set(json.load(f)) == set(lj)


def test_cli_runs_ci_command_like_the_reference(capsys):
    """CI's ``--problem logreg --uploads 400 --policy hinge`` on both
    packages: the same header and, to the printed digits, the same final
    and best suboptimality."""
    jfed.run_convex_federated("logreg", uploads=400, policy_name="hinge")
    ref = capsys.readouterr().out.splitlines()
    tfed.main(["--problem", "logreg", "--uploads", "400", "--policy",
               "hinge", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ref[0] + " device=cpu"
    assert out[1].split("(")[0] == ref[1].split("(")[0]


def _reference_init(jc):
    def init_params(cfg, generator=None, device=None):
        seed = int(generator.initial_seed()) if generator is not None else 0
        pj = jax.tree_util.tree_map(np.asarray,
                                    j_init(jc, jax.random.PRNGKey(seed)))
        return interop.model_params(pj, cfg, device=device)
    return init_params


def test_run_transformer_federated_matches_reference():
    jc = J_PRESETS["25m"].replace(**TINY)
    tc = tfed.PRESETS["25m"].replace(attention_impl="chunked", **TINY)
    kw = dict(uploads=8, n_clients=3, local_steps=2, batch=2, seq=32,
              log_every=1)
    lj = jfed.run_transformer_federated(jc, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfed, "init_params", _reference_init(jc))
        lt = tfed.run_transformer_federated(tc, device="cpu", **kw)
    assert len(lt) == len(lj) == 8
    for a, b in zip(lj, lt):
        assert (a["upload"], a["tau"]) == (b["upload"], b["tau"]), (a, b)
        assert np.float32(a["gamma"]).view(np.int32) == \
            np.float32(b["gamma"]).view(np.int32), (a, b)
        assert abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(lj[0]["loss"]), \
            (a, b)
    assert lt[-1]["loss"] < lt[0]["loss"]
    # the clients of the trainer's trace are the reference's
    from repro_torch.federated import heterogeneous_clients, \
        simulate_federated
    args = dict(spread=3.0, seed=0, p_straggle=0.05, p_dropout=0.01,
                local_epochs=2)
    np.testing.assert_array_equal(
        simulate_federated(3, 8, heterogeneous_clients(3, **args),
                           seed=0).client,
        np.asarray(j_simulate(3, 8, j_clients(3, **args), seed=0).client))


def test_run_transformer_federated_refuses_the_flash_kernel():
    """Local SGD needs a backward; the flash-attention kernel has none."""
    cfg = tfed.PRESETS["25m"].replace(**TINY)
    assert cfg.attention_impl == "pallas"
    with pytest.raises(ValueError, match="cannot train"):
        tfed.run_transformer_federated(cfg, uploads=1, n_clients=1,
                                       local_steps=1, batch=1, seq=8,
                                       device="cpu")
