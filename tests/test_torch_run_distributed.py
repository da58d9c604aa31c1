"""The port's sharded trainer (``repro_torch.launch.run_distributed``) on
the CPU listed 8 times, batch 8, seq 32, held

* on a (1, 4) mesh, whose one data-parallel row is the whole batch, on
  the row-gathered route (each row's parameters gathered whole; the
  tensor-parallel route of the dense and MoE configs, whose row-parallel
  products sum in another float order, is held to its envelopes by
  ``tests/test_torch_tp_step.py``), against the port's unsharded step
  (``Trainer.train_step``) for the reference test's three configs
  (``tests/test_dryrun.py``) and a dense one, reduced.  Taus are exact
  and gammas bitwise in every case, and
  the step-0 loss bitwise.  With the clip not acting (``grad_clip`` far
  above the gradient norm) the whole run is bitwise: every loss, every
  parameter and moment leaf.  With the reference trainer's clip of 1.0,
  which acts at these configs (gradient norms 2-9), the clip's global
  norm sums the blocks' squares where the unsharded step sums each
  leaf's: every loss is within 1e-6 of the first, and after the first
  step every parameter and moment leaf within 1e-6 of its largest
  absolute value.  Past the first step the parameters move apart further
  (AdamW's ``m / (sqrt(v) + eps)`` turns the rounding difference of a
  gradient element near zero into an update difference of up to the
  learning rate, as between the packages: ROADMAP queue C), so the last
  state is held to 1e-2 in norm, leaf by leaf.  (At (2, 4) the two rows
  sum the loss and the gradients in row order, another float order:
  ``tests/test_torch_dp_step.py`` holds that mesh to its envelopes);
* at (2, 4) against the reference's jitted unsharded ``train_step`` from the
  reference's initial state (``interop.train_state``): taus exact,
  gammas bitwise, losses within 1e-4 of the first (the trainers'
  envelope; the reference's own sharded step raises on this tree,
  ROADMAP "Durable notes");
* through its CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import TokenStream as JTokenStream
from repro.launch.steps import make_trainer as j_make_trainer
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.pytree import tree_leaves
from repro_torch.launch import run_distributed as rd
from repro_torch.launch.steps import loss_and_grad, make_trainer
from repro_torch.launch.train import make_stream
from repro_torch.mesh import (batch_shardings, device_put, gather,
                              make_mesh)
from repro_torch.models import tensor_parallel
from repro_torch.optim.optimizers import global_norm

ARCHS = ["qwen2-moe-a2.7b", "mamba2-780m", "deepseek-v2-236b", "qwen2.5-32b"]
STEPS, BATCH, SEQ = 3, 8, 32
LOSS_REL = 1e-6        # sharded vs unsharded losses, of the first
LEAF_REL = 1e-6        # after the first step, of each leaf's max |value|
LAST_NORM_REL = 1e-2   # the last state, leaf by leaf in norm
REF_LOSS_REL = 1e-4    # against the reference's unsharded step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((2, 4), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def row_mesh():
    """A data axis of 1: one row computes the whole batch."""
    return make_mesh((1, 4), devices=["cpu"] * 4)


@pytest.fixture
def row_gathered(monkeypatch):
    """Every family on the row-gathered route."""
    monkeypatch.setattr(tensor_parallel, "route",
                        lambda cfg: tensor_parallel.ROW_GATHERED)


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _state_leaves(state):
    return tree_leaves(state.params) + tree_leaves(state.opt.inner)


def _pair(arch, mesh, grad_clip):
    """Both steps from one initial state: per step (unsharded metrics,
    sharded metrics, unsharded state, sharded state gathered), and the
    first step's gradient norm."""
    cfg = get_config(arch).reduced().replace(attention_impl="chunked")
    trainer = make_trainer(cfg, n_workers=2, lr=1e-3, grad_clip=grad_clip)
    plain = trainer.init(device="cpu")
    sharded = rd.shard_state(trainer.init(device="cpu"), mesh)
    stream = make_stream(cfg, BATCH, SEQ, device="cpu")
    gnorm = float(global_norm(loss_and_grad(plain.params, cfg,
                                            stream.batch_at(0))[2]))
    out = []
    with mesh:
        for k in range(STEPS):
            b = stream.batch_at(k)
            plain, m = trainer.train_step(plain, b, k % 2)
            sharded, ms = rd.sharded_train_step(
                trainer, sharded, device_put(b, batch_shardings(b, mesh,
                                                                BATCH)),
                k % 2)
            out.append((m, ms, _state_leaves(plain),
                        [gather(x, "cpu") for x in _state_leaves(sharded)]))
    return out, gnorm


def _same_trace(out):
    for m, ms, _, _ in out:
        assert int(ms["tau"]) == int(m["tau"])
        assert _bits(ms["gamma"]) == _bits(m["gamma"])
    assert _bits(out[0][1]["loss"]) == _bits(out[0][0]["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_is_bitwise_where_the_clip_does_not_act(arch,
                                                             row_mesh,
                                                             row_gathered):
    out, gnorm = _pair(arch, row_mesh, grad_clip=1e9)
    assert gnorm < 1e9
    _same_trace(out)
    for m, ms, want, got in out:
        assert _bits(ms["loss"]) == _bits(m["loss"])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded_under_the_clip(arch, row_mesh,
                                                       row_gathered):
    out, gnorm = _pair(arch, row_mesh, grad_clip=1.0)
    assert gnorm > 1.0     # the clip acts
    _same_trace(out)
    first = abs(float(out[0][0]["loss"]))
    for m, ms, _, _ in out:
        assert abs(float(ms["loss"]) - float(m["loss"])) <= LOSS_REL * first
    _, _, want, got = out[0]
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max()
        assert err <= LEAF_REL * b.float().abs().max()
    _, _, want, got = out[-1]
    for a, b in zip(got, want):
        assert torch.linalg.vector_norm(a.float() - b.float()) <= \
            LAST_NORM_REL * torch.linalg.vector_norm(b.float())


def test_sharded_step_matches_reference_unsharded_step(mesh):
    """reduced qwen2-moe-a2.7b from the reference's ``Trainer.init``."""
    jcfg = jconfigs.get_config("qwen2-moe-a2.7b").reduced()
    tcfg = get_config("qwen2-moe-a2.7b").reduced().replace(
        attention_impl="chunked")
    jtr = j_make_trainer(jcfg, n_workers=2, lr=1e-3)
    jstate = jtr.init(jax.random.PRNGKey(0))
    trainer = make_trainer(tcfg, n_workers=2, lr=1e-3)
    state = rd.shard_state(
        interop.train_state(jax.tree_util.tree_map(np.asarray, jstate), tcfg,
                            device="cpu"), mesh)
    jstream = JTokenStream(vocab=jcfg.vocab, batch=BATCH, seq=SEQ)
    stream = make_stream(tcfg, BATCH, SEQ, device="cpu")
    jstep = jax.jit(jtr.train_step)
    jl, tl = [], []
    with mesh:
        for k in range(STEPS):
            jstate, jm = jstep(jstate, jstream.batch_at(k), jnp.int32(k % 2))
            b = stream.batch_at(k)
            state, m = rd.sharded_train_step(
                trainer, state, device_put(b, batch_shardings(b, mesh,
                                                              BATCH)), k % 2)
            assert int(m["tau"]) == int(jm["tau"])
            assert np.float32(jm["gamma"]).view(np.int32) == \
                np.float32(float(m["gamma"])).view(np.int32)
            jl.append(float(jm["loss"]))
            tl.append(float(m["loss"]))
    assert np.abs(np.array(jl) - np.array(tl)).max() <= \
        REF_LOSS_REL * abs(jl[0])


def test_run_logs_each_step(mesh):
    cfg = get_config("mamba2-780m").reduced()
    state, log = rd.run(cfg, mesh, steps=2, batch=BATCH, seq=SEQ)
    assert [r["step"] for r in log] == [0, 1]
    assert [r["tau"] for r in log] == [0, 1]
    for r in log:
        assert np.isfinite(r["loss"]) and r["wall_s"] >= r["compute_s"] > 0
        assert len(r["compute_rows_s"]) == 2
        assert r["compute_s"] == sum(r["compute_rows_s"])
    leaf = tree_leaves(state.params)[0]
    assert leaf.sharding.mesh is mesh


def test_cli_prints_the_reference_lines(capsys):
    rd.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--steps", "2",
             "--mesh", "2x4", "--batch", "8", "--seq", "32",
             "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("\nstep ") + out.startswith("step ") == 2
    assert "sharding of first param: NamedSharding(" in out
    assert out.rstrip().endswith("DISTRIBUTED_RUN_OK")


def test_default_mesh_needs_the_cards():
    if torch.cuda.device_count() >= 8:
        pytest.skip("this host has 8 cards: the default (2, 4) mesh fits")
    with pytest.raises((RuntimeError, ValueError)):
        make_mesh((2, 4))
