"""A model mesh over two ``torch.distributed`` ranks (gloo on 127.0.0.1):
the (2, 2) ("data", "model") mesh of the CPU listed 4 times, each rank
owning one data-parallel row (positions [0, 0, 1, 1]).

* ``launch.run_distributed``'s step for reduced qwen2-moe-a2.7b (capacity
  MoE: each row's offsets come from an all-gather of the counts at each
  MoE layer; each row's two "model" positions compute tensor-parallel,
  and each model block's gradient crosses the ranks), 3 steps from the
  reference's initial state
  (``interop.train_state``): every rank's final state, gathered across
  the ranks, its losses, taus and gammas are bitwise the one-process run
  of the same mesh; against the reference's jitted unsharded
  ``train_step`` taus are exact, gammas bitwise and losses within
  ``REF_LOSS_REL`` of the first;
* the same for reduced qwen2.5-32b with two kv heads, the dense family
  on the tensor-parallel route, from the port's initial state;
* the CLI with ``--coordinator``, ``--num-processes`` and
  ``--process-id``: rank 0 prints the reference's lines and
  ``DISTRIBUTED_RUN_OK``;
* a device list giving one CUDA card to two ranks raises ``ValueError``
  before any process group is made, in ``make_mesh`` and in the CLI;
  a row spread over two ranks raises.

Every spawned process is joined under ``TIMEOUT_S``; one still running
then is killed and the test fails.
"""
import os
import pathlib
import socket
import subprocess
import sys

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
from repro_torch.core.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import run_distributed as rd
from repro_torch.launch.steps import make_trainer
from repro_torch.launch.train import make_stream
from repro_torch.mesh import (batch_shardings, device_put, gather, make_mesh,
                              process_count)
from repro_torch.models.tensor_parallel import TENSOR_PARALLEL, route

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, STEPS, BATCH, SEQ = "qwen2-moe-a2.7b", 3, 8, 32
SHAPE, RANKS = (2, 2), [0, 0, 1, 1]
TIMEOUT_S = 120
REF_LOSS_REL = 1e-4    # against the reference's unsharded step

# one rank: the steps of ``_steps`` of the config argv[4] from the state
# saved at argv[3]
_RANK = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from test_torch_multiprocess_mesh import _load_state, _steps, _save
from repro_torch.mesh import init_distributed, make_mesh, shutdown_distributed

rank = int(sys.argv[1])
init_distributed("127.0.0.1:{port}", 2, rank, backend="gloo")
mesh = make_mesh({shape}, devices=["cpu"] * 4, processes={ranks})
_save(sys.argv[2], *_steps(mesh, _load_state(sys.argv[3], sys.argv[4]),
                           sys.argv[4]))
shutdown_distributed()
"""
# reduced qwen2.5-32b with two kv heads (its k / v row-parallel, as at
# full width), beside ARCH's reduced config
DENSE = "qwen2.5-32b-kv2"

_CLI = """
import sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import run_distributed as rd
rd.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--steps", "2",
         "--mesh", "2x2", "--batch", "8", "--seq", "32", "--device", "cpu",
         "--coordinator", "127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", sys.argv[1]])
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name=ARCH):
    if name == DENSE:
        return get_config("qwen2.5-32b").reduced().replace(
            attention_impl="chunked", n_kv_heads=2)
    return get_config(name).reduced().replace(attention_impl="chunked")


def _trainer(name=ARCH):
    return make_trainer(_cfg(name), n_workers=2, lr=1e-3)


def _load_state(path, name=ARCH):
    """The train state saved by :func:`_reference_state` (its leaves in
    tree order) in the port trainer's structure."""
    like = _trainer(name).init(device="cpu")
    data = np.load(path)
    leaves = [torch.from_numpy(data[f"l{i}"].copy())
              for i in range(len(data.files))]
    _, spec = tree_flatten(like)
    return tree_unflatten(spec, leaves)


def _steps(mesh, state, name=ARCH):
    """``STEPS`` sharded steps on ``mesh`` from ``state``; the gathered
    final state's leaves and (loss, gamma bits, tau) a step."""
    trainer = _trainer(name)
    sharded = rd.shard_state(state, mesh)
    stream = make_stream(_cfg(name), BATCH, SEQ, device="cpu")
    trace = []
    with mesh:
        for k in range(STEPS):
            b = stream.batch_at(k)
            sharded, m = rd.sharded_train_step(
                trainer, sharded, device_put(b, batch_shardings(b, mesh,
                                                                BATCH)),
                k % 2)
            trace.append((float(m["loss"]), int(m["gamma"].view(torch.int32)),
                          int(m["tau"])))
    leaves = [gather(x, "cpu") for x in tree_leaves(sharded.params)
              + tree_leaves(sharded.opt)]
    return leaves, trace


def _save(path, leaves, trace):
    np.savez(path, trace=np.asarray(trace, dtype=np.float64),
             **{f"l{i}": t.numpy() for i, t in enumerate(leaves)})


def _reference_state(path):
    """The reference's ``Trainer.init`` (PRNGKey 0) carried across; saved
    at ``path``; returns the reference's state."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    jstate = j_make_trainer(jcfg, n_workers=2, lr=1e-3).init(
        jax.random.PRNGKey(0))
    state = interop.train_state(jax.tree_util.tree_map(np.asarray, jstate),
                                _cfg(), device="cpu")
    np.savez(path, **{f"l{i}": t.numpy()
                      for i, t in enumerate(tree_leaves(state))})
    return jstate


def _free_port() -> int:
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            return int(s.getsockname()[1])
    except OSError as e:
        pytest.skip(f"loopback sockets are refused here: {e}")


def _spawn(code, args_of_rank):
    """Two processes of ``code``; joined under ``TIMEOUT_S`` (killed and
    failed past it); their (returncode, stdout, stderr)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               *args_of_rank(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    out = []
    try:
        for p in procs:
            try:
                o, e = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank ran past {TIMEOUT_S} s")
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.poll() is not None for p in procs)
    return out


def test_two_gloo_ranks_give_the_one_process_run(tmp_path):
    init = str(tmp_path / "init.npz")
    jstate = _reference_state(init)
    code = _RANK.format(tests=str(ROOT / "tests"), port=_free_port(),
                        shape=SHAPE, ranks=RANKS)
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    for rc, _, err in _spawn(code, lambda r: [str(r), outs[r], init, ARCH]):
        assert rc == 0, err[-3000:]

    assert process_count() == 1
    want_leaves, want_trace = _steps(make_mesh(SHAPE, devices=["cpu"] * 4),
                                     _load_state(init))
    for o in outs:
        got = np.load(o)
        np.testing.assert_array_equal(got["trace"], np.asarray(
            want_trace, dtype=np.float64))
        for i, w in enumerate(want_leaves):
            g = got[f"l{i}"]
            assert g.dtype == w.numpy().dtype
            assert g.tobytes() == w.numpy().tobytes(), i

    # the reference's jitted unsharded step from the same initial state
    jcfg = jconfigs.get_config(ARCH).reduced()
    jstep = jax.jit(j_make_trainer(jcfg, n_workers=2, lr=1e-3).train_step)
    jstream = JTokenStream(vocab=jcfg.vocab, batch=BATCH, seq=SEQ)
    jl = []
    for k, (loss, gamma_bits, tau) in enumerate(want_trace):
        jstate, jm = jstep(jstate, jstream.batch_at(k), jnp.int32(k % 2))
        assert tau == int(jm["tau"])
        assert gamma_bits == int(np.float32(jm["gamma"]).view(np.int32))
        jl.append(float(jm["loss"]))
    assert np.abs(np.array(jl) - np.array([t[0] for t in want_trace])
                  ).max() <= REF_LOSS_REL * abs(jl[0])


def test_two_gloo_ranks_give_the_one_process_tensor_parallel_run(tmp_path):
    """The dense family on the tensor-parallel route (row-parallel k / v
    and w2, column-parallel q, wo and w1 / w3, the vocab-parallel
    embedding and logits) from the port's initial state: both ranks'
    final state, losses, taus and gammas bitwise the one-process run."""
    assert route(_cfg(DENSE)) == TENSOR_PARALLEL
    init = str(tmp_path / "init.npz")
    state = _trainer(DENSE).init(device="cpu")
    np.savez(init, **{f"l{i}": t.numpy()
                      for i, t in enumerate(tree_leaves(state))})
    code = _RANK.format(tests=str(ROOT / "tests"), port=_free_port(),
                        shape=SHAPE, ranks=RANKS)
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    for rc, _, err in _spawn(code, lambda r: [str(r), outs[r], init, DENSE]):
        assert rc == 0, err[-3000:]
    want_leaves, want_trace = _steps(make_mesh(SHAPE, devices=["cpu"] * 4),
                                     _load_state(init, DENSE), DENSE)
    for o in outs:
        got = np.load(o)
        np.testing.assert_array_equal(got["trace"], np.asarray(
            want_trace, dtype=np.float64))
        for i, w in enumerate(want_leaves):
            assert got[f"l{i}"].tobytes() == w.numpy().tobytes(), i


def test_cli_over_two_gloo_ranks():
    code = _CLI.format(port=_free_port())
    (rc0, out0, err0), (rc1, out1, err1) = _spawn(code, lambda r: [str(r)])
    assert rc0 == 0 and rc1 == 0, (err0[-2000:], err1[-2000:])
    assert out0.count("step ") == 2
    assert "sharding of first param: NamedSharding(" in out0
    assert out0.rstrip().endswith("DISTRIBUTED_RUN_OK")
    assert out1 == ""


def test_two_ranks_on_one_card_raise_before_the_group():
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one"):
        make_mesh(SHAPE, devices=["cuda:0"] * 4, processes=RANKS)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one"):
        rd.main(["--arch", ARCH, "--reduced", "--mesh", "2x2",
                 "--device", "cuda:0", "--coordinator", "127.0.0.1:1",
                 "--num-processes", "2", "--process-id", "0"])
    assert not torch.distributed.is_initialized()
    # one card a rank is fine until the group is needed
    with pytest.raises(ValueError, match="torch.distributed group"):
        make_mesh(SHAPE, devices=["cuda:0", "cuda:0", "cuda:1", "cuda:1"],
                  processes=RANKS)


def test_a_row_lives_in_one_rank():
    with pytest.raises(ValueError, match="lives in one process"):
        make_mesh(SHAPE, devices=["cpu"] * 4, processes=[0, 1, 0, 1])
