"""The port's dry run (``repro_torch.launch.dryrun``) and probe
(``launch.perf_probe``) against the reference's plans and skips:

* the combos it skips, and why, are the reference's (``applicable``:
  hubert-xlarge has no decode step);
* the bytes one position of the 16x16 and 2x16x16 production meshes
  holds of the parameters, the optimizer state and the train inputs, and
  of the decode_32k cache, equal the sums of the reference's
  ``NamedSharding(...).shard_shape`` over ``jax.sharding.AbstractMesh``
  for all ten architectures at full size;
* ``run_one`` writes a full-size record for a train, a prefill and a
  decode step, and a skip record;
* the ``perf_probe`` CLI's ``--describe`` prints the reference's plan
  rows, and ``--metric flops --top 5`` the counted step's top products;
* D1's comparison in bf16 at a reduced size on a (1, 8) mesh: the
  sharded step against the unsharded one, later losses within
  ``D1_BF16_LOSS_ENV`` of the first
  (``chip_smoke.py``'s ``DIST_LOSS_BF16_ENV``, whose float32 basis D1f
  measures on the card).

The FLOP parity with the reference's compiled HLO is in
``test_torch_dryrun_flops.py``, ``test_torch_dryrun_serve_flops.py`` and
``test_torch_dryrun_full.py``.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

import repro.configs as jconfigs
from repro.configs.shapes import cache_len as j_cache_len
from repro.launch import roofline as jroof
from repro.launch.steps import make_trainer as j_make_trainer
from repro.mesh import batch_shardings as j_batch_shardings
from repro.mesh import cache_shardings as j_cache_shardings
from repro.mesh import describe_shardings as j_describe_shardings
from repro.mesh import param_shardings as j_param_shardings
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import run_distributed as rd
from repro_torch.launch.steps import make_trainer
from repro_torch.launch.train import make_stream
from repro_torch.mesh import dp_size, make_mesh
from repro_torch.models import tensor_parallel

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
D1_BF16_LOSS_ENV = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_production_meshes_and_tags():
    assert dryrun.mesh_tag(dryrun.production_mesh()) == "16x16"
    m = dryrun.production_mesh(multi_pod=True)
    assert dryrun.mesh_tag(m) == "2x16x16" and m.size == 512
    assert m.axis_names == ("pod", "data", "model")
    assert dryrun.abstract_mesh((2, 4)).axis_names == ("data", "model")


def test_skips_equal_the_reference():
    mesh = dryrun.production_mesh()
    skipped = []
    for arch in jconfigs.ARCH_IDS:
        jcfg = jconfigs.get_config(arch)
        for name, jshape in jconfigs.SHAPES.items():
            ok, why = jconfigs.applicable(jcfg, jshape)
            if ok:
                assert tconfigs.applicable(tconfigs.get_config(arch),
                                           tconfigs.SHAPES[name])[0]
                continue
            step, port_why = dryrun.build_step(arch, name, mesh)
            assert step is None and port_why == why
            skipped.append((arch, name))
    assert skipped == [("hubert-xlarge", "decode_32k"),
                       ("hubert-xlarge", "long_500k")]


def _j_bytes(tree, shardings) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    sh = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, JNamedSharding))
    assert len(leaves) == len(sh)
    return sum(int(np.prod(s.shard_shape(x.shape), dtype=np.int64))
               * np.dtype(x.dtype).itemsize for x, s in zip(leaves, sh))


def _full_bytes(tree) -> int:
    return sum(int(np.prod(x.shape, dtype=np.int64))
               * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_position_bytes_equal_the_reference_plan(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jmesh = JAbstractMesh(sizes, names)
    mesh = dryrun.abstract_mesh(sizes, names)
    jcfg = jconfigs.get_config(arch)
    jtrain = jconfigs.SHAPES["train_4k"]
    trainer = j_make_trainer(jcfg, n_workers=dp_size(mesh))
    specs = trainer.state_specs()
    jbatch = jconfigs.input_specs(jcfg, jtrain)["batch"]
    rest = specs.opt._replace(inner=None)  # replicated: whole at each
    want = {"params": _j_bytes(specs.params,
                               j_param_shardings(specs.params, jmesh)),
            "opt_state": _j_bytes(specs.opt.inner, j_param_shardings(
                specs.opt.inner, jmesh)) + _full_bytes(rest),
            "inputs": _j_bytes(jbatch, j_batch_shardings(
                jbatch, jmesh, jtrain.global_batch))}
    step, _ = dryrun.build_step(arch, "train_4k", mesh)
    assert step.position_bytes() == want
    if not jcfg.has_decode:
        return
    jdec = jconfigs.SHAPES["decode_32k"]
    cache = jconfigs.input_specs(jcfg, jdec)["cache"]
    step, _ = dryrun.build_step(arch, "decode_32k", mesh)
    held = step.position_bytes()
    assert held["params"] == want["params"]
    assert held["cache"] == _j_bytes(cache, j_cache_shardings(
        cache, jmesh, jdec.global_batch, j_cache_len(jcfg, jdec)))


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-moe-a2.7b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
    ("starcoder2-15b", "decode_32k")])
def test_run_one_writes_a_full_size_record(arch, shape, tmp_path):
    mesh = dryrun.production_mesh()
    rec = dryrun.run_one(arch, shape, mesh, str(tmp_path), verbose=False)
    with open(tmp_path / f"{arch}__{shape}__16x16.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["model_flops_total"] == jroof.model_flops(
        jconfigs.get_config(arch), jconfigs.SHAPES[shape])
    assert rec["step_flops"] > 0 and rec["step_bytes"] > 0
    assert rec["uncounted"] == {}
    assert rec["model_over_step_flops"] == \
        rec["model_flops_total"] / rec["step_flops"]
    kind = tconfigs.SHAPES[shape].kind
    held = set(rec["position_bytes"])
    if kind == "train":
        assert held == {"params", "opt_state", "inputs"}
        assert set(rec["moved_bytes"]) == {"gather", "cut", "replicate"}
    else:
        assert held == ({"params", "inputs", "cache"} if kind == "decode"
                        else {"params", "inputs"})
        assert rec["moved_bytes"] == {}
    bound = rec["roofline_h100"]
    assert bound["step_time_bound_s"] == max(
        bound["t_compute_s"], bound["t_memory_s"], bound["t_collective_s"])


def test_run_one_writes_a_skip_record(tmp_path):
    rec = dryrun.run_one("hubert-xlarge", "long_500k",
                         dryrun.abstract_mesh((2, 4)), str(tmp_path),
                         tag="t", verbose=False)
    with open(tmp_path / "hubert-xlarge__long_500k__2x4__t.json") as f:
        assert json.load(f) == rec
    assert rec["skipped"] == jconfigs.applicable(
        jconfigs.get_config("hubert-xlarge"),
        jconfigs.SHAPES["long_500k"])[1]


def _probe(*args) -> list:
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf_probe", *args],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_perf_probe_describe_prints_the_reference_plan():
    lines = _probe("--arch", "qwen2-moe-a2.7b", "--shape", "train_4k",
                   "--describe")
    from repro.models import param_specs
    specs = param_specs(jconfigs.get_config("qwen2-moe-a2.7b"))
    jmesh = JAbstractMesh((16, 16), ("data", "model"))
    rows = j_describe_shardings(specs, j_param_shardings(specs, jmesh))
    assert lines == [f"{name:48s} {str(shape):28s} {spec}"
                     for name, shape, spec in rows]


def test_perf_probe_lists_the_top_products():
    lines = _probe("--arch", "starcoder2-15b", "--shape", "decode_32k",
                   "--metric", "flops", "--top", "5")
    step, _ = dryrun.build_step("starcoder2-15b", "decode_32k",
                                dryrun.production_mesh())
    tr = op_cost.trace(step.run)
    assert lines[0].startswith(f"total step flops {tr.cost().flops:.3e}")
    top = lines[lines.index("top 5 by flops:") + 1:]
    assert len(top) == 5
    want = op_cost.top_contributors(tr, "flops", 5)
    assert [float(t.split()[0]) for t in top] == \
        [float(f"{v:.3e}") for v, *_ in want]


def test_d1_comparison_in_bf16_holds_its_envelope(monkeypatch):
    """D1 at a reduced size on the CPU listed 8 times: bf16 parameters and
    compute, the sharded step against the unsharded one from the same
    state and stream: step-0 loss bitwise, taus exact, gammas bitwise,
    later losses within ``D1_BF16_LOSS_ENV`` of the first.  The mesh is
    (1, 8): its one data-parallel row computes the whole batch on the
    row-gathered route (the tensor-parallel route's row-parallel sums,
    another float order, are held by ``tests/test_torch_tp_step.py``), so
    only the clip's sum over the blocks differs.  (Two rows sum the gradients
    in row order, two bf16 roundings where the unsharded step has one:
    ``tests/test_torch_dp_step.py`` holds (2, 4) in bf16 to its measured
    envelope, ROADMAP queue C.)"""
    cfg = tconfigs.get_config("qwen2-moe-a2.7b").reduced().replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    steps, batch, seq = 3, 8, 32
    mesh = make_mesh((1, 8), devices=["cpu"] * 8)
    monkeypatch.setattr(tensor_parallel, "route",
                        lambda cfg: tensor_parallel.ROW_GATHERED)
    n = dp_size(mesh)
    trainer = make_trainer(cfg.replace(attention_impl="chunked"),
                           n_workers=n, lr=1e-3)
    stream = make_stream(cfg, batch, seq, device="cpu")
    state = trainer.init(device="cpu")
    plain = []
    for k in range(steps):
        state, m = trainer.train_step(state, stream.batch_at(k), k % n)
        plain.append((float(m["loss"]), np.float32(m["gamma"]),
                      int(m["tau"])))
    _, log = rd.run(cfg, mesh, steps, batch, seq, device="cpu")
    assert log[0]["loss"] == plain[0][0]
    for r, (_, gamma, tau) in zip(log, plain):
        assert r["tau"] == tau
        assert np.float32(r["gamma"]).view(np.int32) == gamma.view(np.int32)
    err = max(abs(r["loss"] - p[0]) for r, p in zip(log[1:], plain[1:]))
    assert err <= D1_BF16_LOSS_ENV * abs(plain[0][0])
