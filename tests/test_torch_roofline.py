"""The port's roofline arithmetic (``repro_torch.launch.roofline``) against
the reference's ``repro.launch.roofline``:

* ``count_params`` and ``model_flops`` equal the reference's exactly for
  all ten architectures and every shape ``configs.applicable`` runs (the
  same float sums over the same leaves in the same order);
* ``RooflineTerms`` with the reference's v5e constants passed in as a
  ``Hardware`` record gives the reference's terms, ``dominant``,
  ``useful_ratio``, ``step_time`` and ``as_dict`` (but its hardware key);
  the port's own record is the H100 data sheet's;
* ``moved_bytes`` equals what ``mesh.gather`` and ``mesh.device_put``
  really copy in one reduced ``sharded_train_step`` on the CPU listed 8
  times at (2, 4), counted by wrapping them; on an ``AbstractMesh`` it
  is the plan's per-position bytes summed over the positions, the
  parameters gathered onto each data-parallel row's device and the
  gradient sum carried from one row's device to the next.
"""
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import roofline as jroof
from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import InputShape
from repro_torch.core.pytree import tree_leaves
from repro_torch.launch import roofline as troof
from repro_torch.launch import run_distributed as rd
from repro_torch.launch import steps as tsteps
from repro_torch.launch.dryrun import abstract_mesh, make_step
from repro_torch.launch.steps import make_trainer
from repro_torch.launch.train import make_stream
from repro_torch.mesh import batch_shardings, device_put, make_mesh
from repro_torch.models import tensor_parallel
from repro_torch.models.tensor_parallel import ROW_GATHERED, TENSOR_PARALLEL

V5E = troof.Hardware("TPU v5e", jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.ICI_BW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_count_params_and_model_flops_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert troof.count_params(tcfg) == jroof.count_params(jcfg)
    ran = 0
    for name, jshape in jconfigs.SHAPES.items():
        tshape = tconfigs.SHAPES[name]
        if not tconfigs.applicable(tcfg, tshape)[0]:
            assert not jconfigs.applicable(jcfg, jshape)[0]
            continue
        assert troof.model_flops(tcfg, tshape) == \
            jroof.model_flops(jcfg, jshape), name
        ran += 1
    assert ran == (4 if tcfg.has_decode else 2)


def test_moe_active_params_are_top_k_of_the_experts():
    total, active = troof.count_params(tconfigs.get_config("qwen2-moe-a2.7b"))
    assert active < total / 3


@pytest.mark.parametrize("terms", [
    (jroof.PEAK_FLOPS, jroof.HBM_BW / 2, jroof.ICI_BW * 2,
     jroof.PEAK_FLOPS * 128, 256),
    (3.1e15, 2.2e12, 1e9, 5e17, 256),
    (1e12, 9e12, 3e11, 0.0, 512),
    (0.0, 0.0, 0.0, 0.0, 1),
])
def test_roofline_terms_equal_the_reference_with_its_constants(terms):
    j = jroof.RooflineTerms(*terms)
    t = troof.RooflineTerms(*terms, hardware=V5E)
    for name in ("t_compute", "t_memory", "t_collective", "dominant",
                 "useful_ratio", "step_time"):
        assert getattr(t, name) == getattr(j, name), name
    d = t.as_dict()
    assert d.pop("hardware") == "TPU v5e"
    assert d == j.as_dict()


def test_h100_record_is_the_data_sheet():
    h = troof.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 450e9)
    t = troof.RooflineTerms(989e12, 3.35e12 / 4, 900e9, 0.0, 1)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 0.25, 2.0)
    assert t.dominant == "collective" and t.hardware is h


def _nbytes(t):
    return t.numel() * t.element_size()


def _copied_by_one_step(monkeypatch, route_name):
    """The bytes one ``sharded_train_step`` of reduced qwen2-moe-a2.7b on
    the CPU listed 8 times at (2, 4) copies on ``route_name``, wrapping
    its copies: ``gather`` writes the whole tensor once and
    ``gather_model_blocks`` each block it returns; ``device_put`` and
    ``put_model_blocks`` make one tensor a distinct (device, block) pair
    (replicas on one device share it).  Returns them and the plan's
    ``moved_bytes`` for that route."""
    cfg = tconfigs.get_config("qwen2-moe-a2.7b").reduced()
    batch_size, seq = 8, 32
    mesh = make_mesh((2, 4), devices=["cpu"] * 8)
    trainer = make_trainer(cfg.replace(attention_impl="chunked"),
                           n_workers=2, lr=1e-3)
    state = rd.shard_state(trainer.init(device="cpu"), mesh)
    plain = make_stream(cfg, batch_size, seq, device="cpu").batch_at(0)
    b = device_put(plain, batch_shardings(plain, mesh, batch_size))
    copied = {"gather": 0, "cut": 0}
    real_gather, real_put = tsteps.gather, rd.device_put
    real_blocks = tsteps.gather_model_blocks
    real_put_blocks = rd.put_model_blocks

    def gather(x, device=None):
        out = real_gather(x, device)
        copied["gather"] += _nbytes(out)
        return out

    def blocks(x, wanted):
        out = real_blocks(x, wanted)
        copied["gather"] += sum(_nbytes(t) for t in out)
        return out

    def count_cut(out):
        copied["cut"] += sum({id(t): _nbytes(t)
                              for t in out.shards.flat}.values())
        return out

    monkeypatch.setattr(tsteps, "gather", gather)
    monkeypatch.setattr(tsteps, "gather_model_blocks", blocks)
    monkeypatch.setattr(rd, "device_put",
                        lambda tree, sh: count_cut(real_put(tree, sh)))
    monkeypatch.setattr(rd, "put_model_blocks",
                        lambda bl, sh, shape: count_cut(
                            real_put_blocks(bl, sh, shape)))
    monkeypatch.setattr(tensor_parallel, "route", lambda cfg: route_name)
    with mesh:
        rd.sharded_train_step(trainer, state, b, 0)
    specs = make_trainer(cfg, n_workers=2).state_specs()
    want = troof.moved_bytes(specs, mesh, tensor_parallel=(
        route_name == TENSOR_PARALLEL))
    return copied, want


def test_moved_bytes_are_what_one_sharded_step_copies(monkeypatch):
    """The step's own route (tensor-parallel for this MoE config): each
    row position's "model" block gathered, the gradients cut from the
    blocks."""
    copied, want = _copied_by_one_step(monkeypatch, TENSOR_PARALLEL)
    assert want == {**copied, "replicate": 0}
    assert copied["gather"] > 0 and copied["cut"] > 0


def test_moved_bytes_on_the_row_gathered_route(monkeypatch):
    """The row-gathered route (every other family's): each leaf gathered
    whole once a row device, the gradients cut from the whole leaves."""
    copied, want = _copied_by_one_step(monkeypatch, ROW_GATHERED)
    assert want == {**copied, "replicate": 0}
    assert copied["gather"] > 0 and copied["cut"] > 0


def test_moved_bytes_on_an_abstract_mesh_are_the_plans_positions():
    """A device a position: the cut puts every position's block, and the
    update copies each block to the positions beside the one it was
    updated on."""
    cfg = tconfigs.get_config("qwen2-moe-a2.7b").reduced()
    mesh = abstract_mesh((2, 4))
    step = make_step(cfg, InputShape("t", 32, 8, "train"), mesh)
    held = step.position_bytes()
    state = step.args[0]
    moved = troof.moved_bytes(state, mesh)
    whole = sum(_nbytes(t) for t in tree_leaves(state.params))
    opt = sum(_nbytes(t) for t in tree_leaves(state.opt))
    # two data-parallel rows on two devices: the gradient sum crosses
    # once from the first row's device to the second's
    assert moved["cut"] == 8 * held["params"] + whole
    assert moved["replicate"] == 8 * (held["params"] + held["opt_state"]) \
        - whole - opt
    assert moved["gather"] == 2 * whole   # onto each row's device
    rows = troof.moved_rows(state, mesh)
    assert sum(r[0] for r in rows) == sum(moved.values())
    assert {r[1] for r in rows} == set(troof.MOVED_KINDS)
    assert np.all([r[0] > 0 for r in rows])
