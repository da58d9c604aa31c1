"""The port's model-sharding planner (``repro_torch.mesh``'s model half)
against the reference's (``repro.mesh`` / ``repro.launch.sharding``).

* Every case of ``tests/test_sharding.py``, on the port's ``AbstractMesh``
  with ``meta`` tensors in place of ``ShapeDtypeStruct``s.
* Exact parity at full size: for the ten architectures, the spec of every
  leaf of the parameter tree and of the optimizer's inner tree (the
  reference's ``jax.eval_shape`` trees against the port's ``meta`` ones),
  of ``batch_shardings`` of every applicable shape's inputs and of
  ``cache_shardings`` of every decode shape's cache (context parallel on
  and off), on the meshes (16, 16), (2, 16, 16), (2, 4), (4,) and (1, 1),
  with FSDP on and off and ``small_out_threshold`` 0 and 1024; the
  ``describe_shardings`` rows and every leaf's ``shard_shape`` too.
* ``device_put`` / ``gather``: every planned leaf of a reduced config cut
  onto the CPU listed 8 times at (2, 4) and put back together bitwise;
  each block of ``shard_shape``; a dim that does not divide raises.
* ``act_constraint``: its spec against the reference's at ranks 2-4, with
  and without ``seq_shard``; the raises without an ambient mesh and for an
  axis the mesh lacks; the identity on values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro.launch.sharding as jsh
import repro.models.layers as jlayers
from repro.launch.steps import make_trainer as j_make_trainer
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import tree_flatten_with_path, tree_leaves
from repro_torch.launch import sharding as tsh
from repro_torch.launch.steps import make_trainer
from repro_torch.mesh import (AbstractMesh, Mesh, NamedSharding, P,
                              _key_names, current_mesh, device_put, gather,
                              make_mesh, make_production_mesh,
                              position_bytes)
from repro_torch.models import forward, init_params, param_tree
from repro_torch.models.layers import act_constraint, act_spec

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((4,), ("model",)),
          ((4,), ("data",)),
          ((1, 1), ("data", "model"))]
PLANS = [dict(fsdp=f, small_out_threshold=t) for f in (True, False)
         for t in (0, 1024)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------- tests/test_sharding.py, mirrored

MESH = AbstractMesh((16, 16), ("data", "model"))
MESH3 = AbstractMesh((2, 16, 16), ("pod", "data", "model"))


def sds(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def spec_of(shardings):
    """{path: spec tuple} of a tree of shardings."""
    return {"/".join(_key_names(path)): tuple(s.spec)
            for path, s in tree_flatten_with_path(shardings)[0]}


def test_megatron_column_and_row_parallel():
    tree = {"layers": {"attn": {"wq": sds(60, 7168, 7168)},
                       "mlp": {"w1": sds(60, 7168, 20480),
                               "w2": sds(60, 20480, 7168)}}}
    sp = spec_of(tsh.param_shardings(tree, MESH))
    assert sp["layers/mlp/w1"] == (None, "data", "model")
    assert sp["layers/mlp/w2"] == (None, "model", "data")
    for leaf in sp.values():
        assert leaf[0] is None


def test_expert_parallel_when_divisible():
    tree = {"layers": {"moe": {"w1": sds(60, 160, 5120, 1536)}}}
    sp = spec_of(tsh.param_shardings(tree, MESH))
    assert sp["layers/moe/w1"][1] == "model"  # 160 experts / 16


def test_expert_fallback_when_not_divisible():
    tree = {"layers": {"moe": {"w1": sds(24, 60, 2048, 1408)}}}
    sp = spec_of(tsh.param_shardings(tree, MESH))
    assert sp["layers/moe/w1"][1] is None     # 60 % 16 != 0
    assert "model" in sp["layers/moe/w1"]     # falls back to a feature dim


def test_small_out_rule_replicates_row_parallel_small_projection():
    tree = {"layers": {"attn": {"w_dkv": sds(60, 5120, 576)}}}
    sp0 = spec_of(tsh.param_shardings(tree, MESH))
    assert sp0["layers/attn/w_dkv"][1] == "model"
    sp1 = spec_of(tsh.param_shardings(tree, MESH, small_out_threshold=1024))
    assert "model" not in sp1["layers/attn/w_dkv"]


def test_embedding_vocab_sharded():
    tree = {"embed": {"tok": sds(152064, 5120)}}
    sp = spec_of(tsh.param_shardings(tree, MESH))
    assert sp["embed/tok"] == ("model", "data")


def test_non_divisible_dims_replicated():
    sp = spec_of(tsh.param_shardings({"x": sds(7, 13)}, MESH))
    assert sp["x"] == (None, None)


def test_batch_sharding_multipod():
    tree = {"tokens": sds(256, 4096, dtype=torch.int32)}
    sp = spec_of(tsh.batch_shardings(tree, MESH3, 256))
    assert sp["tokens"][0] == ("pod", "data")


def test_cache_context_parallel():
    tree = {"ckv": sds(60, 128, 32768, 512)}
    sp0 = spec_of(tsh.cache_shardings(tree, MESH, 128, 32768))
    assert sp0["ckv"][3] == "model"
    sp1 = spec_of(tsh.cache_shardings(tree, MESH, 128, 32768,
                                      context_parallel=True))
    assert sp1["ckv"][2] == "model"
    assert sp1["ckv"][1] == "data"


def test_cache_batch1_context_parallel_over_data():
    tree = {"k": sds(40, 1, 8192, 4, 128)}
    sp = spec_of(tsh.cache_shardings(tree, MESH, 1, 8192))
    assert sp["k"][2] == "data"


def test_recipes_follow_measured_guidance():
    from repro_torch.launch.recipes import recommended_knobs
    k = recommended_knobs("nemotron-4-15b", "train_4k")
    assert k["remat_chunk"] and k["shard_acts"] and k["ce_chunk"] == 512
    assert "ce_chunk" not in recommended_knobs("zamba2-2.7b", "train_4k")
    assert recommended_knobs("qwen2-vl-72b", "train_4k") == dict(
        remat_chunk=True)
    assert recommended_knobs("deepseek-v2-236b", "decode_32k") == dict(
        cp_cache=True)


# -------------------------------------- exact parity at full size

@pytest.fixture(scope="module")
def ref_specs():
    """The reference's abstract trees of every architecture: the train
    state (``Trainer.state_specs``) and the inputs of each applicable
    shape (``input_specs``), all from ``jax.eval_shape``."""
    out = {}
    for arch in jconfigs.ARCH_IDS:
        cfg = jconfigs.get_config(arch)
        shapes = {name: jconfigs.input_specs(cfg, s)
                  for name, s in jconfigs.SHAPES.items()
                  if jconfigs.applicable(cfg, s)[0]}
        out[arch] = (j_make_trainer(cfg, n_workers=4).state_specs(), shapes)
    return out


def _rows(tree, shardings, flatten):
    """(path, shape, spec tuple, shard shape) of every leaf."""
    rows = []
    for (path, leaf), (spath, sh) in zip(flatten(tree), flatten(shardings)):
        assert _key_names(spath) == _key_names(path)
        rows.append(("/".join(_key_names(path)), tuple(leaf.shape),
                     tuple(sh.spec), tuple(sh.shard_shape(leaf.shape))))
    return rows


def _jflat(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]


def _tflat(tree):
    return tree_flatten_with_path(tree)[0]


def _assert_same_plan(jtree, ttree, jshard, tshard):
    j_rows = _rows(jtree, jshard, _jflat)
    t_rows = _rows(ttree, tshard, _tflat)
    assert len(t_rows) == len(j_rows) > 0
    for a, b in zip(j_rows, t_rows):
        assert a == b
    assert tsh.describe_shardings(ttree, tshard) == \
        jsh.describe_shardings(jtree, jshard)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_and_optimizer_plans_match_reference(arch, ref_specs):
    jstate = ref_specs[arch][0]
    tstate = make_trainer(tconfigs.get_config(arch),
                          n_workers=4).state_specs()
    for shape, names in MESHES:
        jm, tm = JAbstractMesh(shape, names), AbstractMesh(shape, names)
        for kw in PLANS:
            for jt, tt in ((jstate.params, tstate.params),
                           (jstate.opt.inner, tstate.opt.inner)):
                _assert_same_plan(jt, tt, jsh.param_shardings(jt, jm, **kw),
                                  tsh.param_shardings(tt, tm, **kw))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_batch_and_cache_plans_match_reference(arch, ref_specs):
    jshapes = ref_specs[arch][1]
    tcfg = tconfigs.get_config(arch)
    assert sorted(jshapes) == sorted(
        n for n, s in tconfigs.SHAPES.items()
        if tconfigs.applicable(tcfg, s)[0])
    for name, jin in jshapes.items():
        shp = tconfigs.SHAPES[name]
        tin = tconfigs.input_specs(tcfg, shp)
        for shape, names in MESHES:
            jm, tm = JAbstractMesh(shape, names), AbstractMesh(shape, names)
            _assert_same_plan(
                jin, tin, jsh.batch_shardings(jin, jm, shp.global_batch),
                tsh.batch_shardings(tin, tm, shp.global_batch))
            if "cache" not in jin:
                continue
            clen = tconfigs.shapes.cache_len(tcfg, shp)
            for cp in (False, True):
                _assert_same_plan(
                    jin["cache"], tin["cache"],
                    jsh.cache_shardings(jin["cache"], jm, shp.global_batch,
                                        clen, context_parallel=cp),
                    tsh.cache_shardings(tin["cache"], tm, shp.global_batch,
                                        clen, context_parallel=cp))


def test_replicated_and_specs():
    tree = {"a": sds(4, 8), "b": [sds(2), sds()]}
    rep = tsh.replicated(tree, MESH)
    assert all(s.spec == P() for s in tree_leaves(rep))
    for spec in ((), ("model",), (None, ("pod", "data"), "model")):
        assert repr(P(*spec)) == repr(JP(*spec))
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(MESH, P("pod"))
    with pytest.raises(ValueError, match="twice"):
        NamedSharding(MESH, P("data", "data"))
    with pytest.raises(ValueError, match="does not divide"):
        NamedSharding(MESH, P("data")).shard_shape((7, 3))


def test_production_meshes_list_the_devices_given():
    m = make_production_mesh(devices=["cpu"] * 256)
    assert m.shape == {"data": 16, "model": 16}
    m3 = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert m3.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_mesh((4,), devices=["cpu"] * 4).axis_names == ("model",)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((2, 4), devices=["cpu"] * 4)


# ------------------------------------------- device_put / gather

@pytest.fixture(scope="module")
def reduced_state():
    cfg = tconfigs.get_config("qwen2-moe-a2.7b").reduced()
    return make_trainer(cfg.replace(attention_impl="chunked"),
                        n_workers=2).init(device="cpu")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else
                  torch.int32 if t.element_size() == 4 else torch.int64)


def test_device_put_gather_round_trip_is_bitwise(reduced_state):
    mesh = make_mesh((2, 4), devices=["cpu"] * 8)
    for tree in (reduced_state.params, reduced_state.opt.inner):
        sh = tsh.param_shardings(tree, mesh)
        put = device_put(tree, sh)
        n_sharded = 0
        for x, s, p in zip(tree_leaves(tree), tree_leaves(sh),
                           tree_leaves(put)):
            assert p.sharding is s and p.shape == tuple(x.shape)
            for pos in np.ndindex(2, 4):
                assert tuple(p.shards[pos].shape) == s.shard_shape(x.shape)
            assert len(p.blocks()) == p.n_blocks
            n_sharded += p.n_blocks > 1
            back = gather(p, "cpu")
            assert back.dtype == x.dtype
            assert torch.equal(_bits(back), _bits(x))
        assert n_sharded >= 10
        # replicas on one device share one tensor: each position holds
        # 1/8 of a leaf cut 8 ways, the whole of a replicated one
        held = position_bytes(put)
        assert held.shape == (2, 4) and held.min() == held.max()


def test_replicas_on_one_device_share_a_tensor():
    mesh = make_mesh((2, 4), devices=["cpu"] * 8)
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    p = device_put(x, NamedSharding(mesh, P(None, "model")))
    assert p.n_blocks == 4
    assert p.shards[0, 1] is p.shards[1, 1]
    assert p.shards[0, 1] is not p.shards[0, 2]
    assert torch.equal(p.shards[1, 3], x[:, 6:8])
    y = x.reshape(8, 4)
    q = device_put(y, NamedSharding(mesh, P(("data", "model"))))
    assert torch.equal(q.shards[1, 0], y[4:5])   # block 1 * 4 + 0
    assert torch.equal(gather(q), y)


def test_device_put_raises_where_a_dim_does_not_divide():
    mesh = make_mesh((2, 4), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="does not divide"):
        device_put(torch.zeros(7, 8), NamedSharding(mesh, P("data")))
    with pytest.raises(TypeError, match="holds no devices"):
        device_put(torch.zeros(4), NamedSharding(MESH, P("data")))


def test_a_model_mesh_lives_in_one_process():
    mesh = Mesh(np.array([["cpu", "cpu"]], dtype=object), ("data", "model"),
                processes=[[0, 1]])
    with pytest.raises(ValueError, match="one process"):
        with mesh:
            pass
    with pytest.raises(ValueError, match="one process"):
        device_put(torch.zeros(2), NamedSharding(mesh, P("model")))


# ------------------------------------------------------ act_constraint

ACT_SHAPES = [(4, 8), (1, 8), (4, 16, 8), (1, 16, 8), (4, 1, 8),
              (4, 16, 2, 8)]


@pytest.mark.parametrize("dp", [("data",), ("pod", "data")])
@pytest.mark.parametrize("seq_shard", [False, True])
def test_act_spec_matches_reference(dp, seq_shard, monkeypatch):
    seen = []

    def record(x, spec):
        seen.append(tuple(spec))
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record)
    jcfg = jconfigs.get_config("qwen2.5-32b").reduced().replace(
        shard_activations=True, seq_shard=seq_shard, act_dp_axes=dp)
    tcfg = tconfigs.get_config("qwen2.5-32b").reduced().replace(
        shard_activations=True, seq_shard=seq_shard, act_dp_axes=dp)
    for shape in ACT_SHAPES:
        jlayers.act_constraint(jnp.zeros(shape), jcfg)
        assert tuple(act_spec(torch.zeros(shape), tcfg)) == seen[-1], shape
    assert len(seen) == len(ACT_SHAPES)


def test_act_constraint_raises_where_the_reference_does():
    jcfg = jconfigs.get_config("qwen2.5-32b").reduced().replace(
        shard_activations=True, seq_shard=True)
    tcfg = tconfigs.get_config("qwen2.5-32b").reduced().replace(
        shard_activations=True, seq_shard=True)
    x = torch.zeros(4, 16, 8)
    assert current_mesh() is None
    with pytest.raises(RuntimeError):
        jlayers.act_constraint(jnp.zeros((4, 16, 8)), jcfg)
    with pytest.raises(RuntimeError, match="ambient mesh"):
        act_constraint(x, tcfg)
    # a mesh without "model": both raise
    jmesh = JMesh(np.array(jax.devices()[:1]), ("data",))
    with jmesh:
        with pytest.raises(ValueError):
            jlayers.act_constraint(jnp.zeros((4, 16, 8)), jcfg)
    with make_mesh((2,), ("data",), devices=["cpu"] * 2):
        with pytest.raises(ValueError, match="'model'"):
            act_constraint(x, tcfg)
    # a mesh with both axes: the value comes back unchanged
    jmesh2 = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))
    with jmesh2:
        y = jlayers.act_constraint(jnp.arange(8.0).reshape(2, 2, 2), jcfg)
    np.testing.assert_array_equal(np.asarray(y),
                                  np.arange(8.0).reshape(2, 2, 2))
    with make_mesh((2, 4), devices=["cpu"] * 8) as mesh:
        assert current_mesh() is mesh
        assert act_constraint(x, tcfg) is x
    assert current_mesh() is None
    # off: no mesh needed
    assert act_constraint(x, tcfg.replace(shard_activations=False)) is x


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-v2-236b",
                                  "mamba2-780m"])
def test_constrained_forward_equals_unconstrained(arch):
    """The call sites (each layer, MLA's latent projection) check the spec
    on the ambient mesh and change no value."""
    cfg = tconfigs.get_config(arch).reduced().replace(
        attention_impl="chunked")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = param_tree(model)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8),
                                     generator=torch.Generator().manual_seed(1))}
    want, _ = forward(params, cfg, batch)
    on = cfg.replace(shard_activations=True, seq_shard=True)
    with pytest.raises(RuntimeError, match="ambient mesh"):
        forward(params, on, batch)
    with make_mesh((2, 4), devices=["cpu"] * 8):
        got, _ = forward(params, on, batch)
    assert torch.equal(got, want)
