"""The port's input shapes (``repro_torch.configs.shapes``), abstract
parameter and train-state trees (``models.param_specs``,
``Trainer.state_specs``) and recipes (``launch.recipes``) against the
reference's, exactly: every case of ``tests/test_shapes.py`` on the port,
then for every (architecture, shape) ``applicable``, ``decode_window``,
``cache_len``, ``uses_ring`` and ``input_specs`` (paths, shapes, dtypes),
``recommended_knobs``, and the paths, shapes and dtypes of every leaf of
``param_specs`` and ``state_specs`` at full size -- the port's on the
``meta`` device, the reference's from ``jax.eval_shape``.
"""
import jax
import pytest
import torch

import repro.configs as jconfigs
import repro.configs.shapes as jshapes
from repro.launch.recipes import recommended_knobs as j_knobs
from repro.launch.steps import make_trainer as j_make_trainer
from repro.models import param_specs as j_param_specs
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable, get_config,
                                 input_specs)
from repro_torch.configs.shapes import cache_len, decode_window, uses_ring
from repro_torch.core.pytree import tree_flatten_with_path, tree_leaves
from repro_torch.launch.recipes import recommended_knobs
from repro_torch.launch.steps import make_trainer
from repro_torch.mesh import _key_names
from repro_torch.models import param_specs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, flatten):
    """(path, shape, dtype name) of every leaf."""
    return [("/".join(_key_names(path)), tuple(leaf.shape),
             str(leaf.dtype).replace("torch.", ""))
            for path, leaf in flatten(tree)]


def _jflat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _tflat(tree):
    return tree_flatten_with_path(tree)[0]


def _assert_same_leaves(jtree, ttree):
    j, t = _leaves(jtree, _jflat), _leaves(ttree, _tflat)
    assert len(t) == len(j) > 0
    for a, b in zip(j, t):
        assert a == b
    assert all(leaf.device.type == "meta" for leaf in tree_leaves(ttree))


# --------------------------------------- tests/test_shapes.py, mirrored

def test_long_context_uses_ring_for_attention_archs():
    for a in ARCH_IDS:
        cfg = get_config(a)
        shp = SHAPES["long_500k"]
        if not cfg.has_decode:
            continue
        if cfg.family == "ssm":
            assert not uses_ring(cfg, shp)
            assert decode_window(cfg, shp) is None
        else:
            assert uses_ring(cfg, shp)
            w = decode_window(cfg, shp)
            assert w is not None and w <= 8192
            assert cache_len(cfg, shp) == w


def test_decode_32k_keeps_native_behaviour():
    cfg = get_config("starcoder2-15b")
    shp = SHAPES["decode_32k"]
    assert decode_window(cfg, shp) == 4096
    assert not uses_ring(cfg, shp)
    assert cache_len(cfg, shp) == 32768
    assert decode_window(get_config("yi-34b"), shp) is None


def test_input_specs_are_abstract():
    """Specs are ``meta`` tensors: no storage, however large."""
    for a in ["deepseek-v2-236b", "mamba2-780m", "qwen2-vl-72b",
              "hubert-xlarge"]:
        cfg = get_config(a)
        for s in SHAPES.values():
            if not applicable(cfg, s)[0]:
                continue
            for leaf in tree_leaves(input_specs(cfg, s)):
                assert isinstance(leaf, torch.Tensor), (a, s.name)
                assert leaf.device.type == "meta", (a, s.name)


def test_vlm_specs_include_mrope_positions():
    sp = input_specs(get_config("qwen2-vl-72b"), SHAPES["train_4k"])["batch"]
    assert "positions" in sp and sp["positions"].shape == (3, 256, 4096)
    assert "embeds" in sp and sp["embeds"].shape == (256, 4096, 8192)
    assert sp["embeds"].dtype == torch.bfloat16


def test_audio_specs_are_embeddings_without_positions():
    sp = input_specs(get_config("hubert-xlarge"),
                     SHAPES["prefill_32k"])["batch"]
    assert "embeds" in sp and "tokens" not in sp and "positions" not in sp


def test_mla_cache_is_compressed():
    sp = input_specs(get_config("deepseek-v2-236b"), SHAPES["decode_32k"])
    leaves = tree_leaves(sp["cache"])
    total_per_tok = sum(leaf.numel() // (128 * 32768) for leaf in leaves)
    assert total_per_tok == 60 * (512 + 64)


# ------------------------------------------------------ exact parity

def test_shapes_table_matches_reference():
    assert list(SHAPES) == list(jconfigs.SHAPES)
    for name, s in SHAPES.items():
        j = jconfigs.SHAPES[name]
        assert (s.name, s.seq, s.global_batch, s.kind) == (
            j.name, j.seq, j.global_batch, j.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_policy_and_input_specs_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), get_config(arch)
    for name, shp in SHAPES.items():
        jshp = jconfigs.SHAPES[name]
        assert applicable(tcfg, shp) == jconfigs.applicable(jcfg, jshp)
        assert decode_window(tcfg, shp) == jshapes.decode_window(jcfg, jshp)
        assert cache_len(tcfg, shp) == jshapes.cache_len(jcfg, jshp)
        assert uses_ring(tcfg, shp) == jshapes.uses_ring(jcfg, jshp)
        if applicable(tcfg, shp)[0]:
            _assert_same_leaves(jconfigs.input_specs(jcfg, jshp),
                                input_specs(tcfg, shp))
        assert recommended_knobs(arch, name) == j_knobs(arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), get_config(arch)
    _assert_same_leaves(j_param_specs(jcfg), param_specs(tcfg))
    _assert_same_leaves(j_make_trainer(jcfg, n_workers=4).state_specs(),
                        make_trainer(tcfg, n_workers=4).state_specs())
