"""The sharded prefill (``launch.run_distributed.sharded_prefill``) and an
encoder's sharded forward (``sharded_forward``) on the CPU listed at
every position of a ("data", "model") mesh, for the configs of
``_torch_tp_cases.CASES`` (reduced qwen2.5-32b with two kv heads, its
k / v projections row-parallel as at full width; reduced qwen2-moe-a2.7b;
MLA with DeepSeek's MoE, the VLM and the encoder, each reduced and cut on
its full config's dims), float32, two prompts of 48 tokens (the VLM's
image embeddings with (3, B, S) M-RoPE grids, the second prompt's
positions shifted so that the rows differ; the encoder's frames), under
``attention_impl="pallas"`` (each position calls
``kernels.ops.flash_attention`` on its own heads: the plain version on
the CPU) and the chunked attention, on (1, 4), and under "pallas" on
(1, 2), (2, 2) and (2, 4).  Against the unsharded ``prefill`` (an
encoder's ``forward``) of the same parameters: the last position's (an
encoder's every position's) logits within ``LOGIT_REL`` of their largest
absolute value, the greedy tokens equal, and the cache cut by
``mesh.cache_shardings`` -- every layer's blocks within ``LOGIT_REL`` of
the cache's largest absolute value (a later layer reads a residual
stream that went through row-parallel sums), and where the cached
entries are column-parallel products of the layer's input (k / v at as
many kv heads as query heads) the first layer's blocks bitwise the
unsharded cache's cut by the same plan."""
import numpy as np
import pytest
import torch

from _torch_tp_cases import DECODERS, ENCODERS, tp_cfg
from repro_torch.configs import get_config
from repro_torch.core.pytree import tree_leaves
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import run_distributed as rd
from repro_torch.launch.train import make_stream
from repro_torch.mesh import (batch_shardings, cache_shardings, device_put,
                              make_mesh, param_shardings)
from repro_torch.models import forward, init_params, param_tree, prefill

LOGIT_REL = 1e-5
B, S = 2, 48
OTHER_MESHES = [(1, 2), (2, 2), (2, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, impl, shape):
    cfg = tp_cfg(arch, attention_impl=impl)
    mesh = make_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    tree = param_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
    if cfg.embed_inputs:
        batch = make_stream(cfg, B, S, device="cpu").batch_at(0)
        del batch["targets"]
        if "positions" in batch:
            batch["positions"] = batch["positions"].clone()
            batch["positions"][:, 1] += 5
    else:
        batch = {"tokens": torch.randint(
            0, cfg.vocab, (B, S), dtype=torch.int32,
            generator=torch.Generator().manual_seed(1))}
    return cfg, mesh, tree, batch


def _check_logits(got_l, want_l):
    assert got_l.shape == want_l.shape
    scale = float(want_l.abs().max())
    assert float((got_l - want_l).abs().max()) <= LOGIT_REL * scale
    assert torch.equal(got_l.argmax(-1), want_l.argmax(-1))


def _check_prefill(arch, impl, shape):
    cfg, mesh, tree, batch = _setup(arch, impl, shape)
    want_l, want_c = prefill(tree, cfg, batch)
    stats = {}
    before = fa.flash_attention_bhsd.launches
    got_l, got_c = rd.sharded_prefill(
        device_put(tree, param_shardings(tree, mesh)), cfg, batch, mesh,
        stats=stats)
    assert fa.flash_attention_bhsd.launches == before  # the CPU: no kernel
    assert got_l.shape == (B, 1, cfg.vocab)
    _check_logits(got_l, want_l)
    assert stats["exchanged_bytes"] > 0
    want_cut = device_put(want_c, cache_shardings(want_c, mesh, B, S))
    column = not cfg.use_mla and cfg.n_kv_heads == cfg.n_heads
    for name, a in got_c.items():
        b = want_cut[name]
        assert a.sharding.spec == b.sharding.spec
        assert tuple(a.shape) == tuple(b.shape)
        assert tuple(a.shape[:3]) == (cfg.n_layers, B, S)
        top = max(float(t.abs().max()) for t in b.blocks())
        for x, y in zip(a.blocks(), b.blocks()):
            assert torch.equal(x[0], y[0]) or not column
            assert float((x - y).abs().max()) <= LOGIT_REL * top


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", DECODERS)
def test_sharded_prefill_matches_unsharded(arch, impl):
    _check_prefill(arch, impl, (1, 4))


@pytest.mark.parametrize("shape", OTHER_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", DECODERS)
def test_sharded_prefill_on_other_meshes(arch, shape):
    _check_prefill(arch, "pallas", shape)


def _check_forward(arch, impl, shape):
    cfg, mesh, tree, batch = _setup(arch, impl, shape)
    with torch.inference_mode():
        want, _ = forward(tree, cfg, batch)
    stats = {}
    before = fa.flash_attention_bhsd.launches
    got = rd.sharded_forward(device_put(tree, param_shardings(tree, mesh)),
                             cfg, batch, mesh, stats=stats)
    assert fa.flash_attention_bhsd.launches == before
    assert got.shape == (B, S, cfg.vocab)
    _check_logits(got, want)
    assert stats["exchanged_bytes"] > 0


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", ENCODERS)
def test_sharded_forward_matches_unsharded(arch, impl):
    _check_forward(arch, impl, (1, 4))


@pytest.mark.parametrize("shape", OTHER_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ENCODERS)
def test_sharded_forward_on_other_meshes(arch, shape):
    _check_forward(arch, "pallas", shape)


def test_sharded_prefill_cuts_mrope_positions_on_their_batch_dim():
    """A VLM's (3, B, S) positions on a data axis of 2: each row gets
    its own prompt's grids (the second's shifted), as the reference's
    ``batch_shardings`` places them (on dim 1)."""
    cfg, mesh, _, batch = _setup("qwen2-vl-72b", "pallas", (2, 2))
    rows = rd.row_batches(device_put(batch, batch_shardings(
        batch, mesh, B)), mesh)
    for i in (0, 1):
        assert torch.equal(rows[i]["positions"],
                           batch["positions"][:, i:i + 1])
        assert torch.equal(rows[i]["embeds"], batch["embeds"][i:i + 1])


def test_sharded_prefill_of_a_row_gathered_family():
    """Mamba2 keeps the row-gathered route: its prefill is the unsharded
    one bitwise."""
    cfg = get_config("mamba2-780m").reduced()
    mesh = make_mesh((1, 4), devices=["cpu"] * 4)
    tree = param_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
    tokens = torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    want_l, want_c = prefill(tree, cfg, {"tokens": tokens})
    got_l, got_c = rd.sharded_prefill(
        device_put(tree, param_shardings(tree, mesh)), cfg,
        {"tokens": tokens}, mesh)
    assert torch.equal(got_l, want_l)
    want_cut = device_put(want_c, cache_shardings(want_c, mesh, B, S))
    for a, b in zip(tree_leaves(got_c), tree_leaves(want_cut)):
        assert all(torch.equal(x, y) for x, y in zip(a.blocks(), b.blocks()))
