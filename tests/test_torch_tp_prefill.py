"""The sharded prefill (``launch.run_distributed.sharded_prefill``) on the
CPU listed at every position of a (1, 4) mesh, for reduced qwen2.5-32b
with two kv heads (its k / v projections row-parallel, as at full width)
and reduced qwen2-moe-a2.7b, float32, two prompts of 48 tokens, under
``attention_impl="pallas"`` (each position calls
``kernels.ops.flash_attention`` on its own heads: the plain version on
the CPU) and the chunked attention.  Against the unsharded ``prefill``
of the same parameters: the last position's logits within ``LOGIT_REL``
of their largest absolute value, the greedy tokens equal, and the cache
cut by ``mesh.cache_shardings`` -- every layer's blocks within
``LOGIT_REL`` of the cache's largest absolute value (a later layer reads
a residual stream that went through row-parallel sums), and where k / v
are column-parallel (the MoE config) the first layer's blocks bitwise
the unsharded cache's cut by the same plan."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.pytree import tree_leaves
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import run_distributed as rd
from repro_torch.mesh import (cache_shardings, device_put, make_mesh,
                              param_shardings)
from repro_torch.models import init_params, param_tree, prefill

LOGIT_REL = 1e-5
B, S = 2, 48
OVERRIDES = {"qwen2.5-32b": {"n_kv_heads": 2}, "qwen2-moe-a2.7b": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", sorted(OVERRIDES))
def test_sharded_prefill_matches_unsharded(arch, impl):
    cfg = get_config(arch).reduced().replace(attention_impl=impl,
                                             **OVERRIDES[arch])
    mesh = make_mesh((1, 4), devices=["cpu"] * 4)
    tree = param_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
    tokens = torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    want_l, want_c = prefill(tree, cfg, {"tokens": tokens})
    stats = {}
    before = fa.flash_attention_bhsd.launches
    got_l, got_c = rd.sharded_prefill(
        device_put(tree, param_shardings(tree, mesh)), cfg,
        {"tokens": tokens}, mesh, stats=stats)
    assert fa.flash_attention_bhsd.launches == before  # the CPU: no kernel
    assert got_l.shape == want_l.shape == (B, 1, cfg.vocab)
    scale = float(want_l.abs().max())
    assert float((got_l - want_l).abs().max()) <= LOGIT_REL * scale
    assert torch.equal(got_l.argmax(-1), want_l.argmax(-1))
    assert stats["exchanged_bytes"] > 0
    want_cut = device_put(want_c, cache_shardings(want_c, mesh, B, S))
    for name in ("k", "v"):
        a, b = got_c[name], want_cut[name]
        assert a.sharding.spec == b.sharding.spec
        assert tuple(a.shape) == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                  cfg.head_dim)
        top = max(float(t.abs().max()) for t in b.blocks())
        for x, y in zip(a.blocks(), b.blocks()):
            assert torch.equal(x[0], y[0]) or cfg.n_kv_heads < cfg.n_heads
            assert float((x - y).abs().max()) <= LOGIT_REL * top


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
