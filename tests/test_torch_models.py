"""The port's dense model substrate against the reference.

Two kinds of check, at small sizes on the CPU:

* the reference's own model tests on the port (``tests/test_models.py``:
  chunked == naive attention, decode == forward for GQA, ring decode ==
  plain decode, M-RoPE == RoPE for text, pallas == naive end to end);
* cross-package parity: the reference's parameters carried into the port
  by ``interop.model_params``, then ``forward``, ``prefill`` and a
  teacher-forced sequence of ``decode_step`` on both packages, for
  ``qwen2.5-32b.reduced()`` and the ``25m`` preset.

Envelopes on the logits (values of size ~1-5), per test:
  float32: 1e-4 absolute (at most the reference's own 2e-3); the two
    packages round matmuls, exp and pow in other orders.
  bfloat16: 0.1 absolute, about three bfloat16 ulps at the largest
    logits (~4, ulp 1/32); XLA and PyTorch round bfloat16 at other places
    (XLA keeps fused elementwise chains in float32).  Seeds 0-2 of this
    test's inputs differ by at most 0.047.
Greedy tokens must match wherever the reference's top-2 margin exceeds
twice the envelope; the tests count those steps and require most of them
to qualify.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.train import PRESETS as J_PRESETS
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import make_cache as j_make_cache
from repro.models import prefill as j_prefill
from repro.models.attention import attend as j_attend
from repro.models.layers import mrope_angles as j_mrope
from repro.models.layers import rope_angles as j_rope
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch.train import PRESETS
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_params, make_cache, prefill)
from repro_torch.models.attention import attend
from repro_torch.models.layers import mrope_angles, rope_angles

KEY = jax.random.PRNGKey(0)
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=97, q_chunk=8)
F32_ENV = 1e-4
BF16_ENV = 0.1


def _port_cfg(jcfg, **over):
    """The port's ModelConfig with every field of the reference's."""
    return ModelConfig(**{**dataclasses.asdict(jcfg), **over})


def _j_params(jcfg):
    """The reference's parameters for ``jcfg``, made once per shape and
    dtype (the attention impl does not enter them)."""
    return _j_init(jcfg.replace(attention_impl="chunked"))


@functools.lru_cache(maxsize=None)
def _j_init(jcfg):
    return jax.jit(j_init_params, static_argnums=0)(jcfg, KEY)


def _j_call(fn, jcfg, jp, toks):
    """The reference's ``forward`` or ``prefill`` under ``jax.jit``, as its
    serving driver runs the prefill."""
    return jax.jit(lambda p, t: fn(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks))


def _carry(jcfg, **over):
    """(reference params, port model holding them, port config)."""
    jp = _j_params(jcfg)
    tcfg = _port_cfg(jcfg, **over)
    model = interop.model_params(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    return jp, model, tcfg


def _f32(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x, jnp.float32)))


# ------------------------------------------- the reference's model tests

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 9])
def test_chunked_equals_naive_attention(causal, window):
    """``tests/test_models.py:24`` on the port, and the port's chunked
    path against the reference's."""
    B, S, H, KV, hd = 2, 37, 8, 2, 16
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(S, dtype=np.int32)
    kw = dict(causal=causal, window=window, scale=0.25, q_chunk=8)
    a = attend(*map(torch.from_numpy, (q, k, v, pos, pos)), impl="chunked",
               **kw)
    b = attend(*map(torch.from_numpy, (q, k, v, pos, pos)), impl="naive",
               **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    j = j_attend(*map(jnp.asarray, (q, k, v, pos, pos)), impl="chunked",
                 **kw)
    np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=1e-5)


def _decode_matches_forward(cfg, atol, steps=10):
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, steps),
                         generator=torch.Generator().manual_seed(1))
    logits_full, _ = forward(model, cfg, {"tokens": toks})
    cache = make_cache(cfg, 1, steps, device="cpu")
    for t in range(steps):
        lg, cache = decode_step(model, cfg, cache, toks[:, t:t + 1], t)
        err = float((lg[0, 0] - logits_full[0, t]).abs().max())
        assert err < atol, (cfg.name, t, err)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_decode_matches_forward_gqa(impl):
    """``tests/test_models.py:69`` (atol 3e-3 there)."""
    _decode_matches_forward(ModelConfig(name="d", attention_impl=impl,
                                        **BASE), atol=3e-3)


def test_sliding_window_ring_decode_matches_plain():
    """``tests/test_models.py:92``: ring cache of W == plain cache with
    window W (atol 2e-3 there)."""
    cfg = ModelConfig(name="w", **BASE)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    S, W = 24, 8
    toks = torch.randint(0, cfg.vocab, (1, S),
                         generator=torch.Generator().manual_seed(2))
    plain = make_cache(cfg, 1, S, device="cpu")
    ring = make_cache(cfg, 1, W, ring=True, device="cpu")
    for t in range(S):
        lg_p, plain = decode_step(model, cfg, plain, toks[:, t:t + 1], t,
                                  window=W)
        lg_r, ring = decode_step(model, cfg, ring, toks[:, t:t + 1], t,
                                 window=W, ring=True)
        np.testing.assert_allclose(lg_p.numpy(), lg_r.numpy(), atol=2e-3)


def test_mrope_reduces_to_rope_for_text():
    """``tests/test_models.py:131``, and both against the reference."""
    pos = torch.arange(10, dtype=torch.int32)[None]
    pos3 = pos[None].expand(3, 1, 10)
    c1, s1 = rope_angles(pos, 8, 10000.0)
    c3, s3 = mrope_angles(pos3, (4, 2, 2), 10000.0)
    np.testing.assert_allclose(c1.numpy(), c3.numpy(), atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), s3.numpy(), atol=1e-6)
    jc, js = j_rope(jnp.asarray(pos.numpy()), 8, 10000.0)
    jc3, js3 = j_mrope(jnp.asarray(pos3.numpy()), (4, 2, 2), 10000.0)
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(s3.numpy(), np.asarray(js3), atol=1e-6)


def test_pallas_attention_impl_in_model():
    """``tests/test_models.py:151``: 'pallas' (on the CPU, the kernel's
    plain version) == 'naive' end to end (atol 2e-3 there)."""
    cfg_n = ModelConfig(name="n", attention_impl="naive", **BASE)
    cfg_p = ModelConfig(name="p", attention_impl="pallas", **BASE)
    model = init_params(cfg_n, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg_n.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(3))
    ln, _ = forward(model, cfg_n, {"tokens": toks})
    lp, _ = forward(model, cfg_p, {"tokens": toks})
    np.testing.assert_allclose(ln.numpy(), lp.numpy(), atol=2e-3)


def test_encoder_has_no_decode_and_other_families_name_their_item():
    enc = ModelConfig(name="enc", family="audio", embed_inputs=True,
                      causal=False, has_decode=False, **BASE)
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(None, enc, None, torch.zeros((1, 1), dtype=torch.int32),
                    0)
    for arch in ("deepseek-v2-236b", "mamba2-780m", "zamba2-2.7b",
                 "qwen2-moe-a2.7b", "qwen2-vl-72b"):
        with pytest.raises(NotImplementedError, match="item 14c"):
            init_params(get_config(arch).reduced(), device="cpu")


def test_init_params_is_seeded_and_shaped_like_the_reference():
    cfg = get_config("qwen2.5-32b").reduced()
    a = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert not torch.equal(sa["layers.0.attn.wq"],
                           c.state_dict()["layers.0.attn.wq"])
    jshapes = jax.eval_shape(lambda k: j_init_params(
        j_get_config("qwen2.5-32b").reduced(), k), KEY)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes):
        names = [p.key for p in path]
        if names[0] == "layers":
            t = sa[".".join(["layers", "0", *names[1:]])]
            assert tuple(t.shape) == leaf.shape[1:], names
        else:
            assert tuple(sa[".".join(names)].shape) == leaf.shape, names
    assert all(not p.requires_grad for p in a.parameters())
    w = sa["layers.0.mlp.w1"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05


def test_model_params_refuses_a_mismatched_tree():
    jcfg = j_get_config("qwen2.5-32b").reduced()
    jp = jax.tree_util.tree_map(np.asarray, _j_params(jcfg))
    tcfg = _port_cfg(jcfg)
    bad = dict(jp, layers=dict(jp["layers"]))
    bad["layers"]["attn"] = {k: v for k, v in jp["layers"]["attn"].items()
                             if k != "bq"}
    with pytest.raises(ValueError, match="do not match"):
        interop.model_params(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        interop.model_params(jp, tcfg.replace(d_ff=256), device="cpu")


# ------------------------------------------------ cross-package parity

def _parity_configs():
    return {"qwen2.5-32b-reduced": j_get_config("qwen2.5-32b").reduced(),
            "25m": J_PRESETS["25m"]}


def _greedy_agreement(j_logits, t_logits, env):
    """(steps whose reference top-2 margin exceeds 2 env, how many of
    them agree on the argmax)."""
    j = j_logits.reshape(-1, j_logits.shape[-1])
    t = t_logits.reshape(-1, t_logits.shape[-1])
    top2 = np.sort(j, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 2 * env
    agree = np.argmax(j, -1) == np.argmax(t, -1)
    return int(sure.sum()), int((agree & sure).sum())


@pytest.mark.parametrize("name", ["qwen2.5-32b-reduced", "25m"])
@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_forward_and_prefill_match_reference_f32(name, impl):
    jcfg = _parity_configs()[name].replace(attention_impl=impl)
    jp, model, tcfg = _carry(jcfg)
    assert tcfg.attention_impl == impl and tcfg.param_dtype == "float32"
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 24)).astype(
        np.int32)
    jl, _ = _j_call(j_forward, jcfg, jp, toks)
    tl, aux = forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_ENV)
    sure, agree = _greedy_agreement(np.asarray(jl), tl.numpy(), F32_ENV)
    assert sure >= 0.9 * toks.size and agree == sure, (sure, agree)
    jl1, jcache = _j_call(j_prefill, jcfg, jp, toks)
    tl1, tcache = prefill(model, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=F32_ENV)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   atol=F32_ENV)


@pytest.mark.parametrize("name", ["qwen2.5-32b-reduced", "25m"])
def test_teacher_forced_decode_matches_reference_f32(name):
    """Prefill 12 tokens into a 24-token cache, then 12 teacher-forced
    decode steps on both packages."""
    jcfg = _parity_configs()[name]
    jp, model, tcfg = _carry(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 24)).astype(
        np.int32)
    P, L = 12, 24
    _, jpf = _j_call(j_prefill, jcfg, jp, toks[:, :P])
    jcache = jax.tree_util.tree_map(
        lambda buf, c: jax.lax.dynamic_update_slice_in_dim(buf, c, 0, axis=2),
        j_make_cache(jcfg, 2, L), jpf)
    jstep = jax.jit(lambda p, c, t, pos: j_decode_step(p, jcfg, c, t, pos))
    _, tcache = prefill(model, tcfg, {"tokens": torch.from_numpy(
        toks[:, :P])}, max_len=L)
    j_all, t_all = [], []
    for t in range(P, L):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = decode_step(model, tcfg, tcache,
                                 torch.from_numpy(toks[:, t:t + 1]), t)
        j_all.append(np.asarray(jl))
        t_all.append(tl.numpy())
    j_all, t_all = np.stack(j_all), np.stack(t_all)
    np.testing.assert_allclose(t_all, j_all, atol=F32_ENV)
    sure, agree = _greedy_agreement(j_all, t_all, F32_ENV)
    assert sure >= 0.9 * j_all.shape[0] * 2 and agree == sure, (sure, agree)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=F32_ENV)


def test_bf16_forward_and_decode_match_reference():
    """qwen2.5-32b.reduced() with bfloat16 params and compute (the full
    model's dtypes) through the kernel's plain version."""
    jcfg = j_get_config("qwen2.5-32b").reduced().replace(
        param_dtype="bfloat16", compute_dtype="bfloat16",
        attention_impl="pallas")
    jp, model, tcfg = _carry(jcfg)
    assert model.layers[0].attn["wq"].dtype == torch.bfloat16
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 20)).astype(
        np.int32)
    jl, _ = _j_call(j_forward, jcfg, jp, toks)
    tl, _ = forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=BF16_ENV)
    sure, agree = _greedy_agreement(_f32(jl), _f32(tl), BF16_ENV)
    assert sure >= toks.size // 4 and agree == sure, (sure, agree)
    jl1, jpf = _j_call(j_prefill, jcfg, jp, toks[:, :10])
    tl1, tpf = prefill(model, tcfg, {"tokens": torch.from_numpy(
        toks[:, :10])}, max_len=20)
    np.testing.assert_allclose(_f32(tl1), _f32(jl1), atol=BF16_ENV)
    jcache = jax.tree_util.tree_map(
        lambda buf, c: jax.lax.dynamic_update_slice_in_dim(buf, c, 0, axis=2),
        j_make_cache(jcfg, 2, 20), jpf)
    jstep = jax.jit(lambda p, c, t, pos: j_decode_step(p, jcfg, c, t, pos))
    for t in range(10, 14):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tpf = decode_step(model, tcfg, tpf,
                              torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=BF16_ENV)


def test_presets_match_reference():
    for name, jcfg in J_PRESETS.items():
        j = dataclasses.asdict(jcfg)
        t = dataclasses.asdict(PRESETS[name])
        assert j.pop("attention_impl") == "chunked"
        assert t.pop("attention_impl") == "pallas"
        assert t == j, name


def test_model_tree_round_trips_the_reference_tree():
    """``interop.model_tree`` gives back the reference's tree that
    ``model_params`` took, leaf for leaf."""
    jcfg = j_get_config("qwen2.5-32b").reduced()
    jp, model, _ = _carry(jcfg)
    want = jax.tree_util.tree_map(np.asarray, jp)
    got = interop.model_tree(model)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
