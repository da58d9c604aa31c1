"""The hybrid (zamba2-style) trunk on the CPU against the reference: groups
of ``attn_every`` Mamba2 layers, each preceded by one application of the
shared attention + MLP block.

At ``tests/test_models.py:85``'s config (4 layers in 2 groups of 2), the
reference's parameters carried into the port by ``interop.model_params``:
``forward``, ``prefill`` (logits and the ``{"attn", "ssm"}`` cache) and
a teacher-forced decode after a prefill into a longer cache, within 1e-4
in float32 (the two packages round matmuls, exp and the SSD's sums in
other orders; logits ~1); on the port alone, decode == forward
(``tests/test_models.py:85``, atol 3e-3 there) and the causality
property of ``tests/test_model_properties.py:21``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import make_cache as j_make_cache
from repro.models import prefill as j_prefill
from repro.models.config import ModelConfig as JConfig
from repro_torch import interop
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_params, make_cache, prefill)

HYBRID = dict(name="h", family="hybrid", n_layers=4, attn_every=2,
              d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
              vocab=97, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
              q_chunk=8)
ENV = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    jcfg = JConfig(attention_impl="chunked", **HYBRID)
    jp = jax.jit(j_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(3))
    tcfg = ModelConfig(**{**dataclasses.asdict(jcfg),
                          "attention_impl": "pallas"})
    model = interop.model_params(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    return jcfg, jp, tcfg, model


def test_hybrid_forward_and_prefill_match_reference(carried):
    jcfg, jp, tcfg, model = carried
    assert model.shared.part_names == ("ln1", "attn", "ln2", "mlp")
    toks = np.random.default_rng(0).integers(0, 97, (2, 21)).astype(np.int32)
    jl, _ = jax.jit(lambda p, t: j_forward(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks))
    tl, aux = forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ENV)
    jl1, jc = jax.jit(lambda p, t: j_prefill(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks))
    tl1, tc = prefill(model, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=ENV)
    assert set(tc) == {"attn", "ssm"}
    assert tuple(tc["attn"]["k"].shape) == (2, 2, 21, 4, 16)   # (G, B, S, ..)
    assert tuple(tc["ssm"]["h"].shape)[:3] == (2, 2, 2)        # (G, E, B, ..)
    for part in ("attn", "ssm"):
        for n in tc[part]:
            np.testing.assert_allclose(tc[part][n].numpy(),
                                       np.asarray(jc[part][n]), atol=ENV)


def test_hybrid_teacher_forced_decode_matches_reference(carried):
    """A 10-token prefill into a 20-token cache, then 10 teacher-forced
    decode steps on both packages."""
    jcfg, jp, tcfg, model = carried
    toks = np.random.default_rng(1).integers(0, 97, (2, 20)).astype(np.int32)
    P, L = 10, 20
    _, jpf = jax.jit(lambda p, t: j_prefill(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks[:, :P]))
    jcache = jax.tree_util.tree_map(
        lambda buf, c: jax.lax.dynamic_update_slice_in_dim(buf, c, 0, axis=2)
        if buf.shape != c.shape else c, j_make_cache(jcfg, 2, L), jpf)
    _, tcache = prefill(model, tcfg, {"tokens": torch.from_numpy(
        toks[:, :P])}, max_len=L)
    assert tuple(tcache["attn"]["k"].shape)[2] == L
    jstep = jax.jit(lambda p, c, t, pos: j_decode_step(p, jcfg, c, t, pos))
    for t in range(P, L):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, tcache = decode_step(model, tcfg, tcache,
                                 torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ENV,
                                   err_msg=str(t))
    np.testing.assert_allclose(tcache["ssm"]["h"].numpy(),
                               np.asarray(jcache["ssm"]["h"]), atol=ENV)


def test_hybrid_decode_matches_forward():
    """``tests/test_models.py:85`` on the port (atol 3e-3 there)."""
    cfg = ModelConfig(**HYBRID)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 10),
                         generator=torch.Generator().manual_seed(1))
    full, _ = forward(model, cfg, {"tokens": toks})
    cache = make_cache(cfg, 1, 10, device="cpu")
    for t in range(10):
        lg, cache = decode_step(model, cfg, cache, toks[:, t:t + 1], t)
        assert float((lg[0, 0] - full[0, t]).abs().max()) < 3e-3


_PROPS_CFG = ModelConfig(**{**HYBRID, "n_layers": 2, "vocab": 61})
_PROPS_MODEL = init_params(_PROPS_CFG, torch.Generator().manual_seed(7),
                           device="cpu")


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(4, 28))
def test_hybrid_causality(seed, t):
    """``tests/test_model_properties.py:21`` for the hybrid family:
    perturbing tokens after position t leaves logits[:, :t + 1] as they
    were (the shared attention is causal, the Mamba2 scan and its
    convolution see only the past); atol 2e-4, the reference's."""
    cfg, model = _PROPS_CFG, _PROPS_MODEL
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 32)).astype(
        np.int32))
    toks2 = toks.clone()
    toks2[:, t + 1:] = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, 32 - t - 1)).astype(np.int32))
    l1, _ = forward(model, cfg, {"tokens": toks})
    l2, _ = forward(model, cfg, {"tokens": toks2})
    assert float((l1[:, :t + 1] - l2[:, :t + 1]).abs().max()) <= 2e-4
