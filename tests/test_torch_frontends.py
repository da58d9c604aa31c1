"""The audio and VLM frontends (stubs, as in the reference: inputs are
precomputed embeddings) on the CPU against the reference.

* an encoder (hubert-style: non-causal, layernorm, gelu, no RoPE) runs
  ``forward`` on frame embeddings within 1e-4 of the reference, attends
  both ways (``tests/test_model_properties.py:84``), and has no decode
  step;
* a VLM (M-RoPE) prefills ``EmbedStream`` patch embeddings with their
  (3, B, S) position grids into a longer cache, then decodes text tokens
  through its token table, as ``examples/serve_decode.py:46`` does:
  logits and cache within 1e-4 of the reference's, greedy tokens equal;
  a (B, 1, D) embedding decodes too (``repro.models.decode_step``).

Float32 throughout; the envelope is ``tests/test_torch_models.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import EmbedStream as JEmbedStream
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import make_cache as j_make_cache
from repro.models import prefill as j_prefill
from repro.models.config import ModelConfig as JConfig
from repro_torch import interop
from repro_torch.data import EmbedStream
from repro_torch.models import ModelConfig, decode_step, forward, prefill

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=97, q_chunk=8)
ENCODER = dict(name="e", family="audio", embed_inputs=True, causal=False,
               has_decode=False, norm="layernorm", act="gelu", rope="none",
               mlp_bias=True, **BASE)
VLM = dict(name="v", family="vlm", embed_inputs=True, rope="mrope",
           mrope_sections=(4, 2, 2), qkv_bias=True, **BASE)
ENV = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(fields, seed):
    jcfg = JConfig(attention_impl="chunked", **fields)
    jp = jax.jit(j_init_params, static_argnums=0)(jcfg,
                                                  jax.random.PRNGKey(seed))
    tcfg = ModelConfig(**{**dataclasses.asdict(jcfg),
                          "attention_impl": "pallas"})
    model = interop.model_params(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    return jcfg, jp, tcfg, model


def test_encoder_forward_matches_reference_and_is_bidirectional():
    jcfg, jp, tcfg, model = _carry(ENCODER, 1)
    assert "tok" not in model.embed and "unembed" in model.embed
    emb = np.random.default_rng(0).normal(size=(2, 16, 64)).astype(
        np.float32)
    jl, _ = jax.jit(lambda p, e: j_forward(p, jcfg, {"embeds": e}))(
        jp, jnp.asarray(emb))
    tl, _ = forward(model, tcfg, {"embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ENV)
    # perturbing the last frame moves the first frame's logits (a random
    # perturbation: layernorm takes out a constant shift of a frame)
    emb2 = emb.copy()
    emb2[:, -1] += np.random.default_rng(1).normal(size=64).astype(
        np.float32)
    tl2, _ = forward(model, tcfg, {"embeds": torch.from_numpy(emb2)})
    assert float((tl[:, 0] - tl2[:, 0]).abs().max()) > 1e-6
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(model, tcfg, None, torch.zeros((1, 1, 64)), 0)


def test_vlm_prefill_on_embeds_then_text_decode_matches_reference():
    """36 image patches (a 6 x 6 grid) and 14 text embeddings, prefilled
    into a 60-token cache with their M-RoPE grids, then 10 greedy text
    decode steps."""
    jcfg, jp, tcfg, model = _carry(VLM, 2)
    B, S, L = 2, 50, 60
    js = JEmbedStream(d_model=64, vocab=97, batch=B, seq=S, mrope=True,
                      image_grid=(6, 6)).batch_at(0)
    ts = EmbedStream(d_model=64, vocab=97, batch=B, seq=S, mrope=True,
                     image_grid=(6, 6), device="cpu").batch_at(0)
    for n in ("embeds", "positions"):   # the port's stream is the reference's
        np.testing.assert_array_equal(ts[n].numpy(), np.asarray(js[n]))
    assert tuple(ts["positions"].shape) == (3, B, S)
    jl, jpf = jax.jit(lambda p, b: j_prefill(p, jcfg, b))(
        jp, {n: js[n] for n in ("embeds", "positions")})
    tl, tc = prefill(model, tcfg, {n: ts[n] for n in ("embeds", "positions")},
                     max_len=L)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ENV)
    jc = jax.tree_util.tree_map(
        lambda buf, c: jax.lax.dynamic_update_slice_in_dim(buf, c, 0, axis=2),
        j_make_cache(jcfg, B, L), jpf)
    np.testing.assert_allclose(tc["k"][:, :, :S].numpy(),
                               np.asarray(jpf["k"]), atol=ENV)
    jstep = jax.jit(lambda p, c, t, pos: j_decode_step(p, jcfg, c, t, pos))
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    for pos in range(S, L):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(jp, jc, jtok, jnp.int32(pos))
        tl, tc = decode_step(model, tcfg, tc, ttok, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ENV,
                                   err_msg=str(pos))
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    # one more step on a (B, 1, D) embedding instead of a token
    e = np.random.default_rng(3).normal(size=(B, 1, 64)).astype(np.float32)
    jl, _ = jstep(jp, jc, jnp.asarray(e), jnp.int32(L - 1))
    tl, _ = decode_step(model, tcfg, tc, torch.from_numpy(e), L - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ENV)
