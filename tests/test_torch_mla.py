"""MLA (DeepSeek-V2's multi-head latent attention) and B6 at q/k head dims
other than v's, on the CPU, against the reference.

* ``models.attention.mla_attention`` in train, prefill, ring prefill and
  the absorbed decode, at ``tests/test_models.py:73``'s config (nope 16 +
  rope 8 over v 16, so the q/k and v head dims differ), with and without
  the low-rank query, the reference's parameters on both sides.  The
  reference runs its ``"chunked"`` attention: its ``"pallas"`` fold
  reshapes v with q's head dim (ROADMAP, Durable notes), so its configs
  run MLA chunked.  The port runs ``"pallas"`` (the GQA fold into B6's
  plain version here) and ``"chunked"``.
* ``kernels.ops.flash_attention`` (the fold) at dq != dv against the
  reference's ``attend(impl="chunked")``;
* B6's plain version at the new instances' pairs, (80, 80) and
  (192, 128), against the reference's oracle ``flash_attention_ref``;
* decode == forward for an MLA model (``tests/test_models.py:73``).

Envelopes: float32 1e-4 absolute on the block's outputs and caches (the
two packages round matmuls and exp in other orders; outputs ~1); B6's
plain version 2e-5 (float32) and 2e-2 (bfloat16), as
``tests/test_torch_flash_attention.py`` states them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jatt
from repro.models.config import ModelConfig as JConfig
from repro.models.layers import rope_cos_sin as j_rope_cos_sin
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_params, make_cache)
from repro_torch.models import attention as tatt
from repro_torch.models.layers import rope_cos_sin

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=97, q_chunk=8)
MLA = dict(use_mla=True, kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
           v_head_dim=16)
ENV = 1e-4
FA_ENV = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(q_lora, impl):
    jcfg = JConfig(name="m", q_lora_rank=q_lora, attention_impl="chunked",
                   **MLA, **BASE)
    tcfg = ModelConfig(**{**dataclasses.asdict(jcfg),
                          "attention_impl": impl})
    return jcfg, tcfg


def _block(jcfg, B, S, seed):
    """The reference's MLA parameters, an input x and both packages'
    rope tables at positions 0..S-1."""
    jp = jatt.attn_params(jax.random.PRNGKey(seed), jcfg)
    tp = {n: torch.from_numpy(np.asarray(a, np.float32).copy())
          for n, a in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return jp, tp, x, pos


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _j_mla(jcfg, mode, window=None, ring=False):
    """The reference's ``mla_attention`` under ``jax.jit`` (its eager ops
    are slow), one program per mode, window and ring."""
    return jax.jit(lambda p, x, r, c, pos: jatt.mla_attention(
        p, x, jcfg, r, None, mode, cache=c, pos=pos, window=window,
        ring=ring))


@pytest.mark.parametrize("q_lora", [48, None])
@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_mla_train_and_prefill_match_reference(q_lora, impl):
    jcfg, tcfg = _cfgs(q_lora, impl)
    jp, tp, x, pos = _block(jcfg, 2, 21, 1)
    assert set(tp) == set(tatt.attn_params(
        torch.Generator().manual_seed(0), tcfg))
    jr = j_rope_cos_sin(jcfg, jnp.asarray(pos))
    tr = rope_cos_sin(tcfg, torch.from_numpy(pos.copy()))
    for mode in ("train", "prefill"):
        jy, jc = _j_mla(jcfg, mode)(jp, jnp.asarray(x), jr, None, None)
        ty, tc = tatt.mla_attention(tp, torch.from_numpy(x), tcfg, tr, None,
                                    mode)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=ENV)
        if mode == "prefill":
            assert set(tc) == {"ckv", "krope"}
            for n in tc:
                np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), atol=ENV)


def test_mla_ring_prefill_keeps_the_last_window():
    jcfg, tcfg = _cfgs(48, "pallas")
    jp, tp, x, pos = _block(jcfg, 2, 21, 2)
    jr = j_rope_cos_sin(jcfg, jnp.asarray(pos))
    tr = rope_cos_sin(tcfg, torch.from_numpy(pos.copy()))
    for W in (8, 32):
        jy, jc = _j_mla(jcfg, "prefill", W, True)(jp, jnp.asarray(x), jr,
                                                  None, None)
        ty, tc = tatt.mla_attention(tp, torch.from_numpy(x), tcfg, tr, None,
                                    "prefill", window=W, ring=True)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=ENV)
        assert tc["ckv"].shape[1] == min(W, 21)
        np.testing.assert_array_equal(_np(tc["positions"]),
                                      _np(jc["positions"]))
        for n in ("ckv", "krope"):
            np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), atol=ENV)


@pytest.mark.parametrize("ring", [False, True])
def test_mla_absorbed_decode_matches_reference(ring):
    """18 tokens through the absorbed decode one at a time, against the
    latent cache (a plain 18-slot cache, or a ring of 8 with window 8, so
    the ring wraps twice); the ring prefill's own cache is checked
    above."""
    jcfg, tcfg = _cfgs(48, "pallas")
    B, S = 2, 18
    jp, tp, x, pos = _block(jcfg, B, S, 3)
    W = 8 if ring else None
    L = W if ring else S
    jcache = jatt.init_cache(jcfg, B, L, ring)
    tcache = tatt.init_cache(tcfg, B, L, ring)
    for t in range(S):
        xt = x[:, t:t + 1]
        jr = j_rope_cos_sin(jcfg, jnp.asarray(pos[:, t:t + 1]))
        tr = rope_cos_sin(tcfg, torch.from_numpy(pos[:, t:t + 1].copy()))
        jy, jcache = _j_mla(jcfg, "decode", W, ring)(
            jp, jnp.asarray(xt), jr, jcache, jnp.int32(t))
        ty, tcache = tatt.mla_attention(tp, torch.from_numpy(xt), tcfg, tr,
                                        None, "decode", cache=tcache, pos=t,
                                        window=W, ring=ring)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=ENV, err_msg=t)
    for n in tcache:
        np.testing.assert_allclose(_np(tcache[n]), _np(jcache[n]), atol=ENV)


def test_mla_decode_matches_forward():
    """``tests/test_models.py:73`` on the port (atol 3e-3 there): the
    absorbed decode over a model equals the expanded forward."""
    cfg = ModelConfig(name="m", q_lora_rank=48, **MLA, **BASE)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 10),
                         generator=torch.Generator().manual_seed(1))
    full, _ = forward(model, cfg, {"tokens": toks})
    cache = make_cache(cfg, 1, 10, device="cpu")
    assert tuple(cache["ckv"].shape) == (2, 1, 10, 32)
    for t in range(10):
        lg, cache = decode_step(model, cfg, cache, toks[:, t:t + 1], t)
        assert float((lg[0, 0] - full[0, t]).abs().max()) < 3e-3


@pytest.mark.parametrize("dims", [(24, 16, 2), (192, 128, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_fold_at_unequal_head_dims_matches_reference_attend(dims, causal,
                                                            window):
    """The port's GQA fold keeps v's head dim: q/k 24 over v 16 with two
    query heads a KV head, and MLA's full 192 over 128 with G 1."""
    d, dv, G = dims
    B, S, KV = 2, 19, 2
    rng = np.random.default_rng(d)
    q = rng.standard_normal((B, S, KV * G, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dv)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    got = flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)), **kw)
    want = jatt.attend(*map(jnp.asarray, (q, k, v, pos, pos)), q_chunk=8,
                       impl="chunked", **kw)
    assert tuple(got.shape) == (B, S, KV * G, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    via_attend = tatt.attend(*map(torch.from_numpy, (q, k, v, pos, pos)),
                             q_chunk=8, impl="pallas", **kw)
    np.testing.assert_array_equal(via_attend.numpy(), got.numpy())


@pytest.mark.parametrize("dims", [(80, 80), (192, 128)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 13),
                                           (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle_at_new_pairs(dims, causal, window,
                                                     dtype):
    """B6's plain version at the head-dim pairs of zamba2 / hubert (d 80)
    and MLA's prefill (192 over 128), whose kernels are the float32 SIMT
    and the bf16 tensor-core instances, ring holes in kpos, against
    ``repro.kernels.ref.flash_attention_ref``."""
    d, dv = dims
    BH, Sq, Sk = 3, 40, 70
    rng = np.random.default_rng(d + dv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((BH, Sq, d), (BH, Sk, d), (BH, Sk, dv)))
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    qp = (np.arange(Sq) + (Sk - Sq)).astype(np.int32)
    kp = np.where(np.arange(Sk) % 5 == 0, -1, np.arange(Sk)).astype(np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = fa.flash_attention_bhsd(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(qp), torch.from_numpy(kp), causal=causal,
        window=window, scale=d ** -0.5)
    want = jref.flash_attention_ref(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(qp),
        jnp.asarray(kp), causal=causal, window=window, scale=d ** -0.5)
    assert got.dtype == tdt and tuple(got.shape) == (BH, Sq, dv)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=FA_ENV[dtype])
