"""Attention for the dense GQA family: train / prefill / decode paths with
plain and ring (sliding-window) KV caches (counterpart of
``repro.models.attention``).

``attend``'s ``impl``:

* ``"pallas"`` -- with ``Sq > 1`` the GQA fold (``kernels.ops``) into the
  hand-written Hopper flash-attention kernel on a CUDA device, or its
  plain PyTorch version on the CPU.  The value keeps the reference's
  name (the reference's Pallas TPU kernel is what the CUDA kernel ports).
  With ``Sq == 1`` it falls to the chunked path, as in the reference.
* ``"chunked"`` -- the (Sq, Sk) scores one q-chunk at a time, exact
  softmax per chunk; the decode step always takes it.
* ``"naive"`` -- all scores at once (the oracle).

Caches are updated in place (the reference returns new arrays); the
functions still return the cache, as the reference does.  MLA
(DeepSeek-V2) comes with ROADMAP item 14c.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import ModelConfig
from .layers import _normal, apply_rope

__all__ = ["NEG_INF", "attn_params", "attend", "init_cache",
           "gqa_attention", "attention_block"]

NEG_INF = -1e30


def _mla_not_ported():
    return NotImplementedError(
        "MLA attention (use_mla=True) is not ported yet: ROADMAP queue A "
        "item 14c")


# ------------------------------------------------------------------ params


def attn_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """GQA projections in the reference's ``(in, out)`` layout."""
    if cfg.use_mla:
        raise _mla_not_ported()
    D = cfg.d_model
    std = D ** -0.5
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _normal(gen, (D, H * hd), std, cfg, device),
         "wk": _normal(gen, (D, KV * hd), std, cfg, device),
         "wv": _normal(gen, (D, KV * hd), std, cfg, device),
         "wo": _normal(gen, (H * hd, D), (H * hd) ** -0.5, cfg, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((n,), dtype=cfg.pdtype, device=device)
    return p


# ----------------------------------------------------------------- attend


def _mask(qpos, kpos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) additive float32 mask from absolute positions (invalid
    kpos = -1)."""
    valid = kpos[None, :] >= 0
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, NEG_INF)


def attend(q, k, v, qpos, kpos, *, causal: bool, window: Optional[int],
           scale: float, q_chunk: int, impl: str = "pallas",
           remat_chunk: bool = False) -> torch.Tensor:
    """q (B,Sq,H,dq), k (B,Sk,KV,dq), v (B,Sk,KV,dv) -> (B,Sq,H,dv).

    GQA grouping is einsum-native (no repeated-KV materialization).
    ``remat_chunk`` is a training knob of the reference (recompute scores
    in the backward pass); the port has no backward yet and ignores it."""
    B, Sq, H, dq = q.shape
    KV = k.shape[2]
    G = H // KV

    if impl == "pallas" and Sq > 1:
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, qpos, kpos, causal=causal,
                                    window=window, scale=scale)

    qg = q.reshape(B, Sq, KV, G, dq)
    # the reference multiplies by the scale rounded to q's dtype; rounded
    # here on the host, since a tensor made on the card from a Python
    # number is a copy that waits for the stream
    sc = float(torch.tensor(scale, dtype=q.dtype))
    kf = k.float()

    def chunk_attend(qc, qpc):
        # operands in their dtype, scores accumulated in float32 (the
        # reference's preferred_element_type): bf16 x bf16 products are
        # exact in float32, so the float32 einsum is that contraction
        s = torch.einsum("bqcgd,bscd->bcgqs", (qc * sc).float(), kf)
        s = s + _mask(qpc, kpos, causal, window)[None, None, None]
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bcgqs,bscd->bqcgd", w.to(v.dtype), v)

    if impl == "naive" or Sq <= q_chunk:
        return chunk_attend(qg, qpos).reshape(B, Sq, H, -1)

    outs = [chunk_attend(qg[:, s:s + q_chunk], qpos[s:s + q_chunk])
            for s in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, -1)


# ------------------------------------------------------------- GQA block


def init_cache(cfg: ModelConfig, batch: int, max_len: int, ring: bool,
               device=None) -> dict:
    """One layer's KV cache (stacked over layers by ``make_cache``)."""
    if cfg.use_mla:
        raise _mla_not_ported()
    dt = cfg.cdtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
    if ring:
        c["positions"] = torch.full((max_len,), -1, dtype=torch.int32,
                                    device=device)
    return c


def _cache_len(cache: dict) -> int:
    return cache["k"].shape[1]


def _cache_write(cache: dict, updates: dict, pos: int, ring: bool) -> dict:
    """Write one token's entries at absolute position ``pos``, in place."""
    S = _cache_len(cache)
    slot = (pos % S) if ring else pos
    for name, u in updates.items():
        cache[name][:, slot:slot + 1] = u
    if ring:
        cache["positions"][slot] = pos
    return cache


def _kpos_of(cache: dict, pos: int, ring: bool) -> torch.Tensor:
    if ring:
        return cache["positions"]
    # plain cache: slots [0, pos] are valid
    idx = torch.arange(_cache_len(cache), dtype=torch.int32,
                       device=cache["k"].device)
    return torch.where(idx <= pos, idx, -1)


def gqa_attention(p, x: torch.Tensor, cfg: ModelConfig, rope_cs, positions,
                  mode: str, cache: Optional[dict] = None,
                  pos: Optional[int] = None, window: Optional[int] = None,
                  ring: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    """Multi-head / grouped-query attention with RoPE and caching.

    mode: "train" (no cache) | "prefill" (fill ``cache``, a preallocated
    layer cache, when given; else return a cache of length S as the
    reference does) | "decode" (Sq == 1; ``pos`` a host int).

    A decode step on a plain cache reads slots ``[0, pos]`` only: the
    reference reads all slots and masks those past ``pos``, which adds
    exact zeros to its sums; reading the live prefix gives the same
    function and makes a step's result independent of the cache length.
    """
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.cdtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = hd ** -0.5

    if mode == "decode":
        pos = int(pos)
        cache = _cache_write(cache, {"k": k, "v": v}, pos, ring)
        live = cache if ring else {n: cache[n][:, :pos + 1] for n in "kv"}
        kpos = _kpos_of(live, pos, ring)
        qpos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        out = attend(q, live["k"], live["v"], qpos, kpos, causal=cfg.causal,
                     window=window, scale=scale, q_chunk=cfg.q_chunk,
                     impl="chunked")
    else:
        # masking uses sequence order, independent of the (possibly
        # multimodal) RoPE position streams
        qpos = torch.arange(S, dtype=torch.int32, device=x.device)
        out = attend(q, k, v, qpos, qpos, causal=cfg.causal, window=window,
                     scale=scale, q_chunk=cfg.q_chunk,
                     impl=cfg.attention_impl, remat_chunk=cfg.remat_chunk)
        if mode == "prefill":
            cache = _prefill_cache(cache, k, v, S, window, ring)
    y = out.reshape(B, S, H * hd) @ p["wo"].to(dt)
    return y, cache


def _prefill_cache(cache: Optional[dict], k, v, S: int,
                   window: Optional[int], ring: bool) -> dict:
    """The prefill's cache: the reference's (length S; for a ring, the last
    ``window`` entries with their positions), written into ``cache`` when
    a longer preallocated plain cache is given."""
    if ring:
        if cache is not None:
            raise ValueError("prefill into a preallocated ring cache is not "
                             "supported; the ring cache is the prefill's own")
        if window and S > window:
            k, v = k[:, -window:], v[:, -window:]
        W = k.shape[1]
        start = max(S - W, 0)
        positions = torch.arange(W, dtype=torch.int32, device=k.device) + start
        return {"k": k, "v": v, "positions": positions}
    if cache is None:
        return {"k": k, "v": v}
    if _cache_len(cache) < S:
        raise ValueError(f"cache of length {_cache_len(cache)} cannot hold a "
                         f"{S}-token prefill")
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    return cache


def attention_block(p, x, cfg: ModelConfig, rope_cs, positions, mode: str,
                    cache=None, pos=None, window=None, ring=False):
    if cfg.use_mla:
        raise _mla_not_ported()
    return gqa_attention(p, x, cfg, rope_cs, positions, mode, cache=cache,
                         pos=pos, window=window, ring=ring)
