"""Attention: GQA/MHA and MLA (DeepSeek-V2); train / prefill / decode
paths with plain and ring (sliding-window) KV caches (counterpart of
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

MLA's train and prefill expand the latent KV once and ``attend`` as MHA
with q/k of nope + rope dims over v's own dim (192 over 128 at full
width); its decode step runs in the absorbed latent form in torch ops
(no kernel), as the reference's does.

Caches are updated in place (the reference returns new arrays); the
functions still return the cache, as the reference does.

On a data-parallel row's tensor-parallel leaves (``models.tensor_parallel``)
``gqa_attention`` trains and prefills each "model" position on its own
query heads and the kv heads they read, ``mla_attention`` on its own
heads of the expanded MHA; their decode steps raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import _normal, act_constraint, apply_rope, rmsnorm
from .tensor_parallel import (add_bias, attention_heads, each, group_of,
                              kv_whole, matmul, whole)

__all__ = ["NEG_INF", "attn_params", "attend", "init_cache",
           "gqa_attention", "mla_attention", "attention_block"]

NEG_INF = -1e30


# ------------------------------------------------------------------ params


def _mla_params(gen, cfg: ModelConfig, device) -> dict:
    """MLA's projections: the latent KV down-projection (``w_dkv``, latent
    rank + rope dim) and its norm, the up-projections ``w_uk`` / ``w_uv``,
    ``wo``, and the query through a low-rank ``wq_a`` / ``q_norm`` /
    ``wq_b`` (``q_lora_rank``) or one ``wq``; the reference's layouts and
    scales."""
    D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    hv = H * cfg.v_head_dim
    p = {"w_dkv": _normal(gen, (D, r + cfg.rope_head_dim), D ** -0.5, cfg,
                          device),
         "kv_norm": torch.ones((r,), dtype=cfg.pdtype, device=device),
         "w_uk": _normal(gen, (r, H * cfg.nope_head_dim), r ** -0.5, cfg,
                         device),
         "w_uv": _normal(gen, (r, hv), r ** -0.5, cfg, device),
         "wo": _normal(gen, (hv, D), hv ** -0.5, cfg, device)}
    if cfg.q_lora_rank:
        rq = cfg.q_lora_rank
        p["wq_a"] = _normal(gen, (D, rq), D ** -0.5, cfg, device)
        p["q_norm"] = torch.ones((rq,), dtype=cfg.pdtype, device=device)
        p["wq_b"] = _normal(gen, (rq, H * qk), rq ** -0.5, cfg, device)
    else:
        p["wq"] = _normal(gen, (D, H * qk), D ** -0.5, cfg, device)
    return p


def attn_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """GQA (or, with ``cfg.use_mla``, MLA) projections in the reference's
    ``(in, out)`` layout."""
    if cfg.use_mla:
        return _mla_params(gen, cfg, device)
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
    With ``remat_chunk`` each chunk's scores are recomputed in the
    backward pass instead of kept (``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint``) while autograd records: memory
    changes, numbers do not."""
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

    if remat_chunk and torch.is_grad_enabled():
        plain = chunk_attend

        def chunk_attend(qc, qpc):
            return checkpoint(plain, qc, qpc, use_reentrant=False)

    if impl == "naive" or Sq <= q_chunk:
        return chunk_attend(qg, qpos).reshape(B, Sq, H, -1)

    outs = [chunk_attend(qg[:, s:s + q_chunk], qpos[s:s + q_chunk])
            for s in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, -1)


# ------------------------------------------------------------- GQA block


def init_cache(cfg: ModelConfig, batch: int, max_len: int, ring: bool,
               device=None) -> dict:
    """One layer's KV cache (stacked over layers by ``make_cache``):
    ``k`` / ``v``, or for MLA the latent ``ckv`` (B, max_len, rank) and
    the shared rope key ``krope`` (B, max_len, rope dim)."""
    dt = cfg.cdtype
    if cfg.use_mla:
        c = {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dt, device=device),
             "krope": torch.zeros((batch, max_len, cfg.rope_head_dim),
                                  dtype=dt, device=device)}
    else:
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if ring:
        c["positions"] = torch.full((max_len,), -1, dtype=torch.int32,
                                    device=device)
    return c


def _entries(cache: dict) -> Tuple[str, ...]:
    """The per-token entries of a layer cache (all but ``positions``)."""
    return tuple(n for n in cache if n != "positions")


def _cache_len(cache: dict) -> int:
    return cache[_entries(cache)[0]].shape[1]


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
                       device=cache[_entries(cache)[0]].device)
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
    tp = group_of(p)
    if tp is not None and mode == "decode":
        raise ValueError("a tensor-parallel decode step is not supported; "
                         "decode on the gathered parameters")
    q = matmul(x, p["wq"], dt)
    k = matmul(x, p["wk"], dt)
    v = matmul(x, p["wv"], dt)
    if cfg.qkv_bias:
        q = add_bias(q, p["bq"], dt)
        k = add_bias(k, p["bk"], dt)
        v = add_bias(v, p["bv"], dt)
    # tensor-parallel: each position's whole query heads and the kv heads
    # they read
    q, k, v, kv_ranges = attention_heads(tp, q, k, v, H, KV, hd)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = each(tp, apply_rope, q, cos, sin, dim=2)
        k = each(tp, apply_rope, k, cos, sin, dim=2)
    scale = hd ** -0.5

    if mode == "decode":
        pos = int(pos)
        cache = _cache_write(cache, {"k": k, "v": v}, pos, ring)
        live = _live(cache, pos, ring)
        kpos = _kpos_of(live, pos, ring)
        qpos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        out = attend(q, live["k"], live["v"], qpos, kpos, causal=cfg.causal,
                     window=window, scale=scale, q_chunk=cfg.q_chunk,
                     impl="chunked")
    else:
        # masking uses sequence order, independent of the (possibly
        # multimodal) RoPE position streams
        qpos = torch.arange(S, dtype=torch.int32, device=x.device)
        out = each(tp, lambda q, k, v, qpos: attend(
            q, k, v, qpos, qpos, causal=cfg.causal, window=window,
            scale=scale, q_chunk=cfg.q_chunk, impl=cfg.attention_impl,
            remat_chunk=cfg.remat_chunk), q, k, v, qpos, dim=2)
        if mode == "prefill":
            cache = _prefill_cache(cache, {"k": kv_whole(k, kv_ranges),
                                           "v": kv_whole(v, kv_ranges)},
                                   S, window, ring)
    out = each(tp, lambda o: o.reshape(B, S, -1), out)
    # wo's cut follows the plan: column-parallel on its output D (the
    # heads' outputs gathered first) or row-parallel on its heads
    return whole(matmul(out, p["wo"], dt)), cache


def _live(cache: dict, pos: int, ring: bool) -> dict:
    """What a decode step at ``pos`` reads: a ring whole, a plain cache's
    slots ``[0, pos]``."""
    return cache if ring else {n: cache[n][:, :pos + 1]
                               for n in _entries(cache)}


def _prefill_cache(cache: Optional[dict], entries: dict, S: int,
                   window: Optional[int], ring: bool) -> dict:
    """The prefill's cache of ``entries`` (each (B, S, ...)): the
    reference's (length S; for a ring, the last ``window`` entries with
    their positions), written into ``cache`` when a longer preallocated
    plain cache is given."""
    if ring:
        if cache is not None:
            raise ValueError("prefill into a preallocated ring cache is not "
                             "supported; the ring cache is the prefill's own")
        if window and S > window:
            entries = {n: t[:, -window:] for n, t in entries.items()}
        first = next(iter(entries.values()))
        W = first.shape[1]
        positions = torch.arange(W, dtype=torch.int32,
                                 device=first.device) + (S - W)
        return {**entries, "positions": positions}
    if cache is None:
        return dict(entries)
    if _cache_len(cache) < S:
        raise ValueError(f"cache of length {_cache_len(cache)} cannot hold a "
                         f"{S}-token prefill")
    for n, t in entries.items():
        cache[n][:, :S] = t
    return cache


# ------------------------------------------------------------- MLA block


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig, rope_cs, positions,
                  mode: str, cache: Optional[dict] = None,
                  pos: Optional[int] = None, window: Optional[int] = None,
                  ring: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    """DeepSeek-V2 Multi-head Latent Attention.

    Train / prefill: expand the latent KV once to MHA (KV = H) and
    ``attend`` with q/k of ``nope + rope`` dims over v of ``v_head_dim``.
    Decode: the absorbed form -- scores and values in the ``kv_lora``
    latent space against the cache of ``ckv`` / ``krope``, float32 scores
    as in the reference, so a token costs O(S r), not O(S H d).  Modes and
    caches as :func:`gqa_attention`.

    On tensor-parallel leaves (train and prefill; decode raises) each
    product takes the plan's cut: the low-rank query's ``wq_a`` and the
    latent's ``w_dkv`` give their outputs whole on the row's first device
    for the norms that read them whole (row-parallel sums, or a
    column-parallel output gathered), ``wq_b`` and ``w_uk`` / ``w_uv``
    give each position its heads (column-parallel, or sliced from a
    row-parallel whole), the shared rope key is added to each position's
    heads, and ``wo`` is row-parallel over the heads or column-parallel
    on its output D."""
    B, S, D = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    dt = cfg.cdtype
    scale = (dn + dr) ** -0.5
    tp = group_of(p)
    if tp is not None and mode == "decode":
        raise ValueError("a tensor-parallel decode step is not supported; "
                         "decode on the gathered parameters")

    if cfg.q_lora_rank:
        qa = rmsnorm(whole(matmul(x, p["wq_a"], dt)), whole(p["q_norm"]))
        q = matmul(qa, p["wq_b"], dt)
    else:
        q = matmul(x, p["wq"], dt)

    ckv_full = act_constraint(whole(matmul(x, p["w_dkv"], dt)),
                              cfg)  # batch-sharded
    ckv, k_rope = ckv_full[..., :r], ckv_full[..., r:]
    ckv = rmsnorm(ckv, whole(p["kv_norm"]))
    cos, sin = rope_cs if rope_cs is not None else (None, None)
    if rope_cs is not None:
        k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    if mode == "decode":
        pos = int(pos)
        q = q.reshape(B, S, H, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        if rope_cs is not None:
            q_rope = apply_rope(q_rope, cos, sin)
        cache = _cache_write(cache, {"ckv": ckv, "krope": k_rope}, pos, ring)
        live = _live(cache, pos, ring)
        kpos = _kpos_of(live, pos, ring)
        # absorbed scores: (q_nope W_uk^T) . ckv, plus the rope part
        w_uk = p["w_uk"].to(dt).reshape(r, H, dn)
        q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)      # (B,1,H,r)
        s = torch.einsum("bqhr,bsr->bhqs", q_abs.float(),
                         live["ckv"].float())
        s = s + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                             live["krope"].float())
        qpos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        s = s * scale + _mask(qpos, kpos, cfg.causal, window)[None, None]
        w = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhqs,bsr->bqhr", w.to(dt), live["ckv"])
        w_uv = p["w_uv"].to(dt).reshape(r, H, dv)
        out = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)         # (B,1,H,dv)
    else:
        # expand once; standard MHA (KV == H), each position on its heads
        q, k_nope, vvec, _ = attention_heads(
            tp, q, matmul(ckv, p["w_uk"], dt), matmul(ckv, p["w_uv"], dt),
            H, H, (dn + dr, dn, dv))
        qpos = torch.arange(S, dtype=torch.int32, device=x.device)

        def heads(q, k_nope, v, k_rope, cos, sin, qpos):
            h = q.shape[2]
            q_nope, q_rope = q[..., :dn], q[..., dn:]
            if cos is not None:
                q_rope = apply_rope(q_rope, cos, sin)
            k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
                B, S, h, dr)], dim=-1)
            q_full = torch.cat([q_nope, q_rope], dim=-1)
            return attend(q_full, k_full, v, qpos, qpos, causal=cfg.causal,
                          window=window, scale=scale, q_chunk=cfg.q_chunk,
                          impl=cfg.attention_impl,
                          remat_chunk=cfg.remat_chunk)
        out = each(tp, heads, q, k_nope, vvec, k_rope, cos, sin, qpos, dim=2)
        if mode == "prefill":
            cache = _prefill_cache(cache, {"ckv": ckv, "krope": k_rope}, S,
                                   window, ring)
    out = each(tp, lambda o: o.reshape(B, S, -1), out)
    return whole(matmul(out, p["wo"], dt)), cache


def attention_block(p, x, cfg: ModelConfig, rope_cs, positions, mode: str,
                    cache=None, pos=None, window=None, ring=False):
    fn = mla_attention if cfg.use_mla else gqa_attention
    return fn(p, x, cfg, rope_cs, positions, mode, cache=cache, pos=pos,
              window=window, ring=ring)
