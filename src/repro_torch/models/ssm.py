"""Mamba2 (SSD, state-space duality) block (counterpart of
``repro.models.ssm``).

The selective state-space recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t
    y_t = C_t^T h_t + D x_t

computed two ways, in composed torch ops:

* :func:`ssd_chunked` -- the chunked SSD algorithm: within chunks of
  length Q the quadratic "attention-like" form, across chunks a sequential
  scan of the chunk-end states, with an optional initial state ``h0``;
* :func:`ssd_recurrent_step` -- one step of the recurrence (decode).

:func:`mamba2_block` is the full mixer (in-projection, depthwise causal
conv, the scan, the gated RMSNorm, out-projection) in train, prefill and
decode modes; it calls :func:`ssd_chunked`, as the reference's calls its
jnp scan, so the SSD kernel B7 (``kernels.ops.ssd_scan_pallas``) runs in
no model of either package.  Layout follows the reference: heads of size
P = ``ssm_head_dim``, ``ssm_n_groups`` B/C groups, state size N =
``ssm_state``; parameters are its leaves in its layout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _normal, rmsnorm

__all__ = ["ssm_params", "ssd_chunked", "ssd_recurrent_step",
           "init_ssm_state", "mamba2_block", "softplus"]

NEG_INF = -1e30


def ssm_params(gen: Optional[torch.Generator], cfg: ModelConfig,
               device=None) -> dict:
    """The mixer's leaves: ``in_proj`` emits [z (din), x (din), B (G*N),
    C (G*N), dt (H)]; ``A_log``, ``D`` and ``dt_bias`` are float32, the
    rest in the param dtype.  ``gen=None`` allocates the random leaves
    without drawing (``interop`` fills them)."""
    D, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    N, G = cfg.ssm_state, cfg.ssm_n_groups
    conv_ch = din + 2 * G * N
    f32 = torch.float32
    heads = torch.linspace(1e-3, 1e-1, H, dtype=f32, device=device)
    return {
        "in_proj": _normal(gen, (D, 2 * din + 2 * G * N + H), D ** -0.5,
                           cfg, device),
        "conv_w": _normal(gen, (cfg.ssm_conv, conv_ch), 0.1, cfg, device),
        "conv_b": torch.zeros((conv_ch,), dtype=cfg.pdtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(heads)),
        "norm": torch.ones((din,), dtype=cfg.pdtype, device=device),
        "out_proj": _normal(gen, (din, D), din ** -0.5, cfg, device),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    din, G, N = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state
    return torch.split(zxbcdt, [din, din, G * N, G * N,
                                zxbcdt.shape[-1] - 2 * din - 2 * G * N],
                       dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x (B,S,C), w (K,C).  With ``state``
    ((B,K-1,C), decode) prepends it; returns (silu(out), new state).  The
    taps are summed in the reference's order, ``0 + xin[:, 0]*w[0] + ...
    + b``, in x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xin = (torch.cat([state, x], dim=1) if state is not None
           else F.pad(x, (0, 0, K - 1, 0)))
    out = 0
    for i in range(K):
        out = out + xin[:, i:i + S] * w[i]
    new_state = xin[:, -(K - 1):] if K > 1 else None
    return F.silu(out + b), new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log1p(exp(-|x|)) + max(x, 0)`` (``F.softplus``
    turns linear above 20, the reference's formula does not)."""
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp(x, min=0)


def ssd_chunked(x, dt, A, B, C, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x  (Bt, S, H, P)   inputs per head
    dt (Bt, S, H)      positive step sizes
    A  (H,)            negative decay rates
    B  (Bt, S, G, N)   input projections (G groups broadcast over H)
    C  (Bt, S, G, N)   output projections
    h0 optional (Bt, H, P, N) initial state.
    Returns (y (Bt, S, H, P) in x's dtype, h_final (Bt, H, P, N) float32).
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if H % G:
        raise ValueError(f"ssd_chunked: H={H} is not a multiple of G={G}")
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    out_dtype = x.dtype
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))

    f32 = torch.float32
    xq = x.reshape(Bt, nc, Q, H, P).to(f32)
    dtq = dt.reshape(Bt, nc, Q, H).to(f32)
    Bq = B.reshape(Bt, nc, Q, G, N).repeat_interleave(rep, dim=3).to(f32)
    Cq = C.reshape(Bt, nc, Q, G, N).repeat_interleave(rep, dim=3).to(f32)

    dA = dtq * A.to(f32)                        # (Bt, nc, Q, H) negative
    cums = torch.cumsum(dA, dim=2)              # within-chunk cumulative
    seg_end = cums[:, :, -1, :]                 # (Bt, nc, H)

    # intra-chunk: y[t] = sum_{s<=t} C_t.B_s x_s e^{cums_t - cums_s}
    decay = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (.., t, s, H)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: exp of the (positive) upper triangle overflows
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], decay,
                                 torch.full_like(decay, NEG_INF)))
    CB = torch.einsum("bcthn,bcshn->bctsh", Cq, Bq)
    W = CB * Lmat * dtq[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", W, xq)

    # chunk-end states: sum_s e^{seg_end - cums_s} dt_s B_s x_s^T
    state_in = torch.einsum(
        "bcsh,bcshn,bcshp->bchpn",
        torch.exp(seg_end[:, :, None, :] - cums) * dtq, Bq, xq)

    h = (torch.zeros(Bt, H, P, N, dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    h_enter = []
    for c in range(nc):                         # the state entering chunk c
        h_enter.append(h)
        h = torch.exp(seg_end[:, c])[:, :, None, None] * h + state_in[:, c]
    h_enter = torch.stack(h_enter, dim=1)       # (Bt, nc, H, P, N)

    # inter-chunk: y[t] = C_t e^{cums_t} h_enter
    y_inter = torch.einsum("bcthn,bchpn->bcthp",
                           Cq * torch.exp(cums)[..., None], h_enter)
    y = (y_intra + y_inter).reshape(Bt, nc * Q, H, P)[:, :S]
    return y.to(out_dtype), h


def ssd_recurrent_step(xt, dtt, A, Bt_, Ct, h
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  xt (B, H, P), dtt (B, H), Bt_/Ct (B, G, N),
    h (B, H, P, N) -> (y (B, H, P) in xt's dtype, h_new float32)."""
    G = Bt_.shape[1]
    H = xt.shape[1]
    rep = H // G
    f32 = torch.float32
    Bh = Bt_.repeat_interleave(rep, dim=1).to(f32)        # (B, H, N)
    Ch = Ct.repeat_interleave(rep, dim=1).to(f32)
    dA = torch.exp(dtt.to(f32) * A.to(f32))                # (B, H)
    h_new = dA[..., None, None] * h + torch.einsum(
        "bh,bhn,bhp->bhpn", dtt.to(f32), Bh, xt.to(f32))
    y = torch.einsum("bhn,bhpn->bhp", Ch, h_new)
    return y.to(xt.dtype), h_new


def init_ssm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """One layer's decode state: ``h`` (B, H, P, N) float32 and ``conv``
    (B, K-1, conv channels) in the compute dtype."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    return {"h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=cfg.cdtype, device=device)}


def mamba2_block(p, xres: torch.Tensor, cfg: ModelConfig, mode: str,
                 state: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The full Mamba2 mixer.  xres (B, S, D) -> (y (B, S, D), new state):
    the state is None in ``"train"``, the prompt's final state in
    ``"prefill"``, and the state after the one token of ``"decode"``
    (which reads ``state``)."""
    Bt, S, _ = xres.shape
    dt_ = cfg.cdtype
    H, P, N, G = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_n_groups)
    din = cfg.d_inner
    z, xc, Bv, Cv, dt_raw = _split_proj(xres @ p["in_proj"].to(dt_), cfg)

    conv_in = torch.cat([xc, Bv, Cv], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, p["conv_w"].to(dt_), p["conv_b"].to(dt_),
        state["conv"] if mode == "decode" else None)
    xc = conv_out[..., :din]
    Bv = conv_out[..., din:din + G * N].reshape(Bt, S, G, N)
    Cv = conv_out[..., din + G * N:].reshape(Bt, S, G, N)

    dt = softplus(dt_raw.float() + p["dt_bias"])              # (B, S, H)
    A = -torch.exp(p["A_log"])                                 # (H,)
    xh = xc.reshape(Bt, S, H, P)

    if mode == "decode":
        y1, h_new = ssd_recurrent_step(xh[:, 0], dt[:, 0], A, Bv[:, 0],
                                       Cv[:, 0], state["h"])
        y = y1[:, None]
        new_state = {"h": h_new, "conv": conv_state}
    else:
        h0 = state["h"] if state is not None else None
        y, h_fin = ssd_chunked(xh, dt, A, Bv, Cv, cfg.ssm_chunk, h0=h0)
        new_state = ({"h": h_fin, "conv": conv_state} if mode == "prefill"
                     else None)

    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = rmsnorm(y.reshape(Bt, S, din) * F.silu(z), p["norm"])
    return y @ p["out_proj"].to(dt_), new_state
