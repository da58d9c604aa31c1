"""Mamba2 SSD (state-space duality) scans (counterpart of the scan part of
``repro.models.ssm``).

The selective state-space recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t
    y_t = C_t^T h_t

computed two ways, in composed torch ops:

* :func:`ssd_chunked` -- the chunked SSD algorithm: within chunks of
  length Q the quadratic "attention-like" form, across chunks a sequential
  scan of the chunk-end states, with an optional initial state ``h0``;
* :func:`ssd_recurrent_step` -- one step of the recurrence (decode).

They are the model-side oracles of the SSD kernel B7
(``kernels.ops.ssd_scan_pallas``); no model of the port calls that kernel,
as none of the reference's does.  ``ssm_params``, ``_split_proj``,
``_causal_conv``, ``init_ssm_state`` and ``mamba2_block`` come with the
``ssm`` model family (ROADMAP queue A item 14c).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ssd_chunked", "ssd_recurrent_step"]

NEG_INF = -1e30


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
