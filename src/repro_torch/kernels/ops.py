"""The kernels' public entry points (counterpart of ``repro.kernels.ops``).

* ``flash_attention``     -- GQA attention: the G = H / KV query heads of a
                             group share K/V, so their queries fold into
                             extra query rows of the (B * KV)-indexed kernel
                             batch; K/V are never repeated (B6).
* ``ssd_scan_pallas``     -- the full chunked SSD: the intra-chunk kernel
                             B7 plus the host cross-chunk combine.  The name
                             is the reference's; in the port it means the
                             hand-written CUDA kernel, as
                             ``attention_impl="pallas"`` does.
* ``prox_step`` / ``prox_step_tree`` -- re-exported from
  ``kernels.prox_step`` (B4).
* ``rmsnorm_fused``       -- ``kernels.rmsnorm.rmsnorm`` (B5).

Each runs its kernel on CUDA tensors and its plain PyTorch version on CPU
tensors (``kernels.dispatch.kernel_route``).  No model calls B4, B5 or B7,
as none of the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention_bhsd
from .prox_step import prox_step, prox_step_tree  # re-export
from .rmsnorm import rmsnorm as rmsnorm_fused  # re-export
from .ssd_scan import ssd_intra_chunk

__all__ = ["flash_attention", "ssd_scan_pallas", "prox_step",
           "prox_step_tree", "rmsnorm_fused"]


def flash_attention(q, k, v, qpos, kpos, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: float = 1.0) -> torch.Tensor:
    """q (B, Sq, H, d), k (B, Sk, KV, d), v (B, Sk, KV, dv) -> (B, Sq, H, dv).

    The folded rows of one kv head are its G query heads in turn, so their
    positions are ``qpos`` tiled G times: a row's index in the fold is not
    its position, and the kernel masks by position.  v and the output keep
    v's own head dim (MLA's prefill: q/k 192 over v 128)."""
    B, Sq, H, d = q.shape
    KV, dv = k.shape[2], v.shape[3]
    G = H // KV
    # (B, Sq, KV, G, d) -> (B, KV, G, Sq, d) -> (B*KV, G*Sq, d)
    qf = q.reshape(B, Sq, KV, G, d).permute(0, 2, 3, 1, 4).reshape(
        B * KV, G * Sq, d)
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, -1, d)
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, -1, dv)
    qpos_f = qpos.to(torch.int32).repeat(G)
    out = flash_attention_bhsd(qf.contiguous(), kf.contiguous(),
                               vf.contiguous(), qpos_f,
                               kpos.to(torch.int32).contiguous(),
                               causal=causal, window=window, scale=scale)
    out = out.reshape(B, KV, G, Sq, dv).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, dv)


def ssd_scan_pallas(x, dt, A, B, C, chunk: int,
                    h0: Optional[torch.Tensor] = None):
    """Drop-in replacement for ``models.ssm.ssd_chunked`` through the
    intra-chunk kernel B7 ("pallas" keeps the reference's name; in the port
    it is the hand-written CUDA kernel of ``csrc/ssd_scan.cu`` on the card,
    its plain version on the CPU).

    x (Bt, S, H, P), dt (Bt, S, H), A (H,), B/C (Bt, S, G, N), optional h0
    (Bt, H, P, N) -> (y (Bt, S, H, P) in x's dtype, h_final (Bt, H, P, N)
    float32).  Around the kernel, as the reference does it: pad S to whole
    chunks, ``dA = dt * A`` in float32, a sequential loop over the chunks
    ``h = exp(seg_end) * h + s_in`` from ``h0``, and the inter-chunk term
    ``C e^{cums} h_enter``.
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))

    f32 = torch.float32
    dA = dt.to(f32) * A.to(f32)                                # (Bt, S', H)
    BC_ = Bt * nc
    xq = x.reshape(BC_, Q, H, P)
    dtq = dt.reshape(BC_, Q, H).to(f32)
    dAq = dA.reshape(BC_, Q, H)
    Bq = B.reshape(BC_, Q, G, N).to(f32)
    Cq = C.reshape(BC_, Q, G, N).to(f32)

    y_intra, st_in = ssd_intra_chunk(xq, dtq, dAq, Bq, Cq)
    y_intra = y_intra.reshape(Bt, nc, Q, H, P)
    st_in = st_in.reshape(Bt, nc, H, N, P).transpose(3, 4)    # (.., H, P, N)

    cums = torch.cumsum(dAq.reshape(Bt, nc, Q, H), dim=2)
    seg_end = cums[:, :, -1, :]                               # (Bt, nc, H)

    h = (torch.zeros(Bt, H, P, N, dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = torch.exp(seg_end[:, c])[:, :, None, None] * h + st_in[:, c]
    h_enter = torch.stack(h_enter, dim=1)                     # (Bt,nc,H,P,N)

    rep = H // G
    Cfull = C.reshape(Bt, nc, Q, G, N).repeat_interleave(rep, dim=3).to(f32)
    y_inter = torch.einsum("bcthn,bchpn->bcthp",
                           Cfull * torch.exp(cums)[..., None], h_enter)
    y = (y_intra + y_inter).reshape(Bt, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h
