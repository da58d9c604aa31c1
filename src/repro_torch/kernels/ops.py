"""Model-facing wrappers around the kernels (the part of
``repro.kernels.ops`` this slice ports).

* ``flash_attention`` -- GQA attention: the G = H / KV query heads of a
  group share K/V, so their queries fold into extra query rows of the
  (B * KV)-indexed kernel batch; K/V are never repeated.

``prox_step``, ``rmsnorm_fused`` and ``ssd_scan_pallas`` come with
ROADMAP item 14b.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_bhsd

__all__ = ["flash_attention"]


def flash_attention(q, k, v, qpos, kpos, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: float = 1.0) -> torch.Tensor:
    """q (B, Sq, H, d), k/v (B, Sk, KV, d) -> (B, Sq, H, d).

    The folded rows of one kv head are its G query heads in turn, so their
    positions are ``qpos`` tiled G times: a row's index in the fold is not
    its position, and the kernel masks by position."""
    B, Sq, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    # (B, Sq, KV, G, d) -> (B, KV, G, Sq, d) -> (B*KV, G*Sq, d)
    qf = q.reshape(B, Sq, KV, G, d).permute(0, 2, 3, 1, 4).reshape(
        B * KV, G * Sq, d)
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, -1, d)
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, -1, d)
    qpos_f = qpos.to(torch.int32).repeat(G)
    out = flash_attention_bhsd(qf.contiguous(), kf.contiguous(),
                               vf.contiguous(), qpos_f,
                               kpos.to(torch.int32).contiguous(),
                               causal=causal, window=window, scale=scale)
    out = out.reshape(B, KV, G, Sq, d).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, d)
