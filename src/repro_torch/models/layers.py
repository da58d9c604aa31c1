"""Shared neural building blocks: norms, activations, MLPs, embeddings and
rotary embeddings (standard RoPE, partial rotary, Qwen2-VL M-RoPE);
counterpart of ``repro.models.layers``.

Parameters are the reference's: dictionaries (``nn.ParameterDict`` in a
model) holding ``(in, out)`` matrices, so ``x @ w`` is the reference's
``einsum("...d,df->...f", x, w)`` and weights carry across unchanged.
The cast order is the reference's too: ``rmsnorm`` normalizes in float32,
casts back to the input dtype, then scales in that dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["act_constraint", "rmsnorm", "layernorm", "apply_norm",
           "norm_params", "activation", "mlp_params", "mlp", "embed_params",
           "embed", "unembed", "rope_angles", "apply_rope", "mrope_angles",
           "make_positions", "rope_cos_sin"]


def act_constraint(x: torch.Tensor, cfg: ModelConfig,
                   seq_dim: int = 1) -> torch.Tensor:
    """The reference pins activation shardings on a device mesh here; the
    port has no mesh yet (ROADMAP item 12), so this is the identity."""
    return x


def _normal(gen: Optional[torch.Generator], shape, std: float,
            cfg: ModelConfig, device) -> torch.Tensor:
    """``normal(shape) * std`` drawn in float32 from ``gen`` and cast to the
    param dtype (the reference's order; its bits come from ``jax.random``,
    so the values differ -- carry weights across with ``interop``).
    ``gen=None`` allocates the tensor without drawing (``interop`` fills
    it)."""
    if gen is None:
        return torch.empty(shape, dtype=cfg.pdtype, device=device)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(std).to(cfg.pdtype)


# ----------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def norm_params(cfg: ModelConfig, d: Optional[int] = None,
                device=None) -> dict:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=cfg.pdtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.pdtype, device=device)
    return p


# ------------------------------------------------------------ activations


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x).square()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def activation(name: str):
    if name == "silu_glu":
        raise ValueError("GLU handled inside mlp()")
    if name == "gelu":
        return _gelu
    if name == "relu2":  # squared ReLU (nemotron-4)
        return _relu2
    if name == "silu":
        return F.silu
    raise ValueError(name)


# ------------------------------------------------------------------- MLP


def mlp_params(gen: torch.Generator, cfg: ModelConfig,
               d_in: Optional[int] = None, d_ff: Optional[int] = None,
               device=None) -> dict:
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    p = {"w1": _normal(gen, (d, f), d ** -0.5, cfg, device),
         "w2": _normal(gen, (f, d), f ** -0.5, cfg, device)}
    if cfg.act == "silu_glu":
        p["w3"] = _normal(gen, (d, f), d ** -0.5, cfg, device)
    if cfg.mlp_bias:
        p["b1"] = torch.zeros((f,), dtype=cfg.pdtype, device=device)
        p["b2"] = torch.zeros((d,), dtype=cfg.pdtype, device=device)
    return p


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.cdtype
    h = x @ p["w1"].to(dt)
    if cfg.mlp_bias and "b1" in p:
        h = h + p["b1"].to(dt)
    if cfg.act == "silu_glu":
        g = x @ p["w3"].to(dt)
        h = F.silu(g) * h
    else:
        h = activation(cfg.act)(h)
    y = h @ p["w2"].to(dt)
    if cfg.mlp_bias and "b2" in p:
        y = y + p["b2"].to(dt)
    return y


# ------------------------------------------------------------- embeddings


def embed_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    p = {}
    if not cfg.embed_inputs or cfg.family == "vlm":
        p["tok"] = _normal(gen, (cfg.vocab, cfg.d_model), 0.02, cfg, device)
    if not cfg.tie_embeddings or cfg.embed_inputs:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab),
                               cfg.d_model ** -0.5, cfg, device)
    return p


def embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the rows the reference casts, not the whole table
    return p["tok"][tokens.long()].to(cfg.cdtype)


def unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings and "unembed" not in p:
        w = p["tok"].to(cfg.cdtype).T
    else:
        w = p["unembed"].to(cfg.cdtype)
    return x @ w


# ------------------------------------------------------------------ RoPE


def rope_angles(positions: torch.Tensor, dim_half: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim_half) in float32."""
    exps = -torch.arange(0, dim_half, dtype=torch.float32,
                         device=positions.device) / dim_half
    inv = torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads.

    Rotates pairs (x[..., :hd/2], x[..., hd/2:]) -- the 'rotate_half'
    layout of llama-family checkpoints."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def mrope_angles(positions: torch.Tensor, sections: Tuple[int, ...],
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE.  positions (3, B, S) for (temporal, h, w); sections
    split head_dim//2.  Returns cos/sin (B, S, head_dim//2): each frequency
    band uses the position stream of its section."""
    dim_half = sum(sections)
    exps = -torch.arange(0, dim_half, dtype=torch.float32,
                         device=positions.device) / dim_half
    inv = torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * inv       # (3, B, S, dim_half)
    parts, off = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang[i, ..., off:off + sec])
        off += sec
    ang_sel = torch.cat(parts, dim=-1)             # (B, S, dim_half)
    return torch.cos(ang_sel), torch.sin(ang_sel)


def make_positions(cfg: ModelConfig, batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """Default position ids (B, S) int32; (3, B, S) for M-RoPE, with all
    three streams equal (pure-text behaviour)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + int(offset)
    pos = pos.expand(batch, seq)
    if cfg.rope == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor,
                 dim_half: Optional[int] = None):
    if cfg.rope == "none":
        return None
    rot_dim = dim_half or ((cfg.rope_head_dim if cfg.use_mla
                            else cfg.head_dim) // 2)
    if cfg.rope == "mrope":
        return mrope_angles(positions, cfg.mrope_sections, cfg.rope_theta)
    return rope_angles(positions, rot_dim, cfg.rope_theta)
