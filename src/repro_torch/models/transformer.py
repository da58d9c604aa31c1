"""Model assembly for the dense family (counterpart of
``repro.models.transformer``).

``Transformer`` is an ``nn.Module`` trunk: the embedding tables, an
``nn.ModuleList`` of pre-norm attention + MLP layers and the final norm,
each holding the reference's parameter names in its ``(in, out)`` layout
(``layers[i].attn["wq"]`` is the reference's ``layers["attn"]["wq"][i]``),
so weights carry across by an unstack (``interop.model_params``), never a
transpose.  The reference scans over layers stacked on a leading L axis;
the port loops over the module list.

Entry points, as in the reference:
  forward()      -- logits over all positions (training / encoding)
  prefill()      -- full-sequence forward that returns the cache and the
                    last position's logits
  decode_step()  -- one token against the cache (updated in place)

The serving entry points run under ``torch.inference_mode()``.  The
families moe, ssm, hybrid, audio and vlm, and MLA attention, come with
ROADMAP item 14c; they raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.dispatch import resolve_device
from .attention import attention_block, attn_params, init_cache
from .config import ModelConfig
from .layers import (apply_norm, embed, embed_params, make_positions, mlp,
                     mlp_params, norm_params, rope_cos_sin, unembed)

__all__ = ["Transformer", "init_params", "forward", "make_cache", "prefill",
           "decode_step", "check_ported"]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.family != "dense" or cfg.use_mla or cfg.n_experts \
            or cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            + (" with MLA" if cfg.use_mla else "")
            + " is not ported yet; the port runs the dense GQA family "
            "(ROADMAP queue A item 14c brings MLA, MoE, SSM, hybrid, audio "
            "and VLM)")


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                             for name, t in tensors.items()})


class Layer(nn.Module):
    """One pre-norm attention + MLP layer: ``ln1``, ``attn``, ``ln2``,
    ``mlp`` parameter dictionaries with the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = _params(norm_params(cfg, device=device))
        self.attn = _params(attn_params(gen, cfg, device=device))
        self.ln2 = _params(norm_params(cfg, device=device))
        self.mlp = _params(mlp_params(gen, cfg, device=device))

    def forward(self, x, cfg: ModelConfig, rope_cs, positions, mode: str,
                cache=None, pos=None, window=None, ring=False):
        h, new_cache = attention_block(self.attn, apply_norm(self.ln1, x, cfg),
                                       cfg, rope_cs, positions, mode,
                                       cache=cache, pos=pos, window=window,
                                       ring=ring)
        x = x + h
        return x + mlp(self.mlp, apply_norm(self.ln2, x, cfg), cfg), new_cache


class Transformer(nn.Module):
    """The dense trunk: ``embed`` (``tok``, ``unembed``), ``layers`` and
    ``final_norm``.  ``forward(batch)`` is :func:`forward`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        check_ported(cfg)
        cfg.validate()
        self.cfg = cfg
        self.embed = _params(embed_params(gen, cfg, device=device))
        self.layers = nn.ModuleList(Layer(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _params(norm_params(cfg, device=device))

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def forward(self, batch: Dict[str, torch.Tensor],
                window: Optional[int] = None):
        return forward(self, self.cfg, batch, window=window)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Transformer:
    """A ``Transformer`` with the reference's initializer (normal weights
    scaled as the reference scales them, unit norms, zero biases), drawn
    from ``generator`` on ``device`` (the CUDA card unless ``"cpu"``).
    ``generator`` defaults to one seeded with 0 on that device.  The draw
    is PyTorch's, not ``jax.random``'s: for the reference's values, carry
    its parameters across with ``interop.model_params``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        return Transformer(cfg, generator, dev)


# ----------------------------------------------------------- trunk


def _run_trunk(model: Transformer, x: torch.Tensor, cfg: ModelConfig, *,
               mode: str, positions, cache=None, pos=None,
               window: Optional[int] = None, ring: bool = False):
    """Apply all layers; returns (x, cache).  ``cache`` is the stacked
    cache (leading L axis) that prefill fills or decode reads and
    updates; each layer works on its own views of it."""
    rope_cs = rope_cos_sin(cfg, positions)
    layer_caches = []
    for i, layer in enumerate(model.layers):
        c = None if cache is None else {n: t[i] for n, t in cache.items()}
        x, c = layer(x, cfg, rope_cs, positions, mode, cache=c, pos=pos,
                     window=window, ring=ring)
        layer_caches.append(c)
    if mode == "prefill" and cache is None:
        cache = {n: torch.stack([c[n] for c in layer_caches])
                 for n in layer_caches[0]}
    return x, cache


def _inputs_to_x(model: Transformer, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]):
    tokens = batch["tokens"].to(model.device)
    x = embed(model.embed, tokens, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, B, S, device=x.device)
    return x, positions.to(x.device)


# ------------------------------------------------------------ entry points


def forward(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor],
            window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux); aux is the MoE
    balance loss, zero for the dense family."""
    check_ported(cfg)
    x, positions = _inputs_to_x(params, cfg, batch)
    window = window if window is not None else cfg.sliding_window
    x, _ = _run_trunk(params, x, cfg, mode="train", positions=positions,
                      window=window)
    x = apply_norm(params.final_norm, x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params.embed, x, cfg), aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               ring: bool = False, device=None) -> dict:
    """Stacked decode cache for all layers: ``k``/``v`` of shape
    (L, B, max_len, KV, hd) in the compute dtype (``positions`` (L,
    max_len), all -1, for a ring)."""
    check_ported(cfg)
    dev = resolve_device(device)
    c = init_cache(cfg, batch, max_len, ring, device=dev)
    return {n: t[None].repeat((cfg.n_layers,) + (1,) * t.ndim)
            for n, t in c.items()}


@torch.inference_mode()
def prefill(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], window: Optional[int] = None,
            ring: bool = False, max_len: Optional[int] = None):
    """Full-sequence forward that also returns the cache and the last
    position's logits (B, 1, V).

    The cache is the reference's (length S; a ring keeps the last
    ``window`` entries) or, with ``max_len``, a plain ``max_len`` cache
    holding the prompt in slots [0, S) -- what the reference gets by
    grafting its prefill cache into ``make_cache(..., max_len)``, without
    the intermediate copy."""
    check_ported(cfg)
    x, positions = _inputs_to_x(params, cfg, batch)
    window = window if window is not None else cfg.sliding_window
    cache = None
    if max_len is not None:
        if ring:
            raise ValueError("max_len is for plain caches; a ring prefill "
                             "returns its own window-long cache")
        cache = make_cache(cfg, x.shape[0], max_len, device=x.device)
    x, cache = _run_trunk(params, x, cfg, mode="prefill",
                          positions=positions, cache=cache, window=window,
                          ring=ring)
    x = apply_norm(params.final_norm, x[:, -1:], cfg)
    return unembed(params.embed, x, cfg), cache


@torch.inference_mode()
def decode_step(params: Transformer, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, pos: int, window: Optional[int] = None,
                ring: bool = False):
    """One decode step: token (B, 1) int against ``cache`` at position
    ``pos`` (a host int, or a 0-d tensor read once).  Returns (logits
    (B, 1, V), cache); the cache is updated in place."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    check_ported(cfg)
    pos = int(pos)
    x = embed(params.embed, token.to(params.device), cfg)
    B = token.shape[0]
    positions = make_positions(cfg, B, 1, offset=pos, device=x.device)
    window = window if window is not None else cfg.sliding_window
    x, cache = _run_trunk(params, x, cfg, mode="decode", positions=positions,
                          cache=cache, pos=pos, window=window, ring=ring)
    x = apply_norm(params.final_norm, x, cfg)
    return unembed(params.embed, x, cfg), cache
