"""Model assembly for the dense, MoE and Mamba2 (ssm) families
(counterpart of ``repro.models.transformer``).

``Transformer`` is an ``nn.Module`` trunk: the embedding tables, an
``nn.ModuleList`` of layers and the final norm, each holding the
reference's parameter names in its ``(in, out)`` layout
(``layers[i].attn["wq"]`` is the reference's ``layers["attn"]["wq"][i]``),
so weights carry across by an unstack (``interop.model_params``), never a
transpose.  A layer's parts follow the family, as the reference's
``_layer_params``: pre-norm attention + MLP (``ln1``, ``attn``, ``ln2``,
``mlp``), with ``moe`` in place of ``mlp`` where ``cfg.n_experts`` is
set, or a pre-norm Mamba2 mixer (``ln``, ``mixer``) for ``family="ssm"``.
The reference scans over layers stacked on a leading L axis; the port
loops over the module list.

Entry points, as in the reference:
  forward()      -- logits over all positions (training / encoding) and
                    the MoE balance loss summed over the layers
  loss_fn()      -- the training loss (dense or chunked cross-entropy,
                    plus ``router_aux_coef`` times that sum),
                    differentiable through ``torch.autograd``
  prefill()      -- full-sequence forward that returns the cache and the
                    last position's logits
  decode_step()  -- one token against the cache (updated in place)

The cache is the stacked ``k``/``v`` of the attention layers, or for an
ssm model the stacked Mamba2 state (``h`` (L, B, H, P, N) float32,
``conv`` (L, B, K-1, C)), which has no length axis.

``forward`` and ``loss_fn`` also take the reference's parameter tree
(``param_tree``: ``embed``, ``final_norm`` and ``layers`` with every leaf
stacked on a leading L axis) as a dict of tensors; the trainers hold
their parameters so, take gradients with respect to its leaves, and
checkpoint it in the reference's layout.  With ``cfg.remat`` each layer
is recomputed in the backward pass (``torch.utils.checkpoint``), and the
chunked cross-entropy recomputes each chunk's logits, as the reference's
``jax.checkpoint`` does: memory changes, numbers do not.  Training
refuses ``attention_impl="pallas"``: the flash-attention kernel has no
backward.

The serving entry points run under ``torch.inference_mode()``.  MLA
attention, the hybrid trunk and the audio and VLM frontends come with
ROADMAP item 14c parts 4-5; they raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.stepsize import f32
from ..kernels.dispatch import resolve_device
from .attention import attention_block, attn_params, init_cache
from .config import ModelConfig
from .layers import (apply_norm, embed, embed_params, make_positions, mlp,
                     mlp_params, norm_params, rope_cos_sin, unembed)
from .moe import moe_block, moe_block_capacity, moe_params
from .ssm import init_ssm_state, mamba2_block, ssm_params

__all__ = ["Transformer", "init_params", "forward", "loss_fn", "param_tree",
           "make_cache", "prefill", "decode_step", "check_ported",
           "layer_parts"]

PORTED_FAMILIES = ("dense", "moe", "ssm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.family not in PORTED_FAMILIES or cfg.use_mla \
            or cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            + (" with MLA" if cfg.use_mla else "")
            + " is not ported yet; the port runs the dense, moe and ssm "
            "families (ROADMAP queue A item 14c parts 4-5 bring MLA, the "
            "hybrid trunk and the audio and VLM frontends)")


def layer_parts(cfg: ModelConfig) -> Tuple[str, ...]:
    """The parts of one layer, as the reference's ``_layer_params``."""
    if cfg.family == "ssm":
        return ("ln", "mixer")
    return ("ln1", "attn", "ln2", "moe" if cfg.n_experts else "mlp")


def _layer_tensors(gen, cfg: ModelConfig, device) -> dict:
    """The tensors of each part of ``layer_parts(cfg)``, drawn in order."""
    build = {"attn": attn_params, "mixer": ssm_params, "mlp": mlp_params,
             "moe": moe_params}
    return {part: (build[part](gen, cfg, device=device) if part in build
                   else norm_params(cfg, device=device))
            for part in layer_parts(cfg)}


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                             for name, t in tensors.items()})


def layer_apply(p, x, cfg: ModelConfig, rope_cs, positions, mode: str,
                cache=None, pos=None, window=None, ring=False):
    """One layer on parameters ``p`` (the mappings of ``layer_parts``);
    returns (x, cache, aux).  ``cache`` is the layer's attention cache or
    Mamba2 state, updated in place where one is given; ``aux`` is its MoE
    balance loss, None without experts."""
    if cfg.family == "ssm":
        h, state = mamba2_block(p["mixer"], apply_norm(p["ln"], x, cfg),
                                cfg, mode, state=cache)
        if cache is not None:
            for n in cache:
                cache[n].copy_(state[n])
            state = cache
        return x + h, state, None
    h, new_cache = attention_block(p["attn"], apply_norm(p["ln1"], x, cfg),
                                   cfg, rope_cs, positions, mode,
                                   cache=cache, pos=pos, window=window,
                                   ring=ring)
    x = x + h
    z = apply_norm(p["ln2"], x, cfg)
    if not cfg.n_experts:
        return x + mlp(p["mlp"], z, cfg), new_cache, None
    if cfg.moe_impl == "dense":
        y, aux = moe_block(p["moe"], z, cfg)
    else:
        y, aux = moe_block_capacity(p["moe"], z, cfg, cfg.capacity_factor)
    return x + y, new_cache, aux


class Layer(nn.Module):
    """One layer: the parameter dictionaries of ``layer_parts(cfg)`` with
    the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.part_names = layer_parts(cfg)
        for part, tensors in _layer_tensors(gen, cfg, device).items():
            setattr(self, part, _params(tensors))

    def parts(self) -> dict:
        return {part: getattr(self, part) for part in self.part_names}

    def forward(self, x, cfg: ModelConfig, rope_cs, positions, mode: str,
                cache=None, pos=None, window=None, ring=False):
        return layer_apply(self.parts(), x, cfg, rope_cs, positions, mode,
                           cache=cache, pos=pos, window=window, ring=ring)


class Transformer(nn.Module):
    """The trunk: ``embed`` (``tok``, ``unembed``), ``layers`` and
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
    updates; each layer updates its own views of it in place."""
    rope_cs = rope_cos_sin(cfg, positions)
    layer_caches = []
    for i, layer in enumerate(model.layers):
        c = None if cache is None else {n: t[i] for n, t in cache.items()}
        x, new, _ = layer(x, cfg, rope_cs, positions, mode, cache=c,
                          pos=pos, window=window, ring=ring)
        layer_caches.append(new)
    if mode == "prefill" and cache is None:
        cache = {n: torch.stack([c[n] for c in layer_caches])
                 for n in layer_caches[0]}
    return x, cache


def _inputs_to_x(embed_p, device: torch.device, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]):
    tokens = batch["tokens"].to(device)
    x = embed(embed_p, tokens, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, B, S, device=x.device)
    return x, positions.to(x.device)


# ------------------------------------------------------------ entry points


def param_tree(model: Transformer) -> dict:
    """The model's parameters as the reference's tree of tensors on the
    model's device: ``embed``, ``final_norm``, and ``layers`` with every
    leaf stacked on a leading L axis (new tensors, no autograd)."""
    with torch.no_grad():
        tree = {part: {n: p.detach().clone() for n, p in
                       getattr(model, part).items()}
                for part in ("embed", "final_norm")}
        tree["layers"] = {
            part: {n: torch.stack([getattr(layer, part)[n].detach()
                                   for layer in model.layers])
                   for n in getattr(model.layers[0], part)}
            for part in model.layers[0].part_names}
    return tree


def _parts(params, cfg: ModelConfig):
    """``(embed, [layer parameters], final_norm)`` of a ``Transformer`` or
    of a reference-layout tree (layer ``i`` is slice ``i`` of each
    stacked leaf)."""
    if isinstance(params, Transformer):
        return (params.embed, [layer.parts() for layer in params.layers],
                params.final_norm)
    parts = layer_parts(cfg)
    if set(params) != {"embed", "layers", "final_norm"} \
            or set(params["layers"]) != set(parts):
        raise ValueError(
            f"a parameter tree of {cfg.name} has embed, final_norm and "
            f"layers ({', '.join(parts)}); got {sorted(params)} with layers "
            f"{sorted(params.get('layers', ()))}")
    stacked = params["layers"]
    n_layers = stacked[parts[0]]["scale"].shape[0]
    layers = [{part: {n: t[i] for n, t in stacked[part].items()}
               for part in parts} for i in range(n_layers)]
    return params["embed"], layers, params["final_norm"]


def _hidden(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            window: Optional[int]):
    """The trunk in training mode up to the final norm: ``(x, embed,
    aux)``, aux the MoE balance loss summed over the layers in order."""
    check_ported(cfg)
    embed_p, layers, final = _parts(params, cfg)
    x, positions = _inputs_to_x(embed_p, final["scale"].device, cfg, batch)
    window = window if window is not None else cfg.sliding_window
    rope_cs = rope_cos_sin(cfg, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        def run(x, p=p):
            x, _, aux_l = layer_apply(p, x, cfg, rope_cs, positions,
                                      "train", window=window)
            return x, aux_l
        x, aux_l = (checkpoint(run, x, use_reentrant=False) if remat
                    else run(x))
        if aux_l is not None:
            aux = aux + aux_l
    return apply_norm(final, x, cfg), embed_p, aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over a ``Transformer`` or a parameter tree.
    Returns (logits, aux); aux is the MoE balance loss summed over the
    layers, zero without experts."""
    x, embed_p, aux = _hidden(params, cfg, batch, window)
    return unembed(embed_p, x, cfg), aux


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(sum nll, sum mask) for logits (B, S, V), labels (B, S) (-1 = pad)."""
    mask = (labels >= 0).to(torch.float32)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1,
                      torch.clamp(labels, min=0).long()[..., None])[..., 0]
    return -torch.sum(ll * mask), torch.sum(mask)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy (plus the MoE aux term) and its parts
    ``{"ce", "aux"}``.  With ``cfg.ce_chunk`` dividing the sequence, the
    logits are made one chunk at a time and recomputed in the backward
    pass, so the (B, S, V) logits never exist at once.  Raises on
    ``attention_impl="pallas"`` while autograd records: the
    flash-attention kernel has no backward."""
    if cfg.attention_impl == "pallas" and torch.is_grad_enabled():
        raise ValueError(
            f"{cfg.name}: attention_impl='pallas' cannot train (the "
            "flash-attention kernel is forward-only); pass "
            "cfg.replace(attention_impl='chunked'), the reference trainer's "
            "attention")
    labels = batch["targets"]
    x, embed_p, aux = _hidden(params, cfg, batch, window)
    labels = labels.to(x.device)
    C = cfg.ce_chunk
    if C and labels.shape[1] % C == 0:
        def chunk_ce(xc, lc):
            return _ce_terms(unembed(embed_p, xc, cfg), lc)
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(0, labels.shape[1], C):
            args = (x[:, s:s + C], labels[:, s:s + C])
            n, c = (checkpoint(chunk_ce, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else chunk_ce(*args))
            nll, cnt = nll + n, cnt + c
    else:
        nll, cnt = _ce_terms(unembed(embed_p, x, cfg), labels)
    ce = nll / torch.clamp(cnt, min=1.0)
    total = ce + f32(cfg.router_aux_coef, ce) * aux
    return total, {"ce": ce, "aux": aux}


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               ring: bool = False, device=None) -> dict:
    """Stacked decode cache for all layers: ``k``/``v`` of shape
    (L, B, max_len, KV, hd) in the compute dtype (``positions`` (L,
    max_len), all -1, for a ring); for an ssm model the zero Mamba2
    state of every layer (``max_len`` and ``ring`` do not enter it)."""
    check_ported(cfg)
    dev = resolve_device(device)
    c = (init_ssm_state(cfg, batch, device=dev) if cfg.family == "ssm"
         else init_cache(cfg, batch, max_len, ring, device=dev))
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
    the intermediate copy.  An ssm model's cache is its Mamba2 state after
    the prompt, with or without ``max_len`` (the reference's graft keeps
    such a state whole)."""
    check_ported(cfg)
    x, positions = _inputs_to_x(params.embed, params.device, cfg, batch)
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
