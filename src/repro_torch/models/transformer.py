"""Model assembly for all six families (counterpart of
``repro.models.transformer``).

* dense / moe / audio / vlm: pre-norm attention (GQA or MLA) + MLP (or
  MoE) layers (``ln1``, ``attn``, ``ln2``, ``mlp`` or ``moe``);
* ssm: pre-norm Mamba2 mixers (``ln``, ``mixer``);
* hybrid (zamba2-style): the Mamba2 layers in groups of ``attn_every``,
  each group preceded by one application of a *shared* attention + MLP
  block (``shared``: ``ln1``, ``attn``, ``ln2``, ``mlp``; one set of
  weights reused by every group).

``Transformer`` is an ``nn.Module`` trunk: the embedding tables, an
``nn.ModuleList`` of layers, the hybrid's ``shared`` block and the final
norm, each holding the reference's parameter names in its ``(in, out)``
layout (``layers[i].attn["wq"]`` is the reference's
``layers["attn"]["wq"][i]``), so weights carry across by an unstack
(``interop.model_params``), never a transpose.  The reference scans over
layers stacked on a leading L axis; the port loops over the module list.

Entry points, as in the reference:
  forward()      -- logits over all positions (training / encoding) and
                    the MoE balance loss summed over the layers
  loss_fn()      -- the training loss (dense or chunked cross-entropy,
                    plus ``router_aux_coef`` times that sum),
                    differentiable through ``torch.autograd``: the
                    composition (``compose_loss``) of one batch's
                    ``loss_parts`` -- the summed nll, the label count and
                    each MoE layer's routing statistics -- which a
                    data-parallel step takes per slice and sums
  prefill()      -- full-sequence forward that returns the cache and the
                    last position's logits
  decode_step()  -- one token (or a (B, 1, D) embedding) against the
                    cache (updated in place)

Inputs are ``tokens`` or, for the audio and VLM frontends (stubs, as in
the reference), precomputed ``embeds`` (B, S, D), with ``positions``
given ((3, B, S) M-RoPE grids for a VLM) or made from the sequence index.
A VLM keeps its token table, so text decodes after an image prefill.

The cache is the stacked ``k``/``v`` (for MLA ``ckv``/``krope``) of the
attention layers; for an ssm model the stacked Mamba2 state (``h`` (L,
B, H, P, N) float32, ``conv`` (L, B, K-1, C)), which has no length axis;
for a hybrid model ``{"attn": (G, ...), "ssm": (G, E, ...)}``, the
shared block's cache of each of the G groups and the state of each of
their E Mamba2 layers.

``forward`` and ``loss_fn`` also take the reference's parameter tree
(``param_tree``: ``embed``, ``final_norm``, ``layers`` with every leaf
stacked on a leading L axis, and ``shared`` for a hybrid model) as a
dict of tensors; the trainers hold their parameters so, take gradients
with respect to its leaves, and checkpoint it in the reference's layout.
With ``cfg.remat`` each layer (a hybrid's group) is recomputed in the
backward pass (``torch.utils.checkpoint``), and the chunked
cross-entropy recomputes each chunk's logits, as the reference's
``jax.checkpoint`` does: memory changes, numbers do not.  Training
refuses ``attention_impl="pallas"``: the flash-attention kernel has no
backward.

The serving entry points run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.stepsize import f32
from ..kernels.dispatch import resolve_device, resolve_device_or_meta
from .attention import attention_block, attn_params, init_cache
from .config import ModelConfig
from .layers import (act_constraint, apply_norm, embed, embed_params,
                     make_positions, mlp, mlp_params, norm_params,
                     rope_cos_sin, unembed)
from .moe import MoeSlice, RouteStats, moe_block, moe_block_capacity, \
    moe_params
from .ssm import init_ssm_state, mamba2_block, ssm_params

__all__ = ["Transformer", "init_params", "forward", "loss_fn", "param_tree",
           "make_cache", "prefill", "decode_step", "layer_parts",
           "param_specs", "SHARED_PARTS", "LossParts", "loss_parts",
           "compose_loss", "moe_layer_count"]

# the hybrid's shared attention + MLP block (the reference's
# ``_shared_block_params``)
SHARED_PARTS = ("ln1", "attn", "ln2", "mlp")


def layer_parts(cfg: ModelConfig) -> Tuple[str, ...]:
    """The parts of one layer, as the reference's ``_layer_params``."""
    if cfg.family in ("ssm", "hybrid"):
        return ("ln", "mixer")
    return ("ln1", "attn", "ln2", "moe" if cfg.n_experts else "mlp")


def _part_tensors(gen, cfg: ModelConfig, parts, device) -> dict:
    """The tensors of each of ``parts``, drawn in order."""
    build = {"attn": attn_params, "mixer": ssm_params, "mlp": mlp_params,
             "moe": moe_params}
    return {part: (build[part](gen, cfg, device=device) if part in build
                   else norm_params(cfg, device=device))
            for part in parts}


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                             for name, t in tensors.items()})


def layer_apply(p, x, cfg: ModelConfig, rope_cs, positions, mode: str,
                cache=None, pos=None, window=None, ring=False,
                moe: Optional[MoeSlice] = None):
    """One layer on parameters ``p`` (the mappings of ``layer_parts``);
    returns (x, cache, aux).  ``cache`` is the layer's attention cache or
    Mamba2 state, updated in place where one is given; ``aux`` is its MoE
    balance loss (with ``moe``, the slice's ``RouteStats``), None without
    experts."""
    x = act_constraint(x, cfg)
    if "mixer" in p:
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
        y, aux = moe_block(p["moe"], z, cfg, ctx=moe)
    else:
        y, aux = moe_block_capacity(p["moe"], z, cfg, cfg.capacity_factor,
                                    ctx=moe)
    return x + y, new_cache, aux


class Layer(nn.Module):
    """One layer: the parameter dictionaries of ``parts`` (default
    ``layer_parts(cfg)``; the hybrid's shared block is a ``Layer`` of
    :data:`SHARED_PARTS`) with the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 parts: Optional[Tuple[str, ...]] = None):
        super().__init__()
        self.part_names = parts or layer_parts(cfg)
        for part, tensors in _part_tensors(gen, cfg, self.part_names,
                                           device).items():
            setattr(self, part, _params(tensors))

    def parts(self) -> dict:
        return {part: getattr(self, part) for part in self.part_names}


class Transformer(nn.Module):
    """The trunk: ``embed`` (``tok``, ``unembed``), ``layers``,
    ``final_norm`` and, for a hybrid model, ``shared`` (a ``Layer`` of
    :data:`SHARED_PARTS`).  ``forward(batch)`` is :func:`forward`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        cfg.validate()
        if cfg.family == "hybrid" and (
                not cfg.attn_every or cfg.n_layers % cfg.attn_every):
            raise ValueError(f"{cfg.name}: hybrid requires n_layers % "
                             "attn_every == 0")
        self.cfg = cfg
        self.embed = _params(embed_params(gen, cfg, device=device))
        self.layers = nn.ModuleList(Layer(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.shared = (Layer(cfg, gen, device, SHARED_PARTS)
                       if cfg.family == "hybrid" else None)
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


def param_specs(cfg: ModelConfig) -> dict:
    """The reference-layout parameter tree (:func:`param_tree`) with every
    leaf on the ``meta`` device: shapes and dtypes, no allocation (the
    reference's ``jax.eval_shape`` of ``init_params``), for planning a
    full-size model's shardings."""
    with torch.no_grad():
        return param_tree(Transformer(cfg, None, torch.device("meta")))


# ----------------------------------------------------------- trunk


def _stack(caches: list) -> dict:
    """Layer caches (nested dicts of tensors) stacked on a new leading
    axis, leaf by leaf."""
    return {n: (_stack([c[n] for c in caches]) if isinstance(t, dict)
                else torch.stack([c[n] for c in caches]))
            for n, t in caches[0].items()}


def _index(cache: Optional[dict], i: int) -> Optional[dict]:
    """The views of layer (or group) ``i`` in a stacked cache."""
    if cache is None:
        return None
    return {n: (_index(t, i) if isinstance(t, dict) else t[i])
            for n, t in cache.items()}


def _run_layers(layers, shared, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str, positions, cache=None, pos=None,
                window: Optional[int] = None, ring: bool = False,
                remat: bool = False,
                moe: Optional[Sequence[MoeSlice]] = None):
    """Apply all layers (``layers``: each layer's parts; ``shared``: the
    hybrid's shared block); returns (x, cache, auxes).  ``cache`` is the
    stacked cache (leading L axis; a hybrid's G and G x E) that a
    prefill fills or a decode reads and updates, each layer through its
    own views, in place; without one a prefill returns the stacked cache
    of its layers.  ``auxes`` holds each MoE layer's balance loss in
    order (with ``moe``, one ``MoeSlice`` a layer, its ``RouteStats``).
    With ``remat`` each layer (a hybrid's group) is recomputed in the
    backward pass."""
    rope_cs = rope_cos_sin(cfg, positions)
    kw = dict(pos=pos, window=window, ring=ring)
    if cfg.family == "hybrid":
        E = cfg.attn_every
        groups = [layers[g:g + E] for g in range(0, len(layers), E)]

        def run(x, g, c):
            """Group ``g``: the shared block, then its Mamba2 layers."""
            h, attn_c = attention_block(
                shared["attn"], apply_norm(shared["ln1"], x, cfg), cfg,
                rope_cs, positions, mode,
                cache=None if c is None else c["attn"], **kw)
            x = x + h
            x = x + mlp(shared["mlp"], apply_norm(shared["ln2"], x, cfg),
                        cfg)
            states = []
            for e, p in enumerate(groups[g]):
                sc = None if c is None else {n: t[e] for n, t in
                                             c["ssm"].items()}
                x, st, _ = layer_apply(p, x, cfg, None, None, mode, cache=sc)
                states.append(st)
            new = ({"attn": attn_c, "ssm": _stack(states)}
                   if mode == "prefill" and c is None else None)
            return x, new, None
    else:
        groups = layers

        def run(x, i, c):
            return layer_apply(layers[i], x, cfg, rope_cs, positions, mode,
                               cache=c, moe=moe[i] if moe else None,
                               **kw)

    auxes = []
    outs = []
    for i in range(len(groups)):
        if remat:
            x, new, aux_l = checkpoint(lambda x, i=i: run(x, i, None), x,
                                       use_reentrant=False)
        else:
            x, new, aux_l = run(x, i, _index(cache, i))
        if aux_l is not None:
            auxes.append(aux_l)
        outs.append(new)
    if mode == "prefill" and cache is None:
        cache = _stack(outs)
    return x, cache, auxes


def _sum_aux(auxes, device) -> torch.Tensor:
    """The layers' balance losses summed in order from zero."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for a in auxes:
        aux = aux + a
    return aux


def _inputs_to_x(embed_p, device: torch.device, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]):
    """``batch["embeds"]`` (cast to the compute dtype) or the embedded
    ``batch["tokens"]``, and the given ``positions`` or the default."""
    if "embeds" in batch:
        x = batch["embeds"].to(device=device, dtype=cfg.cdtype)
    else:
        x = embed(embed_p, batch["tokens"].to(device), cfg)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, B, S, device=x.device)
    return x, positions.to(x.device)


# ------------------------------------------------------------ entry points


def param_tree(model: Transformer) -> dict:
    """The model's parameters as the reference's tree of tensors on the
    model's device: ``embed``, ``final_norm``, ``layers`` with every leaf
    stacked on a leading L axis, and a hybrid's ``shared`` (new tensors,
    no autograd)."""
    with torch.no_grad():
        tree = {part: {n: p.detach().clone() for n, p in
                       getattr(model, part).items()}
                for part in ("embed", "final_norm")}
        tree["layers"] = {
            part: {n: torch.stack([getattr(layer, part)[n].detach()
                                   for layer in model.layers])
                   for n in getattr(model.layers[0], part)}
            for part in model.layers[0].part_names}
        if model.shared is not None:
            tree["shared"] = {part: {n: p.detach().clone() for n, p in
                                     getattr(model.shared, part).items()}
                              for part in SHARED_PARTS}
    return tree


def _tree_keys(cfg: ModelConfig) -> set:
    keys = {"embed", "layers", "final_norm"}
    return keys | {"shared"} if cfg.family == "hybrid" else keys


def _parts(params, cfg: ModelConfig):
    """``(embed, [layer parameters], shared, final_norm)`` of a
    ``Transformer`` or of a reference-layout tree (layer ``i`` is slice
    ``i`` of each stacked leaf); ``shared`` is None but for a hybrid
    model."""
    if isinstance(params, Transformer):
        shared = None if params.shared is None else params.shared.parts()
        return (params.embed, [layer.parts() for layer in params.layers],
                shared, params.final_norm)
    parts = layer_parts(cfg)
    if set(params) != _tree_keys(cfg) \
            or set(params["layers"]) != set(parts) \
            or set(params.get("shared", SHARED_PARTS)) != set(SHARED_PARTS):
        raise ValueError(
            f"a parameter tree of {cfg.name} has "
            f"{', '.join(sorted(_tree_keys(cfg)))} with layers "
            f"({', '.join(parts)}); got {sorted(params)} with layers "
            f"{sorted(params.get('layers', ()))}")
    stacked = params["layers"]
    n_layers = stacked[parts[0]]["scale"].shape[0]
    layers = [{part: {n: t[i] for n, t in stacked[part].items()}
               for part in parts} for i in range(n_layers)]
    return params["embed"], layers, params.get("shared"), \
        params["final_norm"]


def _hidden(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            window: Optional[int], moe=None):
    """The trunk in training mode up to the final norm: ``(x, embed,
    auxes)``, each MoE layer's balance loss (with ``moe``, its
    ``RouteStats``) in order."""
    embed_p, layers, shared, final = _parts(params, cfg)
    x, positions = _inputs_to_x(embed_p, final["scale"].device, cfg, batch)
    window = window if window is not None else cfg.sliding_window
    x, _, auxes = _run_layers(layers, shared, x, cfg, mode="train",
                              positions=positions, window=window,
                              remat=cfg.remat and torch.is_grad_enabled(),
                              moe=moe)
    return apply_norm(final, x, cfg), embed_p, auxes


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over a ``Transformer`` or a parameter tree.
    Returns (logits, aux); aux is the MoE balance loss summed over the
    layers, zero without experts."""
    x, embed_p, auxes = _hidden(params, cfg, batch, window)
    return unembed(embed_p, x, cfg), _sum_aux(auxes, x.device)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(sum nll, sum mask) for logits (B, S, V), labels (B, S) (-1 = pad)."""
    mask = (labels >= 0).to(torch.float32)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1,
                      torch.clamp(labels, min=0).long()[..., None])[..., 0]
    return -torch.sum(ll * mask), torch.sum(mask)


class LossParts(NamedTuple):
    """What one batch (or one data slice of it) adds to the loss: ``nll``
    the summed negative log-likelihood and ``cnt`` the count of labels
    (float32, 0-d), ``tokens`` its token count, and ``moe`` each MoE
    layer's ``RouteStats`` in order (empty without experts)."""
    nll: torch.Tensor
    cnt: torch.Tensor
    tokens: int
    moe: Tuple[RouteStats, ...]


def moe_layer_count(cfg: ModelConfig) -> int:
    """The number of MoE layers (each routes once a forward pass)."""
    return cfg.n_layers if cfg.n_experts and cfg.family not in (
        "ssm", "hybrid") else 0


def loss_parts(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               window: Optional[int] = None,
               moe: Optional[Sequence[MoeSlice]] = None) -> LossParts:
    """The :class:`LossParts` of ``batch``.  ``moe`` (one ``MoeSlice`` a
    MoE layer) places the batch as a slice of a larger one; by default
    it is the whole batch.  With ``cfg.ce_chunk`` dividing the sequence,
    the logits are made one chunk at a time and recomputed in the
    backward pass, so the (B, S, V) logits never exist at once.  Raises
    on ``attention_impl="pallas"`` while autograd records: the
    flash-attention kernel has no backward."""
    if cfg.attention_impl == "pallas" and torch.is_grad_enabled():
        raise ValueError(
            f"{cfg.name}: attention_impl='pallas' cannot train (the "
            "flash-attention kernel is forward-only); pass "
            "cfg.replace(attention_impl='chunked'), the reference trainer's "
            "attention")
    labels = batch["targets"]
    tokens = int(labels.numel())
    if moe is None:
        moe = [MoeSlice(tokens)] * moe_layer_count(cfg)
    x, embed_p, stats = _hidden(params, cfg, batch, window, moe=moe)
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
    return LossParts(nll, cnt, tokens, tuple(stats))


def compose_loss(cfg: ModelConfig, parts: LossParts, totals: LossParts
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and ``{"ce", "aux"}`` of ``parts`` within a batch whose
    parts summed over its slices are ``totals``:
    ``nll / max(cnt, 1) + router_aux_coef * aux``, aux summed over the MoE
    layers of ``E * sum_e (counts_e / T) * (probsum_e / T)`` with the
    counts, the label count and T of ``totals`` and the probability sums
    of ``parts``.  ``compose_loss(cfg, p, p)`` is the loss of one batch;
    over the slices of a batch the losses sum to the batch's (the counts
    carry no gradient, so their gradients sum to its gradient)."""
    ce = parts.nll / torch.clamp(totals.cnt, min=1.0)
    T = totals.tokens
    aux = _sum_aux([cfg.n_experts * torch.sum(
        (tot.counts.float() / T) * (own.probsum / T))
        for own, tot in zip(parts.moe, totals.moe)], ce.device)
    total = ce + f32(cfg.router_aux_coef, ce) * aux
    return total, {"ce": ce, "aux": aux}


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy (plus the MoE aux term) and its parts
    ``{"ce", "aux"}``: ``compose_loss`` of the batch's ``loss_parts``."""
    parts = loss_parts(params, cfg, batch, window)
    return compose_loss(cfg, parts, parts)


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               ring: bool = False, device=None) -> dict:
    """Stacked decode cache for all layers: ``k``/``v`` of shape (L, B,
    max_len, KV, hd) in the compute dtype, or for MLA ``ckv`` (L, B,
    max_len, rank) and ``krope`` (L, B, max_len, rope dim)
    (``positions`` (L, max_len), all -1, for a ring); for an ssm model
    the zero Mamba2 state of every layer (``max_len`` and ``ring`` do not
    enter it); for a hybrid model ``{"attn": ..., "ssm": ...}`` with the
    attention cache stacked over the G groups and the state over (G,
    attn_every); ``device="meta"`` gives its shapes alone."""
    dev = resolve_device_or_meta(device)

    def stacked(c, lead):
        return {n: t[(None,) * len(lead)].repeat(lead + (1,) * t.ndim)
                for n, t in c.items()}

    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        return {"attn": stacked(init_cache(cfg, batch, max_len, ring,
                                           device=dev), (G,)),
                "ssm": stacked(init_ssm_state(cfg, batch, device=dev),
                               (G, cfg.attn_every))}
    c = (init_ssm_state(cfg, batch, device=dev) if cfg.family == "ssm"
         else init_cache(cfg, batch, max_len, ring, device=dev))
    return stacked(c, (cfg.n_layers,))


@torch.inference_mode()
def prefill(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], window: Optional[int] = None,
            ring: bool = False, max_len: Optional[int] = None,
            moe: Optional[Sequence[MoeSlice]] = None):
    """Full-sequence forward over ``tokens`` or ``embeds`` (with optional
    ``positions``) that also returns the cache and the last position's
    logits (B, 1, V).

    The cache is the reference's (length S; a ring keeps the last
    ``window`` entries) or, with ``max_len``, a plain ``max_len`` cache
    holding the prompt in slots [0, S) -- what the reference gets by
    grafting its prefill cache into ``make_cache(..., max_len)``, without
    the intermediate copy.  A Mamba2 state (an ssm model's, a hybrid's
    ``ssm``) is the state after the prompt, with or without ``max_len``
    (the reference's graft keeps such a state whole).  ``params`` is a
    ``Transformer`` or a parameter tree, whose leaves may be a row's
    tensor-parallel blocks (``models.tensor_parallel``); ``moe`` (one
    ``MoeSlice`` a MoE layer) places the batch as one data slice of a
    larger one, as :func:`loss_parts`'s does."""
    embed_p, layers, shared, final = _parts(params, cfg)
    x, positions = _inputs_to_x(embed_p, final["scale"].device, cfg, batch)
    window = window if window is not None else cfg.sliding_window
    cache = None
    if max_len is not None:
        if ring:
            raise ValueError("max_len is for plain caches; a ring prefill "
                             "returns its own window-long cache")
        cache = make_cache(cfg, x.shape[0], max_len, device=x.device)
    x, cache, _ = _run_layers(layers, shared, x, cfg, mode="prefill",
                              positions=positions, cache=cache,
                              window=window, ring=ring, moe=moe)
    x = apply_norm(final, x[:, -1:], cfg)
    return unembed(embed_p, x, cfg), cache


@torch.inference_mode()
def decode_step(params: Transformer, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, pos: int, window: Optional[int] = None,
                ring: bool = False):
    """One decode step: token (B, 1) int, or a (B, 1, D) embedding, against
    ``cache`` at position ``pos`` (a host int, or a 0-d tensor read once).
    Returns (logits (B, 1, V), cache); the cache is updated in place."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    pos = int(pos)
    if token.ndim == 3:
        x = token.to(device=params.device, dtype=cfg.cdtype)
    else:
        x = embed(params.embed, token.to(params.device), cfg)
    positions = make_positions(cfg, x.shape[0], 1, offset=pos,
                               device=x.device)
    window = window if window is not None else cfg.sliding_window
    embed_p, layers, shared, final = _parts(params, cfg)
    x, cache, _ = _run_layers(layers, shared, x, cfg, mode="decode",
                              positions=positions, cache=cache, pos=pos,
                              window=window, ring=ring)
    x = apply_norm(final, x, cfg)
    return unembed(embed_p, x, cfg), cache
