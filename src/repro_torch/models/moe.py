"""Mixture-of-Experts layer: a top-k router with the auxiliary
load-balance loss, shared (always-on) experts and routed experts
(counterpart of ``repro.models.moe``).

Two dispatches, as in the reference:

* :func:`moe_block` -- the dense oracle: every expert on every token,
  masked by the (tokens, experts) combine matrix (no token dropped);
* :func:`moe_block_capacity` -- the capacity-bucketed gather / scatter
  (the config default, ``moe_impl="capacity"``): each expert takes at
  most C = int(T * k / E * capacity_factor) tokens, slots given in
  token-major (T*k) order, and the tokens past C are dropped.

Both take an optional :class:`MoeSlice`: the block then runs on one
data slice of a larger batch and returns, beside y, the slice's
:class:`RouteStats` (per-expert counts of the chosen experts, per-expert
sums of the router probabilities, the dropped (token, slot) count).  A
slice's capacity C is the whole batch's (``MoeSlice.tokens``), and its
(token, slot) pairs take their slots after the ``offsets`` the earlier
slices routed to each expert, so a slice keeps exactly the pairs the
whole batch keeps: a kept token's expert output does not depend on the
other tokens of its bucket.  The balance loss of the whole batch is then
``E * sum_e (sum counts_e / T) * (sum probsum_e / T)`` over the slices
(``models.transformer.compose_loss``).

Ties in the top-k go to the lower expert index, as ``jax.lax.top_k``
orders them (a stable descending sort; ``torch.topk`` promises no
order).  The bucket scatter writes each kept (token, slot) row once and
every dropped one into a spare row that is then cut off, so the kept
rows do not depend on the order of a scatter with repeated indices.
On tensor-parallel leaves (``models.tensor_parallel``) the capacity
dispatch is expert-parallel: the routing is computed whole from the
gathered router, each position runs its experts' buckets, and each
bucket row comes back from the position that owns its expert.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _normal
from .tensor_parallel import each, group_of, matmul, whole

__all__ = ["moe_params", "router_topk", "moe_block", "moe_block_capacity",
           "MoeSlice", "RouteStats"]


class MoeSlice(NamedTuple):
    """The place of one data slice in the whole batch, at one MoE layer.

    ``tokens``: the whole batch's token count T (it sets the capacity C
    and divides the balance statistics).  ``offsets``: the (E,) int64
    count of (token, slot) pairs the slices before this one, in batch
    order, routed to each expert; None for the first slice, or a
    function of this slice's own (E,) counts returning them (a slice
    whose predecessors live in other processes exchanges counts there;
    it is called once a forward pass and must give the same offsets when
    a layer is recomputed)."""
    tokens: int
    offsets: Union[None, torch.Tensor,
                   Callable[[torch.Tensor], Optional[torch.Tensor]]] = None

    def offsets_for(self, counts: torch.Tensor) -> Optional[torch.Tensor]:
        off = self.offsets(counts) if callable(self.offsets) \
            else self.offsets
        return None if off is None else off.to(counts.device)


class RouteStats(NamedTuple):
    """One slice's routing at one MoE layer: ``aux`` the slice's own
    balance loss (as if it were the whole batch), ``counts`` (E,) int64
    the tokens that chose each expert (no gradient), ``probsum`` (E,)
    float32 the sum of each expert's router probability over the slice's
    tokens (differentiable), ``dropped`` the (token, slot) pairs past
    their expert's capacity (0-d int64; 0 for the dense oracle)."""
    aux: torch.Tensor
    counts: torch.Tensor
    probsum: torch.Tensor
    dropped: torch.Tensor


def moe_params(gen: Optional[torch.Generator], cfg: ModelConfig,
               device=None) -> dict:
    """``router`` (D, E) in float32; experts ``w1`` / ``w3`` (E, D, F) and
    ``w2`` (E, F, D), and the shared experts ``shared_w1`` / ``shared_w3``
    (D, Fs) and ``shared_w2`` (Fs, D), in the param dtype."""
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_ff
    std = D ** -0.5
    p = {"router": _normal(gen, (D, E), std, cfg.replace(
            param_dtype="float32"), device),
         "w1": _normal(gen, (E, D, F_), std, cfg, device),
         "w3": _normal(gen, (E, D, F_), std, cfg, device),
         "w2": _normal(gen, (E, F_, D), F_ ** -0.5, cfg, device)}
    if cfg.shared_ff:
        Fs = cfg.shared_ff
        p["shared_w1"] = _normal(gen, (D, Fs), std, cfg, device)
        p["shared_w3"] = _normal(gen, (D, Fs), std, cfg, device)
        p["shared_w2"] = _normal(gen, (Fs, D), Fs ** -0.5, cfg, device)
    return p


def _topk(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` of the rows of ``probs``: the k largest, ties to
    the lower index."""
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_w[..., :k], top_i[..., :k]


def _route(logits: torch.Tensor, k: int, stats: bool = False):
    """(probs, renormalized top-k weights, top-k ids, aux loss) of float32
    router logits (T, E).  Aux follows Switch/GShard: E * sum_e f_e * p_e.
    With ``stats`` also the per-expert counts of the chosen experts (int64,
    no gradient) and sums of the probabilities, the parts of f and p."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_i = _topk(probs, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    chosen = torch.zeros_like(probs).scatter_(-1, top_i, 1.0)  # max over k
    aux = E * torch.sum(chosen.mean(dim=0) * probs.mean(dim=0))
    if not stats:
        return probs, top_w, top_i, aux
    return (probs, top_w, top_i, aux, chosen.sum(dim=0).long(),
            probs.sum(dim=0))


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (combine (T, E) holding the top-k softmax weights,
    aux loss, top-k ids (T, k))."""
    probs, top_w, top_i, aux = _route(logits, k)
    combine = torch.zeros_like(probs).scatter_(-1, top_i, top_w)
    return combine, aux, top_i


def _shared(p, t: torch.Tensor, dt) -> torch.Tensor:
    """The shared expert.  On tensor-parallel leaves each product follows
    the dim the plan cuts: w1 / w3 column-parallel where their output
    (Fs) is cut (qwen2-moe) and row-parallel where their input (D) is
    (deepseek-v2: the output is whole on the row's first device); w2
    row-parallel where its input (Fs) is cut and column-parallel where
    its output D is (deepseek-v2); the result is gathered whole."""
    hs = each(group_of(p), lambda a, b: F.silu(a) * b,
              matmul(t, p["shared_w3"], dt), matmul(t, p["shared_w1"], dt))
    return whole(matmul(hs, p["shared_w2"], dt))


def moe_block(p, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[MoeSlice] = None):
    """The dense oracle.  x (B, S, D) -> (y, aux loss); with ``ctx``, (y,
    :class:`RouteStats`) of this slice (no token is dropped, so the
    offsets do not enter)."""
    if group_of(p) is not None:
        raise ValueError("the dense MoE oracle is not tensor-parallel: "
                         "train with moe_impl='capacity'")
    B, S, D = x.shape
    dt = cfg.cdtype
    t = x.reshape(B * S, D)
    routed = _route(t.float() @ p["router"], cfg.top_k, stats=ctx is not None)
    probs, top_w, top_i, aux = routed[:4]
    combine = torch.zeros_like(probs).scatter_(-1, top_i, top_w).to(dt)
    h1 = torch.einsum("td,edf->tef", t, p["w1"].to(dt))
    h3 = torch.einsum("td,edf->tef", t, p["w3"].to(dt))
    h = F.silu(h3) * h1
    y = torch.einsum("tef,efd,te->td", h, p["w2"].to(dt), combine)
    if cfg.shared_ff:
        y = y + _shared(p, t, dt)
    if ctx is None:
        return y.reshape(B, S, D), aux
    counts, probsum = routed[4:]
    return y.reshape(B, S, D), RouteStats(
        aux, counts, probsum, torch.zeros((), dtype=torch.int64,
                                          device=x.device))


def moe_block_capacity(p, x: torch.Tensor, cfg: ModelConfig,
                       capacity_factor: float = 1.25,
                       ctx: Optional[MoeSlice] = None):
    """Capacity-bucketed dispatch: each expert runs on at most C tokens,
    so the work follows the active experts, not all of them.  x (B, S, D)
    -> (y, aux loss).

    With ``ctx`` x is one slice of a batch of ``ctx.tokens`` tokens: C is
    that batch's, each (token, slot) takes the slot after the offset of
    its expert, and the pair lands in the row of that slot of a bucket
    as large as the whole batch's, so a kept pair meets the same
    arithmetic as in the whole batch's block.  Returns (y,
    :class:`RouteStats`)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = cfg.cdtype
    t = x.reshape(B * S, D)
    T = t.shape[0]
    C = max(1, int((T if ctx is None else ctx.tokens) * k / E
                   * capacity_factor))

    # the router whole: routing is a comparison, so its logits are
    # computed whole (a tensor-parallel router leaf is gathered)
    routed = _route(t.float() @ whole(p["router"]), k, stats=ctx is not None)
    _, top_w, top_i, aux = routed[:4]

    # each (token, slot)'s place in its expert's bucket, token-major
    flat_e = top_i.reshape(-1)                                  # (T*k,)
    onehot = F.one_hot(flat_e, E)                               # (T*k, E)
    slot = (torch.cumsum(onehot, dim=0) * onehot).amax(dim=-1) - 1
    if ctx is not None:
        off = ctx.offsets_for(routed[4])
        if off is not None:
            slot = slot + off[flat_e]
    dest = torch.where(slot < C, flat_e * C + slot,
                       torch.full_like(flat_e, E * C))          # spare row

    src = torch.arange(T * k, device=x.device) // k
    buckets = torch.zeros((E * C + 1, D), dtype=dt, device=x.device)
    buckets.index_copy_(0, dest, t[src])
    xb = buckets[:E * C].reshape(E, C, D)
    # expert-parallel leaves: each position runs its experts' buckets, and
    # each bucket row comes back from the one position that owns it
    h = each(group_of(p), lambda a, b: F.silu(a) * b, matmul(xb, p["w3"], dt),
             matmul(xb, p["w1"], dt), dim=0)
    yb = whole(matmul(h, p["w2"], dt)).reshape(E * C, D)
    yb = torch.cat([yb, yb.new_zeros((1, D))], dim=0)
    y_slots = yb[dest] * top_w.reshape(-1, 1).to(dt)
    y = y_slots.reshape(T, k, D).sum(dim=1)

    if cfg.shared_ff:
        y = y + _shared(p, t, dt)
    if ctx is None:
        return y.reshape(B, S, D), aux
    counts, probsum = routed[4:]
    return y.reshape(B, S, D), RouteStats(aux, counts, probsum,
                                          (slot >= C).sum())
