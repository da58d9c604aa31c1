"""The trainer's step and the serving steps (counterpart of
``repro.launch.steps``).

``Trainer.train_step`` embeds the paper's mechanism end to end: the
gradient for the arriving worker's batch, write-event delay bookkeeping
(Algorithm 1's ``tau = k - s[worker]``), the delay-adaptive step-size
(principle (8) via core.stepsize) and the (optionally proximal) parameter
update.  Parameters are the reference-layout tree of tensors
(``models.param_tree``); gradients come from ``torch.autograd`` with
respect to its leaves.  ``Trainer.state_specs`` is the train state on the
``meta`` device (shapes only), which the sharding planner plans at full
size.

:func:`rows_loss_and_grad` is the data-parallel ``loss_and_grad`` of a
model mesh's rows (``mesh.dp_rows``; :func:`data_parallel_loss_and_grad`
cuts a global batch for it).  The loss couples the rows twice: its
cross-entropy divides by the whole batch's label count, and each MoE
layer's balance term multiplies the whole batch's expert counts with its
probability sums; a capacity MoE also gives each row's (token, slot)
pairs their slots after the earlier rows' (``models.moe.MoeSlice``).  So
each row runs its forward on its device in row order, reading the
earlier rows' counts at each MoE layer; the rows' ``loss_parts`` are
summed in row order; each row then takes the gradient of its share,
``compose_loss(parts_row, totals)``, whose sum over the rows is the loss
(the counts carry no gradient), and the gradients are summed in row
order.  The schedule keeps every row's graph (with remat, each layer's
input) until the sums are known: the peak holds the whole batch's
activations, as the unsharded step's does, plus nothing for a second
forward pass.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.prox import ProxOp, Zero
from ..core.pytree import tree_flatten, tree_map, tree_unflatten
from ..core.stepsize import Adaptive1, StepsizePolicy
from ..mesh import (Mesh, _dp_entry, batch_shardings, device_put, dp_rows,
                    gather, gather_model_blocks, model_dim, param_shardings,
                    process_index, row_positions, rows_gather, split_samples,
                    sum_in_order)
from ..models import decode_step, forward, loss_fn, param_tree, prefill
from ..models.config import ModelConfig
from ..models import tensor_parallel
from ..models.moe import MoeSlice, RouteStats
from ..models.tensor_parallel import TENSOR_PARALLEL, ModelGroup, TpLeaf, whole
from ..models.transformer import (LossParts, compose_loss, loss_parts,
                                  moe_layer_count)
from ..optim.optimizers import (AdamW, DelayAdaptiveOptimizer,
                                DelayAdaptiveState, Momentum, Sgd)

__all__ = ["TrainState", "Trainer", "make_trainer", "make_prefill_step",
           "make_serve_step", "loss_and_grad", "row_params", "model_blocks",
           "row_batches", "rows_loss_and_grad", "data_parallel_loss_and_grad"]


class TrainState(NamedTuple):
    params: Any
    opt: DelayAdaptiveState


def loss_and_grad(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``(loss, metrics, grads)`` of ``models.loss_fn`` at a parameter
    tree; ``grads`` has the tree's structure, everything is detached.  A
    leaf the loss does not read (a VLM's text token table under image
    embeddings) gets a zero gradient, as ``jax.grad`` gives it."""
    leaves, spec = tree_flatten(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(spec, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(spec, list(grads)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _offsets_exchange(mesh: Mesh, row: int) -> Callable:
    """A capacity layer's offsets for ``row`` when the rows live in
    several ranks: the first call all-gathers every row's counts (every
    rank calls it at the same layer) and sums the earlier rows'; a
    recompute of the layer reads the kept answer."""
    kept: list = []

    def offsets(counts: torch.Tensor) -> Optional[torch.Tensor]:
        if not kept:
            every = rows_gather(mesh, {row: counts})
            kept.append(None if row == 0 else sum_in_order(every[:row]))
        return kept[0]
    return offsets


def _pack(parts: LossParts) -> Tuple[torch.Tensor, torch.Tensor]:
    """A row's statistics as one float32 and one int64 vector: nll, cnt
    and each MoE layer's probability sums; each layer's counts and
    dropped pairs."""
    f = [parts.nll.detach().reshape(1), parts.cnt.detach().reshape(1)]
    i = [parts.cnt.new_zeros((1,), dtype=torch.int64)]   # never empty
    for st in parts.moe:
        f.append(st.probsum.detach())
        i += [st.counts, st.dropped.reshape(1)]
    return torch.cat(f), torch.cat(i)


def _unpack(f: torch.Tensor, i: torch.Tensor, n_moe: int, n_exp: int,
            tokens: int) -> LossParts:
    moe, fo, io = [], 2, 1
    for _ in range(n_moe):
        moe.append(RouteStats(None, i[io:io + n_exp],
                              f[fo:fo + n_exp], i[io + n_exp]))
        fo += n_exp
        io += n_exp + 1
    return LossParts(f[0], f[1], tokens, tuple(moe))


def _live_rows(params_on: Dict[int, Any], mine) -> Tuple[dict, dict, Any]:
    """Each row's parameter tree with autograd leaves in place of the
    gathered tensors (one leaf a distinct tensor, so rows and positions
    that share a tensor share its leaf), and each row's leaves in one
    order for every row: each leaf's tensor, or a tensor-parallel leaf's
    "model" blocks in position order (its first position's where every
    position holds it whole)."""
    live: Dict[int, torch.Tensor] = {}

    def grad_leaf(t):
        if id(t) not in live:
            live[id(t)] = t.detach().requires_grad_(True)
        return live[id(t)]

    trees, flats, spec = {}, {}, None
    for i in mine:
        leaves, spec = tree_flatten(params_on[i])
        new, flat = [], []
        for leaf in leaves:
            if isinstance(leaf, TpLeaf):
                blocks = [grad_leaf(b) for b in leaf.blocks]
                new.append(TpLeaf(leaf.group, blocks, leaf.dim, leaf.shape))
                flat += blocks if leaf.dim is not None else blocks[:1]
            else:
                new.append(grad_leaf(leaf))
                flat.append(new[-1])
        trees[i] = tree_unflatten(spec, new)
        flats[i] = flat
    return trees, flats, spec


def _my_rows(mesh: Mesh):
    me = process_index()
    return [i for i, (_, _, r) in enumerate(dp_rows(mesh)) if r == me]


def row_params(params, mesh: Mesh, cfg: ModelConfig) -> Dict[int, Any]:
    """Each of this rank's data-parallel rows' parameters, by row index,
    from ``params`` cut by ``mesh.param_shardings`` (``ShardedTensor``
    leaves), on the route of ``models.tensor_parallel.route(cfg)`` (the
    one place the route is chosen): tensor-parallel, the FSDP gather only
    (:func:`model_blocks`); row-gathered, every leaf whole on the row's
    first device, gathered once a device (rows on one device share the
    tree)."""
    if tensor_parallel.route(cfg) == TENSOR_PARALLEL:
        return model_blocks(params, mesh)
    rows = dp_rows(mesh)
    on: Dict[str, Any] = {}
    out: Dict[int, Any] = {}
    for i in _my_rows(mesh):
        dev = rows[i][1]
        if str(dev) not in on:
            on[str(dev)] = tree_map(lambda s: gather(s, dev), params)
        out[i] = on[str(dev)]
    return out


def model_blocks(params, mesh: Mesh) -> Dict[int, Any]:
    """Each of this rank's data-parallel rows' parameters (``params`` cut
    by ``mesh.param_shardings``, ``ShardedTensor`` leaves) as
    tensor-parallel leaves (``models.tensor_parallel.TpLeaf``), by row
    index: each position's "model" block, whole over the data axes, on
    its own device (made once a distinct (device, block), so rows and
    positions that share a device share their blocks)."""
    mine = _my_rows(mesh)
    positions = row_positions(mesh)
    groups = {i: ModelGroup([mesh.devices[pos] for pos in positions[i]])
              for i in mine}

    leaves, spec = tree_flatten(params)
    out: Dict[int, list] = {i: [] for i in mine}
    for s in leaves:
        dim = model_dim(s.sharding, len(s.shape))
        keys: Dict[tuple, tuple] = {}
        for i in mine:
            for m, dev in enumerate(groups[i].devices):
                keys.setdefault((str(dev), 0 if dim is None else m), (m, dev))
        made = dict(zip(keys, gather_model_blocks(s, list(keys.values()))))
        for i in mine:
            out[i].append(TpLeaf(
                groups[i], [made[(str(dev), 0 if dim is None else m)]
                            for m, dev in enumerate(groups[i].devices)],
                dim, s.shape))
    return {i: tree_unflatten(spec, out[i]) for i in mine}


def rows_loss_and_grad(params_on: Dict[int, Any], cfg: ModelConfig,
                       row_batches: Dict[int, Dict[str, torch.Tensor]],
                       mesh: Mesh):
    """``(loss, metrics, grads, row_seconds)`` of the batch whose slices
    are ``mesh``'s data-parallel rows (``mesh.dp_rows``), computed where
    they live.  ``row_batches`` maps the index of each row this rank owns
    to its slice, on the row's device; ``params_on`` maps it to the row's
    parameter tree: whole tensors on the row's first device, or the row's
    tensor-parallel blocks (``models.tensor_parallel.TpLeaf``, each
    position's on its device; ``launch.run_distributed.gather_params``).
    ``grads`` (the tree's structure) is the gradient of the whole batch's
    loss summed over the rows in row order, on the devices of this
    rank's last row (a tensor-parallel leaf's as a ``TpLeaf`` of its
    "model" blocks' gradients); ``metrics`` holds ``ce``, ``aux`` and
    ``dropped`` (each MoE layer's dropped (token, slot) pairs over the
    rows); ``row_seconds`` each of this rank's rows' forward and backward
    seconds.  Where the rows live in several ranks, each rank owns one
    row and every rank calls this (the exchanges are all-gathers summed
    in row order, so the numbers are the one-process run's bitwise)."""
    rows = dp_rows(mesh)
    mine = sorted(row_batches)
    multi = len({r for _, _, r in rows}) > 1
    if multi and len(mine) != 1:
        raise ValueError(
            f"a data-parallel step over several ranks puts one row in each "
            f"rank; this rank owns the rows {mine}")
    tokens = int(row_batches[mine[0]]["targets"].numel()) * len(rows)
    n_moe, n_exp = moe_layer_count(cfg), cfg.n_experts
    trees, flats, spec = _live_rows(params_on, mine)

    # forward passes in row order; each row reads the earlier rows' counts
    parts: Dict[int, LossParts] = {}
    secs: Dict[int, float] = {}
    prefix: list = [None] * n_moe
    for i in mine:
        dev = rows[i][1]
        moe = [MoeSlice(tokens, _offsets_exchange(mesh, i) if multi
                        else prefix[l]) for l in range(n_moe)]
        t0 = time.perf_counter()
        with torch.enable_grad():
            parts[i] = loss_parts(trees[i], cfg, row_batches[i], moe=moe)
        _sync(dev)
        secs[i] = time.perf_counter() - t0
        for l, st in enumerate(parts[i].moe):
            prefix[l] = st.counts if prefix[l] is None \
                else prefix[l].to(dev) + st.counts

    # the coupling statistics, summed in row order
    packed = {i: _pack(parts[i]) for i in mine}
    packed_totals = [sum_in_order(rows_gather(mesh, {i: p[j] for i, p in
                                                     packed.items()}))
                     for j in (0, 1)]
    totals = _unpack(*packed_totals, n_moe, n_exp, tokens)

    # each row's share; the gradients accumulate in row order (where a
    # row's leaf is another tensor than the last row's, the running sum
    # moves onto it)
    holder = None
    for i in mine:
        dev = rows[i][1]
        leaves = flats[i]
        if holder is not None:
            for a, b in zip(holder, leaves):
                if a is not b:
                    b.grad, a.grad = (None if a.grad is None
                                      else a.grad.to(b.device)), None
        tot = _unpack(*(t.to(dev) for t in packed_totals), n_moe, n_exp,
                      tokens)
        t0 = time.perf_counter()
        with torch.enable_grad():
            share, _ = compose_loss(cfg, parts[i], tot)
            share.backward()
        _sync(dev)
        secs[i] += time.perf_counter() - t0
        holder = leaves
    del parts
    grads = [torch.zeros_like(t) if t.grad is None else t.grad
             for t in holder]
    for t in holder:
        t.grad = None
    if multi:
        grads = [sum_in_order(rows_gather(mesh, {mine[0]: g}))
                 for g in grads]
    loss, metrics = compose_loss(cfg, totals, totals)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["dropped"] = torch.stack([st.dropped for st in totals.moe]) \
        if n_moe else torch.zeros((0,), dtype=torch.int64)
    flat_grads = iter(grads)
    out = []
    for leaf in tree_flatten(trees[mine[-1]])[0]:
        if isinstance(leaf, TpLeaf):
            n = len(leaf.blocks) if leaf.dim is not None else 1
            out.append(TpLeaf(leaf.group, [next(flat_grads)
                                           for _ in range(n)],
                              leaf.dim, leaf.shape))
        else:
            out.append(next(flat_grads))
    return (loss.detach(), metrics, tree_unflatten(spec, out),
            [secs[i] for i in mine])


def row_batches(batch, mesh: Mesh) -> Dict[int, Dict[str, torch.Tensor]]:
    """Each of this rank's data-parallel rows' slices of a batch cut by
    ``batch_shardings``: the block of the row's first position, cut over
    the rows where the plan left the batch whole (``split_samples`` then
    raises where it does not divide)."""
    rows = dp_rows(mesh)
    dp = _dp_entry(mesh)
    out = {}
    for i in _my_rows(mesh):
        first = rows[i][0]
        out[i] = {}
        for name, leaf in batch.items():
            block = leaf.shards[first]
            if dp is None or dp in tuple(leaf.sharding.spec):
                out[i][name] = block
            else:
                out[i][name] = split_samples([block], len(rows))[i][0]
    return out


def data_parallel_loss_and_grad(params, cfg: ModelConfig,
                                batch: Dict[str, torch.Tensor], mesh: Mesh):
    """:func:`rows_loss_and_grad` of a whole batch on a one-process
    ``mesh``: the batch cut over its data-parallel rows by
    ``batch_shardings`` (:func:`row_batches`: a VLM's (3, B, S) M-RoPE
    positions on their batch dim), and the parameters cut by
    ``param_shardings`` and taken by :func:`row_params` onto the rows.
    ``(loss, metrics, grads)``, every gradient leaf whole on the last
    row's first device."""
    B = int(batch["targets"].shape[0])
    cut = row_batches(device_put(batch, batch_shardings(batch, mesh, B)),
                      mesh)
    params_on = row_params(device_put(params, param_shardings(params, mesh)),
                           mesh, cfg)
    loss, metrics, grads, _ = rows_loss_and_grad(params_on, cfg, cut, mesh)
    return loss, metrics, tree_map(whole, grads)


@dataclasses.dataclass(frozen=True)
class Trainer:
    cfg: ModelConfig
    optimizer: DelayAdaptiveOptimizer

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> TrainState:
        """Parameters from the port's initializer (``models.init_params``)
        as the reference-layout tree, and a fresh optimizer state."""
        from ..models import init_params
        params = param_tree(init_params(self.cfg, generator, device=device))
        return TrainState(params=params, opt=self.optimizer.init(params))

    def state_specs(self) -> TrainState:
        """The parameters (``models.param_specs``) and ``optimizer.init``
        of them, every leaf on ``meta``: shapes and dtypes, no allocation
        (the reference's ``jax.eval_shape`` of the state)."""
        from ..models import param_specs
        params = param_specs(self.cfg)
        return TrainState(params=params, opt=self.optimizer.init(params))

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   worker) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, metrics, grads = loss_and_grad(state.params, self.cfg, batch)
        params, opt, gamma, tau = self.optimizer.update(
            state.params, grads, state.opt, worker)
        metrics = dict(metrics)
        metrics.update(loss=loss, gamma=gamma, tau=tau)
        return TrainState(params=params, opt=opt), metrics


def make_trainer(cfg: ModelConfig, policy: Optional[StepsizePolicy] = None,
                 base: str = "adamw", prox: ProxOp = Zero(),
                 n_workers: int = 1, lr: float = 1e-3,
                 grad_clip: Optional[float] = 1.0,
                 weight_decay: float = 0.0) -> Trainer:
    """Default production trainer: delay-adaptive AdamW.

    gamma' (the step-size budget of principle (8)) plays the base-LR role;
    the emitted gamma_k scales the AdamW update by the observed staleness."""
    policy = policy or Adaptive1(gamma_prime=lr, alpha=0.9)
    bases = {"adamw": AdamW(weight_decay=weight_decay),
             "momentum": Momentum(), "sgd": Sgd()}
    opt = DelayAdaptiveOptimizer(
        policy=policy, base=bases[base],
        prox=prox, grad_clip=grad_clip, n_workers=n_workers, horizon=1024)
    return Trainer(cfg=cfg, optimizer=opt)


def make_prefill_step(cfg: ModelConfig, window: Optional[int] = None,
                      ring: bool = False) -> Callable:
    if cfg.has_decode:
        def prefill_step(params, batch):
            return prefill(params, cfg, batch, window=window, ring=ring)
        return prefill_step

    @torch.inference_mode()
    def encode_step(params, batch):  # encoder-only: logits, no cache
        logits, _ = forward(params, cfg, batch)
        return logits
    return encode_step


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None,
                    ring: bool = False) -> Callable:
    def serve_step(params, cache, token, pos):
        return decode_step(params, cfg, cache, token, pos, window=window,
                           ring=ring)
    return serve_step
