"""Train with the model sharded over a ("data", "model") mesh (counterpart
of ``repro.launch.run_distributed``).

    PYTHONPATH=src python -m repro_torch.launch.run_distributed \\
        --arch qwen2-moe-a2.7b --reduced --steps 3 --mesh 2x4 --device cpu

Without ``--device`` the mesh takes one CUDA card a position (of every
process) and raises when there are fewer; ``--device cuda:0`` (or
``cpu``) lists that one device at every position.  Over several
processes (``--coordinator host:port --num-processes N --process-id i``,
one command a process; gloo with ``--device cpu``, NCCL otherwise) the
mesh's positions go to the ranks in mesh index order, so each rank owns
whole data-parallel rows; a device list that gives one card to two ranks
raises before the process group is made.

The trainer is the reference's, ``make_trainer(cfg, n_workers=dp_size(mesh),
lr=1e-3)``, with the chunked attention (the flash-attention kernel has no
backward).  Parameters and the optimizer's moments are cut by
``param_shardings`` into one block a mesh position (``mesh.device_put``),
the policy's scalar state is replicated, and each batch is cut by
``batch_shardings``.  One step (:func:`sharded_train_step`), as the
reference's SPMD program computes it, on the route of
``models.tensor_parallel.route``:

1. gather: tensor-parallel (the families of attention layers: dense,
   MoE, MLA, the VLM and the encoder), the FSDP gather only -- each
   position of each data-parallel row gets its "model" block of every
   leaf, whole over the data axes, on its own device; row-gathered (the
   Mamba2 families), every leaf whole onto each row's first device,
   once a device (across ranks an all-gather where the blocks live in
   several);
2. ``steps.rows_loss_and_grad``: each row computes the loss and the
   gradient of its own slice of the batch where it lives, in row order,
   tensor-parallel each position with its own blocks (column-, row- and
   expert-parallel products, the vocab-parallel embedding and logits;
   the positions exchange activations in position order); the statistics
   that couple the batch (the label count, each MoE layer's expert
   counts and probability sums, a capacity layer's offsets) are summed
   in row order, so the step computes the whole batch's loss; the rows'
   gradients are summed in row order, block by block;
3. cut each gradient leaf (or "model" block) by its parameter's sharding
   over the data axes (the reduce-scatter);
4. ``DelayAdaptiveOptimizer.update`` over the distinct blocks: AdamW is
   elementwise, and the clip's global norm sums the blocks' squares leaf
   by leaf, each leaf's blocks in mesh index order (gathered from the
   ranks that hold them).

Against the unsharded step the row sums and the row-parallel products
are another float order (the envelopes of ``tests/test_torch_dp_step.py``
and ``test_torch_tp_step.py``); on a mesh whose data and model axes are 1
the step is the unsharded one but for the clip's sum, and one mesh run
in one process and in several gives bitwise the same state.
:func:`sharded_prefill` is the sharded prefill on the same routes, and
:func:`sharded_forward` an encoder's sharded forward.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core.pytree import tree_leaves, tree_map
from ..mesh import (Mesh, batch_shardings, block_values,
                    cache_shardings, check_one_rank_a_card, device_put,
                    dp_rows, dp_size, init_distributed, make_mesh,
                    param_shardings, process_index, put_model_blocks,
                    replicated, shutdown_distributed, sum_in_order)
from ..models import forward, prefill
from ..models.config import ModelConfig
from ..models.moe import MoeSlice
from ..models.tensor_parallel import TpLeaf
from ..models.transformer import moe_layer_count
from .steps import (Trainer, TrainState, _my_rows, make_trainer, row_batches,
                    row_params, rows_loss_and_grad)
from .train import PRESETS, make_stream

__all__ = ["shard_state", "gather_params", "row_batches",
           "cut_gradients", "update_blocks", "sharded_train_step",
           "sharded_prefill", "sharded_forward", "exchanged_bytes", "run",
           "main"]


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """``state`` on ``mesh``: parameters and the optimizer's inner state
    cut by ``param_shardings``, the rest (step, policy state, worker
    stamps) replicated."""
    rest = state.opt._replace(inner=None)
    opt = device_put(rest, replicated(rest, mesh))
    inner = state.opt.inner
    return TrainState(
        params=device_put(state.params, param_shardings(state.params, mesh)),
        opt=opt._replace(inner=device_put(inner,
                                          param_shardings(inner, mesh))))


def _blocks(tree):
    """Each ``ShardedTensor`` leaf as the distinct blocks this rank holds:
    the tensor when the leaf has one block, else the list of them in mesh
    index order."""
    return tree_map(lambda s: s.blocks()[0] if s.n_blocks == 1
                    else s.blocks(), tree)


def _unblocks(like, tree):
    """The inverse of :func:`_blocks`: ``like``'s shardings holding the
    blocks of ``tree``, taken in its leaf order."""
    flat = iter(tree_leaves(tree))
    return tree_map(lambda s: s.with_blocks(
        [next(flat) for _ in range(len(s.blocks()))]), like)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_of(state: TrainState) -> Mesh:
    return tree_leaves(state.params)[0].sharding.mesh


def gather_params(state: TrainState, cfg: ModelConfig) -> Dict[int, Any]:
    """Step 1: each of this rank's data-parallel rows' parameters, by row
    index, on ``cfg``'s route (``steps.row_params``): tensor-parallel, the
    FSDP gather only, each position of the row getting its "model" block
    whole over the data axes on its own device; row-gathered, every leaf
    gathered whole onto the row's first device, once a device."""
    return row_params(state.params, _mesh_of(state), cfg)


def exchanged_bytes(params_on: Dict[int, Any]) -> int:
    """The bytes the rows' positions exchanged since their parameters
    were gathered: every activation gathered or summed between positions
    (a collective's whole result, as it counts on each position) and
    every small leaf gathered whole, over this rank's rows; 0 on the
    row-gathered route."""
    groups = {id(g): g for tree in params_on.values()
              for g in (leaf.group for leaf in tree_leaves(tree)
                        if isinstance(leaf, TpLeaf))}
    return sum(g.exchanged + g.leaf_bytes for g in groups.values())


def cut_gradients(grads, state: TrainState):
    """Step 3: each gradient leaf cut by its parameter's sharding (a
    tensor-parallel leaf's gradient, given as its "model" blocks, cut
    over the data axes)."""
    return tree_map(lambda g, s: put_model_blocks(g.blocks, s.sharding,
                                                  s.shape)
                    if isinstance(g, TpLeaf) else device_put(g, s.sharding),
                    grads, state.params)


def update_blocks(trainer: Trainer, state: TrainState, cut, worker
                  ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """Step 4: the optimizer over the distinct blocks this rank holds; the
    new sharded state, gamma and tau.  The clip's global norm is that of
    every block (``mesh.block_values``: the squares of the blocks other
    ranks hold are gathered), summed leaf by leaf, each leaf's blocks in
    mesh index order."""
    norm = None
    if trainer.optimizer.grad_clip:
        norm = torch.sqrt(sum(block_values(
            cut, lambda b: torch.sum(torch.square(b.float())))))
    params, opt, gamma, tau = trainer.optimizer.update(
        _blocks(state.params), _blocks(cut), _blocks(state.opt), worker,
        grad_norm=norm)
    return (TrainState(params=_unblocks(state.params, params),
                       opt=_unblocks(state.opt, opt)), gamma, tau)


def sharded_train_step(trainer: Trainer, state: TrainState, batch, worker
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """One step of ``trainer`` on a state made by :func:`shard_state` and a
    batch cut by ``batch_shardings``, each data-parallel row computing
    where it lives (every rank of the mesh calls it), on the route of
    ``models.tensor_parallel.route(trainer.cfg)``.  Returns the new sharded state
    and the metrics of ``Trainer.train_step`` with ``dropped`` (each MoE
    layer's dropped (token, slot) pairs), ``exchanged_bytes``
    (:func:`exchanged_bytes`) and the seconds of the gather
    (``gather_s``), of each of this rank's rows' loss and gradients
    (``compute_rows_s``) and their sum (``compute_s``), and of the
    gradients' reduction, cut and update (``update_s``)."""
    mesh = _mesh_of(state)
    first = dp_rows(mesh)[_my_rows(mesh)[0]][1]
    t0 = time.perf_counter()
    params_on = gather_params(state, trainer.cfg)
    me = process_index()
    for d in {str(dev) for dev, r in zip(mesh.devices.flat,
                                         mesh.processes.flat) if r == me}:
        _sync(torch.device(d))
    t1 = time.perf_counter()
    loss, metrics, grads, rows_s = rows_loss_and_grad(
        params_on, trainer.cfg, row_batches(batch, mesh), mesh)
    moved = exchanged_bytes(params_on)
    del params_on
    t2 = time.perf_counter()
    cut = cut_gradients(grads, state)
    del grads
    new, gamma, tau = update_blocks(trainer, state, cut, worker)
    _sync(first)
    t3 = time.perf_counter()
    metrics = dict(metrics)
    metrics.update(loss=loss, gamma=gamma, tau=tau, gather_s=t1 - t0,
                   compute_s=sum(rows_s), compute_rows_s=rows_s,
                   update_s=t3 - t2, exchanged_bytes=moved)
    return new, metrics


def _after_earlier_rows(seen: list):
    """A MoE layer's ``MoeSlice.offsets`` for the next row of a serving
    call whose rows run one after the other: the sum of the earlier
    rows' per-expert counts at the layer (``seen``, in row order; None
    for the first row), the row's own counts appended for the rows after
    it."""
    def offsets(counts: torch.Tensor) -> Optional[torch.Tensor]:
        earlier = [c.to(counts.device) for c in seen]
        seen.append(counts)
        return sum_in_order(earlier) if earlier else None
    return offsets


def _inputs(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A serving batch's ``tokens`` (B, S) or ``embeds`` (B, S, D)."""
    return batch["tokens"] if "tokens" in batch else batch["embeds"]


def _row_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                mesh: Mesh):
    """The one-process sharded serving calls' inputs: each data-parallel
    row's parameters on ``cfg``'s route (``steps.row_params``) and its
    slice of ``batch`` cut by ``batch_shardings`` (:func:`row_batches`:
    a VLM's (3, B, S) M-RoPE positions on their batch dim), by row
    index."""
    if len({int(p) for p in mesh.processes.flat}) > 1:
        raise ValueError("the sharded serving calls run in one process")
    B = int(_inputs(batch).shape[0])
    cut = row_batches(device_put(batch, batch_shardings(batch, mesh, B)),
                      mesh)
    return row_params(params, mesh, cfg), cut


def sharded_prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    mesh: Mesh, window: Optional[int] = None,
                    ring: bool = False, stats: Optional[dict] = None):
    """The sharded prefill (the executed counterpart of the one the
    reference's dry run lowers): ``params`` cut by ``param_shardings``
    (``mesh.device_put``), a one-process ``mesh``, ``batch`` a prompt
    batch (``tokens`` or ``embeds``, and ``positions`` where given) cut
    over the data-parallel rows by ``batch_shardings``.  Each row
    prefills its slice on the route of ``models.tensor_parallel.route
    (cfg)``: tensor-parallel, each position computing its heads (its own
    share of every product, and under ``attention_impl="pallas"`` the
    flash-attention kernel on its own heads), else on its parameters
    gathered whole.  The rows run in row order, and a capacity MoE layer
    of each row takes its slots after the earlier rows'
    (``models.moe.MoeSlice``), so the rows keep the whole batch's (token,
    slot) pairs.  Returns the last position's logits (B, 1, V) on the
    first row's device and the cache cut by ``mesh.cache_shardings``;
    ``stats`` (a dict), where given, gets ``exchanged_bytes``."""
    rows = dp_rows(mesh)
    params_on, cut = _row_inputs(params, cfg, batch, mesh)
    logits, caches = [], []
    B, S = _inputs(batch).shape[:2]
    seen: List[list] = [[] for _ in range(moe_layer_count(cfg))]
    for i in range(len(rows)):
        moe = [MoeSlice(B * S, _after_earlier_rows(s)) for s in seen]
        lg, c = prefill(params_on[i], cfg, cut[i], window=window, ring=ring,
                        moe=moe)
        logits.append(lg)
        caches.append(c)
    first = rows[0][1]
    cache = caches[0] if len(caches) == 1 else tree_map(
        lambda *cs: (cs[0] if cs[0].ndim < 3 else
                     torch.cat([c.to(first) for c in cs], dim=1)), *caches)
    if stats is not None:
        stats["exchanged_bytes"] = exchanged_bytes(params_on)
    del params_on
    return (torch.cat([lg.to(first) for lg in logits]),
            device_put(cache, cache_shardings(cache, mesh, B, S)))


@torch.inference_mode()
def sharded_forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    mesh: Mesh, stats: Optional[dict] = None
                    ) -> torch.Tensor:
    """The sharded forward of an encoder (which has no cache, so no
    prefill): :func:`sharded_prefill`'s contract, but every position's
    logits (B, S, V), on the first row's device, from ``models.forward``
    in each row (an encoder has no MoE layer, whose capacity would couple
    the rows)."""
    if moe_layer_count(cfg):
        raise ValueError(f"{cfg.name}: the sharded forward is an "
                         "encoder's; its MoE layers would couple the rows")
    rows = dp_rows(mesh)
    params_on, cut = _row_inputs(params, cfg, batch, mesh)
    logits = [forward(params_on[i], cfg, cut[i])[0]
              for i in range(len(rows))]
    if stats is not None:
        stats["exchanged_bytes"] = exchanged_bytes(params_on)
    del params_on
    first = rows[0][1]
    return torch.cat([lg.to(first) for lg in logits])


def run(cfg: ModelConfig, mesh: Mesh, steps: int = 3, batch: int = 8,
        seq: int = 64, device=None) -> Tuple[TrainState, List[dict]]:
    """``steps`` sharded steps of the reference's trainer for ``cfg`` on
    ``mesh`` from the port's initializer (seed 0) and the synthetic
    stream (seed 0), worker ``k % dp_size(mesh)`` at step k; the state
    is made on ``device`` (default the first device of this rank's first
    row) and cut onto the positions this rank owns.  Each rank checks
    its losses for NaN.  Returns the final state and one record a step
    (loss, gamma, tau, dropped pairs, seconds, exchanged bytes)."""
    dev = torch.device(device if device is not None
                       else dp_rows(mesh)[_my_rows(mesh)[0]][1])
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # the card this rank's collectives use
    n_workers = dp_size(mesh)
    trainer = make_trainer(cfg.replace(attention_impl="chunked"),
                           n_workers=n_workers, lr=1e-3)
    state = shard_state(trainer.init(device=dev), mesh)
    stream = make_stream(cfg, batch, seq, device=dev)
    log = []
    with mesh:
        for k in range(steps):
            b = stream.batch_at(k)
            b = device_put(b, batch_shardings(b, mesh, batch))
            t0 = time.perf_counter()
            state, m = sharded_train_step(trainer, state, b, k % n_workers)
            loss = float(m["loss"])
            if loss != loss:
                raise FloatingPointError("NaN loss in distributed execution")
            log.append(dict(step=k, loss=loss, gamma=float(m["gamma"]),
                            tau=int(m["tau"]),
                            wall_s=time.perf_counter() - t0,
                            dropped=[int(v) for v in m["dropped"]],
                            **{n: m[n] for n in ("gather_s", "compute_s",
                                                 "compute_rows_s",
                                                 "update_s",
                                                 "exchanged_bytes")}))
    return state, log


def _positions_ranks(n: int, num_processes: int) -> List[int]:
    """The rank of each of ``n`` mesh positions in mesh index order: equal
    runs, rank 0 first."""
    if n % num_processes:
        raise ValueError(f"{n} mesh positions do not divide over "
                         f"{num_processes} processes")
    return [k * num_processes // n for k in range(n)]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--arch", choices=ARCH_IDS)
    g.add_argument("--preset", choices=list(PRESETS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="2x4")
    ap.add_argument("--device", default=None,
                    help="one device listed at every mesh position (default:"
                         " one CUDA card a position)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 for a multi-process run")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)
    if args.num_processes > 1 and not args.coordinator:
        ap.error("--num-processes > 1 needs --coordinator host:port")
    if not 0 <= args.process_id < args.num_processes:
        ap.error("--process-id must be in [0, --num-processes)")

    cfg = PRESETS[args.preset] if args.preset else get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = tuple(int(x) for x in args.mesh.split("x"))
    n = int(np.prod(shape))
    devices = procs = None
    if args.device is not None:
        devices = [args.device] * n
        procs = _positions_ranks(n, args.num_processes)
        check_one_rank_a_card(devices, procs)
    started = False
    if args.coordinator:
        kind = torch.device(args.device or "cuda").type
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id,
                         backend="gloo" if kind == "cpu" else "nccl")
        started = True
    try:
        mesh = make_mesh(shape, devices=devices, processes=procs)
        state, log = run(cfg, mesh, args.steps, args.batch, args.seq)
        if process_index() == 0:
            n_dev = len({str(d) for d in mesh.devices.flat})
            for r in log:
                print(f"step {r['step']} loss {r['loss']:.4f} gamma "
                      f"{r['gamma']:.2e} tau {r['tau']} ({r['wall_s']:.2f}s) "
                      f"devices={n_dev}")
            # the plan of the first parameter: its blocks live on the
            # mesh's positions
            print("sharding of first param: "
                  f"{tree_leaves(state.params)[0].sharding}")
            print("DISTRIBUTED_RUN_OK")
    finally:
        if started:
            shutdown_distributed()


if __name__ == "__main__":
    main()
