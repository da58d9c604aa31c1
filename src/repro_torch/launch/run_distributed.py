"""Train with the model sharded over a ("data", "model") mesh (counterpart
of ``repro.launch.run_distributed``).

    PYTHONPATH=src python -m repro_torch.launch.run_distributed \\
        --arch qwen2-moe-a2.7b --reduced --steps 3 --mesh 2x4 --device cpu

Without ``--device`` the mesh takes one CUDA card a position and raises
when there are fewer; ``--device cuda:0`` (or ``cpu``) lists that one
device at every position.

The trainer is the reference's, ``make_trainer(cfg, n_workers=dp_size(mesh),
lr=1e-3)``, with the chunked attention (the flash-attention kernel has no
backward).  Parameters and the optimizer's moments are cut by
``param_shardings`` into one block a mesh position (``mesh.device_put``),
the policy's scalar state is replicated, and each batch is cut by
``batch_shardings``.  One step (:func:`sharded_train_step`):

1. gather the parameters and the batch onto one device (the all-gather);
2. ``loss_and_grad`` over the global batch: the loss is a function of the
   whole batch (an MoE router's aux term couples every token), so a split
   of the compute over "data" would compute another function;
3. cut each gradient leaf by its parameter's sharding (the
   reduce-scatter);
4. ``DelayAdaptiveOptimizer.update`` over the distinct blocks: AdamW is
   elementwise, and the clip's global norm sums the blocks' squares leaf
   by leaf, each leaf's blocks in mesh index order.

So the step equals the unsharded one but for the order of that one sum:
bitwise where the clip does not act.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core.pytree import tree_leaves, tree_map
from ..mesh import (Mesh, batch_shardings, device_put, dp_size, gather,
                    make_mesh, param_shardings, replicated)
from ..models.config import ModelConfig
from .steps import Trainer, TrainState, loss_and_grad, make_trainer
from .train import PRESETS, make_stream

__all__ = ["shard_state", "gather_inputs", "cut_gradients",
           "update_blocks", "sharded_train_step", "run", "main"]


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
    """Each ``ShardedTensor`` leaf as its distinct blocks: the tensor when
    there is one, else the list of them in mesh index order."""
    return tree_map(lambda s: s.blocks()[0] if s.n_blocks == 1
                    else s.blocks(), tree)


def _unblocks(like, tree):
    """The inverse of :func:`_blocks`: ``like``'s shardings holding the
    blocks of ``tree``, taken in its leaf order."""
    flat = iter(tree_leaves(tree))
    return tree_map(lambda s: s.with_blocks(
        [next(flat) for _ in range(s.n_blocks)]), like)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gather_inputs(state: TrainState, batch, device):
    """Step 1: the parameters and the batch gathered onto ``device``."""
    return (tree_map(lambda s: gather(s, device), state.params),
            tree_map(lambda s: gather(s, device), batch))


def cut_gradients(grads, state: TrainState):
    """Step 3: each gradient leaf cut by its parameter's sharding."""
    return tree_map(lambda g, s: device_put(g, s.sharding), grads,
                    state.params)


def update_blocks(trainer: Trainer, state: TrainState, cut, worker
                  ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """Step 4: the optimizer over the distinct blocks; the new sharded
    state, gamma and tau."""
    params, opt, gamma, tau = trainer.optimizer.update(
        _blocks(state.params), _blocks(cut), _blocks(state.opt), worker)
    return (TrainState(params=_unblocks(state.params, params),
                       opt=_unblocks(state.opt, opt)), gamma, tau)


def sharded_train_step(trainer: Trainer, state: TrainState, batch, worker,
                       device=None) -> Tuple[TrainState, Dict[str, Any]]:
    """One step of ``trainer`` on a state made by :func:`shard_state` and a
    batch cut by ``batch_shardings``; the compute runs on ``device``
    (default the mesh's first).  Returns the new sharded state and the
    metrics of ``Trainer.train_step`` with the seconds of the gather
    (``gather_s``), the loss and gradients (``compute_s``) and the cut and
    update (``update_s``)."""
    first = tree_leaves(state.params)[0].sharding.mesh.devices.flat[0]
    dev = torch.device(device if device is not None else first)
    t0 = time.perf_counter()
    params, full = gather_inputs(state, batch, dev)
    _sync(dev)
    t1 = time.perf_counter()
    loss, metrics, grads = loss_and_grad(params, trainer.cfg, full)
    del params, full
    _sync(dev)
    t2 = time.perf_counter()
    cut = cut_gradients(grads, state)
    del grads
    new, gamma, tau = update_blocks(trainer, state, cut, worker)
    _sync(dev)
    t3 = time.perf_counter()
    metrics = dict(metrics)
    metrics.update(loss=loss, gamma=gamma, tau=tau, gather_s=t1 - t0,
                   compute_s=t2 - t1, update_s=t3 - t2)
    return new, metrics


def run(cfg: ModelConfig, mesh: Mesh, steps: int = 3, batch: int = 8,
        seq: int = 64, device=None) -> Tuple[TrainState, List[dict]]:
    """``steps`` sharded steps of the reference's trainer for ``cfg`` on
    ``mesh`` from the port's initializer (seed 0) and the synthetic
    stream (seed 0), worker ``k % dp_size(mesh)`` at step k; the state
    is made and computed on ``device`` (default the mesh's first).
    Returns the final state and one record a step (loss, gamma, tau,
    seconds)."""
    dev = torch.device(device if device is not None
                       else mesh.devices.flat[0])
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
            state, m = sharded_train_step(trainer, state, b, k % n_workers,
                                          dev)
            loss = float(m["loss"])
            if loss != loss:
                raise FloatingPointError("NaN loss in distributed execution")
            log.append(dict(step=k, loss=loss, gamma=float(m["gamma"]),
                            tau=int(m["tau"]),
                            wall_s=time.perf_counter() - t0,
                            **{n: m[n] for n in ("gather_s", "compute_s",
                                                 "update_s")}))
    return state, log


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
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset] if args.preset else get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = tuple(int(x) for x in args.mesh.split("x"))
    devices = (None if args.device is None
               else [args.device] * int(np.prod(shape)))
    mesh = make_mesh(shape, devices=devices)
    state, log = run(cfg, mesh, args.steps, args.batch, args.seq)
    n_dev = len({str(d) for d in mesh.devices.flat})
    for r in log:
        print(f"step {r['step']} loss {r['loss']:.4f} gamma "
              f"{r['gamma']:.2e} tau {r['tau']} ({r['wall_s']:.2f}s) "
              f"devices={n_dev}")
    # the plan of the first parameter: its blocks live on the mesh's
    # positions
    print(f"sharding of first param: {tree_leaves(state.params)[0].sharding}")
    print("DISTRIBUTED_RUN_OK")


if __name__ == "__main__":
    main()
