"""Async-BCD trainer for neural networks (counterpart of
``repro.launch.train_bcd``; the paper's Algorithm 2 at NN scale,
feature-space distribution).

The parameter tree is partitioned into ``m`` blocks (leaves packed by
size, in ``jax.tree_util``'s leaf order, so the blocks are the
reference's); simulated workers repeatedly read a (stale) full snapshot,
compute the gradient, and write one randomly chosen block back with the
delay-adaptive step-size chosen inside the write event -- exactly Eq. (5)
with R = 0 (or a prox).  Block writes make new tensors, so a worker's
snapshot keeps the leaves it read.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..core.engine import simulate_shared_memory
from ..core.prox import ProxOp, Zero
from ..core.pytree import tree_flatten, tree_leaves, tree_unflatten
from ..core.stepsize import StepsizePolicy
from ..data import TokenStream
from ..kernels.dispatch import resolve_device
from ..models import init_params, loss_fn, param_tree
from ..models.config import ModelConfig
from .steps import loss_and_grad

__all__ = ["block_partition", "run_bcd_training"]


def block_partition(params, m: int) -> List[List[int]]:
    """Partition leaf indices into m roughly-equal blocks by element count."""
    sizes = [int(np.prod(tuple(leaf.shape))) for leaf in tree_leaves(params)]
    order = np.argsort(sizes)[::-1]  # biggest first, greedy bin packing
    blocks: List[List[int]] = [[] for _ in range(m)]
    loads = np.zeros(m)
    for i in order:
        b = int(np.argmin(loads))
        blocks[b].append(int(i))
        loads[b] += sizes[i]
    return [sorted(b) for b in blocks if b]


def run_bcd_training(cfg: ModelConfig, policy: StepsizePolicy, *,
                     steps: int = 100, batch: int = 4, seq: int = 64,
                     m_blocks: int = 4, n_workers: int = 3, seed: int = 0,
                     prox: ProxOp = Zero(), log_every: int = 10,
                     lr_scale: float = 1.0, device=None) -> List[Dict]:
    """Async-BCD over parameter blocks with real stale snapshots, on
    ``device`` (the CUDA card unless ``"cpu"``).  The parameters come from
    ``init_params(cfg, Generator(seed))``; the trace, block draws and
    batches are the reference's for the same seed.  The step-size state
    is a handful of scalars on the host."""
    dev = resolve_device(device)
    params = param_tree(init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    leaves, spec = tree_flatten(params)
    blocks = block_partition(params, m_blocks)
    m = len(blocks)
    stream = TokenStream(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed,
                         device=dev)

    @torch.no_grad()
    def loss_eval(p, b):
        return loss_fn(p, cfg, b)[0]

    trace = simulate_shared_memory(n_workers, steps, m, seed=seed)
    rng = np.random.default_rng(seed)
    block_choice = rng.integers(0, m, size=steps)

    # worker snapshots: each holds the leaves it read (stale)
    snapshots = [list(leaves) for _ in range(n_workers)]
    ss = policy.init(device="cpu")
    log: List[Dict] = []
    t0 = time.perf_counter()
    for k in range(steps):
        w = int(trace.worker[k])
        j = int(block_choice[k])
        tau = int(trace.tau[k])
        # worker w computed grads on ITS stale snapshot (Algorithm 2 line 4)
        snap = tree_unflatten(spec, snapshots[w])
        g_leaves = tree_leaves(loss_and_grad(snap, cfg, stream.batch_at(k))[2])
        gamma, ss = policy.step(ss, tau)
        lr = float(gamma) * lr_scale
        # write block j (Eq. 5) -- only block-j leaves move
        with torch.no_grad():
            for i in blocks[j]:
                leaves[i] = prox.prox(leaves[i] - lr * g_leaves[i], lr)
        del g_leaves
        # worker w re-reads the shared iterate (line 10)
        snapshots[w] = list(leaves)
        if k % log_every == 0 or k == steps - 1:
            cur = tree_unflatten(spec, leaves)
            lv = float(loss_eval(cur, stream.batch_at(10_000)))
            log.append({"step": k, "loss": lv, "gamma": float(gamma),
                        "tau": tau, "block": j,
                        "wall_s": time.perf_counter() - t0})
            print(f"bcd step {k:4d} block {j} loss {lv:.4f} "
                  f"gamma {float(gamma):.2e} tau {tau}")
    return log
