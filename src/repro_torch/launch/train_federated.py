"""Delay-adaptive asynchronous federated training (counterpart of
``repro.launch.train_federated``).

Two workload families, one server mechanism:

* the paper's convex problems (``--problem logreg`` / ``--problem lasso``)
  run through ``federated.run_fedasync_problem`` / ``run_fedbuff_problem``
  and report true suboptimality against the centralized optimum
  (``solve_centralized``); on the card each upload is one launch of the
  hand-written FedAsync mix kernel (``--buffer 1``) or FedBuff's buffer
  kernel (``--buffer`` > 1);
* the small transformer presets of ``launch.train`` (``--preset 25m``
  ...) run a host-loop federated parameter server: each client holds its
  own data stream and model snapshot, runs ``--local-steps`` SGD steps a
  round (gradients by ``torch.autograd`` over the reference-layout
  parameter tree), and the server mixes client models with the
  delay-adaptive staleness weight alpha * s(tau), leaf by leaf.

    PYTHONPATH=src python -m repro_torch.launch.train_federated \\
        --problem logreg --uploads 2000 --policy hinge
    PYTHONPATH=src python -m repro_torch.launch.train_federated \\
        --preset 25m --uploads 30 --clients 4 --local-steps 2

run on the CUDA card unless ``--device cpu``.  The transformer path takes
the chunked attention, as the trainer CLI does (the flash-attention
kernel has no backward); the CLI sets it and says so.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core import L1, make_lasso, make_logreg, make_policy, solve_centralized
from ..core.pytree import tree_leaves, tree_map
from ..core.stepsize import StepsizePolicy
from ..federated import (heterogeneous_clients, run_fedasync_problem,
                         run_fedbuff_problem, simulate_federated)
from ..kernels.dispatch import resolve_device
from ..models import init_params, loss_fn, param_tree
from .steps import loss_and_grad
from .train import PRESETS, make_stream

__all__ = ["run_convex_federated", "run_transformer_federated",
           "make_weight_policy", "main"]


def make_weight_policy(name: str, alpha: float,
                       tau_bound: int = 0) -> StepsizePolicy:
    """Server mixing-weight policy.  ``fixed_taubound`` is the worst-case
    -tuned constant alpha/(tau_bound+1); the adaptive policies only need
    the measured staleness."""
    if name == "fixed_taubound":
        return make_policy("constant", alpha / (tau_bound + 1))
    if name == "fixed_taubound_sqrt":
        return make_policy("constant", alpha / float(np.sqrt(tau_bound + 1)))
    if name == "hinge":
        return make_policy("hinge", alpha, a=0.5, b=16.0)
    if name == "poly":
        return make_policy("poly", alpha, a=0.3)
    if name == "constant":
        return make_policy("constant", alpha)
    raise ValueError(f"unknown weight policy {name!r}")


def run_convex_federated(problem_name: str = "logreg", *, uploads: int = 2000,
                         n_clients: int = 8, policy_name: str = "hinge",
                         alpha: float = 0.4, buffer_size: int = 1,
                         eta: float = 0.4, seed: int = 0,
                         out_dir: Optional[str] = None, device=None):
    """FedAsync/FedBuff on logreg or lasso on ``device`` (the CUDA card
    unless ``"cpu"``); returns the metrics log: the reference's keys
    (those written to ``out_dir/federated_log.json``) plus ``trace`` (the
    host ``FederatedTrace``) and ``result`` (the ``FedResult``: weights,
    taus, objective)."""
    dev = resolve_device(device)
    if problem_name == "logreg":
        prob = make_logreg(n_samples=500, dim=50, n_workers=n_clients,
                           seed=seed, device=dev)
    elif problem_name == "lasso":
        prob = make_lasso(n_samples=500, dim=100, n_workers=n_clients,
                          seed=seed, device=dev)
    else:
        raise ValueError(f"unknown problem {problem_name!r}")
    prox = L1(lam=prob.lam1)
    _, objs = solve_centralized(prob, prox, iters=3000)
    p_star = float(objs[-1])

    clients = heterogeneous_clients(n_clients, spread=4.0, seed=seed + 1,
                                    p_straggle=0.05, p_dropout=0.02)
    trace = simulate_federated(n_clients, uploads, clients,
                               buffer_size=buffer_size, seed=seed + 1)
    # FedAsync mixes with alpha*s(tau) directly; FedBuff's per-delta weight
    # is the bare s(tau) (gamma'=1) with alpha applied once as the server
    # lr eta.
    base_weight = alpha if buffer_size == 1 else 1.0
    policy = make_weight_policy(policy_name, base_weight, trace.max_delay())
    print(f"problem={problem_name} clients={n_clients} uploads={uploads} "
          f"buffer={buffer_size} policy={policy_name} alpha={alpha} "
          f"max_tau={trace.max_delay()} P*={p_star:.5f} device={dev}")

    t0 = time.perf_counter()
    if buffer_size == 1:
        res = run_fedasync_problem(prob, trace, policy, prox,
                                   local_lr=0.5 / prob.L)
    else:
        res = run_fedbuff_problem(prob, trace, policy, prox, eta=eta,
                                  buffer_size=buffer_size,
                                  local_lr=0.5 / prob.L)
    sub = res.objective.cpu().numpy() - p_star
    wall = time.perf_counter() - t0
    log = {"problem": problem_name, "policy": policy_name,
           "uploads": uploads, "buffer": buffer_size,
           "max_tau": int(trace.max_delay()), "p_star": p_star,
           "final_subopt": float(sub[-1]), "best_subopt": float(sub.min()),
           "wall_s": wall}
    print(f"final P-P* = {sub[-1]:.6f}  best = {sub.min():.6f}  "
          f"({wall:.1f}s, {uploads / wall:.0f} uploads/s)")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "federated_log.json"), "w") as f:
            json.dump(log, f, indent=1)
    return dict(log, trace=trace, result=res)


def run_transformer_federated(cfg, *, uploads: int = 30, n_clients: int = 4,
                              local_steps: int = 2,
                              policy_name: str = "hinge", alpha: float = 0.4,
                              local_lr: float = 3e-3, batch: int = 4,
                              seq: int = 128, seed: int = 0,
                              log_every: int = 5, device=None):
    """Host-loop FedAsync on a transformer preset on ``device`` (the CUDA
    card unless ``"cpu"``); returns the metrics log (a dict per logged
    upload: ``upload``, ``loss``, ``gamma``, ``tau``, ``wall_s``).

    Memory = (n_clients + 1) x params (server model + per-client
    snapshots).  The event structure comes from the same
    ``FederatedTrace`` the convex path uses; only the client update
    (local SGD on the client's token stream) differs.  The parameters
    come from ``init_params(cfg, Generator(seed))`` on ``device``; the
    trace, the weights and the batches are the reference's for the same
    seed."""
    dev = resolve_device(device)
    params = param_tree(init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    n_params = sum(int(leaf.numel()) for leaf in tree_leaves(params))

    clients = heterogeneous_clients(n_clients, spread=3.0, seed=seed,
                                    p_straggle=0.05, p_dropout=0.01,
                                    local_epochs=local_steps)
    trace = simulate_federated(n_clients, uploads, clients, seed=seed)
    policy = make_weight_policy(policy_name, alpha, trace.max_delay())
    print(f"model={cfg.name} params={n_params / 1e6:.1f}M "
          f"clients={n_clients} uploads={uploads} local_steps={local_steps} "
          f"policy={policy_name} max_tau={trace.max_delay()}")

    # per-client disjoint data streams (different seeds = different shards)
    streams = [make_stream(cfg, batch, seq, seed=seed + 100 + c, device=dev)
               for c in range(n_clients)]
    eval_stream = make_stream(cfg, batch, seq, seed=seed + 999, device=dev)
    # every staleness the trace holds, on the device once: an upload
    # indexes it instead of copying a host number to the card
    tau_of = torch.arange(int(trace.max_delay()) + 1, dtype=torch.int32,
                          device=dev)

    def sgd_step(p, b):
        g = loss_and_grad(p, cfg, b)[2]
        return tree_map(lambda a, d: (a - local_lr * d).to(a.dtype), p, g)

    @torch.no_grad()
    def mix(x, xc, gamma):
        return tree_map(lambda a, c: (a + gamma * (c - a)).to(a.dtype),
                        x, xc)

    @torch.no_grad()
    def loss_eval(p, b):
        return loss_fn(p, cfg, b)[0]

    snapshots = [params] * n_clients  # the model each client reads
    ss = policy.init(device=dev)
    log = []
    t0 = time.perf_counter()
    for k in range(uploads):
        c = int(trace.client[k])
        tau = int(trace.tau[k])
        # client c: local_steps SGD steps from its snapshot on its stream
        xc = snapshots[c]
        for s in range(int(trace.local_steps[k])):
            xc = sgd_step(xc, streams[c].batch_at(k * local_steps + s))
        gamma, ss = policy.step(ss, tau_of[tau])
        params = mix(params, xc, gamma)
        snapshots[c] = params      # client picks up the new server model
        if k % log_every == 0 or k == uploads - 1:
            lv = float(loss_eval(params, eval_stream.batch_at(10_000)))
            rec = {"upload": k, "loss": lv, "gamma": float(gamma),
                   "tau": tau, "wall_s": time.perf_counter() - t0}
            log.append(rec)
            print(f"upload {k:4d} loss {lv:.4f} gamma {float(gamma):.3f} "
                  f"tau {tau} ({rec['wall_s']:.1f}s)")
    return log


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--problem", choices=["logreg", "lasso"])
    g.add_argument("--preset", choices=list(PRESETS))
    ap.add_argument("--uploads", type=int, default=2000)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--policy", default="hinge",
                    choices=["hinge", "poly", "constant", "fixed_taubound",
                             "fixed_taubound_sqrt"])
    ap.add_argument("--alpha", type=float, default=0.4)
    ap.add_argument("--buffer", type=int, default=1,
                    help="FedBuff buffer |R|; 1 = FedAsync")
    ap.add_argument("--eta", type=float, default=0.4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-lr", type=float, default=3e-3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.problem:
        run_convex_federated(args.problem, uploads=args.uploads,
                             n_clients=args.clients, policy_name=args.policy,
                             alpha=args.alpha, buffer_size=args.buffer,
                             eta=args.eta, seed=args.seed, out_dir=args.out,
                             device=args.device)
    else:
        cfg = PRESETS[args.preset].replace(attention_impl="chunked")
        print("attention=chunked for training (the reference trainer's; "
              "the flash-attention kernel has no backward)")
        run_transformer_federated(cfg, uploads=args.uploads,
                                  n_clients=args.clients,
                                  local_steps=args.local_steps,
                                  policy_name=args.policy, alpha=args.alpha,
                                  local_lr=args.local_lr, batch=args.batch,
                                  seq=args.seq, seed=args.seed,
                                  log_every=args.log_every,
                                  device=args.device)


if __name__ == "__main__":
    main()
