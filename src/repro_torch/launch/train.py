"""Asynchronous delay-adaptive LM trainer (counterpart of
``repro.launch.train``), with the model presets that ``launch.serve``
also reads.

Implements the paper's parameter-server semantics with REAL stale
gradients on one device: each simulated worker holds the gradient it
computed on the iterate version it last read; at each write event the
arriving worker's (stale) gradient is applied with the delay-adaptive
step-size, and the worker picks up the new iterate.  Memory = n_workers x
grad size, so this runs a ~100M-parameter model with genuine gradient
staleness.

    PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
        --reduced --steps 50 --policy adaptive2 --device cpu

runs on the CUDA card unless ``--device cpu``.  Training takes the
chunked attention (the reference trainer's); the CLI sets it on every
config and says so, and ``run_training`` raises on
``attention_impl="pallas"`` (``models.loss_fn`` refuses it: the
flash-attention kernel has no backward).  Checkpoints are the reference's npz layout, so a ``final.npz``
resumes in either package.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..configs import ARCH_IDS, get_config
from ..core.engine import heterogeneous_workers, simulate_parameter_server
from ..core.pytree import tree_leaves
from ..core.stepsize import make_policy
from ..data import EmbedStream, TokenStream
from ..kernels.dispatch import resolve_device
from ..models import init_params, loss_fn, param_tree
from ..models.config import ModelConfig
from .steps import TrainState, loss_and_grad, make_trainer

__all__ = ["PRESETS", "make_stream", "run_training", "main"]

PRESETS = {
    # ~103M params: the end-to-end driver scale
    "100m": ModelConfig(name="lm-100m", n_layers=12, d_model=768, n_heads=12,
                        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=8192,
                        q_chunk=256),
    "25m": ModelConfig(name="lm-25m", n_layers=8, d_model=384, n_heads=8,
                       n_kv_heads=4, head_dim=48, d_ff=1024, vocab=4096,
                       q_chunk=256),
    "moe-tiny": ModelConfig(name="moe-tiny", family="moe", n_layers=6,
                            d_model=384, n_heads=8, n_kv_heads=8, head_dim=48,
                            d_ff=512, n_experts=8, top_k=2, moe_ff=512,
                            shared_ff=512, vocab=4096, q_chunk=256),
}


def make_stream(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                device=None):
    if cfg.embed_inputs:
        return EmbedStream(d_model=cfg.d_model, vocab=cfg.vocab, batch=batch,
                           seq=seq, seed=seed, mrope=cfg.rope == "mrope",
                           device=device)
    return TokenStream(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed,
                       device=device)


def run_training(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
                 policy_name: str = "adaptive1", lr: float = 3e-3,
                 n_workers: int = 4, seed: int = 0, log_every: int = 10,
                 straggler: float = 0.05, out_dir: Optional[str] = None,
                 tau_bound_for_fixed: int = 8,
                 resume_from: Optional[str] = None,
                 save_every: int = 0, device=None):
    """Returns the metrics log (list of dicts), as the reference's.

    The parameters come from ``init_params(cfg, Generator(seed))`` on
    ``device`` (the CUDA card unless ``"cpu"``); the trace, the worker
    order and the batches are the reference's for the same seed."""
    dev = resolve_device(device)
    kwargs = {}
    if policy_name in ("fixed", "sun_deng"):
        kwargs["tau_bound"] = tau_bound_for_fixed
    policy = make_policy(policy_name, lr, **kwargs)
    trainer = make_trainer(cfg, policy=policy, n_workers=n_workers)
    params = param_tree(init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    state = TrainState(params=params, opt=trainer.optimizer.init(params))
    start_step = 0
    if resume_from:
        (state,), meta = load_checkpoint(resume_from, (state,))
        start_step = int(meta.get("steps", 0))
        print(f"resumed from {resume_from} at step {start_step}")
    n_params = sum(int(leaf.numel()) for leaf in tree_leaves(state.params))
    print(f"model={cfg.name} params={n_params/1e6:.1f}M "
          f"policy={policy_name} gamma'={lr} workers={n_workers}")

    workers = heterogeneous_workers(n_workers, spread=2.0, seed=seed,
                                    p_straggle=straggler, straggle_x=8.0)
    trace = simulate_parameter_server(n_workers, steps, workers, seed=seed)
    stream = make_stream(cfg, batch, seq, seed, device=dev)
    # every delay a step can see, on the device once: a step indexes it
    # instead of copying a host number to the card
    tau_of = torch.arange(steps + 1, dtype=torch.int32, device=dev)

    def grad_fn(p, b):
        return loss_and_grad(p, cfg, b)[2]

    @torch.no_grad()
    def loss_eval(p, b):
        return loss_fn(p, cfg, b)[0]

    # Algorithm-1 init: every worker computes a gradient at x_0
    pending = {}
    for w in range(n_workers):
        pending[w] = (grad_fn(state.params, stream.batch_at(w)), 0)

    params, opt = state.params, state.opt
    log = []
    t0 = time.perf_counter()
    for k in range(steps):
        w = int(trace.worker[k])
        g, s_read = pending[w]
        tau = k - s_read
        params, opt, gamma = trainer.optimizer.step_fn(params, g, opt,
                                                       tau_of[tau])
        del g
        # worker w picks up x_{k+1} and computes its next gradient
        pending[w] = (grad_fn(params, stream.batch_at(n_workers + k)), k + 1)
        if k % log_every == 0 or k == steps - 1:
            lv = float(loss_eval(params, stream.batch_at(10_000)))
            rec = {"step": start_step + k, "loss": lv, "gamma": float(gamma),
                   "tau": int(tau), "wall_s": time.perf_counter() - t0}
            log.append(rec)
            print(f"step {start_step + k:5d} loss {lv:.4f} "
                  f"gamma {float(gamma):.2e} tau {int(tau)} "
                  f"({rec['wall_s']:.1f}s)")
        if out_dir and save_every and (k + 1) % save_every == 0:
            save_checkpoint(os.path.join(out_dir,
                                         f"step_{start_step + k + 1}.npz"),
                            (TrainState(params=params, opt=opt),),
                            {"steps": start_step + k + 1,
                             "policy": policy_name})
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        save_checkpoint(os.path.join(out_dir, "final.npz"),
                        (TrainState(params=params, opt=opt),),
                        {"steps": start_step + steps, "policy": policy_name,
                         "final_loss": log[-1]["loss"]})
        with open(os.path.join(out_dir, "log.json"), "w") as f:
            json.dump(log, f, indent=1)
    return log


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--preset", choices=list(PRESETS))
    g.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke variant of --arch")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--policy", default="adaptive1",
                    choices=["adaptive1", "adaptive2", "fixed", "sun_deng",
                             "naive"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume-from", default=None,
                    help="checkpoint .npz to resume params+optimizer from")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.preset:
        cfg = PRESETS[args.preset]
    else:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    cfg = cfg.replace(attention_impl="chunked")
    print("attention=chunked for training (the reference trainer's; the "
          "flash-attention kernel has no backward)")
    run_training(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 policy_name=args.policy, lr=args.lr, n_workers=args.workers,
                 seed=args.seed, out_dir=args.out,
                 resume_from=args.resume_from, save_every=args.save_every,
                 device=args.device)


if __name__ == "__main__":
    main()
