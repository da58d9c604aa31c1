"""Dry run: build every (architecture x input shape) step at full size on
``meta`` tensors, plan it on a production mesh, and count what it costs
(counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
        --shape decode_32k --mesh 2x4

The reference lowers and compiles each step for the mesh and reads the
per-device SPMD program.  The port has no compiler; its sharded step
(``launch.run_distributed``: gather, compute, cut) computes
tensor-parallel for the families of attention layers, each position of a
row with its own blocks, and :func:`sharded_step_costs` counts it position by
position (``flops_per_device`` and ``collective_bytes_per_device``'s
counterparts).  A record holds what the port does:

* ``step_flops`` / ``step_bytes``: the whole step's FLOPs and bytes,
  counted op by op by ``launch.op_cost`` on ``meta`` tensors (the train
  step is ``Trainer.train_step`` with ``n_workers = dp_size(mesh)``, its
  forward, remat recompute, backward and optimizer; a serving step runs on
  a ``meta`` ``Transformer``), with the chunked attention the reference's
  dry run takes;
* ``position_bytes``: the bytes one mesh position holds of the
  parameters, the optimizer state, the inputs and the decode cache under
  the plan (``param_shardings``, ``batch_shardings``,
  ``cache_shardings``);
* ``moved_bytes``: the copies of a sharded train step, from the plan
  (``launch.roofline.moved_bytes``);
* ``uncounted``: ops the counter has no formula for (none expected);
* ``model_flops_total`` (the reference's key), ``trace_s``, and the step's
  bound on one H100 (``roofline_h100``).

Artifacts: experiments/dryrun/<arch>__<shape>__<mesh>[__tag].json
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import ARCH_IDS, SHAPES, applicable, get_config, input_specs
from ..configs.shapes import InputShape, cache_len, decode_window, uses_ring
from ..core.pytree import tree_leaves
from ..mesh import (AbstractMesh, batch_shardings, cache_shardings,
                    device_put, dp_axes, dp_size, make_mesh, model_size,
                    param_shardings, replicated)
from ..models.tensor_parallel import ROW_GATHERED, TENSOR_PARALLEL, TpLeaf
from . import op_cost
from . import run_distributed as rd
from .roofline import H100, RooflineTerms, model_flops, moved_bytes
from .steps import (make_prefill_step, make_serve_step, make_trainer,
                    rows_loss_and_grad)

__all__ = ["DEFAULT_OUT", "Step", "abstract_mesh", "production_mesh",
           "mesh_tag", "build_step", "make_step", "sharded_step_costs",
           "analyze", "run_one", "main"]

DEFAULT_OUT = "experiments/dryrun"


def abstract_mesh(shape, axes=None) -> AbstractMesh:
    """An ``AbstractMesh`` of ``shape``; ``axes`` default to the last
    ``len(shape)`` of ("pod", "data", "model"), as ``make_mesh``'s."""
    shape = tuple(int(s) for s in shape)
    return AbstractMesh(shape, axes or ("pod", "data", "model")[-len(shape):])


def production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The 16x16 ("data", "model") mesh, or 2x16x16 with "pod"."""
    return abstract_mesh((2, 16, 16) if multi_pod else (16, 16))


def mesh_tag(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


class Step:
    """One (arch, shape) step on ``meta`` tensors: ``run()`` calls it.
    ``plan`` maps "params", "opt_state", "inputs" and "cache" (those the
    step has) to (tree, shardings); ``moved`` is
    ``roofline.moved_bytes`` of a train step, else None."""

    def __init__(self, kind: str, fn: Callable, args: tuple,
                 plan: Dict[str, Tuple[Any, Any]],
                 moved: Optional[Dict[str, int]] = None):
        self.kind, self.fn, self.args = kind, fn, args
        self.plan, self.moved = plan, moved

    def run(self):
        return self.fn(*self.args)

    def position_bytes(self) -> Dict[str, int]:
        """The bytes one mesh position holds of each planned tree (every
        block of a leaf has its sharding's ``shard_shape``)."""
        return {name: sum(int(np.prod(sh.shard_shape(tuple(leaf.shape)),
                                      dtype=np.int64)) * leaf.element_size()
                          for leaf, sh in zip(tree_leaves(tree),
                                              tree_leaves(shardings)))
                for name, (tree, shardings) in self.plan.items()}


def build_step(arch: str, shape_name: str, mesh, *, fsdp: bool = True,
               remat_chunk: bool = False, shard_acts: bool = False,
               seq_shard: bool = False, cp_cache: bool = False,
               small_out: int = 0, ce_chunk: int = 0
               ) -> Tuple[Optional[Step], str]:
    """The step of one (arch, shape) planned on ``mesh`` (``(None,
    why)`` where ``configs.applicable`` skips the combo).  The keyword
    knobs are the reference's beyond-paper optimizations, all off by
    default; ``remat_chunk`` recomputes each attention chunk's scores in
    the backward pass, as the reference's ``jax.checkpoint`` does."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return None, why
    if remat_chunk or shard_acts or seq_shard or ce_chunk:
        cfg = cfg.replace(remat_chunk=remat_chunk,
                          shard_activations=shard_acts, seq_shard=seq_shard,
                          ce_chunk=ce_chunk, act_dp_axes=tuple(dp_axes(mesh)))
    return make_step(cfg, shape, mesh, fsdp=fsdp, small_out=small_out,
                     cp_cache=cp_cache), ""


def make_step(cfg, shape, mesh, *, fsdp: bool = True, small_out: int = 0,
              cp_cache: bool = False) -> Step:
    """The step ``shape.kind`` runs for ``cfg`` (any size: a reduced
    config, a cut depth), planned on ``mesh``, with the chunked
    attention."""
    from ..models import Transformer, param_tree

    cfg = cfg.replace(attention_impl="chunked")
    specs = input_specs(cfg, shape)
    B = shape.global_batch

    if shape.kind == "train":
        trainer = make_trainer(cfg, n_workers=dp_size(mesh))
        state = trainer.state_specs()
        batch = specs["batch"]
        plan = {"params": (state.params, param_shardings(
                    state.params, mesh, fsdp=fsdp,
                    small_out_threshold=small_out)),
                "opt_state": (state.opt, state.opt._replace(
                    inner=param_shardings(state.opt.inner, mesh, fsdp=fsdp,
                                          small_out_threshold=small_out),
                    **{f: replicated(getattr(state.opt, f), mesh)
                       for f in ("step", "ss", "worker_stamp")})),
                "inputs": (batch, batch_shardings(batch, mesh, B))}
        worker = torch.zeros((), dtype=torch.int32, device="meta")
        return Step("train", trainer.train_step, (state, batch, worker),
                    plan, moved_bytes(state, mesh, fsdp=fsdp,
                                      small_out=small_out))

    with torch.no_grad():
        model = Transformer(cfg, None, torch.device("meta"))
    params = param_tree(model)
    p_plan = (params, param_shardings(params, mesh, fsdp=fsdp,
                                      small_out_threshold=small_out))
    if shape.kind == "prefill":
        batch = specs["batch"]
        return Step("prefill", make_prefill_step(cfg), (model, batch),
                    {"params": p_plan,
                     "inputs": (batch, batch_shardings(batch, mesh, B))})

    # decode / decode_long: one token against a full cache (the last
    # position, so every slot is read, as the reference's masked step reads
    # them all)
    clen = cache_len(cfg, shape)
    step = make_serve_step(cfg, window=decode_window(cfg, shape),
                           ring=uses_ring(cfg, shape))
    cache, token = specs["cache"], specs["token"]
    return Step("decode", step, (model, cache, token, clen - 1),
                {"params": p_plan,
                 "inputs": (token, batch_shardings(token, mesh, B)),
                 "cache": (cache, cache_shardings(
                     cache, mesh, B, clen, context_parallel=cp_cache))})


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def sharded_step_costs(cfg, mesh_shape, batch: int, seq: int,
                       devices=None) -> dict:
    """``launch.run_distributed.sharded_train_step`` for ``cfg`` (any
    size) at ``batch`` x ``seq`` on a ("data", "model") mesh of
    ``mesh_shape`` on its route (``models.tensor_parallel.route``),
    counted part by part on ``meta`` tensors: the
    :class:`op_cost.Cost` of the gather, of the rows' loss and gradients
    (``steps.rows_loss_and_grad``, chunked attention), of the cut and of
    the optimizer over the blocks; the model FLOPs; the moved bytes on a
    mesh of ``devices`` (default a device a position); ``update_once``,
    the bytes the update's tensors must cross once (the parameter and
    gradient blocks and the optimizer state read, the new parameters and
    state written); and ``positions``, the counterparts of the
    reference's ``flops_per_device`` and ``collective_bytes_per_device``:
    for each "model" position of a row, the FLOPs and bytes of its own
    ops of the rows' loss and gradients plus the row's own (the work
    every position of an SPMD program would do), per row, and the bytes
    its row exchanged (activations gathered or summed between positions,
    each at its whole size, forward and recompute; ``leaf_bytes`` the
    small leaves gathered whole)."""
    cfg = cfg.replace(attention_impl="chunked")
    shape = InputShape("sharded_step", seq, batch, "train")
    meta = torch.device("meta")
    n = int(np.prod(mesh_shape))
    mesh = make_mesh(tuple(mesh_shape), devices=[meta] * n)
    trainer = make_trainer(cfg, n_workers=dp_size(mesh), lr=1e-3)
    specs = trainer.state_specs()
    state = rd.shard_state(specs, mesh)
    plain_batch = input_specs(cfg, shape)["batch"]
    cut_batch = device_put(plain_batch,
                           batch_shardings(plain_batch, mesh, batch))
    g_tr = op_cost.trace(rd.gather_params, state, cfg)
    groups = [next((leaf.group for leaf in tree_leaves(tree)
                    if isinstance(leaf, TpLeaf)), None)
              for _, tree in sorted(g_tr.result.items())]
    tensor_parallel = groups[0] is not None
    c_tr = op_cost.trace(rows_loss_and_grad, g_tr.result, cfg,
                         rd.row_batches(cut_batch, mesh), mesh,
                         groups=[g for g in groups if g is not None])
    g_tr.result = None
    k_tr = op_cost.trace(rd.cut_gradients, c_tr.result[2], state)
    u_tr = op_cost.trace(rd.update_blocks, trainer, state, k_tr.result, 0)
    moved_mesh = (abstract_mesh(mesh_shape) if devices is None
                  else make_mesh(tuple(mesh_shape), devices=devices))
    rows = len(groups)
    by = c_tr.by_position()
    m = model_size(mesh) if tensor_parallel else 1
    positions = [{"flops": (by[None].flops + by.get(p, op_cost.Cost()).flops)
                  / rows,
                  "bytes": (by[None].bytes + by.get(p, op_cost.Cost()).bytes)
                  / rows,
                  "exchanged_bytes": [0 if g is None else g.exchanged
                                      for g in groups],
                  "leaf_bytes": [0 if g is None else g.leaf_bytes
                                 for g in groups]}
                 for p in range(m)]
    return {"gather": g_tr.cost(), "compute": c_tr.cost(),
            "cut": k_tr.cost(), "update": u_tr.cost(),
            "model_flops": model_flops(cfg, shape),
            "moved": moved_bytes(specs, moved_mesh,
                                 tensor_parallel=tensor_parallel),
            "update_once": (3 * _tree_bytes(specs.params)
                            + 2 * _tree_bytes(specs.opt)),
            "route": TENSOR_PARALLEL if tensor_parallel else ROW_GATHERED,
            "by_position": by, "positions": positions}


def analyze(step: Step, arch: str, shape_name: str, mesh) -> dict:
    """The record of one built step: its counted cost, the plan's bytes a
    position, the moved bytes and the analytic model FLOPs."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    with mesh:
        cost = op_cost.analyze(step.run)
    t_trace = time.perf_counter() - t0
    moved = step.moved or {}
    mf = model_flops(cfg, SHAPES[shape_name])
    bound = RooflineTerms(cost.flops, cost.bytes, float(sum(moved.values())),
                          mf, chips=1, hardware=H100)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag(mesh),
        "chips": mesh.size,
        "step_flops": cost.flops,
        "step_bytes": cost.bytes,
        "model_flops_total": mf,
        "model_over_step_flops": mf / cost.flops if cost.flops else 0.0,
        "position_bytes": step.position_bytes(),
        "moved_bytes": moved,
        "uncounted": cost.uncounted,
        "roofline_h100": {k: v for k, v in bound.as_dict().items()
                          if k.startswith("t_") or k in
                          ("dominant", "step_time_bound_s")},
        "trace_s": t_trace,
    }


def run_one(arch: str, shape_name: str, mesh, out_dir: str, *,
            fsdp: bool = True, tag: str = "", verbose: bool = True,
            **knobs) -> dict:
    t0 = time.perf_counter()
    step, why = build_step(arch, shape_name, mesh, fsdp=fsdp, **knobs)
    if step is None:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag(mesh),
               "skipped": why}
        _write(out_dir, rec, tag)
        if verbose:
            print(f"SKIP  {arch} x {shape_name} x {mesh_tag(mesh)}: {why}")
        return rec
    t_build = time.perf_counter() - t0
    rec = analyze(step, arch, shape_name, mesh)
    rec["build_s"] = t_build
    _write(out_dir, rec, tag)
    if verbose:
        held = sum(rec["position_bytes"].values()) / 2**30
        print(f"OK    {arch} x {shape_name} x {mesh_tag(mesh)}  "
              f"step flops={rec['step_flops']:.3e} "
              f"bytes={rec['step_bytes']:.3e}B "
              f"model/step={rec['model_over_step_flops']:.4f} "
              f"per-position={held:.2f}GiB  "
              f"build={t_build:.1f}s trace={rec['trace_s']:.1f}s")
    return rec


def _write(out_dir: str, rec: dict, tag: str = "") -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if tag:
        name += f"__{tag}"
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="all arch x shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 positions) instead of 16x16")
    ap.add_argument("--mesh", default=None,
                    help="override mesh, e.g. 2x4 (data x model) or 2x2x2")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="")
    # the reference's beyond-paper knobs (baseline = all off)
    ap.add_argument("--remat-chunk", action="store_true")
    ap.add_argument("--shard-acts", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--cp-cache", action="store_true")
    ap.add_argument("--small-out", type=int, default=0)
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--opt", action="store_true",
                    help="enable the full optimized bundle")
    args = ap.parse_args(argv)
    if args.opt:
        args.remat_chunk = args.shard_acts = args.cp_cache = True
        args.small_out = args.small_out or 1024
        if not args.tag:
            args.tag = "opt"
    knobs = dict(remat_chunk=args.remat_chunk, shard_acts=args.shard_acts,
                 seq_shard=args.seq_shard, cp_cache=args.cp_cache,
                 small_out=args.small_out, ce_chunk=args.ce_chunk)

    mesh = (abstract_mesh(int(x) for x in args.mesh.split("x")) if args.mesh
            else production_mesh(multi_pod=args.multi_pod))
    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all required")

    failures = []
    for a, s in combos:
        try:
            run_one(a, s, mesh, args.out, fsdp=not args.no_fsdp,
                    tag=args.tag, **knobs)
        except Exception as e:  # a combo's failure is reported; the rest run
            failures.append((a, s, repr(e)))
            print(f"FAIL  {a} x {s}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run combos failed: {failures}")


if __name__ == "__main__":
    main()
