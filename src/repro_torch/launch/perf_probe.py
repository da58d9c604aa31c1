"""Per-op cost attribution for one (arch, shape) combo (counterpart of
``repro.launch.perf_probe``).

    PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch yi-34b \\
        --shape train_4k --metric bytes --top 20
    PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch yi-34b \\
        --shape train_4k --describe

The step is ``launch.dryrun.build_step``'s, run on ``meta`` tensors under
``launch.op_cost``; ``--metric flops|bytes`` lists its top ops (summed
over the calls of each op, autograd node and operand shapes),
``--metric coll`` the top leaves of ``launch.roofline.moved_rows`` (the
copies of a sharded train step; serving steps move none), ``--describe``
the sharding plan of the parameters.
"""
from __future__ import annotations

import argparse

from ..configs import ARCH_IDS, SHAPES, get_config
from ..mesh import describe_shardings, param_shardings
from .dryrun import abstract_mesh, build_step, production_mesh
from .op_cost import trace, top_contributors
from .roofline import moved_rows

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--metric", default="bytes",
                    choices=["bytes", "flops", "coll"])
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat-chunk", action="store_true")
    ap.add_argument("--shard-acts", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--cp-cache", action="store_true")
    ap.add_argument("--small-out", type=int, default=0)
    ap.add_argument("--describe", action="store_true",
                    help="print the sharding plan (param -> PartitionSpec)")
    args = ap.parse_args(argv)

    mesh = (abstract_mesh(int(x) for x in args.mesh.split("x")) if args.mesh
            else production_mesh(multi_pod=args.multi_pod))

    if args.describe:
        from ..models import param_specs
        specs = param_specs(get_config(args.arch))
        sh = param_shardings(specs, mesh, small_out_threshold=args.small_out)
        for name, shape, spec in describe_shardings(specs, sh):
            print(f"{name:48s} {str(shape):28s} {spec}")
        return

    step, why = build_step(
        args.arch, args.shape, mesh, remat_chunk=args.remat_chunk,
        shard_acts=args.shard_acts, seq_shard=args.seq_shard,
        cp_cache=args.cp_cache, small_out=args.small_out)
    if step is None:
        raise SystemExit(f"skipped: {why}")
    with mesh:
        tr = trace(step.run)
    cost = tr.cost().with_moved(step.moved or {})
    print(f"total step flops {cost.flops:.3e}  bytes {cost.bytes:.3e}  "
          f"moved {cost.moved_bytes:.3e}")
    print(f"moved breakdown: "
          f"{ {k: f'{v:.2e}' for k, v in cost.moved_breakdown.items()} }")
    if cost.uncounted:
        print(f"uncounted: {cost.uncounted}")
    print(f"\ntop {args.top} by {args.metric}:")
    if args.metric == "coll":
        rows = []
        if step.kind == "train":
            rows = sorted(moved_rows(step.args[0], mesh,
                                     small_out=args.small_out),
                          key=lambda r: r[0], reverse=True)[:args.top]
        for v, kind, path, shape in rows:
            print(f"{v:.3e}  {kind:10s} {str(shape):40s} {path}")
        return
    for v, where, op, calls, shapes in top_contributors(tr, args.metric,
                                                        args.top):
        print(f"{v:.3e}  {op:28s} {shapes:60s} in {where[:30]} ({calls})")


if __name__ == "__main__":
    main()
