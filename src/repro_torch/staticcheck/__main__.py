"""``python -m repro_torch.staticcheck``: the full static-analysis gate
(counterpart of ``python -m repro.staticcheck``).

Runs, in order: the kernel-dispatch lint over ``src/repro_torch`` (no
device), the op-trace contract verifier, and the cache-key completeness
and retrace-budget checks, both on ``--device`` (default: the CUDA card;
with none it raises, and it never carries on on the CPU unless asked with
``--device cpu``).  Exits non-zero if ANY layer fails.
"""
from __future__ import annotations

import os

from . import lint


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck",
        description="lint + op-trace contracts + cache-key completeness")
    p.add_argument("--quick", action="store_true",
                   help="contract subset (piag+fedbuff, batched only)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--src", default=None,
                   help="tree to lint (default: the repro_torch package)")
    p.add_argument("--device", default=None,
                   help="device of the dynamic layers (default: the CUDA "
                        "card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    from ..kernels.dispatch import resolve_device
    device = str(resolve_device(args.device))   # raises with no card
    src = args.src or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))

    from . import cachekey, contracts
    print(f"== lint {src} ==")
    rc_lint = lint.main([src])
    print(f"== op-trace contracts ({device}) ==")
    rc_contracts = contracts.main(
        ["--device", device] + (["--quick"] if args.quick else [])
        + (["--verbose"] if args.verbose else []))
    print(f"== cache-key completeness ({device}) ==")
    rc_cachekey = cachekey.main(["--device", device]
                                + (["--verbose"] if args.verbose else []))
    return 1 if (rc_lint or rc_contracts or rc_cachekey) else 0


if __name__ == "__main__":
    raise SystemExit(main())
