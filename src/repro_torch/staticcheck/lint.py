"""Kernel-dispatch lint CLI: ``python -m repro_torch.staticcheck.lint
src/repro_torch`` (counterpart of ``repro.staticcheck.lint``).

Runs every rule in :mod:`repro_torch.staticcheck.rules` over the given
files or directories (``.py`` files, recursively).  The known-bad fixture
corpus under ``staticcheck/fixtures/`` is excluded by default -- those
files exist to PROVE each rule fires (see
``tests/test_torch_staticcheck_lint.py``) and must not fail the tree's
own lint; pass ``--include-fixtures`` to lint them anyway.

Exit status: 0 when clean, 1 when any finding (or a file fails to parse).
Pure AST analysis: no torch import, no execution of the linted code.
"""
from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List, Optional, Sequence

from .rules import ALL_RULES, Finding, ModuleInfo, Rule

__all__ = ["lint_file", "lint_paths", "iter_py", "main"]


def _rules_for(select: Optional[Sequence[str]]) -> Sequence[Rule]:
    if not select:
        return ALL_RULES
    wanted = {s.upper() for s in select}
    unknown = wanted - {r.name for r in ALL_RULES}
    if unknown:
        raise SystemExit(f"unknown rule(s): {', '.join(sorted(unknown))}; "
                         f"known: {', '.join(r.name for r in ALL_RULES)}")
    return [r for r in ALL_RULES if r.name in wanted]


def lint_file(path: str,
              select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one python file; a syntax error is itself reported as a
    finding (rule ``PARSE``) rather than crashing the run."""
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0, "PARSE",
                        f"syntax error: {e.msg}")]
    info = ModuleInfo(tree, path)
    findings: List[Finding] = []
    for rule in _rules_for(select):
        findings.extend(rule.check(info))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _is_fixture_dir(dirpath: str) -> bool:
    parts = os.path.normpath(dirpath).split(os.sep)
    return "fixtures" in parts and "staticcheck" in parts


def iter_py(paths: Iterable[str],
            include_fixtures: bool = False) -> Iterable[str]:
    """Yield ``.py`` files under ``paths`` (files pass through verbatim);
    ``staticcheck/fixtures/`` trees are skipped unless requested."""
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__",))
            if not include_fixtures and _is_fixture_dir(dirpath):
                continue
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               include_fixtures: bool = False) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py(paths, include_fixtures=include_fixtures):
        findings.extend(lint_file(f, select=select))
    return findings


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck.lint",
        description="kernel-dispatch lint for the PyTorch/CUDA port")
    p.add_argument("paths", nargs="+",
                   help=".py files or directories to lint")
    p.add_argument("--select", action="append", default=None,
                   metavar="RULE",
                   help="run only these rule IDs (repeatable)")
    p.add_argument("--include-fixtures", action="store_true",
                   help="also lint staticcheck/fixtures/ (known-bad corpus)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    args = p.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.name}: {r.doc}")
        return 0

    findings = lint_paths(args.paths, select=args.select,
                          include_fixtures=args.include_fixtures)
    for f in findings:
        print(f)
    n_files = sum(1 for _ in iter_py(args.paths,
                                     include_fixtures=args.include_fixtures))
    status = "clean" if not findings else f"{len(findings)} finding(s)"
    print(f"lint: {n_files} file(s), {status}", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
