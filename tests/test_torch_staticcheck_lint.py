"""The port's kernel-dispatch lint (``repro_torch.staticcheck.lint`` /
``rules``): every rule catches its known-bad fixture and only that, the
port's tree lints clean, and the rules map one to one onto the
reference's, fixture for fixture.

The reference's lint imports no JAX, so the parity case runs it on the
reference's fixtures beside the port's lint on the port's: F1-F3, the
reference's three Pallas fixtures (``bad_scalar_ref``,
``bad_switch_in_kernel``, ``bad_unrouted_pallas``), have the port's
``bad_host_alloc``, ``bad_host_select`` and ``bad_unrouted_launch`` as
counterparts, and each pair gives the same number of findings (one, one
and three).
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import repro.staticcheck as ref_pkg
import repro_torch.staticcheck as sc_pkg
from repro.staticcheck import lint as ref_lint
from repro_torch.staticcheck import rules
from repro_torch.staticcheck.lint import iter_py, lint_file, lint_paths
from repro_torch.staticcheck.rules import ALL_RULES, RULE_DOCS


@pytest.fixture(autouse=True)
def _one_thread():
    """The lint runs no tensor code, but the file keeps to one intra-op
    thread as the port's other test files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PKG_DIR = os.path.dirname(os.path.abspath(sc_pkg.__file__))
_FIXTURES = os.path.join(_PKG_DIR, "fixtures")
_SRC = os.path.dirname(_PKG_DIR)            # .../src/repro_torch
_REF_FIXTURES = os.path.join(
    os.path.dirname(os.path.abspath(ref_pkg.__file__)), "fixtures")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXPECTED = {
    "bad_host_select.py": "KRN001",
    "bad_host_alloc.py": "KRN002",
    "bad_unrouted_launch.py": "KRN003",
    "bad_global_rng.py": "RNG001",
    "bad_card_branch.py": "HOST001",
    "bad_mutate_captured.py": "CACHE001",
}
# the reference's fixture of each port fixture (F1-F3 first)
REFERENCE_FIXTURE = {
    "bad_host_alloc.py": "bad_scalar_ref.py",            # F1
    "bad_host_select.py": "bad_switch_in_kernel.py",     # F2
    "bad_unrouted_launch.py": "bad_unrouted_pallas.py",  # F3
    "bad_global_rng.py": "bad_host_entropy.py",
    "bad_card_branch.py": "bad_traced_branch.py",
    "bad_mutate_captured.py": "bad_mutate_captured.py",
}
# rule -> the reference's rule (PAL001 <-> KRN001, ...), as stated
RULE_TABLE = {"KRN001": "PAL001", "KRN002": "PAL002", "KRN003": "PAL003",
              "RNG001": "JIT001", "HOST001": "JIT002",
              "CACHE001": "CACHE001"}


@pytest.mark.parametrize("fixture,rule", sorted(EXPECTED.items()))
def test_each_rule_catches_its_fixture(fixture, rule):
    findings = lint_file(os.path.join(_FIXTURES, fixture))
    assert findings, f"{fixture} produced no findings"
    assert {f.rule for f in findings} == {rule}, \
        f"{fixture} must trigger ONLY {rule}: {[str(f) for f in findings]}"


def test_rule_catalogue_matches_fixture_corpus():
    assert {r.name for r in ALL_RULES} == set(EXPECTED.values())
    assert set(RULE_DOCS) == set(EXPECTED.values())
    present = {f for f in os.listdir(_FIXTURES) if f.endswith(".py")}
    assert present == set(EXPECTED), \
        "fixture corpus and EXPECTED map drifted apart"


def test_port_tree_lints_clean():
    findings = lint_paths([_SRC])
    assert not findings, "\n".join(str(f) for f in findings)


def test_fixtures_excluded_by_default():
    default = set(iter_py([_SRC]))
    included = set(iter_py([_SRC], include_fixtures=True))
    assert not any("fixtures" in p for p in default)
    assert included - default == {
        os.path.join(_FIXTURES, f) for f in EXPECTED}


def test_select_restricts_rules():
    path = os.path.join(_FIXTURES, "bad_unrouted_launch.py")
    assert lint_file(path, select=["KRN003"])
    assert lint_file(path, select=["RNG001"]) == []
    with pytest.raises(SystemExit, match="unknown rule"):
        lint_file(path, select=["NOPE999"])


def test_syntax_error_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    findings = lint_file(str(bad))
    assert len(findings) == 1 and findings[0].rule == "PARSE"


@pytest.mark.parametrize("fixture", sorted(REFERENCE_FIXTURE))
def test_fixture_parity_with_the_reference_lint(fixture):
    """The reference's lint on its fixture and the port's on the
    counterpart: one rule each, the pair of the stated table, and the same
    number of findings (F1 and F2 one, F3 three)."""
    ref = ref_lint.lint_file(os.path.join(_REF_FIXTURES,
                                          REFERENCE_FIXTURE[fixture]))
    port = lint_file(os.path.join(_FIXTURES, fixture))
    ref_rules, port_rules = {f.rule for f in ref}, {f.rule for f in port}
    assert len(ref_rules) == len(port_rules) == 1
    assert RULE_TABLE[port_rules.pop()] == ref_rules.pop()
    assert len(port) == len(ref)
    if fixture in ("bad_host_alloc.py", "bad_host_select.py"):
        assert len(port) == 1
    if fixture == "bad_unrouted_launch.py":
        assert len(port) == 3


def test_rule_table_is_one_to_one_with_the_reference():
    from repro.staticcheck.rules import ALL_RULES as REF_RULES
    assert set(RULE_TABLE) == {r.name for r in ALL_RULES}
    assert sorted(RULE_TABLE.values()) == sorted(r.name for r in REF_RULES)
    assert set(REFERENCE_FIXTURE.values()) == {
        f for f in os.listdir(_REF_FIXTURES) if f.endswith(".py")}


def test_fixtures_are_never_run():
    """The fixtures are lint input only: no module of the port imports
    one, and none calls itself at import."""
    for path in iter_py([_SRC]):
        tree = ast.parse(open(path, encoding="utf-8").read())
        modules = {(n.module or "") for n in ast.walk(tree)
                   if isinstance(n, ast.ImportFrom)}
        modules |= {a.name for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names}
        assert not any("fixtures" in m for m in modules), path
    for name in EXPECTED:
        tree = ast.parse(open(os.path.join(_FIXTURES, name)).read())
        top_calls = [n for n in tree.body if isinstance(n, ast.Expr)
                     and isinstance(n.value, ast.Call)]
        assert not top_calls, name


def _lint_source(tmp_path, src: str, name: str = "mod.py"):
    path = tmp_path / name
    path.write_text(src)
    return lint_file(str(path))


def test_krn001_exempts_a_number_under_is_tensor(tmp_path):
    """``float(g)`` where ``torch.is_tensor(g)`` is false converts a
    number (``kernels.prox_step``'s gamma), not a card tensor."""
    body = '''
from repro_torch.kernels.build import load
from repro_torch.kernels.dispatch import kernel_route

def step(x, gamma):
    if kernel_route(x) == "plain":
        return x
    ptr = gamma.data_ptr() if torch.is_tensor(gamma) else None
    val = 0.0 if torch.is_tensor(gamma) else float(gamma)
    load("k").lib.step_launch(x.data_ptr(), ptr, val)
    return x
'''
    assert _lint_source(tmp_path, body) == []
    bad = body.replace("0.0 if torch.is_tensor(gamma) else float(gamma)",
                       "float(gamma)")
    assert [f.rule for f in _lint_source(tmp_path, bad)] == ["KRN001"]


def test_host001_sees_the_solver_event_bodies(tmp_path):
    """A function handed to ``solver_loop`` runs once per event; a value
    test on its arguments is a finding even with no loop in sight, the
    structure test is not, and rebinding the name is followed."""
    src = '''
def run(carry0, xs, faults=None):
    def advance(carry, event):
        x, ss = carry
        if faults is not None:
            x = x + 0
        return (x, ss), x
    def advance_guarded(carry, event):
        x, ss = carry
        if event[1].max() > 3:
            x = x + 1
        return (x, ss), x
    if faults is not None:
        advance = advance_guarded
    return solver_loop(advance, None, carry0, xs)
'''
    found = _lint_source(tmp_path, src)
    assert [(f.rule, f.line) for f in found] == [("HOST001", 10)]


def test_lint_cli_runs_without_torch():
    """``python -m repro_torch.staticcheck.lint src/repro_torch`` exits 0
    and imports no torch (pure AST)."""
    code = ("import sys, runpy; sys.argv = ['lint', 'src/repro_torch']\n"
            "try:\n    runpy.run_module('repro_torch.staticcheck.lint', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'torch' not in sys.modules, 'the lint imported torch'\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stderr


def test_rules_module_imports_no_torch():
    tree = ast.parse(open(rules.__file__).read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
    assert not imported & {"torch", "jax", "repro", "numpy"}
