import sys
import types

import pytest

try:
    import hypothesis  # noqa: F401  (real package, if available)
except ImportError:
    # Offline container: install the deterministic stub (tests/_hypothesis_stub)
    # under the `hypothesis` name before test modules import it.
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import _hypothesis_stub as _stub

    mod = types.ModuleType("hypothesis")
    mod.given = _stub.given
    mod.settings = _stub.settings
    mod.assume = _stub.assume
    st_mod = types.ModuleType("hypothesis.strategies")
    for name in ("integers", "floats", "booleans", "sampled_from"):
        setattr(st_mod, name, getattr(_stub.strategies, name))
    mod.strategies = st_mod
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels); skips with a reason where none is present")
    # informational when pytest-timeout is absent (offline container); the
    # chaos tests ALSO assert wall-clock bounds themselves, and the CI
    # chaos lane wraps the whole invocation in a shell-level timeout
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test time budget "
        "(enforced by pytest-timeout when installed)")


def pytest_addoption(parser):
    parser.addoption("--skip-slow", action="store_true", default=False)


def pytest_collection_modifyitems(config, items):
    if config.getoption("--skip-slow"):
        skip = pytest.mark.skip(reason="--skip-slow")
        for item in items:
            if "slow" in item.keywords:
                item.add_marker(skip)
