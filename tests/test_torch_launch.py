"""The port's ``launch.sweep`` and ``launch.report`` CLIs against the
reference's.

``launch.sweep``: the same flags give the same summary -- the header line
(cells, policies, seeds, widths, events, tau-bar, horizon, devices) and
the delay profile exactly, the per-policy table's names and clipped
counts exactly and its objectives within OBJ_REL (the port's default
engine, the hand-written kernel's plain version here, against the
reference's scan).  ``launch.report``: the same text for the same ledger,
whichever package wrote it.
"""
import io
import json
import re
import sys
from contextlib import redirect_stdout

import pytest
import torch

from repro.launch import report as jreport
from repro.launch import sweep as jsweep
from repro.telemetry.ledger import read_ledger as j_read_ledger
from repro.telemetry.ledger import set_ledger_path as j_set_ledger_path
from repro_torch.launch import report as treport
from repro_torch.launch import sweep as tsweep
from repro_torch.telemetry.ledger import set_ledger_path as t_set_ledger_path

OBJ_REL = 1e-5
FLAGS = ["--seeds", "2", "--events", "32", "--samples", "240", "--dim", "30",
         "--workers", "4", "--telemetry"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's programs here are tiny: torch's intra-op threads would
    only contend with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["repro.launch.sweep"] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        jsweep.main()
    return out.getvalue().splitlines()


def _port_cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        tsweep.main(argv + ["--device", "cpu"])
    return out.getvalue().splitlines()


def _table(lines):
    start = next(i for i, ln in enumerate(lines) if ln.startswith("policy"))
    rows = []
    for ln in lines[start + 1:]:
        parts = ln.split()
        if len(parts) != 5:
            break
        rows.append((parts[0], float(parts[1]), float(parts[2]),
                     float(parts[3]), int(parts[4])))
    return lines[start], rows


@pytest.mark.parametrize("solver, backend", [("piag", "sharded"),
                                             ("fedbuff", "sharded"),
                                             ("piag", "batched")])
def test_sweep_cli_summary_matches_reference(monkeypatch, tmp_path, solver,
                                             backend):
    argv = ["--solver", solver, "--backend", backend] + FLAGS
    if solver == "fedbuff":
        argv += ["--buffer-size", "2"]
    ref = _reference_cli(monkeypatch, argv + ["--json",
                                              str(tmp_path / "ref.json")])
    got = _port_cli(argv + ["--json", str(tmp_path / "port.json")])
    assert got[0] == ref[0]
    assert f"sweep[{solver}/{backend}]" in got[0] and "devices=1" in got[0]
    assert got[1].startswith(f"{backend} backend: ")
    head_r, rows_r = _table(ref)
    head_p, rows_p = _table(got)
    assert head_p == head_r and len(rows_p) == len(rows_r) > 0
    for r, p in zip(rows_r, rows_p):
        assert p[0] == r[0] and p[4] == r[4]
        for a, b in zip(r[1:3], p[1:3]):
            assert abs(a - b) <= OBJ_REL * abs(a) + 1e-5
        assert abs(r[3] - p[3]) <= 1e-3 * abs(r[3]) + 1e-3
    prof = [ln for ln in got if ln.startswith("delay profile")]
    assert prof == [ln for ln in ref if ln.startswith("delay profile")]
    jr = json.loads((tmp_path / "ref.json").read_text())
    jp = json.loads((tmp_path / "port.json").read_text())
    assert sorted(jp) == sorted(jr)
    for k in ("solver", "backend", "events", "tau_bar", "horizon",
              "horizon_auto", "record_every", "devices", "clipped"):
        assert jp[k] == jr[k], k
    assert len(jp["cells"]) == len(jr["cells"])
    assert jp["telemetry"]["delay_hist"] == jr["telemetry"]["delay_hist"]


def test_sweep_cli_loads_a_port_spec_file(tmp_path):
    """``--spec`` loads a file defining the port's ``SPEC``: here a
    sharded run on a mesh that lists the CPU twice."""
    path = tmp_path / "spec.py"
    path.write_text(
        "import torch\n"
        "from repro_torch import api\n"
        "from repro_torch.mesh import cell_mesh\n"
        "SPEC = api.ExperimentSpec(\n"
        "    problem=api.ProblemSpec(kind='logreg',\n"
        "                            params=dict(n_samples=240, dim=30)),\n"
        "    topology=api.TopologySpec(n_workers=(3, 4)),\n"
        "    policies=api.PolicyGridSpec(seeds=(0,)),\n"
        "    execution=api.ExecutionSpec(\n"
        "        backend='sharded', device='cpu',\n"
        "        mesh=cell_mesh([torch.device('cpu')] * 2)),\n"
        "    n_events=16)\n")
    out = io.StringIO()
    with redirect_stdout(out):
        tsweep.main(["--spec", str(path)])
    first = out.getvalue().splitlines()[0]
    assert first.startswith("sweep[piag/sharded]: 24 cells")
    assert first.endswith("devices=2")
    empty = tmp_path / "empty.py"
    empty.write_text("X = 1\n")
    with pytest.raises(SystemExit, match="must define SPEC"):
        tsweep.load_spec(str(empty))


def test_report_renders_the_reference_text(monkeypatch, tmp_path):
    """Ledgers written by each package render to the same text in both
    renderers; the port's CLI prints it."""
    ledgers = {}
    try:
        for name, cli in (("port", _port_cli),
                          ("ref", lambda argv: _reference_cli(monkeypatch,
                                                              argv))):
            path = tmp_path / f"{name}.jsonl"
            for backend in ("batched", "sharded"):
                cli(["--solver", "piag", "--backend", backend, "--ledger",
                     str(path)] + FLAGS)
            ledgers[name] = path
    finally:  # --ledger sets a process-wide path in each package
        j_set_ledger_path(None)
        t_set_ledger_path(None)
    for path in ledgers.values():
        records = list(j_read_ledger(path))
        assert len(records) == 2
        assert treport.report(records) == jreport.report(records)
        assert treport.sparkline(records[0]["delay_hist"]) == \
            jreport.sparkline(records[0]["delay_hist"])
    port_records = list(j_read_ledger(ledgers["port"]))
    assert [r["devices"] for r in port_records] == [1, 1]
    assert [r["mesh_shape"] for r in port_records] == [None, [1]]
    out = io.StringIO()
    with redirect_stdout(out):
        treport.main([str(ledgers["port"]), "--last", "1", "--json",
                      str(tmp_path / "timeline.json")])
    text = out.getvalue()
    assert text.startswith("== runs (1) ==")
    assert re.search(r"piag\s+sharded\s+24\s+32", text)
    assert json.loads((tmp_path / "timeline.json").read_text())
