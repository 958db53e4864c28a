"""Every cell end to end at a small size on the CPU (the kernels' plain
versions), with a result line of the contract's form."""
import json

import pytest

from conftest import ROOT, SEED, SMALL, run_small

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _expected(kind: str, cell: str) -> set:
    return {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    line = run_small(cell)
    assert all(k in line for k in LINE_KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    assert set(line["metrics"]) == _expected("end_to_end", cell)
    for name, m in line["metrics"].items():
        assert m["value"] > 0, name
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("cell", ["float-ingest", "pq16-query"])
def test_traced_cell_reports_program_spans(cell):
    line = run_small(cell, trace=True)
    assert line["correct"] is True, line["checks"]
    # the CPU has no device trace: only the program's own spans read
    want = {n for n in _expected("per_layer", cell) if n.startswith("driver.")}
    assert set(line["metrics"]) == want


def test_a_window_that_runs_out_of_steps_is_no_result():
    """Every step the id room holds is drawn; a window that outlasts them
    exits without a line."""
    import time
    from ubis_bench import harness
    small = {**SMALL, "config": {**SMALL["config"], "index": {
        **SMALL["config"]["index"], "max_ids": 2000 + 3 * 256}}}
    spec = harness.load_spec(ROOT, "float-ingest", False, small)
    assert harness.steps_for(spec) == 3
    with pytest.raises(SystemExit) as exc:
        harness.run_cell(spec, seed=SEED, seconds=600.0, trace=False,
                         device="cpu", t_start=time.perf_counter())
    assert exc.value.code == 5
