"""On the card: one short run of each plane's query cell through the
command, correct and with its metrics."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["float-query", "pq16-query"])
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "ubis_bench/run.py", "--workload",
                          cell, "--seed", "2147483701", "--seconds", "3",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
