"""A configuration, a traffic mix (parameters in a ``.json``, or a ``.py``
with its own step), a per-layer metric and a cell added as new files to
a copy of the benchmark are found by name, with no edit to any file that
is there."""
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, SMALL

SCRIPT = """
import json, sys, time
from pathlib import Path
from ubis_bench import harness
small = json.loads(sys.argv[1])
for cell in sys.argv[2:]:
    spec = harness.load_spec(Path.cwd(), cell, True, small)
    line = harness.run_cell(spec, seed=5, seconds=1.0, trace=True,
                            device="cpu", t_start=time.perf_counter())
    print(json.dumps(line))
"""

#: a traffic mix with code of its own: the ingest mix's parameters, and a
#: step that counts itself before the general one
PULSE = """
import json
from pathlib import Path
PARAMS = json.loads((Path(__file__).parent / "ingest-heavy.json").read_text())
CALLS = []
def step(driver, s, deadline, record):
    CALLS.append(s)
    driver.general_step(s, deadline, record)
"""


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "ubis_bench", tmp_path / "ubis_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "ubis_bench").rglob("*")
              if p.is_file()}

    cfg = json.loads((ROOT / "ubis_bench/configs/sift1m-float.json")
                     .read_text())
    cfg["name"] = "tiny-float"
    cfg["engine"] = "ubis"
    (tmp_path / "ubis_bench/configs/tiny-float.json").write_text(
        json.dumps(cfg))
    mix = json.loads((ROOT / "ubis_bench/traffic/ingest-heavy.json")
                     .read_text())
    mix["deletes"] = 128            # a mix that shrinks the live set
    (tmp_path / "ubis_bench/traffic/shrinking.json").write_text(
        json.dumps(mix))
    (tmp_path / "ubis_bench/traffic/pulse.py").write_text(PULSE)
    (tmp_path / "ubis_bench/metrics/window.steps.py").write_text(
        "def read(run):\n    return run.steps\n")
    (tmp_path / "ubis_bench/metrics/window.hooked.py").write_text(
        "def read(run):\n    hook = run.spec.hooks.get('step')\n"
        "    return None if hook is None else "
        "len(hook.__globals__['CALLS'])\n")
    bench["configs"].append({"name": "tiny-float", "source": "a test",
                             "file": "ubis_bench/configs/tiny-float.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.shrinking",
                               "config": "tiny-float",
                               "traffic": "shrinking", "chips": 1,
                               "why": "a test"})
    bench["workloads"].append({"name": "tiny.pulse", "config": "tiny-float",
                               "traffic": "pulse", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "window.hooked", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "driver", "moves": "update_vps",
                               "workloads": ["tiny.pulse"]})
    bench["per_layer"].append({"name": "window.steps", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "driver", "moves": "update_vps",
                               "workloads": ["tiny.shrinking"]})
    for m in bench["end_to_end"]:
        if m["name"] == "update_vps":
            m["workloads"] += ["tiny.shrinking", "tiny.pulse"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(SMALL),
                          "tiny.shrinking", "tiny.pulse"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line, pulse = [json.loads(x) for x in out.stdout.strip().splitlines()[-2:]]
    # the new cell reports the new metric, and only the metrics that
    # list it
    assert set(line["metrics"]) == {"window.steps"}
    assert line["metrics"]["window.steps"]["value"] >= 1
    # the live set shrank: fresh 256 a step, 128 deleted
    assert line["correct"] is True, line["checks"]
    # the .py mix's own step ran: the warm-up's and every window step's
    assert set(pulse["metrics"]) == {"window.hooked"}
    assert pulse["metrics"]["window.hooked"]["value"] == (
        pulse["window"]["steps"] + 1)
    assert pulse["correct"] is True, pulse["checks"]
    for p, data in before.items():
        assert p.read_bytes() == data, p
