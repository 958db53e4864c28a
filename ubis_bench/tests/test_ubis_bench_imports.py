"""Nothing the harness or the reference imports is JAX, the JAX package
or the old CPU benchmarks (top-level names compared whole: the port's
``repro_torch`` starts with ``repro``), and the reference imports
nothing of the program."""
import ast
import json
import os
import subprocess
import sys

from conftest import ROOT, SMALL

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _modules_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("import json, time\nfrom pathlib import Path\n"
            "from ubis_bench import harness\n"
            f"small = json.loads({json.dumps(json.dumps(SMALL))})\n"
            "spec = harness.load_spec(Path.cwd(), 'pq16-ingest', True, small)\n"
            "harness.run_cell(spec, seed=3, seconds=0.5, trace=True, "
            "device='cpu', t_start=time.perf_counter())\n")
    loaded = _modules_after(code)
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import ubis_bench.reference, ubis_bench.roofline,"
                            " ubis_bench.stream, ubis_bench.control")
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_no_source_names_a_forbidden_module():
    for path in (ROOT / "ubis_bench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_run_refuses_a_forbidden_module_loaded_after_the_window(
        monkeypatch, capsys):
    """The check runs last: a module that the reference or a metric's
    reader loads after the window is seen, and no line is printed."""
    import types
    import torch
    from ubis_bench import harness, run

    def run_cell(spec, **kw):
        # as a metric reader that imports JAX would
        monkeypatch.setitem(sys.modules, "jax.numpy",
                            types.ModuleType("jax.numpy"))
        return {"correct": True, "checks": {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", run_cell)
    assert run.main(["--workload", "float-query", "--seed", "1",
                     "--seconds", "1"]) == 4
    assert capsys.readouterr().out == ""
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setattr(harness, "run_cell",
                        lambda spec, **kw: {"correct": True, "checks": {}})
    assert run.main(["--workload", "float-query", "--seed", "1",
                     "--seconds", "1"]) == 0
    assert '"correct": true' in capsys.readouterr().out
