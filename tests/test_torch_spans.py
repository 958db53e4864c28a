"""The port's named spans (``repro_torch.obs.span``).

* With no profiler recording, ``span`` hands back one shared context that
  does nothing and never builds a ``record_function``: a driver's whole
  stream runs with ``record_function`` made to raise.
* Under ``torch.profiler`` a small CPU driver (float plane and quant
  plane) puts every span of :data:`PARENT` in the exported trace, each
  inside its parent's interval, and none bears a name of the
  benchmark's own spans.
* A profiled run returns what an unprofiled one does: ids, scores and
  the driver's counts.
* The program names exactly the spans of :data:`PARENT`.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from conftest import make_clustered
from repro_torch import obs
from repro_torch.core.driver import UBISDriver
from repro_torch.core.types import UBISConfig

SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"

#: every span of the program and the span it lies in (None: no other
#: ``ubis.*`` span holds it)
PARENT = {
    "ubis.insert.round": None,
    "ubis.insert.readback": "ubis.insert.round",
    "ubis.delete.round": None,
    "ubis.tick": None,
    "ubis.tick.exec": "ubis.tick",
    "ubis.tick.exec.readback": "ubis.tick.exec",
    "ubis.bg.split": "ubis.tick.exec",
    "ubis.bg.reassign": "ubis.tick.exec",
    "ubis.tick.drain": "ubis.tick",
    "ubis.tick.mark": "ubis.tick",
    "ubis.tick.gc": "ubis.tick",
    "ubis.tick.pq_retrain": "ubis.tick",
    "ubis.tick.tier": "ubis.tick",
    "ubis.search.phase1": None,
    "ubis.search.phase2": None,
    "ubis.search.cache": None,
    "ubis.search.merge": None,
    "ubis.search.readback": None,
}
#: the benchmark harness's own span names (``ubis_bench/tracing.py``)
HARNESS = {"insert", "delete", "tick", "search.dispatch", "search.collect",
           "window"}

CFG = dict(dim=16, max_postings=256, capacity=96, l_min=10, l_max=80,
           cache_capacity=1024, max_ids=1 << 14)
PLANES = {"float": {},
          "pq": dict(use_pq=True, pq_m=4, pq_ksub=32, rerank_k=96)}
DRIVER_KW = dict(round_size=256, bg_ops_per_round=8, pq_retrain_every=2,
                 gc_lag=1)


def _stream(plane: str) -> dict:
    """Insert, delete, tick, then dispatch and collect a search, on a new
    seeded CPU driver; returns what it answered and counted."""
    data = make_clustered(3000, d=16, seed=3)
    drv = UBISDriver(UBISConfig(**CFG, **PLANES[plane]), data[:800],
                     device="cpu", seed=0, **DRIVER_KW)
    drv.insert(data, np.arange(3000))
    drv.delete(np.arange(0, 3000, 7))
    for _ in range(4):
        drv.tick()
    res = drv.collect_search(drv.dispatch_search(data[:40] + 0.1, 10))
    counts = {k: v for k, v in drv.stats.items() if not k.endswith("_time")}
    return dict(ids=res.ids, scores=res.scores, counts=counts)


def _profiled(plane: str, tmp_path) -> tuple:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _stream(plane)
    path = tmp_path / f"{plane}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, spans


def test_span_off_is_one_shared_noop(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function built with no profiler on")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    a, b = obs.span("ubis.a"), obs.span("ubis.b")
    assert a is b
    with a, b:          # nests, and does nothing
        pass
    for plane in PLANES:
        _stream(plane)


def test_span_on_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = obs.span("ubis.x")
        assert isinstance(s, autograd_profiler.record_function)
        with s:
            pass


@pytest.mark.parametrize("plane", list(PLANES))
def test_profiled_stream_holds_every_span_nested(plane, tmp_path):
    _, spans = _profiled(plane, tmp_path)
    ours = sorted(s for s in spans if s[2].startswith("ubis."))
    assert {s[2] for s in ours} == set(PARENT)
    assert not {s[2] for s in spans} & HARNESS
    for t0, t1, name in ours:
        # the innermost other ubis.* span holding this one is its parent
        holders = [h for h in ours if h[0] <= t0 and t1 <= h[1]
                   and h != (t0, t1, name)]
        inner = max(holders, default=None,
                    key=lambda h: (h[0], -h[1]))
        assert (inner[2] if inner else None) == PARENT[name], (name, inner)


@pytest.mark.parametrize("plane", list(PLANES))
def test_profiler_leaves_the_results_alone(plane, tmp_path):
    plain = _stream(plane)
    traced, _ = _profiled(plane, tmp_path)
    np.testing.assert_array_equal(plain["ids"], traced["ids"])
    np.testing.assert_array_equal(plain["scores"], traced["scores"])
    assert plain["counts"] == traced["counts"]
    assert plain["counts"]["bg_split"] > 0 and plain["counts"]["deleted"] > 0


def test_the_program_names_exactly_these_spans():
    names = set()
    for path in SRC.rglob("*.py"):
        names |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert names == set(PARENT)
