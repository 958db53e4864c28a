"""The readers of the program's spans (``program_spans.py`` and its
metrics) on a hand-built Chrome trace: harness spans, nested ``ubis.*``
spans, kernels and device-to-host copies tied to their launches by
correlation id; and one traced CPU run through ``traced_line``."""
import types

import numpy as np
import pytest

from conftest import ROOT, SEED, SMALL
from ubis_bench import harness, program_spans, tracing

# (start, end, name) in microseconds on the profiler's clock
HARNESS = [(0, 1000, "window"), (0, 200, "insert"), (200, 500, "tick"),
           (500, 600, "search.dispatch"), (600, 700, "search.collect")]
PROGRAM = [(10, 100, "ubis.insert.round"), (80, 100, "ubis.insert.readback"),
           (110, 190, "ubis.insert.round"),
           (170, 190, "ubis.insert.readback"),
           (210, 490, "ubis.tick"), (220, 300, "ubis.tick.exec"),
           (230, 250, "ubis.bg.split"), (280, 300, "ubis.tick.exec.readback"),
           (300, 400, "ubis.tick.mark"), (400, 480, "ubis.tick.gc"),
           (510, 540, "ubis.search.phase1"), (540, 580, "ubis.search.phase2"),
           (580, 590, "ubis.search.cache"), (590, 598, "ubis.search.merge"),
           (610, 690, "ubis.search.readback")]
# (launch time, device start, device end, kind) by correlation id
KERNEL, DTOH = "kernel", "Memcpy DtoH (Device -> Pinned)"
DEVICE = {1: (20, 30, 60, KERNEL), 2: (85, 90, 95, DTOH),
          3: (120, 130, 150, KERNEL), 4: (175, 176, 180, DTOH),
          5: (235, 240, 270, KERNEL), 6: (285, 290, 292, DTOH),
          7: (310, 320, 330, DTOH), 8: (410, 420, 440, KERNEL),
          9: (515, 520, 560, KERNEL), 10: (545, 560, 600, KERNEL),
          11: (585, 600, 605, KERNEL), 12: (592, 605, 610, KERNEL),
          13: (615, 640, 650, DTOH), 14: (705, 710, 720, KERNEL)}

#: the window's 769 us of idle time by the innermost span the host was in
IDLE_US = {"host": 290, "ubis.tick.mark": 90, "insert.round": 80,
           "search.readback": 70, "ubis.tick.gc": 60, "insert.readback": 31,
           "insert": 30, "tick": 20, "ubis.tick": 20, "ubis.tick.exec": 20,
           "ubis.tick.exec.readback": 18, "ubis.bg.split": 10,
           "search.dispatch": 10, "ubis.search.phase1": 10,
           "search.collect": 10}
IDLE_US = {("ubis." + k if k.startswith(("insert.", "search.r")) else k): v
           for k, v in IDLE_US.items()}


def _events(program=True) -> list:
    evs = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
            "dur": b - a} for a, b, n in HARNESS + (PROGRAM if program
                                                    else [])]
    for corr, (at, t0, t1, kind) in DEVICE.items():
        evs.append({"ph": "X", "cat": "cuda_runtime",
                    "name": ("cudaMemcpyAsync" if kind == DTOH
                             else "cudaLaunchKernel"),
                    "ts": at, "dur": 2, "args": {"correlation": corr}})
        evs.append({"ph": "X", "cat": ("gpu_memcpy" if kind == DTOH
                                       else "kernel"),
                    "name": kind if kind == DTOH else f"k{corr}",
                    "ts": t0, "dur": t1 - t0, "args": {"correlation": corr}})
    return evs


def _run(trace, inserted=2000.0, batches=1):
    batch = {"queries": 2, "probe": np.array([[0, 1], [1, 2]]),
             "ids": np.array([[5, 6], [6, -1]])}
    return types.SimpleNamespace(
        trace=trace, stats={"inserted": inserted},
        searches=[batch] * batches, ticks=1, steps=1,
        index={"dim": 8, "max_postings": 16, "capacity": 4,
               "cache_capacity": 4})


def _kept(events):
    Kept, made = program_spans.kept_trace()
    trace = Kept(events)
    assert made == [trace]
    return trace


def _read(name, run):
    return harness.read_metric(name, run)


def test_each_reader_reads_its_spans():
    run = _run(_kept(_events()))
    assert _read("tick.device_ms", run) == pytest.approx(62e-3)
    assert _read("tick.host_reads", run) == 2
    # 59 us over 2,000 acknowledged inserts, per 1,000
    assert _read("insert.device_ms", run) == pytest.approx(0.0295)
    assert _read("search.phase1_ms", run) == pytest.approx(40e-3)
    assert _read("search.phase2_ms", run) == pytest.approx(40e-3)
    assert _read("search.readback_ms", run) == pytest.approx(80e-3)
    # the phases fit in what the harness's search spans launched
    assert (_read("search.phase1_ms", run) + _read("search.phase2_ms", run)
            <= _read("search.device_ms", run))
    ps = run.trace.program
    assert ps.busy_in("ubis.tick") <= run.trace.busy_s(("tick",))
    for name in tracing.SPANS:
        assert ps.busy_in(name) == pytest.approx(run.trace.busy_s((name,)))
    assert ps.names_at(235e-6) == ("tick", "ubis.tick", "ubis.tick.exec",
                                   "ubis.bg.split")
    assert ps.names_at(705e-6) == ()
    assert len(ps.copies) == 5


def test_idle_by_span_sums_to_the_idle_time():
    trace = _kept(_events())
    every = trace.program.idle_by_span()
    assert {n: s * 1e6 for n, s in every} == pytest.approx(IDLE_US)
    assert len(every) > tracing.TOP        # all of them, not the top ten
    idle = trace.window_s - trace.busy_s()
    assert sum(s for _, s in every) == pytest.approx(idle)
    assert idle == pytest.approx(769e-6)
    assert [n for n, _ in every[:3]] == ["host", "ubis.tick.mark",
                                         "ubis.insert.round"]


def test_the_program_spans_leave_the_harness_readings_alone():
    with_ours, without = (tracing.Trace(_events(p)) for p in (True, False))
    assert with_ours.busy_s() == without.busy_s()
    assert with_ours.idle_gaps() == without.idle_gaps()
    assert with_ours.device_ops() == without.device_ops()
    assert with_ours.spans == without.spans
    for name in ("search.device_ms", "search.roofline", "device_idle.query",
                 "device_idle.ingest"):
        assert _read(name, _run(without)) is not None
        assert _read(name, _run(with_ours)) == _read(name, _run(without))
        assert _read(name, _run(_kept(_events()))) == _read(
            name, _run(without))


@pytest.mark.parametrize("name", [m["name"] for m in program_spans.METRICS])
def test_a_reader_finds_nothing_without_program_spans(name):
    # a trace that kept no program spans (the benchmark's own, or a
    # parent program without them), and one with no device operation
    assert _read(name, _run(tracing.Trace(_events()))) is None
    assert _read(name, _run(_kept(_events(program=False)))) is None
    cpu = [e for e in _events() if e["cat"] == "user_annotation"]
    assert _read(name, _run(_kept(cpu))) is None


@pytest.mark.parametrize("cell", ["float-ingest", "pq16-query"])
def test_traced_line_keeps_the_program_spans(cell):
    spec = harness.load_spec(ROOT, cell, True, SMALL)
    line = program_spans.traced_line(spec, seed=SEED, seconds=1.0,
                                     device="cpu")
    assert line["correct"] is True, line["checks"]
    # the CPU has no device trace: the span readers find nothing there
    assert set(line["metrics"]) <= {"driver.insert_ms", "driver.tick_ms"}
    ps = line["program_spans"]
    assert ps["spans_per_step"] > 0 and ps["dtoh_per_step"] == 0
    want = ({"ubis.insert.round", "ubis.tick", "ubis.tick.mark"}
            if cell == "float-ingest" else
            {"ubis.search.phase1", "ubis.search.readback"})
    assert want <= set(ps["count"])
    assert tracing.Trace is not None and not hasattr(tracing.Trace(
        []), "program")
