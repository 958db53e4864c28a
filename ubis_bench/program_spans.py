"""The program's own spans in a traced window, and the card's time in each.

``repro_torch`` names the phases of its hot path with
``repro_torch.obs.span`` (``ubis.insert.round``, ``ubis.tick`` and its
phases, ``ubis.search.phase1`` ...): a ``record_function`` while a
profiler records, nothing otherwise.  :class:`ProgramSpans` reads them
from the profiler's Chrome trace beside a :class:`tracing.Trace` of the
same window, and ties each device operation, through its launch's
correlation id, to every span the host was in when it launched it.  It
adds no synchronisation: the trace alone says which span issued what.

``tracing.Trace`` keeps the harness's spans only, and the benchmark's
own runs (``run.py``) read none of this.  This script runs a cell traced
with the program's spans kept and prints the result line with the
per-layer metrics of ``METRICS`` among the others, and two more
entries: ``breakdown.idle_by_span`` (the window's idle seconds by the
innermost span the host was in, every such span) and ``program_spans``
(the card's busy seconds, device-to-host copies and count by span, the
copies in each step, spans and copies a step, the idle seconds):

    python3 ubis_bench/program_spans.py --workload float-ingest --seconds 20 --seeds 1 2 3

On a program without these spans the metrics find nothing to read and
are left out; the copies a step are counted all the same.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "ubis_bench":
    del sys.path[0]          # run as a script: no sibling module shadows
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from ubis_bench import tracing  # noqa: E402

PREFIX = "ubis."
HOST = "host"
DTOH = "DtoH"
EPS = 0.5e-9     # half the trace's resolution: float noise on touching spans

#: per-layer metrics that read the program's spans
#: (``metrics/<name>.py``), with the cells where they find something
METRICS = [
    {"name": "tick.device_ms", "unit": "ms",
     "workloads": ["float-ingest", "pq16-ingest"]},
    {"name": "tick.host_reads", "unit": "count",
     "workloads": ["float-ingest", "pq16-ingest"]},
    {"name": "insert.device_ms", "unit": "ms",
     "workloads": ["float-ingest", "pq16-ingest"]},
    {"name": "search.phase1_ms", "unit": "ms",
     "workloads": ["float-query", "pq16-query"]},
    {"name": "search.phase2_ms", "unit": "ms",
     "workloads": ["float-query", "pq16-query"]},
    {"name": "search.readback_ms", "unit": "ms",
     "workloads": ["float-query", "pq16-query"]},
]


def _segments(spans) -> list:
    """(start, end, names) pieces of the host's timeline, ``names`` the
    spans that hold the piece, outermost first; ``spans`` (start, end,
    name), nested as one thread's calls nest (a span that ends within
    ``EPS`` of another's start has ended)."""
    segs, stack, cur = [], [], None

    def close(t):
        nonlocal cur
        while stack and stack[-1][1] <= t + EPS:
            end = stack[-1][1]
            if end > cur:
                segs.append((cur, end, tuple(s[2] for s in stack)))
                cur = end
            stack.pop()

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close(a)
        if stack and a > cur:
            segs.append((cur, a, tuple(s[2] for s in stack)))
        cur = a
        stack.append((a, b, name))
    close(float("inf"))
    return segs


class ProgramSpans:
    """The ``ubis.*`` spans of one traced window and the device operations
    of its :class:`tracing.Trace` that each span launched (at any depth
    below it), in seconds on the profiler's clock."""

    def __init__(self, events: list, trace: tracing.Trace):
        self.trace = trace
        lo, hi = trace.window or (float("-inf"), float("inf"))
        spans = []
        for ev in events:
            name = ev.get("name", "")
            if (ev.get("ph") != "X" or ev.get("cat") != "user_annotation"
                    or not name.startswith(PREFIX)):
                continue
            ts = float(ev.get("ts", 0.0))
            t0, t1 = ts * 1e-6, (ts + float(ev.get("dur", 0.0))) * 1e-6
            if t1 > lo and t0 < hi:
                spans.append((t0, t1, name))
        self.spans = sorted(spans)
        self._segs = _segments(self.spans + trace.spans)
        self._seg_starts = [s[0] for s in self._segs]
        self.copies = [o for o in trace.ops if DTOH in o[2]]
        self._launched = collections.defaultdict(list)
        for op in trace.ops:
            at = trace.launch.get(op[3])
            if at is not None:
                for name in set(self.names_at(at)):
                    self._launched[name].append(op)

    def names_at(self, t: float) -> tuple:
        """The spans (the program's and the harness's) that held the host
        at time ``t``, outermost first."""
        i = bisect.bisect_right(self._seg_starts, t) - 1
        if i >= 0 and t <= self._segs[i][1]:
            return self._segs[i][2]
        return ()

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[2] == name)

    def seconds(self, name: str) -> float:
        """The summed durations of the spans named ``name``."""
        return sum(b - a for a, b, n in self.spans if n == name)

    def busy_in(self, name: str) -> float:
        """Seconds the device was busy on operations launched inside a
        span named ``name`` (a program span or a harness span), clipped
        to the window."""
        lo, hi = self.trace.window or (float("-inf"), float("inf"))
        return sum(b - a for a, b in tracing._union(
            (max(t0, lo), min(t1, hi))
            for t0, t1, _, _ in self._launched.get(name, ())))

    def copies_in(self, name: str) -> int:
        """Device-to-host copies launched inside a span named ``name``."""
        return sum(1 for o in self._launched.get(name, ()) if DTOH in o[2])

    def idle_by_span(self) -> list:
        """[span, seconds] of the window's idle time on the device, each
        idle interval split over the innermost spans the host was in
        (a ``ubis.*`` span where there is one, else the harness's span,
        else ``host``), largest first.  Every span with idle time is
        listed (a few dozen names at most): on the card the ten largest
        leave out 1-9% of the idle time."""
        if not self.trace.window:
            return []
        lo, hi = self.trace.window
        busy = tracing._union((max(a, lo), min(b, hi))
                              for a, b, _, _ in self.trace.ops)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        by = collections.defaultdict(float)
        j = 0
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            covered = 0.0
            while j < len(self._segs) and self._segs[j][1] <= a:
                j += 1
            k = j
            while k < len(self._segs) and self._segs[k][0] < b:
                s0, s1, names = self._segs[k]
                part = min(b, s1) - max(a, s0)
                if part > 0:
                    by[names[-1]] += part
                    covered += part
                k += 1
            by[HOST] += (b - a) - covered
        return sorted(([n, s] for n, s in by.items() if s > 0),
                      key=lambda x: -x[1])


def of(run):
    """The run's :class:`ProgramSpans`, or None where its trace kept none
    or holds no device operation (the CPU)."""
    trace = run.trace
    ps = getattr(trace, "program", None)
    return ps if ps is not None and trace.ops else None


def kept_trace():
    """A :class:`tracing.Trace` that also keeps the window's
    :class:`ProgramSpans` (as ``program``), and the list of those made."""
    made = []

    class Kept(tracing.Trace):
        def __init__(self, events):
            super().__init__(events)
            self.program = ProgramSpans(events, self)
            made.append(self)

    return Kept, made


def traced_line(spec, *, seed: int, seconds: float, device,
                **kw) -> dict:
    """One traced run of ``spec``'s cell with the program's spans kept:
    its result line, with ``METRICS`` read where the cell lists them,
    ``breakdown.idle_by_span`` and ``program_spans``."""
    from ubis_bench import harness
    cell = spec.cell["name"]
    spec.metrics = spec.metrics + [m for m in METRICS
                                   if cell in m["workloads"]]
    Kept, made = kept_trace()
    plain, tracing.Trace = tracing.Trace, Kept
    try:
        line = harness.run_cell(spec, seed=seed, seconds=seconds,
                                trace=True, device=device,
                                t_start=time.perf_counter(), **kw)
    finally:
        tracing.Trace = plain
    if not made:
        return line
    trace = made[-1]
    ps = trace.program
    steps = max(1, line["window"]["steps"])
    idle = (trace.window_s or 0.0) - trace.busy_s()
    every = ps.idle_by_span()
    names = sorted({s[2] for s in ps.spans})
    # a step starts at the harness's insert span
    starts = [s[0] for s in trace.spans if s[2] == "insert"]
    by_step = [0] * len(starts)
    for o in ps.copies:
        i = bisect.bisect_right(starts, trace.launch.get(o[3], -1.0)) - 1
        if i >= 0:
            by_step[i] += 1
    line["breakdown"]["idle_by_span"] = every
    line["program_spans"] = {
        "spans_per_step": len(ps.spans) / steps,
        "dtoh_per_step": len(ps.copies) / steps,
        "dtoh_by_step": by_step,
        "count": {n: ps.count(n) for n in names},
        "busy_s": {n: ps.busy_in(n) for n in names},
        "dtoh": {n: ps.copies_in(n) for n in names},
        "harness_busy_s": {n: ps.busy_in(n) for n in tracing.SPANS},
        "idle_s": idle,
        "idle_by_span_s": sum(s for _, s in every),
    }
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from ubis_bench import harness
    if not torch.cuda.is_available():
        harness.say("no CUDA device: this script reads the card's trace")
        return 3
    for seed in args.seeds:
        spec = harness.load_spec(ROOT, args.workload, True)
        line = traced_line(spec, seed=seed, seconds=args.seconds,
                           device="cuda")
        line["workload"], line["seed"] = args.workload, seed
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
