"""The traced run: ``torch.profiler`` over the window, read back as spans.

The harness wraps each call into the program in a span of its own
(``record_function``: ``insert``, ``delete``, ``tick``,
``search.dispatch``, ``search.collect``, and ``window`` around them
all).  After the window the profiler's Chrome trace is read back into
:class:`Trace`: the device's operations (kernels, copies, memsets) with
their times, each tied through its launch's correlation id to the span
the host was in when it launched it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Optional

SPANS = ("insert", "delete", "tick", "search.dispatch", "search.collect")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Device operations and host spans of one traced window, in seconds
    on the profiler's clock."""

    def __init__(self, events: list):
        spans, launches, ops = [], {}, []
        window = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            t0 = float(ev.get("ts", 0.0)) * 1e-6
            t1 = t0 + float(ev.get("dur", 0.0)) * 1e-6
            corr = (ev.get("args") or {}).get("correlation")
            if cat == "user_annotation":
                if name == "window":
                    window = (t0, t1)
                elif name in SPANS:
                    spans.append((t0, t1, name))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = t0
            elif cat in DEVICE_CATS:
                ops.append((t0, t1, name, corr))
        self.window = window
        self.spans = sorted(spans)
        self._starts = [s[0] for s in self.spans]
        if window is not None:
            ops = [o for o in ops if o[1] > window[0] and o[0] < window[1]]
        self.ops = ops
        self.launch = launches

    @property
    def window_s(self) -> Optional[float]:
        return None if self.window is None else self.window[1] - self.window[0]

    def span_at(self, t: float) -> Optional[str]:
        """The name of the host span that holds time ``t``, if any (the
        harness's spans never nest)."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i][2]
        return None

    def busy_s(self, names=None) -> float:
        """Seconds the device was busy: the union of its operations'
        intervals, clipped to the window; with ``names``, only the
        operations launched inside a span of one of those names."""
        lo, hi = self.window if self.window else (float("-inf"),
                                                  float("inf"))
        sel = []
        for t0, t1, _, corr in self.ops:
            if names is not None:
                at = self.launch.get(corr)
                if at is None or self.span_at(at) not in names:
                    continue
            sel.append((max(t0, lo), min(t1, hi)))
        return sum(b - a for a, b in _union(sel))

    def idle_pct(self) -> Optional[float]:
        """The share of the window in which no device operation ran."""
        if not self.ops or not self.window_s:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def device_ops(self) -> list:
        """[name, seconds] of the operations that took most time."""
        by = {}
        for t0, t1, name, _ in self.ops:
            by[name] = by.get(name, 0.0) + (t1 - t0)
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[span, seconds] of the longest idle gaps on the device, each
        named by the host span that held the gap's middle (``host`` where
        the harness was between spans)."""
        if not self.window:
            return []
        busy = _union((a, b) for a, b, _, _ in self.ops)
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.span_at((a + b) / 2) or "host", b - a]
                for a, b in gaps[:TOP]]


@contextlib.contextmanager
def profiled(enabled: bool, device_type: str):
    """Run the block under ``torch.profiler`` when ``enabled``; yields a
    holder whose ``trace`` is the :class:`Trace` once the block ends."""
    holder = type("Traced", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = Trace(json.load(f).get("traceEvents", []))
    finally:
        os.remove(path)


def spans(enabled: bool):
    """``span(name)``: a named host span the profiler sees when
    ``enabled``, else a context that does nothing."""
    if not enabled:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function
