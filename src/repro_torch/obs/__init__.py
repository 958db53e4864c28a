"""The observability plane: one :class:`Obs` bundle shared by every layer.

Counterpart of ``repro/obs/``:

* :class:`~repro_torch.obs.metrics.MetricsRegistry`: counters, gauges,
  log-bucket latency histograms, the drivers' shared ``stats`` schema,
  the Prometheus text exposition and a JSON snapshot;
* :class:`~repro_torch.obs.trace.Tracer`: structured trace events (a
  bounded ring buffer and an optional JSONL file sink), emitted by every
  planner with its reason;
* :class:`~repro_torch.obs.probe.RecallProbe`, the sampled live-recall
  probe (built by the serving engine through :meth:`Obs.make_probe`);
* :meth:`Obs.profile`, a ``torch.profiler`` capture of a block;
* :func:`span`, the program's named spans (``ubis.*``) in a profiler's
  trace.

A driver builds its own ``Obs()`` unless one is injected; the serving
engine reuses its index's, so one exposition covers driver internals and
request spans.  ``Obs(enabled=False)`` keeps the stats mapping (the
drivers need it) and turns tracing and span recording into no-ops.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, List, Optional

from torch.autograd import profiler as _profiler

from .metrics import (DRIVER_STAT_SCHEMA, GAUGE_STAT_KEYS, Counter, Gauge,
                      Histogram, MetricsRegistry, StatsMap, parse_exposition,
                      required_series)
from .probe import RecallProbe
from .trace import Tracer

__all__ = ["Obs", "MetricsRegistry", "Tracer", "RecallProbe", "Counter",
           "Gauge", "Histogram", "StatsMap", "DRIVER_STAT_SCHEMA",
           "GAUGE_STAT_KEYS", "parse_exposition", "required_series",
           "span"]

_NO_SPAN = nullcontext()


def span(name: str):
    """A named host span in ``torch.profiler``'s trace: a
    ``record_function(name)`` while a profiler records, else one shared
    context that does nothing.  Off, a span costs one flag read (a bare
    ``record_function`` costs microseconds even with no profiler).  On,
    it adds no synchronisation and no host read: each launch's
    correlation id ties a device operation to the innermost span that
    issued it.  The program's spans are named ``ubis.*``."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NO_SPAN


class Obs:
    """Metrics registry + tracer (+ profiler hook)."""

    def __init__(self, *, enabled: bool = True,
                 trace_capacity: int = 4096,
                 trace_path: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.tracer = Tracer(capacity=trace_capacity, path=trace_path,
                             clock=clock, enabled=enabled)
        self._profiles = 0

    def driver_stats(self, prefix: str = "index") -> StatsMap:
        """The shared-schema ``stats`` map of a driver, exported under
        ``prefix``."""
        return self.registry.stats_map(prefix, DRIVER_STAT_SCHEMA)

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str, **kw) -> Histogram:
        return self.registry.histogram(name, **kw)

    def make_probe(self, index, **kw) -> RecallProbe:
        return RecallProbe(index, self.registry, **kw)

    # ---- tracing ------------------------------------------------------

    def emit(self, kind: str, **fields) -> None:
        self.tracer.emit(kind, **fields)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        return self.tracer.events(kind)

    # ---- export -------------------------------------------------------

    def snapshot(self):
        return self.registry.snapshot()

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()

    # ---- device profiler hook -----------------------------------------

    @contextmanager
    def profile(self, trace_dir: Optional[str]):
        """Run the block under ``torch.profiler`` (the card's kernels too,
        when CUDA is present) and write a Chrome trace
        ``trace_<pid>_<n>.json`` into ``trace_dir``; no ``trace_dir``
        runs the block untraced."""
        if not trace_dir:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        self._profiles += 1
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{os.getpid()}_{self._profiles}.json"))
