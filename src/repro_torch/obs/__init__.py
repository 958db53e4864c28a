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
* :meth:`Obs.profile`, a ``torch.profiler`` capture of a block.

A driver builds its own ``Obs()`` unless one is injected; the serving
engine reuses its index's, so one exposition covers driver internals and
request spans.  ``Obs(enabled=False)`` keeps the stats mapping (the
drivers need it) and turns tracing and span recording into no-ops.  The
``kernel_fallback`` and ``kernel_fallback_traces`` counters exist and
read 0: on the card every kernel launches or raises, and nothing falls
back.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Callable, List, Optional

from .metrics import (DRIVER_STAT_SCHEMA, GAUGE_STAT_KEYS, Counter, Gauge,
                      Histogram, MetricsRegistry, StatsMap, parse_exposition,
                      required_series)
from .probe import RecallProbe
from .trace import Tracer

__all__ = ["Obs", "MetricsRegistry", "Tracer", "RecallProbe", "Counter",
           "Gauge", "Histogram", "StatsMap", "DRIVER_STAT_SCHEMA",
           "GAUGE_STAT_KEYS", "parse_exposition", "required_series"]

#: Counters every ``Obs`` registers at construction.
FALLBACK_COUNTERS = ("kernel_fallback", "kernel_fallback_traces")


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
        for name in FALLBACK_COUNTERS:
            self.counter(name)

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
