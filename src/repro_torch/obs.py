"""Observability for the port's drivers: the shared stats schema, counters
and a bounded trace-event log.

The key set of a driver's ``stats`` is the JAX package's
``DRIVER_STAT_SCHEMA`` (kept here as a copy, so the port never imports
the JAX package).  The ``kernel_fallback`` and ``kernel_fallback_traces``
counters exist and read 0: on the card every kernel launches or raises,
and nothing falls back.  The Prometheus exposition and the profiler hook
of the JAX package's ``obs/`` are not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from collections.abc import MutableMapping
from typing import Dict, Iterable, List, Optional, Tuple

#: Every engine's ``stats`` starts with exactly these keys (0.0).
DRIVER_STAT_SCHEMA: Tuple[str, ...] = (
    # foreground counts
    "inserted", "deleted", "rejected", "blocked", "queries",
    # wall-time accumulators (feed throughput_from_stats)
    "insert_time", "delete_time", "search_time", "bg_time",
    "bg_exec_time",
    # background-plane counts
    "bg_ops", "bg_split", "bg_merge", "bg_compact", "bg_deferred",
    "bg_reassigned", "bg_gc", "drained",
    # sharded-plane counts (0 on single-device)
    "migrated", "host_cached",
    # quant plane
    "pq_retrains", "pq_generation",
    # cold-tier plane
    "tier_spilled", "tier_promoted", "tier_resident",
    # device-search introspection (piggybacked on existing transfers)
    "search_probed", "search_results", "search_spilled_hits",
    "search_adc_batches", "search_exact_batches",
)

#: Counters every ``Obs`` registers at construction.
FALLBACK_COUNTERS = ("kernel_fallback", "kernel_fallback_traces")

#: The trace keeps the newest this many events.
TRACE_CAPACITY = 4096


class Counter:
    """Monotone float counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class StatsMap(MutableMapping):
    """A driver's ``stats``: missing reads return 0.0, and the key set
    starts from the schema, so it is the same for every engine."""

    __slots__ = ("_d",)

    def __init__(self, schema: Iterable[str] = DRIVER_STAT_SCHEMA):
        self._d: Dict[str, float] = dict.fromkeys(schema, 0.0)

    def __getitem__(self, key):
        return self._d.get(key, 0.0)

    def __setitem__(self, key, value):
        self._d[key] = value

    def __delitem__(self, key):
        del self._d[key]

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __repr__(self):
        return f"StatsMap({self._d!r})"


class Obs:
    """Counters plus a bounded in-memory trace of events, each a dict
    ``{"seq", "t", "kind", **fields}`` with ``t`` from
    ``time.perf_counter``."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._events: deque = deque(maxlen=TRACE_CAPACITY)
        self._seq = 0
        for name in FALLBACK_COUNTERS:
            self.counter(name)

    def driver_stats(self) -> StatsMap:
        return StatsMap()

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def emit(self, kind: str, **fields) -> None:
        ev = {"seq": self._seq, "t": round(time.perf_counter(), 6),
              "kind": kind}
        ev.update(fields)
        self._seq += 1
        self._events.append(ev)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e["kind"] == kind]
