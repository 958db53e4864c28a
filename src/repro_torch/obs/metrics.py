"""Metrics registry: counters, gauges, log-bucket latency histograms.

A copy of the JAX package's ``repro/obs/metrics.py`` (pure Python; the
port keeps its own).  One registry per ``Obs`` plane: the drivers'
``stats`` maps (seeded from :data:`DRIVER_STAT_SCHEMA`, so every engine
has the same key set) and the serving engine's request-span histograms
ride one Prometheus text exposition (:meth:`MetricsRegistry.to_prometheus`,
parsed back by :func:`parse_exposition`) and one JSON-able snapshot.

Histograms use geometric buckets (growth ``2 ** 0.25``): a quantile is
the bucket's geometric midpoint clamped to the observed [min, max], so
its relative error is under about 9%.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_left
from collections.abc import MutableMapping
from typing import Dict, Iterable, List, Tuple

# ---------------------------------------------------------------------------
# the shared driver-stats schema
# ---------------------------------------------------------------------------

#: Every engine initializes ``stats`` with exactly these keys.  Keys an
#: engine never updates stay 0.0 (e.g. ``migrated`` on the single-device
#: driver): present, not missing.
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

#: stats keys that are levels, not monotone counts (typed gauge in the
#: exposition)
GAUGE_STAT_KEYS = frozenset({"tier_resident", "pq_generation"})


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


class Counter:
    """Monotone float counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-value gauge."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Geometric-bucket histogram with streaming quantile extraction.

    ``record`` is one bisect into the precomputed edge table; quantiles
    walk the cumulative counts and return the bucket's geometric
    midpoint clamped to the exact observed [min, max].
    """

    __slots__ = ("name", "_edges", "_counts", "count", "sum",
                 "_min", "_max")

    def __init__(self, name: str = "", *, lo: float = 1e-6,
                 hi: float = 3600.0, growth: float = 2 ** 0.25):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.name = name
        edges = [lo]
        while edges[-1] < hi:
            edges.append(edges[-1] * growth)
        self._edges = edges
        self._counts = [0] * (len(edges) + 1)   # +1 overflow bucket
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        self._counts[bisect_left(self._edges, v)] += 1
        self.count += 1
        self.sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (relative error bounded by the bucket
        growth factor, exact when all samples share one bucket)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            if cum >= target and c:
                if i >= len(self._edges):          # overflow bucket
                    est = self._max
                elif i == 0:
                    est = self._edges[0] / 2.0
                else:
                    est = math.sqrt(self._edges[i - 1] * self._edges[i])
                return min(max(est, self._min), self._max)
        return self._max

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def buckets(self) -> Iterable[Tuple[float, int]]:
        """(upper_edge, cumulative_count) pairs, only non-empty prefixes
        trimmed — the Prometheus ``le`` series."""
        cum = 0
        for edge, c in zip(self._edges, self._counts):
            cum += c
            if c:
                yield edge, cum


class StatsMap(MutableMapping):
    """A driver's ``stats``: missing reads return 0.0, the key set starts
    from the schema (the same for every engine), and the map is
    registered with its :class:`MetricsRegistry`, so every key rides
    the exposition."""

    __slots__ = ("prefix", "_d")

    def __init__(self, prefix: str, schema: Iterable[str]):
        self.prefix = prefix
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
        return f"StatsMap({self.prefix!r}, {self._d!r})"


class MetricsRegistry:
    """Names -> metric instances, plus registered stats maps.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent,
    so layers can look metrics up by name without coordination).
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._maps: List[StatsMap] = []

    # ---- construction -------------------------------------------------

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def stats_map(self, prefix: str,
                  schema: Iterable[str] = DRIVER_STAT_SCHEMA) -> StatsMap:
        """A schema-seeded stats facade exported under ``prefix``."""
        for m in self._maps:
            if m.prefix == prefix:
                return m
        m = StatsMap(prefix, schema)
        self._maps.append(m)
        return m

    # ---- export -------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view of every metric (histograms as summaries)."""
        out: Dict[str, object] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value
        for sm in self._maps:
            for k in sorted(sm):
                out[f"{sm.prefix}_{k}"] = sm[k]
        return out

    def snapshot_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4 subset)."""
        lines: List[str] = []
        for sm in self._maps:
            for k in sorted(sm):
                name = _sanitize(f"{sm.prefix}_{k}")
                typ = "gauge" if k in GAUGE_STAT_KEYS else "counter"
                lines.append(f"# TYPE {name} {typ}")
                lines.append(f"{name} {sm[k]:g}")
        for name, m in sorted(self._metrics.items()):
            pname = _sanitize(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value:g}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                for edge, cum in m.buckets():
                    lines.append(
                        f'{pname}_bucket{{le="{edge:.6g}"}} {cum}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {m.sum:g}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> Dict[str, float]:
    """Parse a Prometheus text exposition back to {series_name: value}.

    Labels are folded into the series key (``name{le="0.1"}``), which is
    all the smoke checks need.  Raises ``ValueError`` on malformed
    lines, so "the exposition parses" is a real assertion.
    """
    out: Dict[str, float] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            if ln.startswith("#") and not ln.startswith(("# TYPE",
                                                         "# HELP")):
                raise ValueError(f"malformed comment line: {ln!r}")
            continue
        parts = ln.rsplit(" ", 1)
        if len(parts) != 2:
            raise ValueError(f"malformed sample line: {ln!r}")
        name, val = parts
        out[name] = float(val)      # raises on non-numeric values
    return out


def required_series(snapshot_keys: Iterable[str],
                    required: Iterable[str]) -> List[str]:
    """Names in ``required`` that no snapshot/exposition key starts
    with: empty means every required series is present."""
    keys = list(snapshot_keys)
    return [r for r in required
            if not any(k == r or k.startswith(r + "_") or
                       k.startswith(r + "{") for k in keys)]
