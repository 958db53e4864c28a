"""Sampled live-recall probe (a copy of ``repro/obs/probe.py``).

A configurable fraction of *served* query batches is shadow-executed
against the engine's ``exact()`` oracle after their tickets resolve, and
the rolling mean over the last ``WINDOW`` probes is exported as the
``live_recall`` gauge: the paper's claim that recall holds while the
index churns, as a production signal.

Sampling is seeded (deterministic per run) and decided per served
batch with one RNG draw, so the obs-off / probe-off cost is zero and
the probe-on cost is bounded by ``fraction`` exact scans.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from .metrics import MetricsRegistry


WINDOW = 64      # probes in the rolling mean
MAX_ROWS = 8     # queries probed per sampled batch
SEED = 0


class RecallProbe:
    """Shadow-execute sampled query batches against ``exact()``."""

    def __init__(self, index, registry: MetricsRegistry, *,
                 fraction: float = 0.0):
        self.index = index
        self.fraction = float(fraction)
        self._rng = np.random.default_rng(SEED)
        self._window: deque = deque(maxlen=WINDOW)
        self.gauge = registry.gauge("live_recall")
        self.gauge.set(float("nan"))
        self.samples = registry.counter("live_recall_probes")

    def maybe_probe(self, queries: np.ndarray, k: int,
                    found_ids: np.ndarray) -> Optional[float]:
        """Sample this served batch with probability ``fraction``.

        Probes at most ``MAX_ROWS`` rows of the batch (uniformly
        chosen) so probe cost is independent of batch size.  Returns
        the batch recall when probed, else ``None``.
        """
        # lazy: the core imports obs at package load
        from ..core.metrics import recall_at_k

        if self.fraction <= 0.0:
            return None
        if float(self._rng.random()) >= self.fraction:
            return None
        n = min(len(queries), len(found_ids))
        if n == 0:
            return None
        rows = (np.arange(n) if n <= MAX_ROWS else
                self._rng.choice(n, size=MAX_ROWS, replace=False))
        true = self.index.exact(np.asarray(queries)[rows], k)
        true_ids = getattr(true, "ids", true)
        r = recall_at_k(np.asarray(found_ids)[rows], true_ids)
        self._window.append(r)
        self.samples.inc()
        self.gauge.set(float(np.mean(self._window)))
        return r

    @property
    def rolling_recall(self) -> float:
        return float(np.mean(self._window)) if self._window else float("nan")
