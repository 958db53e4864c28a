"""``QueuedIndex``: the batch API re-expressed through the queue.

An adapter that presents the ``StreamingIndex`` surface while routing
every insert/delete/search through a :class:`ServingEngine` — submit,
drain, return the resolved ticket values.  Draining after every op
keeps per-op results exact (no cross-ticket folding), so the adapter is
behaviorally identical to the wrapped engine: the queue adds scheduling,
not semantics.  Counterpart of ``repro/serving/queued.py``.

Searches are submitted ONE ROW PER REQUEST, so a (Q, d) batch genuinely
exercises the fold-into-padded-batch path rather than bypassing it.
Everything not reimplemented here (snapshot, exact, stats, ...)
delegates to the wrapped index.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from ..api.types import SearchResult
from .engine import ServingConfig, ServingEngine


class QueuedIndex:
    """StreamingIndex adapter over a ``ServingEngine`` queue."""

    def __init__(self, index, config: Optional[ServingConfig] = None, *,
                 clock: Callable[[], float] = time.perf_counter):
        # tick_every=0 by default: the caller (harness/driver of this
        # adapter) owns background cadence, exactly like a bare engine
        self.engine = ServingEngine(
            index,
            config if config is not None else ServingConfig(tick_every=0),
            clock=clock)
        self.index = index

    def insert(self, vecs, ids):
        t = self.engine.submit_insert(vecs, ids)
        self.engine.drain()
        return t.result()

    def delete(self, ids):
        t = self.engine.submit_delete(ids)
        self.engine.drain()
        return t.result()

    def search(self, queries, k: int) -> SearchResult:
        qs = np.atleast_2d(np.asarray(queries, np.float32))
        tickets = [self.engine.submit_search(q, k) for q in qs]
        self.engine.drain()
        rows = [t.result() for t in tickets]
        return SearchResult(
            ids=np.concatenate([r.ids for r in rows]),
            scores=np.concatenate([r.scores for r in rows]))

    def tick(self):
        return self.engine.tick()

    def flush(self, max_ticks: int = 200) -> int:
        self.engine.drain()
        return self.index.flush(max_ticks)

    def __getattr__(self, name):
        return getattr(self.index, name)
