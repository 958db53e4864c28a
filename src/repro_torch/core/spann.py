"""SPANN static baseline (paper III-B1): build once, search only.

Table I: SPANN supports neither incremental nor streaming update, so
this wrapper refuses updates: that is its role in the comparison (a
quality ceiling for a freshly built index).  Refusals are reported
through the ``StreamingIndex`` result types (every insert job counts as
``rejected``, every delete as ``blocked``) instead of raising, so the
engine rides the same comparison loop as the updatable engines and its
staleness shows as recall decay against the stream.
"""
from __future__ import annotations

import numpy as np

from ..api.types import SearchResult, TickReport, UpdateResult
from .driver import UBISDriver
from .types import UBISConfig


class SPANNStatic:
    """Build-once cluster index (k-means seed + one bulk load); a
    ``StreamingIndex`` whose update surface always refuses.  ``device``,
    ``kmeans_init``, ``pq_init`` and ``pq_keys`` go to the inner
    ``UBISDriver``."""

    def __init__(self, cfg: UBISConfig, vectors: np.ndarray,
                 ids: np.ndarray, *, round_size: int = 1024,
                 seed: int = 0, obs=None, device=None, kmeans_init=None,
                 pq_init=None, pq_keys=None):
        # bulk-load through the same machinery, then freeze (the inner
        # driver also supplies the shared-schema stats/obs plane)
        self._drv = UBISDriver(cfg, vectors, round_size=round_size,
                               seed=seed, obs=obs, device=device,
                               kmeans_init=kmeans_init, pq_init=pq_init,
                               pq_keys=pq_keys)
        self._drv.insert(vectors, ids)
        self._drv.flush()
        self.state = self._drv.state
        self.cfg = cfg

    def search(self, queries, k: int, nprobe=None) -> SearchResult:
        return self._drv.search(queries, k, nprobe)

    def insert(self, vecs, ids, **_) -> UpdateResult:
        return UpdateResult(rejected=len(np.asarray(ids)))

    def delete(self, ids) -> UpdateResult:
        return UpdateResult(blocked=len(np.asarray(ids)))

    def tick(self) -> TickReport:
        return TickReport()

    def flush(self, max_ticks: int = 0) -> int:
        return 0

    # ---- StreamingIndex protocol surface ------------------------------

    @property
    def stats(self):
        return self._drv.stats

    @property
    def obs(self):
        return self._drv.obs

    @property
    def device(self):
        return self._drv.device

    def snapshot(self):
        return self._drv.snapshot()

    def memory_bytes(self) -> int:
        return self._drv.memory_bytes()

    def memory_tiers(self) -> dict:
        return {"device": self.memory_bytes(), "host": 0}

    def exact(self, queries, k: int) -> SearchResult:
        return self._drv.exact(queries, k)

    def posting_lengths(self) -> np.ndarray:
        return self._drv.posting_lengths()

    def live_count(self) -> int:
        return self._drv.live_count()

    def throughput(self) -> dict:
        return self._drv.throughput()
