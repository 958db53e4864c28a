"""Result types of the streaming-index contract (the port's subset)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SearchResult:
    """One search batch.  ``ids`` is (Q, k) int32 with -1 where fewer
    than k hits exist; ``scores`` follows ``||v||^2 - 2 q.v`` (add
    ``||q||^2`` for true squared distances)."""

    ids: np.ndarray
    scores: np.ndarray
    seconds: float = 0.0


@dataclasses.dataclass
class UpdateResult:
    """Outcome of one insert() or delete() call (counts over the batch).
    insert fills accepted/cached/rejected; delete fills deleted/blocked."""

    accepted: int = 0
    cached: int = 0
    rejected: int = 0
    deleted: int = 0
    blocked: int = 0
    seconds: float = 0.0

    @property
    def applied(self) -> int:
        return self.accepted + self.cached + self.deleted


@dataclasses.dataclass
class TickReport:
    """Outcome of one background tick; stages an engine lacks stay 0."""

    executed: int = 0
    drained: int = 0
    marked: int = 0
    migrated: int = 0
    gc: int = 0
    pq_retrained: int = 0
    spilled: int = 0
    promoted: int = 0
    seconds: float = 0.0
