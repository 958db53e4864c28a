"""The streaming-index contract: the result types, the
:class:`StreamingIndex` protocol every engine presents, and the
request-first serving types that ``repro_torch.serving`` hands out."""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Mapping, Optional, Protocol,
                    runtime_checkable)

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


# ---------------------------------------------------------------------------
# request-first serving types (consumed by repro_torch.serving)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchRequest:
    """One enqueued query.  The serving engine folds requests into
    padded device batches, so a request is the unit of latency
    accounting, never of device dispatch.  ``t_submit`` is on the
    engine's (injectable) clock."""

    vector: np.ndarray
    k: int
    t_submit: float
    ticket: "Ticket"


#: Pumps ``Ticket.result`` makes before it calls the ticket lost.
MAX_PUMPS = 10_000


@dataclasses.dataclass
class Ticket:
    """Caller-side handle for one in-flight serving request.

    The serving engine resolves it when the batch carrying the request
    completes; ``latency_s`` is then resolve time - submit time on the
    engine's clock.  ``result()`` pumps the owning engine until the
    ticket resolves."""

    kind: str                        # "search" | "insert" | "delete"
    seq: int                         # engine-unique, monotone
    t_submit: float
    _value: Any = None
    _done: bool = False
    _t_done: float = 0.0
    # backref used by result() to drive the queue; None once resolved
    _pump: Optional[Callable[[], Any]] = None

    def done(self) -> bool:
        return self._done

    @property
    def latency_s(self) -> float:
        if not self._done:
            raise RuntimeError(f"ticket {self.kind}#{self.seq} unresolved")
        return self._t_done - self.t_submit

    def result(self):
        """The resolved value (a one-row ``SearchResult`` for a search,
        an ``UpdateResult`` for an update), pumping the owning engine
        until the ticket resolves."""
        pumps = 0
        while not self._done:
            if self._pump is None:
                raise RuntimeError(
                    f"ticket {self.kind}#{self.seq} unresolved and "
                    "detached from its engine")
            self._pump()
            pumps += 1
            if pumps > MAX_PUMPS:
                raise RuntimeError(
                    f"ticket {self.kind}#{self.seq} still unresolved "
                    f"after {pumps} pumps")
        return self._value

    def _resolve(self, value, t_done: float) -> None:
        self._value = value
        self._t_done = t_done
        self._done = True
        self._pump = None


@runtime_checkable
class StreamingIndex(Protocol):
    """The one front door every engine presents.

    Engines conform structurally: ``isinstance(x, StreamingIndex)``
    checks method presence at runtime.  ``stats`` is a mapping of
    monotone counters (the shared schema of ``obs.metrics``).
    ``snapshot()`` returns a state a single device can use again
    (``load_snapshot`` on a fresh engine of the same kind).
    """

    def insert(self, vecs, ids) -> UpdateResult: ...

    def delete(self, ids) -> UpdateResult: ...

    def search(self, queries, k: int) -> SearchResult: ...

    def tick(self) -> TickReport: ...

    def flush(self, max_ticks: int = 200) -> int: ...

    def snapshot(self) -> Any: ...

    def memory_bytes(self) -> int: ...

    def memory_tiers(self) -> Mapping: ...

    def exact(self, queries, k: int) -> SearchResult: ...

    def posting_lengths(self) -> np.ndarray: ...

    def live_count(self) -> int: ...

    @property
    def stats(self) -> Mapping: ...
