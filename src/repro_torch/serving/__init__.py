"""Async serving over the ``StreamingIndex`` contract.

    from repro_torch.serving import ServingConfig, ServingEngine

    engine = ServingEngine(make_index("ubis", cfg, seeds))
    t = engine.submit_search(q, k=10)        # returns a Ticket now
    engine.submit_insert(vecs, ids)
    ...
    res = t.result()                         # pumps until resolved

Continuous batching (fill-or-deadline, separate search/insert lanes),
dispatch/collect overlap of searches with updates and background ticks,
and engine-owned tick cadence: see ``engine.py``.  ``QueuedIndex``
re-presents the batch API through the queue.
"""
from .engine import ServingConfig, ServingEngine  # noqa: F401
from .queued import QueuedIndex                   # noqa: F401

__all__ = ["ServingConfig", "ServingEngine", "QueuedIndex"]
