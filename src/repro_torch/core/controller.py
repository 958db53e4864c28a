"""High-Concurrency Controller (paper IV-B2): entry-point shim.

New code goes through the engine-agnostic front door,
``repro_torch.api.make_index`` (the ``StreamingIndex`` protocol), which
covers every engine, not only the UBIS driver re-exported here.

The controller is split across two layers:
  * data plane (the rounds; the three status branches, conflict-free
    scatters, the vector cache):     ``core/update.py``
  * control plane (job queues, the two-phase SPLITTING/MERGING window,
    cache drains, GC scheduling):    ``core/driver.py``
This module re-exports the public pieces under the paper's name.
"""
from .update import (batched_append, cache_append, cache_take,
                     delete_round, insert_round, mark_status)
from .driver import UBISDriver

__all__ = ["batched_append", "cache_append", "cache_take", "delete_round",
           "insert_round", "mark_status", "UBISDriver"]
