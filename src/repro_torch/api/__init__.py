"""One front door: the engine-agnostic streaming-index API.

    from repro_torch.api import make_index, list_engines

    idx = make_index("ubis", cfg, seed_vectors)      # any engine name
    idx.insert(vecs, ids); idx.tick()
    res = idx.search(queries, k=10)                  # SearchResult

Engines: ``ubis`` | ``spfresh`` | ``spann`` | ``freshdiskann`` |
``ubis-sharded`` | ``ubis-cluster``, all conforming to :class:`StreamingIndex`, so an engine
comparison is one loop over names.  ``list_engines()`` returns each engine's
:class:`EngineSpec` with its capability flags.

The registry imports the engine modules, which import the result types
from here, so the registry's names load lazily (as in the JAX package's
``api``).
"""
from .types import (SearchRequest, SearchResult, StreamingIndex,  # noqa: F401
                    Ticket, TickReport, UpdateResult)

__all__ = ["StreamingIndex", "SearchResult", "UpdateResult", "TickReport",
           "SearchRequest", "Ticket", "make_index", "list_engines",
           "engine_spec", "EngineSpec", "ENGINES", "ShardedUBISDriver",
           "RebalancePlanner"]


def __getattr__(name):
    if name in ("make_index", "ENGINES", "list_engines", "engine_spec",
                "EngineSpec"):
        from . import registry
        return getattr(registry, name)
    if name == "ShardedUBISDriver":
        from .sharded_driver import ShardedUBISDriver
        return ShardedUBISDriver
    if name == "RebalancePlanner":
        from .rebalance import RebalancePlanner
        return RebalancePlanner
    raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
