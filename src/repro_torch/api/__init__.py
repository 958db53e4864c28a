"""The port's front door: ``make_index`` and the result types.

The registry imports the driver, which imports the result types from
here, so ``make_index`` loads lazily (as in the JAX package's ``api``).
"""
from .types import (SearchRequest, SearchResult, Ticket, TickReport,
                    UpdateResult)

__all__ = ["ENGINES", "make_index", "SearchRequest", "SearchResult",
           "Ticket", "TickReport", "UpdateResult"]


def __getattr__(name):
    if name in ("make_index", "ENGINES"):
        from . import registry
        return getattr(registry, name)
    raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
