"""Data pipeline: deterministic, cursor-resumable synthetic streams
(numpy only; the port's own copy of ``repro/data``)."""
from .tokens import TokenStream
from .vectors import DriftingVectorStream, StaticVectorSet, make_queries

__all__ = ["TokenStream", "DriftingVectorStream", "StaticVectorSet",
           "make_queries"]
