"""Engine registry: ``make_index(engine, cfg, seed_vectors, **kw)``.

This slice of the port knows the two single-device cluster engines,
``ubis`` and ``spfresh``; every other engine name of the JAX package's
registry (spann, freshdiskann, ubis-sharded, ubis-cluster) raises until
its slice is ported.  Keyword arguments unknown to an engine are
dropped, so one kwargs dict can drive an engine-comparison loop; the
JAX driver's knobs are all known, and the two values the port does not
implement (``tier_rerank_host=False``, an ``obs_profile_dir``) raise.
The index runs on the card unless ``device="cpu"`` is passed; ``obs=`` hands
the driver an observability plane to share (the serving layer's), so
one exposition covers the driver and the request spans.
"""
from __future__ import annotations

import dataclasses

from ..core.driver import UBISDriver
from ..core.types import UBISConfig

ENGINES = ("ubis", "spfresh")
_UBIS_KW = frozenset({
    "seed", "round_size", "bg_ops_per_round", "drain_per_tick",
    "insert_retries", "gc_lag", "reassign_after_split", "fused_tick",
    "device", "kmeans_init", "pq_retrain_every", "pq_init", "pq_keys",
    "tier_moves_per_tick", "tier_rerank_host", "tier_async", "obs",
    "obs_profile_dir"})


def make_index(engine: str, cfg: UBISConfig, seed_vectors, **kw):
    """Build a ``ubis`` or ``spfresh`` index (``seed_vectors`` seed the
    k-means centroids; they are not inserted)."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} is not ported; choose from "
                         f"{ENGINES}")
    if cfg.mode != engine:
        cfg = dataclasses.replace(cfg, mode=engine)
    return UBISDriver(cfg, seed_vectors,
                      **{k: v for k, v in kw.items() if k in _UBIS_KW})
