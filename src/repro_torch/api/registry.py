"""Engine registry: ``make_index(engine, cfg, seed_vectors, **kw)``.

One constructor for every engine of the paper's comparison.  All
engines take the same ``UBISConfig`` (the registry rewrites ``mode``
and, for the graph baseline, translates to a ``GraphConfig``), and
keyword arguments unknown to an engine are dropped, so one kwargs dict
drives a whole engine-comparison loop:

    for spec in list_engines():
        idx = make_index(spec.name, cfg, seed, seed_ids=ids0,
                         round_size=512, bg_ops_per_round=8)
        ...same insert/delete/search/tick/flush loop...

Each entry is an :class:`EngineSpec`: name, constructor, allowed kwargs and
the capability flags (``supports_tier`` / ``supports_pq`` /
``supports_shards`` / ``updatable`` and the contract harness's ``audit``
tier), the same as the JAX package's entries.  Each engine's kwargs are
the JAX package's plus the port's own: ``device`` (the card unless
``device="cpu"``), and where a ``UBISDriver`` is built, its injectable
random draws ``kmeans_init``, ``pq_init`` and ``pq_keys``.

``seed_vectors`` follow each engine's construction story: the cluster
engines (ubis/spfresh) use them for k-means seeding only (NOT inserted);
the build-once engines (spann, freshdiskann) ingest them under
``seed_ids`` (default ``arange``).  ``ubis-sharded`` takes a ``mesh``
(``distributed.sharding.make_mesh``: S shards on one device or one a
card), by default ``distributed.default_mesh`` (one shard on each card
of the process, the JAX rule); ``ubis-cluster`` runs
``ShardedUBISDriver`` workers behind the command protocol (``workers``,
``backend="local" | "multiprocess"``, ``mesh_shape``: each worker's
shards, over its cards when it sees several), its draws one per worker
when ``workers > 1`` (``cluster/coordinator.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

from ..core.types import UBISConfig
from .types import StreamingIndex

_PORT_KW = frozenset({"device", "kmeans_init", "pq_init", "pq_keys"})
_DRIVER_KW = frozenset({
    "seed", "round_size", "bg_ops_per_round", "drain_per_tick",
    "insert_retries", "gc_lag", "reassign_after_split",
    "pq_retrain_every", "tier_moves_per_tick", "tier_rerank_host",
    "tier_async", "obs", "obs_profile_dir"}) | _PORT_KW
_UBIS_KW = _DRIVER_KW | {"fused_tick"}
_SHARDED_KW = _DRIVER_KW | {"mesh", "shard_cache_scan", "rebalance",
                            "rebalance_watermark", "rebalance_ratio",
                            "migrate_per_tick", "route_alpha"}
_CLUSTER_KW = frozenset({
    "seed", "round_size", "bg_ops_per_round", "drain_per_tick",
    "insert_retries", "gc_lag", "reassign_after_split",
    "pq_retrain_every", "tier_moves_per_tick", "tier_rerank_host",
    "obs", "shard_cache_scan", "rebalance", "rebalance_watermark",
    "rebalance_ratio", "migrate_per_tick", "route_alpha", "workers",
    "backend", "worker_devices", "mesh_shape", "spread_ratio",
    "spread_per_tick", "rpc_timeout"}) | _PORT_KW
_SPANN_KW = frozenset({"seed", "round_size", "obs"}) | _PORT_KW
_GRAPH_KW = frozenset({"max_nodes", "degree", "beam", "alpha",
                       "consolidate_every", "obs", "device"})
#: engines of the JAX package's registry whose slice is not ported yet
NOT_PORTED = ()


def _pick(kw: dict, allowed: frozenset) -> dict:
    return {k: v for k, v in kw.items() if k in allowed}


def _with_mode(cfg: UBISConfig, mode: str) -> UBISConfig:
    return cfg if cfg.mode == mode else dataclasses.replace(cfg, mode=mode)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One registry entry: how to build an engine + what it supports.

    ``audit`` is the contract-harness audit tier (``state`` = full
    IndexState multiset equality, ``count`` = live-count + no
    resurrection, ``static`` = every update refused); ``build`` is the
    lazily-importing constructor (same signature for every engine).
    """

    name: str
    description: str
    build: Callable[..., StreamingIndex]
    kwargs: frozenset
    supports_tier: bool = False
    supports_pq: bool = False
    supports_shards: bool = False
    updatable: bool = True
    audit: str = "state"

    def make(self, cfg: UBISConfig, seed_vectors, *, seed_ids=None,
             **kw) -> StreamingIndex:
        return self.build(cfg, seed_vectors, seed_ids, _pick(kw, self.kwargs))


def _build_ubis_mode(mode):
    def build(cfg, seed_vectors, seed_ids, kw):
        from ..core.driver import UBISDriver
        return UBISDriver(_with_mode(cfg, mode), seed_vectors, **kw)
    return build


def _build_sharded(cfg, seed_vectors, seed_ids, kw):
    from .sharded_driver import ShardedUBISDriver
    return ShardedUBISDriver(_with_mode(cfg, "ubis"), seed_vectors, **kw)


def _build_cluster(cfg, seed_vectors, seed_ids, kw):
    from ..cluster.coordinator import ClusterCoordinator
    return ClusterCoordinator(_with_mode(cfg, "ubis"), seed_vectors, **kw)


def _seed_arrays(seed_vectors, seed_ids):
    seeds = np.asarray(seed_vectors, np.float32)
    ids = (np.arange(len(seeds)) if seed_ids is None
           else np.asarray(seed_ids, np.int64))
    return seeds, ids


def _build_spann(cfg, seed_vectors, seed_ids, kw):
    from ..core.spann import SPANNStatic
    seeds, ids = _seed_arrays(seed_vectors, seed_ids)
    return SPANNStatic(_with_mode(cfg, "ubis"), seeds, ids, **kw)


def _build_freshdiskann(cfg, seed_vectors, seed_ids, kw):
    from ..core.freshdiskann import FreshDiskANN, GraphConfig
    seeds, ids = _seed_arrays(seed_vectors, seed_ids)
    kw = dict(kw)
    obs = kw.pop("obs", None)
    device = kw.pop("device", None)
    kw.setdefault("max_nodes", 1 << 17)
    gcfg = GraphConfig(dim=cfg.dim, **kw)
    return FreshDiskANN(gcfg, seeds, ids, obs=obs, device=device)


_REGISTRY: dict[str, EngineSpec] = {spec.name: spec for spec in (
    EngineSpec(
        name="ubis",
        description="the paper's balanced updatable cluster index "
                    "(UBISDriver)",
        build=_build_ubis_mode("ubis"), kwargs=_UBIS_KW,
        supports_tier=True, supports_pq=True, audit="state"),
    EngineSpec(
        name="spfresh",
        description="UBISDriver in the SPFresh lock/strict-trigger mode",
        build=_build_ubis_mode("spfresh"), kwargs=_UBIS_KW,
        supports_tier=True, supports_pq=True, audit="state"),
    EngineSpec(
        name="spann",
        description="build-once SPANN snapshot (updates refused as "
                    "rejected/blocked counts)",
        build=_build_spann, kwargs=_SPANN_KW,
        updatable=False, audit="static"),
    EngineSpec(
        name="freshdiskann",
        description="FreshDiskANN Vamana graph baseline",
        build=_build_freshdiskann, kwargs=_GRAPH_KW, audit="count"),
    EngineSpec(
        name="ubis-sharded",
        description="ShardedUBISDriver: host orchestration over the "
                    "sharded programs (one model shard a card by "
                    "default, or S shards of one device)",
        build=_build_sharded, kwargs=_SHARDED_KW,
        supports_tier=True, supports_pq=True, supports_shards=True,
        audit="state"),
    EngineSpec(
        name="ubis-cluster",
        description="coordinator/worker cluster plane: all planners on "
                    "the coordinator, ShardedUBISDriver workers behind "
                    "the serializable command protocol",
        build=_build_cluster, kwargs=_CLUSTER_KW,
        supports_tier=True, supports_pq=True, supports_shards=True,
        audit="state"),
)}

ENGINES = tuple(_REGISTRY)


def list_engines() -> Tuple[EngineSpec, ...]:
    """Every registered engine's spec, registration order."""
    return tuple(_REGISTRY.values())


def engine_spec(engine: str) -> EngineSpec:
    """The :class:`EngineSpec` for one engine name."""
    if engine in NOT_PORTED:
        raise ValueError(f"engine {engine!r} is not ported yet; choose "
                         f"from {ENGINES}")
    if engine not in _REGISTRY:
        raise ValueError(f"unknown engine {engine!r}; choose from "
                         f"{ENGINES}")
    return _REGISTRY[engine]


def make_index(engine: str, cfg: UBISConfig, seed_vectors, *,
               seed_ids=None, **kw) -> StreamingIndex:
    """Build any engine behind the ``StreamingIndex`` front door."""
    return engine_spec(engine).make(cfg, seed_vectors, seed_ids=seed_ids,
                                    **kw)
