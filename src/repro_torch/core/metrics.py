"""Evaluation metrics (paper Section V-A)."""
from __future__ import annotations

import numpy as np

from .types import STATUS_DELETED


def recall_at_k(found_ids, true_ids) -> float:
    """Mean |found ∩ truth| / |truth| over the query batch (recall k@k).
    -1 entries (padding / missing) never count as hits."""
    found_ids = np.asarray(found_ids)
    true_ids = np.asarray(true_ids)
    hits = 0
    total = 0
    for f, t in zip(found_ids, true_ids):
        t = set(int(x) for x in t if x >= 0)
        if not t:
            continue
        f = set(int(x) for x in f if x >= 0)
        hits += len(f & t)
        total += len(t)
    return hits / total if total else 1.0


def live_posting_lengths(state) -> np.ndarray:
    """Live lengths of visible postings (posting-CDF statistics)."""
    status = (state.rec_meta & 3).cpu().numpy()
    alive = state.allocated.cpu().numpy() & (status != STATUS_DELETED)
    lens = state.lengths.cpu().numpy()[alive]
    return lens[lens > 0]


def live_vectors(state) -> np.ndarray:
    """Live vectors per posting of ``state`` (0 where the posting is free
    or retired), read on the state's device."""
    status = (state.rec_meta & 3).cpu().numpy()
    alive = state.allocated.cpu().numpy() & (status != STATUS_DELETED)
    return np.where(alive, state.lengths.cpu().numpy(), 0)


def shard_live_vectors(state, n_shards: int) -> np.ndarray:
    """Live vectors per posting-pool shard (contiguous pid blocks over
    the ``model`` axis): the occupancy signal behind ``figskew`` and the
    rebalance acceptance ratio."""
    return live_vectors(state).reshape(n_shards, -1).sum(axis=1)


def occupancy_spread(occ) -> dict:
    """Spread statistics over per-shard occupancy: ``occ_ratio`` is the
    acceptance metric max/min (min clamped to 1 so an empty shard reads
    as a huge, not infinite, ratio); ``occ_spread`` = max/mean is the
    bounded form."""
    occ = np.asarray(occ, float)
    mx, mn, mean = occ.max(), occ.min(), occ.mean()
    return {"occ_min": int(mn), "occ_max": int(mx),
            "occ_ratio": float(mx / max(mn, 1.0)),
            "occ_spread": float(mx / max(mean, 1.0))}


def throughput_from_stats(stats) -> dict:
    """TPS/QPS derived from a driver's counter mapping (updates over
    insert + delete + background wall time)."""
    upd = stats["insert_time"] + stats["delete_time"] + stats["bg_time"]
    tps = (stats["inserted"] + stats["deleted"]) / upd if upd else 0.0
    qps = (stats["queries"] / stats["search_time"]
           if stats["search_time"] else 0.0)
    return {"tps": tps, "qps": qps, **dict(stats)}
