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


def throughput_from_stats(stats) -> dict:
    """TPS/QPS derived from a driver's counter mapping (updates over
    insert + delete + background wall time)."""
    upd = stats["insert_time"] + stats["delete_time"] + stats["bg_time"]
    tps = (stats["inserted"] + stats["deleted"]) / upd if upd else 0.0
    qps = (stats["queries"] / stats["search_time"]
           if stats["search_time"] else 0.0)
    return {"tps": tps, "qps": qps, **dict(stats)}
