"""Two-phase k-NN search over the UBIS index (paper II-A, IV-B2).

Phase 1 scores every *visible* centroid (allocated, not DELETED, weight
<= snapshot version) and keeps the top ``nprobe`` (``centroid_topk``).
Phase 2 scans the probed posting tiles (``posting_scan_topk``) *and the
vector cache* (``centroid_topk`` over the cache), then merges a global
top-k with the stable top-k, so ties keep the reference's order.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from ..kernels.ref import BIG, stable_topk
from . import version_manager as vm
from .types import IndexState, UBISConfig, require_float_plane


def search(state: IndexState, cfg: UBISConfig, queries: torch.Tensor,
           k: int, nprobe: Optional[int] = None):
    """Returns (ids (Q, k) int32, scores (Q, k) f32, probe (Q, P) int32).

    Scores follow the kernel convention ``||v||^2 - 2 q.v``; add
    ``||q||^2`` for true squared distances.  ``probe`` feeds SPFresh's
    search-triggered merge rule."""
    require_float_plane(cfg)
    if nprobe is None:
        nprobe = cfg.nprobe
    queries = queries.to(torch.float32)
    vis = vm.visible(state.rec_meta, state.allocated, state.global_version)
    _, probe = ops.centroid_topk(queries, state.centroids, vis, k=nprobe)

    C = state.vectors.shape[1]
    kf = min(k, probe.shape[1] * C)
    pscores, cand = ops.posting_scan_topk(
        queries, state.vectors, state.slot_valid, vis, probe, k=kf)
    pids = state.ids.reshape(-1)[cand.to(torch.int64)]

    kc = min(k, cfg.cache_capacity)
    cscores, cpos = ops.centroid_topk(queries, state.cache_vecs,
                                      state.cache_valid, k=kc)
    cids = state.cache_ids[cpos.to(torch.int64)]

    # final merge over the two already-selected lists (kf + kc entries);
    # both keep the position-major tie order of a one-shot top-k
    all_scores = torch.cat([pscores, cscores], dim=1)
    all_ids = torch.cat([pids, cids], dim=1)
    scores, idx = stable_topk(all_scores, k)
    found = torch.gather(all_ids, 1, idx)
    found = torch.where(scores < BIG / 2, found, -1)
    return found, scores, probe


def brute_force(state: IndexState, cfg: UBISConfig, queries: torch.Tensor,
                k: int):
    """Exact top-k over the index's live contents (ground truth for
    recall): every posting slot and the cache, fully masked.  Returns
    (ids (Q, k) int32, scores (Q, k))."""
    M, C, d = state.vectors.shape
    queries = queries.to(torch.float32)
    vis = vm.visible(state.rec_meta, state.allocated, state.global_version)
    valid = state.slot_valid & (vis & ~state.tier_spilled)[:, None]
    s = ops.posting_scan(queries, state.vectors, valid)        # (Q, M*C)
    cs = ops.centroid_score(queries, state.cache_vecs, state.cache_valid)
    all_scores = torch.cat([s, cs], dim=1)
    del s, cs
    flat = torch.cat([state.ids.reshape(-1), state.cache_ids])
    top, idx = stable_topk(all_scores, k)
    found = flat[idx]
    return torch.where(top < BIG / 2, found, -1), top
