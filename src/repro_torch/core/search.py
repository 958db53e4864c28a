"""Two-phase k-NN search over the UBIS index (paper II-A, IV-B2).

Phase 1 scores every *visible* centroid (allocated, not DELETED, weight
<= snapshot version) and keeps the top ``nprobe`` (``centroid_topk``).
Phase 2 scans the probed posting tiles (``posting_scan_topk``; with
``use_pq`` the ADC scan ``pq_scan_topk`` of their codes and the exact
rerank ``rerank_topk`` of its best ``rerank_k``) *and the vector cache*
(``centroid_topk`` over the cache), then merges a global top-k with the
stable top-k, so ties keep the reference's order.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from ..kernels.ref import BIG, stable_topk
from ..obs import span
from ..quant import pq
from . import version_manager as vm
from .types import IndexState, UBISConfig


def search(state: IndexState, cfg: UBISConfig, queries: torch.Tensor,
           k: int, nprobe: Optional[int] = None):
    """Returns (ids (Q, k) int32, scores (Q, k) f32, probe (Q, P) int32).

    Scores follow the kernel convention ``||v||^2 - 2 q.v``; add
    ``||q||^2`` for true squared distances.  ``probe`` feeds SPFresh's
    search-triggered merge rule."""
    if nprobe is None:
        nprobe = cfg.nprobe
    queries = queries.to(torch.float32)
    with span("ubis.search.phase1"):
        vis = vm.visible(state.rec_meta, state.allocated,
                         state.global_version)
        _, probe = ops.centroid_topk(queries, state.centroids, vis, k=nprobe)

    with span("ubis.search.phase2"):
        if cfg.use_pq:
            pscores, pids = _pq_stage(state, cfg, queries, probe, vis, k)
        else:
            C = state.vectors.shape[1]
            kf = min(k, probe.shape[1] * C)
            pscores, cand = ops.posting_scan_topk(
                queries, state.vectors, state.slot_valid, vis, probe, k=kf)
            pids = state.ids.reshape(-1)[cand.to(torch.int64)]

    with span("ubis.search.cache"):
        kc = min(k, cfg.cache_capacity)
        cscores, cpos = ops.centroid_topk(queries, state.cache_vecs,
                                          state.cache_valid, k=kc)
        cids = state.cache_ids[cpos.to(torch.int64)]

    # final merge over the two already-selected lists (kf + kc entries);
    # both keep the position-major tie order of a one-shot top-k
    with span("ubis.search.merge"):
        all_scores = torch.cat([pscores, cscores], dim=1)
        all_ids = torch.cat([pids, cids], dim=1)
        scores, idx = stable_topk(all_scores, k)
        found = torch.gather(all_ids, 1, idx)
        found = torch.where(scores < BIG / 2, found, -1)
    return found, scores, probe


def _pq_stage(state: IndexState, cfg: UBISConfig, queries: torch.Tensor,
              probe: torch.Tensor, vis: torch.Tensor, k: int):
    """ADC scan + exact rerank.  Returns (scores (Q, kk), ids (Q, kk)) of
    the reranked float candidates, kk = min(k, R), R = min(rerank_k,
    P*C); ids are -1 where the score is BIG (fewer real candidates)."""
    C = state.vectors.shape[1]
    R = min(cfg.rerank_k, probe.shape[1] * C)
    luts = pq.lookup_tables(state.pq_codebooks, queries)   # (Q, V, m, ksub)
    adc, cand = ops.pq_scan_topk(luts, state.codes, state.pq_posting_slot,
                                 state.slot_valid, vis, probe, k=R)
    exact, cand_sel = ops.rerank_topk(queries, state.vectors,
                                      state.tier_spilled, cand, adc,
                                      k=min(k, R))
    ids = state.ids.reshape(-1)[cand_sel.to(torch.int64)]
    return exact, torch.where(exact < BIG / 2, ids, -1)


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
