"""Update data path: conflict-free batched appends, insert/delete rounds.

The *high-concurrency controller* (paper IV-B2) as plain functions on
tensors.  A round processes a padded batch of jobs:

  1. resolve targets (hinted jobs chase DELETED successor pointers;
     fresh jobs locate the nearest insertable centroid);
  2. branch on Posting Recorder status — NORMAL -> direct append,
     SPLITTING/MERGING -> vector cache (UBIS) or reject (SPFresh's
     posting-lock model), DELETED dead-end -> relocate;
  3. resolve conflicts ahead of the scatter: jobs are ranked within
     their target-posting group (stable job order) and accepted while
     capacity lasts — exactly one winner per slot, no retries;
  4. one batched scatter applies all winners; losers divert to the
     cache or are rejected, never silently dropped.

The functions update ``state`` in place and return it.  Every scatter
goes through ``masked_set_``/``masked_add_``, which never index out of
bounds (the JAX package's ``mode="drop"`` sentinel has no counterpart
in PyTorch), and every gather clamps or is in range by construction.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..quant import pq
from . import version_manager as vm
from .types import (NO_ID, NO_SUCC, STATUS_DELETED, STATUS_MERGING,
                    STATUS_NORMAL, STATUS_SPLITTING, IndexState, RoundResult,
                    UBISConfig)
from .version_manager import masked_add_, masked_set_

_EMPTY_SUCC = (NO_SUCC << 16) | NO_SUCC


# ---------------------------------------------------------------------------
# small combinators
# ---------------------------------------------------------------------------

def group_ranks(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rank of each job within its equal-key group, stable job order.
    Invalid jobs get arbitrary ranks.  O(J log J)."""
    J = keys.shape[0]
    key = torch.where(valid, keys.to(torch.int64), torch.iinfo(torch.int32).max)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    idx = torch.arange(J, dtype=torch.int64, device=keys.device)
    seg_start = torch.ones((J,), dtype=torch.bool, device=keys.device)
    seg_start[1:] = ks[1:] != ks[:-1]
    seg_first = torch.cummax(torch.where(seg_start, idx, 0), dim=0).values
    ranks = torch.empty((J,), dtype=torch.int64, device=keys.device)
    ranks[order] = idx - seg_first
    return ranks


def _flat(arr: torch.Tensor) -> torch.Tensor:
    """View an (M, C, ...) tensor as (M*C, ...)."""
    return arr.view((arr.shape[0] * arr.shape[1],) + tuple(arr.shape[2:]))


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------

def alloc_postings(state: IndexState, cfg: UBISConfig, k: int,
                   centroids_new: torch.Tensor, weight) -> tuple:
    """Pop ``k`` posting slots from the free stack and initialise them.
    The caller ensures ``free_top >= k``.  Returns (state, pids int64)."""
    dev = state.device
    idx = state.free_top.to(torch.int64) - 1 - torch.arange(k, device=dev)
    pids = state.free_list[idx].to(torch.int64)
    state.ids[pids] = NO_ID
    state.slot_valid[pids] = False
    state.used[pids] = 0
    state.lengths[pids] = 0
    state.centroids[pids] = centroids_new.to(state.centroids.dtype)
    state.rec_meta[pids] = vm.pack_meta(STATUS_NORMAL,
                                        torch.as_tensor(weight, device=dev))
    state.rec_succ[pids] = _EMPTY_SUCC
    state.allocated[pids] = True
    state.free_top = state.free_top - k
    state.pq_posting_slot[pids] = state.pq_active
    state.heat[pids] = cfg.tier_promote_heat
    state.tier_spilled[pids] = False
    return state, pids


def free_postings(state: IndexState, pids: torch.Tensor,
                  valid: torch.Tensor) -> IndexState:
    """Push reclaimed posting ids back onto the free stack (GC), and
    clear every successor pointer that references one of them, so a
    chaser never follows a recycled slot into an unrelated posting."""
    pids = pids.to(torch.int64)
    rank = group_ranks(torch.zeros_like(pids), valid)
    slot = state.free_top.to(torch.int64) + rank
    masked_set_(state.free_list, slot.clamp(max=state.free_list.shape[0] - 1),
                pids.to(torch.int32), valid)
    state.free_top = state.free_top + valid.sum().to(torch.int32)
    masked_set_(state.allocated, pids, False, valid)
    masked_set_(state.rec_succ, pids, _EMPTY_SUCC, valid)
    masked_set_(state.heat, pids, 0, valid)
    masked_set_(state.tier_spilled, pids, False, valid)
    freed = masked_set_(torch.zeros_like(state.allocated), pids, True, valid)
    s1, s2 = vm.succ_ids(state.rec_succ)
    s1 = torch.where((s1 >= 0) & freed[s1.clamp(min=0)], -1, s1)
    s2 = torch.where((s2 >= 0) & freed[s2.clamp(min=0)], -1, s2)
    state.rec_succ = vm.pack_succ(torch.where(s1 < 0, NO_SUCC, s1),
                                  torch.where(s2 < 0, NO_SUCC, s2))
    return state


def rebuild_free_stack(state: IndexState) -> IndexState:
    """Recompute a canonical free stack from ``allocated``."""
    order = torch.argsort(state.allocated.to(torch.uint8), stable=True)
    state.free_list = order.to(torch.int32)
    state.free_top = (~state.allocated).sum().to(torch.int32)
    return state


def ensure_free_stack(state: IndexState) -> IndexState:
    """Rebuild the free stack and check that it is canonical before a
    gathered state is reused on one device."""
    state = rebuild_free_stack(state)
    allocated = state.allocated.cpu()
    top = int(state.free_top)
    free = state.free_list[:top].cpu().to(torch.int64)
    if top + int(allocated.sum()) != allocated.shape[0]:
        raise AssertionError("free stack disagrees with the allocated "
                             "bitmap")
    if torch.unique(free).numel() != top:
        raise AssertionError("free stack holds duplicates")
    if bool(allocated[free].any()):
        raise AssertionError("free stack aliases a live posting")
    return state


# ---------------------------------------------------------------------------
# the conflict-free batched append (shared by every write path)
# ---------------------------------------------------------------------------

def batched_append(state: IndexState, cfg: UBISConfig, vecs, ids, pids,
                   valid, update_id_loc: bool = True):
    """Append jobs to their target postings; winners are decided by
    group rank against the remaining tile capacity.  Returns
    (state, ok, flat) with ``flat = pid*C + slot`` (``max_postings*C``
    for losers, a sentinel past any pool).  The pool is the state's own,
    a shard's sub-pool included; ``update_id_loc=False`` leaves the id map
    to the caller (the sharded insert merges it across shards)."""
    C = cfg.capacity
    M = state.used.shape[0]
    pids = pids.to(torch.int64)
    ranks = group_ranks(pids, valid)
    safe_pid = pids.clamp(0, M - 1)
    slot = state.used[safe_pid].to(torch.int64) + ranks
    ok = valid & (pids >= 0) & (slot < C)
    flat = safe_pid * C + slot
    masked_set_(_flat(state.vectors), flat, vecs.to(state.vectors.dtype), ok)
    masked_set_(_flat(state.ids), flat, ids.to(torch.int32), ok)
    masked_set_(_flat(state.slot_valid), flat, True, ok)
    masked_add_(state.used, pids, 1, ok)
    masked_add_(state.lengths, pids, 1, ok)
    if update_id_loc:
        masked_set_(state.id_loc,
                    ids.to(torch.int64).clamp(0, cfg.max_ids - 1),
                    flat.to(torch.int32), ok)
    if cfg.use_pq:
        # every float write carries its code, encoded under the TARGET
        # posting's codebook slot (encoded under all V slots, selected
        # per job), from the value as stored
        J = pids.shape[0]
        x = vecs.to(state.vectors.dtype).float()
        codes_all = pq.encode_all_versions(state.pq_codebooks, x)  # (V,J,m)
        tslot = state.pq_posting_slot[safe_pid].long().clamp(
            0, cfg.pq_versions - 1)
        code_j = codes_all[tslot, torch.arange(J, device=x.device)]  # (J,m)
        m = code_j.shape[1]
        cidx = ((safe_pid[:, None] * m + torch.arange(m, device=x.device))
                * C + slot.clamp(max=C - 1)[:, None])              # (J, m)
        masked_set_(state.codes.view(-1), cidx.reshape(-1),
                    code_j.reshape(-1), ok.repeat_interleave(m))
    return state, ok, torch.where(ok, flat, cfg.max_postings * C)


def cache_append(state: IndexState, cfg: UBISConfig, vecs, ids, targets,
                 want):
    """Park jobs in the vector cache (paper IV-B2 branch 3).
    id_loc encoding for cached vectors: ``-2 - cache_slot``."""
    K = cfg.cache_capacity
    ranks = group_ranks(torch.zeros_like(targets, dtype=torch.int64), want)
    slot_order = torch.argsort(state.cache_valid.to(torch.uint8), stable=True)
    nfree = (~state.cache_valid).sum()
    ok = want & (ranks < nfree)
    slot = slot_order[ranks.clamp(0, K - 1)]
    masked_set_(state.cache_vecs, slot, vecs.to(state.cache_vecs.dtype), ok)
    masked_set_(state.cache_ids, slot, ids.to(torch.int32), ok)
    masked_set_(state.cache_target, slot, targets.to(torch.int32), ok)
    masked_set_(state.cache_valid, slot, True, ok)
    masked_set_(state.id_loc, ids.to(torch.int64).clamp(0, cfg.max_ids - 1),
                (-2 - slot).to(torch.int32), ok)
    return state, ok


def cache_take(state: IndexState, cfg: UBISConfig, n: int):
    """Pop up to ``n`` cached vectors for re-insertion (background drain).
    Returns (state, vecs, ids, targets, taken)."""
    prio = torch.argsort((~state.cache_valid).to(torch.uint8), stable=True)
    slots = prio[:n]
    taken = state.cache_valid[slots]
    vecs = state.cache_vecs[slots]
    ids = state.cache_ids[slots]
    targets = state.cache_target[slots]
    masked_set_(state.cache_valid, slots, False, taken)
    return state, vecs, ids, targets, taken


# ---------------------------------------------------------------------------
# foreground rounds
# ---------------------------------------------------------------------------

def insert_round(state: IndexState, cfg: UBISConfig, vecs, ids, valid,
                 hints):
    """One foreground insert round over a padded job batch.

    hints: (J,) int32 precomputed target posting (-1 = locate fresh);
    used by cache drains (the path that exercises the paper's
    DELETED-branch pointer chasing).  Returns (state, RoundResult,
    touched (M,) bool)."""
    M = state.used.shape[0]
    status = vm.unpack_status(state.rec_meta)
    insertable = (state.allocated & (status != STATUS_DELETED)
                  & ~state.tier_spilled)

    has_hint = hints >= 0
    chased, dead_end = vm.chase_successors(
        state.rec_meta, state.rec_succ, state.allocated, state.centroids,
        hints.clamp(min=0), vecs, cfg.succ_chase_depth)
    chased = chased.to(torch.int64)
    chased_ok = (has_hint & ~dead_end & state.allocated[chased]
                 & ~state.tier_spilled[chased])

    scores = ops.centroid_score(vecs, state.centroids, insertable)
    located = torch.argmin(scores, dim=-1)
    pid = torch.where(chased_ok, chased, located)

    st = status[pid]
    sp_pid = state.tier_spilled[pid]
    normal = (st == STATUS_NORMAL) & ~sp_pid
    in_flux = ((st == STATUS_SPLITTING) | (st == STATUS_MERGING)
               | ((st == STATUS_NORMAL) & sp_pid))

    direct = valid & normal
    state, ok, _ = batched_append(state, cfg, vecs, ids,
                                  torch.where(direct, pid, -1), direct)
    overflow = direct & ~ok

    if cfg.is_ubis:
        to_cache = valid & (in_flux | overflow)
        state, cached = cache_append(state, cfg, vecs, ids, pid, to_cache)
    else:  # SPFresh lock model: blocked jobs fail this round
        cached = torch.zeros_like(valid)

    accepted = direct & ok
    rejected = valid & ~accepted & ~cached
    state.global_version = state.global_version + 1
    touched = masked_set_(torch.zeros((M,), dtype=torch.bool,
                                      device=state.device),
                          pid, True, accepted)
    result = RoundResult(accepted=accepted, cached=cached, rejected=rejected,
                         target=torch.where(valid, pid, -1).to(torch.int32))
    return state, result, touched


def apply_tombstones(state: IndexState, cfg: UBISConfig, safe_ids, loc,
                     in_post, in_cache, *, base=0):
    """The delete step (UBIS semantics): tombstone the slots of
    ``in_post`` jobs (``loc`` = global flat tile location), drop the
    cache entries of ``in_cache`` jobs (``loc = -2 - slot``), clear their
    id_loc.  Only locations in ``[base, base + span)`` (``span`` = this
    state's pool in flat slots) touch the tiles: a shard's owner span in
    the sharded delete, the whole pool for the single-device caller
    (``base=0``).  The cache and id-map updates follow from the
    replicated inputs alone, so shard replicas stay identical."""
    C = cfg.capacity
    span = state.lengths.shape[0] * C
    lloc = loc.to(torch.int64) - base
    mine = in_post & (lloc >= 0) & (lloc < span)
    lloc = lloc.clamp(0, span - 1)
    masked_set_(_flat(state.slot_valid), lloc, False, mine)
    masked_add_(state.lengths, lloc // C, -1, mine)
    cslot = (-2 - loc.to(torch.int64)).clamp(0, cfg.cache_capacity - 1)
    masked_set_(state.cache_valid, cslot, False, in_cache)
    done = in_post | in_cache
    masked_set_(state.id_loc, safe_ids, -1, done)
    state.global_version = state.global_version + 1
    return state, done


def delete_round(state: IndexState, cfg: UBISConfig, del_ids, valid):
    """Mark a padded batch of external ids as deleted (tombstones).
    Returns (state, done, blocked)."""
    C = cfg.capacity
    safe = del_ids.to(torch.int64).clamp(0, cfg.max_ids - 1)
    loc = state.id_loc[safe]
    first = vm.first_occurrence_mask(safe) & valid
    in_post = first & (loc >= 0)
    in_cache = first & (loc <= -2)

    if not cfg.is_ubis:
        # SPFresh lock model: deletes on non-NORMAL postings are blocked.
        pid_all = loc.clamp(min=0).to(torch.int64) // C
        st = vm.unpack_status(state.rec_meta[pid_all])
        blocked = in_post & (st != STATUS_NORMAL)
        in_post = in_post & ~blocked
    else:
        blocked = torch.zeros_like(valid)

    state, done = apply_tombstones(state, cfg, safe, loc, in_post, in_cache)
    return state, done, blocked


# ---------------------------------------------------------------------------
# recorder transitions used by the background scheduler
# ---------------------------------------------------------------------------

def mark_status(state: IndexState, pids, status: int) -> IndexState:
    """Transition a batch of postings to SPLITTING/MERGING/NORMAL (the
    window that makes the vector cache functionally necessary)."""
    state.rec_meta = vm.transition(state.rec_meta, pids, status)
    state.global_version = state.global_version + 1
    return state
