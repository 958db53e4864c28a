"""Balance Detector + the batched background round (paper IV-C).

UBIS keeps posting lengths in memory and scans them periodically
(``detect``), and splits with a balance factor: a split whose small side
is under ``f * total`` moves that side to nearer postings instead of
persisting a small posting (Alg. 1 BalanceSplit).

``background_round`` executes the whole marked batch (kinds in an int
lane) at once.  The JAX package writes it as one jitted program with
``vmap`` over the batch; here the batch is an explicit leading dimension,
the free-slot grant scan is a loop over the (small) batch on device
tensors, and the two ``lax.cond`` gates (split planning, post-op
reassign) are host branches — the only host reads in the round.  The
sequential single-op functions of the JAX package (``balance_split``,
``merge_postings``, ...) are not ported yet.  The driver sequences
rounds two-phase:

  round t   : mark SPLITTING/MERGING  (foreground traffic diverts to cache)
  round t+1 : execute; old posting -> DELETED with successor pointers.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.ref import BIG
from . import version_manager as vm
from .types import (KIND_COMPACT, KIND_MERGE, KIND_NONE, KIND_SPLIT, NO_ID,
                    NO_SUCC, STATUS_DELETED, STATUS_MERGING, STATUS_NORMAL,
                    STATUS_SPLITTING, BackgroundRound, IndexState, UBISConfig,
                    require_float_plane)
from .update import (_flat, batched_append, cache_append, free_postings)
from .version_manager import masked_add_, masked_set_


# ---------------------------------------------------------------------------
# detection (the in-memory length table scan)
# ---------------------------------------------------------------------------

def detect(state: IndexState, cfg: UBISConfig):
    """(split_due, merge_due, compact_due) boolean masks over M."""
    status = vm.unpack_status(state.rec_meta)
    normal = (state.allocated & (status == STATUS_NORMAL)
              & ~state.tier_spilled)
    split_due = normal & (state.lengths > cfg.l_max)
    merge_due = normal & (state.lengths < cfg.l_min)
    compact_due = (normal & (state.used >= cfg.capacity)
                   & (state.lengths <= cfg.l_max))
    return split_due, merge_due, compact_due


def shard_pressure(state: IndexState, cfg: UBISConfig):
    """Pressure stats for the posting pool: ``(live_postings, free_slots,
    cache_backlog, live_vectors)`` as a (4,) int32 tensor."""
    M = state.allocated.shape[0]
    status = vm.unpack_status(state.rec_meta)
    alive = state.allocated & (status != STATUS_DELETED)
    t = state.cache_target
    backlog = (state.cache_valid & (t >= 0) & (t < M)).sum()
    live_vecs = torch.where(alive, state.lengths, 0).sum()
    return torch.stack([alive.sum(), (~state.allocated).sum(), backlog,
                        live_vecs]).to(torch.int32)


# ---------------------------------------------------------------------------
# masked 2-means over a batch of tiles (the split clustering step)
# ---------------------------------------------------------------------------

def _masked_mean(tiles, masks, fallback):
    """Mean of the masked rows of each tile: (B, C, d), (B, C), (B, d)
    -> (B, d); ``fallback`` where a tile has no masked row."""
    n = masks.sum(-1).clamp(min=1)
    m = torch.where(masks[..., None], tiles.float(), 0.0).sum(1) / n[:, None]
    return torch.where(masks.any(-1)[:, None], m, fallback)


def _median_bisect(tiles, masks):
    """Deterministic balanced bisection of each tile: split the valid
    rows at the median of the maximum-variance axis (ties by rank).
    Initialises 2-means and guards termination when Lloyd collapses to
    an outlier-vs-rest split.  Returns (B, C) int in {0, 1}, -1 invalid."""
    B, C, _ = tiles.shape
    x = tiles.float()
    m3 = masks[..., None]
    n = masks.sum(-1).clamp(min=1)
    mean = torch.where(m3, x, 0.0).sum(1) / n[:, None]
    var = torch.where(m3, (x - mean[:, None]) ** 2, 0.0).sum(1)
    axis = torch.argmax(var, dim=-1)
    col = torch.gather(x, 2, axis[:, None, None].expand(B, C, 1))[..., 0]
    vals = torch.where(masks, col, BIG)
    order = torch.argsort(vals, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(C, device=x.device).expand(B, C))
    half = ((n + 1) // 2)[:, None]
    return torch.where(masks, (rank >= half).to(torch.int32), -1)


def _two_means(tiles, masks, iters: int, init: str = "median"):
    """2-means over the valid rows of each tile.

    init="median": balanced median-split init (the UBIS path);
    init="farthest": classic farthest-point init (the SPFresh-faithful
    path, which collapses to outlier-vs-rest splits — the small-posting
    generator behind the paper's Fig. 5).
    Returns (assign (B, C) int in {0, 1} / -1, c0 (B, d), c1 (B, d))."""
    B = tiles.shape[0]
    x = tiles.float()
    rows = torch.arange(B, device=x.device)
    first = x[rows, torch.argmax(masks.to(torch.uint8), dim=-1)]
    if init == "median":
        ini = _median_bisect(tiles, masks)
        c0 = _masked_mean(x, (ini == 0) & masks, first)
        c1 = _masked_mean(x, (ini == 1) & masks, first)
    else:
        c0 = first
        d0 = torch.where(masks, ((x - c0[:, None]) ** 2).sum(-1), -BIG)
        c1 = x[rows, torch.argmax(d0, dim=-1)]
    for _ in range(iters):
        d0 = ((x - c0[:, None]) ** 2).sum(-1)
        d1 = ((x - c1[:, None]) ** 2).sum(-1)
        a = d1 < d0
        w1 = a & masks
        w0 = ~a & masks
        c0 = _masked_mean(x, w0, c0)
        c1 = _masked_mean(x, w1, c1)
    d0 = ((x - c0[:, None]) ** 2).sum(-1)
    d1 = ((x - c1[:, None]) ** 2).sum(-1)
    assign = torch.where(masks, (d1 < d0).to(torch.int32), -1)
    return assign, c0, c1


def _gather_rows(t, order):
    """t (B, C, ...) reordered along dim 1 by ``order`` (B, C')."""
    if t.dim() == 2:
        return torch.gather(t, 1, order)
    return torch.gather(t, 1, order[..., None].expand(
        order.shape + tuple(t.shape[2:])))


def _front_order(mask):
    """Stable order putting the True rows of each tile first."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)


def _pack_rows(tiles, tids, member_mask):
    """Compact the ``member_mask`` rows of each tile to the front.
    Returns (rows, rids, keep, n)."""
    C = tiles.shape[1]
    order = _front_order(member_mask)
    n = member_mask.sum(-1)
    keep = torch.arange(C, device=tiles.device)[None, :] < n[:, None]
    rows = torch.where(keep[..., None], _gather_rows(tiles, order), 0.0)
    rids = torch.where(keep, _gather_rows(tids, order), NO_ID)
    return rows, rids, keep, n.to(torch.int32)


def _merge_rows(t1, i1, m1, t2, i2, m2):
    """Stable-compact the live members of two tiles into one.
    Returns (rows, rids, keep, n)."""
    C = t1.shape[1]
    o1, o2 = _front_order(m1), _front_order(m2)
    rows = torch.cat([_gather_rows(t1, o1), _gather_rows(t2, o2)], 1)
    rids = torch.cat([_gather_rows(i1, o1), _gather_rows(i2, o2)], 1)
    keep = torch.cat([_gather_rows(m1, o1), _gather_rows(m2, o2)], 1)
    order = _front_order(keep)[:, :C]
    rows, rids, keep = (_gather_rows(rows, order), _gather_rows(rids, order),
                        _gather_rows(keep, order))
    rows = torch.where(keep[..., None], rows, 0.0)
    rids = torch.where(keep, rids, NO_ID)
    return rows, rids, keep, keep.sum(-1).to(torch.int32)


# ---------------------------------------------------------------------------
# epoch GC — reclaim retired postings
# ---------------------------------------------------------------------------

def gc_round(state: IndexState, cfg: UBISConfig, min_live_version, k: int):
    """Reclaim up to ``k`` DELETED postings retired before the oldest
    live snapshot; their ids return to the free stack and successor words
    pointing at them are cleared.  Returns (state, reclaimed count)."""
    status = vm.unpack_status(state.rec_meta)
    weight = vm.unpack_weight(state.rec_meta)
    dead = (state.allocated & (status == STATUS_DELETED)
            & (weight < min_live_version))
    order = torch.argsort((~dead).to(torch.uint8), stable=True)[:k]
    valid = dead[order]
    state = free_postings(state, order, valid)
    return state, valid.sum()


# ---------------------------------------------------------------------------
# batched background round
# ---------------------------------------------------------------------------
# Conflicts that a sequential order would resolve implicitly are resolved
# explicitly:
#   * duplicate pids        -> first occurrence wins (recorder CAS rule);
#   * two merges, 1 partner -> first in batch order wins, loser defers;
#   * free-list exhaustion  -> a sequential grant scan admits ops in batch
#                              order while slots last, later ops defer;
#   * postings retiring this round are excluded from every move-out /
#     reassign target set, so no vector can land in a dying tile.

def _grant(demand: torch.Tensor, free_top: torch.Tensor):
    """Admit ops in batch order while free slots last (the JAX package's
    ``lax.scan``): returns (granted (B,) bool, start offset (B,))."""
    B = demand.shape[0]
    off = torch.zeros((), dtype=torch.int64, device=demand.device)
    granted = torch.empty((B,), dtype=torch.bool, device=demand.device)
    starts = torch.empty((B,), dtype=torch.int64, device=demand.device)
    for i in range(B):
        g = off + demand[i] <= free_top
        granted[i] = g
        starts[i] = off
        off = off + torch.where(g, demand[i], 0)
    return granted, starts


def _plan_splits(state, cfg, tiles, masks, split_exec, normal0, retiring):
    """Masked 2-means + Alg. 1 balance for every lane, and the nearer-
    posting search of each small-side row (one flat kernel call).
    Returns (members_a, members_b, move_out, best_other, cent_a, cent_b)."""
    B, C, d = tiles.shape
    assign, c0, c1 = _two_means(tiles, masks, cfg.kmeans_iters,
                                init="median" if cfg.is_ubis else "farthest")
    n0 = ((assign == 0) & masks).sum(-1)
    n1 = ((assign == 1) & masks).sum(-1)
    small_is_0 = n0 <= n1
    if cfg.is_ubis:
        imbalanced = (torch.minimum(n0, n1).float()
                      < cfg.balance_factor
                      * torch.clamp(n0 + n1, min=1).float())
    else:
        imbalanced = torch.zeros_like(small_is_0)
    small_side = torch.where(small_is_0, 0, 1)[:, None]
    small_mask = (assign == small_side) & masks
    big_mask = (assign == 1 - small_side) & masks
    c_big = torch.where(small_is_0[:, None], c1, c0)
    c_small = torch.where(small_is_0[:, None], c0, c1)

    sc = ops.centroid_score(tiles.reshape(B * C, d), state.centroids,
                            normal0 & ~retiring)
    best_other = torch.argmin(sc, dim=-1)
    best_d = torch.gather(sc, 1, best_other[:, None])[:, 0].reshape(B, C)
    best_other = best_other.reshape(B, C)
    del sc
    d_big_score = ((c_big ** 2).sum(-1)[:, None]
                   - 2 * torch.einsum("bcd,bd->bc", tiles, c_big))
    nearer = best_d < d_big_score
    imb = imbalanced[:, None]
    move_out = imb & small_mask & nearer & split_exec[:, None]
    fold_in = imb & small_mask & ~nearer
    members_a = torch.where(imb, big_mask | fold_in, big_mask)
    members_b = torch.where(imb, torch.zeros_like(small_mask), small_mask)
    # termination guard: median bisection when a survivor stays oversize
    if cfg.is_ubis:
        oversized = ((members_a.sum(-1) > cfg.l_max)
                     | (members_b.sum(-1) > cfg.l_max))
    else:
        oversized = torch.zeros_like(small_is_0)
    med = _median_bisect(tiles, masks)
    med_a = (med == 0) & masks
    med_b = (med == 1) & masks
    ov = oversized[:, None]
    members_a = torch.where(ov, med_a, members_a)
    members_b = torch.where(ov, med_b, members_b)
    move_out = move_out & ~ov
    c_big = torch.where(ov, _masked_mean(tiles, med_a, c_big), c_big)
    c_small = torch.where(ov, _masked_mean(tiles, med_b, c_small), c_small)
    cent_a = _masked_mean(tiles, members_a, c_big)
    cent_b = _masked_mean(tiles, members_b, c_small)
    return members_a, members_b, move_out, best_other, cent_a, cent_b


def _reassign(state, cfg, r_pid):
    """Fused post-op reassign over every posting born this round: move
    each vector to a strictly nearer NORMAL posting when one exists.
    Returns (state, moved count)."""
    M = state.lengths.shape[0]
    C, d = cfg.capacity, cfg.dim
    R = r_pid.shape[0]
    rs = r_pid.clamp(0, M - 1)
    r_tiles = state.vectors[rs].float()
    r_ids = state.ids[rs]
    r_mask = state.slot_valid[rs] & (r_pid >= 0)[:, None]
    status2 = vm.unpack_status(state.rec_meta)
    sc2 = ops.centroid_score(
        r_tiles.reshape(R * C, d), state.centroids,
        state.allocated & (status2 == STATUS_NORMAL) & ~state.tier_spilled)
    own = rs[:, None].expand(R, C).reshape(-1)
    sc2[torch.arange(R * C, device=sc2.device), own] = BIG
    r_best = torch.argmin(sc2, dim=-1)
    r_bd = torch.gather(sc2, 1, r_best[:, None])[:, 0]
    del sc2
    own_c = state.centroids[rs].float()
    d_own = ((own_c ** 2).sum(-1)[:, None]
             - 2 * torch.einsum("bcd,bd->bc", r_tiles, own_c)).reshape(-1)
    mv = r_mask.reshape(-1) & (r_bd < d_own)
    state, mv_ok, _ = batched_append(
        state, cfg, r_tiles.reshape(-1, d), r_ids.reshape(-1),
        torch.where(mv, r_best, -1), mv)
    moved = mv & mv_ok
    src_flat = own * C + torch.arange(C, device=own.device).repeat(R)
    masked_set_(_flat(state.slot_valid), src_flat, False, moved)
    masked_add_(state.lengths, own, -1, moved)
    return state, moved.sum()


def background_round(state: IndexState, cfg: UBISConfig, kinds, pids):
    """Execute a padded batch of marked background ops.

    kinds: (B,) int in {KIND_NONE, KIND_SPLIT, KIND_MERGE, KIND_COMPACT}
    pids:  (B,) int posting ids (-1 = padding)

    Ops must have been marked (SPLITTING for split/compact, MERGING for
    merge) in an earlier round.  Updates ``state`` in place; returns
    (state, BackgroundRound).  The JAX package's ``use_cache=False`` (the
    sharded plane) is not ported yet."""
    require_float_plane(cfg)
    dev = state.device
    B = kinds.shape[0]
    C, d = cfg.capacity, cfg.dim
    M = state.lengths.shape[0]
    ver = state.global_version + 1
    lanes = torch.arange(B, device=dev)

    kinds = kinds.to(device=dev, dtype=torch.int64)
    pids = pids.to(device=dev, dtype=torch.int64)
    safe = pids.clamp(0, M - 1)
    status = vm.unpack_status(state.rec_meta)

    want = torch.where(kinds == KIND_MERGE, STATUS_MERGING, STATUS_SPLITTING)
    valid = ((pids >= 0) & (kinds != KIND_NONE)
             & vm.first_occurrence_mask(pids)
             & state.allocated[safe] & (status[safe] == want)
             & ~state.tier_spilled[safe])

    lengths0 = state.lengths[safe]
    # a split whose live length no longer exceeds l_max demotes to compact
    kind = torch.where(valid & (kinds == KIND_SPLIT)
                       & (lengths0 <= cfg.l_max), KIND_COMPACT,
                       torch.where(valid, kinds, KIND_NONE))
    is_split = kind == KIND_SPLIT
    is_merge = kind == KIND_MERGE
    normal0 = (state.allocated & (status == STATUS_NORMAL)
               & ~state.tier_spilled)

    # ---- merge partner selection (conflicts: first in batch order wins)
    n_me = torch.where(is_merge, lengths0, 0)
    psc = ops.centroid_score(state.centroids[safe].float(), state.centroids,
                             normal0)                              # (B, M)
    psc = torch.where(state.lengths[None, :] + n_me[:, None] < cfg.l_max,
                      psc, BIG)
    partner = torch.argmin(psc, dim=-1)
    has_partner = ((torch.gather(psc, 1, partner[:, None])[:, 0] < BIG / 2)
                   & is_merge)
    del psc
    pkey = torch.where(has_partner, partner, -2 - lanes)
    merge_ok = is_merge & (vm.first_occurrence_mask(pkey) | ~has_partner)
    kind = torch.where(is_merge & ~merge_ok, KIND_NONE, kind)
    is_merge = kind == KIND_MERGE
    is_compact = kind == KIND_COMPACT

    # ---- free-slot budget: sequential grant scan over the batch -------
    demand = torch.where(is_split, 2, torch.where(is_merge, 1, 0))
    granted, starts = _grant(demand, state.free_top)
    exec_ = (kind != KIND_NONE) & granted
    split_exec = is_split & exec_
    merge_exec = is_merge & exec_
    compact_exec = is_compact & exec_
    deferred = valid & ~exec_            # revert to NORMAL, re-mark later
    total = torch.where(exec_, demand, 0).sum()

    # ---- ranked free-list pops: op i takes slots [start_i, start_i+dem)
    idx1 = state.free_top - 1 - starts
    pa = torch.where(split_exec | merge_exec,
                     state.free_list[idx1.clamp(0, M - 1)], -1).long()
    pb = torch.where(split_exec,
                     state.free_list[(idx1 - 1).clamp(0, M - 1)], -1).long()

    partner = torch.where(merge_exec & has_partner, partner, -1)
    has_partner = partner >= 0
    retiring = torch.zeros((M,), dtype=torch.bool, device=dev)
    masked_set_(retiring, pids, True, split_exec | merge_exec)
    masked_set_(retiring, partner, True, has_partner)

    tiles = state.vectors[safe].float()                  # (B, C, d)
    tids_all = state.ids[safe]                           # (B, C)
    masks = state.slot_valid[safe]                       # (B, C)

    # ---- split planning (a host branch: the JAX package's lax.cond) ----
    if bool(split_exec.any()):
        (members_a, members_b, move_out, best_other, cent_a,
         cent_b) = _plan_splits(state, cfg, tiles, masks, split_exec,
                                normal0, retiring)
    else:
        members_a = members_b = move_out = torch.zeros_like(masks)
        best_other = torch.zeros((B, C), dtype=torch.int64, device=dev)
        cent_a = cent_b = torch.zeros((B, d), dtype=torch.float32,
                                      device=dev)
    b_empty = ~members_b.any(-1) & split_exec

    # ---- merge tile construction --------------------------------------
    safe_partner = partner.clamp(0, M - 1)
    pt = state.vectors[safe_partner].float()
    pi = state.ids[safe_partner]
    pmask = state.slot_valid[safe_partner] & has_partner[:, None]
    m_rows, m_rids, m_keep, m_n = _merge_rows(tiles, tids_all, masks,
                                              pt, pi, pmask)
    n1 = masks.sum(-1)
    n2 = pmask.sum(-1)
    mean1 = _masked_mean(tiles, masks, state.centroids[safe].float())
    mean2 = _masked_mean(pt, pmask, torch.zeros((B, d), device=dev))
    cent_m = ((mean1 * n1[:, None] + mean2 * n2[:, None])
              / torch.clamp(n1 + n2, min=1)[:, None])

    # ---- compact + split children tile packing ------------------------
    a_rows, a_rids, a_keep, a_n = _pack_rows(tiles, tids_all, members_a)
    b_rows, b_rids, b_keep, b_n = _pack_rows(tiles, tids_all, members_b)
    c_rows, c_rids, c_keep, c_n = _pack_rows(tiles, tids_all, masks)

    # ---- one scatter per field writes every produced tile -------------
    w_pid = torch.cat([torch.where(split_exec, pa, -1),
                       torch.where(split_exec, pb, -1),
                       torch.where(merge_exec, pa, -1),
                       torch.where(compact_exec, pids, -1)])
    w_valid = torch.cat([split_exec, split_exec, merge_exec, compact_exec])
    w_rows = torch.cat([a_rows, b_rows, m_rows, c_rows])
    w_keep = torch.cat([a_keep, b_keep, m_keep, c_keep]) & w_valid[:, None]
    w_rids = torch.where(w_keep, torch.cat([a_rids, b_rids, m_rids, c_rids]),
                         NO_ID)
    w_n = torch.cat([a_n, b_n, m_n, c_n])
    w_cent = torch.cat([cent_a, cent_b, cent_m,
                        state.centroids[safe].float()])

    # claim the popped slots (recorder word + allocated + free_top)
    new_pids = torch.cat([pa, pb])
    np_ok = new_pids >= 0
    rec_meta = masked_set_(state.rec_meta.clone(), new_pids,
                           vm.pack_meta(STATUS_NORMAL, ver), np_ok)
    rec_succ = masked_set_(state.rec_succ.clone(), new_pids,
                           (NO_SUCC << 16) | NO_SUCC, np_ok)
    allocated = masked_set_(state.allocated.clone(), new_pids, True, np_ok)

    masked_set_(state.vectors, w_pid, w_rows.to(state.vectors.dtype), w_valid)
    masked_set_(state.ids, w_pid, w_rids, w_valid)
    masked_set_(state.slot_valid, w_pid, w_keep, w_valid)
    masked_set_(state.used, w_pid, w_n, w_valid)
    masked_set_(state.lengths, w_pid, w_n, w_valid)
    masked_set_(state.centroids, w_pid, w_cent.to(state.centroids.dtype),
                w_valid)
    flat = w_pid[:, None] * C + torch.arange(C, device=dev)[None, :]
    masked_set_(state.id_loc, w_rids.reshape(-1).clamp(0, cfg.max_ids - 1),
                flat.reshape(-1).to(torch.int32), w_keep.reshape(-1))

    # ---- batched retirement: DELETED + successor installation ---------
    succ_b = torch.where(b_empty, -1, pb)
    minus = torch.full((B,), -1, dtype=torch.int64, device=dev)
    ret_pids = torch.cat([torch.where(split_exec, pids, -1),
                          torch.where(merge_exec, pids, -1), partner])
    ret_s1 = torch.cat([torch.where(split_exec, pa, -1),
                        torch.where(merge_exec, pa, -1),
                        torch.where(has_partner, pa, -1)])
    ret_s2 = torch.cat([succ_b, minus, minus])
    rec_meta, rec_succ = vm.retire(rec_meta, rec_succ, ret_pids, ret_s1,
                                   ret_s2, ver)
    # Rescue rule: no mark may outlive a round it rode in.  A lane can be
    # invalid (stale kind, duplicate pid) while its posting still carries
    # SPLITTING/MERGING; if no other lane handles that posting this
    # round, revert it to NORMAL so the detector can re-mark it.
    handled = masked_set_(torch.zeros((M,), dtype=torch.bool, device=dev),
                          pids, True, exec_ | deferred)
    st0 = status[safe]
    stuck = ((pids >= 0) & ~exec_ & ~deferred & ~handled[safe]
             & state.allocated[safe]
             & ((st0 == STATUS_SPLITTING) | (st0 == STATUS_MERGING)))
    rec_meta = vm.transition(
        rec_meta,
        torch.cat([torch.where(deferred | stuck, pids, -1),
                   torch.where(compact_exec, pids, -1)]),
        STATUS_NORMAL)

    # ---- neighbourhood graph: children adopt the parent's edges -------
    pn = state.nbrs[safe].long()
    nb_pid = torch.cat([torch.where(split_exec, pa, -1),
                        torch.where(split_exec, pb, -1),
                        torch.where(merge_exec, pa, -1)])
    nb_rows = torch.cat([
        torch.cat([torch.where(b_empty, pa, pb)[:, None], pn[:, :-1]], 1),
        torch.cat([pa[:, None], pn[:, :-1]], 1),
        pn])
    nbrs = masked_set_(state.nbrs.clone(), nb_pid, nb_rows.to(torch.int32),
                       nb_pid >= 0)

    state.rec_meta, state.rec_succ = rec_meta, rec_succ
    state.allocated, state.nbrs = allocated, nbrs
    state.free_top = state.free_top - total.to(torch.int32)
    state.global_version = ver

    # empty b-sides go straight back to the free list
    state = free_postings(state, pb, b_empty)

    # ---- small-side move-outs (one conflict-free append for the batch)
    mo_vecs = tiles.reshape(B * C, d)
    mo_ids = tids_all.reshape(B * C)
    mo = move_out.reshape(B * C)
    mo_tgt = torch.where(mo, best_other.reshape(B * C), -1)
    state, mo_ok, _ = batched_append(state, cfg, mo_vecs, mo_ids, mo_tgt, mo)
    spill = mo & ~mo_ok
    state, cache_ok = cache_append(state, cfg, mo_vecs, mo_ids,
                                   torch.where(spill, mo_tgt, -1), spill)
    lost = spill & ~cache_ok
    n_spill = (spill & cache_ok).sum()
    # spills the cache cannot hold fold back into child a — always fits
    pa_row = pa[:, None].expand(B, C).reshape(B * C)
    state, _, _ = batched_append(state, cfg, mo_vecs, mo_ids,
                                 torch.where(lost, pa_row, -1), lost)

    # ---- fused post-op reassign (a host branch: lax.cond) -------------
    n_re = torch.zeros((), dtype=torch.int64, device=dev)
    r_pid = torch.cat([torch.where(split_exec, pa, -1),
                       torch.where(split_exec & ~b_empty, pb, -1),
                       torch.where(merge_exec, pa, -1)])
    if bool((r_pid >= 0).any()):
        state, n_re = _reassign(state, cfg, r_pid)

    rr = BackgroundRound(
        executed=exec_.sum(), n_split=split_exec.sum(),
        n_merge=merge_exec.sum(), n_compact=compact_exec.sum(),
        deferred=deferred.sum() + stuck.sum(),
        moved_out=(mo & mo_ok).sum(), spilled=n_spill, reassigned=n_re,
        freed=b_empty.sum())
    return state, rr
