"""Distributed UBIS: the index over S logical shards (the sharded plane).

The JAX package shards the posting pool over the ``model`` axis of a
device mesh and runs each program under ``shard_map``.  Here the ``model``
axis is S logical shards of one device (``distributed/sharding.py``):

  * the global ``IndexState`` owns the storage, and shard s's local state
    is *views* of rows ``[s * M_local, (s + 1) * M_local)`` of every
    ``"model"`` field of :func:`index_specs`;
  * every replicated field (the id map, the vector cache, the free-stack
    top, the global version, the codebooks) has one replica per shard;
    shard 0's replica is the global state's own field.

A program is the reference's per-shard stages run one shard after
another, separated by the collectives the reference calls, in the same
order.  Each stage reads its own replica, so a shard never sees another
shard's write of a replicated field within a program, as on a pod.  The
replicas are identical after every program (:func:`check_replicas`).

One shard owns each posting, so structural updates (split / merge /
compact / GC) stay shard-local; only search and insert communicate:

  * search  — per-shard phase-1 top-nprobe, all-gather the (score, id)
              candidates, global re-rank, per-shard phase-2 scan of the
              postings it owns, all-gather per-shard top-k, final merge;
  * insert  — per-shard locate (scores vs. local centroids), global
              argmin over the gathered per-shard bests routes each job
              to its owner shard, which applies the conflict-free append.

Every top-k here is the stable one (ties lowest index first, as
``lax.top_k`` breaks them), and gathers are in shard order.
"""
from __future__ import annotations

import dataclasses

import torch

from ..distributed.sharding import Mesh, all_gather, pmax, psum
from ..kernels import ops
from ..kernels.ref import BIG, stable_topk
from ..quant import pq
from . import balance, update, version_manager as vm
from .types import (NO_SUCC, STATUS_DELETED, STATUS_NORMAL, IndexState,
                    UBISConfig)
from .version_manager import masked_set_


def index_specs() -> dict:
    """Field -> ``"model"`` (rows shard over the model axis) or ``None``
    (replicated): the layout of the JAX package's ``index_specs``.  The
    id map and the vector cache are replicated (the cache is small and
    every search scans it); PQ codes and the tier flags follow their
    posting, the versioned codebooks are replicated."""
    model = {"vectors", "ids", "slot_valid", "used", "lengths", "centroids",
             "rec_meta", "rec_succ", "allocated", "nbrs", "free_list",
             "codes", "pq_posting_slot", "heat", "tier_spilled"}
    return {f.name: ("model" if f.name in model else None)
            for f in dataclasses.fields(IndexState)}


MODEL_FIELDS = tuple(f for f, ax in index_specs().items() if ax)
REPLICATED_FIELDS = tuple(f for f, ax in index_specs().items() if not ax)


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class ShardedState:
    """An ``IndexState`` held as S logical shards of one device.

    ``state`` is the global view: an ordinary ``IndexState`` whose
    sharded fields own the storage and whose replicated fields are shard
    0's replica.  Code that runs on the whole index (the codebook
    re-train, the cold tier, the cache admission, ``snapshot``) works on
    it and then calls :meth:`replicate`, which broadcasts the replicated
    fields to the other shards (the ``device_put`` of the reference)."""

    def __init__(self, state: IndexState, mesh: Mesh):
        S = mesh.shape["model"]
        M = state.allocated.shape[0]
        if M % S:
            raise ValueError(f"max_postings {M} must divide the model axis "
                             f"({S} shards)")
        self.state = state
        self.mesh = mesh
        self.n_shards = S
        self.pool = M // S
        self._reps: list = [None] * S
        self.replicate()

    def replicate(self) -> None:
        """Every shard's replica := the global view's replicated fields."""
        self._reps[0] = {f: getattr(self.state, f) for f in REPLICATED_FIELDS}
        for s in range(1, self.n_shards):
            self._reps[s] = {f: t.clone() for f, t in self._reps[0].items()}

    def local(self, s: int) -> IndexState:
        """Shard ``s``'s state: views of its rows and its own replicas."""
        lo, hi = s * self.pool, (s + 1) * self.pool
        kw = {f: getattr(self.state, f)[lo:hi] for f in MODEL_FIELDS}
        kw.update(self._reps[s])
        return IndexState(**kw)

    def store(self, s: int, local: IndexState) -> None:
        """Take shard ``s``'s state back after a stage: a sharded field a
        function replaced (instead of writing in place) is copied into the
        shard's rows; the replicated fields become its replica (shard
        0's are also the global view's)."""
        lo, hi = s * self.pool, (s + 1) * self.pool
        for f in MODEL_FIELDS:
            t, view = getattr(local, f), getattr(self.state, f)[lo:hi]
            if not _same_storage(t, view):
                view.copy_(t)
        self._reps[s] = {f: getattr(local, f) for f in REPLICATED_FIELDS}
        if s == 0:
            for f, t in self._reps[0].items():
                setattr(self.state, f, t)


def check_replicas(sh: ShardedState) -> None:
    """Raise ``AssertionError`` unless every shard's replica of every
    replicated field equals shard 0's, bit for bit."""
    ref = sh._reps[0]
    for s in range(1, sh.n_shards):
        for f, t in sh._reps[s].items():
            if not torch.equal(t, ref[f]):
                raise AssertionError(f"replica of {f} on shard {s} differs "
                                     "from shard 0's")


def _local_topk(scores, ids, k):
    s, idx = stable_topk(scores, k)
    return s, torch.gather(ids, -1, idx)


def _owned_cache_slice(state: IndexState, my: int, n_shard: int):
    """This shard's 1/S slice of the replicated vector cache: (vecs,
    valid, ids), with the rows of the clamped overlap masked OUT of
    ``valid``.  Ceil-div slices of a capacity S does not divide overlap
    at the end (the ``start`` clamp); the ownership mask keeps every
    cache slot scanned by exactly one shard, so the merge can never
    count an entry twice.  Shared by the sharded search and exact."""
    K_all = state.cache_vecs.shape[0]
    Ks = -(-K_all // n_shard)
    start = min(my * Ks, K_all - Ks)
    cvs = state.cache_vecs[start:start + Ks]
    cval = state.cache_valid[start:start + Ks]
    cid = state.cache_ids[start:start + Ks]
    own = (torch.arange(Ks, device=cval.device) + start) >= my * Ks
    return cvs, cval & own, cid


def _rebase_succ(rec_succ, offset: int, limit: int):
    """Shift stored successor pids by ``offset``; anything landing outside
    [0, limit) becomes no-successor (``NO_SUCC`` stays ``NO_SUCC``)."""
    s1, s2 = vm.succ_ids(rec_succ)

    def shift(s):
        t = torch.where(s >= 0, s.to(torch.int64) + offset, -1)
        return torch.where((t >= 0) & (t < limit), t, -1)

    t1, t2 = shift(s1), shift(s2)
    return vm.pack_succ(torch.where(t1 < 0, NO_SUCC, t1),
                        torch.where(t2 < 0, NO_SUCC, t2))


def _pq_phase2(state: IndexState, cfg: UBISConfig, queries, probe, mine,
               vis, k: int):
    """Sharded search phase 2 served from PQ codes (``cfg.use_pq``): per
    shard, the ADC scan of the owned probed tiles' codes with the
    ownership mask applied in the kernel, then the exact rerank of the
    local top ``rerank_k``.  Returns this shard's (scores, ids)."""
    C = state.vectors.shape[1]
    R = min(cfg.rerank_k, probe.shape[1] * C)
    luts = pq.lookup_tables(state.pq_codebooks, queries)   # (Q, V, m, ksub)
    adc_top, cand = ops.pq_scan_topk(
        luts, state.codes, state.pq_posting_slot, state.slot_valid, vis,
        probe, k=R, qp_ok=mine)
    exact, cand_sel = ops.rerank_topk(queries, state.vectors,
                                      state.tier_spilled, cand, adc_top,
                                      k=min(k, R))
    ids = state.ids.reshape(-1)[cand_sel.to(torch.int64)]
    return exact, torch.where(exact < BIG / 2, ids, -1)


def make_sharded_search(cfg: UBISConfig, mesh: Mesh, k: int,
                        nprobe: int | None = None,
                        shard_cache_scan: bool = True):
    """The sharded search: (sh, queries (Q, d)) -> (ids (Q, k) int32,
    scores (Q, k)).  ``shard_cache_scan``: each shard scans only its 1/S
    slice of the replicated cache (else shard 0 scans all of it); the
    merge all-gather combines the partial top-ks.  ``cfg.shard_probe_cap``
    > 0 compacts each shard's phase-2 scan to its first that many owned
    probes (phase-1 order, best first)."""
    if nprobe is None:
        nprobe = cfg.nprobe
    probe_cap = cfg.shard_probe_cap

    def run(sh: ShardedState, queries: torch.Tensor):
        S, M_local = sh.n_shards, sh.pool
        queries = queries.to(torch.float32)
        locs = [sh.local(s) for s in range(S)]
        # phase 1 local: fused centroid score + per-shard top-nprobe
        p_local = min(nprobe, M_local)
        vis, s1, pid = [], [], []
        for st in locs:
            v = vm.visible(st.rec_meta, st.allocated, st.global_version)
            sc, lp = ops.centroid_topk(queries, st.centroids, v, k=p_local)
            vis.append(v)
            s1.append(sc)
            pid.append(lp)
        # global re-rank of the gathered candidates
        s1_all = all_gather(s1, 1)
        pid_all = all_gather(pid, 1).to(torch.int64)
        owner = torch.arange(S, device=queries.device).repeat_interleave(
            p_local)[None, :].expand(s1_all.shape)
        _, sel = stable_topk(s1_all, nprobe)
        probe_owner = torch.gather(owner, 1, sel)
        probe_pid = torch.gather(pid_all, 1, sel)
        cap = probe_cap if probe_cap else nprobe
        s_parts, i_parts = [], []
        for my, st in enumerate(locs):
            # phase 2: scan the selected postings THIS shard owns
            mine = probe_owner == my
            if cap < nprobe:
                order = torch.argsort((~mine).to(torch.uint8), dim=1,
                                      stable=True)[:, :cap]
                pid_cap = torch.gather(probe_pid, 1, order)
                mine_cap = torch.gather(mine, 1, order)
            else:
                pid_cap, mine_cap = probe_pid, mine
            safe_pid = torch.where(mine_cap, pid_cap, 0)
            if cfg.use_pq:
                s2, i2 = _pq_phase2(st, cfg, queries, safe_pid, mine_cap,
                                    vis[my], k)
            else:
                C = st.vectors.shape[1]
                k_local = min(k, safe_pid.shape[1] * C)
                s2, cand2 = ops.posting_scan_topk(
                    queries, st.vectors, st.slot_valid, vis[my], safe_pid,
                    k=k_local, qp_ok=mine_cap)
                i2 = st.ids.reshape(-1)[cand2.to(torch.int64)]
            # cache scan: a 1/S slice per shard (or shard 0 scans it all)
            if shard_cache_scan:
                cvs, cval_own, cid = _owned_cache_slice(st, my, S)
                s3, cpos = ops.centroid_topk(queries, cvs, cval_own,
                                             k=min(k, cvs.shape[0]))
                i3 = cid[cpos.to(torch.int64)]
            else:
                cval = st.cache_valid & (my == 0)
                s3, cpos = ops.centroid_topk(
                    queries, st.cache_vecs, cval,
                    k=min(k, st.cache_vecs.shape[0]))
                i3 = st.cache_ids[cpos.to(torch.int64)]
            s_parts.append(torch.cat([s2, s3], dim=1))
            i_parts.append(torch.cat([i2, i3], dim=1))
        # global merge
        sf, idf = _local_topk(all_gather(s_parts, 1), all_gather(i_parts, 1),
                              k)
        return torch.where(sf < BIG / 2, idf, -1), sf

    return run


def make_sharded_insert(cfg: UBISConfig, mesh: Mesh,
                        route_alpha: float = 0.0):
    """The sharded insert round: (sh, vecs, ids, valid) -> (sh, accepted
    (J,) bool, routed (J,) int32).

    Each shard locates jobs against its local centroids (NORMAL, not
    spilled postings only); a global argmin routes each job to its owner
    shard, which runs the conflict-free batched append on its sub-pool.
    Blocked jobs are *rejected*: the cache is replicated, so the driver
    parks them.  ``routed`` is the GLOBAL pid located for each job (-1
    when nothing was insertable), the parked jobs' cache target.
    ``route_alpha`` > 0 penalizes each job's per-shard best score by
    ``route_alpha * saturation * range`` (saturation: the shard's live
    vectors over its pool's ``M_local * l_max``; range: the job's finite
    score spread), so a nearly-full shard only wins a job it is
    decisively closest to."""
    C = cfg.capacity

    def run(sh: ShardedState, vecs, ids, valid):
        S, M_local = sh.n_shards, sh.pool
        locs = [sh.local(s) for s in range(S)]
        best_local, best_pid = [], []
        for st in locs:
            status = vm.unpack_status(st.rec_meta)
            insertable = (st.allocated & (status == STATUS_NORMAL)
                          & ~st.tier_spilled)
            sc = ops.centroid_score(vecs, st.centroids, insertable)
            bp = torch.argmin(sc, dim=1)
            best_local.append(torch.gather(sc, 1, bp[:, None])[:, 0])
            best_pid.append(bp)
            del sc
        # global owner = argmin over shards (lowest shard on a tie)
        all_best = torch.stack(best_local)                       # (S, J)
        if route_alpha:
            sat = []
            for st in locs:
                status = vm.unpack_status(st.rec_meta)
                alive = st.allocated & (status != STATUS_DELETED)
                live = torch.where(alive, st.lengths, 0).sum()
                sat.append(live.to(torch.float32)
                           / float(M_local * cfg.l_max))
            sat_all = torch.stack(sat)                           # (S,)
            finite = all_best < BIG / 2
            vmin = torch.where(finite, all_best, BIG).min(dim=0).values
            vmax = torch.where(finite, all_best, -BIG).max(dim=0).values
            rng_j = torch.clamp(vmax - vmin, min=0.0)
            all_best = torch.where(
                finite,
                all_best + route_alpha * sat_all[:, None] * rng_j[None, :],
                all_best)
        owner = torch.argmin(all_best, dim=0)
        routed_c, claim_c, flat_c, won_c = [], [], [], []
        for my, st in enumerate(locs):
            claim = (owner == my) & (best_local[my] < BIG / 2)
            mine = valid & claim
            routed_c.append(torch.where(claim, best_pid[my] + my * M_local, 0))
            claim_c.append(claim.to(torch.int64))
            st, ok, flat_local = update.batched_append(
                st, cfg, vecs, ids, torch.where(mine, best_pid[my], -1),
                mine, update_id_loc=False)
            won = mine & ok
            flat_c.append(torch.where(won, my * (M_local * C) + flat_local,
                                      0))
            won_c.append(won.to(torch.int64))
        routed = psum(routed_c)
        routable = psum(claim_c) > 0
        routed = torch.where(valid & routable, routed, -1)
        # the replicated id map: one-hot sums, one winner per job
        flat_global = psum(flat_c).to(torch.int32)
        any_won = psum(won_c) > 0
        safe_ids = ids.to(torch.int64).clamp(0, cfg.max_ids - 1)
        for my, st in enumerate(locs):
            masked_set_(st.id_loc, safe_ids, flat_global, valid & any_won)
            st.global_version = st.global_version + 1
            sh.store(my, st)
        return sh, valid & any_won, routed.to(torch.int32)

    return run


def make_sharded_delete(cfg: UBISConfig, mesh: Mesh):
    """The sharded delete round: (sh, del_ids, valid) -> (sh, done (J,)
    bool).  Locations come from the replicated id map, so routing is
    free: each shard tombstones the locations in its own span
    (``update.apply_tombstones(base=)``), and the cache and id-map
    updates are computed identically on every shard from its replica.
    UBIS semantics only."""
    C = cfg.capacity

    def run(sh: ShardedState, del_ids, valid):
        done0 = None
        safe = del_ids.to(torch.int64).clamp(0, cfg.max_ids - 1)
        first = vm.first_occurrence_mask(safe) & valid
        for my in range(sh.n_shards):
            st = sh.local(my)
            loc = st.id_loc[safe]
            in_post = first & (loc >= 0)
            in_cache = first & (loc <= -2)
            st, done = update.apply_tombstones(
                st, cfg, safe, loc, in_post, in_cache,
                base=my * sh.pool * C)
            sh.store(my, st)
            if done0 is None:
                done0 = done
        return sh, done0

    return run


def make_sharded_background(cfg: UBISConfig, mesh: Mesh, bg_ops: int = 8,
                            reassign: bool = True, gc_k: int = 64):
    """The sharded background tick: (sh, gc_min_version) -> (sh, executed,
    reclaimed, pressure (S, 4) int32).

    Every shard runs the same program over the postings it owns: select
    the top ``bg_ops`` candidates, mark, execute
    (``balance.background_round`` with ``use_cache=False``: the cache is
    replicated, so split-side spills fold back into child ``a``), then
    epoch GC of up to ``gc_k`` of its retired postings older than
    ``gc_min_version``.  The shard-specific steps, as in the reference:

      * a local free view is derived from ``allocated`` on entry; the
        state leaves with a fail-safe EMPTY stack (``free_top = 0``);
      * successor pointers are stored global and used local: localized
        on entry (cross-shard successors dead-end), and only the words
        the round rewrote are rebased back on exit;
      * the id map's local rewrites are rebased by the shard's pool
        offset and merged with one sum of deltas;
      * ``global_version`` is the max over shards.

    ``pressure`` is ``balance.shard_pressure`` per shard, after the
    round and GC: the rebalance planner's input."""
    C = cfg.capacity

    def run(sh: ShardedState, gc_min_version):
        S, M_local = sh.n_shards, sh.pool
        locs, olds, execs, gcs = [], [], [], []
        total = None
        for my in range(S):
            st = sh.local(my)
            base_pid = my * M_local
            st = update.rebuild_free_stack(st)
            old_succ_global = st.rec_succ.clone()
            succ_local0 = _rebase_succ(old_succ_global, -base_pid, M_local)
            st.rec_succ = succ_local0.clone()
            old_id_loc = st.id_loc.clone()
            kinds, pids = balance.select_candidates(st, cfg, bg_ops)
            st.rec_meta = balance.mark_selected(st.rec_meta, kinds, pids)
            st, rr = balance.background_round(st, cfg, kinds, pids,
                                              reassign=reassign,
                                              use_cache=False)
            st, n_gc = balance.gc_round(st, cfg, gc_min_version, gc_k)
            # the id map's rewrites, rebased from local to global flats
            il = st.id_loc.to(torch.int64)
            old = old_id_loc.to(torch.int64)
            changed = il != old
            rebased = torch.where(changed & (il >= 0),
                                  il + my * (M_local * C), il)
            delta = torch.where(changed, rebased - old, 0)
            total = delta if total is None else total + delta
            succ_changed = st.rec_succ != succ_local0
            st.rec_succ = torch.where(
                succ_changed,
                _rebase_succ(st.rec_succ, base_pid, cfg.max_postings),
                old_succ_global)
            locs.append(st)
            olds.append(old)
            execs.append(rr.executed.to(torch.int64))
            gcs.append(n_gc.to(torch.int64))
        version = pmax([st.global_version for st in locs])
        pressure = []
        for my, st in enumerate(locs):
            st.id_loc = (olds[my] + total).to(torch.int32)
            st.free_top = torch.zeros_like(st.free_top)
            st.global_version = version.clone()
            pressure.append(balance.shard_pressure(st, cfg,
                                                   base_pid=my * M_local))
            sh.store(my, st)
        return sh, psum(execs), psum(gcs), torch.stack(pressure)

    return run


def make_sharded_migrate(cfg: UBISConfig, mesh: Mesh, jobs: int = 8):
    """The cross-shard posting migration round: (sh, src_pids (B,),
    dst_shards (B,), valid (B,)) -> (sh, migrated (B,) bool, new_pids (B,)
    int32), B = ``jobs`` (another width raises ``ValueError``).

    ``new_pids`` is the landing GLOBAL pid per job (-1 when the job did
    not move): the cold tier remaps its host-pool entries by it, because
    a **spilled** posting migrates without promotion (its zeroed tile,
    codes, heat and ``tier_spilled`` flag travel verbatim).  Three steps:

      * extraction: the owner shard's tile, ids, slot validity, used and
        live counts, centroid, codes, codebook slot, heat and spill flag
        of each job reach every shard as a one-hot sum (exactly one shard
        adds a value, the others zeros, so the copy is bit-exact).  Only
        allocated NORMAL postings move;
      * installation: the receiver grants slots from its local free view
        in batch order while they last, writes the payload verbatim into
        them with an empty neighbour row (the donor's row holds
        shard-local pids) and claims the recorder word at the round's
        version;
      * hand-off: the donor retires its copy (DELETED, no successors) and
        every shard applies the identical id-map rewrite from the
        replicated payload.

    The free stack leaves fail-safe EMPTY."""
    C = cfg.capacity

    def run(sh: ShardedState, src_pids, dst_shards, valid):
        if src_pids.shape[0] != jobs:
            raise ValueError(f"migrate round built for jobs={jobs}, "
                             f"got batch of {src_pids.shape[0]}")
        S, M_local = sh.n_shards, sh.pool
        B = jobs
        src = src_pids.to(torch.int64)
        dst = dst_shards.to(torch.int64)
        locs = [update.rebuild_free_stack(sh.local(s)) for s in range(S)]
        src_shard = torch.div(src, M_local, rounding_mode="floor")
        job_ok = (valid & (src >= 0) & (src < S * M_local)
                  & vm.first_occurrence_mask(src)
                  & (dst >= 0) & (dst < S) & (dst != src_shard))

        # ---- donor extraction: one-hot sums replicate each payload ----
        names = ("vectors", "ids", "slot_valid", "used", "lengths",
                 "centroids", "codes", "pq_posting_slot", "heat",
                 "tier_spilled")
        parts = {n: [] for n in names}
        donates, sls = [], []
        for my, st in enumerate(locs):
            src_local = src - my * M_local
            sl = src_local.clamp(0, M_local - 1)
            status = vm.unpack_status(st.rec_meta)
            donate = (job_ok & (src_local >= 0) & (src_local < M_local)
                      & st.allocated[sl] & (status[sl] == STATUS_NORMAL))
            for n in names:
                x = getattr(st, n)[sl]
                if x.dtype in (torch.bool, torch.uint8):
                    x = x.to(torch.int64)
                mask = donate.reshape((B,) + (1,) * (x.dim() - 1))
                parts[n].append(torch.where(mask, x, torch.zeros_like(x)))
            donates.append(donate)
            sls.append(sl)
        pay = {n: psum(v) for n, v in parts.items()}
        sv_b = pay["slot_valid"] > 0
        sp_b = pay["tier_spilled"] > 0
        codes_b = pay["codes"].to(torch.uint8)
        movable = psum([d.to(torch.int64) for d in donates]) > 0

        # ---- receiver admission: sequential free-stack grant scan -----
        grants, news = [], []
        for my, st in enumerate(locs):
            want = movable & (dst == my)
            granted, starts = balance._grant(want.to(torch.int64),
                                             st.free_top)
            grant = want & granted
            idx = (st.free_top - 1 - starts).clamp(0, M_local - 1)
            grants.append(grant)
            news.append(torch.where(grant, st.free_list[idx].to(torch.int64),
                                    -1))
        new_global = psum([torch.where(g, n + my * M_local, 0)
                           for my, (g, n) in enumerate(zip(grants, news))])
        migrated = psum([g.to(torch.int64) for g in grants]) > 0
        new_global = torch.where(migrated, new_global, -1)

        ids_flat = pay["ids"].reshape(B * C)
        live_flat = ((sv_b & migrated[:, None]).reshape(B * C)
                     & (ids_flat >= 0))
        new_flat = (new_global[:, None] * C + torch.arange(
            C, device=src.device)[None, :]).reshape(-1).to(torch.int32)
        for my, st in enumerate(locs):
            ver = st.global_version + 1
            g, tgt = grants[my], news[my]
            # ---- install on the receiver ------------------------------
            masked_set_(st.vectors, tgt, pay["vectors"], g)
            masked_set_(st.ids, tgt, pay["ids"], g)
            masked_set_(st.slot_valid, tgt, sv_b, g)
            masked_set_(st.used, tgt, pay["used"], g)
            masked_set_(st.lengths, tgt, pay["lengths"], g)
            masked_set_(st.centroids, tgt, pay["centroids"], g)
            masked_set_(st.nbrs, tgt, -1, g)
            masked_set_(st.codes, tgt, codes_b, g)
            masked_set_(st.pq_posting_slot, tgt, pay["pq_posting_slot"], g)
            masked_set_(st.heat, tgt, pay["heat"], g)
            masked_set_(st.tier_spilled, tgt, sp_b, g)
            masked_set_(st.rec_meta, tgt, vm.pack_meta(STATUS_NORMAL, ver),
                        g)
            masked_set_(st.rec_succ, tgt, (NO_SUCC << 16) | NO_SUCC, g)
            masked_set_(st.allocated, tgt, True, g)
            # ---- donor retirement (no successors) ---------------------
            retire = donates[my] & migrated
            gone = torch.where(retire, sls[my], -1)
            st.rec_meta = vm.transition(st.rec_meta, gone, STATUS_DELETED,
                                        ver.expand((B,)))
            st.rec_succ = vm.set_successors(st.rec_succ, gone, -1, -1)
            masked_set_(st.tier_spilled, sls[my], False, retire)
            # ---- the replicated id map: one rewrite on every shard ----
            masked_set_(st.id_loc, ids_flat.to(torch.int64).clamp(
                0, cfg.max_ids - 1), new_flat, live_flat)
            st.free_top = torch.zeros_like(st.free_top)
            st.global_version = ver
            sh.store(my, st)
        return sh, migrated, new_global.to(torch.int32)

    return run


def make_sharded_exact(cfg: UBISConfig, mesh: Mesh, k: int):
    """The exact top-k oracle over the sharded live contents: (sh,
    queries) -> (ids, scores), the sharded form of ``search.brute_force``.
    Each shard scans every slot it owns (slot validity, visibility, not
    spilled) and its 1/S slice of the cache, takes a local top-k of its
    own id rows, and one gather + merge gives the global result.  The
    caller chunks the queries: a shard's score block is Q x (M_local * C
    + its cache slice)."""

    def run(sh: ShardedState, queries: torch.Tensor):
        S = sh.n_shards
        queries = queries.to(torch.float32)
        s_parts, i_parts = [], []
        for my in range(S):
            st = sh.local(my)
            vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
            valid = st.slot_valid & (vis & ~st.tier_spilled)[:, None]
            s = ops.posting_scan(queries, st.vectors, valid)
            cvs, cval_own, cid = _owned_cache_slice(st, my, S)
            cs = ops.centroid_score(queries, cvs, cval_own)
            scores = torch.cat([s, cs], dim=1)
            del s, cs
            flat = torch.cat([st.ids.reshape(-1), cid])
            top, idx = stable_topk(scores, min(k, scores.shape[1]))
            del scores
            s_parts.append(top)
            i_parts.append(flat[idx])
        sf, idf = _local_topk(all_gather(s_parts, 1), all_gather(i_parts, 1),
                              k)
        return torch.where(sf < BIG / 2, idf, -1), sf

    return run
