"""Host orchestration for the sharded index: the distributed driver.

``ShardedUBISDriver`` presents the same ``StreamingIndex`` API as the
single-device ``UBISDriver``, with every data-plane call dispatched to
the sharded programs of ``core/sharded.py`` over the mesh's S logical
shards (``distributed/sharding.py``):

  * **insert** — padded job rounds through ``make_sharded_insert``; the
    per-job accepted mask drives the retry-with-a-tick-between loop, and
    jobs still rejected after the retries park in the **host-mediated
    vector cache** (below);
  * **delete** — ``make_sharded_delete`` rounds (owner-shard tombstones,
    replicated id-map/cache updates);
  * **search** — ``make_sharded_search`` per (k, nprobe), queries padded
    to the data rows' multiple and split over the rows, one contiguous
    block a row;
  * **tick**  — ONE ``make_sharded_background`` call (per-shard select →
    mark → execute → epoch GC, reporting per-shard pressure rows), then
    the **cross-shard rebalance** stage, then the host cache drain, then
    the PQ codebook re-train on cadence.

**Cross-shard rebalance.**  Structural ownership makes every background
op shard-local, so a skewed stream can saturate one shard's sub-pool
(splits defer until epoch GC frees a local slot, inserts park in the
cache) while cold shards sit on free capacity; with contiguous pid
seeding a fresh index even starts with every posting on shard 0.  The
tick's pressure rows feed ``rebalance.RebalancePlanner``; when a shard
crosses the saturation watermark (or the live-vector spread exceeds
``rebalance_ratio``), the planner picks donor → receiver posting moves
and ONE ``make_sharded_migrate`` round executes them.

**Host-mediated vector cache.**  The cache arrays are replicated, so no
shard writes them inside the insert and background programs.  The host
decides which jobs park and runs ``update.cache_append`` on the global
view, then broadcasts the replicas.  Cached entries stay searchable and
deletable; each tick drains up to ``drain_per_tick`` of them back through
the sharded insert round.

**Snapshot contract.**  The sharded rounds leave the free stack fail-safe
EMPTY; ``snapshot()`` copies the global view and passes it through
``update.ensure_free_stack``, which rebuilds the canonical stack and
checks it.

**Devices.**  The mesh is a grid of D data rows by S ``model`` shards,
and cell (r, s) lives on ``mesh.row_devices(r)[s]``: ``default_mesh``
puts one cell on each card of the process (the JAX rule's (n // m, m)),
``make_mesh(..., devices=[...])`` names them row-major, ``make_mesh(...,
device=d)`` puts every cell on ``d``.  Every row holds a whole replica
of the index: an update program runs on every row, in row order, and
the driver takes row 0's outputs; a search splits its batch over the
rows; ``exact`` runs on row 0.  The driver's own work (the final merges,
the host reads, the cold tier's planning) runs on the controller, cell
(0, 0)'s device.  Code that works on the whole index reads row 0
through the global view (``ShardedState.gather`` / ``scatter``, or the
field-by-field ``GlobalView`` that ``state`` returns) and writes every
row through it; the replicated fields it needs (the id map, the cache,
the version) are read from row 0's shard 0's replica.

Like ``UBISDriver`` it runs on the card unless the caller passes
``device="cpu"`` (or a mesh on the CPU), and takes its random draws as
arguments: ``kmeans_init``, ``pq_init`` and ``pq_keys`` (see
``UBISDriver``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core import tier as tier_mod, update
from ..core import version_manager as vm
from ..core.build import initial_state
from ..core.driver import (EXACT_CHUNK_FLOATS, GC_LAG, INSERT_RETRIES,
                           PQ_SEED_OFFSET, SearchDispatch, draw_kmeans_init,
                           draw_pq_init, resolve_device)
from ..core.sharded import (GlobalView, ShardedState, check_replicas,
                            make_sharded_background, make_sharded_delete,
                            make_sharded_exact, make_sharded_insert,
                            make_sharded_migrate, make_sharded_search)
from ..core.types import STATUS_NORMAL, IndexState, UBISConfig, tile_bytes
from ..distributed.sharding import Mesh, check_device, default_mesh
from ..obs import Obs
from .rebalance import RebalancePlanner
from .types import SearchResult, TickReport, UpdateResult


class ShardedUBISDriver:
    """Streaming driver over a sharded index (a ``StreamingIndex``).

    ``mesh``: a ``distributed.sharding.Mesh`` (default
    ``default_mesh(cfg, device)``: one cell a card); its controller
    (cell (0, 0)'s device) is the driver's ``device``.  The other
    knobs are the JAX package's, and ``device``, ``kmeans_init``,
    ``pq_init`` and ``pq_keys`` are ``UBISDriver``'s."""

    def __init__(self, cfg: UBISConfig, seed_vectors=None, *,
                 mesh: Optional[Mesh] = None, seed: int = 0,
                 round_size: int = 1024, bg_ops_per_round: int = 8,
                 drain_per_tick: int = 256,
                 insert_retries: int = INSERT_RETRIES,
                 gc_lag: int = GC_LAG, reassign_after_split: bool = True,
                 pq_retrain_every: int = 32,
                 shard_cache_scan: bool = True,
                 rebalance: bool = True,
                 rebalance_watermark: float = 0.85,
                 rebalance_ratio: float = 1.2,
                 migrate_per_tick: int = 8,
                 route_alpha: float = 0.0,
                 tier_moves_per_tick: int = 32,
                 tier_rerank_host: bool = True,
                 tier_async: bool = False,
                 device=None, kmeans_init=None, pq_init=None, pq_keys=None,
                 obs: Optional[Obs] = None,
                 obs_profile_dir: Optional[str] = None):
        if not cfg.is_ubis:
            raise ValueError("ShardedUBISDriver is UBIS-mode only "
                             "(SPFresh's lock model is single-device)")
        if seed_vectors is None:
            raise ValueError("seed_vectors required (used for k-means seeds)")
        self.cfg = cfg
        if mesh is None:
            mesh = default_mesh(cfg, device)
        elif (device is not None
              and check_device(resolve_device(device)) != mesh.device):
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.device = mesh.device
        if cfg.max_postings % self.mesh.shape["model"]:
            raise ValueError("max_postings must divide the model axis")
        self.round_size = int(round_size)
        self.bg_ops = int(bg_ops_per_round)
        self.drain_n = int(drain_per_tick)
        self.retries = int(insert_retries)
        self.gc_lag = int(gc_lag)
        self.pq_retrain_every = int(pq_retrain_every)
        self._ticks = 0
        self.obs = obs if obs is not None else Obs()
        self.stats = self.obs.driver_stats()
        self._profile_dir = obs_profile_dir
        self._profiled = False

        seeds = torch.as_tensor(np.asarray(seed_vectors, np.float32),
                                device=self.device)
        if kmeans_init is None:
            kmeans_init = draw_kmeans_init(cfg, seeds.shape[0], seed)
        init = torch.as_tensor(np.array(kmeans_init), device=self.device)
        pq_idx = None
        if cfg.use_pq:
            if pq_init is None:
                pq_init = draw_pq_init(cfg, seeds.shape[0], seed)
            pq_idx = torch.as_tensor(np.array(pq_init), device=self.device)
        self._sh = ShardedState(initial_state(cfg, seeds, init, pq_idx),
                                self.mesh)
        self._pq_keys = None if pq_keys is None else iter(pq_keys)
        self._pq_gen = None
        if cfg.use_pq and pq_keys is None:
            self._pq_gen = torch.Generator(device=self.device)
            self._pq_gen.manual_seed(int(seed) + PQ_SEED_OFFSET)

        # cold-tier plane (cfg.use_tier): host pool + planner on the
        # global view; per-shard accounting rides on contiguous pid blocks
        self.tier = (tier_mod.TierManager(
            cfg, self.device, max_moves=int(tier_moves_per_tick),
            rerank_host=tier_rerank_host, obs=self.obs)
            if cfg.use_tier else None)
        self.tier_async = bool(tier_async)
        self._insert_fn = make_sharded_insert(cfg, self.mesh,
                                              route_alpha=float(route_alpha))
        self._delete_fn = make_sharded_delete(cfg, self.mesh)
        self._background_fn = make_sharded_background(
            cfg, self.mesh, bg_ops=self.bg_ops,
            reassign=reassign_after_split)
        # cross-shard rebalance: host planner + one migrate round
        self.n_shards = int(self.mesh.shape["model"])
        self.rebalance = bool(rebalance) and self.n_shards > 1
        self._pressure = None
        self.planner = RebalancePlanner(
            self.n_shards, cfg.max_postings // self.n_shards,
            watermark=rebalance_watermark, ratio_target=rebalance_ratio,
            max_moves=int(migrate_per_tick), min_gap=cfg.l_max)
        # built for every multi-shard mesh, so toggling ``self.rebalance``
        # after construction (figskew's on/off comparison) still works
        self._migrate_jobs = int(migrate_per_tick)
        if self.n_shards > 1:
            self._migrate_fn = make_sharded_migrate(
                cfg, self.mesh, jobs=self._migrate_jobs)
        self._shard_cache_scan = shard_cache_scan
        self._search_fns = {}
        self._exact_fns = {}
        # queries split over the data rows: batches pad to this multiple
        self._q_mult = self.mesh.n_rows

    # ---- the global view ----------------------------------------------

    @property
    def state(self) -> GlobalView:
        """The global view of the index: a sharded field read gathers it
        onto the controller, a replicated field is shard 0's replica
        (``core.sharded.GlobalView``)."""
        return self._sh.state

    @state.setter
    def state(self, state: IndexState) -> None:
        self._sh = ShardedState(state, self.mesh)

    @property
    def sharded(self) -> ShardedState:
        """The index as D rows of S shards (``ShardedState.rows``)."""
        return self._sh

    def check_replicas(self) -> None:
        """Raise ``AssertionError`` unless every shard's replicas equal
        shard 0's and every row equals row 0 (``core.sharded.
        check_replicas``)."""
        check_replicas(self._sh)

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _sync(self) -> None:
        for d in dict.fromkeys(self.mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ------------------------------------------------------------------
    # foreground
    # ------------------------------------------------------------------

    def insert(self, vecs, ids, *, tick_between: bool = True) -> UpdateResult:
        """Stream (vecs, ids) through padded sharded insert rounds.
        Rejected jobs retry up to ``insert_retries`` times with a
        background tick in between; survivors park in the host-mediated
        cache, and only overflow beyond the cache is reported rejected."""
        vecs = np.asarray(vecs, np.float32)
        ids = np.asarray(ids, np.int64).astype(np.int32)
        if len(vecs) != len(ids):
            raise ValueError(f"vecs/ids length mismatch: {len(vecs)} vs "
                             f"{len(ids)}")
        if ids.size and (ids.min() < 0 or ids.max() >= self.cfg.max_ids):
            raise ValueError("ids out of range for cfg.max_ids")
        t0 = time.perf_counter()
        n_acc = 0
        pending, rej_t = (vecs, ids), None
        for _ in range(self.retries + 1):
            acc, rej_v, rej_i, rej_t = self._insert_rounds(*pending)
            n_acc += acc
            if rej_i is None:
                pending = None
                break
            pending = (rej_v, rej_i)
            if tick_between:
                self.tick()
        n_cache = n_rej = 0
        if pending is not None:
            n_cache = self._cache_put(*pending, targets=rej_t)
            n_rej = len(pending[1]) - n_cache
        self._sync()
        dt = time.perf_counter() - t0
        self.stats["insert_time"] += dt
        self.stats["inserted"] += n_acc + n_cache
        self.stats["rejected"] += n_rej
        self.obs.emit("insert", accepted=n_acc, cached=n_cache,
                      rejected=n_rej, seconds=round(dt, 6))
        return UpdateResult(accepted=n_acc, cached=n_cache, rejected=n_rej,
                            seconds=dt)

    def _insert_rounds(self, vecs, ids):
        """One pass of padded sharded insert rounds.  Returns (n_accepted,
        rej_vecs | None, rej_ids | None, rej_targets | None); a rejected
        job's target is the global pid it was routed to (-1 if nothing
        was insertable), so the pressure stats attribute the parked
        backlog to its shard."""
        J = self.round_size
        n_acc = 0
        rej_v, rej_i, rej_t = [], [], []
        for off in range(0, len(ids), J):
            cv, ci = vecs[off:off + J], ids[off:off + J]
            n = len(ci)
            pad = J - n
            valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
            cv = np.concatenate([cv, np.zeros((pad, self.cfg.dim),
                                              np.float32)])
            ci = np.concatenate([ci, np.zeros(pad, np.int32)])
            _, accm, routed = self._insert_fn(
                self._sh, self._dev(cv), self._dev(ci), self._dev(valid))
            accm = accm.cpu().numpy()[:n]
            routed = routed.cpu().numpy()[:n]
            n_acc += int(accm.sum())
            if self.tier is not None:       # appends heat their target
                self.tier.note_targets(routed[accm])
            if not accm.all():
                rej_v.append(cv[:n][~accm])
                rej_i.append(ci[:n][~accm])
                rej_t.append(routed[~accm])
        if not rej_i:
            return n_acc, None, None, None
        return (n_acc, np.concatenate(rej_v), np.concatenate(rej_i),
                np.concatenate(rej_t))

    def delete(self, ids) -> UpdateResult:
        ids = np.asarray(ids, np.int64).astype(np.int32)
        t0 = time.perf_counter()
        J = self.round_size
        n_done = 0
        for off in range(0, len(ids), J):
            ci = ids[off:off + J]
            pad = J - len(ci)
            valid = np.concatenate([np.ones(len(ci), bool),
                                    np.zeros(pad, bool)])
            ci = np.concatenate([ci, np.zeros(pad, np.int32)])
            _, done = self._delete_fn(self._sh, self._dev(ci),
                                      self._dev(valid))
            n_done += int(done.sum())
        self._sync()
        dt = time.perf_counter() - t0
        self.stats["delete_time"] += dt
        self.stats["deleted"] += n_done
        self.obs.emit("delete", deleted=n_done, blocked=0,
                      seconds=round(dt, 6))
        return UpdateResult(deleted=n_done, seconds=dt)

    def search(self, queries, k: int,
               nprobe: Optional[int] = None) -> SearchResult:
        return self.collect_search(self.dispatch_search(queries, k, nprobe))

    def dispatch_search(self, queries, k: int,
                        nprobe: Optional[int] = None) -> SearchDispatch:
        """Launch the sharded search without waiting for the device; pair
        with ``collect_search``.  With the cold tier the found ids'
        locations and the spill flags are captured at dispatch (the
        rounds update the state in place)."""
        q = np.asarray(queries, np.float32)
        t0 = time.perf_counter()
        # cold tier + host rerank: widen the final candidate set to
        # rerank_k so the exact host pass has room to reorder
        k_eff = (max(k, self.cfg.rerank_k)
                 if self.tier is not None and self.tier.rerank_host else k)
        key = (k_eff, nprobe)
        fn = self._search_fns.get(key)
        if fn is None:
            fn = self._search_fns[key] = make_sharded_search(
                self.cfg, self.mesh, k=k_eff, nprobe=nprobe,
                shard_cache_scan=self._shard_cache_scan)
        qp = q
        pad = (-q.shape[0]) % self._q_mult
        if pad:
            qp = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
        found, scores = fn(self._sh, self._dev(qp))
        disp = SearchDispatch(queries=q, k=k, found=found, scores=scores,
                              probe=None, t0=t0)
        if self.tier is not None:
            disp.loc = self.state.id_loc[
                found[:q.shape[0]].long().clamp(0, self.cfg.max_ids - 1)]
            disp.spilled = self.state.tier_spilled      # a gathered copy
        return disp

    def collect_search(self, disp: SearchDispatch) -> SearchResult:
        """Await a dispatched sharded search and finish the host tail
        against the dispatch-time state."""
        Q = disp.queries.shape[0]
        found = disp.found.cpu().numpy()[:Q]
        scores = disp.scores.cpu().numpy()[:Q]
        if self.tier is not None:
            # search-heat: the postings holding the found candidates (the
            # sharded search exports no probe list)
            loc = disp.loc.cpu().numpy()
            pid = loc[(found >= 0) & (loc >= 0)] // self.cfg.capacity
            self.tier.note_probes(pid)
            found, scores, n_sp = self.tier.rerank(
                disp.queries, found, scores, loc, disp.spilled.cpu().numpy())
            self.stats["search_spilled_hits"] += n_sp
            found, scores = found[:, :disp.k], scores[:, :disp.k]
        dt = time.perf_counter() - disp.t0
        self.stats["search_time"] += dt
        self.stats["queries"] += Q
        self.stats["search_results"] += int((found >= 0).sum())
        if self.cfg.use_pq:
            self.stats["search_adc_batches"] += 1
        else:
            self.stats["search_exact_batches"] += 1
        return SearchResult(ids=found, scores=scores, seconds=dt)

    # ------------------------------------------------------------------
    # background
    # ------------------------------------------------------------------

    def tick(self) -> TickReport:
        """One background round: the sharded select/mark/execute/GC
        program (which also reports per-shard pressure), then the
        cross-shard rebalance stage, then the host cache drain, then the
        PQ re-train on cadence."""
        if self._profile_dir and not self._profiled:
            self._profiled = True
            with self.obs.profile(self._profile_dir):
                return self._tick_impl()
        return self._tick_impl()

    def _tick_impl(self) -> TickReport:
        t0 = time.perf_counter()
        plan = None
        if self.tier is not None and self.tier_async:
            # tick-start dispatch: the copies overlap the background
            # program; reconcile commits at tick end (decayed=True: the
            # sharded round decays every tick)
            _, plan = self.tier.dispatch(self.state, decayed=True)
            self._sh.replicate()
        executed, reclaimed, _ = self.exec_background()
        migrated = self._rebalance() if self.rebalance else 0
        drained = self.exec_drain()
        retrained = self._pq_retrain()
        if self.tier is not None and self.tier_async:
            _, n_s, n_p = self.tier.reconcile(self.state, plan)
            self._sh.replicate()
            self._note_tier(n_s, n_p)
            spilled, promoted = n_s, n_p
        else:
            spilled, promoted = self._tier_step()
        dt = time.perf_counter() - t0
        self.stats["bg_time"] += dt
        self.stats["drained"] += drained
        self.obs.emit("tick", executed=executed, drained=drained,
                      migrated=migrated, gc=reclaimed, pq=retrained,
                      spilled=spilled, promoted=promoted,
                      seconds=round(dt, 6))
        # marked=0: the sharded round selects and executes in ONE program,
        # so quiescence is executed == 0 (and an empty cache)
        return TickReport(executed=executed, drained=drained,
                          migrated=migrated, gc=reclaimed,
                          pq_retrained=retrained, spilled=spilled,
                          promoted=promoted, seconds=dt)

    def flush(self, max_ticks: int = 200) -> int:
        """Tick until quiescent (no structural work, no migrations left
        to plan, cache empty, no tier moves).  Returns the ticks run."""
        for i in range(max_ticks):
            r = self.tick()
            cache_n = int(self.state.cache_valid.sum())
            if (r.executed == 0 and r.migrated == 0 and cache_n == 0
                    and r.spilled == 0 and r.promoted == 0):
                return i + 1
        return max_ticks

    # ---- plan/execute halves (the coordinator/worker seam) ------------

    def exec_background(self):
        """Run ONE sharded background program (select/mark/execute/GC)
        and record the pressure rows.  Returns (executed, reclaimed,
        pressure)."""
        t0 = time.perf_counter()
        ver = int(self.state.global_version)
        gc_min = ver - self.gc_lag if ver > self.gc_lag else 0
        _, ex, gc, press = self._background_fn(self._sh, gc_min)
        executed, reclaimed = int(ex), int(gc)
        self._pressure = press.cpu().numpy()
        self.stats["bg_exec_time"] += time.perf_counter() - t0
        self.stats["bg_ops"] += executed
        self.stats["bg_gc"] += reclaimed
        return executed, reclaimed, self._pressure

    def rebalance_inputs(self):
        """The migrate planner's (M,)-sized observation: live lengths plus
        the movable mask (allocated NORMAL postings), as numpy."""
        st = self.state
        lengths = st.lengths.cpu().numpy()
        status = vm.unpack_status(st.rec_meta).cpu().numpy()
        movable = st.allocated.cpu().numpy() & (status == STATUS_NORMAL)
        return lengths, movable

    def exec_migrate(self, src, dst) -> np.ndarray:
        """Execute one already-planned migration round (owner extract,
        free-stack install, id-map rewrite, tier-pool remap).  Returns
        the per-move committed mask."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        B = self._migrate_jobs
        n = len(src)
        pad = B - n
        valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
        src = np.concatenate([src, np.full(pad, -1, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        _, mig, new_pids = self._migrate_fn(
            self._sh, self._dev(src), self._dev(dst), self._dev(valid))
        mig = mig.cpu().numpy()[:n]
        if self.tier is not None:
            # spilled postings migrate WITHOUT promotion: the device round
            # carried codes and flags, the host pool entry follows
            new_pids = new_pids.cpu().numpy()
            for j in np.flatnonzero(mig):
                if int(src[j]) in self.tier.pool:
                    self.tier.pool.remap(int(src[j]), int(new_pids[j]))
        self.stats["migrated"] += int(mig.sum())
        return mig

    def _rebalance(self) -> int:
        """Plan + execute one migration round when the tick's pressure
        rows cross a trigger; the planner's cheap ``needs`` gate keeps
        quiescent ticks free of the (M,)-sized host reads."""
        press = self._pressure
        if press is None or not self.planner.needs(press):
            return 0
        lengths, movable = self.rebalance_inputs()
        src, dst = self.planner.plan(press, lengths, movable)
        if len(src) == 0:
            return 0
        mig = self.exec_migrate(src, dst)
        n = int(mig.sum())
        self.obs.emit(
            "rebalance",
            trigger=(self.planner.last_moves[0]["trigger"]
                     if self.planner.last_moves else "none"),
            moves=[{**mv, "committed": bool(mig[j])}
                   for j, mv in enumerate(self.planner.last_moves)],
            migrated=n)
        return n

    def shard_pressure(self) -> Optional[np.ndarray]:
        """Last tick's (S, 4) pressure rows, ``(live_postings, free_slots,
        cache_backlog, live_vectors)`` per shard, or None before the
        first tick."""
        return self._pressure

    def shard_occupancy(self) -> np.ndarray:
        """Live vectors per posting-pool shard, computed now (no tick
        required): the ``figskew`` spread metric, each shard read on its
        own device."""
        from ..core.metrics import live_vectors
        return np.array([live_vectors(st).sum() for st in self._sh.shards])

    # ---- host-mediated vector cache -----------------------------------

    def _cache_put(self, vecs, ids, targets=None) -> int:
        """Park jobs in the replicated cache: ``update.cache_append`` on
        the global view per chunk, then the replicas follow (id_loc takes
        the ``-2 - slot`` encoding, so the entries stay searchable and
        deletable).  ``targets``: the routed global pid per job, the
        pressure stats' backlog attribution (-1 when unknown)."""
        vecs = np.asarray(vecs, np.float32)
        ids = np.asarray(ids, np.int32)
        tgts = (np.full(len(ids), -1, np.int32) if targets is None
                else np.asarray(targets, np.int32))
        J = self.round_size
        n = 0
        for off in range(0, len(ids), J):
            cv, ci, ct = (vecs[off:off + J], ids[off:off + J],
                          tgts[off:off + J])
            pad = J - len(ci)
            want = np.concatenate([np.ones(len(ci), bool),
                                   np.zeros(pad, bool)])
            cv = np.concatenate([cv, np.zeros((pad, self.cfg.dim),
                                              np.float32)])
            ci = np.concatenate([ci, np.zeros(pad, np.int32)])
            ct = np.concatenate([ct, np.full(pad, -1, np.int32)])
            _, ok = update.cache_append(self.state, self.cfg, self._dev(cv),
                                        self._dev(ci), self._dev(ct),
                                        self._dev(want))
            self._sh.replicate()
            got = int(ok.sum())
            n += got
            if got < int(want.sum()):
                break                       # cache full: the rest rejected
        self.stats["host_cached"] += n
        return n

    def _drain_cache(self) -> int:
        """Pop up to ``drain_per_tick`` cached vectors and feed them back
        through the sharded insert round; failures re-park."""
        cval = self.state.cache_valid.cpu().numpy().copy()
        slots = np.flatnonzero(cval)[:self.drain_n]
        if slots.size == 0:
            return 0
        idx = self._dev(slots.astype(np.int64))
        vecs = self.state.cache_vecs[idx].float().cpu().numpy()
        ids = self.state.cache_ids[idx].cpu().numpy()
        cval[slots] = False
        self.state.cache_valid = self._dev(cval)
        self._sh.replicate()
        n_acc, rej_v, rej_i, rej_t = self._insert_rounds(vecs, ids)
        if rej_i is not None:
            self._cache_put(rej_v, rej_i, targets=rej_t)
        return n_acc

    # the public plan/execute name for the cluster worker (the same op)
    exec_drain = _drain_cache

    def _pq_retrain(self) -> int:
        """Versioned codebook re-train on tick cadence (quant plane): the
        cadence half; execution is ``exec_pq_retrain``."""
        if not self.cfg.use_pq or self.pq_retrain_every <= 0:
            return 0
        self._ticks += 1
        if self._ticks % self.pq_retrain_every:
            return 0
        return self.exec_pq_retrain()

    def exec_pq_retrain(self) -> int:
        """Execute one codebook re-train round now, on the whole index
        gathered onto the controller (it reads every pool slot), then
        scattered back; the replicas follow."""
        from ..quant import pq
        if self.tier is not None:
            # promote the spilled postings pinned to the evicted slot first
            _, n = self.tier.promote_retrain_pinned(self.state)
            self.stats["tier_promoted"] += n
        st = self._sh.gather()
        M, C, _ = st.vectors.shape
        if self._pq_keys is not None:
            keys = self._dev(np.array(next(self._pq_keys), np.float32))
        else:
            keys = torch.rand((M * C,), generator=self._pq_gen,
                              device=self.device)
        evict = (int(st.pq_active) + 1) % self.cfg.pq_versions
        pq.retrain_round(st, self.cfg, keys)
        self._sh.scatter(st)
        self._sh.replicate()
        self.stats["pq_retrains"] += 1
        self.stats["pq_generation"] = int(
            st.pq_slot_gen[st.pq_active.long()])
        self.obs.emit("pq_retrain", reason="cadence", evicted_slot=evict,
                      generation=int(self.stats["pq_generation"]))
        return 1

    # ---- cold-tier plane ----------------------------------------------

    def _note_tier(self, spilled: int, promoted: int) -> None:
        self.stats["tier_spilled"] += spilled
        self.stats["tier_promoted"] += promoted
        self.stats["tier_resident"] = len(self.tier.pool)

    def _tier_step(self) -> tuple:
        """Spill/promote planning + moves on the global view (decayed:
        the sharded background program decays the heat every tick)."""
        if self.tier is None:
            return 0, 0
        _, n_s, n_p = self.tier.tick(self.state, decayed=True)
        self._sh.replicate()
        self._note_tier(n_s, n_p)
        return n_s, n_p

    def force_spill(self, n: int) -> int:
        """Spill the ``n`` coldest hot postings now (test hook)."""
        if self.tier is None:
            return 0
        _, moved = self.tier.force_spill(self.state, n)
        self._sh.replicate()
        self._note_tier(moved, 0)
        return moved

    def force_promote(self, n=None) -> int:
        """Promote up to ``n`` spilled postings (all when None)."""
        if self.tier is None:
            return 0
        _, moved = self.tier.force_promote(self.state, n)
        self._sh.replicate()
        self._note_tier(0, moved)
        return moved

    def tier_host_bytes_by_shard(self) -> np.ndarray:
        """Host-pool bytes per shard (contiguous pid blocks)."""
        out = np.zeros(self.n_shards, np.int64)
        if self.tier is not None:
            pool_span = self.cfg.max_postings // self.n_shards
            tb = tile_bytes(self._sh.shards[0])
            for pid in self.tier.pool.pids():
                out[int(pid) // pool_span] += tb
        return out

    # ---- StreamingIndex protocol surface ------------------------------

    def snapshot(self) -> IndexState:
        """A copy of the global view with a canonical free stack
        (``update.ensure_free_stack`` checks it: the sharded rounds leave
        a fail-safe EMPTY stack).  With the cold tier the spilled float
        tiles are written into the copy (flags stay set)."""
        snap = self._sh.gather()
        if self.tier is not None:
            snap = self.tier.snapshot_fill(snap)
        return update.ensure_free_stack(snap)

    def load_snapshot(self, state) -> "ShardedUBISDriver":
        """Adopt a ``snapshot()`` state: an ``IndexState`` (laid out over
        this driver's shards) or a ``ShardedState`` on this driver's mesh
        (a checkpoint restored onto ``drv.sharded``, taken as it is).
        Tier residency is re-derived from the persisted flags.  Returns
        self."""
        if isinstance(state, ShardedState):
            if state.mesh.devices != self.mesh.devices or \
                    state.n_shards != self.n_shards:
                raise ValueError("the sharded state lives on another mesh")
            if self.tier is not None:
                self.tier.adopt(state.state)
            self._sh = state
            return self
        if self.tier is not None:
            state = self.tier.adopt(state)
        self.state = state
        return self

    def memory_bytes(self) -> int:
        """Bytes of the index across both tiers (the replicas beyond the
        first are not counted, as the reference counts the global
        arrays)."""
        return self._sh.memory_bytes()

    def memory_tiers(self) -> dict:
        """Device/host byte split; sums to ``memory_bytes()``."""
        total = self.memory_bytes()
        if self.tier is None:
            return {"device": total, "host": 0}
        host = int(self.state.tier_spilled.sum()) * tile_bytes(
            self._sh.shards[0])
        return {"device": total - host, "host": host}

    def exact(self, queries, k: int) -> SearchResult:
        """Exact top-k over live contents (recall oracle): the sharded
        brute force (``make_sharded_exact``, on row 0), in query chunks
        that keep each shard's score block near 1 GiB.  With the cold
        tier the host-pool scan of the spilled postings is merged on
        top."""
        fn = self._exact_fns.get(k)
        if fn is None:
            fn = self._exact_fns[k] = make_sharded_exact(self.cfg, self.mesh,
                                                         k)
        queries = np.asarray(queries, np.float32)
        S = self.n_shards
        width = (self._sh.pool * self.cfg.capacity
                 + -(-self.cfg.cache_capacity // S))
        chunk = max(1, EXACT_CHUNK_FLOATS // width)
        ids, scores = [], []
        for off in range(0, len(queries), chunk):
            f, s = fn(self._sh, self._dev(queries[off:off + chunk]))
            ids.append(f.cpu().numpy())
            scores.append(s.cpu().numpy())
        found, scores = np.concatenate(ids), np.concatenate(scores)
        if self.tier is not None:
            found, scores = self.tier.exact_merge(self.state, queries,
                                                  found, scores, k)
        return SearchResult(ids=found, scores=scores)

    def posting_lengths(self) -> np.ndarray:
        from ..core.metrics import live_posting_lengths
        return live_posting_lengths(self.state)

    def live_count(self) -> int:
        """Vectors in visible postings + the (replicated) cache."""
        return int(self.state.live_vector_count()) + int(
            self.state.cache_valid.sum())

    def throughput(self) -> dict:
        from ..core.metrics import throughput_from_stats
        return throughput_from_stats(self.stats)

    def close(self) -> None:
        """Release the cold tier's host pool and copy stream (its pinned
        memory).  The index must not be used afterwards."""
        self.tier = None
