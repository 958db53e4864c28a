"""The cluster coordinator: every planner, no device state.

``ClusterCoordinator`` is a full ``StreamingIndex`` whose data plane
lives in N workers (``cluster.worker``) behind a pluggable transport
(``cluster.backend``).  The coordinator owns every host-side decision —
the per-worker ``RebalancePlanner`` and ``TierPlanner``, the PQ retrain
cadence counter, insert routing, and the cross-worker spread balance —
and drives workers through the serializable command protocol
(``cluster.protocol``).

**The tick** is three legs per worker, preserving the in-process
``ShardedUBISDriver._tick_impl`` mutation order exactly:

  1. ``tick_begin``  — worker runs the sharded background program and
     ships pressure rows up; the coordinator's rebalance planner gates
     (``needs``) and, when tripped, pulls plan inputs and plans moves;
  2. ``tick_exec``   — migrate moves + cache drain + (cadence-granted)
     PQ retrain execute; the tier observation rows ship up and the
     coordinator's ``plan_tier_moves`` picks spill/promote lanes;
  3. ``tick_end``    — the lanes dispatch + reconcile under staleness
     signatures; commits, cache backlog, and live counts ship up.

With ``workers=1`` on the ``LocalBackend`` this is **bit-identical** to
``ShardedUBISDriver`` on the same seeded interleaving (the codec is
lossless and the planners see byte-identical observations in the same
order); ``tests/test_torch_cluster.py`` holds it, and holds this
coordinator to the JAX package's on the same streams.

**Multi-worker layout**: each worker owns ``max_postings / N`` postings
over the FULL id space; inserts route by least-loaded water-filling
(:func:`plan_insert_split`), deletes broadcast, searches fan out and
merge by score.  When worker live counts drift past ``spread_ratio``,
the coordinator moves vectors donor→receiver through the ``extract`` /
``insert_rounds`` pair (one logical migration — the live multiset is
conserved, traced as a ``rebalance`` event with trigger
``worker-spread``).

**Failure plane**: every RPC feeds the backend's per-worker straggler
monitor (``worker_slow`` events); a :class:`~.backend.WorkerLost`
triggers restart → re-init → (checkpoint base ``load_state``) → journal
replay → ``worker_restarted`` event → one retry of the failed command.
The journal records every state-mutating command since the last
checkpoint; ``checkpoint()`` writes per-worker snapshots plus the
digest-carrying manifest (``checkpoint.manager``) and resets the
journals.  Caveats (documented, test-pinned): replay is command-level
deterministic, but search-heat (``note_probes``) is advisory and not
journaled, and delivery is at-least-once — a worker that dies *inside*
a command may replay it twice; the tests kill between commands.

**The port's additions.**  ``device`` (the card unless ``"cpu"``) goes
to every worker's ``init``; the coordinator itself holds no tensor, and
``snapshot()`` returns CPU states.  The random draws of the single-device
drivers (``kmeans_init``, ``pq_init``, ``pq_keys``) are injectable per
worker: with ``workers=1`` each is one draw as for ``ubis-sharded``; with
W > 1 each is a list of W draws, worker w's for its k-means over
``seed_vectors[w::W]`` under its own ``max_postings / W`` config.  They
ride in ``init``, so a restarted worker replays them too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np

from ..api.rebalance import RebalancePlanner
from ..api.types import SearchResult, TickReport, UpdateResult
from ..core.driver import resolve_device
from ..core.tier import TierPlanner, plan_tier_moves
from ..core.types import UBISConfig
from ..obs import Obs
from . import protocol
from .backend import (ClusterBackend, LocalBackend, MultiProcessBackend,
                      WorkerLost)

#: commands that mutate worker state — exactly these are journaled for
#: restart replay (reads and searches are not; see module docstring)
MUTATING = frozenset({
    "insert_rounds", "cache_put", "delete", "tick_begin", "tick_exec",
    "tick_end", "force_spill", "force_promote", "extract"})


def plan_insert_split(live, n: int) -> np.ndarray:
    """Water-filling insert routing: give each of ``n`` new vectors to
    the currently-least-loaded worker.  Deterministic (ties break by
    worker index) and closed-form — no per-vector loop."""
    live = np.asarray(live, np.int64).astype(np.float64)
    counts = np.zeros(len(live), np.int64)
    remaining = int(n)
    lv = live.copy()
    while remaining > 0:
        m = lv.min()
        cand = np.flatnonzero(lv == m)
        higher = lv[lv > m]
        gap = int(higher.min() - m) if higher.size else remaining
        take = min(remaining, max(gap, 1) * len(cand))
        q, r = divmod(take, len(cand))
        add = np.full(len(cand), q, np.int64)
        add[:r] += 1
        counts[cand] += add
        lv[cand] += add
        remaining -= take
    return counts


@dataclasses.dataclass
class ClusterSnapshot:
    """A multi-worker snapshot: one self-contained ``IndexState`` per
    worker plus the combined live-multiset digest."""

    states: list
    digests: list

    @property
    def digest(self) -> int:
        return protocol.combine_digests(self.digests)


class ClusterCoordinator:
    """Coordinator/worker cluster index (a ``StreamingIndex``)."""

    def __init__(self, cfg: UBISConfig, seed_vectors=None, *,
                 workers: int = 1,
                 backend: Union[str, ClusterBackend] = "local",
                 worker_devices: int = 1,
                 mesh_shape=None,
                 seed: int = 0, round_size: int = 1024,
                 bg_ops_per_round: int = 8, drain_per_tick: int = 256,
                 insert_retries: int = 2, gc_lag: int = 16,
                 reassign_after_split: bool = True,
                 pq_retrain_every: int = 32,
                 shard_cache_scan: bool = True,
                 rebalance: bool = True,
                 rebalance_watermark: float = 0.85,
                 rebalance_ratio: float = 1.2,
                 migrate_per_tick: int = 8,
                 route_alpha: float = 0.0,
                 tier_moves_per_tick: int = 32,
                 tier_rerank_host: bool = True,
                 spread_ratio: float = 1.3,
                 spread_per_tick: int = 256,
                 rpc_timeout: Optional[float] = None,
                 obs: Optional[Obs] = None, device=None,
                 kmeans_init=None, pq_init=None, pq_keys=None):
        if seed_vectors is None:
            raise ValueError("seed_vectors required (k-means seeds)")
        W = int(workers)
        if W < 1:
            raise ValueError("workers must be >= 1")
        if cfg.max_postings % W:
            raise ValueError("max_postings must divide the worker count")
        self.cfg = cfg
        self.n_workers = W
        self.device = resolve_device(device)
        self.retries = int(insert_retries)
        self.pq_retrain_every = int(pq_retrain_every)
        self.spread_ratio = float(spread_ratio)
        self.spread_per_tick = int(spread_per_tick)
        self.rpc_timeout = rpc_timeout
        self._pq_ticks = 0
        self.obs = obs if obs is not None else Obs()
        self.stats = self.obs.driver_stats()

        # worker-local config: each worker owns max_postings/W postings
        # over the FULL id space; nprobe clamps to the local pool
        if W == 1:
            self._worker_cfg = cfg          # bit-identity: untouched
        else:
            mp = cfg.max_postings // W
            self._worker_cfg = dataclasses.replace(
                cfg, max_postings=mp, nprobe=min(cfg.nprobe, mp))
        self._worker_kwargs = dict(
            seed=seed, round_size=round_size,
            bg_ops_per_round=bg_ops_per_round,
            drain_per_tick=drain_per_tick,
            insert_retries=insert_retries, gc_lag=gc_lag,
            reassign_after_split=reassign_after_split,
            pq_retrain_every=pq_retrain_every,
            shard_cache_scan=shard_cache_scan, rebalance=rebalance,
            rebalance_watermark=rebalance_watermark,
            rebalance_ratio=rebalance_ratio,
            migrate_per_tick=migrate_per_tick, route_alpha=route_alpha,
            tier_moves_per_tick=tier_moves_per_tick,
            tier_rerank_host=tier_rerank_host, tier_async=False)
        self._mesh_shape = (list(mesh_shape) if mesh_shape is not None
                            else None)
        sv = np.asarray(seed_vectors, np.float32)
        self._seed_slices = [sv[w::W] for w in range(W)]
        self._draws = [{} for _ in range(W)]
        for name, draw in (("kmeans_init", kmeans_init),
                           ("pq_init", pq_init), ("pq_keys", pq_keys)):
            if draw is None:
                continue
            per = [draw] if W == 1 else list(draw)
            if len(per) != W:
                raise ValueError(f"{name}: one draw per worker ({W}), got "
                                 f"{len(per)}")
            for w in range(W):
                self._draws[w][name] = (
                    [np.asarray(k) for k in per[w]] if name == "pq_keys"
                    else np.asarray(per[w]))

        if isinstance(backend, ClusterBackend):
            self.backend = backend
        elif backend == "local":
            self.backend = LocalBackend(W)
        elif backend == "multiprocess":
            self.backend = MultiProcessBackend(
                W, worker_devices=worker_devices)
        else:
            raise ValueError(f"unknown backend {backend!r} "
                             "(local | multiprocess)")
        self.backend.on_slow = self._on_slow
        self.backend.start()

        # recovery plane: per-worker journal of mutating commands since
        # the last checkpoint base (None base = deterministic re-init)
        self._journal: list[list] = [[] for _ in range(W)]
        self._base_states: list = [None] * W
        self._n_shards = [1] * W
        self._est_live = np.zeros(W, np.int64)
        self._cache_backlog = np.zeros(W, np.int64)
        self._tier_resident = np.zeros(W, np.int64)
        for w in range(W):
            self._init_worker(w)

        # one planner pair per worker — decisions live HERE, observations
        # ship up (params mirror ShardedUBISDriver's exactly, which is
        # half of the workers=1 bit-identity story)
        self._rebalance_on = [bool(rebalance) and s > 1
                              for s in self._n_shards]
        self._planners = [RebalancePlanner(
            s, self._worker_cfg.max_postings // s,
            watermark=rebalance_watermark, ratio_target=rebalance_ratio,
            max_moves=int(migrate_per_tick), min_gap=cfg.l_max)
            for s in self._n_shards]
        self._tier_planners = ([TierPlanner(
            cfg.tier_hot_max, cfg.tier_cold_heat, cfg.tier_promote_heat,
            max_moves=int(tier_moves_per_tick)) for _ in range(W)]
            if cfg.use_tier else None)

    # ------------------------------------------------------------------
    # transport + recovery
    # ------------------------------------------------------------------

    def _on_slow(self, worker: int, command: str, seconds: float,
                 watermark: float) -> None:
        self.obs.emit("worker_slow", worker=int(worker), command=command,
                      seconds=round(float(seconds), 6),
                      watermark=round(float(watermark), 6))

    def _init_worker(self, w: int) -> None:
        r = self.backend.call(w, "init", {
            "cfg": protocol.cfg_to_payload(self._worker_cfg),
            "seed_vectors": self._seed_slices[w],
            "mesh_shape": self._mesh_shape,
            "kwargs": self._worker_kwargs,
            "worker": w, "n_workers": self.n_workers,
            "device": str(self.device), **self._draws[w],
        }, timeout=self.rpc_timeout)
        self._n_shards[w] = int(r["n_shards"])

    def _recover(self, w: int) -> None:
        """Restart a lost worker and replay it back to the present:
        fresh process → ``init`` → checkpoint base (if any) → every
        journaled mutating command, in order."""
        self.backend.restart_worker(w)
        self._init_worker(w)
        if self._base_states[w] is not None:
            self.backend.call(w, "load_state",
                              {"state": self._base_states[w]},
                              timeout=self.rpc_timeout)
        for kind, payload in self._journal[w]:
            self.backend.call(w, kind, payload, timeout=self.rpc_timeout)
        self.obs.emit("worker_restarted", worker=int(w),
                      replayed=len(self._journal[w]),
                      from_checkpoint=self._base_states[w] is not None)

    def _call(self, w: int, kind: str, payload=None) -> dict:
        try:
            out = self.backend.call(w, kind, payload,
                                    timeout=self.rpc_timeout)
        except WorkerLost as e:
            self.obs.emit("worker_lost", worker=int(w), reason=e.reason,
                          command=kind)
            self._recover(w)
            out = self.backend.call(w, kind, payload,
                                    timeout=self.rpc_timeout)
        if kind in MUTATING:
            self._journal[w].append((kind, payload))
        return out

    def heartbeat(self, timeout: Optional[float] = 30.0) -> None:
        """Ping every worker; a missed heartbeat trips the same lost →
        restart → replay path as a failed command."""
        for w in range(self.n_workers):
            try:
                self.backend.call(w, "ping", {}, timeout=timeout)
            except WorkerLost as e:
                self.obs.emit("worker_lost", worker=int(w),
                              reason=e.reason, command="ping")
                self._recover(w)

    # ------------------------------------------------------------------
    # foreground
    # ------------------------------------------------------------------

    def _route(self, vecs: np.ndarray, ids: np.ndarray):
        """Split an insert batch across workers (least-loaded first)."""
        if self.n_workers == 1:
            return [(vecs, ids)]
        counts = plan_insert_split(self._est_live, len(ids))
        parts, off = [], 0
        for w in range(self.n_workers):
            c = int(counts[w])
            parts.append((vecs[off:off + c], ids[off:off + c]))
            off += c
        return parts

    def insert(self, vecs, ids, *, tick_between: bool = True
               ) -> UpdateResult:
        vecs = np.asarray(vecs, np.float32)
        ids = np.asarray(ids, np.int64).astype(np.int32)
        if len(vecs) != len(ids):
            raise ValueError(f"vecs/ids length mismatch: {len(vecs)} vs "
                             f"{len(ids)}")
        if ids.size and (ids.min() < 0 or ids.max() >= self.cfg.max_ids):
            raise ValueError("ids out of range for cfg.max_ids")
        t0 = time.perf_counter()
        n_acc = n_cache = n_rej = 0
        for w, (pv, pi) in enumerate(self._route(vecs, ids)):
            if not len(pi):
                continue
            # mirrors ShardedUBISDriver.insert: retry with a tick
            # between attempts, survivors park in the worker's cache
            pending, rej_t = (pv, pi), None
            for _attempt in range(self.retries + 1):
                r = self._call(w, "insert_rounds",
                               {"vecs": pending[0], "ids": pending[1]})
                n_acc += int(r["accepted"])
                self._est_live[w] += int(r["accepted"])
                if r["rej_ids"] is None:
                    pending = None
                    break
                pending = (np.asarray(r["rej_vecs"], np.float32),
                           np.asarray(r["rej_ids"], np.int32))
                rej_t = np.asarray(r["rej_targets"], np.int32)
                if tick_between:
                    self.tick()
            if pending is not None:
                rc = self._call(w, "cache_put",
                                {"vecs": pending[0], "ids": pending[1],
                                 "targets": rej_t})
                got = int(rc["cached"])
                n_cache += got
                self._est_live[w] += got
                n_rej += len(pending[1]) - got
                self.stats["host_cached"] += got
        dt = time.perf_counter() - t0
        self.stats["insert_time"] += dt
        self.stats["inserted"] += n_acc + n_cache
        self.stats["rejected"] += n_rej
        self.obs.emit("insert", accepted=n_acc, cached=n_cache,
                      rejected=n_rej, seconds=round(dt, 6))
        return UpdateResult(accepted=n_acc, cached=n_cache,
                            rejected=n_rej, seconds=dt)

    def delete(self, ids) -> UpdateResult:
        ids = np.asarray(ids, np.int64).astype(np.int32)
        t0 = time.perf_counter()
        total = 0
        for w in range(self.n_workers):
            r = self._call(w, "delete", {"ids": ids})
            total += int(r["deleted"])
            self._est_live[w] -= int(r["deleted"])
        dt = time.perf_counter() - t0
        self.stats["delete_time"] += dt
        self.stats["deleted"] += total
        self.obs.emit("delete", deleted=total, blocked=0,
                      seconds=round(dt, 6))
        return UpdateResult(deleted=total, seconds=dt)

    def _merge(self, ids_list, scores_list, k: int):
        all_i = np.concatenate(ids_list, axis=1)
        all_s = np.concatenate(scores_list, axis=1).astype(np.float32)
        keyed = np.where(all_i < 0, np.float32(np.inf), all_s)
        order = np.argsort(keyed, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(all_i, order, axis=1),
                np.take_along_axis(all_s, order, axis=1))

    def search(self, queries, k: int,
               nprobe: Optional[int] = None) -> SearchResult:
        q = np.asarray(queries, np.float32)
        t0 = time.perf_counter()
        ids_l, scores_l = [], []
        for w in range(self.n_workers):
            r = self._call(w, "search",
                           {"queries": q, "k": int(k), "nprobe": nprobe})
            ids_l.append(np.asarray(r["ids"]))
            scores_l.append(np.asarray(r["scores"]))
        if self.n_workers == 1:
            found, scores = ids_l[0], scores_l[0]
        else:
            found, scores = self._merge(ids_l, scores_l, k)
        dt = time.perf_counter() - t0
        self.stats["search_time"] += dt
        self.stats["queries"] += q.shape[0]
        self.stats["search_results"] += int((found >= 0).sum())
        if self.cfg.use_pq:
            self.stats["search_adc_batches"] += 1
        else:
            self.stats["search_exact_batches"] += 1
        return SearchResult(ids=found, scores=scores, seconds=dt)

    def exact(self, queries, k: int) -> SearchResult:
        q = np.asarray(queries, np.float32)
        ids_l, scores_l = [], []
        for w in range(self.n_workers):
            r = self._call(w, "exact", {"queries": q, "k": int(k)})
            ids_l.append(np.asarray(r["ids"]))
            scores_l.append(np.asarray(r["scores"]))
        if self.n_workers == 1:
            return SearchResult(ids=ids_l[0], scores=scores_l[0])
        found, scores = self._merge(ids_l, scores_l, k)
        return SearchResult(ids=found, scores=scores)

    # ------------------------------------------------------------------
    # background
    # ------------------------------------------------------------------

    def _absorb_commits(self, commits: list) -> None:
        """Re-emit worker tier commits on the coordinator's trace plane
        and fold them into the stats counters (the audit invariant:
        tier_commit events account 1:1 for the stats deltas)."""
        for c in commits:
            self.obs.emit("tier_commit", **c)
            self.stats["tier_spilled"] += len(c.get("spilled", ()))
            self.stats["tier_promoted"] += len(c.get("promoted", ()))

    def tick(self) -> TickReport:
        t0 = time.perf_counter()
        executed = reclaimed = migrated = drained = retrained = 0
        spilled = promoted = 0
        retrain = False
        if self.cfg.use_pq and self.pq_retrain_every > 0:
            # the coordinator owns the cadence counter the in-process
            # driver keeps in _pq_retrain — the retrain slot is an
            # explicit grant in the tick plan
            self._pq_ticks += 1
            retrain = self._pq_ticks % self.pq_retrain_every == 0
        for w in range(self.n_workers):
            r1 = self._call(w, "tick_begin", {})
            executed += int(r1["executed"])
            reclaimed += int(r1["gc"])
            press = np.asarray(r1["pressure"])
            planner = self._planners[w]
            src = dst = np.empty(0, np.int32)
            if self._rebalance_on[w] and planner.needs(press):
                pi = self._call(w, "plan_inputs", {})
                src, dst = planner.plan(press,
                                        np.asarray(pi["lengths"]),
                                        np.asarray(pi["movable"]))
            if len(src) or retrain:
                self.obs.emit("plan_sent", worker=w,
                              migrate=int(len(src)), retrain=retrain)
            r2 = self._call(w, "tick_exec",
                            {"src": src, "dst": dst, "retrain": retrain})
            mig = np.asarray(r2["migrated"], bool)
            n_mig = int(mig.sum())
            if len(src):
                self.stats["migrated"] += n_mig
                self.obs.emit(
                    "rebalance",
                    trigger=(planner.last_moves[0]["trigger"]
                             if planner.last_moves else "none"),
                    moves=[{**mv, "committed": bool(mig[j])}
                           for j, mv in enumerate(planner.last_moves)],
                    migrated=n_mig)
            migrated += n_mig
            drained += int(r2["drained"])
            retrained += int(r2["retrained"])
            if r2["retrained"]:
                self.stats["pq_retrains"] += 1
                self.obs.emit("pq_retrain", reason="cadence", worker=w)
            self._absorb_commits(r2["commits"])
            promos = spills = np.empty(0, np.int64)
            if self._tier_planners is not None and r2["tier_rows"]:
                tp = self._tier_planners[w]
                promos, spills = plan_tier_moves(tp, r2["tier_rows"],
                                                 self._worker_cfg)
                if len(promos) or len(spills):
                    reasons = tp.last_promote_reasons
                    self.obs.emit(
                        "tier_plan", worker=w,
                        promotes=[{"pid": int(p),
                                   "reason": reasons.get(int(p),
                                                         "search-heat")}
                                  for p in promos],
                        spills=[{"pid": int(p),
                                 "reason": "watermark-cold"}
                                for p in spills])
            r3 = self._call(w, "tick_end",
                            {"promotes": promos, "spills": spills})
            spilled += int(r3["spilled"])
            promoted += int(r3["promoted"])
            self._absorb_commits(r3["commits"])
            self._cache_backlog[w] = int(r3["cache_backlog"])
            self._tier_resident[w] = int(r3["tier_resident"])
            self._est_live[w] = int(r3["live"])
        if self._tier_planners is not None:
            self.stats["tier_resident"] = int(self._tier_resident.sum())
        if self.n_workers > 1 and self.spread_ratio > 0:
            migrated += self._spread_balance()
        dt = time.perf_counter() - t0
        self.stats["bg_time"] += dt
        self.stats["bg_ops"] += executed
        self.stats["bg_gc"] += reclaimed
        self.stats["drained"] += drained
        self.obs.emit("tick", executed=executed, drained=drained,
                      migrated=migrated, gc=reclaimed, pq=retrained,
                      spilled=spilled, promoted=promoted,
                      seconds=round(dt, 6))
        return TickReport(executed=executed, drained=drained,
                          migrated=migrated, gc=reclaimed,
                          pq_retrained=retrained, spilled=spilled,
                          promoted=promoted, seconds=dt)

    def _spread_balance(self) -> int:
        """Cross-worker occupancy balance: when worker live counts drift
        past ``spread_ratio``, move vectors from the heaviest worker to
        the lightest via ``extract`` → ``insert_rounds``.  The pair is
        one logical migration; anything the receiver cannot absorb
        parks in its cache, and a cache overflow falls back to the
        donor — the live multiset is conserved at every step."""
        live = self._est_live
        d, r = int(np.argmax(live)), int(np.argmin(live))
        hi, lo = int(live[d]), int(live[r])
        if hi - lo <= self.cfg.l_max or hi <= max(lo, 1) * self.spread_ratio:
            return 0
        n = min(self.spread_per_tick, (hi - lo) // 2)
        if n <= 0:
            return 0
        ex = self._call(d, "extract", {"n": int(n)})
        ids = np.asarray(ex["ids"], np.int32)
        if not len(ids):
            return 0
        vecs = np.asarray(ex["vecs"], np.float32)
        self._est_live[d] -= len(ids)
        rr = self._call(r, "insert_rounds", {"vecs": vecs, "ids": ids})
        installed = int(rr["accepted"])
        self._est_live[r] += installed
        if rr["rej_ids"] is not None:
            rv = np.asarray(rr["rej_vecs"], np.float32)
            ri = np.asarray(rr["rej_ids"], np.int32)
            rc = self._call(r, "cache_put",
                            {"vecs": rv, "ids": ri,
                             "targets": np.asarray(rr["rej_targets"],
                                                   np.int32)})
            got = int(rc["cached"])
            installed += got
            self._est_live[r] += got
            if got < len(ri):
                # receiver full: return the remainder home (donor just
                # freed capacity by deleting these very vectors)
                rv, ri = rv[got:], ri[got:]
                rd = self._call(d, "insert_rounds",
                                {"vecs": rv, "ids": ri})
                back = int(rd["accepted"])
                self._est_live[d] += back
                if rd["rej_ids"] is not None:
                    rc2 = self._call(
                        d, "cache_put",
                        {"vecs": np.asarray(rd["rej_vecs"], np.float32),
                         "ids": np.asarray(rd["rej_ids"], np.int32),
                         "targets": np.asarray(rd["rej_targets"],
                                               np.int32)})
                    got2 = int(rc2["cached"])
                    back += got2
                    self._est_live[d] += got2
                    if got2 < len(np.asarray(rd["rej_ids"])):
                        raise RuntimeError(
                            "spread balance dropped vectors: donor and "
                            "receiver both refused re-installation")
        if installed:
            self.stats["migrated"] += installed
            self.obs.emit(
                "rebalance", trigger="worker-spread",
                moves=[{"src_worker": d, "dst_worker": r,
                        "n": installed, "trigger": "worker-spread",
                        "committed": True}],
                migrated=installed)
        return installed

    def flush(self, max_ticks: int = 200) -> int:
        for i in range(max_ticks):
            r = self.tick()
            if (r.executed == 0 and r.migrated == 0
                    and int(self._cache_backlog.sum()) == 0
                    and r.spilled == 0 and r.promoted == 0):
                return i + 1
        return max_ticks

    # ------------------------------------------------------------------
    # tier hooks (contract-harness surface)
    # ------------------------------------------------------------------

    def force_spill(self, n: int) -> int:
        moved = 0
        for w in range(self.n_workers):
            r = self._call(w, "force_spill", {"n": int(n)})
            moved += int(r["moved"])
            self._tier_resident[w] = int(r["tier_resident"])
            self._absorb_commits(r["commits"])
        self.stats["tier_resident"] = int(self._tier_resident.sum())
        return moved

    def force_promote(self, n=None) -> int:
        moved = 0
        for w in range(self.n_workers):
            r = self._call(w, "force_promote",
                           {"n": None if n is None else int(n)})
            moved += int(r["moved"])
            self._tier_resident[w] = int(r["tier_resident"])
            self._absorb_commits(r["commits"])
        self.stats["tier_resident"] = int(self._tier_resident.sum())
        return moved

    # ------------------------------------------------------------------
    # state / StreamingIndex surface
    # ------------------------------------------------------------------

    @property
    def state(self):
        """The single worker's gathered state (``workers=1`` only — the
        contract harness's id-map fallback reads ``.state.id_loc``)."""
        if self.n_workers != 1:
            raise NotImplementedError(
                "per-worker states are not one pytree; use snapshot()")
        r = self._call(0, "snapshot", {})
        return protocol.payload_to_state(r["state"], "cpu")

    def snapshot(self):
        """``workers=1``: the worker's self-contained ``IndexState``
        (drop-in for the single-host drivers).  Multi-worker: a
        :class:`ClusterSnapshot` of per-worker states + digests.  The
        states are on the CPU."""
        snaps, digests = [], []
        for w in range(self.n_workers):
            r = self._call(w, "snapshot", {})
            snaps.append(protocol.payload_to_state(r["state"], "cpu"))
            digests.append(int(r["digest"]))
        if self.n_workers == 1:
            return snaps[0]
        return ClusterSnapshot(states=snaps, digests=digests)

    def load_snapshot(self, snap) -> "ClusterCoordinator":
        """Adopt a ``snapshot()`` result.  Resets the recovery journal:
        the loaded states become the new replay bases."""
        states = (snap.states if isinstance(snap, ClusterSnapshot)
                  else [snap])
        if len(states) != self.n_workers:
            raise ValueError(f"snapshot has {len(states)} worker states, "
                             f"cluster has {self.n_workers}")
        for w, st in enumerate(states):
            # a copy: on the CPU the arrays would share the caller's
            # tensors, which in-place rounds may change after this call,
            # and this payload is the worker's replay base
            payload = {k: v.copy()
                       for k, v in protocol.state_to_payload(st).items()}
            r = self._call(w, "load_state", {"state": payload})
            self._base_states[w] = payload
            self._journal[w] = []
            self._est_live[w] = int(r["live"])
        return self

    def checkpoint(self, directory: str) -> dict:
        """Write per-worker snapshots + the digest manifest, and reset
        the journals (the checkpoint becomes the new replay base)."""
        from ..checkpoint.manager import save_cluster_checkpoint
        payloads, digests = [], []
        for w in range(self.n_workers):
            r = self._call(w, "snapshot", {})
            payloads.append(r["state"])
            digests.append(int(r["digest"]))
        manifest = save_cluster_checkpoint(directory, payloads, digests)
        for w in range(self.n_workers):
            self._base_states[w] = payloads[w]
            self._journal[w] = []
        self.obs.emit("checkpoint", directory=str(directory),
                      workers=self.n_workers,
                      digest=int(manifest["combined_digest"]))
        return manifest

    def restore(self, directory: str) -> "ClusterCoordinator":
        """Load a ``checkpoint()`` directory into the running cluster
        (digest-verified; partial/mismatched checkpoints fail loudly)."""
        from ..checkpoint.manager import load_cluster_checkpoint
        payloads, manifest = load_cluster_checkpoint(
            directory, expect_workers=self.n_workers)
        for w, payload in enumerate(payloads):
            r = self._call(w, "load_state", {"state": payload})
            self._base_states[w] = payload
            self._journal[w] = []
            self._est_live[w] = int(r["live"])
        return self

    def live_count(self) -> int:
        total = 0
        for w in range(self.n_workers):
            total += int(self._call(w, "live_count", {})["live"])
        return total

    def worker_live(self) -> np.ndarray:
        """Live vectors per worker (the cross-host occupancy rows)."""
        return np.array([int(self._call(w, "live_count", {})["live"])
                         for w in range(self.n_workers)], np.int64)

    def shard_occupancy(self) -> np.ndarray:
        """Per-shard live vectors, all workers concatenated."""
        return np.concatenate([
            np.asarray(self._call(w, "occupancy", {})["occ"])
            for w in range(self.n_workers)])

    def posting_lengths(self) -> np.ndarray:
        return np.concatenate([
            np.asarray(self._call(w, "posting_lengths", {})["lengths"])
            for w in range(self.n_workers)])

    def memory_bytes(self) -> int:
        return sum(int(self._call(w, "memory", {})["bytes"])
                   for w in range(self.n_workers))

    def memory_tiers(self) -> dict:
        out: dict = {}
        for w in range(self.n_workers):
            for key, v in self._call(w, "memory", {})["tiers"].items():
                out[key] = out.get(key, 0) + int(v)
        return out

    def throughput(self) -> dict:
        from ..core.metrics import throughput_from_stats
        return throughput_from_stats(self.stats)

    def close(self) -> None:
        self.backend.stop()
