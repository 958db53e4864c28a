"""Host-side orchestration: job queues + the background scheduler.

The data plane is tensor code on one device (``update.py``,
``balance.py``, ``search.py``); this module is the control plane: it
sequences rounds, implements the two-phase SPLITTING/MERGING window,
drains the vector cache, garbage-collects retired postings, and keeps
the accounting (TPS/QPS/recall inputs) the benchmarks read.

Mode differences (cfg.mode):
  * ``ubis``     — periodic balance-detector scan (relaxed restrictions),
                   vector cache for blocked jobs, balanced splits.
  * ``spfresh``  — strict triggers only (split on insert overflow, merge
                   on search touching a small posting), posting-lock
                   rejection of blocked jobs, unconditional 2-means splits.

The driver runs on the card unless the caller passes ``device="cpu"``
(the kernels' plain versions; what the tests use).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..api.types import SearchResult, TickReport, UpdateResult
from ..obs import Obs
from ..quant import pq
from . import balance, search as search_mod, update
from . import version_manager as vm
from .build import SAMPLE_CAP, initial_posting_count, initial_state
from .types import (KIND_COMPACT, KIND_MERGE, KIND_SPLIT, STATUS_MERGING,
                    STATUS_SPLITTING, IndexState, UBISConfig,
                    require_untiered, state_memory_bytes)

KIND_CODES = {"split": KIND_SPLIT, "merge": KIND_MERGE,
              "compact": KIND_COMPACT}
EXACT_CHUNK_FLOATS = 1 << 28  # exact(): score block per query chunk (1 GiB)
INSERT_RETRIES = 2            # re-rounds for rejected jobs, a tick between
GC_LAG = 16                   # versions a retired posting outlives for readers
PQ_SEED_OFFSET = 0x517C0DE    # the quant plane's draws: seed + this


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without CUDA that raises instead of
    quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def draw_kmeans_init(cfg: UBISConfig, n_seed: int, seed: int) -> np.ndarray:
    """The k-means initial indices: ``initial_posting_count`` distinct
    rows of the seed sample, drawn from a ``torch.Generator``."""
    g = torch.Generator().manual_seed(int(seed))
    k0 = initial_posting_count(cfg, n_seed)
    return torch.randperm(min(n_seed, SAMPLE_CAP), generator=g)[:k0].numpy()


def draw_pq_init(cfg: UBISConfig, n_seed: int, seed: int) -> np.ndarray:
    """The generation-0 codebook sample: ``pq_ksub`` rows of the seed
    sample (distinct when it has that many), from a ``torch.Generator``."""
    g = torch.Generator().manual_seed(int(seed) + PQ_SEED_OFFSET)
    n = min(n_seed, SAMPLE_CAP)
    if n >= cfg.pq_ksub:
        return torch.randperm(n, generator=g)[:cfg.pq_ksub].numpy()
    return torch.randint(0, n, (cfg.pq_ksub,), generator=g).numpy()


def _pad_rows(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    """``t`` with ``pad`` rows of ``value`` appended along dim 0."""
    return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), value,
                                    dtype=t.dtype, device=t.device)])


@dataclasses.dataclass
class SearchDispatch:
    """An in-flight search: launched on the device, not yet awaited."""

    queries: np.ndarray
    k: int
    found: Any                       # device (Q, k) int32
    scores: Any                      # device (Q, k) f32
    probe: Any                       # device probed pids
    t0: float


class UBISDriver:
    """Streaming driver for one index instance (a ``StreamingIndex``).

    ``kmeans_init``: the k-means initial indices into the seed sample
    (default: drawn from ``seed``).  With ``cfg.use_pq``: ``pq_init``,
    the generation-0 codebook sample rows (default: drawn from
    ``seed``); ``pq_retrain_every``, the codebook re-train cadence in
    ticks (0 = never); ``pq_keys``, an iterable of (M*C,) uniform draws
    in [0, 1), one per re-train, that pick its sample (default: drawn
    from a ``torch.Generator`` seeded from ``seed``).  ``obs``: the
    observability plane to report into (default: a new ``Obs()``).
    ``fused_tick=True`` (device-side candidate selection) belongs to a
    later slice and raises.
    """

    def __init__(self, cfg: UBISConfig, seed_vectors=None, *,
                 seed: int = 0, round_size: int = 1024,
                 bg_ops_per_round: int = 4, drain_per_tick: int = 256,
                 fused_tick: bool = False, pq_retrain_every: int = 32,
                 device=None, kmeans_init=None, pq_init=None,
                 pq_keys=None, obs: Optional[Obs] = None):
        require_untiered(cfg)
        if fused_tick:
            raise NotImplementedError(
                "fused_tick=True (balance.mark_round) belongs to a later "
                "slice of the port")
        if seed_vectors is None:
            raise ValueError("seed_vectors required (used for k-means seeds)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.round_size = int(round_size)
        self.bg_ops = int(bg_ops_per_round)
        self.drain_n = int(drain_per_tick)
        self.pq_retrain_every = int(pq_retrain_every)
        self.obs = obs if obs is not None else Obs()

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
        self.state: IndexState = initial_state(cfg, seeds, init, pq_idx)
        self._ticks = 0
        self._pq_keys = None if pq_keys is None else iter(pq_keys)
        self._pq_gen = None
        if cfg.use_pq and pq_keys is None:
            self._pq_gen = torch.Generator(device=self.device)
            self._pq_gen.manual_seed(int(seed) + PQ_SEED_OFFSET)
        # ops marked SPLITTING/MERGING last tick, executed this tick
        self._marked: list[tuple[str, int]] = []
        self._marked_set: set[int] = set()
        # SPFresh strict-trigger candidate sets
        self._sp_split: set[int] = set()
        self._sp_merge: set[int] = set()
        self.stats = self.obs.driver_stats()

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # foreground
    # ------------------------------------------------------------------

    def insert(self, vecs, ids, *, tick_between: bool = True) -> UpdateResult:
        """Stream (vecs, ids) through padded insert rounds.  Rejected jobs
        (SPFresh lock model / full cache) are retried up to
        ``INSERT_RETRIES`` times with a background tick in between."""
        vecs = np.asarray(vecs, np.float32)
        ids = np.asarray(ids, np.int64).astype(np.int32)
        if len(vecs) != len(ids):
            raise ValueError(f"vecs/ids length mismatch: {len(vecs)} vs "
                             f"{len(ids)}")
        if ids.size and (ids.min() < 0 or ids.max() >= self.cfg.max_ids):
            raise ValueError("ids out of range for cfg.max_ids")
        t0 = time.perf_counter()
        n_acc = n_cache = n_rej = 0
        J = self.round_size
        pending = (vecs, ids, np.full(ids.shape, -1, np.int32))
        for _ in range(INSERT_RETRIES + 1):
            pv, pi, ph = pending
            rej_v, rej_i, rej_h = [], [], []
            for off in range(0, len(pi), J):
                cv, ci, ch = pv[off:off + J], pi[off:off + J], ph[off:off + J]
                pad = J - len(ci)
                valid = np.concatenate([np.ones(len(ci), bool),
                                        np.zeros(pad, bool)])
                cv = np.concatenate([cv, np.zeros((pad, self.cfg.dim),
                                                  np.float32)])
                ci = np.concatenate([ci, np.zeros(pad, np.int32)])
                ch = np.concatenate([ch, np.full(pad, -1, np.int32)])
                self.state, res, _touched = update.insert_round(
                    self.state, self.cfg, self._dev(cv), self._dev(ci),
                    self._dev(valid), self._dev(ch))
                flags = torch.stack([res.accepted, res.cached,
                                     res.rejected]).cpu().numpy()
                acc, cac, rej = flags
                n_acc += int(acc.sum())
                n_cache += int(cac.sum())
                if rej.any():
                    rej_v.append(cv[rej])
                    rej_i.append(ci[rej])
                    rej_h.append(np.full(int(rej.sum()), -1, np.int32))
                if not self.cfg.is_ubis:
                    self._note_spfresh_overflow(
                        res.target.cpu().numpy()[acc])
            if not rej_v:
                pending = None
                break
            pending = (np.concatenate(rej_v), np.concatenate(rej_i),
                       np.concatenate(rej_h))
            if tick_between:
                self.tick()
        if pending is not None:
            n_rej = len(pending[1])
        self._sync()
        dt = time.perf_counter() - t0
        self.stats["insert_time"] += dt
        self.stats["inserted"] += n_acc + n_cache
        self.stats["rejected"] += n_rej
        self.obs.emit("insert", accepted=n_acc, cached=n_cache,
                      rejected=n_rej, seconds=round(dt, 6))
        return UpdateResult(accepted=n_acc, cached=n_cache, rejected=n_rej,
                            seconds=dt)

    def delete(self, ids) -> UpdateResult:
        ids = np.asarray(ids, np.int64).astype(np.int32)
        t0 = time.perf_counter()
        J = self.round_size
        n_done = n_blocked = 0
        for off in range(0, len(ids), J):
            ci = ids[off:off + J]
            pad = J - len(ci)
            valid = np.concatenate([np.ones(len(ci), bool),
                                    np.zeros(pad, bool)])
            ci = np.concatenate([ci, np.zeros(pad, np.int32)])
            self.state, done, blocked = update.delete_round(
                self.state, self.cfg, self._dev(ci), self._dev(valid))
            n_done_b, n_blocked_b = torch.stack(
                [done.sum(), blocked.sum()]).tolist()
            n_done += n_done_b
            n_blocked += n_blocked_b
        self._sync()
        dt = time.perf_counter() - t0
        self.stats["delete_time"] += dt
        self.stats["deleted"] += n_done
        self.stats["blocked"] += n_blocked
        self.obs.emit("delete", deleted=n_done, blocked=n_blocked,
                      seconds=round(dt, 6))
        return UpdateResult(deleted=n_done, blocked=n_blocked, seconds=dt)

    def search(self, queries, k: int,
               nprobe: Optional[int] = None) -> SearchResult:
        return self.collect_search(self.dispatch_search(queries, k, nprobe))

    def dispatch_search(self, queries, k: int,
                        nprobe: Optional[int] = None) -> SearchDispatch:
        """Launch the search without waiting for the device; pair with
        ``collect_search``.  The result answers for the index as of
        dispatch: the work is queued on the stream before any later
        round's."""
        queries = np.asarray(queries, np.float32)
        t0 = time.perf_counter()
        found, scores, probe = search_mod.search(
            self.state, self.cfg, self._dev(queries), k, nprobe)
        return SearchDispatch(queries=queries, k=k, found=found,
                              scores=scores, probe=probe, t0=t0)

    def collect_search(self, disp: SearchDispatch) -> SearchResult:
        found = disp.found.cpu().numpy()
        scores = disp.scores.cpu().numpy()
        probe = disp.probe.cpu().numpy()
        dt = time.perf_counter() - disp.t0
        self.stats["search_time"] += dt
        self.stats["queries"] += disp.queries.shape[0]
        self.stats["search_probed"] += int((probe >= 0).sum())
        self.stats["search_results"] += int((found >= 0).sum())
        if self.cfg.use_pq:
            self.stats["search_adc_batches"] += 1
        else:
            self.stats["search_exact_batches"] += 1
        if not self.cfg.is_ubis:
            self._note_spfresh_small(probe)
        return SearchResult(ids=found, scores=scores, seconds=dt)

    # ------------------------------------------------------------------
    # background
    # ------------------------------------------------------------------

    def tick(self) -> TickReport:
        """One background round: execute marked ops, drain the cache,
        detect + mark new candidates, GC, and (quant plane) re-train the
        PQ codebooks on cadence."""
        t0 = time.perf_counter()
        executed = self._execute_marked()
        self.stats["bg_exec_time"] += time.perf_counter() - t0
        drained = self._drain_cache() if self.cfg.is_ubis else 0
        marked = self._mark_candidates()
        reclaimed = self._gc()
        retrained = self._pq_retrain()
        dt = time.perf_counter() - t0
        self.stats["bg_time"] += dt
        self.stats["bg_ops"] += executed
        self.stats["bg_gc"] += reclaimed
        self.stats["drained"] += drained
        self.obs.emit("tick", executed=executed, drained=drained,
                      marked=marked, gc=reclaimed, pq=retrained,
                      seconds=round(dt, 6))
        return TickReport(executed=executed, drained=drained, marked=marked,
                          gc=reclaimed, pq_retrained=retrained, seconds=dt)

    def flush(self, max_ticks: int = 200) -> int:
        """Tick until quiescent (no marked ops, no due candidates, cache
        empty).  Returns the number of ticks."""
        for i in range(max_ticks):
            r = self.tick()
            cache_n = int(self.state.cache_valid.sum())
            if (r.executed == 0 and r.marked == 0
                    and (cache_n == 0 or not self.cfg.is_ubis)):
                return i + 1
        return max_ticks

    def _execute_marked(self) -> int:
        """Execute the whole marked batch as ONE background round; the
        only transfer back is the small ``BackgroundRound`` struct."""
        marked, self._marked = self._marked, []
        self._marked_set.clear()
        if not marked:
            return 0
        # every marked op MUST ride in this batch: a truncated op would
        # keep its mark with nothing queued to clear it
        B = max(self.bg_ops, len(marked), 1)
        kinds_np = np.zeros(B, np.int32)
        pids_np = np.full(B, -1, np.int32)
        for i, (kind, pid) in enumerate(marked):
            kinds_np[i] = KIND_CODES[kind]
            pids_np[i] = pid
        self.state, rr = balance.background_round(
            self.state, self.cfg, self._dev(kinds_np), self._dev(pids_np))
        rr = rr.to_host()
        self.stats["bg_split"] += rr["n_split"]
        self.stats["bg_merge"] += rr["n_merge"]
        self.stats["bg_compact"] += rr["n_compact"]
        self.stats["bg_deferred"] += rr["deferred"]
        self.stats["bg_reassigned"] += rr["reassigned"]
        self.obs.emit("bg_exec", split=rr["n_split"], merge=rr["n_merge"],
                      compact=rr["n_compact"], deferred=rr["deferred"],
                      reassigned=rr["reassigned"], executed=rr["executed"])
        return rr["executed"]

    def _drain_cache(self) -> int:
        if not bool(self.state.cache_valid.any()):
            return 0
        n = min(self.drain_n, self.round_size)
        self.state, vecs, ids, targets, taken = update.cache_take(
            self.state, self.cfg, n)
        pad = self.round_size - n
        vecs, ids = _pad_rows(vecs, pad, 0), _pad_rows(ids, pad, 0)
        targets = _pad_rows(targets, pad, -1)
        taken = _pad_rows(taken, pad, False)
        self.state, res, _ = update.insert_round(
            self.state, self.cfg, vecs, ids, taken, targets)
        return int(res.accepted.sum())

    def _mark_candidates(self) -> int:
        lengths = self.state.lengths.cpu().numpy()
        if self.cfg.is_ubis:
            split_due, merge_due, compact_due = (
                x.cpu().numpy() for x in balance.detect(self.state, self.cfg))
            split_pids = np.flatnonzero(split_due)
            split_pids = split_pids[np.argsort(-lengths[split_pids])]
            merge_pids = np.flatnonzero(merge_due)
            merge_pids = merge_pids[np.argsort(lengths[merge_pids])]
            compact_pids = np.flatnonzero(compact_due)
        else:
            alloc = self.state.allocated.cpu().numpy()
            # a noted candidate may have retired since: marking a DELETED
            # posting would resurrect its stale tile, so require NORMAL
            status = vm.unpack_status(self.state.rec_meta).cpu().numpy()
            normal = alloc & (status == 0)
            split_pids = np.array(
                [p for p in self._sp_split
                 if normal[p] and lengths[p] > self.cfg.l_max], int)
            merge_pids = np.array(
                [p for p in self._sp_merge
                 if normal[p] and lengths[p] < self.cfg.l_min], int)
            compact_pids = np.array(
                [p for p in self._sp_split
                 if normal[p] and lengths[p] <= self.cfg.l_max], int)
            self._sp_split.clear()
            self._sp_merge.clear()

        jobs = ([("split", int(p)) for p in split_pids]
                + [("compact", int(p)) for p in compact_pids]
                + [("merge", int(p)) for p in merge_pids])
        # one job per posting: a hollowed-out full tile is both
        # compact_due and merge_due
        seen = set(self._marked_set)
        deduped = []
        for j in jobs:
            if j[1] not in seen:
                seen.add(j[1])
                deduped.append(j)
        jobs = deduped[:self.bg_ops]
        if not jobs:
            return 0
        split_like = [p for k_, p in jobs if k_ in ("split", "compact")]
        merge_like = [p for k_, p in jobs if k_ == "merge"]
        if split_like:
            self.state = update.mark_status(
                self.state, self._dev(np.asarray(split_like, np.int64)),
                STATUS_SPLITTING)
        if merge_like:
            self.state = update.mark_status(
                self.state, self._dev(np.asarray(merge_like, np.int64)),
                STATUS_MERGING)
        self._marked.extend(jobs)
        self._marked_set.update(p for _, p in jobs)
        self.obs.emit(
            "bg_mark",
            reason=("balance-detector" if self.cfg.is_ubis
                    else "strict-trigger"),
            split=[p for kk, p in jobs if kk == "split"],
            merge=[p for kk, p in jobs if kk == "merge"],
            compact=[p for kk, p in jobs if kk == "compact"])
        return len(jobs)

    def _gc(self) -> int:
        ver = int(self.state.global_version)
        if ver <= GC_LAG:
            return 0
        self.state, n = balance.gc_round(self.state, self.cfg,
                                         ver - GC_LAG, 64)
        return int(n)

    def _pq_retrain(self) -> int:
        """Versioned codebook re-train on tick cadence (quant plane)."""
        if not self.cfg.use_pq or self.pq_retrain_every <= 0:
            return 0
        self._ticks += 1
        if self._ticks % self.pq_retrain_every:
            return 0
        M, C, _ = self.state.vectors.shape
        if self._pq_keys is not None:
            keys = self._dev(np.array(next(self._pq_keys), np.float32))
        else:
            keys = torch.rand((M * C,), generator=self._pq_gen,
                              device=self.device)
        evict = (int(self.state.pq_active) + 1) % self.cfg.pq_versions
        self.state = pq.retrain_round(self.state, self.cfg, keys)
        self.stats["pq_retrains"] += 1
        self.stats["pq_generation"] = int(
            self.state.pq_slot_gen[self.state.pq_active.long()])
        self.obs.emit("pq_retrain", reason="cadence", evicted_slot=evict,
                      generation=int(self.stats["pq_generation"]))
        return 1

    # ---- SPFresh strict-trigger bookkeeping ---------------------------

    def _note_spfresh_overflow(self, pids: np.ndarray):
        lengths = self.state.lengths.cpu().numpy()
        for p in np.unique(pids):
            if p >= 0 and lengths[p] > self.cfg.l_max:
                self._sp_split.add(int(p))

    def _note_spfresh_small(self, probe: np.ndarray):
        lengths = self.state.lengths.cpu().numpy()
        for p in np.unique(probe[lengths[probe] < self.cfg.l_min]):
            if p >= 0:
                self._sp_merge.add(int(p))

    # ---- StreamingIndex protocol surface ------------------------------

    def snapshot(self) -> IndexState:
        """A copy of the state (the rounds update the live one in place,
        so a snapshot must not alias it)."""
        return IndexState(**{f.name: getattr(self.state, f.name).clone()
                             for f in dataclasses.fields(IndexState)})

    def load_snapshot(self, state: IndexState) -> "UBISDriver":
        """Adopt a ``snapshot()`` state; the driver takes ownership of its
        tensors.  Returns self."""
        self.state = state
        self._marked = []
        self._marked_set.clear()
        return self

    def memory_bytes(self) -> int:
        return state_memory_bytes(self.state)

    def exact(self, queries, k: int) -> SearchResult:
        """Exact top-k over the index's live contents (recall oracle),
        scanned in query chunks that keep each score block near 1 GiB."""
        queries = np.asarray(queries, np.float32)
        M, C, _ = self.state.vectors.shape
        width = M * C + self.cfg.cache_capacity
        chunk = max(1, EXACT_CHUNK_FLOATS // width)
        ids, scores = [], []
        for off in range(0, len(queries), chunk):
            f, s = search_mod.brute_force(
                self.state, self.cfg, self._dev(queries[off:off + chunk]), k)
            ids.append(f.cpu().numpy())
            scores.append(s.cpu().numpy())
        return SearchResult(ids=np.concatenate(ids),
                            scores=np.concatenate(scores))

    def posting_lengths(self) -> np.ndarray:
        from .metrics import live_posting_lengths
        return live_posting_lengths(self.state)

    def live_count(self) -> int:
        """Vectors in visible postings + the cache."""
        return int(self.state.live_vector_count()) + int(
            self.state.cache_valid.sum())

    def throughput(self) -> dict:
        from .metrics import throughput_from_stats
        return throughput_from_stats(self.stats)
