"""Cold-tier host spill: codes-only device residency for cold postings.

Under streaming traffic most postings are cold (never probed, never
appended to), yet their float tiles are the index's dominant device
cost.  With ``cfg.use_tier`` (which needs ``cfg.use_pq``) the driver
moves cold postings' float tiles to a host pool (pinned when the index
lives on a card) and keeps only their PQ codes, centroid and recorder
word on the device; search serves them ADC-only and reranks the final
candidate set exactly on the host, while hot postings keep the float
path.

Three cooperating pieces, as in the JAX package's ``core/tier.py``:

  * **heat tracking**: ``state.heat`` counts probes and accepted appends
    per posting (accumulated on the host, applied by one ``touch_round``
    per tick) and halves once per background round
    (``balance.background_round``) or, on a tick without one, in
    ``decay_round``;
  * **the planner** (:class:`TierPlanner`, numpy on the host): spill the
    coldest NORMAL postings while the float-resident count exceeds
    ``cfg.tier_hot_max``; promote on search heat, and force-promote any
    spilled posting that became structurally due (split, merge and
    compact never run on a spilled posting);
  * **the move rounds**: ``spill_round`` zeroes the device tiles and
    raises ``tier_spilled`` once the bytes are in the pool;
    ``promote_round`` writes the pooled bytes back verbatim, so a promote
    restores the float tile bit-identically.

Residency invariants (``core/invariants.check_residency``): a spilled
posting's device tile is all zero and its pool tile encodes to its codes
under its pinned codebook slot; a hot posting is not pooled; ``memory_
tiers()['device'] + ['host']`` equals the untiered total.

The rounds update ``state`` in place, like every round of the port.  On
the card the tier's copies run on a side stream: a spill's tiles are
gathered on the current stream and copied to pinned memory on the side
stream, which waits on the current stream first; the host waits on the
copy's event before the pool takes the bytes and ``spill_round`` zeroes
the device tiles.  Promote tiles go host to device on the side stream,
and the current stream waits on their event before ``promote_round``.

The rounds read and write rows through the state's row interface
(``get_rows`` / ``set_rows`` / ``row_parts``), which a sharded index's
global view (``core.sharded.GlobalView``) shares: a spill's tiles are
read on the card of the shard that owns each posting and copied to
pinned memory on that card's side stream; a promote's tiles go to the
driver's card on its side stream and ``set_rows`` moves each row on to
its shard's card (no move on one card).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.ref import BIG
from . import version_manager as vm
from .types import (STATUS_DELETED, STATUS_NORMAL, IndexState, UBISConfig,
                    state_tier_bytes)

HEAT_ADD_MAX = 1 << 20        # touch_round saturates each add here
UINT32_MASK = 0xFFFFFFFF      # heat wraps as the reference's uint32 does
POOL_CHUNK_TILES = 1024       # the host pool grows by this many tiles


# ---------------------------------------------------------------------------
# the rounds (elementwise / small scatters, in place)
# ---------------------------------------------------------------------------

def touch_round(state: IndexState, counts: torch.Tensor) -> IndexState:
    """Apply host-accumulated touch counts: ``heat += min(counts, 2^20)``,
    modulo 2^32 (the reference's uint32)."""
    add = counts.to(device=state.device, dtype=state.heat.dtype)
    state.heat = (state.heat + add.clamp(max=HEAT_ADD_MAX)) & UINT32_MASK
    return state


def decay_round(state: IndexState) -> IndexState:
    """Halve every touch counter: the driver's fallback for a tick that
    ran no background round (which normally carries the decay)."""
    state.heat = state.heat >> 1
    return state


def spill_round(state: IndexState, cfg: UBISConfig, pids, valid):
    """The reconcile half of a spill: zero the device float tiles and raise
    ``tier_spilled``.  The caller must have the tile bytes in the host
    pool first: this round destroys the device copy."""
    state.set_rows("vectors", pids, 0, valid)
    state.set_rows("tier_spilled", pids, True, valid)
    return state


def promote_round(state: IndexState, cfg: UBISConfig, pids, tiles, valid):
    """Restore pooled float tiles to the device (bit-identical bytes) and
    clear ``tier_spilled``.  Promoted postings land warm (``heat =
    tier_promote_heat``), so the next spill plan does not evict them."""
    state.set_rows("vectors", pids, tiles.to(cfg.dtype), valid)
    state.set_rows("tier_spilled", pids, False, valid)
    state.set_rows("heat", pids, cfg.tier_promote_heat, valid)
    return state


# ---------------------------------------------------------------------------
# the host pool
# ---------------------------------------------------------------------------

class HostTierPool:
    """Host-resident float tiles of spilled postings, keyed by pid.

    One slab of tiles, grown in chunks of ``POOL_CHUNK_TILES`` (pinned when
    ``pin``, so the copies to and from the card are DMA), with a pid ->
    row map and a stack of free rows: a spill allocates nothing once the
    slab covers the working set.  Tiles are stored verbatim in the
    storage dtype, so a promote restores bit-identical bytes; ``get``
    returns a view into the slab."""

    def __init__(self, tile_shape, dtype, *, pin: bool = False):
        self.tile_shape = tuple(tile_shape)
        self.dtype = dtype
        self.pin = bool(pin)
        self.tile_nbytes = int(np.prod(self.tile_shape)) * torch.empty(
            (), dtype=dtype).element_size()
        self._chunks: list = []
        self._row: dict = {}
        self._free: list = []

    def _alloc_row(self) -> int:
        if not self._free:
            n = POOL_CHUNK_TILES
            base = len(self._chunks) * n
            self._chunks.append(torch.zeros((n,) + self.tile_shape,
                                            dtype=self.dtype,
                                            pin_memory=self.pin))
            self._free.extend(range(base + n - 1, base - 1, -1))
        return self._free.pop()

    def _tile(self, row: int) -> torch.Tensor:
        return self._chunks[row // POOL_CHUNK_TILES][row % POOL_CHUNK_TILES]

    def put(self, pid: int, tile) -> None:
        pid = int(pid)
        row = self._row.get(pid)
        if row is None:
            row = self._row[pid] = self._alloc_row()
        self._tile(row).copy_(torch.as_tensor(tile))

    def take(self, pid: int) -> torch.Tensor:
        row = self._row.pop(int(pid))
        self._free.append(row)
        return self._tile(row).clone()

    def get(self, pid: int) -> torch.Tensor:
        return self._tile(self._row[int(pid)])

    def remap(self, src: int, dst: int) -> None:
        """Migration hand-off: the posting moved pids without promoting
        (its tile stays in the same row)."""
        self._row[int(dst)] = self._row.pop(int(src))

    def pids(self) -> np.ndarray:
        return np.asarray(sorted(self._row), np.int32)

    def __len__(self) -> int:
        return len(self._row)

    def __contains__(self, pid) -> bool:
        return int(pid) in self._row

    def nbytes(self) -> int:
        """Bytes of the tiles held (not of the slab's free rows)."""
        return len(self._row) * self.tile_nbytes

    def by_chunk(self, pids):
        """Group ``pids`` by the slab chunk holding them: yields (chunk
        tensor, local rows (n,) int64, positions of those pids in
        ``pids``)."""
        rows = np.asarray([self._row[int(p)] for p in pids], np.int64)
        which = rows // POOL_CHUNK_TILES
        for ci in np.unique(which):
            pos = np.flatnonzero(which == ci)
            yield (self._chunks[int(ci)],
                   torch.from_numpy(rows[pos] % POOL_CHUNK_TILES),
                   pos)

    def rows(self, pids, slots) -> torch.Tensor:
        """The float rows ``tile(pids[i])[slots[i]]`` as an (n, d) fp32
        tensor."""
        slots = np.asarray(slots, np.int64)
        out = torch.empty((len(slots), self.tile_shape[1]),
                          dtype=torch.float32)
        for chunk, local, pos in self.by_chunk(pids):
            out[torch.from_numpy(pos)] = chunk[
                local, torch.from_numpy(slots[pos])].float()
        return out

    def tiles(self, pids) -> torch.Tensor:
        """The tiles of ``pids`` stacked, (n, C, d) in the storage dtype."""
        out = torch.empty((len(pids),) + self.tile_shape, dtype=self.dtype)
        for chunk, local, pos in self.by_chunk(pids):
            out[torch.from_numpy(pos)] = chunk[local]
        return out


# ---------------------------------------------------------------------------
# the spill/promote planner (host-side numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TierPlanner:
    """Picks per-tick spill and promote batches from host views.

    ``hot_max`` is the device high-watermark in float-resident live
    postings (0 disables watermark spilling); ``cold_heat`` /
    ``promote_heat`` are the decayed-counter thresholds; ``max_moves``
    bounds the per-tick batch.
    """

    hot_max: int
    cold_heat: int
    promote_heat: int
    max_moves: int = 32

    #: pid -> reason for the most recent ``plan_promotes`` picks
    #: ("structural-due" | "search-heat" | "wedge-recovery")
    last_promote_reasons: dict = dataclasses.field(default_factory=dict)

    def plan_promotes(self, heat, spilled, allocated, status, lengths,
                      used, *, l_min: int, l_max: int,
                      capacity: int) -> np.ndarray:
        """Spilled postings to promote this tick: structurally-due ones
        first (split/merge/compact need float residency), then by search
        heat, hottest first."""
        self.last_promote_reasons = {}
        alive = np.asarray(allocated) & (np.asarray(status)
                                         != STATUS_DELETED)
        sp = np.asarray(spilled) & alive
        if not sp.any():
            return np.empty(0, np.int32)
        heat = np.asarray(heat)
        lengths = np.asarray(lengths)
        due = sp & ((lengths > l_max) | (lengths < l_min)
                    | (np.asarray(used) >= capacity))
        hot = sp & ~due & (heat >= self.promote_heat)
        due_pids = np.flatnonzero(due)
        hot_pids = np.flatnonzero(hot)
        hot_pids = hot_pids[np.argsort(-heat[hot_pids], kind="stable")]
        picks = np.concatenate([due_pids, hot_pids])
        reasons = (["structural-due"] * len(due_pids)
                   + ["search-heat"] * len(hot_pids))
        # wedge guard: with no float-resident insertable posting left,
        # inserts can only park in the cache, so promote a batch
        n_hot = int((np.asarray(allocated)
                     & (np.asarray(status) == STATUS_NORMAL)
                     & ~np.asarray(spilled)).sum())
        if n_hot == 0 and picks.size == 0:
            rest = np.flatnonzero(sp)
            picks = rest[np.argsort(-heat[rest], kind="stable")]
            reasons = ["wedge-recovery"] * len(picks)
        picks = picks.astype(np.int32)[:self.max_moves]
        self.last_promote_reasons = {int(p): r for p, r
                                     in zip(picks, reasons)}
        return picks

    def plan_spills(self, heat, spilled, allocated, status) -> np.ndarray:
        """Hot postings to spill this tick: only while the float-resident
        live count exceeds the watermark, only NORMAL postings, only ones
        whose heat decayed to ``cold_heat``, coldest first."""
        if self.hot_max <= 0:
            return np.empty(0, np.int32)
        hot = (np.asarray(allocated)
               & (np.asarray(status) == STATUS_NORMAL)
               & ~np.asarray(spilled))
        over = int(hot.sum()) - self.hot_max
        if over <= 0:
            return np.empty(0, np.int32)
        heat = np.asarray(heat)
        cand = np.flatnonzero(hot & (heat <= self.cold_heat))
        cand = cand[np.argsort(heat[cand], kind="stable")]
        return cand.astype(np.int32)[:min(over, self.max_moves)]

    def force_spills(self, n, heat, spilled, allocated,
                     status) -> np.ndarray:
        """Coldest ``n`` hot NORMAL postings regardless of watermark and
        cold threshold (test and benchmark hook; same safety rules)."""
        hot = (np.asarray(allocated)
               & (np.asarray(status) == STATUS_NORMAL)
               & ~np.asarray(spilled))
        cand = np.flatnonzero(hot)
        heat = np.asarray(heat)
        cand = cand[np.argsort(heat[cand], kind="stable")]
        return cand.astype(np.int32)[:n]


# ---------------------------------------------------------------------------
# host-side exact serving for spilled postings
# ---------------------------------------------------------------------------

def host_rerank(found, scores, queries, pool: HostTierPool, loc,
                tier_spilled, capacity: int):
    """Exact rerank of a search's final candidate set against the pool.

    ``found``/``scores`` (Q, k): candidates of spilled postings carry ADC
    scores; ``loc`` is each found id's flat location.  Spilled candidates
    get ``||v||^2 - 2 q.v`` from their pooled row and each row is
    re-sorted (stable): the set cannot grow, only re-rank.  Returns
    (found, scores, the number of spilled candidates)."""
    found = np.asarray(found)
    scores = np.array(scores, np.float32, copy=True)
    loc = np.asarray(loc)
    tier_spilled = np.asarray(tier_spilled)
    in_post = (found >= 0) & (loc >= 0)
    pid = np.where(in_post, loc // capacity, 0)
    # membership guard: the flags are the dispatch's, so a posting
    # promoted since has no pool tile (its candidate keeps its score)
    member = np.zeros(tier_spilled.shape[0], bool)
    pp = pool.pids()
    if pp.size:
        member[pp] = True
    sp = in_post & tier_spilled[pid] & member[pid]
    if not sp.any():
        return found, scores, 0
    qi, ci = np.nonzero(sp)
    vs = pool.rows(pid[qi, ci], loc[qi, ci] % capacity)
    qs = torch.from_numpy(np.ascontiguousarray(queries[qi], np.float32))
    scores[qi, ci] = ((vs * vs).sum(-1) - 2.0 * (qs * vs).sum(-1)).numpy()
    order = np.argsort(scores, axis=1, kind="stable")
    return (np.take_along_axis(found, order, axis=1),
            np.take_along_axis(scores, order, axis=1), int(sp.sum()))


def _smallest(s: torch.Tensor, pos: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row of ``s`` (Q, W) by (score,
    position), ``pos`` (W,) or (Q, W) their distinct positions: (scores,
    positions), each (Q, min(k, W)).  Linear in W (``kthvalue`` finds the
    cut, then only entries at or below it are sorted), equal to a stable
    sort of the rows in position order and a slice."""
    Q, W = s.shape
    pos = pos.expand(Q, W)
    if W > k:
        cut = s.kthvalue(k, dim=1, keepdim=True).values
        r, c = torch.nonzero(s <= cut, as_tuple=True)   # row-major
        vals, p = s[r, c], pos[r, c]
        o = torch.argsort(p, stable=True)
        o = o[torch.argsort(vals[o], stable=True)]
        o = o[torch.argsort(r[o], stable=True)]          # (row, score, pos)
        counts = torch.bincount(r, minlength=Q)
        first = torch.cumsum(counts, 0) - counts
        take = first[:, None] + torch.arange(k)[None, :]
        return vals[o][take], p[o][take]
    o = torch.argsort(pos, dim=1, stable=True)
    s, pos = torch.gather(s, 1, o), torch.gather(pos, 1, o)
    o = torch.argsort(s, dim=1, stable=True)
    return torch.gather(s, 1, o), torch.gather(pos, 1, o)


def host_exact_candidates(pool: HostTierPool, sp_pids, ids_rows,
                          valid_rows, queries, k: int):
    """The top ``k`` of a brute-force scan over the pooled tiles of
    ``sp_pids``, in the repo-wide score convention (invalid slots BIG),
    ties by position in the (pid, slot) order of ``sp_pids``.  Returns
    (scores (Q, k'), ids (Q, k')), k' = min(k, n*C): the host half of the
    exact oracle, merged with a device ``brute_force`` restricted to hot
    postings.  The pool is scanned one slab chunk at a time."""
    queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    Q = queries.shape[0]
    C = pool.tile_shape[0]
    ids_rows = torch.from_numpy(np.asarray(ids_rows, np.int32))
    valid_rows = torch.from_numpy(np.asarray(valid_rows, bool))
    best_s = torch.empty((Q, 0), dtype=torch.float32)
    best_p = torch.empty((Q, 0), dtype=torch.int64)
    for chunk, local, pos in pool.by_chunk(sp_pids):
        flat = chunk[local].float().reshape(-1, chunk.shape[-1])
        s = (flat * flat).sum(-1)[None, :] - 2.0 * (queries @ flat.T)
        pos_t = torch.from_numpy(pos)
        s = torch.where(valid_rows[pos_t].reshape(1, -1), s, BIG)
        gpos = (pos_t[:, None] * C + torch.arange(C)[None, :]).reshape(-1)
        s, p = _smallest(s, gpos, k)
        best_s, best_p = _smallest(torch.cat([best_s, s], 1),
                                   torch.cat([best_p, p], 1), k)
    flat_ids = torch.where(valid_rows, ids_rows, -1).reshape(-1)
    return best_s.numpy(), flat_ids[best_p].numpy()


def merge_topk(found, scores, extra_scores, extra_ids, k: int):
    """Merge a device (Q, k) result with (Q, n) host candidates into the
    final top-k (scores ascending, device entries first on ties, -1 ids
    for missing)."""
    all_s = np.concatenate([np.asarray(scores, np.float32),
                            np.asarray(extra_scores, np.float32)], axis=1)
    all_i = np.concatenate([np.asarray(found), np.asarray(extra_ids)], axis=1)
    order = np.argsort(all_s, axis=1, kind="stable")[:, :k]
    s = np.take_along_axis(all_s, order, axis=1)
    i = np.take_along_axis(all_i, order, axis=1)
    return np.where(s < BIG / 2, i, -1).astype(np.int32), s


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TierPlan:
    """An in-flight tier tick: moves planned and copies started at tick
    start (``TierManager.dispatch``), committed at tick end
    (``TierManager.reconcile``).  Each spill lane carries a staleness
    signature (length and used slots at dispatch): reconcile drops a lane
    whose signature changed or whose posting is no longer a hot NORMAL
    one.  Promote lanes are validated by pool membership."""

    spill_pids: np.ndarray                  # (S,) int32
    spill_tiles: list                       # [(positions, host rows)] in flight
    spill_events: list                      # the copies' ends (card only)
    spill_sig_len: np.ndarray               # (S,) lengths at dispatch
    spill_sig_used: np.ndarray              # (S,) used slots at dispatch
    promote_pids: np.ndarray                # (P,) int32
    promote_tiles: Optional[torch.Tensor]   # (P, C, d) on the device
    promote_event: Optional[torch.cuda.Event]


def plan_tier_moves(planner: TierPlanner, rows: dict, cfg: UBISConfig):
    """The tier tick's decision half, a pure function of the observed
    rows (heat / spilled / alloc / status / lengths / used): returns
    (promote_pids, spill_pids).  Promoted postings' heat is mirrored as
    ``promote_round`` will write it, and nothing promoted is spilled in
    the same tick (no promote/spill livelock)."""
    promos = planner.plan_promotes(
        rows["heat"], rows["spilled"], rows["alloc"], rows["status"],
        rows["lengths"], rows["used"],
        l_min=cfg.l_min, l_max=cfg.l_max, capacity=cfg.capacity)
    spilled = rows["spilled"].copy()
    spilled[promos] = False
    heat = rows["heat"].copy()
    heat[promos] = planner.promote_heat
    spills = planner.plan_spills(heat, spilled, rows["alloc"],
                                 rows["status"])
    if len(promos):
        spills = spills[~np.isin(spills, promos)]
    return promos, spills


class TierManager:
    """Host orchestration of the cold tier for one driver: the host pool,
    the planner, the touch accumulator (an (M,) count vector, applied by
    one ``touch_round`` per tick) and, on the card, the side stream of
    the tier's copies.

    The per-tick step comes in two shapes: the synchronous ``tick`` (plan
    and move in one call) and the split ``dispatch``/``reconcile`` pair
    that starts the copies before the driver's background round and
    commits after it (``tier_async``).  Every method returns the state
    (updated in place) and the counts it moved."""

    def __init__(self, cfg: UBISConfig, device, *, max_moves: int = 32,
                 rerank_host: bool = True, obs=None):
        self.cfg = cfg
        self.device = torch.device(device)
        on_card = self.device.type == "cuda"
        self.pool = HostTierPool((cfg.capacity, cfg.dim), cfg.dtype,
                                 pin=on_card)
        self.planner = TierPlanner(cfg.tier_hot_max, cfg.tier_cold_heat,
                                   cfg.tier_promote_heat,
                                   max_moves=max_moves)
        self._counts = np.zeros(cfg.max_postings, np.int64)
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        self._sides = {}          # another card's side stream (shards)
        self.rerank_host = bool(rerank_host)
        self.obs = obs
        # every commit decision (reconcile and the forced, retrain-pinned
        # paths) is also kept here, so a cluster worker can drain it and
        # the coordinator re-emit it on its own trace plane; cleared on
        # ``adopt``
        self.commit_log: list = []

    def _emit(self, kind: str, **fields) -> None:
        if self.obs is not None:
            self.obs.emit(kind, **fields)

    def _commit(self, **fields) -> None:
        self.commit_log.append(fields)
        self._emit("tier_commit", **fields)

    def drain_commits(self) -> list:
        """The commits since the last drain (and forget them)."""
        out, self.commit_log = self.commit_log, []
        return out

    # ---- copies between the card and the pool -------------------------

    def _side(self, device: torch.device):
        """The side stream of ``device`` (the driver's, or a shard's)."""
        if device == self._stream.device:
            return self._stream
        side = self._sides.get(device)
        if side is None:
            side = self._sides[device] = torch.cuda.Stream(device)
        return side

    def _to_host(self, tiles: torch.Tensor):
        """Start the copy of device ``tiles`` to pinned host memory on the
        side stream of their card; returns (host tensor, event) — the
        bytes are there once the event has completed.  On the CPU:
        (tiles, None)."""
        if self._stream is None:
            return tiles, None
        dev = tiles.device
        side = self._side(dev)
        host = torch.empty(tiles.shape, dtype=tiles.dtype, pin_memory=True)
        with torch.cuda.device(dev):
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                host.copy_(tiles, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            tiles.record_stream(side)
        return host, ev

    def _spill_copy(self, state, pids: np.ndarray):
        """Start the copies of the float tiles of ``pids`` to the host,
        each part from the card it lives on (``state.row_parts``: one
        part for an ``IndexState``, one a shard for a sharded index's
        global view): ([(positions in pids, host rows)], the events)."""
        M = self.cfg.max_postings
        pids_t = torch.from_numpy(np.asarray(pids, np.int64)).clamp(0, M - 1)
        parts, events = [], []
        for at, rows in state.row_parts("vectors", pids_t):
            host, ev = self._to_host(rows)
            parts.append((at, host))
            if ev is not None:
                events.append(ev)
        return parts, events

    def _landed(self, parts: list, events: list, n: int) -> torch.Tensor:
        """Wait for a spill's copies and return its (n, C, d) host tiles."""
        for ev in events:
            ev.synchronize()
        if len(parts) == 1 and len(parts[0][0]) == n:
            return parts[0][1]          # one part holds them all, in order
        out = torch.empty((n,) + self.pool.tile_shape, dtype=self.pool.dtype)
        for at, host in parts:
            out[at] = host
        return out

    def _to_device(self, tiles: torch.Tensor):
        """Start the copy of pinned host ``tiles`` to the device on the side
        stream; returns (device tensor, event): a stream must wait on the
        event before it reads the tensor."""
        if self._stream is None:
            return tiles, None
        out = torch.empty(tiles.shape, dtype=tiles.dtype, device=self.device)
        # ``out`` may reuse memory the current stream's queued work reads
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            out.copy_(tiles, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return out, ev

    def _staged(self, pids, take: bool) -> torch.Tensor:
        """The pool tiles of ``pids`` in one (pinned, on the card) host
        tensor; ``take`` removes them from the pool."""
        staged = torch.empty((len(pids),) + self.pool.tile_shape,
                             dtype=self.pool.dtype,
                             pin_memory=self._stream is not None)
        for i, pid in enumerate(pids):
            staged[i] = self.pool.take(pid) if take else self.pool.get(pid)
        return staged

    # ---- heat bookkeeping (host-side accumulation) --------------------

    def note_probes(self, probe) -> None:
        """Search touched these postings (any int array of pids)."""
        p = np.asarray(probe).ravel()
        M = self._counts.shape[0]
        p = p[(p >= 0) & (p < M)]
        self._counts += np.bincount(p, minlength=M)

    note_targets = note_probes     # accepted appends touch the same way

    # ---- the per-tick tier step ---------------------------------------

    def tick(self, state: IndexState, *, decayed: bool):
        """Apply the touches, decay (when no background round ran this
        tick), promote, then spill: dispatch and an immediate reconcile.
        Returns (state, n_spilled, n_promoted)."""
        state, plan = self.dispatch(state, decayed=decayed)
        return self.reconcile(state, plan)

    def dispatch(self, state: IndexState, *, decayed: bool):
        """Tick-start half: apply touches and decay, plan this tick's
        moves and start their copies.  Returns (state, plan or None);
        ``decayed`` says whether a background round carries the decay."""
        state, rows = self.observe(state, decayed=decayed)
        promos, spills = plan_tier_moves(self.planner, rows, self.cfg)
        return self.dispatch_planned(
            state, rows, promos, spills,
            reasons=self.planner.last_promote_reasons)

    def observe(self, state: IndexState, *, decayed: bool):
        """Apply the accumulated touches and the decay, then read the
        planner's observation rows (numpy).  Returns (state, rows)."""
        if self._counts.any():
            state = touch_round(state, torch.from_numpy(self._counts))
            self._counts[:] = 0
        if not decayed:
            state = decay_round(state)
        rows = {
            "heat": state.heat.cpu().numpy(),
            "spilled": state.tier_spilled.cpu().numpy(),
            "alloc": state.allocated.cpu().numpy(),
            "status": vm.unpack_status(state.rec_meta).cpu().numpy(),
            "lengths": state.lengths.cpu().numpy(),
            "used": state.used.cpu().numpy(),
        }
        return state, rows

    def dispatch_planned(self, state: IndexState, rows: dict, promos,
                         spills, reasons: Optional[dict] = None):
        """Start the copies of an already-planned move set (``rows`` is
        the observation the plan was made from: its lengths and used
        slots become the spill signatures).  Returns (state, plan or
        None)."""
        promos = np.asarray(promos, np.int32).ravel()
        spills = np.asarray(spills, np.int32).ravel()
        if not len(promos) and not len(spills):
            return state, None
        reasons = reasons or {}
        self._emit("tier_plan",
                   promotes=[{"pid": int(p),
                              "reason": reasons.get(int(p), "search-heat")}
                             for p in promos],
                   spills=[{"pid": int(p), "reason": "watermark-cold"}
                           for p in spills])
        spill_tiles, spill_events = self._spill_copy(state, spills)
        promote_tiles = promote_event = None
        if len(promos):
            promote_tiles, promote_event = self._to_device(
                self._staged(promos, take=False))
        plan = TierPlan(
            spill_pids=spills, spill_tiles=spill_tiles,
            spill_events=spill_events,
            spill_sig_len=rows["lengths"][spills].copy(),
            spill_sig_used=rows["used"][spills].copy(),
            promote_pids=promos, promote_tiles=promote_tiles,
            promote_event=promote_event)
        return state, plan

    def reconcile(self, state: IndexState, plan: Optional[TierPlan]):
        """Tick-end half: validate the dispatched plan against the current
        state and commit the lanes still fresh.  Returns (state,
        n_spilled, n_promoted).

        Promotes first, validated by pool membership (a mid-tick
        ``promote_retrain_pinned`` may have promoted a planned pid).
        Spills are validated by the staleness signature: a lane whose
        posting was appended to, compacted, marked or already spilled
        since dispatch is dropped and simply re-planned next tick."""
        if plan is None:
            return state, 0, 0
        cfg = self.cfg
        dev = state.device
        p_pids = plan.promote_pids
        p_valid = np.array([int(p) in self.pool for p in p_pids], bool)
        n_p = int(p_valid.sum())
        if n_p:
            for pid in p_pids[p_valid]:
                self.pool.take(int(pid))       # bytes already staged
            if plan.promote_event is not None:
                torch.cuda.current_stream(dev).wait_event(plan.promote_event)
            state = promote_round(state, cfg,
                                  torch.from_numpy(p_pids).to(dev),
                                  plan.promote_tiles,
                                  torch.from_numpy(p_valid).to(dev))
        s_pids = plan.spill_pids
        status = vm.unpack_status(state.rec_meta).cpu().numpy()
        s_valid = ((status[s_pids] == STATUS_NORMAL)
                   & ~state.tier_spilled.cpu().numpy()[s_pids]
                   & state.allocated.cpu().numpy()[s_pids]
                   & (state.lengths.cpu().numpy()[s_pids]
                      == plan.spill_sig_len)
                   & (state.used.cpu().numpy()[s_pids]
                      == plan.spill_sig_used))
        # the copy must have landed before the pool reads the bytes and
        # spill_round zeroes the device tiles
        tiles = self._landed(plan.spill_tiles, plan.spill_events,
                             len(s_pids))
        n_s = int(s_valid.sum())
        if n_s:
            for i in np.flatnonzero(s_valid):
                self.pool.put(int(s_pids[i]), tiles[i])
            state = spill_round(state, cfg, torch.from_numpy(s_pids).to(dev),
                                torch.from_numpy(s_valid).to(dev))
        self._commit(
            spilled=[int(p) for p in s_pids[s_valid]],
            promoted=[int(p) for p in p_pids[p_valid]],
            dropped_spills=[{"pid": int(p), "reason": "stale-signature"}
                            for p in s_pids[~s_valid]],
            dropped_promotes=[{"pid": int(p), "reason": "pool-missing"}
                              for p in p_pids[~p_valid]])
        return state, n_s, n_p

    def force_spill(self, state: IndexState, n: int):
        """Spill the ``n`` coldest hot NORMAL postings now (test and
        benchmark hook; ignores the watermark and cold threshold)."""
        pids = self.planner.force_spills(
            int(n), state.heat.cpu().numpy(),
            state.tier_spilled.cpu().numpy(), state.allocated.cpu().numpy(),
            vm.unpack_status(state.rec_meta).cpu().numpy())
        return self._spill(state, pids, reason="forced")

    def force_promote(self, state: IndexState, n=None):
        """Promote up to ``n`` spilled postings (all of them when None),
        hottest first."""
        pids = self.pool.pids()
        if len(pids):
            heat = state.heat.cpu().numpy()
            pids = pids[np.argsort(-heat[pids], kind="stable")]
        if n is not None:
            pids = pids[:int(n)]
        return self._promote(state, pids, reason="forced")

    def promote_retrain_pinned(self, state: IndexState):
        """Quant interplay: ``pq.retrain_round`` re-encodes postings
        pinned to the slot it evicts from their device float tiles, and a
        spilled posting's tile is zeroed, so the spilled postings pinned
        to that slot are promoted first (they re-spill later if still
        cold).  Returns (state, n_promoted); call right before the
        re-train."""
        if not len(self.pool):
            return state, 0
        evict = (int(state.pq_active) + 1) % self.cfg.pq_versions
        pslot = state.pq_posting_slot.cpu().numpy()
        sp = self.pool.pids()
        pinned = sp[pslot[sp] == evict]
        if not pinned.size:
            return state, 0
        return self._promote(state, pinned, reason="retrain-pinned")

    # ---- move execution (chunked at the planner's batch width) --------

    def _spill(self, state: IndexState, pids, reason: str = ""):
        # no reason: ``adopt``'s re-derivation, which is no decision
        B = self.planner.max_moves
        dev = state.device
        pids = np.asarray(pids, np.int32)
        for off in range(0, len(pids), B):
            chunk = pids[off:off + B]
            tiles = self._landed(*self._spill_copy(state, chunk), len(chunk))
            for i, pid in enumerate(chunk):
                self.pool.put(int(pid), tiles[i])
            state = spill_round(state, self.cfg,
                                torch.from_numpy(chunk).to(dev),
                                torch.ones(len(chunk), dtype=torch.bool,
                                           device=dev))
        if reason and len(pids):
            self._commit(spilled=[int(p) for p in pids], promoted=[],
                         dropped_spills=[], dropped_promotes=[],
                         reason=reason)
        return state, len(pids)

    def _promote(self, state: IndexState, pids, reason: str = ""):
        B = self.planner.max_moves
        dev = state.device
        pids = np.asarray(pids, np.int32)
        for off in range(0, len(pids), B):
            chunk = pids[off:off + B]
            tiles, ev = self._to_device(self._staged(chunk, take=True))
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)
            state = promote_round(state, self.cfg,
                                  torch.from_numpy(chunk).to(dev), tiles,
                                  torch.ones(len(chunk), dtype=torch.bool,
                                             device=dev))
        if reason and len(pids):
            self._commit(spilled=[], promoted=[int(p) for p in pids],
                         dropped_spills=[], dropped_promotes=[],
                         reason=reason)
        return state, len(pids)

    # ---- host-side exact serving --------------------------------------

    def rerank(self, queries, found, scores, loc, tier_spilled):
        """Host exact rerank of a search's final candidate set; ``loc``
        and ``tier_spilled`` are the index's as of the search's dispatch.
        Returns (found, scores, spilled candidates reranked); with
        ``rerank_host`` off, the candidates unchanged."""
        if not self.rerank_host or not len(self.pool):
            return np.asarray(found), np.asarray(scores), 0
        return host_rerank(found, scores, queries, self.pool, loc,
                           tier_spilled, self.cfg.capacity)

    def exact_merge(self, state: IndexState, queries, found, scores,
                    k: int):
        """Merge a device oracle result (spilled postings excluded) with a
        host scan of the pooled tiles of the visible spilled postings."""
        sp = self.pool.pids()
        if len(sp) == 0:
            return np.asarray(found), np.asarray(scores)
        vis = vm.visible(state.rec_meta, state.allocated,
                         state.global_version).cpu().numpy()
        sp = sp[vis[sp]]
        if len(sp) == 0:
            return np.asarray(found), np.asarray(scores)
        idx = torch.from_numpy(sp.astype(np.int64))
        es, ei = host_exact_candidates(
            self.pool, sp, state.get_rows("ids", idx).cpu().numpy(),
            state.get_rows("slot_valid", idx).cpu().numpy(), queries, k)
        return merge_topk(found, scores, es, ei, k)

    # ---- snapshot / restore -------------------------------------------

    def snapshot_fill(self, state: IndexState) -> IndexState:
        """A self-contained snapshot: the spilled float tiles written into
        ``state`` (a copy the caller owns; ``tier_spilled`` stays set, so a
        restore re-derives residency)."""
        pids = self.pool.pids()
        for off in range(0, len(pids), POOL_CHUNK_TILES):
            part = pids[off:off + POOL_CHUNK_TILES]
            idx = torch.from_numpy(part.astype(np.int64)).to(state.device)
            state.vectors[idx] = self.pool.tiles(part).to(state.device)
        return state

    def adopt(self, state: IndexState) -> IndexState:
        """Restore path: rebuild the pool from a filled snapshot (see
        ``snapshot_fill``) and re-zero the spilled device tiles."""
        self.pool = HostTierPool(self.pool.tile_shape, self.pool.dtype,
                                 pin=self.pool.pin)
        self._counts[:] = 0
        self.commit_log = []
        sp = np.flatnonzero((state.tier_spilled & state.allocated)
                            .cpu().numpy())
        state.tier_spilled = torch.zeros_like(state.tier_spilled)
        if sp.size:
            state, _ = self._spill(state, sp.astype(np.int32))
        return state

    def memory_tiers(self, state: IndexState) -> dict:
        return state_tier_bytes(state)
