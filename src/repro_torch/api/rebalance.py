"""Host-side cross-shard rebalance planning (the control plane).

The sharded background program reports per-shard pressure rows
``(live_postings, free_slots, cache_backlog, live_vectors)`` —
``balance.shard_pressure`` computed inside the tick, zero extra
collectives.  ``RebalancePlanner`` turns those rows plus a host view of
the posting-length table into donor -> receiver posting migrations for
``core.sharded.make_sharded_migrate``.  The port's own copy of the JAX
package's planner (pure numpy, no device state).

Two triggers, in priority order:

  * **slot saturation** — a shard whose live sub-pool crosses the
    ``watermark`` fraction is the paper's "imbalanced distribution"
    failure mode lifted to the pod: its splits defer (no local free
    slot until epoch GC) and its inserts park in the host cache while
    cold shards sit on free capacity.  The parked-cache backlog counts
    toward saturation (as ``min_gap``-vector posting equivalents) — a
    shard drowning in parked jobs triggers even below the live-posting
    watermark.  Donors above the watermark shed postings until they
    project below it.
  * **vector imbalance** — even without saturation, a skewed stream
    concentrates live vectors; when the max/min shard occupancy ratio
    exceeds ``ratio_target`` (and the absolute gap is worth at least a
    posting), postings flow from the heaviest to the lightest shard.

The plan is greedy and *simulated-monotone*: every move updates the
planner's local copy of the pressure rows, a vector-mode move must fit
HALF the donor->receiver occupancy gap (a move of mass L closes the gap
by 2L, so the gap strictly shrinks and the pair can never swap roles —
the ping-pong guard), and receivers are only shards with free slots
that stay below the watermark.  The planner is
pure host-side numpy: it owns no device state and is trivially testable.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RebalancePlanner:
    """Picks donor->receiver posting migrations from pressure stats.

    ``n_shards`` / ``pool_per_shard`` describe the mesh layout
    (``max_postings // n_shards`` local pids per shard, contiguous
    blocks).  ``min_gap`` is the absolute live-vector gap below which
    vector-mode rebalance is not worth a migration (default: one full
    posting, set by the driver to ``cfg.l_max``).
    """

    n_shards: int
    pool_per_shard: int
    watermark: float = 0.85
    ratio_target: float = 1.2
    max_moves: int = 8
    min_gap: int = 80
    #: per-move decision records from the most recent ``plan`` call:
    #: ``{"src", "dst", "donor", "trigger": "watermark" | "spread"}`` —
    #: the obs plane's rebalance trace payload
    last_moves: list = dataclasses.field(default_factory=list)

    def _saturation(self, live, backlog):
        """Slot-saturation fraction per shard.  Parked-cache backlog
        counts as demand the shard has already failed to absorb: it is
        converted to posting-slots-worth at ``min_gap`` (= one full
        posting) vectors each, so a shard drowning in parked jobs
        triggers even while its live-posting count sits below the
        watermark."""
        pending = np.asarray(backlog, float) / max(self.min_gap, 1)
        return (np.asarray(live, float) + pending) / self.pool_per_shard

    def needs(self, pressure: np.ndarray) -> bool:
        """Cheap per-tick gate: does this pressure report justify pulling
        the (M,)-sized host views and running ``plan``?"""
        if self.n_shards < 2:
            return False
        p = np.asarray(pressure)
        if (self._saturation(p[:, 0], p[:, 2]) > self.watermark).any():
            return True
        occ = p[:, 3].astype(float)
        gap = occ.max() - occ.min()
        return bool(gap > self.min_gap
                    and occ.max() > max(occ.min(), 1.0) * self.ratio_target)

    def plan(self, pressure: np.ndarray, lengths: np.ndarray,
             movable: np.ndarray):
        """Returns (src_pids, dst_shards) int32 arrays, at most
        ``max_moves`` long.

        ``lengths`` is the global posting-length table; ``movable``
        marks postings that may migrate (allocated + NORMAL — the
        migrate round re-checks on device, so a stale host view only
        costs a skipped job, never a lost posting).

        Each accepted move is recorded in ``last_moves`` with its
        trigger ("watermark" = slot saturation, "spread" = vector
        imbalance) for the caller's trace events.
        """
        S, pool = self.n_shards, self.pool_per_shard
        p = np.asarray(pressure).astype(float)
        live = p[:, 0].copy()
        free = p[:, 1].copy()
        backlog = p[:, 2].copy()
        occ = p[:, 3].copy()
        lengths = np.asarray(lengths)
        movable = np.asarray(movable)
        # per-shard donor candidates, longest first (a long posting
        # shifts the most vector mass per migration)
        cands = []
        for s in range(S):
            pids = np.flatnonzero(movable[s * pool:(s + 1) * pool]
                                  & (lengths[s * pool:(s + 1) * pool] > 0))
            pids = pids + s * pool
            cands.append(list(pids[np.argsort(-lengths[pids])]))

        src, dst = [], []
        self.last_moves = []
        for _ in range(self.max_moves):
            sat = self._saturation(live, backlog)
            over = np.flatnonzero(sat > self.watermark)
            if len(over):
                d = int(over[np.argmax(sat[over])])
                slot_mode = True                    # slot mode: any length
            else:
                d = int(np.argmax(occ))
                r0 = int(np.argmin(occ))
                gap0 = occ[d] - occ[r0]
                if (gap0 <= self.min_gap
                        or occ[d] <= max(occ[r0], 1.0) * self.ratio_target):
                    break
                slot_mode = False
            # receiver: lightest shard with a free slot, below watermark
            order = np.argsort(occ)
            r = next((int(s) for s in order
                      if s != d and free[s] > 0
                      and (live[s] + 1) / pool <= self.watermark), None)
            if r is None:
                break
            # vector mode: the move must fit HALF the gap to the shard
            # actually receiving (occ[d] -= L, occ[r] += L closes the
            # gap by 2L) — every move strictly shrinks the donor/receiver
            # gap, so the pair can never swap roles and re-migrate the
            # same posting back (the ping-pong guard)
            gap_cap = None if slot_mode else (occ[d] - occ[r]) / 2.0
            if gap_cap is not None and gap_cap <= 0:
                break
            pick = None
            for i, pid in enumerate(cands[d]):
                if gap_cap is None or lengths[pid] <= gap_cap:
                    pick = cands[d].pop(i)
                    break
            if pick is None:
                break
            src.append(pick)
            dst.append(r)
            self.last_moves.append(
                {"src": int(pick), "dst": int(r), "donor": int(d),
                 "trigger": "watermark" if slot_mode else "spread"})
            mass = float(lengths[pick])
            occ[d] -= mass
            occ[r] += mass
            live[d] -= 1                 # donor copy retires immediately
            live[r] += 1
            free[r] -= 1                 # donor slot frees only after GC
        return (np.asarray(src, np.int32), np.asarray(dst, np.int32))
