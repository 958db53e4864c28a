"""The open-loop serving engine: continuous batching over any engine.

Counterpart of ``repro/serving/engine.py``, with the same scheduling
decisions, so a seeded trace on a fake clock gives the same batch log
over either package's driver.

``ServingEngine`` sits between per-request callers and the batch-first
``StreamingIndex`` contract.  Callers submit single queries or ingest
batches and get a :class:`~repro_torch.api.types.Ticket` back immediately;
the engine folds pending requests into padded device batches and fires
a batch when it FILLS (``search_batch`` requests / ``insert_batch``
jobs) or when the OLDEST pending request hits the lane's deadline —
whichever comes first.  Two lanes, scheduled independently:

  * **search lane** — single-query requests folded into one padded
    ``(B, d)`` batch per fire; each ticket resolves to a one-row
    ``SearchResult`` whose ``seconds`` is the request's queue+service
    latency;
  * **update lane** — insert/delete submissions kept in FIFO order
    (interleaving inserts and deletes of the same id must replay in
    submission order); consecutive insert submissions are concatenated
    into one driver call.  A ticket whose submission was folded with
    others resolves to the *group's* aggregate ``UpdateResult`` — exact
    per-op results come from draining after each submit, which is what
    ``QueuedIndex`` does.

**Overlap.**  When both lanes are due and the index supports the
non-blocking seam (``dispatch_search``/``collect_search``), the engine
dispatches the search batch first, runs the update flush (and, on
cadence, the background tick) while the device executes the search, and
only then collects: the search's kernels are queued on the CUDA stream
before any later round's, and ``collect_search`` is the one copy back to
the host.  The collected result answers for the index as of dispatch
time, so overlap never changes what a search observes.

**Tick cadence.**  The engine owns background-tick cadence:
``tick_every = N`` runs one ``index.tick()`` after every N update-lane
flushes (0 = never — the caller ticks).  The synchronous
``RetrievalServer`` path ticks once per ingest by default; see
``launch/serve.py``.

**Clock.**  Every timestamp comes from the injectable ``clock``
callable, so a seeded arrival trace replays deterministically in tests
and an open-loop benchmark can run on a *virtual* clock (advance time by
measured service seconds, never sleep).
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Callable, List, Optional, Tuple

import dataclasses

import numpy as np

from ..api.types import SearchRequest, SearchResult, Ticket
from ..obs import Obs


@dataclasses.dataclass
class ServingConfig:
    """Knobs for the two batching lanes (see the module docstring).

    ``search_batch`` is the padded device batch width — every fired
    search costs exactly one (B, d) program call, short batches ride
    with zero-padded rows.  Deadlines bound the queueing delay the
    batching may add to the OLDEST request in a lane.

    Observability knobs: ``recall_probe`` shadow-executes that fraction
    of served search batches against ``index.exact()`` off the hot path
    (rolling ``live_recall`` gauge over the last 64 probes, at most 8
    rows each); ``obs_profile_dir`` wraps the first pump that fires work
    in a ``torch.profiler`` capture.
    """

    search_batch: int = 32
    insert_batch: int = 256
    search_deadline_s: float = 2e-3
    insert_deadline_s: float = 10e-3
    tick_every: int = 1          # background tick per N update flushes
    default_k: int = 10
    recall_probe: float = 0.0    # fraction of served batches probed
    obs_profile_dir: Optional[str] = None


@dataclasses.dataclass
class _UpdateJob:
    kind: str                    # "insert" | "delete"
    vecs: Optional[np.ndarray]
    ids: np.ndarray
    ticket: Ticket


class ServingEngine:
    """Request queue + dynamic batcher over one ``StreamingIndex``."""

    def __init__(self, index, config: Optional[ServingConfig] = None, *,
                 clock: Callable[[], float] = time.perf_counter,
                 obs: Optional[Obs] = None):
        self.index = index
        self.cfg = config if config is not None else ServingConfig()
        self.clock = clock
        self._search_q: deque[SearchRequest] = deque()
        self._update_q: deque[_UpdateJob] = deque()
        self._seq = 0
        self._flushes_since_tick = 0
        self.counters = defaultdict(int)
        # (lane, n_requests_or_jobs, reason) per fired batch — the
        # determinism tests replay a seeded trace against this log
        self.batch_log: List[Tuple[str, int, str]] = []
        self._can_overlap = (hasattr(index, "dispatch_search")
                             and hasattr(index, "collect_search"))
        # obs plane: reuse the index's so ONE exposition covers driver
        # internals and request spans; fall back to a private one
        self.obs = (obs if obs is not None
                    else getattr(index, "obs", None) or Obs())
        # request-span histograms (engine-clock seconds): queue wait
        # (submit → fire), service (fire → resolve), end-to-end latency,
        # and the update-flush work overlapped inside dispatch→collect
        self._h_queue = self.obs.histogram("serve_queue_wait_seconds")
        self._h_service = self.obs.histogram("serve_service_seconds")
        self._h_latency = self.obs.histogram("serve_latency_seconds")
        self._h_overlap = self.obs.histogram("serve_flush_overlap_seconds")
        self._g_fill = self.obs.gauge("serve_batch_fill")
        self.probe = (self.obs.make_probe(index,
                                          fraction=self.cfg.recall_probe)
                      if self.cfg.recall_probe > 0 and hasattr(index, "exact")
            else None)
        self._profiled = False

    # ------------------------------------------------------------------
    # submission (returns immediately; tickets resolve on pump)
    # ------------------------------------------------------------------

    def _ticket(self, kind: str) -> Ticket:
        self._seq += 1
        return Ticket(kind=kind, seq=self._seq, t_submit=self.clock(),
                      _pump=self.pump)

    def submit_search(self, vector, k: Optional[int] = None) -> Ticket:
        """Enqueue ONE query; the ticket resolves to a one-row
        ``SearchResult``."""
        vec = np.asarray(vector, np.float32).reshape(-1)
        t = self._ticket("search")
        self._search_q.append(SearchRequest(
            vector=vec, k=int(k if k is not None else self.cfg.default_k),
            t_submit=t.t_submit, ticket=t))
        return t

    def submit_insert(self, vecs, ids) -> Ticket:
        vecs = np.asarray(vecs, np.float32)
        ids = np.asarray(ids, np.int64)
        t = self._ticket("insert")
        self._update_q.append(_UpdateJob("insert", vecs, ids, t))
        return t

    def submit_delete(self, ids) -> Ticket:
        ids = np.asarray(ids, np.int64)
        t = self._ticket("delete")
        self._update_q.append(_UpdateJob("delete", None, ids, t))
        return t

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self._search_q and not self._update_q

    def pending(self) -> Tuple[int, int]:
        """(queued search requests, queued update jobs)."""
        return (len(self._search_q),
                sum(len(j.ids) for j in self._update_q))

    def next_deadline(self) -> Optional[float]:
        """The earliest absolute clock time at which a lane fires
        without further arrivals — ``clock()`` itself when a lane is
        already due, None when both lanes are empty.  A virtual-clock
        caller advances time to ``min(next arrival, this)``."""
        now = self.clock()
        times = []
        if self._search_q:
            if len(self._search_q) >= self.cfg.search_batch:
                return now
            times.append(self._search_q[0].t_submit
                         + self.cfg.search_deadline_s)
        if self._update_q:
            if (sum(len(j.ids) for j in self._update_q)
                    >= self.cfg.insert_batch):
                return now
            times.append(self._update_q[0].ticket.t_submit
                         + self.cfg.insert_deadline_s)
        return min(times) if times else None

    # ------------------------------------------------------------------
    # the pump: one scheduling step
    # ------------------------------------------------------------------

    def pump(self, *, force: bool = False) -> int:
        """Fire every lane that is due (``force=True``: fire non-empty
        lanes regardless of fill/deadline).  Returns the number of
        tickets resolved.  When both lanes are due and the index has
        the non-blocking seam, the update flush (and cadence tick) runs
        INSIDE the search's dispatch→collect window."""
        now = self.clock()
        s_reason = self._search_due(now, force)
        u_reason = self._update_due(now, force)
        if ((s_reason or u_reason) and self.cfg.obs_profile_dir
                and not self._profiled):
            # opt-in device profiling: capture exactly one working pump
            self._profiled = True
            with self.obs.profile(self.cfg.obs_profile_dir):
                return self._pump_lanes(s_reason, u_reason)
        return self._pump_lanes(s_reason, u_reason)

    def _pump_lanes(self, s_reason: Optional[str],
                    u_reason: Optional[str]) -> int:
        resolved = 0
        if s_reason:
            reqs = self._take_search_batch()
            box = [0]
            work = None
            if u_reason:
                def work(u_reason=u_reason):
                    box[0] = self._flush_updates(u_reason)
            resolved += self._fire_search(reqs, s_reason,
                                          overlap_work=work)
            resolved += box[0]
        elif u_reason:
            resolved += self._flush_updates(u_reason)
        return resolved

    def drain(self) -> int:
        """Pump with force until both lanes are empty."""
        resolved = 0
        while not self.idle:
            resolved += self.pump(force=True)
        return resolved

    def tick(self):
        """Run one background tick on the wrapped index now (on top of
        whatever ``tick_every`` cadence the engine runs itself)."""
        self.counters["ticks"] += 1
        return self.index.tick()

    # ------------------------------------------------------------------

    def _search_due(self, now: float, force: bool) -> Optional[str]:
        if not self._search_q:
            return None
        if len(self._search_q) >= self.cfg.search_batch:
            return "fill"
        if now >= self._search_q[0].t_submit + self.cfg.search_deadline_s:
            return "deadline"
        return "force" if force else None

    def _update_due(self, now: float, force: bool) -> Optional[str]:
        if not self._update_q:
            return None
        if (sum(len(j.ids) for j in self._update_q)
                >= self.cfg.insert_batch):
            return "fill"
        if (now >= self._update_q[0].ticket.t_submit
                + self.cfg.insert_deadline_s):
            return "deadline"
        return "force" if force else None

    def _take_search_batch(self) -> List[SearchRequest]:
        """Pop the longest FIFO prefix sharing one ``k`` (a padded
        device batch runs at a single k), capped at ``search_batch``."""
        reqs = [self._search_q.popleft()]
        while (self._search_q and len(reqs) < self.cfg.search_batch
               and self._search_q[0].k == reqs[0].k):
            reqs.append(self._search_q.popleft())
        return reqs

    def _fire_search(self, reqs: List[SearchRequest], reason: str,
                     overlap_work: Optional[Callable[[], None]] = None
                     ) -> int:
        B = self.cfg.search_batch
        vecs = np.stack([r.vector for r in reqs])
        if len(reqs) < B:
            vecs = np.concatenate(
                [vecs, np.zeros((B - len(reqs), vecs.shape[1]),
                                np.float32)])
        t_fire = self.clock()
        for r in reqs:
            self._h_queue.record(max(t_fire - r.t_submit, 0.0))
        self._g_fill.set(len(reqs) / B)
        if self._can_overlap:
            disp = self.index.dispatch_search(vecs, reqs[0].k)
            if overlap_work is not None:
                t_w = self.clock()
                overlap_work()          # runs while the device searches
                self._h_overlap.record(max(self.clock() - t_w, 0.0))
            res = self.index.collect_search(disp)
        else:
            res = self.index.search(vecs, reqs[0].k)
            if overlap_work is not None:
                overlap_work()
        now = self.clock()
        for i, r in enumerate(reqs):
            r.ticket._resolve(
                SearchResult(ids=res.ids[i:i + 1],
                             scores=res.scores[i:i + 1],
                             seconds=now - r.t_submit), now)
        self._h_service.record(max(now - t_fire, 0.0))
        for r in reqs:
            self._h_latency.record(max(now - r.t_submit, 0.0))
        if self.probe is not None:
            # shadow-execute a sampled fraction against exact() — AFTER
            # the tickets resolved, so the probe is off the hot path
            self.probe.maybe_probe(vecs[:len(reqs)], reqs[0].k,
                                   np.asarray(res.ids)[:len(reqs)])
        self.counters["search_batches"] += 1
        self.counters["search_requests"] += len(reqs)
        self.counters["search_padded"] += B - len(reqs)
        self.counters[f"search_{reason}"] += 1
        self.batch_log.append(("search", len(reqs), reason))
        return len(reqs)

    def _flush_updates(self, reason: str) -> int:
        """Execute up to ``insert_batch`` queued update jobs in FIFO
        order, concatenating consecutive insert submissions into one
        driver call; then run the cadence tick."""
        budget = self.cfg.insert_batch
        n_jobs = 0
        resolved = 0
        while self._update_q and n_jobs < budget:
            if self._update_q[0].kind == "insert":
                group = [self._update_q.popleft()]
                n_jobs += len(group[0].ids)
                while (self._update_q and n_jobs < budget
                       and self._update_q[0].kind == "insert"):
                    g = self._update_q.popleft()
                    group.append(g)
                    n_jobs += len(g.ids)
                res = self.index.insert(
                    np.concatenate([g.vecs for g in group]),
                    np.concatenate([g.ids for g in group]))
                now = self.clock()
                for g in group:
                    g.ticket._resolve(dataclasses.replace(
                        res, seconds=now - g.ticket.t_submit), now)
                resolved += len(group)
            else:
                job = self._update_q.popleft()
                n_jobs += len(job.ids)
                res = self.index.delete(job.ids)
                now = self.clock()
                job.ticket._resolve(dataclasses.replace(
                    res, seconds=now - job.ticket.t_submit), now)
                resolved += 1
        self.counters["update_flushes"] += 1
        self.counters["update_jobs"] += n_jobs
        self.counters[f"update_{reason}"] += 1
        self.batch_log.append(("update", n_jobs, reason))
        self._flushes_since_tick += 1
        if (self.cfg.tick_every
                and self._flushes_since_tick >= self.cfg.tick_every):
            self._flushes_since_tick = 0
            self.tick()
        return resolved
