"""The port's serving layer against the JAX package's.

* ``ServingEngine`` scheduling: the same seeded arrival trace on a fake
  clock gives the identical batch log (sizes and fire reasons) in both
  packages, over a stub index and over the two packages' ``ubis``
  drivers; over the drivers, on integer data, the tickets also carry
  identical ids and scores, and the drivers end with identical stats.
* ``RetrievalServer`` end to end at reduced width: the same embeddings
  ingested into both servers give the same live ids and search ids; the
  port's own server (its backbone embedding the tokens) reaches
  recall@10 > 0.9 against its exact oracle; ``metrics_text()`` parses.
* The observability plane the serving path reads: histogram quantiles
  and the exposition as in the JAX package, the recall probe, the
  profiler hook.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro.core import UBISConfig as JConfig, UBISDriver as JDriver
from repro.launch.serve import RetrievalServer as JRetrievalServer
from repro.launch.serve import ServeConfig as JServeConfig
from repro.obs import metrics as jmetrics
from repro.serving import ServingConfig as JServingConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.api import SearchResult, TickReport, UpdateResult, make_index
from repro_torch.api.types import Ticket
from repro_torch.core.build import initial_posting_count
from repro_torch.core.types import UBISConfig
from repro_torch.launch.serve import RetrievalServer, ServeConfig
from repro_torch.obs import Obs, parse_exposition
from repro_torch.obs.metrics import Histogram
from repro_torch.obs import probe as probe_mod
from repro_torch.serving import QueuedIndex, ServingConfig, ServingEngine

DIM = 16
STAT_KEYS = ("inserted", "deleted", "rejected", "blocked", "queries",
             "bg_ops", "bg_split", "bg_merge", "bg_compact", "bg_deferred",
             "bg_reassigned", "bg_gc", "drained", "search_probed",
             "search_results", "search_exact_batches")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class StubIndex:
    """The smallest index surface, for pure-scheduling tests."""

    def __init__(self):
        self.calls = []

    def search(self, queries, k):
        self.calls.append(("search", len(queries), k))
        return SearchResult(ids=np.zeros((len(queries), k), np.int32),
                            scores=np.zeros((len(queries), k), np.float32))

    def insert(self, vecs, ids):
        self.calls.append(("insert", len(ids)))
        return UpdateResult(accepted=len(ids))

    def delete(self, ids):
        self.calls.append(("delete", len(ids)))
        return UpdateResult(deleted=len(ids))

    def tick(self):
        self.calls.append(("tick",))
        return TickReport()


def _trace(seed, n=200, p_search=0.9):
    """(time, kind) arrivals: bursts (sub-deadline gaps, so lanes fill)
    and lulls (so deadlines fire)."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.choice([1e-5, 5e-3], p=[0.85, 0.15]))
        out.append((t, "search" if rng.random() < p_search else "insert"))
    return out


def _replay(engine_cls, scfg, index, trace, payload):
    """Feed ``trace`` through an engine on a fake clock, pumping whenever
    a deadline falls due.  ``payload(kind, i)`` gives each submission's
    arguments.  Returns (engine, [(kind, ticket)])."""
    clock = FakeClock()
    eng = engine_cls(index, scfg, clock=clock)
    tickets = []
    for i, (t, kind) in enumerate(trace):
        while True:
            nd = eng.next_deadline()
            if nd is None or nd > t:
                break
            clock.t = max(clock.t, nd)
            eng.pump()
        clock.t = t
        submit = {"search": eng.submit_search, "insert": eng.submit_insert,
                  "delete": eng.submit_delete}[kind]
        tickets.append((kind, submit(*payload(kind, i))))
        eng.pump()
    eng.drain()
    return eng, tickets


def _stub_payload(kind, i):
    rng = np.random.default_rng(i)
    if kind == "search":
        return (rng.normal(size=DIM),)
    return rng.normal(size=(4, DIM)), np.arange(4)


@pytest.mark.parametrize("scfg", [
    dict(search_batch=8, insert_batch=64, search_deadline_s=2e-3,
         insert_deadline_s=4e-3, tick_every=0),
    dict(search_batch=4, insert_batch=8, search_deadline_s=1e-3,
         insert_deadline_s=2e-3, tick_every=2)], ids=["fill8", "fill4-tick2"])
def test_batch_log_matches_jax_on_a_stub(scfg):
    trace = _trace(3)
    jeng, _ = _replay(JServingEngine, JServingConfig(**scfg), StubIndex(),
                      trace, _stub_payload)
    idx = StubIndex()
    teng, _ = _replay(ServingEngine, ServingConfig(**scfg), idx, trace,
                      _stub_payload)
    assert teng.batch_log == jeng.batch_log
    assert {r for _, _, r in teng.batch_log} >= {"fill", "deadline"}
    assert dict(teng.counters) == dict(jeng.counters)
    assert all(n <= scfg["search_batch"] for lane, n, _ in teng.batch_log
               if lane == "search")
    assert idx.calls.count(("tick",)) == teng.counters["ticks"]


def test_fill_fires_before_deadline():
    clock = FakeClock()
    eng = ServingEngine(StubIndex(), ServingConfig(
        search_batch=4, tick_every=0, search_deadline_s=1.0), clock=clock)
    for i in range(4):
        clock.t = i * 1e-6
        eng.submit_search(np.zeros(DIM))
    assert eng.next_deadline() == clock.t
    assert eng.pump() == 4
    assert eng.batch_log == [("search", 4, "fill")]
    eng.submit_search(np.zeros(DIM))
    assert eng.pump() == 0
    clock.t += 1.0
    assert eng.pump() == 1
    assert eng.batch_log[-1] == ("search", 1, "deadline")


def test_ticket_pumps_its_engine_until_resolved():
    eng = ServingEngine(StubIndex(), ServingConfig(search_batch=64,
                                                   tick_every=0))
    t = eng.submit_search(np.ones(DIM), k=3)
    assert not t.done()
    with pytest.raises(RuntimeError, match="unresolved"):
        t.latency_s
    assert t.result().ids.shape == (1, 3)
    assert t.done() and t.latency_s >= 0
    with pytest.raises(RuntimeError, match="detached"):
        Ticket(kind="search", seq=1, t_submit=0.0).result()


# ---------------------------------------------------------------------------
# over the two packages' drivers
# ---------------------------------------------------------------------------

def _int_clusters(n, k=8, seed=1):
    """Integer-valued clustered vectors: every score is an exact sum."""
    r = np.random.default_rng(seed)
    cents = r.integers(-6, 7, (k, DIM)) * 4
    return (cents[r.integers(0, k, n)]
            + r.integers(-3, 4, (n, DIM))).astype(np.float32)


def _index_cfg(**kw):
    return dict(dim=DIM, max_postings=128, capacity=96, l_min=10, l_max=80,
                nprobe=128, cache_capacity=512, max_ids=1 << 13, **kw)


def _jax_kmeans_init(tcfg, seeds, seed=0):
    k0 = initial_posting_count(tcfg, len(seeds))
    return np.asarray(jax.random.choice(jax.random.key(seed), len(seeds),
                                        (k0,), replace=False))


def _driver_pair(seeds, **kw):
    tcfg = UBISConfig(**_index_cfg())
    jd = JDriver(JConfig(use_pallas="off", **_index_cfg()), seeds, **kw)
    td = make_index("ubis", tcfg, seeds, device="cpu",
                    kmeans_init=_jax_kmeans_init(tcfg, seeds), **kw)
    return jd, td


def test_engine_over_drivers_matches_jax():
    """One seeded trace of searches, inserts and deletes through both
    packages' engines over their ``ubis`` drivers, on integer data:
    identical batch logs, ticket ids, search ids and scores, and driver
    stats."""
    data = _int_clusters(1400, seed=2)
    seeds = data[:300]
    trace = _trace(5, n=240, p_search=0.6)
    next_id = [0]

    def payload(kind, i):
        if kind == "search":
            return (data[1000 + i % 400],)
        if kind == "delete":                 # ids inserted or not (blocked)
            return (np.arange(i % 40, i % 40 + 6),)
        off = next_id[0]
        next_id[0] += 12
        return data[off % 1000:off % 1000 + 12], np.arange(off, off + 12)

    kinds = [(t, "delete" if k == "insert" and i % 5 == 4 and i > 20 else k)
             for i, (t, k) in enumerate(trace)]
    scfg = dict(search_batch=8, insert_batch=48, search_deadline_s=2e-3,
                insert_deadline_s=4e-3, tick_every=2)
    jd, td = _driver_pair(seeds, round_size=64, bg_ops_per_round=4)
    next_id[0] = 0
    jeng, jt = _replay(JServingEngine, JServingConfig(**scfg), jd, kinds,
                       payload)
    next_id[0] = 0
    teng, tt = _replay(ServingEngine, ServingConfig(**scfg), td, kinds,
                       payload)
    assert teng.batch_log == jeng.batch_log
    assert dict(teng.counters) == dict(jeng.counters)
    assert teng.counters["ticks"] > 0 and teng.counters["search_batches"] > 0
    assert [(k, t.seq) for k, t in tt] == [(k, t.seq) for k, t in jt]
    for (kind, a), (_, b) in zip(tt, jt):
        ra, rb = a.result(), b.result()
        if kind == "search":
            np.testing.assert_array_equal(ra.ids, np.asarray(rb.ids))
            np.testing.assert_array_equal(ra.scores, np.asarray(rb.scores))
        else:
            assert (ra.accepted, ra.cached, ra.rejected, ra.deleted,
                    ra.blocked) == (rb.accepted, rb.cached, rb.rejected,
                                    rb.deleted, rb.blocked)
    for key in STAT_KEYS:
        assert td.stats[key] == jd.stats[key], key
    assert td.live_count() == jd.live_count()


def test_overlap_answers_for_dispatch_time_state():
    """A search batch and an insert flush in one pump: the search answers
    for the index as of dispatch, the next one sees the insert."""
    data = make_clustered(600, d=DIM, k=6, seed=19)
    drv = make_index("ubis", UBISConfig(**_index_cfg()), data[:200],
                     device="cpu", round_size=256, bg_ops_per_round=4)
    drv.insert(data[:400], np.arange(400))
    drv.flush(max_ticks=30)
    eng = ServingEngine(drv, ServingConfig(search_batch=4, tick_every=1))
    probe = data[500]
    t1 = eng.submit_search(probe, k=3)
    eng.submit_insert(probe[None], np.array([8000]))
    eng.drain()                      # one pump: dispatch, insert, collect
    assert eng.counters["search_batches"] == 1
    assert eng.counters["ticks"] == 1
    assert 8000 not in set(t1.result().ids.ravel().tolist())
    t2 = eng.submit_search(probe, k=3)
    eng.drain()
    assert int(t2.result().ids[0, 0]) == 8000


def test_queued_index_matches_direct_driver():
    data = make_clustered(1200, d=DIM, k=8, seed=23)
    live, res = {}, {}
    for queued in (False, True):
        drv = make_index("ubis", UBISConfig(**_index_cfg()), data[:300],
                         device="cpu", round_size=256, bg_ops_per_round=8)
        idx = QueuedIndex(drv) if queued else drv
        idx.insert(data[:800], np.arange(800))
        idx.delete(np.arange(100, 200))
        idx.tick()
        idx.insert(data[800:], np.arange(800, 1200))
        idx.flush(max_ticks=40)
        live[queued] = idx.live_count()
        res[queued] = idx.search(data[:16], 5)
    assert live[False] == live[True] == 1100
    np.testing.assert_array_equal(res[False].ids, res[True].ids)
    np.testing.assert_array_equal(res[False].scores, res[True].scores)


# ---------------------------------------------------------------------------
# RetrievalServer end to end, reduced width
# ---------------------------------------------------------------------------

def test_retrieval_server_matches_jax():
    """The same embeddings (the JAX server's) into both servers: the
    same live ids and search ids."""
    rng = np.random.default_rng(11)
    seeds = make_clustered(400, d=DIM, k=8, seed=31)
    jcfg = JServeConfig(reduced=True, embed_dim=DIM)
    js = JRetrievalServer(jcfg, index_cfg=JConfig(use_pallas="off",
                                                  **_index_cfg()),
                          seed_vectors=seeds, round_size=128)
    tcfg = UBISConfig(**_index_cfg())
    ts = RetrievalServer(ServeConfig(reduced=True, embed_dim=DIM,
                                     device="cpu"), index_cfg=tcfg,
                         seed_vectors=seeds, round_size=128,
                         kmeans_init=_jax_kmeans_init(tcfg, seeds))
    for _ in range(4):
        vecs = js.embedder.embed(rng.integers(0, 512, (48, 24)).astype(
            np.int32))
        np.testing.assert_array_equal(js.ingest_vectors(vecs),
                                      ts.ingest_vectors(vecs))
    js.index.flush()
    ts.index.flush()
    np.testing.assert_array_equal(
        np.flatnonzero(ts.index.state.id_loc.numpy() != -1),
        np.flatnonzero(np.asarray(js.index.state.id_loc) != -1))
    q = js.embedder.embed(rng.integers(0, 512, (20, 12)).astype(np.int32))
    np.testing.assert_array_equal(ts.query_vectors(q, k=5).ids,
                                  np.asarray(js.query_vectors(q, k=5).ids))
    assert ts.stats == js.stats


def test_retrieval_server_end_to_end():
    """The port's server on its own: its backbone embeds the documents,
    queries ride the queue, recall@10 > 0.9 against the exact oracle, the
    freshest batch finds itself, and the exposition parses."""
    rng = np.random.default_rng(12)
    server = RetrievalServer(ServeConfig(reduced=True, embed_dim=DIM,
                                         device="cpu", recall_probe=1.0),
                             index_cfg=UBISConfig(**_index_cfg()))
    for _ in range(5):
        docs = rng.integers(0, 512, (48, 32)).astype(np.int32)
        ids = server.ingest_tokens(docs)
    server.index.flush()
    assert server.index.live_count() == 240
    qt = rng.integers(0, 512, (40, 16)).astype(np.int32)
    res = server.query_tokens(qt)
    assert res.ids.shape == (40, 10)
    assert server.recall_check(server.embedder.embed(qt)) > 0.9
    found = server.query_vectors(server.embedder.embed(docs[:8]), k=3).ids
    assert all(int(ids[i]) in set(f.tolist()) for i, f in enumerate(found))
    text = server.metrics_text()
    series = parse_exposition(text)
    assert series["serve_latency_seconds_count"] == 48
    assert series["index_inserted"] == 240
    assert series["live_recall_probes"] > 0
    assert jmetrics.parse_exposition(text) == series
    snap = server.metrics_snapshot()
    assert snap["serve_latency_seconds"]["count"] == 48
    assert server.trace_events("tick")


# ---------------------------------------------------------------------------
# the observability plane
# ---------------------------------------------------------------------------

def test_histogram_quantiles_match_jax():
    samples = np.random.default_rng(13).lognormal(-6, 1.5, 500)
    a, b = Histogram("x"), jmetrics.Histogram("x")
    for s in samples:
        a.record(s)
        b.record(s)
    assert a.summary() == b.summary()
    assert list(a.buckets()) == list(b.buckets())


def test_exposition_matches_jax_registry():
    """The same metrics through both registries give the same text."""
    obs, jreg = Obs(), jmetrics.MetricsRegistry()
    for reg in (obs.registry, jreg):
        st = reg.stats_map("index")
        st["inserted"] += 7
        reg.counter("kernel_fallback")
        reg.counter("kernel_fallback_traces")
        reg.gauge("serve_batch_fill").set(0.25)
        h = reg.histogram("serve_latency_seconds")
        for s in (1e-3, 2e-3, 5e-2):
            h.record(s)
    assert obs.to_prometheus() == jreg.to_prometheus()
    assert parse_exposition(obs.to_prometheus())["index_inserted"] == 7
    with pytest.raises(ValueError):
        parse_exposition("a b c\n# junk\n")


def test_profile_writes_a_trace(tmp_path):
    """``Obs.profile`` directly, and through the serving engine's
    ``obs_profile_dir``: the first pump that fires work is captured,
    once."""
    obs = Obs()
    with obs.profile(str(tmp_path / "direct")):
        torch.ones(8) @ torch.ones(8)
    with obs.profile(None):          # no directory: runs untraced
        pass
    assert [f.endswith(".json") for f in os.listdir(tmp_path / "direct")] \
        == [True]
    eng = ServingEngine(StubIndex(), ServingConfig(
        tick_every=1, obs_profile_dir=str(tmp_path / "engine")))
    for _ in range(2):
        eng.submit_insert(np.zeros((2, DIM), np.float32), np.arange(2))
        eng.drain()
    assert len(os.listdir(tmp_path / "engine")) == 1


def test_make_index_shares_the_obs_plane():
    obs = Obs()
    drv = make_index("ubis", UBISConfig(**_index_cfg()),
                     make_clustered(300, d=DIM, seed=3), device="cpu",
                     obs=obs)
    assert drv.obs is obs
    drv.insert(make_clustered(50, d=DIM, seed=4), np.arange(50))
    assert parse_exposition(obs.to_prometheus())["index_inserted"] == 50
    eng = ServingEngine(drv, ServingConfig(tick_every=0))
    assert eng.obs is obs
    # the port keeps as constants the JAX package's overlap switch and
    # probe window and rows, at the JAX package's defaults
    jdef = dataclasses.asdict(JServingConfig())
    assert (jdef.pop("overlap"), jdef.pop("recall_probe_window"),
            jdef.pop("recall_probe_rows")) == (True, probe_mod.WINDOW,
                                               probe_mod.MAX_ROWS)
    assert dataclasses.asdict(ServingConfig()) == jdef
