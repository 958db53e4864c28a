"""The port's front door and the rest of its single-device plane, held
against the JAX package on the same inputs.

* the registry: every engine with the JAX spec's capability flags,
  audit tier and kwargs (plus the port's ``device`` and draws);
* ``freshdiskann``: on integer-valued data (exact distances, so tie
  order is compared too) the graph (edges, tombstones, ids, entry), the
  search and ``exact`` ids and ``memory_bytes`` equal the JAX engine's
  after seeding, inserts with an upsert, deletes and ``flush``;
* ``spann``: search ids equal, scores within 1e-5, refusals equal;
* ``fused_tick=True`` over ``tests/test_api.py``'s churn: the state is
  field-equal to the JAX fused driver's, and its live map equals the
  port's unfused driver's;
* the sequential single-posting ops, each on a marked state built as in
  ``tests/test_background_round.py``: the state equals the JAX op's; the
  whole sequential execution equals the JAX oracle's, and its live
  multiset equals the port's batched ``background_round``;
* ``select_candidates`` / ``mark_round`` against the JAX package;
* the tracer (JSONL sink, ``enabled=False``), ``snapshot_json`` and
  ``required_series``, the ``StreamingIndex`` protocol, the controller
  shim and the numpy data streams.

The JAX side runs with ``use_pallas="off"``; the port runs on the CPU
with the JAX random draws injected (``kmeans_init``, ``pq_init``,
``pq_keys``).
"""
import functools
import json
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from conftest import make_clustered
from repro.api import engine_spec as j_engine_spec, make_index as j_make_index
from repro.core import UBISConfig as JConfig, UBISDriver as JDriver
from repro.core import balance as jbalance
from repro.data import DriftingVectorStream as JStream, TokenStream as JTokens
from repro.obs import metrics as jmetrics
from repro_torch import bridge
from repro_torch.api import (ENGINES, StreamingIndex, engine_spec,
                             list_engines, make_index)
from repro_torch.core import balance
from repro_torch.core.invariants import check_invariants
from repro_torch.core.types import UBISConfig
from repro_torch.obs import Obs, metrics
from test_api import _churn
from test_background_round import (_marked_state, live_multiset,
                                   sequential_execute)
from test_torch_core import assert_states_match, jax_np
from test_torch_pq import jax_draws

DIM = 16


def _np_state(state):
    """A port state as numpy arrays with attribute access (the JAX
    test helpers' input)."""
    return types.SimpleNamespace(**bridge.state_to_numpy(state))


def _port_state(jstate, tcfg):
    return bridge.state_from_numpy(jax_np(jstate), tcfg, "cpu")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

FLAGS = ("supports_tier", "supports_pq", "supports_shards", "updatable",
         "audit")


@pytest.mark.parametrize("engine", ["ubis", "spfresh", "spann",
                                    "freshdiskann", "ubis-sharded",
                                    "ubis-cluster"])
def test_registry_spec_matches_jax(engine):
    spec, jspec = engine_spec(engine), j_engine_spec(engine)
    assert spec.name == jspec.name
    for flag in FLAGS:
        assert getattr(spec, flag) == getattr(jspec, flag), flag
    # the JAX kwargs plus the port's device and draw knobs
    extra = {"device"} | ({"kmeans_init", "pq_init", "pq_keys"}
                          if engine != "freshdiskann" else set())
    assert spec.kwargs == jspec.kwargs | extra
    assert spec in list_engines()


def test_list_engines_and_the_unported_engines():
    """Every engine of the JAX registry is ported (``NOT_PORTED`` is
    empty, in the JAX registry's order); an unknown name raises."""
    from repro.api import ENGINES as J_ENGINES
    from repro_torch.api.registry import NOT_PORTED
    assert NOT_PORTED == ()
    assert ENGINES == ("ubis", "spfresh", "spann", "freshdiskann",
                       "ubis-sharded", "ubis-cluster") == J_ENGINES
    assert tuple(s.name for s in list_engines()) == ENGINES
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24)
    seeds = np.zeros((60, 8), np.float32)
    with pytest.raises(ValueError, match="unknown engine"):
        make_index("nope", cfg, seeds, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_every_engine_builds_on_the_cpu_and_not_without_cuda(engine):
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4,
                     l_max=24, max_ids=1 << 10)
    seeds = make_clustered(80, d=8, seed=4)
    idx = make_index(engine, cfg, seeds, device="cpu", max_nodes=256)
    assert isinstance(idx, StreamingIndex)
    assert idx.live_count() == (80 if engine_spec(engine).audit != "state"
                                else 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_index(engine, cfg, seeds, max_nodes=256)


def test_controller_shim_reexports_the_update_plane():
    from repro_torch.core import controller, update
    from repro_torch.core.driver import UBISDriver
    assert controller.UBISDriver is UBISDriver
    for name in ("batched_append", "cache_append", "cache_take",
                 "delete_round", "insert_round", "mark_status"):
        assert getattr(controller, name) is getattr(update, name)


# ---------------------------------------------------------------------------
# freshdiskann and spann against the JAX engines
# ---------------------------------------------------------------------------

GRAPH_KW = dict(max_nodes=1024, degree=8, beam=12, consolidate_every=64)


def _graph_program(idx, data):
    idx.insert(data[200:420], np.arange(200, 420))
    # upsert: live ids again, with new vectors
    idx.insert(data[420:460], np.arange(0, 40))
    idx.delete(np.arange(100, 190))           # past consolidate_every
    idx.insert(data[460:520], np.arange(460, 520))
    idx.delete(np.arange(200, 230))
    idx.flush()


def test_freshdiskann_matches_jax():
    data = np.round(make_clustered(600, d=DIM, k=8, seed=21))
    cfg = dict(dim=DIM, max_postings=128, capacity=96, max_ids=1 << 12)
    q = np.round(make_clustered(32, d=DIM, k=8, seed=22))
    jidx = j_make_index("freshdiskann", JConfig(use_pallas="off", **cfg),
                        data[:200], **GRAPH_KW)
    tidx = make_index("freshdiskann", UBISConfig(**cfg), data[:200],
                      device="cpu", **GRAPH_KW)
    for idx in (jidx, tidx):
        _graph_program(idx, data)
    js, ts = jidx.state, tidx.state
    for name in ("nbrs", "valid", "ids", "entry", "n_used"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(ts.vectors.numpy(), np.asarray(js.vectors))
    assert tidx.live_count() == jidx.live_count() == 480 - 90 - 30
    for k in (1, 10, 30):
        np.testing.assert_array_equal(tidx.search(q, k).ids,
                                      jidx.search(q, k).ids)
        te, je = tidx.exact(q, k), jidx.exact(q, k)
        np.testing.assert_array_equal(te.ids, je.ids)
        np.testing.assert_array_equal(te.scores, je.scores)
    assert tidx.memory_bytes() == jidx.memory_bytes()
    assert tidx.memory_tiers() == jidx.memory_tiers()
    assert tidx.stats["inserted"] == jidx.stats["inserted"]
    assert tidx.stats["deleted"] == jidx.stats["deleted"]


def test_freshdiskann_exact_chunks_like_one_block(monkeypatch):
    """``exact`` scans the live nodes in query chunks: the answer equals
    one block's (the reference's single broadcast)."""
    from repro_torch.core import freshdiskann
    data = np.round(make_clustered(300, d=DIM, k=8, seed=23))
    idx = make_index("freshdiskann", UBISConfig(dim=DIM), data,
                     device="cpu", max_nodes=512, degree=8, beam=12)
    q = np.round(make_clustered(40, d=DIM, k=8, seed=24))
    whole = idx.exact(q, 7)
    monkeypatch.setattr(freshdiskann, "EXACT_CHUNK_FLOATS", 3 * 300 * DIM)
    chunked = idx.exact(q, 7)
    np.testing.assert_array_equal(chunked.ids, whole.ids)
    np.testing.assert_array_equal(chunked.scores, whole.scores)


def test_spann_matches_jax():
    data = np.round(make_clustered(900, d=DIM, k=8, seed=31))
    cfg = dict(dim=DIM, max_postings=128, capacity=96, l_min=10, l_max=80,
               nprobe=16, max_ids=1 << 12)
    tcfg = UBISConfig(**cfg)
    init, _, _ = jax_draws(tcfg, 600)
    jidx = j_make_index("spann", JConfig(use_pallas="off", **cfg), data[:600],
                        round_size=128)
    tidx = make_index("spann", tcfg, data[:600], device="cpu",
                      round_size=128, kmeans_init=init)
    q = np.round(make_clustered(32, d=DIM, k=8, seed=32))
    for k in (1, 10):
        tr, jr = tidx.search(q, k), jidx.search(q, k)
        np.testing.assert_array_equal(tr.ids, jr.ids)
        np.testing.assert_allclose(tr.scores, jr.scores, rtol=1e-5, atol=1e-5)
    for idx in (jidx, tidx):
        r = idx.insert(data[600:700], np.arange(600, 700))
        assert (r.accepted, r.cached, r.rejected) == (0, 0, 100)
        r = idx.delete(np.arange(50))
        assert (r.deleted, r.blocked) == (0, 50)
    assert tidx.live_count() == jidx.live_count() == 600
    assert tidx.memory_tiers() == {"device": tidx.memory_bytes(), "host": 0}


# ---------------------------------------------------------------------------
# fused_tick over tests/test_api.py's churn
# ---------------------------------------------------------------------------

def _live_map(state):
    from contract_harness import live_map
    return live_map(_np_state(state))


def test_fused_tick_matches_jax_and_the_unfused_driver():
    data = make_clustered(2000, d=DIM, k=12, seed=11)
    cfg = dict(dim=DIM, max_postings=256, capacity=96, l_min=10, l_max=80,
               max_ids=1 << 14)
    tcfg = UBISConfig(**cfg)
    init, _, _ = jax_draws(tcfg, 400)
    kw = dict(round_size=256, bg_ops_per_round=8)
    jd = JDriver(JConfig(use_pallas="off", **cfg), data[:400],
                 fused_tick=True, **kw)
    expected = _churn(jd, data, seed=1)
    ports = {}
    for fused in (True, False):
        td = make_index("ubis", tcfg, data[:400], device="cpu",
                        kmeans_init=init, fused_tick=fused, **kw)
        assert _churn(td, data, seed=1) == expected
        check_invariants(td.state, tcfg)
        assert (td.posting_lengths() <= tcfg.l_max).all()
        ports[fused] = td
    td = ports[True]
    assert td.fused_tick and td.stats["bg_ops"] > 0
    assert_states_match(bridge.state_to_numpy(td.state), jax_np(jd.state))
    for key in ("bg_ops", "bg_split", "bg_merge", "bg_compact", "drained"):
        assert td.stats[key] == jd.stats[key], key
    marks = td.obs.events("bg_mark")
    assert marks and all(e["reason"] == "fused-device-round" for e in marks)
    live = _live_map(td.state)
    assert set(live) == expected
    assert live == _live_map(ports[False].state)


def test_fused_tick_is_ignored_in_spfresh_mode():
    tcfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4,
                      l_max=24, max_ids=1 << 10, mode="spfresh")
    seeds = make_clustered(80, d=8, seed=4)
    assert not make_index("spfresh", tcfg, seeds, device="cpu",
                          fused_tick=True).fused_tick


# ---------------------------------------------------------------------------
# the sequential single-posting ops on a marked state
# ---------------------------------------------------------------------------

SEQ_CFG = dict(dim=8, max_postings=128, capacity=64, l_min=6, l_max=48,
               cache_capacity=512, max_ids=1 << 13)
PQ_KW = dict(use_pq=True, pq_m=4, pq_ksub=32)
SEQ_MODES = {"ubis": dict(mode="ubis"), "spfresh": dict(mode="spfresh"),
             "ubis-pq": dict(mode="ubis", **PQ_KW)}


@functools.lru_cache(maxsize=None)
def marked_state(mode, seed=0):
    """A JAX state marked as tests/test_background_round.py marks it,
    and its jobs (cached: JAX states are immutable)."""
    kw = SEQ_MODES[mode]
    jcfg = JConfig(use_pallas="off", **SEQ_CFG, **kw)
    tcfg = UBISConfig(**SEQ_CFG, **kw)
    state, jobs = _marked_state(jcfg, seed)
    return jcfg, tcfg, state, tuple(jobs)


@functools.lru_cache(maxsize=None)
def executed_state(mode):
    """The marked state after the JAX sequential execution: split
    children of many lengths, so a short posting has merge partners."""
    jcfg, tcfg, state, jobs = marked_state(mode)
    return sequential_execute(state, jcfg, list(jobs))


def _job(mode, kind):
    """(JAX state, pid): the first marked job of ``kind``; for a merge,
    the shortest NORMAL posting of the executed state."""
    _, _, state, jobs = marked_state(mode)
    if kind != "merge":
        return state, [p for k, p in jobs if k == kind][0]
    from repro.core import version_manager as jvm
    state = executed_state(mode)
    normal = (np.asarray(state.allocated)
              & (np.asarray(jvm.unpack_status(state.rec_meta)) == 0))
    lengths = np.where(normal, np.asarray(state.lengths), 1 << 30)
    return state, int(np.argmin(lengths))


OPS = {
    "balance_split": ("split", lambda b, s, c, p: b.balance_split(s, c, p)),
    "compact_posting": ("split",
                        lambda b, s, c, p: (b.compact_posting(s, c, p),)),
    "merge_postings": ("merge", lambda b, s, c, p: b.merge_postings(s, c, p)),
    "reassign_check": ("split", lambda b, s, c, p: b.reassign_check(s, c, p)),
}


@pytest.mark.parametrize("mode", list(SEQ_MODES))
@pytest.mark.parametrize("op", list(OPS))
def test_sequential_op_matches_jax(op, mode):
    jcfg, tcfg, _, _ = marked_state(mode)
    kind, fn = OPS[op]
    js, pid = _job(mode, kind)
    jout = fn(jbalance, js, jcfg, jnp.asarray(pid, jnp.int32))
    tout = fn(balance, _port_state(js, tcfg), tcfg, pid)
    for j, t in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert_states_match(bridge.state_to_numpy(tout[0]), jax_np(jout[0]))
    check_invariants(tout[0], tcfg)
    if op == "merge_postings":
        assert bool(tout[2])            # a partner was found


@pytest.mark.parametrize("mode,seed", [("ubis", 0), ("ubis", 1),
                                       ("spfresh", 0), ("ubis-pq", 0)])
def test_sequential_execution_matches_jax_and_the_batched_round(mode, seed):
    jcfg, tcfg, js, jobs = marked_state(mode, seed)
    before = live_multiset(js, jcfg)
    jseq = sequential_execute(js, jcfg, list(jobs))
    tseq = balance.execute_sequential(_port_state(js, tcfg), tcfg, jobs)
    assert_states_match(bridge.state_to_numpy(tseq), jax_np(jseq))
    B = 8
    kinds = np.zeros(B, np.int32)
    pids = np.full(B, -1, np.int32)
    codes = {"split": 1, "merge": 2, "compact": 3}
    for i, (k, p) in enumerate(jobs):
        kinds[i], pids[i] = codes[k], p
    tbat, rr = balance.background_round(_port_state(js, tcfg), tcfg,
                                        torch.from_numpy(kinds),
                                        torch.from_numpy(pids))
    assert int(rr.executed) > 0
    for st in (tseq, tbat):
        check_invariants(st, tcfg)
        assert live_multiset(_np_state(st), tcfg) == before


# ---------------------------------------------------------------------------
# device-side selection + mark
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [5, 6])
def test_select_candidates_and_mark_round_match_jax(seed):
    jcfg, tcfg, js, _ = marked_state("ubis", seed)
    # unmark so selection sees NORMAL postings again (as
    # tests/test_background_round.py:374 does)
    from repro.core import update as jupdate, version_manager as jvm
    status = np.asarray(jvm.unpack_status(js.rec_meta))
    marked = np.flatnonzero((status == 1) | (status == 2))
    js = jupdate.mark_status(js, jnp.asarray(marked, jnp.int32), 0)
    for k in (3, 8, 200):
        jk, jp = jbalance.select_candidates(js, jcfg, k)
        tk, tp = balance.select_candidates(_port_state(js, tcfg), tcfg, k)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert tk.dtype == tp.dtype == torch.int32
    # detect's priority order: splits by length desc, compacts, merges
    # by length asc
    sd, md, cd = (np.asarray(x) for x in jbalance.detect(js, jcfg))
    lengths = np.asarray(js.lengths)
    want = ([p for p in sorted(np.flatnonzero(sd), key=lambda p: -lengths[p])]
            + list(np.flatnonzero(cd & ~sd))
            + sorted(np.flatnonzero(md & ~sd & ~cd), key=lambda p: lengths[p]))
    tk, tp = balance.select_candidates(_port_state(js, tcfg), tcfg, 8)
    assert tp.numpy()[tk.numpy() != 0].tolist() == want[:8]
    js2, jk, jp, jn = jbalance.mark_round(js, jcfg, 8)
    ts2, tk, tp, tn = balance.mark_round(_port_state(js, tcfg), tcfg, 8)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))


# ---------------------------------------------------------------------------
# the observability plane
# ---------------------------------------------------------------------------

def test_tracer_jsonl_sink_ring_and_switch(tmp_path):
    path = tmp_path / "trace.jsonl"
    obs = Obs(trace_capacity=4, trace_path=str(path),
              clock=iter(range(100)).__next__)
    assert obs.enabled and obs.tracer.capacity == 4
    for i in range(6):
        obs.emit("tick", executed=np.int64(i), ids=torch.arange(2),
                 n=torch.tensor(i))
    obs.tracer.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 6 and len(obs.tracer) == 4
    assert [e["seq"] for e in lines] == list(range(6))
    assert lines[5] == {"seq": 5, "t": 5.0, "kind": "tick", "executed": 5,
                        "ids": [0, 1], "n": 5}
    assert obs.events() == lines[2:]
    off = Obs(enabled=False)
    off.emit("tick", executed=1)
    assert not off.enabled and len(off.tracer) == 0 and off.events() == []
    # the stats map stays on: the drivers need it
    off.driver_stats()["inserted"] += 3
    assert off.snapshot()["index_inserted"] == 3.0


def test_disabled_obs_drives_an_index_without_events():
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4,
                     l_max=24, max_ids=1 << 10)
    data = make_clustered(200, d=8, seed=4)
    idx = make_index("ubis", cfg, data[:80], device="cpu",
                     obs=Obs(enabled=False))
    idx.insert(data, np.arange(200))
    idx.flush()
    assert idx.obs.events() == [] and idx.stats["inserted"] == 200


def test_snapshot_json_and_required_series_match_jax():
    regs = (metrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("serve_requests").inc(3)
        reg.histogram("serve_latency_seconds").record(0.004)
        reg.stats_map("index", metrics.DRIVER_STAT_SCHEMA)["inserted"] += 7
    assert regs[0].snapshot_json(sort_keys=True) == \
        regs[1].snapshot_json(sort_keys=True)
    keys = list(regs[0].snapshot())
    want = ["serve_requests", "serve_latency_seconds", "index_inserted",
            "missing_series", "serve"]
    assert metrics.required_series(keys, want) == \
        jmetrics.required_series(keys, want) == ["missing_series"]


# ---------------------------------------------------------------------------
# the numpy data streams
# ---------------------------------------------------------------------------

def test_data_streams_equal_the_jax_package():
    from repro_torch.data import DriftingVectorStream, TokenStream
    a, b = DriftingVectorStream(dim=8, seed=3), JStream(dim=8, seed=3)
    for n in (5, 17):
        np.testing.assert_array_equal(a.next_batch(n), b.next_batch(n))
    np.testing.assert_array_equal(a.queries(4), b.queries(4))
    ta, tb = (cls(vocab=50, seq_len=8, batch_per_host=2, seed=1)
              for cls in (TokenStream, JTokens))
    for _ in range(2):
        xa, xb = ta.next_batch(), tb.next_batch()
        for key in xb:
            np.testing.assert_array_equal(xa[key], xb[key])
    assert ta.state_dict() == tb.state_dict()

