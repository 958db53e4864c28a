"""The port's cold tier (``use_tier=True``) against the JAX package.

* The ten residency tests of tests/test_tier.py, on the port's driver
  (``device="cpu"``): spill/promote round trips bit-identically, the
  residency invariant under churn (``core/invariants.check_residency``,
  the port's ``_audit_residency``), the detector never marks a spilled
  posting, a structurally-due spilled posting is promoted before its
  merge, a forced promotion survives its tick's spill plan, the memory
  split, inserts route around spilled postings, the exact oracle under
  spill, the re-train promotes pinned spilled postings, and the
  watermark evicts cold postings, not hot ones.
* Both drivers over one tiered stream with the JAX draws injected
  (``kmeans_init``, ``pq_init``, ``pq_keys``), for ``tier_async`` False
  and True, on integer-valued data (every sum exact): identical
  ``tier_spilled``, ``heat`` (as uint32) and the rest of the state, the
  same pool pids with the same tile bytes, the same tier stats, search
  and ``exact`` ids and scores, and the same host bytes of
  ``memory_tiers()`` (the device bytes differ by the five uint32 fields
  the port keeps as int64).  A tiered ``snapshot()`` crosses the npz
  bridge into the other package's ``load_snapshot`` and back.
* tests/test_serving.py::test_tier_async_matches_sync_liveness[ubis],
  over the port's serving engine.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro.core import UBISConfig as JConfig, UBISDriver as JDriver
from repro.core.types import IndexState as JState
from repro_torch import bridge
from repro_torch.api import make_index
from repro_torch.core import balance, metrics
from repro_torch.core import version_manager as vm
from repro_torch.core.invariants import check_invariants, check_residency
from repro_torch.core.search import search
from repro_torch.core.tier import (HostTierPool, decay_round, touch_round,
                                   UINT32_MASK)
from repro_torch.core.types import UBISConfig, state_memory_bytes
from repro_torch.serving import QueuedIndex, ServingConfig
from test_torch_pq import jax_draws, jax_np

DIM = 16


def _cfg(**kw):
    base = dict(dim=DIM, max_postings=128, capacity=96, l_min=10,
                l_max=80, nprobe=128, max_ids=1 << 13,
                cache_capacity=2048, use_pq=True, pq_m=4, pq_ksub=16,
                rerank_k=256, use_tier=True, tier_hot_max=0)
    base.update(kw)
    return UBISConfig(**base)


def _make(cfg, seeds, **kw):
    return make_index("ubis", cfg, seeds, device="cpu", round_size=256,
                      bg_ops_per_round=8, **kw)


def _driver(data, n_seed=300, **cfg_kw):
    drv = _make(_cfg(**cfg_kw), data[:n_seed])
    drv.insert(data, np.arange(len(data)))
    drv.flush(max_ticks=60)
    return drv


def _audit_residency(drv):
    """check_invariants + check_residency; returns the spilled count."""
    check_invariants(drv.state, drv.cfg)
    check_residency(drv.state, drv.cfg, drv.tier.pool)
    return len(drv.tier.pool)


def _status(state):
    return vm.unpack_status(state.rec_meta).numpy()


# ---------------------------------------------------------------------------
# tests/test_tier.py on the port's driver
# ---------------------------------------------------------------------------

def test_spill_promote_roundtrip_is_bit_identical():
    data = make_clustered(1500, d=DIM, k=8, seed=1)
    drv = _driver(data)
    state = drv.state
    live = np.flatnonzero(state.allocated.numpy() & (_status(state) == 0)
                          & (state.lengths.numpy() > 0))
    assert len(live) >= 4
    before = {int(p): state.vectors[p].numpy().tobytes() for p in live[:4]}

    moved = drv.force_spill(len(live))          # spill everything hot
    assert moved == len(live)
    assert drv.state.tier_spilled.numpy()[live].all()
    _audit_residency(drv)

    promoted = drv.force_promote()
    assert promoted == moved
    assert not drv.state.tier_spilled.any()
    after = {p: drv.state.vectors[p].numpy().tobytes() for p in before}
    assert after == before, "promote did not restore bit-identical tiles"
    assert len(drv.tier.pool) == 0


def test_residency_invariant_under_churn():
    """Mixed insert/delete/tick churn with forced spills interleaved: the
    code/float invariant holds for hot and spilled postings, and the live
    multiset never drifts."""
    rng = np.random.default_rng(3)
    data = make_clustered(2400, d=DIM, k=10, seed=3)
    drv = _driver(data[:1200], tier_hot_max=12)
    live = set(range(1200))
    nxt = 1200
    for step in range(6):
        n = int(rng.integers(60, 180))
        drv.insert(data[nxt:nxt + n], np.arange(nxt, nxt + n))
        live |= set(range(nxt, min(nxt + n, len(data))))
        nxt = min(nxt + n, len(data))
        dels = rng.choice(sorted(live), size=min(50, len(live) // 4),
                          replace=False)
        drv.delete(dels)
        live -= set(int(x) for x in dels)
        if step % 2 == 0:
            drv.force_spill(int(rng.integers(2, 10)))
        drv.tick()
    drv.flush(max_ticks=60)
    assert drv.live_count() == len(live)
    n_sp = _audit_residency(drv)
    assert n_sp > 0, "watermark never spilled anything"
    q = data[:24]
    rec = metrics.recall_at_k(drv.search(q, 8).ids, drv.exact(q, 8).ids)
    assert rec >= 0.9, rec


def test_detector_never_marks_spilled_postings():
    data = make_clustered(1500, d=DIM, k=8, seed=5)
    drv = _driver(data)
    drv.force_spill(10 ** 6)                      # spill everything
    sp = drv.state.tier_spilled.numpy()
    assert sp.any()
    for mask in balance.detect(drv.state, drv.cfg):
        assert not (mask.numpy() & sp).any(), \
            "detector marked a spilled posting"


def _hollow_one(drv):
    """Delete enough of a spilled NORMAL posting to put it under l_min;
    returns its pid."""
    state = drv.state
    lengths = state.lengths.numpy()
    cand = np.flatnonzero(state.allocated.numpy() & (_status(state) == 0)
                          & state.tier_spilled.numpy()
                          & (lengths >= drv.cfg.l_min))
    assert cand.size, "no spilled posting to hollow out"
    p = int(cand[0])
    ids = state.ids[p].numpy()
    sv = state.slot_valid[p].numpy()
    drv.delete(ids[sv][: int(lengths[p]) - drv.cfg.l_min + 1])
    assert int(drv.state.lengths[p]) < drv.cfg.l_min
    return p


def test_structural_op_on_spilled_posting_promotes_first():
    """A spilled posting hollowed below l_min is promoted (forced,
    structural-due) and only then merged away."""
    data = make_clustered(1500, d=DIM, k=8, seed=7)
    drv = _driver(data)
    drv.force_spill(10 ** 6)
    p = _hollow_one(drv)
    assert bool(drv.state.tier_spilled[p])
    promoted_before_merge = False
    for _ in range(40):
        drv.tick()
        st = int(vm.unpack_status(drv.state.rec_meta[p]))
        sp_now = bool(drv.state.tier_spilled[p])
        if st in (1, 2):                          # marked for a structural op
            assert not sp_now, "posting marked while still spilled"
            promoted_before_merge = True
        if st == 3:                               # merged away (DELETED)
            assert promoted_before_merge or not sp_now
            break
    else:
        pytest.fail("hollowed spilled posting was never merged")
    _audit_residency(drv)


def test_forced_promotion_survives_the_same_ticks_spill_plan():
    """With promote_heat <= cold_heat a structurally-due posting promoted
    in a tick must not be re-spilled by that tick's spill plan (the
    promote/spill livelock), and its merge must land."""
    data = make_clustered(1500, d=DIM, k=8, seed=19)
    drv = _make(_cfg(tier_hot_max=8, tier_promote_heat=2, tier_cold_heat=2),
                data[:300])
    drv.insert(data, np.arange(1500))
    drv.flush(max_ticks=60)
    p = _hollow_one(drv)
    r = drv.tick()                                # forced promotion tick
    assert r.promoted >= 1, r
    assert not bool(drv.state.tier_spilled[p]), \
        "promoted posting was re-spilled in the same tick"
    n = drv.flush(max_ticks=40)
    assert n < 40, "tier moves never quiesced (promote/spill livelock)"
    assert int(vm.unpack_status(drv.state.rec_meta[p])) == 3, \
        "the due merge never landed"
    _audit_residency(drv)


def test_memory_tiers_split_sums_to_untiered_total():
    data = make_clustered(1500, d=DIM, k=8, seed=9)
    drv = _driver(data)
    total = state_memory_bytes(drv.state)
    t0 = drv.memory_tiers()
    assert t0["device"] + t0["host"] == total == drv.memory_bytes()
    assert t0["host"] == 0

    n = drv.force_spill(7)
    tb = drv.cfg.capacity * DIM * 4               # f32 tile bytes
    t1 = drv.memory_tiers()
    assert t1["host"] == n * tb == drv.tier.pool.nbytes()
    assert t1["device"] == total - n * tb
    assert t1["device"] + t1["host"] == drv.memory_bytes()

    drv.force_promote()
    assert drv.memory_tiers() == {"device": total, "host": 0}


def test_inserts_route_around_spilled_postings():
    data = make_clustered(1500, d=DIM, k=8, seed=11)
    drv = _driver(data)
    drv.force_spill(10 ** 6)
    sp = np.flatnonzero(drv.state.tier_spilled.numpy())
    used_before = drv.state.used.numpy()[sp]
    fresh = make_clustered(200, d=DIM, k=8, seed=11)   # same clusters
    r = drv.insert(fresh, np.arange(4000, 4200))
    assert r.accepted + r.cached == 200
    still = drv.state.tier_spilled.numpy()[sp]         # none promoted yet
    assert (drv.state.used.numpy()[sp][still] == used_before[still]).all(), \
        "an append landed in a spilled posting's tile"
    drv.flush(max_ticks=60)
    assert drv.live_count() == 1500 + 200
    _audit_residency(drv)


def test_exact_oracle_matches_numpy_under_spill():
    data = make_clustered(1200, d=DIM, k=6, seed=13)
    drv = _driver(data)
    drv.force_spill(10 ** 6)
    q = make_clustered(16, d=DIM, k=6, seed=14)
    d2 = ((q[:, None, :] - data[None]) ** 2).sum(-1)
    true = np.argsort(d2, axis=1)[:, :10]
    got = drv.exact(q, 10)
    assert metrics.recall_at_k(got.ids, true) == 1.0
    rec = metrics.recall_at_k(drv.search(q, 10).ids, got.ids)
    assert rec >= 0.9, rec
    assert drv.stats["search_spilled_hits"] > 0


def test_retrain_promotes_pinned_spilled_postings():
    """The re-train overwrites the evicted codebook slot: spilled postings
    pinned to it are promoted first, and the residency invariant holds."""
    data = make_clustered(1500, d=DIM, k=8, seed=15)
    drv = _make(_cfg(), data[:300], pq_retrain_every=1)
    drv.insert(data, np.arange(len(data)))
    drv.force_spill(10 ** 6)
    assert len(drv.tier.pool) > 0
    for _ in range(3):                            # retrains every tick
        drv.tick()
    assert drv.stats["pq_retrains"] >= 3
    _audit_residency(drv)
    q = data[:16]
    rec = metrics.recall_at_k(drv.search(q, 8).ids, drv.exact(q, 8).ids)
    assert rec >= 0.9, rec


def test_watermark_spills_cold_not_hot():
    """With a hot query working set, the watermark evicts the unqueried
    postings and the queried ones stay float-resident."""
    rng = np.random.default_rng(17)
    cents = rng.normal(size=(10, DIM)) * 8
    a = rng.integers(0, 10, 2000)
    data = (cents[a] + rng.normal(size=(2000, DIM))).astype(np.float32)
    drv = _make(_cfg(tier_hot_max=8, nprobe=4), data[:300])
    drv.insert(data, np.arange(2000))
    hot_q = (cents[0] + rng.normal(size=(32, DIM))).astype(np.float32)
    for _ in range(8):
        drv.search(hot_q, 8)                      # heat cluster 0 only
        drv.tick()
    assert drv.stats["tier_spilled"] > 0
    r = drv.tick()
    assert r.spilled >= 0 and r.promoted >= 0     # TickReport surface
    _, _, probe = search(drv.state, drv.cfg, torch.from_numpy(hot_q), 8, 4)
    probed = np.unique(probe.numpy())
    assert not drv.state.tier_spilled.numpy()[probed].all(), \
        "the hot working set was fully evicted"
    _audit_residency(drv)


# ---------------------------------------------------------------------------
# rounds and pool
# ---------------------------------------------------------------------------

def test_heat_wraps_and_saturates_as_uint32():
    """touch_round adds min(count, 2^20) modulo 2^32, decay halves: the
    reference's uint32 arithmetic on the port's int64 heat."""
    drv = _make(_cfg(), make_clustered(400, d=DIM, seed=2)[:300])
    st = drv.state
    st.heat[:4] = torch.tensor([0, 5, UINT32_MASK - 2, UINT32_MASK])
    counts = torch.zeros_like(st.heat)
    counts[:4] = torch.tensor([3, 1 << 22, 5, 1])
    touch_round(st, counts)
    assert st.heat[:4].tolist() == [3, 5 + (1 << 20), 2, 0]
    decay_round(st)
    assert st.heat[:4].tolist() == [1, (5 + (1 << 20)) >> 1, 1, 0]


def test_host_pool_grows_in_chunks_and_reuses_rows():
    pool = HostTierPool((3, 2), torch.float32)
    tiles = {p: torch.full((3, 2), float(p)) for p in (7, 2, 9)}
    for p, t in tiles.items():
        pool.put(p, t)
    assert list(pool.pids()) == [2, 7, 9] and len(pool) == 3
    assert pool.nbytes() == 3 * 3 * 2 * 4
    assert torch.equal(pool.take(7), tiles[7]) and 7 not in pool
    pool.put(11, torch.ones(3, 2))                # reuses 7's row
    assert len(pool._chunks) == 1
    assert torch.equal(pool.tiles([9, 11, 2]),
                       torch.stack([tiles[9], torch.ones(3, 2), tiles[2]]))
    assert pool.rows([2, 9], [1, 2]).tolist() == [[2.0, 2.0], [9.0, 9.0]]


# ---------------------------------------------------------------------------
# both drivers over one tiered stream
# ---------------------------------------------------------------------------

PCFG = dict(dim=DIM, max_postings=128, capacity=96, l_min=10, l_max=80,
            nprobe=8, max_ids=1 << 13, cache_capacity=2048, use_pq=True,
            pq_m=4, pq_ksub=16, rerank_k=96, use_tier=True, tier_hot_max=8)
PKW = dict(round_size=256, bg_ops_per_round=8, pq_retrain_every=3)
TIER_STATS = ("tier_spilled", "tier_promoted", "tier_resident",
              "search_spilled_hits", "inserted", "deleted", "bg_split",
              "bg_merge", "pq_retrains")


def _pstream(drv, data):
    """Watermark spills, forced spills, searches that heat and promote,
    re-trains, then everything spilled for the final reads."""
    out = {}
    drv.insert(data[:1200], np.arange(1200))
    drv.tick()
    drv.force_spill(6)
    drv.insert(data[1200:2000], np.arange(1200, 2000))
    drv.delete(np.arange(0, 400, 2))
    for i in range(8):
        drv.tick()
        if i % 3 == 0:
            drv.search(data[2000 + 8 * i:2008 + 8 * i], 8)
    drv.force_spill(10 ** 6)
    q = data[2100:2132]
    out["search"] = drv.search(q, 10)
    out["exact"] = drv.exact(q, 10)
    out["tiers"] = drv.memory_tiers()
    drv.tick()
    return out


@functools.lru_cache(maxsize=None)
def _pdata():
    return np.round(make_clustered(2400, d=DIM, k=10, seed=21))


@functools.lru_cache(maxsize=None)
def _jax_run(tier_async: bool):
    data = _pdata()
    jd = JDriver(JConfig(use_pallas="off", **PCFG), data[:300],
                 tier_async=tier_async, **PKW)
    return jd, _pstream(jd, data)


def _port_run(tier_async: bool):
    tcfg = UBISConfig(**PCFG)
    data = _pdata()
    init, pq_init, keys = jax_draws(tcfg, 300)
    td = make_index("ubis", tcfg, data[:300], device="cpu",
                    kmeans_init=init, pq_init=pq_init, pq_keys=keys,
                    tier_async=tier_async, **PKW)
    return td, _pstream(td, data)


def _assert_pools_match(tpool, jpool):
    np.testing.assert_array_equal(tpool.pids(), jpool.pids())
    for p in jpool.pids():
        assert tpool.get(p).numpy().tobytes() == \
            np.asarray(jpool.get(p)).tobytes(), p


@pytest.mark.parametrize("tier_async", [False, True])
def test_tiered_driver_stream_matches_jax(tier_async):
    jd, jout = _jax_run(tier_async)
    td, tout = _port_run(tier_async)
    got, want = bridge.state_to_numpy(td.state), jax_np(jd.state)
    for name in want:
        if name == "centroids":
            scale = max(1.0, float(np.abs(want[name]).max()))
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-4 * scale)
        else:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    assert got["heat"].dtype == np.uint32 and got["heat"].any()
    assert got["tier_spilled"].any()
    _assert_pools_match(td.tier.pool, jd.tier.pool)
    for key in TIER_STATS:
        assert td.stats[key] == jd.stats[key], key
    assert td.stats["tier_promoted"] > 0 and td.stats["pq_retrains"] >= 2
    assert td.stats["search_spilled_hits"] > 0
    for k in ("search", "exact"):
        np.testing.assert_array_equal(tout[k].ids, jout[k].ids, err_msg=k)
        np.testing.assert_array_equal(tout[k].scores, jout[k].scores,
                                      err_msg=k)
    # host bytes identical; device bytes differ by the uint32 fields the
    # port widens to int64 (rec_meta, rec_succ, heat: M each; the version;
    # the V codebook generations)
    assert tout["tiers"]["host"] == jout["tiers"]["host"] > 0
    M, V = PCFG["max_postings"], 2
    assert (tout["tiers"]["device"] - jout["tiers"]["device"]
            == 4 * (3 * M + 1 + V))
    _audit_residency(td)


def test_tiered_snapshot_crosses_the_bridge_both_ways():
    """A tiered JAX ``snapshot()`` (every tile present, flags set) carried
    as numpy into the port's ``load_snapshot`` rebuilds the same pool and
    answers as the JAX driver does; the port's snapshot goes back into a
    JAX driver the same way."""
    jd, _ = _jax_run(False)
    jd.force_spill(10 ** 6)
    tcfg = UBISConfig(**PCFG)
    data = _pdata()
    arrays = jax_np(jd.snapshot())
    assert arrays["tier_spilled"].any() and arrays["vectors"][
        arrays["tier_spilled"]].any()
    td = make_index("ubis", tcfg, data[:300], device="cpu", **PKW)
    td.load_snapshot(bridge.state_from_numpy(arrays, tcfg, "cpu"))
    _assert_pools_match(td.tier.pool, jd.tier.pool)
    np.testing.assert_array_equal(bridge.state_to_numpy(td.state)["vectors"],
                                  np.asarray(jd.state.vectors))
    _audit_residency(td)
    q = data[2200:2232]
    np.testing.assert_array_equal(td.search(q, 10).ids, jd.search(q, 10).ids)
    np.testing.assert_array_equal(td.exact(q, 10).ids, jd.exact(q, 10).ids)

    back = bridge.state_to_numpy(td.snapshot())
    np.testing.assert_array_equal(back["vectors"], arrays["vectors"])
    jd2 = JDriver(JConfig(use_pallas="off", **PCFG), data[:300], **PKW)
    jd2.load_snapshot(JState(**{k: jnp.asarray(v) for k, v in back.items()}))
    _assert_pools_match(td.tier.pool, jd2.tier.pool)
    np.testing.assert_array_equal(jd2.search(q, 10).ids,
                                  td.search(q, 10).ids)


# ---------------------------------------------------------------------------
# tests/test_serving.py::test_tier_async_matches_sync_liveness[ubis]
# ---------------------------------------------------------------------------

def test_tier_async_matches_sync_liveness():
    """Splitting the tier round into dispatch (tick start) / reconcile
    (tick end) never changes what is live: the same tiered churn, every
    insert, delete and search through the serving engine (``QueuedIndex``,
    searches overlapping the update flushes), holds the sync run's live
    multiset, keeps serving above the recall floor, and actually
    spills."""
    data = make_clustered(1500, d=DIM, k=8, seed=29)
    stats = {}
    for tier_async in (False, True):
        drv = QueuedIndex(_make(_cfg(tier_hot_max=8), data[:300],
                                tier_async=tier_async),
                          ServingConfig(tick_every=1))
        drv.insert(data[:900], np.arange(900))
        drv.tick()
        drv.force_spill(6)
        drv.insert(data[900:], np.arange(900, 1500))
        drv.delete(np.arange(0, 200))
        for _ in range(6):
            drv.tick()
        drv.flush(max_ticks=40)
        found = drv.search(data[300:332], 8).ids
        true = drv.exact(data[300:332], 8).ids
        hits = sum(len(set(f.tolist()) & set(t.tolist()))
                   for f, t in zip(found, true))
        stats[tier_async] = dict(live=drv.live_count(),
                                 spilled=drv.stats["tier_spilled"],
                                 recall=hits / true.size)
    assert stats[False]["live"] == stats[True]["live"] == 1300
    assert stats[True]["spilled"] > 0
    assert stats[True]["recall"] >= 0.9, stats


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tier's side-stream copies and "
                    "pinned pool run only there (chip_smoke.py phase 3f)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tier_async", [False, True])
def test_card_tiered_driver_matches_cpu(cuda_dev, tier_async):
    """The tiered stream on the card (pinned pool, side-stream copies,
    the kernels) and on the CPU (plain versions) with the same draws, on
    integer-valued data: identical state, pool, stats and answers."""
    tcfg = UBISConfig(**PCFG)
    data = _pdata()
    init, pq_init, keys = jax_draws(tcfg, 300)
    runs = {}
    for dev in ("cpu", cuda_dev):
        drv = make_index("ubis", tcfg, data[:300], device=dev,
                         kmeans_init=init, pq_init=pq_init, pq_keys=keys,
                         tier_async=tier_async, **PKW)
        runs[str(dev)] = (drv, _pstream(drv, data))
    (cd, cout), (gd, gout) = runs["cpu"], runs[str(cuda_dev)]
    assert gd.tier.pool.pin and gd.tier.pool._chunks[0].is_pinned()
    got, want = (bridge.state_to_numpy(gd.state),
                 bridge.state_to_numpy(cd.state))
    for name in want:
        if name != "centroids":
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    _assert_pools_match(gd.tier.pool, cd.tier.pool)
    for key in TIER_STATS:
        assert gd.stats[key] == cd.stats[key], key
    for k in ("search", "exact"):
        np.testing.assert_array_equal(gout[k].ids, cout[k].ids, err_msg=k)
    check_residency(gd.state, gd.cfg, gd.tier.pool)
