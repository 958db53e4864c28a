"""The port's quant plane (``use_pq=True``) against the JAX package.

* The plain versions of the three quant kernels (``kmeans_assign``,
  ``pq_scan_topk``, ``rerank_topk``: what ``repro_torch.kernels.ops``
  runs on a CPU tensor) against JAX ``ops.*`` with ``backend="pallas"``
  (interpret mode, as tests/test_kernels.py runs it) and
  ``backend="ref"``, at main and edge shapes: odd C = 33, d = 100 with
  m = 10, ksub = 100, R = 64 and 192, all masked, integer ties, a
  spilled mask and empty ADC slots.  Ids and tie order must match
  exactly; scores within ``1e-5 * scale`` (scale: the largest real
  score; the frameworks sum in other orders, and fp32 keeps ~7 digits).
  Integer-valued inputs make every sum exact, so there the scores match
  exactly too.
* ``quant/pq.py`` (encode, decode, lookup tables, codebook training, the
  re-train round) and the quant branches of the insert, background and
  search rounds, from one bridged JAX state, with the JAX draws
  injected.  On integer-valued data every sum is exact in any order, so
  codes, codebook slots, generations, codebooks and the integer state
  must be identical.
* Both drivers over one stream with ``pq_retrain_every=2``: identical
  live ids, stats and quant state, and the port's quant invariant after
  every tick.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from conftest import make_clustered
from repro.core import UBISConfig as JConfig, UBISDriver as JDriver
from repro.core import balance as jbalance, update as jupdate
from repro.core.search import search as j_search
from repro.core.types import KIND_COMPACT, KIND_MERGE, KIND_SPLIT
from repro.kernels import ops as jops
from repro.quant import pq as jpq
from repro_torch import bridge
from repro_torch.api import make_index
from repro_torch.core import balance, search, update
from repro_torch.core.build import SAMPLE_CAP, initial_posting_count
from repro_torch.core.driver import PQ_SEED_OFFSET
from repro_torch.core.invariants import check_codes, check_invariants
from repro_torch.core.types import UBISConfig
from repro_torch.kernels import ops
from repro_torch.quant import pq

BACKENDS = ["pallas", "ref"]
BIG = 1e30


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    real = want[want < 1e29]
    scale = max(1.0, float(np.abs(real).max())) if real.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _data(rng, kind, shape):
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "ties":
        return rng.integers(-1, 2, shape).astype(np.float32)
    return rng.integers(-3, 4, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the three kernels' plain versions
# ---------------------------------------------------------------------------

# (N, K, d, kind, p_unmasked): main, ksub=100 with dsub=10, ties, all masked
KA_CASES = [(300, 16, 4, "normal", 0.8), (257, 100, 10, "normal", 0.8),
            (300, 256, 4, "ties", 0.8), (64, 16, 4, "int", 0.0)]


@pytest.mark.parametrize("N,K,d,kind,p", KA_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_kmeans_assign_matches_jax(N, K, d, kind, p, backend):
    rng = np.random.default_rng(N + K + d + len(kind))
    pts, cents = _data(rng, kind, (N, d)), _data(rng, kind, (K, d))
    mask = rng.random(N) < p
    wa, wb = jops.kmeans_assign(jnp.asarray(pts), jnp.asarray(cents),
                                jnp.asarray(mask), backend=backend)
    ga, gb = ops.kmeans_assign(_t(pts), _t(cents), _t(mask))
    assert ga.dtype == torch.int32 and ga.shape == (N,)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    _close(gb.numpy(), wb)


def test_kmeans_assign_batches_share_points():
    """Batch b of the batched form scores points[b % Bp]: one launch
    encodes a set of rows under every subspace and codebook version."""
    rng = np.random.default_rng(3)
    pts = _t(_data(rng, "int", (2, 50, 4)))
    cents = _t(_data(rng, "int", (6, 16, 4)))
    mask = _t(rng.random(50) < 0.7)
    a, b = ops.kmeans_assign(pts, cents, mask)
    assert a.shape == b.shape == (6, 50)
    for i in range(6):
        ai, bi = ops.kmeans_assign(pts[i % 2], cents[i], mask)
        assert torch.equal(a[i], ai) and torch.equal(b[i], bi)


# (Q, M, C, P, m, ksub, k, kind, p_valid): main, odd C=33 with m=10 and
# ksub=100 at R=64, R=192, integer ties, all masked
PQ_CASES = [(6, 12, 24, 4, 4, 16, 32, "normal", 0.6),
            (5, 9, 33, 8, 10, 100, 64, "normal", 0.6),
            (4, 16, 33, 8, 4, 256, 192, "normal", 0.6),
            (6, 12, 24, 4, 4, 16, 32, "ties", 0.6),
            (6, 12, 24, 4, 4, 16, 32, "int", 0.0)]


@pytest.mark.parametrize("Q,M,C,P,m,ksub,k,kind,p", PQ_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_pq_scan_topk_matches_jax(Q, M, C, P, m, ksub, k, kind, p, backend):
    rng = np.random.default_rng(Q * M * C + k + len(kind))
    V = 2
    luts = _data(rng, kind, (Q, V, m, ksub))
    codes = rng.integers(0, ksub, (M, m, C)).astype(np.uint8)
    slot = rng.integers(0, V, M).astype(np.int32)
    slot_valid = rng.random((M, C)) < p
    vis = rng.random(M) < 0.8
    probe = rng.integers(0, M, (Q, P)).astype(np.int32)
    qp_ok = (rng.random((Q, P)) < 0.8).astype(np.int32)
    ws, wi = jops.pq_scan_topk(
        jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(slot),
        jnp.asarray(slot_valid), jnp.asarray(vis), jnp.asarray(probe), k=k,
        qp_ok=jnp.asarray(qp_ok), backend=backend)
    gs, gi = ops.pq_scan_topk(_t(luts), _t(codes), _t(slot), _t(slot_valid),
                              _t(vis), _t(probe), k=k, qp_ok=_t(qp_ok))
    assert gi.dtype == torch.int32 and gi.shape == (Q, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gs.numpy(), ws)


# (Q, M, C, d, R, k, kind, p_spilled, p_empty): plain, d=100 with odd C at
# R=192 with spilled postings and empty ADC slots, ties at k=R, all empty
RR_CASES = [(6, 12, 24, 16, 64, 10, "normal", 0.0, 0.0),
            (5, 9, 33, 100, 192, 32, "normal", 0.3, 0.2),
            (6, 12, 24, 16, 64, 64, "ties", 0.3, 0.2),
            (4, 12, 24, 16, 64, 10, "int", 0.0, 1.0)]


@pytest.mark.parametrize("Q,M,C,d,R,k,kind,ps,pe", RR_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_rerank_topk_matches_jax(Q, M, C, d, R, k, kind, ps, pe, backend):
    rng = np.random.default_rng(Q * M * C + R + k + len(kind))
    q, vecs = _data(rng, kind, (Q, d)), _data(rng, kind, (M, C, d))
    spilled = rng.random(M) < ps
    cand = np.stack([rng.permutation(M * C)[:R] for _ in range(Q)])
    cand = cand.astype(np.int32)
    adc = np.sort(_data(rng, kind, (Q, R)) * 10, axis=1)
    empty = rng.random((Q, R)) < pe
    adc = np.where(empty, np.where(rng.random((Q, R)) < 0.5, BIG, np.inf),
                   adc).astype(np.float32)
    ws, wi = jops.rerank_topk(jnp.asarray(q), jnp.asarray(vecs),
                              jnp.asarray(spilled), jnp.asarray(cand),
                              jnp.asarray(adc), k=k, backend=backend)
    gs, gi = ops.rerank_topk(_t(q), _t(vecs), _t(spilled), _t(cand),
                             _t(adc), k=k)
    assert gi.dtype == torch.int32 and gi.shape == (Q, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gs.numpy(), ws)
    if ps:                                 # the passthrough was exercised
        assert spilled[np.asarray(wi) // C].any()


# ---------------------------------------------------------------------------
# quant/pq.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,m,ksub", [(16, 4, 16), (100, 10, 100),
                                      (16, 4, 256)])
def test_encode_decode_and_lookup_tables_match_jax(d, m, ksub):
    rng = np.random.default_rng(d + m + ksub)
    V, dsub = 2, d // m
    cbv = rng.normal(size=(V, m, ksub, dsub)).astype(np.float32)
    x = rng.normal(size=(120, d)).astype(np.float32)
    tiles = x[:96].reshape(4, 24, d)
    q = rng.normal(size=(7, d)).astype(np.float32)
    want = np.asarray(jpq.encode(jnp.asarray(cbv[0]), jnp.asarray(x)))
    got = pq.encode(_t(cbv[0]), _t(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pq.encode_all_versions(_t(cbv), _t(x)).numpy(),
        np.asarray(jpq.encode_all_versions(jnp.asarray(cbv),
                                           jnp.asarray(x))))
    np.testing.assert_array_equal(
        pq.encode_tiles(_t(cbv[1]), _t(tiles)).numpy(),
        np.asarray(jpq.encode_tiles(jnp.asarray(cbv[1]),
                                    jnp.asarray(tiles))))
    np.testing.assert_array_equal(
        pq.decode(_t(cbv[0]), _t(want)).numpy(),
        np.asarray(jpq.decode(jnp.asarray(cbv[0]), jnp.asarray(want))))
    _close(pq.lookup_tables(_t(cbv), _t(q)).numpy(),
           jpq.lookup_tables(jnp.asarray(cbv), jnp.asarray(q)))


@pytest.mark.parametrize("m,ksub,p", [(4, 16, 1.0), (4, 16, 0.7),
                                      (10, 100, 0.9)])
def test_train_and_init_codebooks_match_jax(m, ksub, p):
    """On integer-valued samples the Lloyd sums are exact in any order,
    so the codebooks must be identical, not just close."""
    rng = np.random.default_rng(m * ksub)
    d = 8 * m if m == 4 else 10 * m
    sample = np.round(make_clustered(400, d=d, k=12, seed=ksub))
    mask = rng.random(400) < p
    init = sample[rng.choice(400, ksub, replace=False)]
    init = init.reshape(ksub, m, d // m).transpose(1, 0, 2)
    want = jpq.train_codebooks(jnp.asarray(sample), jnp.asarray(mask),
                               jnp.asarray(init), 6)
    got = pq.train_codebooks(_t(sample), _t(mask), _t(init), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = jax.random.key(ksub)
    idx = np.asarray(jax.random.choice(key, 400, (ksub,), replace=False))
    want = jpq.init_codebooks(jnp.asarray(sample), m, ksub, 6, key)
    got = pq.init_codebooks(_t(sample), m, ksub, 6, _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# rounds from one bridged JAX quant state
# ---------------------------------------------------------------------------

CFG = dict(dim=16, max_postings=512, capacity=16, l_min=3, l_max=12,
           cache_capacity=512, max_ids=1 << 13, use_pq=True, pq_m=4,
           pq_ksub=16, rerank_k=48)


def cfgs(mode="ubis"):
    return (JConfig(use_pallas="off", mode=mode, **CFG),
            UBISConfig(mode=mode, **CFG))


def jax_np(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def assert_states_match(got: dict, want: dict):
    """Every field identical, codes and codebooks included (integer-valued
    data), except the posting centroids: a merged centroid is a weighted
    mean of means, which the two frameworks round at other places, so
    they match within ``1e-4 * scale``, as in tests/test_torch_core.py."""
    assert set(got) == set(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name == "centroids":
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@functools.lru_cache(maxsize=None)
def pq_streamed(mode="ubis"):
    """A JAX quant state on integer-valued data: a few hundred postings
    (more than the re-train's 128-posting re-encode budget), retired
    postings, cache entries, two codebook generations."""
    jcfg, tcfg = cfgs(mode)
    data = np.round(make_clustered(2400, d=16, k=8, seed=7))
    drv = JDriver(jcfg, data[:600], round_size=128, bg_ops_per_round=16,
                  pq_retrain_every=3)
    drv.insert(data[:2000], np.arange(2000), tick_between=False)
    drv.delete(np.arange(0, 2000, 7))
    for _ in range(3):
        drv.tick()
    drv.insert(data[2000:], np.arange(2000, 2400), tick_between=False)
    assert int(drv.state.pq_active) == 1
    return jcfg, tcfg, drv.state, data


def test_bridged_quant_state_round_trips_and_holds_the_invariant():
    jcfg, tcfg, js, _ = pq_streamed()
    a = jax_np(js)
    ts = bridge.state_from_numpy(a, tcfg, "cpu")
    back = bridge.state_to_numpy(ts)
    for name in ("codes", "pq_codebooks", "pq_slot_gen", "pq_active",
                 "pq_posting_slot"):
        assert back[name].dtype == a[name].dtype, name
        np.testing.assert_array_equal(back[name], a[name], err_msg=name)
    assert ts.pq_slot_gen.dtype == torch.int64
    assert int(np.asarray(js.allocated).sum()) > 128
    check_invariants(ts, tcfg)
    live = ts.allocated & ((ts.rec_meta & 3) != 3)            # not DELETED
    p = int(torch.nonzero(ts.slot_valid.any(-1) & live)[0, 0])
    c = int(torch.nonzero(ts.slot_valid[p])[0, 0])
    ts.codes[p, 0, c] = (ts.codes[p, 0, c] + 1) % tcfg.pq_ksub
    with pytest.raises(AssertionError, match="codes diverged"):
        check_codes(ts, tcfg)


@pytest.mark.parametrize("pinned", ["none", "few", "all"])
def test_retrain_round_matches_jax(pinned):
    """One re-train from a bridged state with the JAX key's draws
    injected, through each branch: nothing pinned to the evicted slot, a
    few postings (gathered), more than 128 (the whole pool encoded)."""
    jcfg, tcfg, js, _ = pq_streamed()
    a = jax_np(js)
    evict = (int(a["pq_active"]) + 1) % tcfg.pq_versions
    alloc = np.flatnonzero(a["allocated"])
    slot = np.full_like(a["pq_posting_slot"], 1 - evict)
    slot[alloc[:{"none": 0, "few": 9, "all": len(alloc)}[pinned]]] = evict
    a["pq_posting_slot"] = slot
    js = dataclasses.replace(js, pq_posting_slot=jnp.asarray(slot))
    key = jax.random.key(5)
    M, C = tcfg.max_postings, tcfg.capacity
    keys = np.asarray(jax.random.uniform(key, (M * C,)))
    js2 = jpq.retrain_round(js, jcfg, key)
    ts2 = pq.retrain_round(bridge.state_from_numpy(a, tcfg, "cpu"), tcfg,
                           _t(keys))
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))
    assert int(ts2.pq_active) == evict


@pytest.mark.parametrize("mode", ["ubis", "spfresh"])
def test_quant_insert_round_matches_jax(mode):
    jcfg, tcfg, js, data = pq_streamed(mode)
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    rng = np.random.default_rng(4)
    J = 128            # the JAX driver's round size: reuses its compile
    vecs = np.round(make_clustered(J, d=16, k=8, seed=9))
    ids = np.arange(5000, 5000 + J, dtype=np.int32)
    valid = rng.random(J) < 0.9
    hints = np.full(J, -1, np.int32)
    js2, jres, _ = jupdate.insert_round(
        js, jcfg, jnp.asarray(vecs), jnp.asarray(ids), jnp.asarray(valid),
        jnp.asarray(hints))
    ts2, tres, _ = update.insert_round(ts, tcfg, _t(vecs), _t(ids),
                                       _t(valid), _t(hints))
    np.testing.assert_array_equal(tres.accepted.numpy(),
                                  np.asarray(jres.accepted))
    assert np.asarray(jres.accepted).any()
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))
    check_invariants(ts2, tcfg)


KIND = {"split": KIND_SPLIT, "merge": KIND_MERGE, "compact": KIND_COMPACT}


@pytest.mark.parametrize("mode", ["ubis", "spfresh"])
def test_quant_background_round_matches_jax(mode):
    """Every tile the round writes re-encodes under the active codebook
    and repins its slot; the move-outs carry their codes."""
    jcfg, tcfg, js, _ = pq_streamed(mode)
    sd, md, cd = (np.asarray(x) for x in jbalance.detect(js, jcfg))
    jobs = ([("split", int(p)) for p in np.flatnonzero(sd)]
            + [("compact", int(p)) for p in np.flatnonzero(cd)]
            + [("merge", int(p)) for p in np.flatnonzero(md)])
    seen, uniq = set(), []
    for k, p in jobs:
        if p not in seen:
            seen.add(p)
            uniq.append((k, p))
    jobs = uniq[:16]
    assert jobs
    for status, kinds in ((1, ("split", "compact")), (2, ("merge",))):
        sel = [p for k, p in jobs if k in kinds]
        if sel:
            js = jupdate.mark_status(js, jnp.asarray(sel, jnp.int32), status)
    kinds = np.zeros(16, np.int32)
    pids = np.full(16, -1, np.int32)
    for i, (k, p) in enumerate(jobs):
        kinds[i], pids[i] = KIND[k], p
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    js2, jrr = jbalance.background_round(js, jcfg, jnp.asarray(kinds),
                                         jnp.asarray(pids))
    ts2, trr = balance.background_round(ts, tcfg, _t(kinds), _t(pids))
    assert trr.to_host() == {f.name: int(getattr(jrr, f.name))
                             for f in dataclasses.fields(jrr)}
    assert int(jrr.executed) > 0
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))
    check_invariants(ts2, tcfg)


def test_quant_search_matches_jax():
    """ADC scan, exact rerank and the cache merge: ids exact."""
    jcfg, tcfg, js, _ = pq_streamed()
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    assert np.asarray(js.cache_valid).any()
    q = np.round(make_clustered(24, d=16, k=8, seed=8))
    for k, nprobe in ((10, 4), (5, 2), (48, 8)):
        jf, jsc, jp = j_search(js, jcfg, jnp.asarray(q), k, nprobe)
        tf, tsc, tp = search.search(ts, tcfg, _t(q), k, nprobe)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


# ---------------------------------------------------------------------------
# both drivers over one stream, re-training every other tick
# ---------------------------------------------------------------------------

def jax_draws(tcfg, n_seed, seed=0, retrains=40):
    """The JAX driver's random draws, to inject into the port: the
    k-means init, the generation-0 codebook sample, the re-train keys."""
    key = jax.random.key(seed)
    k0 = initial_posting_count(tcfg, n_seed)
    init = np.asarray(jax.random.choice(key, n_seed, (k0,), replace=False))
    _, pk = jax.random.split(key)
    n = min(n_seed, SAMPLE_CAP)
    pq_init = np.asarray(jax.random.choice(pk, n, (tcfg.pq_ksub,),
                                           replace=n < tcfg.pq_ksub))
    M, C = tcfg.max_postings, tcfg.capacity
    rkey, keys = jax.random.key(seed + PQ_SEED_OFFSET), []
    for _ in range(retrains):
        rkey, k = jax.random.split(rkey)
        keys.append(np.asarray(jax.random.uniform(k, (M * C,))))
    return init, pq_init, keys


@pytest.mark.parametrize("engine", ["ubis", "spfresh"])
def test_quant_driver_stream_matches_jax(engine):
    jcfg, tcfg = cfgs(engine)
    data = np.round(make_clustered(2400, d=16, k=8, seed=7))
    seeds = data[:600]
    init, pq_init, keys = jax_draws(tcfg, len(seeds))
    kw = dict(round_size=128, bg_ops_per_round=16, pq_retrain_every=2)
    jd = JDriver(jcfg, seeds, **kw)
    td = make_index(engine, tcfg, seeds, device="cpu", kmeans_init=init,
                    pq_init=pq_init, pq_keys=keys, **kw)
    np.testing.assert_array_equal(td.state.pq_codebooks.numpy(),
                                  np.asarray(jd.state.pq_codebooks))
    for drv in (jd, td):
        drv.insert(data[:2000], np.arange(2000), tick_between=False)
        drv.delete(np.arange(0, 2000, 5))
    for _ in range(6):
        jr, tr = jd.tick(), td.tick()
        assert tr.pq_retrained == jr.pq_retrained
        check_invariants(td.state, tcfg)
    for drv in (jd, td):
        drv.insert(data[2000:], np.arange(2000, 2400))
    assert_states_match(bridge.state_to_numpy(td.state), jax_np(jd.state))
    for key in ("inserted", "deleted", "rejected", "bg_split", "bg_merge",
                "pq_retrains", "pq_generation"):
        assert td.stats[key] == jd.stats[key], key
    assert td.stats["pq_retrains"] >= 3
    q = np.round(make_clustered(32, d=16, k=8, seed=11))
    np.testing.assert_array_equal(td.search(q, 10).ids, jd.search(q, 10).ids)
    assert td.stats["search_adc_batches"] == 1
    assert td.stats["search_exact_batches"] == 0
