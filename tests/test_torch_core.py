"""The port's core against the JAX package, from one bridged JAX state.

A JAX driver builds and streams a small index; its state crosses to the
port through ``repro_torch.bridge`` (the checkpoint format: numpy arrays
keyed by field name).  Then the same round runs in both packages on the
same inputs, and the results must agree: integer and bool state and
every counter exactly, float state within ``1e-4 * scale`` (fp32 sums
run in another order in the two frameworks; the moved vectors are
copies and match exactly).  The clusters are well separated, so 2-means
meets no near-ties that rounding could flip.
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
from repro.core import balance as jbalance
from repro.core.search import brute_force as j_brute_force, search as j_search
from repro.core import update as jupdate, version_manager as jvm
from repro.core.build import initial_state as j_initial_state
from repro.core.types import KIND_COMPACT, KIND_MERGE, KIND_SPLIT
from repro_torch import bridge
from repro_torch.core import balance, search, update, version_manager as vm
from repro_torch.core.invariants import check_invariants
from repro_torch.core.types import UBISConfig, empty_state

KIND = {"split": KIND_SPLIT, "merge": KIND_MERGE, "compact": KIND_COMPACT}
CFG = dict(dim=8, max_postings=128, capacity=64, l_min=6, l_max=48,
           cache_capacity=512, max_ids=1 << 13)


def cfgs(mode="ubis", **kw):
    args = dict(CFG, mode=mode, **kw)
    return JConfig(use_pallas="off", **args), UBISConfig(**args)


def jax_np(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def assert_states_match(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating) and name == "centroids":
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


@functools.lru_cache(maxsize=None)
def streamed(mode="ubis", seed=0, n=1200):
    """A JAX state with oversize postings, tombstones, retired postings
    (DELETED with successors), marked postings and cache entries.
    Cached per module: JAX states are immutable, and every test bridges
    its own port state from them."""
    jcfg, tcfg = cfgs(mode)
    data = make_clustered(n + 200, d=jcfg.dim, k=6, seed=seed)
    drv = JDriver(jcfg, data[:150], round_size=128, bg_ops_per_round=8)
    drv.insert(data[:n], np.arange(n), tick_between=False)
    drv.delete(np.arange(0, n, 9))
    drv.tick()                       # marks
    drv.tick()                       # executes: retired parents + successors
    drv.insert(data[n:], np.arange(n, n + 200), tick_between=False)
    return jcfg, tcfg, drv.state, data


def marked(state, jcfg, bg_ops=8):
    """Mark a mixed candidate batch exactly as the driver does."""
    sd, md, cd = (np.asarray(x) for x in jbalance.detect(state, jcfg))
    lengths = np.asarray(state.lengths)
    split = np.flatnonzero(sd)
    split = split[np.argsort(-lengths[split])]
    merge = np.flatnonzero(md)
    merge = merge[np.argsort(lengths[merge])]
    jobs = ([("split", int(p)) for p in split]
            + [("compact", int(p)) for p in np.flatnonzero(cd)]
            + [("merge", int(p)) for p in merge])[:bg_ops]
    sl = [p for k, p in jobs if k in ("split", "compact")]
    ml = [p for k, p in jobs if k == "merge"]
    if sl:
        state = jupdate.mark_status(state, jnp.asarray(sl, jnp.int32), 1)
    if ml:
        state = jupdate.mark_status(state, jnp.asarray(ml, jnp.int32), 2)
    return state, jobs


# ---------------------------------------------------------------------------
# bridge + version manager
# ---------------------------------------------------------------------------

def test_bridge_round_trip_is_field_for_field_equal():
    jcfg, tcfg = cfgs()
    seeds = make_clustered(300, d=jcfg.dim, seed=1)
    js = j_initial_state(jcfg, jnp.asarray(seeds), key=jax.random.key(0))
    a = jax_np(js)
    back = bridge.state_to_numpy(bridge.state_from_numpy(a, tcfg, "cpu"))
    assert set(back) == set(a)
    for name in a:
        assert back[name].dtype == a[name].dtype, name
        np.testing.assert_array_equal(back[name], a[name], err_msg=name)


def test_bridge_rejects_mismatched_state():
    jcfg, tcfg = cfgs()
    a = bridge.state_to_numpy(empty_state(tcfg, "cpu"))
    with pytest.raises(ValueError):
        bridge.state_from_numpy({k: v for k, v in a.items() if k != "ids"},
                                tcfg, "cpu")
    with pytest.raises(ValueError):
        bridge.state_from_numpy(a, UBISConfig(**dict(CFG, dim=16)), "cpu")


def test_version_manager_matches_jax():
    rng = np.random.default_rng(0)
    status = rng.integers(0, 4, 50)
    weight = rng.integers(0, 2 ** 30, 50)
    meta = vm.pack_meta(t(status), t(weight))
    np.testing.assert_array_equal(
        meta.numpy().astype(np.uint32),
        np.asarray(jvm.pack_meta(jnp.asarray(status, jnp.uint32),
                                 jnp.asarray(weight, jnp.uint32))))
    np.testing.assert_array_equal(vm.unpack_weight(meta).numpy(), weight)
    s1, s2 = rng.integers(0, 0xFFFF + 1, 50), rng.integers(0, 0xFFFF + 1, 50)
    succ = vm.pack_succ(t(s1), t(s2))
    jsucc = jvm.pack_succ(jnp.asarray(s1), jnp.asarray(s2))
    np.testing.assert_array_equal(succ.numpy().astype(np.uint32), jsucc)
    for a, b in zip(vm.succ_ids(succ), jvm.succ_ids(jsucc)):
        np.testing.assert_array_equal(a.numpy(), b)
    # first-writer-wins transitions with padding and duplicate pids
    pids = np.array([3, -1, 7, 3, 0, 7, 12, -1], np.int32)
    rec = jnp.asarray(rng.integers(0, 2 ** 31, 16), jnp.uint32)
    ver = np.arange(8, dtype=np.uint32) + 100
    np.testing.assert_array_equal(
        vm.transition(t(np.asarray(rec), torch.int64), t(pids), 1,
                      t(ver, torch.int64)).numpy().astype(np.uint32),
        jvm.transition(rec, jnp.asarray(pids), 1, jnp.asarray(ver)))
    np.testing.assert_array_equal(
        vm.transition(t(np.asarray(rec), torch.int64), t(pids), 2)
        .numpy().astype(np.uint32),
        jvm.transition(rec, jnp.asarray(pids), 2))
    x = rng.integers(0, 6, 40)
    np.testing.assert_array_equal(vm.first_occurrence_mask(t(x)).numpy(),
                                  jvm.first_occurrence_mask(jnp.asarray(x)))


def test_chase_successors_matches_jax():
    jcfg, tcfg, js, data = streamed()
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    M = jcfg.max_postings
    pids = np.arange(M, dtype=np.int32)
    pts = make_clustered(M, d=jcfg.dim, k=6, seed=9)
    want = jvm.chase_successors(js.rec_meta, js.rec_succ, js.allocated,
                                js.centroids, jnp.asarray(pids),
                                jnp.asarray(pts), jcfg.succ_chase_depth)
    got = vm.chase_successors(ts.rec_meta, ts.rec_succ, ts.allocated,
                              ts.centroids, t(pids), t(pts),
                              tcfg.succ_chase_depth)
    status = np.asarray(jvm.unpack_status(js.rec_meta))
    assert (status[np.asarray(js.allocated)] == 3).any(), "no retired posting"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_group_ranks_matches_jax():
    rng = np.random.default_rng(3)
    keys = rng.integers(-1, 5, 64).astype(np.int32)
    valid = rng.random(64) < 0.8
    got = update.group_ranks(t(keys), t(valid)).numpy()
    want = np.asarray(jax.jit(jupdate.group_ranks)(jnp.asarray(keys),
                                                   jnp.asarray(valid)))
    np.testing.assert_array_equal(got[valid], want[valid])


# ---------------------------------------------------------------------------
# rounds from one bridged JAX state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ubis", "spfresh"])
def test_insert_round_matches_jax(mode):
    jcfg, tcfg, js, _ = streamed(mode)
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    rng = np.random.default_rng(4)
    J = 128            # the JAX driver's round size: reuses its compile
    vecs = make_clustered(J, d=jcfg.dim, k=6, seed=5)
    ids = np.arange(5000, 5000 + J, dtype=np.int32)
    valid = rng.random(J) < 0.9
    # hinted jobs: retired postings (pointer chasing) and live ones
    alloc = np.asarray(js.allocated)
    status = np.asarray(jvm.unpack_status(js.rec_meta))
    pool = np.flatnonzero(alloc)
    hints = np.where(rng.random(J) < 0.4, rng.choice(pool, J), -1)
    hints = hints.astype(np.int32)
    assert (status[hints[hints >= 0]] == 3).any()
    js2, jres, jtouched = jupdate.insert_round(
        js, jcfg, jnp.asarray(vecs), jnp.asarray(ids), jnp.asarray(valid),
        jnp.asarray(hints))
    ts2, tres, ttouched = update.insert_round(ts, tcfg, t(vecs), t(ids),
                                              t(valid), t(hints))
    for f in ("accepted", "cached", "rejected", "target"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(ttouched.numpy(), np.asarray(jtouched))
    assert np.asarray(jres.accepted).any() and np.asarray(
        jres.cached | jres.rejected).any()
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))


@pytest.mark.parametrize("mode", ["ubis", "spfresh"])
def test_delete_round_matches_jax(mode):
    jcfg, tcfg, js, _ = streamed(mode)
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    rng = np.random.default_rng(6)
    cached = np.flatnonzero(np.asarray(js.cache_valid))
    cached_ids = np.asarray(js.cache_ids)[cached][:10]  # cached vectors
    del_ids = np.concatenate([
        rng.integers(0, 1400, 125 - len(cached_ids)),  # live, gone, absent
        cached_ids,
        [17, 17, 4000]]).astype(np.int32)              # duplicate, absent
    valid = rng.random(len(del_ids)) < 0.95
    js2, jdone, jblocked = jupdate.delete_round(
        js, jcfg, jnp.asarray(del_ids), jnp.asarray(valid))
    ts2, tdone, tblocked = update.delete_round(ts, tcfg, t(del_ids), t(valid))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tblocked.numpy(), np.asarray(jblocked))
    assert np.asarray(jdone).any()
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))


def _round_inputs(jobs, B=8):
    kinds = np.zeros(B, np.int32)
    pids = np.full(B, -1, np.int32)
    for i, (k, p) in enumerate(jobs):
        kinds[i], pids[i] = KIND[k], p
    return kinds, pids


@pytest.mark.parametrize("mode,seed", [("ubis", 0), ("ubis", 1),
                                       ("spfresh", 0)])
def test_background_round_matches_jax(mode, seed):
    jcfg, tcfg, js, _ = streamed(mode, seed=seed)
    js, jobs = marked(js, jcfg)
    assert jobs
    kinds, pids = _round_inputs(jobs)
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    js2, jrr = jbalance.background_round(js, jcfg, jnp.asarray(kinds),
                                         jnp.asarray(pids))
    ts2, trr = balance.background_round(ts, tcfg, t(kinds), t(pids))
    want = {f.name: int(getattr(jrr, f.name))
            for f in dataclasses.fields(jrr)}
    assert trr.to_host() == want
    assert want["executed"] > 0
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))
    check_invariants(ts2, tcfg)


def test_gc_round_matches_jax():
    jcfg, tcfg, js, _ = streamed()
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    ver = int(js.global_version)
    js2, jn = jbalance.gc_round(js, jcfg, jnp.uint32(ver), 64)
    ts2, tn = balance.gc_round(ts, tcfg, ver, 64)
    assert int(tn) == int(jn) > 0
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))


def test_free_stack_rebuild_and_pressure_match_jax():
    jcfg, tcfg, js, _ = streamed()
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    np.testing.assert_array_equal(balance.shard_pressure(ts, tcfg).numpy(),
                                  np.asarray(jbalance.shard_pressure(js, jcfg)))
    js2 = jupdate.ensure_free_stack(js)
    ts2 = update.ensure_free_stack(ts)
    assert_states_match(bridge.state_to_numpy(ts2), jax_np(js2))
    ts2.free_list[0] = ts2.free_list[1]           # alias one free slot twice
    with pytest.raises(AssertionError, match="free stack"):
        check_invariants(ts2, tcfg)


def test_check_invariants_catches_an_id_loc_desync():
    jcfg, tcfg, js, _ = streamed()
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    check_invariants(ts, tcfg)
    live = int(torch.nonzero(ts.id_loc >= 0)[0, 0])
    ts.id_loc[live] = ts.id_loc[live] + 1
    with pytest.raises(AssertionError, match="id_loc"):
        check_invariants(ts, tcfg)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def test_search_and_brute_force_match_jax():
    jcfg, tcfg, js, _ = streamed()
    ts = bridge.state_from_numpy(jax_np(js), tcfg, "cpu")
    assert np.asarray(js.cache_valid).any()
    q = make_clustered(24, d=jcfg.dim, k=6, seed=8)
    for k, nprobe in ((10, 4), (5, 2)):
        jf, jsc, jp = j_search(js, jcfg, jnp.asarray(q), k, nprobe)
        tf, tsc, tp = search.search(ts, tcfg, t(q), k, nprobe)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(
                                       np.asarray(jsc)).max())))
    jf, _ = j_brute_force(js, jcfg, jnp.asarray(q), 10)
    tf, _ = search.brute_force(ts, tcfg, t(q), 10)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
