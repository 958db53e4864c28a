"""The port's cluster plane against the JAX package's, on the CPU.

The streams, configuration and tape of ``tests/test_cluster.py`` (its
``_cfg``, ``TIER_KW`` and ``_interleaving``) drive both packages' cluster
coordinators with the JAX random draws injected into the port (one set
per worker when ``workers > 1``: worker w draws for its k-means over
``seed_vectors[w::W]`` under its own ``max_postings / W`` config).

* the protocol: one payload encodes to the same bytes in both packages
  and each decodes the other's frames; a foreign schema and a truncated
  frame are refused, a torch tensor is never coerced;
  ``plan_insert_split`` and ``live_multiset_digest`` equal the JAX
  functions;
* ``workers=1`` on the ``LocalBackend``: the tape, the snapshot field by
  field (through the bridge) and the digest equal the JAX coordinator's,
  and, plain and tiered, bit for bit the port's ``ShardedUBISDriver``'s.
  The JAX package's tiered cluster raises jax's ``ShardingTypeError``
  here (its own ``test_local_w1_bit_identical_to_sharded_driver[tiered]``
  fails the same way; ROADMAP §3), so the tiered tape is held to the
  port's sharded driver, which ``tests/test_torch_contract.py`` holds to
  the contract harness's oracle;
* ``workers=2`` on the Zipf stream of ``tests/test_cluster.py::
  test_two_workers_stay_occupancy_balanced_on_zipf_stream``, then
  deletes that drain worker 0: the tape, ``worker_live()``, the
  per-worker digests and the spread-balance migrations equal the JAX
  coordinator's;
* the failure plane on the port: the straggler event, kill -> journal
  replay -> the same digest, checkpoint -> kill -> replay from the
  checkpoint, and the loud failures of a partial, corrupt,
  foreign-schema or wrong-count checkpoint;
* across frameworks: a cluster checkpoint written by either package
  loads in the other (digests verified), and the restored cluster
  answers the same searches;
* the multiprocess backend: one stream equals the local backend's
  (two worker processes), a worker killed mid-stream leaves the digest
  unchanged, and no worker process imports ``jax`` or ``repro``;
* ``tier_rerank_host=False`` and ``TierManager.drain_commits`` on both
  drivers against the JAX drivers on a tiered stream.

The JAX side runs with ``use_pallas="off"``; scores are compared within
fp32 tolerance, ids and every count exactly.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro.cluster import ClusterCoordinator as JCoordinator
from repro.cluster import plan_insert_split as j_plan_insert_split
from repro.cluster import protocol as jprotocol
from repro.checkpoint.manager import (
    load_cluster_checkpoint as j_load_cluster_checkpoint)
from repro.core import UBISConfig as JConfig
from repro_torch import bridge
from repro_torch.api import make_index
from repro_torch.checkpoint.manager import (ClusterManifestError,
                                            load_cluster_checkpoint)
from repro_torch.cluster import (ClusterCoordinator, ProtocolError,
                                 WorkerLost, combine_digests,
                                 plan_insert_split, protocol)
from repro_torch.core.types import UBISConfig
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.obs import Obs
from test_cluster import TIER_KW, _cfg, _interleaving
from test_torch_core import assert_states_match
from test_torch_pq import jax_draws

SCORE_TOL = dict(rtol=1e-5, atol=1e-3)      # fp32, scores ~1e2-1e3
KW = dict(round_size=128, bg_ops_per_round=8, insert_retries=2,
          pq_retrain_every=4, seed=0)


def _tcfg(**kw) -> UBISConfig:
    """The port's twin of ``tests/test_cluster.py``'s ``_cfg``."""
    jc = _cfg(**kw)
    d = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
         if f.name not in ("use_pallas", "dtype")}
    return UBISConfig(**d)


def _draws(tcfg, seeds, workers: int, seed: int = 0) -> dict:
    """The JAX draws for each worker of a ``workers``-worker cluster."""
    per = []
    for w in range(workers):
        wcfg = tcfg if workers == 1 else dataclasses.replace(
            tcfg, max_postings=tcfg.max_postings // workers,
            nprobe=min(tcfg.nprobe, tcfg.max_postings // workers))
        per.append(jax_draws(wcfg, len(seeds[w::workers]), seed=seed))
    out = {}
    for i, name in enumerate(("kmeans_init", "pq_init", "pq_keys")):
        vals = [p[i] for p in per]
        out[name] = vals[0] if workers == 1 else vals
    return out


def _port(tcfg, seeds, workers=1, **kw):
    return ClusterCoordinator(tcfg, seeds, workers=workers, device="cpu",
                              **_draws(tcfg, seeds, workers,
                                       kw.get("seed", 0)), **kw)


def _assert_tapes_close(a, b, exact_scores=False):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0]
        if ra[0] == "search":
            np.testing.assert_array_equal(ra[1], rb[1])
            if exact_scores:
                np.testing.assert_array_equal(ra[2], rb[2])
            else:
                np.testing.assert_allclose(ra[2], rb[2], **SCORE_TOL)
        else:
            assert ra[1:] == rb[1:], (ra, rb)


def _np_snap(state) -> dict:
    """A port or JAX state in the checkpoint format; a JAX state goes
    through the port's ``payload_to_state`` (its 0-d fields arrive from
    the codec with shape (1,))."""
    if not torch.is_tensor(state.rec_meta):
        state = protocol.payload_to_state(
            {f.name: np.asarray(getattr(state, f.name))
             for f in dataclasses.fields(state)})
    return bridge.state_to_numpy(state)


# ---------------------------------------------------------------- protocol

def _payload():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "i64": rng.integers(-5, 5, 7),
        "u32": np.arange(6, dtype=np.uint32).reshape(2, 3),
        "scalar0d": np.array(7, np.int32),
        "bools": np.array([True, False]),
        "nested": {"x": np.arange(4, dtype=np.int32), "s": "hi",
                   "none": None, "f": 1.5, "list": [1, "a", None]},
        "scalar": np.float32(2.5),
    }


def test_codec_bytes_equal_across_packages():
    import io
    p = _payload()
    buf, jbuf = (protocol.encode_message("test", p, 7),
                 jprotocol.encode_message("test", p, 7))
    assert buf == jbuf
    for dec, enc in ((protocol.decode_message, jbuf),
                     (jprotocol.decode_message, buf)):
        out = dec(enc)["payload"]
        assert out["f32"].tobytes() == p["f32"].tobytes()
        assert out["u32"].dtype == np.uint32
        np.testing.assert_array_equal(out["i64"], p["i64"])
        assert out["nested"]["list"] == [1, "a", None]
        assert out["scalar"] == 2.5
    # framing: each package reads the other's frames
    a, b = io.BytesIO(), io.BytesIO()
    protocol.write_frame(a, buf)
    jprotocol.write_frame(b, jbuf)
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    assert jprotocol.read_frame(a) == buf
    b.seek(0)
    assert protocol.read_frame(b) == jbuf


def test_codec_refuses_foreign_schema_truncation_and_tensors():
    import io
    for enc in (protocol.encode_message, jprotocol.encode_message):
        buf = enc("ping", {}, 1, v=protocol.SCHEMA_VERSION + 1)
        with pytest.raises(ProtocolError, match="schema version"):
            protocol.decode_message(buf)
    buf = protocol.encode_message("m", {"a": np.arange(10)}, 3)
    with pytest.raises(ProtocolError, match="truncated"):
        protocol.decode_message(buf[:-5])
    with pytest.raises(ProtocolError, match="truncated"):
        protocol.decode_message(buf[:3])
    bio = io.BytesIO()
    protocol.write_frame(bio, buf)
    for cut in (3, 12):
        trunc = io.BytesIO(bio.getvalue()[:-cut] if cut == 3
                           else bio.getvalue()[:5])
        with pytest.raises(ProtocolError):
            protocol.read_frame(trunc)
    with pytest.raises(ProtocolError, match="unserializable"):
        protocol.encode_message("m", {"t": torch.zeros(3)}, 1)


def test_plan_insert_split_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        live = rng.integers(0, 1000, int(rng.integers(1, 6)))
        n = int(rng.integers(0, 3000))
        got = plan_insert_split(live, n)
        np.testing.assert_array_equal(got, j_plan_insert_split(live, n))
        assert got.sum() == n


def test_digest_equals_jax_and_is_order_independent():
    cfg = _tcfg()
    sv = make_clustered(400)
    rng = np.random.default_rng(1)
    perm = rng.permutation(200)
    a = make_index("ubis-sharded", cfg, sv[:100], round_size=128, seed=0,
                   device="cpu")
    b = make_index("ubis-sharded", cfg, sv[:100], round_size=128, seed=1,
                   device="cpu")
    a.insert(sv[100:300][perm], np.arange(200)[perm])
    b.insert(sv[100:300], np.arange(200))
    b.delete(np.arange(0, 200, 7))
    b.insert(sv[100:300][::7], np.arange(0, 200, 7))
    pa = protocol.state_to_payload(a.snapshot())
    assert pa["rec_meta"].dtype == np.uint32
    import types
    d = protocol.live_multiset_digest(pa)
    assert d == jprotocol.live_multiset_digest(types.SimpleNamespace(**pa))
    assert d == protocol.live_multiset_digest(a.snapshot())
    assert d == protocol.live_multiset_digest(b.snapshot())
    assert combine_digests([d, 0]) == d and combine_digests([d, d]) != d


# --------------------------------------------- workers = 1 and workers = 2


@pytest.mark.parametrize("tiered", [False, True], ids=["plain", "tiered"])
def test_w1_bit_identical_to_sharded_driver(tiered):
    """``tests/test_cluster.py::test_local_w1_bit_identical_to_sharded_
    driver`` on the port: the codec round trip and the coordinator's
    planners change nothing, scores included."""
    tcfg = _tcfg(**(TIER_KW if tiered else {}))
    data = make_clustered(1600, seed=3)
    tc = _port(tcfg, data[:200], **KW)
    init, pq_init, keys = jax_draws(tcfg, 200)
    drv = make_index("ubis-sharded", tcfg, data[:200], device="cpu",
                     kmeans_init=init, pq_init=pq_init, pq_keys=keys, **KW)
    tape_t = _interleaving(tc, data[200:], 11, tiered=tiered)
    tape_d = _interleaving(drv, data[200:], 11, tiered=tiered)
    _assert_tapes_close(tape_d, tape_t, exact_scores=True)
    st, sd = _np_snap(tc.snapshot()), _np_snap(drv.snapshot())
    for k in sd:
        np.testing.assert_array_equal(st[k], sd[k], err_msg=k)
    assert (protocol.live_multiset_digest(st)
            == protocol.live_multiset_digest(sd))
    for key in ("inserted", "deleted", "tier_spilled", "tier_promoted"):
        assert float(tc.stats[key]) == float(drv.stats[key]), key
    if tiered:
        assert tc.stats["tier_spilled"] > 0
        assert tc.obs.events("tier_commit")
    tc.close()


def test_w1_matches_jax_coordinator():
    data = make_clustered(1600, seed=3)
    jc = JCoordinator(_cfg(), data[:200], workers=1, backend="local", **KW)
    tc = _port(_tcfg(), data[:200], **KW)
    _assert_tapes_close(_interleaving(jc, data[200:], 11),
                        _interleaving(tc, data[200:], 11))
    st, sj = _np_snap(tc.snapshot()), _np_snap(jc.snapshot())
    assert_states_match(st, sj)
    assert (protocol.live_multiset_digest(st)
            == jprotocol.live_multiset_digest(jc.snapshot()))
    for key in ("inserted", "deleted", "rejected", "bg_ops", "bg_gc",
                "host_cached", "drained"):
        assert float(tc.stats[key]) == float(jc.stats[key]), key
    jc.close()
    tc.close()


def _zipf_data():
    """The stream of ``tests/test_cluster.py::
    test_two_workers_stay_occupancy_balanced_on_zipf_stream``."""
    rng = np.random.default_rng(31)
    cents = rng.normal(size=(20, 16)) * 5.0
    ranks = np.arange(1, 21, dtype=np.float64)
    pz = (1.0 / ranks ** 1.2)
    pz /= pz.sum()
    a = rng.choice(20, size=1200, p=pz)
    return (cents[a] + rng.normal(size=(1200, 16))).astype(np.float32)


def _zipf_run(idx, data):
    """Ten batches of 100 inserts, each with a tick (the routing splits
    each batch 50/50, ids ``b * 100 + [0, 50)`` to worker 0), then the
    deletes of 40 of worker 0's ids in six batches and four ticks, which
    the spread balance answers."""
    tape = []
    for b in range(10):
        r = idx.insert(data[b * 100:(b + 1) * 100],
                       np.arange(b * 100, (b + 1) * 100))
        t = idx.tick()
        tape.append((r.accepted, r.cached, r.rejected, t.executed,
                     t.migrated))
    gone = np.concatenate([b * 100 + np.arange(40) for b in range(6)])
    tape.append(idx.delete(gone).deleted)
    for _ in range(4):
        t = idx.tick()
        tape.append((t.executed, t.migrated))
    res = idx.search(data[::37], 8)
    return tape, res


def test_w2_zipf_matches_jax_coordinator():
    data = _zipf_data()
    kw = dict(round_size=128, spread_per_tick=64, seed=0)
    jc = JCoordinator(_cfg(), data[:200], workers=2, backend="local", **kw)
    tc = _port(_tcfg(), data[:200], workers=2, **kw)
    tape_j, res_j = _zipf_run(jc, data)
    tape_t, res_t = _zipf_run(tc, data)
    assert tape_t == tape_j
    np.testing.assert_array_equal(res_t.ids, res_j.ids)
    np.testing.assert_allclose(res_t.scores, res_j.scores, **SCORE_TOL)
    np.testing.assert_array_equal(tc.worker_live(), jc.worker_live())
    live = tc.worker_live()
    assert live.max() / live.min() <= 1.5 and tc.live_count() == 760
    spread = [e for e in tc.obs.events("rebalance")
              if e["trigger"] == "worker-spread"]
    assert spread and tc.stats["migrated"] == jc.stats["migrated"] > 0
    ts, js = tc.snapshot(), jc.snapshot()
    assert ts.digests == js.digests
    for a, b in zip(ts.states, js.states):
        assert_states_match(_np_snap(a), _np_snap(b))
    jc.close()
    tc.close()


# ------------------------------------------------------ failure plane


def test_straggler_rpc_fires_worker_slow_event():
    obs = Obs()
    coord = ClusterCoordinator(_tcfg(), make_clustered(300, seed=5),
                               workers=1, round_size=128, obs=obs,
                               device="cpu")
    coord.backend.monitors[0] = StragglerMonitor()
    for _ in range(6):
        coord.backend.call(0, "ping", {})
    coord.backend.call(0, "sleep", {"seconds": 0.25})
    slow = obs.events("worker_slow")
    assert slow and slow[-1]["command"] == "sleep"
    assert slow[-1]["seconds"] >= 0.25
    coord.close()


def test_worker_kill_recovers_via_journal_replay():
    data = make_clustered(900, seed=7)
    obs = Obs()
    coord = ClusterCoordinator(_tcfg(), data[:200], workers=1,
                               round_size=128, obs=obs, device="cpu")
    coord.insert(data[200:500], np.arange(300))
    coord.delete(np.arange(40))
    coord.tick()
    before = protocol.live_multiset_digest(coord.snapshot())
    live_before = coord.live_count()
    coord.backend.kill_worker(0)
    with pytest.raises(WorkerLost):
        coord.backend.call(0, "ping", {})
    assert coord.live_count() == live_before
    assert protocol.live_multiset_digest(coord.snapshot()) == before
    assert obs.events("worker_lost")
    restarts = obs.events("worker_restarted")
    assert restarts and restarts[-1]["replayed"] > 0
    assert not restarts[-1]["from_checkpoint"]
    coord.close()


def test_checkpoint_then_kill_replays_from_the_checkpoint(tmp_path):
    data = make_clustered(900, seed=9)
    obs = Obs()
    coord = ClusterCoordinator(_tcfg(), data[:200], workers=1,
                               round_size=128, obs=obs, device="cpu")
    coord.insert(data[200:500], np.arange(300))
    coord.flush()
    manifest = coord.checkpoint(str(tmp_path / "ck"))
    assert manifest["n_workers"] == 1
    coord.delete(np.arange(25))
    digest = protocol.live_multiset_digest(coord.snapshot())
    coord.backend.kill_worker(0)
    assert protocol.live_multiset_digest(coord.snapshot()) == digest
    restart = obs.events("worker_restarted")[-1]
    assert restart["from_checkpoint"] and restart["replayed"] > 0
    coord2 = ClusterCoordinator(_tcfg(), data[:200], workers=1,
                                round_size=128, device="cpu")
    coord2.restore(str(tmp_path / "ck"))
    assert (protocol.live_multiset_digest(coord2.snapshot())
            == manifest["combined_digest"])
    coord.close()
    coord2.close()


def test_partial_or_corrupt_checkpoint_fails_loudly(tmp_path):
    data = make_clustered(600, seed=13)
    coord = ClusterCoordinator(_tcfg(), data[:200], workers=1,
                               round_size=128, device="cpu")
    coord.insert(data[200:400], np.arange(200))
    ck = str(tmp_path / "ck")
    coord.checkpoint(ck)
    coord.close()
    with pytest.raises(ClusterManifestError, match="manifest"):
        load_cluster_checkpoint(str(tmp_path / "empty"))
    broken = str(tmp_path / "broken")
    shutil.copytree(ck, broken)
    os.remove(os.path.join(broken, "worker_000.npz"))
    with pytest.raises(ClusterManifestError, match="missing"):
        load_cluster_checkpoint(broken)

    def edited(name, fn):
        path = str(tmp_path / name)
        shutil.copytree(ck, path)
        mp = os.path.join(path, "manifest.json")
        with open(mp) as f:
            m = json.load(f)
        fn(m)
        with open(mp, "w") as f:
            json.dump(m, f)
        return path

    tampered = edited("tampered", lambda m: m["digests"].__setitem__(
        0, (m["digests"][0] + 1) & 0xFFFFFFFFFFFFFFFF))
    with pytest.raises(ClusterManifestError, match="digest mismatch"):
        load_cluster_checkpoint(tampered)
    foreign = edited("foreign", lambda m: m.__setitem__(
        "schema_version", m["schema_version"] + 1))
    with pytest.raises(ClusterManifestError, match="schema"):
        load_cluster_checkpoint(foreign)
    with pytest.raises(ClusterManifestError, match="workers"):
        load_cluster_checkpoint(ck, expect_workers=2)
    # a swapped shard file: the vectors differ, the digest catches it
    swapped = str(tmp_path / "swapped")
    shutil.copytree(ck, swapped)
    path = os.path.join(swapped, "worker_000.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["vectors"] = arrays["vectors"] + np.float32(1)
    np.savez(path, **arrays)
    with pytest.raises(ClusterManifestError, match="digest mismatch"):
        load_cluster_checkpoint(swapped)


# --------------------------------------------------- across frameworks


def test_cluster_checkpoints_cross_load_both_ways(tmp_path):
    data = make_clustered(900, seed=17)
    tcfg = _tcfg()
    tc = _port(tcfg, data[:200], round_size=128)
    jc = JCoordinator(_cfg(), data[:200], workers=1, backend="local",
                      round_size=128)
    for c in (tc, jc):
        c.insert(data[200:600], np.arange(400))
        c.delete(np.arange(0, 400, 5))
        c.flush()
    q = data[600:640]
    # the port's checkpoint in the JAX package
    m_t = tc.checkpoint(str(tmp_path / "port"))
    payloads, manifest = j_load_cluster_checkpoint(str(tmp_path / "port"),
                                                   expect_workers=1)
    assert manifest["combined_digest"] == m_t["combined_digest"]
    jc2 = JCoordinator(_cfg(), data[:200], workers=1, backend="local",
                       round_size=128)
    jc2.restore(str(tmp_path / "port"))
    assert (jprotocol.live_multiset_digest(jc2.snapshot())
            == m_t["combined_digest"])
    r_t, r_j = tc.search(q, 8), jc2.search(q, 8)
    np.testing.assert_array_equal(r_t.ids, r_j.ids)
    np.testing.assert_allclose(r_t.scores, r_j.scores, **SCORE_TOL)
    # the JAX package's checkpoint in the port
    m_j = jc.checkpoint(str(tmp_path / "jax"))
    tc2 = _port(tcfg, data[:200], round_size=128)
    tc2.restore(str(tmp_path / "jax"))
    assert (protocol.live_multiset_digest(tc2.snapshot())
            == m_j["combined_digest"])
    r_t, r_j = tc2.search(q, 8), jc.search(q, 8)
    np.testing.assert_array_equal(r_t.ids, r_j.ids)
    np.testing.assert_allclose(r_t.scores, r_j.scores, **SCORE_TOL)
    for c in (tc, jc, jc2, tc2):
        c.close()


# ------------------------------------------------- the multiprocess plane


def test_multiprocess_equals_local_and_imports_no_jax():
    data = make_clustered(1600, seed=21)
    kw = dict(round_size=128, seed=0, insert_retries=2,
              spread_per_tick=64)
    a = _port(_tcfg(), data[:200], workers=2, backend="local", **kw)
    b = _port(_tcfg(), data[:200], workers=2, backend="multiprocess", **kw)
    try:
        for w in range(2):
            mods = b.backend.call(w, "modules", {})["modules"]
            assert "repro_torch" in mods and "torch" in mods
            assert not {"jax", "jaxlib", "repro"} & set(mods), mods
        tape_a = _interleaving(a, data[200:], 17)
        tape_b = _interleaving(b, data[200:], 17)
        _assert_tapes_close(tape_a, tape_b, exact_scores=True)
        sa, sb = a.snapshot(), b.snapshot()
        assert sa.digests == sb.digests
        np.testing.assert_array_equal(a.worker_live(), b.worker_live())
    finally:
        a.close()
        b.close()


def test_multiprocess_worker_kill_midstream_preserves_multiset():
    data = make_clustered(1400, seed=23)
    obs = Obs()
    coord = _port(_tcfg(), data[:200], workers=2, backend="multiprocess",
                  obs=obs, round_size=128, spread_per_tick=64, seed=0)
    try:
        coord.insert(data[200:700], np.arange(500))
        coord.flush()
        before = coord.snapshot()
        pid = coord.backend.pid(0)
        coord.backend.kill_worker(0)          # SIGKILL between commands
        after = coord.snapshot()              # triggers recovery
        assert after.digest == before.digest
        assert coord.backend.pid(0) != pid
        assert obs.events("worker_lost")
        restarts = obs.events("worker_restarted")
        assert restarts and restarts[-1]["replayed"] > 0
        q = data[300:320]
        found = coord.search(q, 8).ids
        true = coord.exact(q, 8).ids
        hits = sum(len(set(map(int, f)) & set(map(int, t)))
                   for f, t in zip(found, true))
        assert hits / true.size >= 0.9
    finally:
        coord.close()


# --------------------------------- the tier pieces under the cluster plane


def _tiered_stream(engine, make, **kw):
    """A tiered index over a spilled stream: 1,200 integer-valued vectors
    (exact sums), flushed, 6 postings forced out, one more tick."""
    rng = np.random.default_rng(2)
    cents = rng.normal(size=(8, 16)) * 6
    data = np.round(cents[rng.integers(0, 8, 1200)]
                    + rng.normal(size=(1200, 16))).astype(np.float32)
    d = make(data[:300], round_size=256, bg_ops_per_round=8,
             tier_rerank_host=False, **kw)
    d.insert(data, np.arange(1200))
    d.flush(max_ticks=60)
    d.force_spill(6)
    d.tick()
    return d, data[:24]


TIER_CFG = dict(dim=16, max_postings=128, capacity=96, l_min=10, l_max=80,
                nprobe=128, max_ids=1 << 13, use_pq=True, pq_m=4,
                pq_ksub=16, rerank_k=256, use_tier=True, tier_hot_max=8)


def test_tier_rerank_host_off_and_commit_log_match_jax_driver():
    """``tier_rerank_host=False`` (the ADC-only cold read) and the tier's
    commit log on the single-device driver, against the JAX driver: the
    same search ids and scores (spilled candidates keep their ADC
    scores, no host rerank), the same drained commits."""
    from repro.core import UBISDriver as JDriver
    tcfg = UBISConfig(**TIER_CFG)
    init, pq_init, keys = jax_draws(tcfg, 300)
    jd, q = _tiered_stream("ubis", lambda s, **kw: JDriver(
        JConfig(use_pallas="off", **TIER_CFG), s, **kw))
    td, _ = _tiered_stream("ubis", lambda s, **kw: make_index(
        "ubis", tcfg, s, device="cpu", kmeans_init=init, pq_init=pq_init,
        pq_keys=keys, **kw))
    assert td.tier.rerank_host is False and len(td.tier.pool)
    commits = [jd.tier.drain_commits(), td.tier.drain_commits()]
    assert commits[0] == commits[1]
    assert any(c.get("reason") == "forced" for c in commits[1])
    assert td.tier.drain_commits() == []
    rj, rt = jd.search(q, 10), td.search(q, 10)
    np.testing.assert_array_equal(rt.ids, np.asarray(rj.ids))
    np.testing.assert_allclose(rt.scores, np.asarray(rj.scores), **SCORE_TOL)
    assert td.stats["search_spilled_hits"] == 0
    # the log resets with the pool on a restore
    td.tier.commit_log.append({"stale": True})
    td.load_snapshot(td.snapshot())
    assert td.tier.commit_log == []


def test_tier_rerank_host_off_and_commit_log_on_the_sharded_driver():
    """The same on ``ShardedUBISDriver`` (2 shards), on the port alone:
    the JAX package's tiered sharded driver raises jax's
    ``ShardingTypeError`` here (ROADMAP §3).  The search answers what the
    sharded search program answers at k (no widening to ``rerank_k``, no
    rerank), and the commits account one for one for the tier stats."""
    from repro_torch.core.sharded import make_sharded_search
    from repro_torch.distributed import make_mesh
    tcfg = UBISConfig(**TIER_CFG)
    init, pq_init, keys = jax_draws(tcfg, 300)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    td, q = _tiered_stream("ubis-sharded", lambda s, **kw: make_index(
        "ubis-sharded", tcfg, s, device="cpu", mesh=mesh, kmeans_init=init,
        pq_init=pq_init, pq_keys=keys, **kw))
    assert td.tier.rerank_host is False and len(td.tier.pool)
    commits = td.tier.drain_commits()
    assert sum(len(c["spilled"]) for c in commits) == td.stats["tier_spilled"]
    assert (sum(len(c["promoted"]) for c in commits)
            == td.stats["tier_promoted"])
    assert td.tier.drain_commits() == []
    f, s = make_sharded_search(tcfg, mesh, k=10)(td.sharded,
                                                 torch.from_numpy(q))
    r = td.search(q, 10)
    np.testing.assert_array_equal(r.ids, f.numpy())
    np.testing.assert_array_equal(r.scores, s.numpy())
    assert td.stats["search_spilled_hits"] == 0
