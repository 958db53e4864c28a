"""The port's sharded plane against the JAX package's, on the CPU.

The JAX side runs once per test session: ``tests/sharded_reference.py``
in one subprocess with 8 fake host devices and mesh (2, 4), as
``tests/test_distributed.py`` runs its programs.  From a float state and
a quant state built by the JAX single-device driver it runs every
sharded program, and it drives ``ShardedUBISDriver`` over a churn stream
and over ``tests/test_rebalance.py:297``'s Zipf stream; one npz holds the
inputs, the outputs and the states (pytest-xdist workers share it).

It also drives a two-worker ``ClusterCoordinator`` with two shards a
worker (``mesh_shape=(1, 2)``), the layout in which the coordinator's
in-worker rebalance legs (``plan_inputs``, the migrate round) run.

The port replays the same calls on S = 4 logical shards of the CPU
(``make_mesh((2, 4), ...)``): every program on the same starting state,
each driver with the JAX draws injected (the cluster's one set per
worker).  Ids, masks, ``routed``,
``new_pids``, pressure rows, stats and every integer field are compared
exactly; scores within fp32 tolerance; states field by field through
``bridge.state_to_numpy`` (centroids within ``1e-4 * scale``, as in
``tests/test_torch_pq.py``).  The replicas are checked after every
program.  At S = 1 (mesh (1, 1), in process) the port's sharded driver
is held to its single-device driver (``tests/test_api.py:132``) and to
the JAX sharded driver.  The planner runs ``tests/test_rebalance.py:44``
and ``tests/test_obs.py:190`` on the port's copy, and the migration of
spilled postings (``tests/test_rebalance.py:353-405``) runs on the port
alone.
"""
import dataclasses
import fcntl
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import sharded_reference as reference
from repro_torch import bridge
from repro_torch.api import make_index
from repro_torch.api.rebalance import RebalancePlanner
from repro_torch.core import metrics, sharded
from repro_torch.core.invariants import check_invariants
from repro_torch.core.types import UBISConfig
from repro_torch.distributed import (all_gather, default_mesh, make_mesh,
                                     pmax, psum)
from test_torch_pq import assert_states_match, jax_draws

ROOT = Path(__file__).resolve().parent.parent
SCORE_TOL = dict(rtol=1e-5, atol=1e-3)      # fp32, scores ~1e2-1e3


def _run_reference(path: Path) -> None:
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="2")
    part = path.with_name(path.stem + ".part.npz")
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "sharded_reference.py"),
                        str(part)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, f"STDOUT:{r.stdout}\nSTDERR:{r.stderr[-3000:]}"
    os.replace(part, path)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX reference's arrays, computed once per session: under
    pytest-xdist the workers share one file behind a lock."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / "sharded_reference.npz"
    with open(base / "sharded_reference.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            _run_reference(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _mesh(S=4, data=2):
    return make_mesh((data, S), ("data", "model"), device="cpu")


def _state(ref, tag, cfg):
    return bridge.state_from_numpy(
        {f: ref[f"{tag}/{f}"] for f in bridge.FIELDS}, cfg, "cpu")


def _np_state(state) -> dict:
    return {k: v.copy() for k, v in bridge.state_to_numpy(state).items()}


def _want(ref, tag) -> dict:
    return {f: ref[f"{tag}/{f}"] for f in bridge.FIELDS}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# program level, S = 4: the float chain and the quant plane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def float_chain(ref):
    """The reference's chain of float programs replayed on the port:
    tag -> outputs, the state after the program (numpy) and the replica
    check's outcome."""
    cfg = UBISConfig(**reference.FLOAT_CFG)
    mesh = _mesh()
    sh = sharded.ShardedState(_state(ref, "f0", cfg), mesh)
    q = _t(ref["o/in/q"])
    out = {}

    def record(tag, **outputs):
        try:
            sharded.check_replicas(sh)
            rep = None
        except AssertionError as e:
            rep = str(e)
        out[tag] = dict(outputs, state=_np_state(sh.state), replicas=rep)

    capped = dataclasses.replace(cfg, shard_probe_cap=4)
    searches = {"search_on": sharded.make_sharded_search(cfg, mesh, k=10),
                "search_off": sharded.make_sharded_search(
                    cfg, mesh, k=10, shard_cache_scan=False),
                "search_cap": sharded.make_sharded_search(capped, mesh, k=10)}

    def search_all(tag):
        for name, fn in searches.items():
            f, s = fn(sh, q)
            out[f"{tag}_{name}"] = dict(ids=f.numpy(), scores=s.numpy())

    search_all("f0")
    for i, alpha in enumerate((0.0, 1.0)):
        t = f"ins{i}"
        _, acc, routed = sharded.make_sharded_insert(
            cfg, mesh, route_alpha=alpha)(sh, _t(ref[f"o/{t}/vecs"]),
                                          _t(ref[f"o/{t}/ids"]),
                                          _t(ref[f"o/{t}/valid"]))
        record(t, acc=acc.numpy(), routed=routed.numpy())
    _, done = sharded.make_sharded_delete(cfg, mesh)(
        sh, _t(ref["o/del/ids"]), _t(ref["o/del/valid"]))
    record("del", done=done.numpy())
    bg = sharded.make_sharded_background(cfg, mesh, bg_ops=8)
    for i in range(2):
        _, ex, gc, press = bg(sh, int(ref[f"o/bg{i}/gc_min"]))
        record(f"bg{i}", executed=int(ex), reclaimed=int(gc),
               pressure=press.numpy())
    mig = sharded.make_sharded_migrate(cfg, mesh, jobs=8)
    for i in range(2):
        t = f"mig{i}"
        _, moved, new_pids = mig(sh, _t(ref[f"o/{t}/src"]),
                                 _t(ref[f"o/{t}/dst"]),
                                 _t(ref[f"o/{t}/valid"]))
        record(t, moved=moved.numpy(), new_pids=new_pids.numpy())
    search_all("end")
    f, s = sharded.make_sharded_exact(cfg, mesh, 10)(sh, q)
    out["exact"] = dict(ids=f.numpy(), scores=s.numpy())
    return out


def _check_step(ref, got, tag, exact=()):
    assert got["replicas"] is None, got["replicas"]
    for name in exact:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      ref[f"o/{tag}/{name}"], err_msg=name)
    assert_states_match(got["state"], _want(ref, tag))


@pytest.mark.parametrize("name", ["search_on", "search_off", "search_cap"])
@pytest.mark.parametrize("when", ["f0", "end"])
def test_sharded_search_matches_jax(ref, float_chain, when, name):
    """Phase 1 per shard, the global re-rank, phase 2 under the
    ownership mask, the cache slice (or shard 0's whole cache), the
    merge: the ids exactly, the scores within fp32 tolerance.  ``end``
    searches the state after the two migrate rounds, with postings on
    every shard."""
    got, tag = float_chain[f"{when}_{name}"], f"{when}_{name}"
    np.testing.assert_array_equal(got["ids"], ref[f"o/{tag}/ids"])
    np.testing.assert_allclose(got["scores"], ref[f"o/{tag}/scores"],
                               **SCORE_TOL)
    assert (got["ids"] >= 0).sum() > 0


@pytest.mark.parametrize("i", [0, 1])
def test_sharded_insert_matches_jax(ref, float_chain, i):
    """``route_alpha`` 0 and 1: the accepted mask and the routed global
    pids exactly, the state after the round field by field."""
    _check_step(ref, float_chain[f"ins{i}"], f"ins{i}", ("acc", "routed"))
    assert float_chain[f"ins{i}"]["acc"].any()


def test_sharded_delete_matches_jax(ref, float_chain):
    """Posting-resident ids, cached ids, duplicates, an absent id and
    padding lanes: the done mask and the state."""
    got = float_chain["del"]
    _check_step(ref, got, "del", ("done",))
    assert got["done"].sum() >= 60


@pytest.mark.parametrize("i", [0, 1])
def test_sharded_background_matches_jax(ref, float_chain, i):
    """Two background programs, the second with epoch GC of the first's
    retirees: executed, reclaimed, the pressure rows and the state (the
    localized successors rebased back, the id-map deltas merged, the
    EMPTY free stack)."""
    got = float_chain[f"bg{i}"]
    _check_step(ref, got, f"bg{i}", ("executed", "reclaimed", "pressure"))
    assert got["executed"] > 0 if i == 0 else got["reclaimed"] > 0
    assert int(got["state"]["free_top"]) == 0


@pytest.mark.parametrize("i", [0, 1])
def test_sharded_migrate_matches_jax(ref, float_chain, i):
    """Batch 0 holds a dead donor, a same-shard job, a duplicate and a
    padding lane; batch 1 eight moves over shards 1-3: the committed mask,
    the landing pids and the state."""
    got = float_chain[f"mig{i}"]
    _check_step(ref, got, f"mig{i}", ("moved", "new_pids"))
    moved = got["moved"]
    if i == 0:
        assert moved[[0, 1, 2, 6]].all() and not moved[[3, 4, 5, 7]].any()
    else:
        assert moved.all()
    landed = got["new_pids"][moved] // 64
    assert (landed == ref[f"o/mig{i}/dst"][moved]).all()


def test_sharded_exact_matches_jax(ref, float_chain):
    got = float_chain["exact"]
    np.testing.assert_array_equal(got["ids"], ref["o/exact/ids"])
    np.testing.assert_allclose(got["scores"], ref["o/exact/scores"],
                               **SCORE_TOL)


@pytest.fixture(scope="module")
def quant_chain(ref):
    cfg = UBISConfig(**reference.QUANT_CFG)
    mesh = _mesh()
    sh = sharded.ShardedState(_state(ref, "q0", cfg), mesh)
    f, s = sharded.make_sharded_search(cfg, mesh, k=10)(sh, _t(ref["o/qin/q"]))
    out = {"search": dict(ids=f.numpy(), scores=s.numpy())}
    _, acc, routed = sharded.make_sharded_insert(cfg, mesh)(
        sh, _t(ref["o/qins/vecs"]), _t(ref["o/qins/ids"]),
        torch.ones(256, dtype=torch.bool))
    sharded.check_replicas(sh)
    out["insert"] = dict(acc=acc.numpy(), routed=routed.numpy(),
                         state=_np_state(sh.state), replicas=None)
    return out, cfg


def test_sharded_quant_search_matches_jax(ref, quant_chain):
    """The quant plane's phase 2 per shard (``pq_scan_topk`` under the
    ownership mask, ``rerank_topk``): ids exactly, scores in tolerance."""
    got = quant_chain[0]["search"]
    np.testing.assert_array_equal(got["ids"], ref["o/qsearch/ids"])
    np.testing.assert_allclose(got["scores"], ref["o/qsearch/scores"],
                               **SCORE_TOL)


def test_sharded_quant_insert_matches_jax(ref, quant_chain):
    """The sharded insert on the quant plane: every append carries its
    code under the target posting's codebook slot."""
    out, cfg = quant_chain
    _check_step(ref, out["insert"], "qins", ("acc", "routed"))
    check_invariants(bridge.state_from_numpy(out["insert"]["state"], cfg,
                                             "cpu"), cfg)


# ---------------------------------------------------------------------------
# the driver, S = 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["churn", "zipf"])
def test_sharded_driver_matches_jax(ref, name):
    """``ShardedUBISDriver`` over a stream, both packages, the JAX draws
    injected: the stats (migrations included), the snapshot field by
    field, the search and exact ids, the occupancy and pressure rows."""
    seeds, ops, queries = getattr(reference, f"{name}_stream")()
    cfg = UBISConfig(**reference.DRIVER_CFG)
    init, _, _ = jax_draws(cfg, len(seeds))
    drv = make_index("ubis-sharded", cfg, seeds, mesh=_mesh(),
                     kmeans_init=init, **reference.DRIVER_KW)
    reference.drive(drv, ops)
    drv.check_replicas()
    want = json.loads(str(ref[f"o/{name}/stats"]))
    got = {k: float(drv.stats[k]) for k in reference.STAT_KEYS
           if k not in ("queries", "search_results")}
    assert got == {k: v for k, v in want.items() if k in got}
    assert got["migrated"] > 0
    snap = drv.snapshot()
    assert_states_match(_np_state(snap), _want(ref, name))
    check_invariants(snap, cfg)
    res = drv.search(queries, 10)
    np.testing.assert_array_equal(res.ids, ref[f"o/{name}/ids"])
    np.testing.assert_allclose(res.scores, ref[f"o/{name}/scores"],
                               **SCORE_TOL)
    np.testing.assert_array_equal(drv.exact(queries, 10).ids,
                                  ref[f"o/{name}/exact"])
    assert drv.live_count() == int(ref[f"o/{name}/live"])
    np.testing.assert_array_equal(drv.shard_occupancy(),
                                  ref[f"o/{name}/occupancy"])
    np.testing.assert_array_equal(drv.shard_pressure(),
                                  ref[f"o/{name}/pressure"])


def test_cluster_two_workers_two_shards_matches_jax(ref):
    """The port's coordinator over two workers of two logical shards each,
    the JAX draws injected per worker, against the JAX coordinator on
    fake devices: the stats, both rebalance planes' triggers (in-worker
    ``spread`` and cross-worker ``worker-spread``), each worker's live
    count, digest and snapshot field by field, the merged search and
    ``exact`` ids and the per-shard occupancy."""
    from repro_torch.cluster import ClusterCoordinator
    from repro_torch.obs import Obs
    seeds, ops, queries = reference.cluster_stream()
    cfg = UBISConfig(**reference.DRIVER_CFG)
    W = reference.CLUSTER_KW["workers"]
    wcfg = dataclasses.replace(cfg, max_postings=cfg.max_postings // W,
                               nprobe=min(cfg.nprobe, cfg.max_postings // W))
    inits = [jax_draws(wcfg, len(seeds[w::W]))[0] for w in range(W)]
    obs = Obs()
    coord = ClusterCoordinator(cfg, seeds, device="cpu", obs=obs,
                               kmeans_init=inits, **reference.CLUSTER_KW)
    reference.drive(coord, ops)
    want = json.loads(str(ref["o/cluster/stats"]))
    got = {k: float(coord.stats[k]) for k in reference.STAT_KEYS
           if k not in ("queries", "search_results")}
    assert got == {k: v for k, v in want.items() if k in got}
    triggers = reference.rebalance_triggers(obs)
    assert triggers == json.loads(str(ref["o/cluster/triggers"]))
    assert triggers.get("spread", 0) > 0 and triggers["worker-spread"] > 0
    np.testing.assert_array_equal(coord.worker_live(), ref["o/cluster/live"])
    snap = coord.snapshot()
    np.testing.assert_array_equal(np.array(snap.digests, np.uint64),
                                  ref["o/cluster/digests"])
    for w, st in enumerate(snap.states):
        assert_states_match(_np_state(st), _want(ref, f"cluster{w}"))
        check_invariants(st, wcfg)
    res = coord.search(queries, 10)
    np.testing.assert_array_equal(res.ids, ref["o/cluster/ids"])
    np.testing.assert_allclose(res.scores, ref["o/cluster/scores"],
                               **SCORE_TOL)
    np.testing.assert_array_equal(coord.exact(queries, 10).ids,
                                  ref["o/cluster/exact"])
    np.testing.assert_array_equal(coord.shard_occupancy(),
                                  ref["o/cluster/occupancy"])
    coord.close()


# ---------------------------------------------------------------------------
# S = 1, in process
# ---------------------------------------------------------------------------

def _live(state) -> dict:
    from test_api import _live_map
    return _live_map(types.SimpleNamespace(**bridge.state_to_numpy(state)),
                     None)


@pytest.mark.parametrize("seed", [0, 3])
def test_one_shard_matches_single_device(seed):
    """``tests/test_api.py:132``'s property on the port: ubis-sharded on
    a 1-shard mesh ends ``_churn`` with the single-device driver's live
    id -> vector multiset and (probing every posting) its search."""
    from conftest import make_clustered
    from test_api import _churn
    cfg = UBISConfig(dim=16, max_postings=128, capacity=96, l_min=10,
                     l_max=80, nprobe=128, max_ids=1 << 13)
    data = make_clustered(2200, d=16, k=10, seed=30 + seed)
    init, _, _ = jax_draws(cfg, 500, seed=seed)
    kw = dict(round_size=256, bg_ops_per_round=8, seed=seed, device="cpu",
              kmeans_init=init)
    single = make_index("ubis", cfg, data[:500], **kw)
    shard1 = make_index("ubis-sharded", cfg, data[:500], **kw)
    assert shard1.n_shards == 1
    assert _churn(single, data, seed) == _churn(shard1, data, seed)
    assert _live(single.state) == _live(shard1.snapshot())
    q = make_clustered(48, d=16, k=10, seed=99)
    rs, rd = single.search(q, 10), shard1.search(q, 10)
    np.testing.assert_allclose(rs.scores, rd.scores, rtol=1e-4, atol=1e-4)
    for row_s, row_d in zip(rs.ids, rd.ids):
        assert set(row_s.tolist()) == set(row_d.tolist())


def test_one_shard_matches_jax_sharded_driver():
    """At S = 1 the port's sharded driver against the JAX package's
    (mesh (1, 1), in process) over ``_churn``: the stats, the snapshot
    field by field, the search ids."""
    import jax
    from conftest import make_clustered
    from repro.api import make_index as j_make_index
    from repro.core import UBISConfig as JConfig
    from test_api import _churn
    kw = dict(dim=16, max_postings=128, capacity=96, l_min=10, l_max=80,
              max_ids=1 << 13)
    cfg = UBISConfig(**kw)
    data = make_clustered(2200, d=16, k=10, seed=31)
    init, _, _ = jax_draws(cfg, 500)
    dkw = dict(round_size=256, bg_ops_per_round=8)
    jd = j_make_index("ubis-sharded", JConfig(use_pallas="off", **kw),
                      data[:500], mesh=jax.make_mesh((1, 1),
                                                     ("data", "model")),
                      **dkw)
    td = make_index("ubis-sharded", cfg, data[:500], device="cpu",
                    kmeans_init=init, mesh=_mesh(S=1, data=1), **dkw)
    assert _churn(jd, data) == _churn(td, data)
    for k in ("inserted", "deleted", "rejected", "bg_ops", "bg_gc",
              "host_cached", "drained"):
        assert float(td.stats[k]) == float(jd.stats[k]), k
    jsnap = jd.snapshot()
    assert_states_match(_np_state(td.snapshot()),
                        {f.name: np.asarray(getattr(jsnap, f.name))
                         for f in dataclasses.fields(jsnap)})
    q = make_clustered(48, d=16, k=10, seed=98)
    np.testing.assert_array_equal(td.search(q, 10).ids, jd.search(q, 10).ids)


# ---------------------------------------------------------------------------
# the mesh, the collectives, the replicas
# ---------------------------------------------------------------------------

def test_mesh_and_collectives():
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_names == ("data", "model")
    assert default_mesh(cfg, "cpu").shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1, 4), ("data", "model"))
    xs = [torch.tensor([[s, 10 + s]]) for s in range(3)]
    assert all_gather(xs, 1).tolist() == [[0, 10, 1, 11, 2, 12]]
    assert psum(xs).tolist() == [[3, 33]] and pmax(xs).tolist() == [[2, 12]]
    f = [torch.zeros(2), torch.tensor([-0.0, 1.5]), torch.zeros(2)]
    assert psum(f).tolist() == [0.0, 1.5]


def test_replica_check_and_local_views():
    """Shard-local states are the shard's own tensors, equal to its rows
    of the global view; a stage that replaces a sharded field is taken
    back; a replica that drifts is caught by ``check_replicas``."""
    from conftest import make_clustered
    cfg = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24,
                     max_ids=1 << 10)
    drv = make_index("ubis-sharded", cfg, make_clustered(200, d=8, seed=5),
                     mesh=_mesh(), device=None)
    sh = drv.sharded
    drv.check_replicas()
    heat = sh.state.heat.clone()
    loc = sh.local(2)
    own = {sh.shards[s].vectors.untyped_storage().data_ptr()
           for s in (1, 2, 3)}
    assert len(own) == 3                    # no shard shares another's
    assert torch.equal(loc.vectors, sh.state.vectors[32:48])
    loc.heat = loc.heat + 5                 # replaced, not written
    sh.store(2, loc)
    assert (sh.state.heat[32:48] == heat[32:48] + 5).all()
    assert (sh.state.heat[:32] == heat[:32]).all()
    assert (sh.state.heat[48:] == heat[48:]).all()
    loc = sh.local(3)
    loc.id_loc[7] = 123
    sh.store(3, loc)
    with pytest.raises(AssertionError, match="id_loc on shard 3"):
        sharded.check_replicas(sh)
    sh.replicate()
    sharded.check_replicas(sh)
    with pytest.raises(ValueError, match="jobs=8"):
        sharded.make_sharded_migrate(cfg, sh.mesh, jobs=8)(
            sh, torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="divide"):
        sharded.ShardedState(sh.state, _mesh(S=5))


def test_rebase_succ_keeps_no_succ():
    from repro_torch.core import version_manager as vm
    from repro_torch.core.types import NO_SUCC
    words = vm.pack_succ(torch.tensor([NO_SUCC, 70, 3, 130]),
                         torch.tensor([NO_SUCC, NO_SUCC, 64, 65]))
    local = sharded._rebase_succ(words, -64, 64)
    s1, s2 = vm.succ_ids(local)
    assert s1.tolist() == [-1, 6, -1, -1] and s2.tolist() == [-1, -1, 0, 1]
    back = sharded._rebase_succ(local, 64, 256)
    assert vm.succ_ids(back)[0].tolist() == [-1, 70, -1, -1]
    assert (back[0] == (NO_SUCC << 16 | NO_SUCC)).item()


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test", [
    "test_rebalance.test_planner_vector_mode_cannot_ping_pong",
    "test_obs.test_rebalance_planner_records_move_triggers"])
def test_planner_reference_tests_on_the_port(test, monkeypatch):
    """The reference's planner tests, run with the port's planner in
    place of the JAX package's."""
    import importlib
    import repro.api.rebalance as jrebalance
    mod, fn = test.split(".")
    monkeypatch.setattr(jrebalance, "RebalancePlanner", RebalancePlanner)
    getattr(importlib.import_module(mod), fn)()


def test_planner_matches_jax_on_random_pressure():
    from repro.api.rebalance import RebalancePlanner as JPlanner
    rng = np.random.default_rng(0)
    for trial in range(40):
        S, pool = int(rng.integers(2, 6)), 32
        lengths = rng.integers(0, 90, S * pool).astype(np.int32)
        movable = rng.random(S * pool) < 0.6
        live = np.array([movable[s * pool:(s + 1) * pool].sum()
                         for s in range(S)])
        occ = np.array([lengths[s * pool:(s + 1) * pool][
            movable[s * pool:(s + 1) * pool]].sum() for s in range(S)])
        press = np.stack([live, pool - live, rng.integers(0, 400, S), occ],
                         axis=1)
        kw = dict(watermark=float(rng.choice([0.5, 0.85])), min_gap=80,
                  max_moves=int(rng.integers(1, 9)))
        a, b = RebalancePlanner(S, pool, **kw), JPlanner(S, pool, **kw)
        assert a.needs(press) == b.needs(press)
        pa, pb = a.plan(press, lengths, movable), b.plan(press, lengths,
                                                         movable)
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(x, y)
        assert a.last_moves == b.last_moves


# ---------------------------------------------------------------------------
# the cold tier x rebalance, on the port alone
# ---------------------------------------------------------------------------

def test_migrate_moves_spilled_postings_without_promoting():
    """``tests/test_rebalance.py:353-405``'s assertions on the port: a
    saturated shard full of SPILLED postings still rebalances, the
    migrate round carries codes, heat and ``tier_spilled`` verbatim, and
    the driver remaps the host-pool entries to the landing pids.  The
    reference's own test fails in this repository's runs (a
    ``ShardingTypeError`` on a gather from the sharded pool), so the
    port is held to the assertions alone."""
    from repro_torch.core import version_manager as vm
    cfg = UBISConfig(dim=16, max_postings=256, capacity=96, max_ids=1 << 14,
                     use_pq=True, pq_m=4, pq_ksub=16, rerank_k=256,
                     use_tier=True, tier_hot_max=0)
    r = np.random.default_rng(21)
    cents = r.normal(size=(4, 16)) * 4
    data = (cents[r.integers(0, 4, 3000)]
            + r.normal(size=(3000, 16))).astype(np.float32)
    init, pq_init, keys = jax_draws(cfg, 400)
    drv = make_index("ubis-sharded", cfg, data[:400], mesh=_mesh(),
                     round_size=256, bg_ops_per_round=8, gc_lag=4,
                     rebalance_watermark=0.8, kmeans_init=init,
                     pq_init=pq_init, pq_keys=keys)
    drv.insert(data[:1500], np.arange(1500))
    n_sp = drv.force_spill(10 ** 6)
    assert n_sp > 0, n_sp
    pool_before = set(int(p) for p in drv.tier.pool.pids())
    drv.insert(data[1500:], np.arange(1500, 3000))
    drv.flush(max_ticks=40)
    drv.check_replicas()
    assert drv.stats["migrated"] > 0, drv.stats
    st = drv.state
    sp, alloc = st.tier_spilled.numpy(), st.allocated.numpy()
    status = vm.unpack_status(st.rec_meta).numpy()
    pool_now = set(int(p) for p in drv.tier.pool.pids())
    assert pool_now == set(np.flatnonzero(sp & alloc & (status != 3)))
    assert pool_now != pool_before or not pool_now
    assert drv.live_count() == 3000
    q = data[:32]
    rec = metrics.recall_at_k(drv.search(q, 10).ids, drv.exact(q, 10).ids)
    assert rec >= 0.9, rec
