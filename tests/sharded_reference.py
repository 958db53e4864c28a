"""The JAX package's sharded plane on 8 fake host devices, mesh (2, 4):
every sharded program on one float and one quant state, two
``ShardedUBISDriver`` streams, and one ``ClusterCoordinator`` stream
with two workers of two shards each (``mesh_shape=(1, 2)``: the only
layout in which the coordinator's in-worker rebalance legs run).  Run as a script (``python
tests/sharded_reference.py OUT.npz``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs its programs; ``tests/
test_torch_sharded.py`` runs it once and holds the port to the npz it
writes.  Every input is made here from a seed and saved beside the
outputs, so the port replays the same calls.

Keys: ``{tag}/{field}`` for a state after a program, ``o/{tag}/{name}``
for a program's inputs and outputs, ``o/{run}/stats`` (JSON) for a
driver run; ``cluster{w}/{field}`` for worker w's state after the
cluster stream.
"""
import dataclasses
import json
import sys

import numpy as np

FLOAT_CFG = dict(dim=16, max_postings=256, capacity=96, max_ids=1 << 14,
                 cache_capacity=1022)
QUANT_CFG = dict(dim=16, max_postings=256, capacity=96, max_ids=1 << 14,
                 use_pq=True, pq_m=4, pq_ksub=32, rerank_k=128)
DRIVER_CFG = dict(dim=16, max_postings=256, capacity=96, max_ids=1 << 14)
DRIVER_KW = dict(round_size=256, bg_ops_per_round=8, gc_lag=4)
STAT_KEYS = ("inserted", "deleted", "rejected", "migrated", "bg_ops",
             "bg_gc", "host_cached", "drained", "queries", "search_results")
#: the cluster stream: two workers, each (1, 2) shards of its 128 postings
CLUSTER_KW = dict(workers=2, mesh_shape=(1, 2), spread_per_tick=256,
                  **DRIVER_KW)


def clustered(seed, n, k=12, scale=5.0, rounded=False):
    """(centres, n vectors of N(centre, I)) from ``seed``."""
    r = np.random.default_rng(seed)
    cents = r.normal(size=(k, 16)) * scale
    x = (cents[r.integers(0, k, n)] + r.normal(size=(n, 16)))
    return cents, (np.round(x) if rounded else x).astype(np.float32)


def churn_stream():
    """(seed vectors, ops, queries): inserts, a flush, deletes, fresh
    inserts, a flush."""
    cents, data = clustered(3, 3000)
    r = np.random.default_rng(4)
    q = (cents[r.integers(0, 12, 48)]
         + r.normal(size=(48, 16))).astype(np.float32)
    ops = [("insert", data[:2000], np.arange(2000)), ("flush", 40),
           ("delete", np.arange(0, 2000, 3)),
           ("insert", data[2000:], np.arange(2000, 3000)), ("flush", 40)]
    return data[:500], ops, q


def zipf_stream():
    """``tests/test_rebalance.py:297``'s Zipf stream: 12 clusters, Zipf
    1.5 popularity, 4000 vectors in batches of 1000, each flushed."""
    r = np.random.default_rng(5)
    K = 12
    cents = r.normal(size=(K, 16)) * 5
    w = 1.0 / (np.arange(K) + 1) ** 1.5

    def draw(n):
        a = r.choice(K, size=n, p=w / w.sum())
        return (cents[a] + r.normal(size=(n, 16))).astype(np.float32)

    data = draw(4000)
    ops = []
    for off in range(0, 4000, 1000):
        ops += [("insert", data[off:off + 1000], np.arange(off, off + 1000)),
                ("flush", 20)]
    ops.append(("flush", 60))
    return data[:400], ops, draw(64)


def cluster_stream():
    """The Zipf stream, then deletes of a third of its ids and a flush:
    the shrunken worker is refilled by the spread balance."""
    seeds, ops, queries = zipf_stream()
    return seeds, ops + [("delete", np.arange(0, 4000, 3)),
                         ("flush", 40)], queries


def rebalance_triggers(obs) -> dict:
    """How many ``rebalance`` events each trigger raised."""
    out: dict = {}
    for e in obs.events("rebalance"):
        out[e["trigger"]] = out.get(e["trigger"], 0) + 1
    return out


def drive(drv, ops):
    for op in ops:
        if op[0] == "insert":
            drv.insert(op[1], op[2])
        elif op[0] == "delete":
            drv.delete(op[1])
        else:
            drv.flush(max_ticks=op[1])


def migrate_jobs(state, pool, B=8):
    """Batch A: three moves off shard 0, a dead donor, a same-shard job,
    a duplicated donor, another move, a padding lane.  Batch B: eight
    more moves, round robin over shards 1-3."""
    status = np.asarray(state["rec_meta"]) & 3
    alloc = np.asarray(state["allocated"])
    lens = np.asarray(state["lengths"])
    live = np.flatnonzero(alloc & (status == 0) & (lens > 0))
    dead = np.flatnonzero(~alloc | (status == 3))
    s0 = live[live < pool]
    assert len(s0) >= 14, len(s0)
    src_a = np.array([s0[0], s0[1], s0[2], dead[0], s0[3], s0[0], s0[4], -1],
                     np.int32)
    dst_a = np.array([1, 2, 3, 2, 0, 2, 3, 0], np.int32)
    valid_a = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    src_b = s0[5:5 + B].astype(np.int32)
    dst_b = (1 + np.arange(B) % 3).astype(np.int32)
    return (src_a, dst_a, valid_a), (src_b, dst_b, np.ones(B, bool))


def main(path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.api import ShardedUBISDriver
    from repro.core import UBISConfig, UBISDriver
    from repro.core.sharded import (index_specs, make_sharded_background,
                                    make_sharded_delete, make_sharded_exact,
                                    make_sharded_insert, make_sharded_migrate,
                                    make_sharded_search)

    out = {}
    mesh = jax.make_mesh((2, 4), ("data", "model"))

    def put(cfg, state):
        sh = jax.tree_util.tree_map(
            lambda sp: NamedSharding(mesh, sp), index_specs(cfg),
            is_leaf=lambda x: isinstance(x, PartitionSpec))
        return jax.device_put(state, sh)

    def save(tag, st):
        host = jax.device_get(st)
        for f in dataclasses.fields(host):
            out[f"{tag}/{f.name}"] = np.asarray(getattr(host, f.name))

    def state_np(st):
        host = jax.device_get(st)
        return {f.name: np.asarray(getattr(host, f.name))
                for f in dataclasses.fields(host)}

    def keep(tag, **arrays):
        for k, v in arrays.items():
            out[f"o/{tag}/{k}"] = np.asarray(v)

    # ---- the float plane: every program in one chain -------------------
    cfg = UBISConfig(use_pallas="off", **FLOAT_CFG)
    cents, data = clustered(1, 3300, rounded=True)
    drv = UBISDriver(cfg, data[:500], round_size=256, bg_ops_per_round=8)
    # no ticks: oversize postings for the background program, and cache
    # entries for the cache scans
    drv.insert(data[:2500], np.arange(2500), tick_between=False)
    st = put(cfg, drv.state)
    save("f0", st)
    r = np.random.default_rng(11)
    q = np.round(cents[r.integers(0, 12, 48)]
                 + r.normal(size=(48, 16))).astype(np.float32)
    keep("in", q=q)
    capped = dataclasses.replace(cfg, shard_probe_cap=4)
    searches = {"search_on": make_sharded_search(cfg, mesh, k=10),
                "search_off": make_sharded_search(cfg, mesh, k=10,
                                                  shard_cache_scan=False),
                "search_cap": make_sharded_search(capped, mesh, k=10)}

    def search_all(tag):
        for name, fn in searches.items():
            f, s = fn(st, jnp.asarray(q))
            keep(f"{tag}_{name}", ids=f, scores=s)

    search_all("f0")
    for i, alpha in enumerate((0.0, 1.0)):
        lo = 2500 + 256 * i
        nv, nid = data[lo:lo + 256], np.arange(lo, lo + 256, dtype=np.int32)
        valid = np.ones(256, bool)
        valid[-16:] = False
        keep(f"ins{i}", vecs=nv, ids=nid, valid=valid)
        st, acc, routed = make_sharded_insert(cfg, mesh, route_alpha=alpha)(
            st, jnp.asarray(nv), jnp.asarray(nid), jnp.asarray(valid))
        keep(f"ins{i}", acc=acc, routed=routed)
        save(f"ins{i}", st)
    il = np.asarray(jax.device_get(st.id_loc))
    posted, cached = np.flatnonzero(il >= 0), np.flatnonzero(il <= -2)
    assert len(cached) >= 10, len(cached)
    dels = np.concatenate([posted[:120:2], cached[:10], posted[:3],
                           [16000]]).astype(np.int32)
    valid = np.ones(128, bool)
    valid[len(dels):] = False
    dels = np.concatenate([dels, np.zeros(128 - len(dels), np.int32)])
    keep("del", ids=dels, valid=valid)
    st, done = make_sharded_delete(cfg, mesh)(st, jnp.asarray(dels),
                                              jnp.asarray(valid))
    keep("del", done=done)
    save("del", st)
    bg = make_sharded_background(cfg, mesh, bg_ops=8)
    for i in range(2):
        # the second round reclaims the first round's retirees
        gc_min = 0 if i == 0 else int(jax.device_get(st.global_version)) + 1
        st, ex, gc, press = bg(st, jnp.uint32(gc_min))
        keep(f"bg{i}", gc_min=gc_min, executed=ex, reclaimed=gc,
             pressure=press)
        save(f"bg{i}", st)
    batches = migrate_jobs(state_np(st), cfg.max_postings // 4)
    mig = make_sharded_migrate(cfg, mesh, jobs=8)
    for i, (src, dst, valid) in enumerate(batches):
        keep(f"mig{i}", src=src, dst=dst, valid=valid)
        st, moved, new_pids = mig(st, jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(valid))
        keep(f"mig{i}", moved=moved, new_pids=new_pids)
        save(f"mig{i}", st)
    search_all("end")
    f, s = make_sharded_exact(cfg, mesh, 10)(st, jnp.asarray(q))
    keep("exact", ids=f, scores=s)

    # ---- the quant plane: search and insert ----------------------------
    qcfg = UBISConfig(use_pallas="off", **QUANT_CFG)
    qcents, qdata = clustered(2, 2800, k=10, scale=6.0, rounded=True)
    qdrv = UBISDriver(qcfg, qdata[:500], round_size=256, bg_ops_per_round=8)
    qdrv.insert(qdata[:2500], np.arange(2500), tick_between=False)
    qst = put(qcfg, qdrv.state)
    save("q0", qst)
    r = np.random.default_rng(12)
    qq = np.round(qcents[r.integers(0, 10, 48)]
                  + r.normal(size=(48, 16))).astype(np.float32)
    keep("qin", q=qq)
    f, s = make_sharded_search(qcfg, mesh, k=10)(qst, jnp.asarray(qq))
    keep("qsearch", ids=f, scores=s)
    nv, nid = qdata[2500:2756], np.arange(2500, 2756, dtype=np.int32)
    qst, acc, routed = make_sharded_insert(qcfg, mesh)(
        qst, jnp.asarray(nv), jnp.asarray(nid), jnp.ones(256, bool))
    keep("qins", vecs=nv, ids=nid, acc=acc, routed=routed)
    save("qins", qst)

    # ---- the driver over two streams -----------------------------------
    dcfg = UBISConfig(use_pallas="off", **DRIVER_CFG)
    first = None
    for name, stream in (("churn", churn_stream), ("zipf", zipf_stream)):
        seeds, ops, queries = stream()
        drv = ShardedUBISDriver(dcfg, seeds, mesh=mesh, **DRIVER_KW)
        if first is not None:
            # the same config, mesh and knobs build the same programs:
            # reuse the first driver's compiled ones
            for attr in ("_insert_fn", "_cache_admit_fn", "_delete_fn",
                         "_background_fn", "_migrate_fn", "_search_fns",
                         "_exact_fns"):
                setattr(drv, attr, getattr(first, attr))
        first = first or drv
        drive(drv, ops)
        save(name, drv.snapshot())
        res = drv.search(queries, 10)
        keep(name, ids=res.ids, scores=res.scores,
             exact=drv.exact(queries, 10).ids, live=drv.live_count(),
             occupancy=drv.shard_occupancy(), pressure=drv.shard_pressure(),
             stats=json.dumps({k: float(drv.stats[k]) for k in STAT_KEYS}))

    # ---- the cluster plane: two workers of two shards ------------------
    from repro.cluster import ClusterCoordinator
    from repro.obs import Obs
    seeds, ops, queries = cluster_stream()
    obs = Obs()
    coord = ClusterCoordinator(dcfg, seeds, obs=obs, **CLUSTER_KW)
    drive(coord, ops)
    snap = coord.snapshot()
    for w, st in enumerate(snap.states):
        save(f"cluster{w}", st)
    res = coord.search(queries, 10)
    keep("cluster", ids=res.ids, scores=res.scores,
         exact=coord.exact(queries, 10).ids, live=coord.worker_live(),
         digests=np.array(snap.digests, np.uint64),
         occupancy=coord.shard_occupancy(),
         triggers=json.dumps(rebalance_triggers(obs)),
         stats=json.dumps({k: float(coord.stats[k]) for k in STAT_KEYS}))
    coord.close()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
