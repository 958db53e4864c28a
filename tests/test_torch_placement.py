"""The sharded plane's placement on the devices of one process.

Shard s of a ``ShardedState`` lives on ``mesh.devices[s]`` in tensors of
its own (on the CPU every shard is on the CPU, still in storage of its
own); the whole index crosses to and from the controller through
``gather``/``scatter``; ``to_named_sharding`` and ``batch_sharding`` give
the JAX functions' specs leaf for leaf; ``default_mesh`` follows the JAX
rule (``repro/api/sharded_driver.py:79-86``) with one shard a card; a
kernel wrapper given inputs on two devices raises.  JAX is imported only
inside the tests that compare with it.  The tests marked ``cuda`` skip
here: one runs a sharded stream with its shards on two
cards against the same stream on one card (``chip_smoke.py`` phase 3k
runs the full-size check).
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.api import make_index
from repro_torch.checkpoint.manager import restore_pytree, save_pytree
from repro_torch.core import sharded
from repro_torch.core.types import IndexState, UBISConfig
from repro_torch.distributed import (Placement, batch_sharding,
                                     default_mesh, gather, make_mesh,
                                     make_rules, model_shards, place,
                                     to_named_sharding)
from repro_torch.kernels import ops
from repro_torch.models import get_model

CFG = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24,
                 max_ids=1 << 12)


def _clustered(n, d=8, seed=0, k=6):
    r = np.random.default_rng(seed)
    cents = r.normal(size=(k, d)) * 5
    return (cents[r.integers(0, k, n)] + r.normal(size=(n, d))).astype(
        np.float32)


def _driver(S=4, cfg=CFG, **kw):
    data = _clustered(1200, cfg.dim, seed=3)
    drv = make_index("ubis-sharded", cfg, data[:200], round_size=128,
                     bg_ops_per_round=8,
                     mesh=make_mesh((1, S), ("data", "model"), device="cpu"),
                     **kw)
    return drv, data


def _storages(sh):
    """(shard, field) -> its storage's address, every shard's fields."""
    return {(s, f): getattr(st, f).untyped_storage().data_ptr()
            for s, st in enumerate(sh.shards) for f in sharded.FIELDS
            if getattr(st, f).numel()}


# ---------------------------------------------------------------------------
# each shard owns its storage
# ---------------------------------------------------------------------------

def test_every_shard_owns_its_storage_through_a_stream():
    """After construction and after every program of a stream (insert,
    delete, tick with rebalance, search, exact, cache drain), no two
    shards share a storage and every tensor is on its shard's device."""
    drv, data = _driver()
    sh = drv.sharded

    def audit():
        sharded.audit_placement(drv.sharded)
        by = _storages(drv.sharded)
        owner = {}
        for (s, f), ptr in by.items():
            assert owner.setdefault(ptr, s) == s, (s, f)

    audit()
    drv.insert(data[:600], np.arange(600))
    audit()
    drv.delete(np.arange(0, 600, 3))
    audit()
    for _ in range(4):
        drv.tick()
        audit()
    drv.search(data[:16], 5)
    drv.exact(data[:16], 5)
    audit()
    drv.check_replicas()
    assert drv.sharded is sh


def test_audit_catches_shared_and_misplaced_storage():
    drv, _ = _driver()
    sh = drv.sharded
    sh.shards[1].heat = sh.shards[0].heat        # two shards, one storage
    with pytest.raises(AssertionError, match="shares storage"):
        sharded.audit_placement(sh)
    loc = sh.local(2)
    loc.heat = torch.empty(loc.heat.shape, dtype=loc.heat.dtype,
                           device="meta")
    with pytest.raises(ValueError, match="not on its own device"):
        sh.store(2, loc)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_gather_scatter_round_trip_bit_for_bit(S):
    drv, data = _driver(S=4)
    drv.insert(data[:500], np.arange(500))
    drv.tick()
    whole = drv.snapshot()
    want = {k: v.copy() for k, v in bridge.state_to_numpy(whole).items()}
    sh = sharded.ShardedState(whole, make_mesh((1, S), ("data", "model"),
                                               device="cpu"))
    got = bridge.state_to_numpy(sh.gather())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # scatter a changed index back: every shard's rows and replicas follow
    changed = sh.gather()
    changed.heat = changed.heat + torch.arange(changed.heat.shape[0])
    changed.id_loc[3] = 77
    sh.scatter(changed)
    sharded.check_replicas(sh)
    sharded.audit_placement(sh)
    again = bridge.state_to_numpy(sh.gather())
    for k, v in bridge.state_to_numpy(changed).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    for s in range(S):
        assert int(sh.shards[s].id_loc[3]) == 77


def test_global_view_rows_match_the_whole_index():
    """``GlobalView``'s row interface on the owning shards against the
    same interface of the gathered ``IndexState`` (which the cold tier
    calls without telling the two apart)."""
    drv, data = _driver()
    drv.insert(data[:500], np.arange(500))
    view, whole = drv.state, drv.sharded.gather()
    pids = torch.tensor([63, 0, 17, 16, 47, 48, 5])
    for f in ("vectors", "ids", "heat", "tier_spilled"):
        assert torch.equal(view.get_rows(f, pids), getattr(whole, f)[pids])
        assert torch.equal(whole.get_rows(f, pids), getattr(whole, f)[pids])
        for st in (view, whole):
            got = torch.empty_like(getattr(whole, f)[pids])
            for at, rows in st.row_parts(f, pids):
                got[at] = rows
            assert torch.equal(got, getattr(whole, f)[pids])
    assert len(view.row_parts("ids", pids)) == 4
    assert len(whole.row_parts("ids", pids)) == 1
    valid = torch.tensor([True, False, True, True, False, True, True])
    tiles = torch.randn((7,) + tuple(whole.vectors.shape[1:]))
    for st in (view, whole):
        st.set_rows("vectors", pids, tiles, valid)
        st.set_rows("heat", pids, 9, valid)
    assert torch.equal(view.vectors, whole.vectors)
    assert torch.equal(view.heat, whole.heat)
    with pytest.raises(IndexError):
        view.get_rows("heat", torch.tensor([64]))
    with pytest.raises(AttributeError):
        view.not_a_field = 1


def _mask_write(view):
    from repro_torch.core.version_manager import masked_set_
    masked_set_(view.vectors, torch.tensor([1]), 0, torch.tensor([True]))


WRITES = {
    "setitem": lambda v: v.heat.__setitem__(3, 0),
    "in_place_method": lambda v: v.heat.zero_(),
    "view_of_the_copy": lambda v: v.heat[:4].fill_(1),
    "reshaped_copy": lambda v: v.vectors.view(-1).add_(1),
    "augmented": lambda v: v.lengths.__iadd__(1),
    "out_argument": lambda v: torch.add(v.heat, 1, out=v.heat),
    "masked_set": _mask_write,
}


@pytest.mark.parametrize("how", sorted(WRITES))
def test_global_view_refuses_writes_it_cannot_honour(how):
    """A sharded field read through the view is a gathered copy: a write
    into it (or into a view of it) raises instead of being lost.  What is
    computed from it is an ordinary tensor, and a replicated field is
    shard 0's own replica, so a write into it lands."""
    drv, data = _driver()
    drv.insert(data[:300], np.arange(300))
    view = drv.state
    before = drv.sharded.gather()
    with pytest.raises(RuntimeError, match="gathered copy"):
        WRITES[how](view)
    after = drv.sharded.gather()
    for f in sharded.FIELDS:
        assert torch.equal(getattr(before, f), getattr(after, f)), f
    scratch = view.heat + 1
    scratch.zero_()
    host = view.heat.cpu()
    host[0] = 7
    assert type(scratch) is torch.Tensor and type(host) is torch.Tensor
    view.id_loc[5] = 42
    assert int(drv.sharded.shards[0].id_loc[5]) == 42


CARDS_RULE = [
    # (cards, device, shape, devices) -> the mesh's devices
    (4, "cuda", None, 2, ["cuda:0", "cuda:1"]),
    (4, "cuda", (1, 4), 1, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (2, "cuda", (1, 4), 1, ["cuda:0"] * 4),
    (4, "cuda:1", (1, 2), 1, ["cuda:1"] * 2),
    (1, "cuda", (1, 2), 1, ["cuda:0"] * 2),
    (4, "cuda", None, 1, ["cuda:0"]),
    (4, "cpu", (1, 4), 1, ["cpu"] * 4),
    (4, "cpu", None, 3, ["cpu"]),          # 64 % 3: falls back to 1
]


@pytest.mark.parametrize("cards,device,shape,devices,want", CARDS_RULE)
def test_worker_mesh_rule(cards, device, shape, devices, want):
    """A cluster worker's mesh: the shard count comes from ``mesh_shape``
    or the worker's ``--devices`` count alone; an unindexed ``"cuda"``
    spreads the shards one a card where the process sees enough cards,
    anything else keeps them all on ``device``."""
    from repro_torch.cluster.worker import logical_mesh
    cfg = dataclasses.replace(CFG, max_postings=64)
    with mock.patch.object(torch.cuda, "device_count", lambda: cards), \
            mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "current_device", lambda: 0):
        mesh = logical_mesh(cfg, devices, device, shape)
    assert [str(d) for d in mesh.devices] == want
    assert mesh.shape["model"] == len(want)


def test_checkpoint_restores_onto_the_shards(tmp_path):
    """A checkpoint of ``drv.sharded`` restored onto the sharded layout
    (each shard's rows from the host to its own device), adopted by a
    fresh driver: the same snapshot and the same search."""
    drv, data = _driver()
    drv.insert(data[:700], np.arange(700))
    drv.tick()
    path = str(tmp_path / "sh")
    save_pytree({"index": drv.sharded}, path)
    fresh, _ = _driver()
    out, _ = restore_pytree({"index": fresh.sharded}, path)
    assert isinstance(out["index"], sharded.ShardedState)
    sharded.audit_placement(out["index"])
    fresh.load_snapshot(out["index"])
    a, b = (bridge.state_to_numpy(drv.snapshot()),
            bridge.state_to_numpy(fresh.snapshot()))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    q = data[:12]
    np.testing.assert_array_equal(drv.search(q, 5).ids,
                                  fresh.search(q, 5).ids)


# ---------------------------------------------------------------------------
# placements against the JAX functions
# ---------------------------------------------------------------------------

def _logical_axes():
    tm = get_model("tinyllama-1.1b", reduced=True, device="cpu",
                   local_global_pattern="LLG", n_layers=4, sliding_window=8)
    _, paxes = tm.param_shapes()
    _, caxes = tm.cache_shapes(2, 16)
    tree = {"params": paxes,
            "caches": [{k: ("layers",) + ax for k, ax in layer.items()}
                       for layer in caxes],
            "extra": ("kv_seq", "unknown", None)}
    return tree


def _jax_tree(tree):
    import jax
    P = jax.sharding.PartitionSpec
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return P(*tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("kind,long_context", [
    ("train", False), ("decode", False), ("decode", True)])
def test_placements_match_jax_leaf_for_leaf(kind, long_context):
    import jax

    from repro.distributed import sharding as jsharding
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    rules = make_rules(mesh, kind, long_context)
    jrules = jsharding.make_rules(jmesh, kind, long_context)
    tree = _logical_axes()
    for got_tree, want_tree in (
            (to_named_sharding(mesh, tree, rules),
             jsharding.to_named_sharding(jmesh, _jax_tree(tree), jrules)),
            (batch_sharding(mesh, tree, rules),
             jsharding.batch_sharding(jmesh, tree, jrules))):
        got, want = list(_leaves(got_tree)), list(
            jax.tree_util.tree_leaves(
                want_tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding)))
        assert len(got) == len(want) > 20
        for g, w in zip(got, want):
            assert isinstance(g, Placement) and g.mesh is mesh
            assert g.spec == tuple(w.spec), (g.spec, w.spec)


def test_place_and_gather_split_the_model_dim():
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    t = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    parts = place(t, Placement(mesh, ("data", "model", None)))
    assert [tuple(p.shape) for p in parts] == [(2, 2, 3)] * 4
    assert len({p.untyped_storage().data_ptr() for p in parts}) == 4
    assert torch.equal(gather(parts, Placement(mesh, (None, "model", None))),
                       t)
    whole = place(t, Placement(mesh, ("data", None, None)))
    assert all(torch.equal(p, t) for p in whole)
    assert whole[0].untyped_storage().data_ptr() != t.untyped_storage(
    ).data_ptr()
    with pytest.raises(ValueError, match="divide"):
        place(torch.zeros(6), Placement(mesh, ("model",)))


# ---------------------------------------------------------------------------
# the default mesh and the mesh's devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cards", range(1, 9))
@pytest.mark.parametrize("max_postings", [64, 96, 4096, 65504])
def test_default_mesh_follows_the_jax_rule(cards, max_postings):
    import jax

    from repro.api import sharded_driver as jdriver
    cfg = UBISConfig(dim=8, max_postings=max_postings, capacity=32,
                     l_min=4, l_max=24)
    with mock.patch.object(jax, "devices", lambda: list(range(cards))), \
            mock.patch.object(jax, "make_mesh",
                              lambda shape, names: (shape, names)):
        want_shape, names = jdriver.default_mesh(cfg)
    with mock.patch.object(torch.cuda, "device_count", lambda: cards), \
            mock.patch.object(torch.cuda, "is_available", lambda: True):
        mesh = default_mesh(cfg, "cuda")
    assert mesh.axis_names == names
    assert mesh.axis_sizes == tuple(want_shape)
    m = mesh.shape["model"]
    assert m == model_shards(max_postings, cards)
    assert (mesh.n_rows, mesh.n_shards) == (cards // m, m)
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(cards))
    for r in range(cards // m):
        assert mesh.row_devices(r) == tuple(
            torch.device("cuda", r * m + j) for j in range(m))


def test_mesh_devices_are_checked():
    with mock.patch.object(torch.cuda, "device_count", lambda: 1), \
            mock.patch.object(torch.cuda, "is_available", lambda: True):
        with pytest.raises(RuntimeError, match="not available"):
            make_mesh((1, 2), ("data", "model"),
                      devices=["cuda:0", "cuda:1"])
    grid = make_mesh((2, 2), ("data", "model"),
                     devices=["cpu", "cpu", "cpu", "cpu"])
    assert (grid.n_rows, grid.n_shards) == (2, 2)
    for shape, n in (((2, 2), 2), ((2, 2), 3), ((1, 2), 4)):
        with pytest.raises(ValueError, match="one device a cell"):
            make_mesh(shape, ("data", "model"), devices=["cpu"] * n)
    with pytest.raises(ValueError, match="not both"):
        make_mesh((1, 1), ("data", "model"), device="cpu", devices=["cpu"])
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert default_mesh(CFG, "cpu").devices == (torch.device("cpu"),)


# ---------------------------------------------------------------------------
# kernel wrappers refuse inputs on two devices
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


MIXED = {
    "centroid_score": lambda: ops.centroid_score(
        torch.zeros(2, 8), _meta(5, 8)),
    "centroid_topk": lambda: ops.centroid_topk(
        torch.zeros(2, 8), torch.zeros(5, 8), _meta(5, dtype=torch.bool),
        k=2),
    "posting_scan": lambda: ops.posting_scan(
        torch.zeros(2, 8), _meta(3, 4, 8), torch.ones(3, 4, dtype=bool)),
    "posting_scan_gather": lambda: ops.posting_scan_gather(
        torch.zeros(2, 8), torch.zeros(3, 4, 8),
        torch.ones(3, 4, dtype=bool), torch.ones(3, dtype=bool),
        _meta(2, 2, dtype=torch.int32)),
    "posting_scan_topk": lambda: ops.posting_scan_topk(
        torch.zeros(2, 8), torch.zeros(3, 4, 8),
        torch.ones(3, 4, dtype=bool), _meta(3, dtype=torch.bool),
        torch.zeros(2, 2, dtype=torch.int32), k=2),
    "kmeans_assign": lambda: ops.kmeans_assign(
        torch.zeros(6, 8), _meta(3, 8)),
    "pq_scan_gather": lambda: ops.pq_scan_gather(
        torch.zeros(2, 1, 2, 4), _meta(3, 2, 4, dtype=torch.uint8),
        torch.zeros(3, dtype=torch.int32), torch.ones(3, 4, dtype=bool),
        torch.ones(3, dtype=bool), torch.zeros(2, 2, dtype=torch.int32)),
    "pq_scan_topk": lambda: ops.pq_scan_topk(
        torch.zeros(2, 1, 2, 4), torch.zeros(3, 2, 4, dtype=torch.uint8),
        torch.zeros(3, dtype=torch.int32), torch.ones(3, 4, dtype=bool),
        torch.ones(3, dtype=bool), torch.zeros(2, 2, dtype=torch.int32),
        k=2, qp_ok=_meta(2, 2, dtype=torch.int32)),
    "rerank_topk": lambda: ops.rerank_topk(
        torch.zeros(2, 8), torch.zeros(3, 4, 8), torch.zeros(3, dtype=bool),
        torch.zeros(2, 4, dtype=torch.int32), _meta(2, 4), k=2),
    "flash_attention": lambda: ops.flash_attention(
        torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8),
        _meta(1, 2, 4, 8)),
}


@pytest.mark.parametrize("name", sorted(MIXED))
def test_wrapper_refuses_inputs_on_two_devices(name):
    assert set(MIXED) == set(ops.KERNELS)
    with pytest.raises(ValueError, match="different devices"):
        MIXED[name]()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode "
                    "(chip_smoke.py phases 3h and 3k run these checks)")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, the machine has "
                    f"{torch.cuda.device_count()} (chip_smoke.py phase 3k "
                    "says so too)")


def _stream(drv, data):
    drv.insert(data[:700], np.arange(700))
    drv.delete(np.arange(0, 700, 4))
    for _ in range(3):
        drv.tick()
    if drv.tier is not None:
        drv.force_spill(20)
        drv.tick()
        drv.force_promote(5)
    drv.insert(data[700:], np.arange(700, len(data)))
    drv.flush(max_ticks=20)
    q = data[:32]
    return drv.search(q, 5), drv.exact(q, 5)


TIERED = dataclasses.replace(CFG, use_pq=True, pq_m=4, pq_ksub=16,
                             rerank_k=64, use_tier=True, tier_hot_max=8)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG, TIERED], ids=["float", "tiered"])
def test_card_shards_on_one_card_own_their_storage(cfg):
    _cards(1)
    data = _clustered(1200, cfg.dim, seed=3)
    drv = make_index("ubis-sharded", cfg, data[:200], round_size=128,
                     mesh=make_mesh((1, 4), ("data", "model")))
    _stream(drv, data)
    sharded.audit_placement(drv.sharded)
    drv.check_replicas()
    with pytest.raises(ValueError, match="different devices"):
        ops.centroid_score(torch.zeros(2, 8, device="cuda"),
                           torch.zeros(5, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG, TIERED], ids=["float", "tiered"])
def test_card_two_cards_match_one_card_bit_for_bit(cfg):
    _cards(2)
    data = _clustered(1200, cfg.dim, seed=3)
    runs = []
    for mesh in (make_mesh((1, 2), ("data", "model"), device="cuda:0"),
                 make_mesh((1, 2), ("data", "model"),
                           devices=["cuda:0", "cuda:1"])):
        drv = make_index("ubis-sharded", cfg, data[:200], round_size=128,
                         mesh=mesh, pq_retrain_every=2)
        res, ex = _stream(drv, data)
        sharded.audit_placement(drv.sharded)
        drv.check_replicas()
        runs.append((res, ex, bridge.state_to_numpy(drv.snapshot())))
    (r1, e1, s1), (r2, e2, s2) = runs
    np.testing.assert_array_equal(r1.ids, r2.ids)
    np.testing.assert_array_equal(r1.scores, r2.scores)
    np.testing.assert_array_equal(e1.ids, e2.ids)
    for k in s1:
        np.testing.assert_array_equal(s1[k], s2[k], err_msg=k)


def _cluster_run(backend, device, data):
    """A two-worker ``ubis-cluster`` stream, each worker's mesh (1, 2):
    (each worker's shard devices, then the answers and the state)."""
    from repro_torch.cluster import ClusterCoordinator
    c = ClusterCoordinator(CFG, data[:200], workers=2, backend=backend,
                           device=device, mesh_shape=(1, 2), round_size=128,
                           seed=0, spread_per_tick=64)
    try:
        placed = [c.backend.call(w, "placement", {})["devices"]
                  for w in range(2)]
        c.insert(data[200:900], np.arange(700))
        c.delete(np.arange(0, 700, 5))
        c.flush()
        c.insert(data[900:], np.arange(700, len(data) - 200))
        c.flush()
        q = data[:32]
        res, ex = c.search(q, 5), c.exact(q, 5)
        return placed, (res.ids, res.scores, ex.ids, ex.scores,
                        c.snapshot().digests, c.worker_live())
    finally:
        c.close()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["local", "multiprocess"])
def test_card_cluster_two_cards_match_one_card(backend):
    """``ubis-cluster`` whose workers take two cards each (``device=
    "cuda"``: shard j on card j) against the same stream with both
    shards of each worker on ``cuda:0``, bit for bit."""
    _cards(2)
    data = _clustered(1400, CFG.dim, seed=5)
    one_placed, one = _cluster_run(backend, "cuda:0", data)
    two_placed, two = _cluster_run(backend, "cuda", data)
    assert one_placed == [["cuda:0", "cuda:0"]] * 2
    assert two_placed == [["cuda:0", "cuda:1"]] * 2
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)


def test_index_state_fields_are_the_layouts_fields():
    assert sharded.FIELDS == tuple(
        f.name for f in dataclasses.fields(IndexState))
    assert set(sharded.MODEL_FIELDS) | set(sharded.REPLICATED_FIELDS) == \
        set(sharded.FIELDS)
