"""The sharded plane's data x model mesh, on the CPU.

A mesh of shape (D, S) holds D data rows, each a whole replica of the S
``model`` shards (``repro/core/sharded.py``'s ``index_specs`` leave
every field unsharded over ``data``).  A search splits its batch over
the rows, every update program runs on every row, ``exact`` runs on row
0.  So a stream on (D, S) answers as on (1, S) bit for bit, and its rows
stay identical after every program.  These tests hold that on every cell
of the CPU: (2, 2) against (1, 2) and (4, 1) against (1, 1) over the
float, quant (with codebook re-trains) and tiered streams (spills and
promotes, ``tier_async`` off and on), checking the rows after every
program and auditing every cell's storage; ``pod x data x model`` (2, 1,
2) against (1, 1, 2); ``place``/``gather`` over the data axis and the
whole grid; a checkpoint taken at (1, 2) restored onto (2, 2); and a
``ubis-cluster`` worker whose mesh has two rows.

The JAX package is the reference for the rows too:
``tests/test_torch_sharded.py`` replays ``tests/sharded_reference.py``'s
programs, run by JAX on a (2, 4) mesh of 8 host devices, on
``make_mesh((2, 4), ..., device="cpu")``, which holds two real rows of
four shards; it compares the outputs and the states there and checks
the rows after every program.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.api import make_index
from repro_torch.checkpoint.manager import restore_pytree, save_pytree
from repro_torch.core import sharded
from repro_torch.core.types import UBISConfig
from repro_torch.distributed import (Placement, gather, make_mesh,
                                     make_rules, place)

CFG = UBISConfig(dim=8, max_postings=64, capacity=32, l_min=4, l_max=24,
                 max_ids=1 << 12)
QUANT = dataclasses.replace(CFG, use_pq=True, pq_m=4, pq_ksub=16,
                            rerank_k=64)
TIERED = dataclasses.replace(QUANT, use_tier=True, tier_hot_max=8)
PLANES = {"float": (CFG, {}), "quant": (QUANT, {}),
          "tiered_sync": (TIERED, {"tier_async": False}),
          "tiered_async": (TIERED, {"tier_async": True})}
STATS = ("inserted", "deleted", "rejected", "migrated", "bg_ops", "bg_gc",
         "host_cached", "drained", "pq_retrains", "tier_spilled",
         "tier_promoted")
#: the programs and the writes through the global view after which the
#: rows are checked
CHECKED = ("_insert_fn", "_delete_fn", "_background_fn", "_migrate_fn",
           "_cache_put", "_tier_step", "exec_pq_retrain", "force_spill",
           "force_promote", "tick")


def _clustered(n, d=8, seed=0, k=6):
    r = np.random.default_rng(seed)
    cents = r.normal(size=(k, d)) * 5
    return (cents[r.integers(0, k, n)] + r.normal(size=(n, d))).astype(
        np.float32)


DATA = _clustered(1200, seed=3)


def _mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, device="cpu")


def _checked(drv) -> list:
    """Wrap the driver's programs and global-view writers so that the
    rows (and the replicas) are checked after each; returns the list the
    checks are counted in."""
    done = []
    for name in CHECKED:
        fn = getattr(drv, name, None)
        if fn is None:
            continue

        def wrap(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            sharded.check_replicas(drv.sharded)
            done.append(_name)
            return out
        setattr(drv, name, wrap)
    return done


def _audit(drv) -> int:
    """``audit_placement`` and the count of distinct storages: one a
    cell's field, none shared."""
    sh = drv.sharded
    sharded.audit_placement(sh)
    stores = {(t.device, t.untyped_storage().data_ptr())
              for row in sh.rows for st in row.shards
              for t in (getattr(st, f) for f in sharded.FIELDS)
              if t.numel()}
    return len(stores)


def _run(cfg, mesh, **kw) -> dict:
    drv = make_index("ubis-sharded", cfg, DATA[:200], mesh=mesh,
                     round_size=128, bg_ops_per_round=8, pq_retrain_every=2,
                     **kw)
    done = _checked(drv)
    drv.insert(DATA[:700], np.arange(700))
    drv.delete(np.arange(0, 700, 4))
    for _ in range(3):
        drv.tick()
    if drv.tier is not None:
        drv.force_spill(20)
        drv.tick()
        drv.force_promote(5)
    drv.insert(DATA[700:], np.arange(700, len(DATA)))
    drv.flush(max_ticks=20)
    q = DATA[:32]
    res, odd, ex = drv.search(q, 5), drv.search(q[:13], 5), drv.exact(q, 5)
    snap = bridge.state_to_numpy(drv.snapshot())
    out = dict(ids=res.ids, scores=res.scores, odd_ids=odd.ids,
               odd_scores=odd.scores, exact=ex.ids, exact_scores=ex.scores,
               occ=drv.shard_occupancy(), live=drv.live_count(),
               stats={k: float(drv.stats[k]) for k in STATS},
               snap={k: v.copy() for k, v in snap.items()},
               checked=sorted(set(done)), n_checked=len(done),
               stores=_audit(drv), mem=drv.memory_bytes())
    drv.close()
    return out


def _same(a, b):
    for k in ("ids", "scores", "odd_ids", "odd_scores", "exact",
              "exact_scores", "occ"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["stats"] == b["stats"]
    assert a["live"] == b["live"] and a["mem"] == b["mem"]
    assert a["snap"].keys() == b["snap"].keys()
    for k in a["snap"]:
        np.testing.assert_array_equal(a["snap"][k], b["snap"][k], err_msg=k)


@pytest.mark.parametrize("plane", sorted(PLANES))
@pytest.mark.parametrize("rows,one", [((2, 2), (1, 2)), ((4, 1), (1, 1))],
                         ids=["2x2-vs-1x2", "4x1-vs-1x1"])
def test_rows_match_one_row_bit_for_bit(plane, rows, one):
    cfg, kw = PLANES[plane]
    a, b = _run(cfg, _mesh(one), **kw), _run(cfg, _mesh(rows), **kw)
    _same(a, b)
    D, S = rows
    assert b["stores"] == D * S * len(sharded.FIELDS)
    assert {"_insert_fn", "_delete_fn", "_background_fn", "tick"} <= set(
        b["checked"])
    if S > 1:
        assert "_migrate_fn" in b["checked"] or b["stats"]["migrated"] == 0
    if cfg.use_pq:
        assert b["stats"]["pq_retrains"] > 0
        assert "exec_pq_retrain" in b["checked"]
    if cfg.use_tier:
        assert b["stats"]["tier_spilled"] > 0
        assert b["stats"]["tier_promoted"] > 0
    assert b["n_checked"] == a["n_checked"] > 20


def test_pod_data_model_matches_one_row():
    names = ("pod", "data", "model")
    a = _run(QUANT, _mesh((1, 1, 2), names))
    b = _run(QUANT, _mesh((2, 1, 2), names))
    _same(a, b)
    assert b["stores"] == 4 * len(sharded.FIELDS)


def test_rows_are_checked_and_written_through_the_view():
    """A write into one row only is caught; the view's writes and
    ``store`` reach every row; its reads are row 0's."""
    drv = make_index("ubis-sharded", CFG, DATA[:200], mesh=_mesh((2, 2)),
                     round_size=128)
    drv.insert(DATA[:400], np.arange(400))
    sh = drv.sharded
    assert (sh.n_rows, sh.n_shards) == (2, 2) and len(sh.devices) == 4
    sharded.check_replicas(sh)
    row1 = sh.row(1).shards[1]
    row1.heat[3] += 1
    with pytest.raises(AssertionError, match="heat of row 1's shard 1"):
        sharded.check_replicas(sh)
    row1.heat[3] -= 1
    sh.row(1).shards[0].id_loc[9] = 5
    with pytest.raises(AssertionError, match="id_loc of row 1's shard 0"):
        sharded.check_replicas(sh)
    sh.replicate()                       # row 0's replica to every cell
    sharded.check_replicas(sh)
    view = drv.state
    view.set_rows("heat", torch.tensor([1, 40]), 7,
                  torch.tensor([True, True]))
    view.lengths = view.lengths + 1
    loc = sh.local(1)
    loc.heat = loc.heat + 2
    sh.store(1, loc)
    sharded.check_replicas(sh)
    assert int(sh.row(1).shards[1].heat[8]) == 7 + 2
    assert int(view.heat[40]) == 9
    with pytest.raises(ValueError, match="divide over the 2 data rows"):
        sharded.make_sharded_search(CFG, drv.mesh, k=5)(
            sh, torch.zeros(3, CFG.dim))
    drv.sharded.row(1).shards[0].heat = sh.shards[0].heat
    with pytest.raises(AssertionError, match="shares storage"):
        sharded.audit_placement(sh)


def test_a_row_runs_the_programs_alone():
    """A ``ShardRow`` is taken by the programs as a mesh of one row: its
    search equals the whole mesh's on the same block of queries."""
    drv = make_index("ubis-sharded", CFG, DATA[:200], mesh=_mesh((2, 2)),
                     round_size=128)
    drv.insert(DATA[:600], np.arange(600))
    drv.flush(max_ticks=10)
    fn = sharded.make_sharded_search(CFG, drv.mesh, k=5)
    q = torch.from_numpy(DATA[:8])
    ids, scores = fn(drv.sharded, q)
    for r in range(2):
        i, s = fn(drv.sharded.row(r), q[4 * r:4 * r + 4])
        assert torch.equal(i, ids[4 * r:4 * r + 4])
        assert torch.equal(s, scores[4 * r:4 * r + 4])


# ---------------------------------------------------------------------------
# placements over the data axis and the whole grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,blocks", [
    (("data", None, None), [(8, 4)] * 4),
    ((None, "model", None), [(16, 2)] * 4),
    ((("data", "model"), None, None), [(4, 4)] * 4),
    (("data", "model", None), [(8, 2)] * 4),
    ((None, None, None), [(16, 4)] * 4)],
    ids=["batch-over-data", "model", "kv_seq-over-grid", "data-and-model",
         "whole"])
def test_place_and_gather_round_trip(spec, blocks):
    mesh = _mesh((2, 2))
    t = torch.arange(16 * 6 * 4).reshape(16, 6, 4).permute(0, 2, 1)
    pl = Placement(mesh, spec)
    parts = place(t, pl)
    assert [tuple(p.shape[:2]) for p in parts] == blocks
    assert len({p.untyped_storage().data_ptr() for p in parts}) == 4
    assert torch.equal(gather(parts, pl), t)


def test_rules_place_batch_over_data_and_kv_seq_over_the_grid():
    """The backbone's rules on a (2, 2) mesh: a ``batch`` leaf splits over
    the rows and is whole over ``model``; on long-context decode
    ``kv_seq`` splits over ``("data", "model")`` row-major, cell i
    holding the i-th quarter."""
    mesh = _mesh((2, 2))
    batch = torch.arange(4 * 6).reshape(4, 6)
    pl = Placement(mesh, (make_rules(mesh, "train")["batch"], None))
    parts = place(batch, pl)
    assert [p.tolist() for p in parts] == [batch[:2].tolist()] * 2 + [
        batch[2:].tolist()] * 2
    assert torch.equal(gather(parts, pl), batch)
    cache = torch.randn(2, 3, 8, 5)              # (B, heads, kv_seq, D)
    rules = make_rules(mesh, "decode", long_context=True)
    pl = Placement(mesh, (rules["batch"], None, rules["kv_seq"], None))
    parts = place(cache, pl)
    for i, p in enumerate(parts):
        assert torch.equal(p, cache[:, :, 2 * i:2 * i + 2])
    assert torch.equal(gather(parts, pl), cache)
    with pytest.raises(ValueError, match="divide"):
        place(torch.zeros(3, 4), Placement(mesh, ("data", None)))


# ---------------------------------------------------------------------------
# a checkpoint across layouts, a cluster worker with two rows
# ---------------------------------------------------------------------------

def test_checkpoint_at_one_row_restores_onto_two_rows(tmp_path):
    def drv_on(shape):
        return make_index("ubis-sharded", QUANT, DATA[:200],
                          mesh=_mesh(shape), round_size=128,
                          pq_retrain_every=2)

    src = drv_on((1, 2))
    src.insert(DATA[:600], np.arange(600))
    src.tick()
    path = str(tmp_path / "ckpt")
    save_pytree({"index": src.sharded}, path)
    runs = []
    for shape in ((1, 2), (2, 2)):
        drv = drv_on(shape)
        out, _ = restore_pytree({"index": drv.sharded}, path)
        assert out["index"].n_rows == shape[0]
        drv.load_snapshot(out["index"])
        sharded.check_replicas(drv.sharded)
        sharded.audit_placement(drv.sharded)
        drv.insert(DATA[600:], np.arange(600, len(DATA)))
        drv.flush(max_ticks=20)
        sharded.check_replicas(drv.sharded)
        q = DATA[:16]
        runs.append((drv.search(q, 5), drv.exact(q, 5),
                     bridge.state_to_numpy(drv.snapshot())))
    (r1, e1, s1), (r2, e2, s2) = runs
    np.testing.assert_array_equal(r1.ids, r2.ids)
    np.testing.assert_array_equal(r1.scores, r2.scores)
    np.testing.assert_array_equal(e1.ids, e2.ids)
    for k in s1:
        np.testing.assert_array_equal(s1[k], s2[k], err_msg=k)
    with pytest.raises(ValueError, match="another mesh"):
        drv_on((1, 2)).load_snapshot(out["index"])


def test_cluster_worker_with_two_rows_matches_one_row():
    from repro_torch.cluster import ClusterCoordinator
    runs = []
    for shape in ((1, 1), (2, 1)):
        c = ClusterCoordinator(CFG, DATA[:200], workers=1, backend="local",
                               device="cpu", mesh_shape=shape,
                               round_size=128, seed=0)
        try:
            placed = c.backend.call(0, "placement", {})["devices"]
            assert placed == ["cpu"] * shape[0]
            c.insert(DATA[200:900], np.arange(700))
            c.delete(np.arange(0, 700, 5))
            c.flush()
            c.insert(DATA[900:], np.arange(700, 1000))
            c.flush()
            sharded.check_replicas(c.backend._runtimes[0].drv.sharded)
            q = DATA[:32]
            res, ex = c.search(q, 5), c.exact(q, 5)
            snap = bridge.state_to_numpy(c.snapshot())
            runs.append([res.ids, res.scores, ex.ids, ex.scores,
                         c.worker_live()] + [snap[k].copy()
                                             for k in sorted(snap)])
        finally:
            c.close()
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cards,device,shape,want", [
    (4, "cuda", (2, 2), ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (4, "cuda", (2, 1), ["cuda:0", "cuda:1"]),
    (3, "cuda", (2, 2), ["cuda:0"] * 4),
    (4, "cuda:2", (2, 2), ["cuda:2"] * 4),
    (4, "cpu", (4, 1), ["cpu"] * 4)])
def test_worker_lays_its_rows_over_cards(cards, device, shape, want):
    from unittest import mock

    from repro_torch.cluster.worker import logical_mesh
    with mock.patch.object(torch.cuda, "device_count", lambda: cards), \
            mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "current_device", lambda: 0):
        mesh = logical_mesh(CFG, 1, device, shape)
    assert [str(d) for d in mesh.devices] == want
    assert (mesh.n_rows, mesh.n_shards) == shape
