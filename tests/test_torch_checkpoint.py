"""The port's checkpoint manager (``repro_torch/checkpoint/manager.py``).

The five tests of ``tests/test_checkpoint.py`` on the port: the atomic
round trip, keep-N and resume extras, the async save, no ``.tmp`` left,
and the tiered snapshot's round trip through the files on the port's
``UBISDriver`` (the spilled tiles in the saved state, the same search
and ``exact`` answers, the residency and the byte split after
``load_snapshot``).  Then the two properties the port adds:

* the files cross-load: a JAX ``save_pytree`` of an ``IndexState``
  restores into the port's template (its uint32 fields into int64), and
  a port save restores into the JAX template, keys and values equal;
* an async save takes a real host copy on the caller's thread: a round
  that updates the state in place right after ``save`` (the port's
  rounds do) leaves the file holding the state as it was at ``save``.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointManager, restore_pytree,
                                    save_pytree)
from repro_torch.checkpoint.manager import _flatten
from repro_torch.core.types import UBISConfig


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": torch.from_numpy(r.normal(size=(4, 8)).astype(np.float32)),
            "b": {"c": torch.arange(5), "d": torch.tensor(2.0)}}


def _leaves(tree):
    return [tree["a"], tree["b"]["c"], tree["b"]["d"]]


def test_roundtrip(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck")
    save_pytree(t, path, extra={"step": 7})
    out, extra = restore_pytree(t, path)
    assert extra["step"] == 7
    for a, b in zip(_leaves(t), _leaves(out)):
        assert b.dtype == a.dtype and b.device == a.device
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # a list and a tuple keep their kind; the keys are the JAX package's
    t2 = {"l": [torch.zeros(2), (torch.ones(3), np.arange(2))]}
    save_pytree(t2, path)
    out, _ = restore_pytree(t2, path)
    assert isinstance(out["l"], list) and isinstance(out["l"][1], tuple)
    assert sorted(_flatten(t2)) == ["l/0", "l/1/0", "l/1/1"]


def test_manager_keep_n_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for step in (10, 20, 30):
        mgr.save(step, _tree(step), extra={"stream": {"cursor": step}})
    assert mgr.all_steps() == [20, 30]
    step, tree, extra = mgr.restore_latest(_tree())
    assert step == 30 and extra["stream"]["cursor"] == 30
    np.testing.assert_allclose(tree["a"].numpy(), _tree(30)["a"].numpy())


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(1, _tree(1))
    mgr.wait()
    assert mgr.latest_step() == 1


def test_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(5, _tree())
    files = os.listdir(tmp_path)
    assert not any(f.endswith(".tmp") for f in files)


def _tiered_driver():
    from repro_torch.api import make_index
    rng = np.random.default_rng(2)
    cents = rng.normal(size=(8, 16)) * 6
    data = (cents[rng.integers(0, 8, 1200)]
            + rng.normal(size=(1200, 16))).astype(np.float32)
    cfg = UBISConfig(dim=16, max_postings=128, capacity=96, l_min=10,
                     l_max=80, nprobe=128, max_ids=1 << 13, use_pq=True,
                     pq_m=4, pq_ksub=16, rerank_k=256, use_tier=True,
                     tier_hot_max=8)

    def make():
        return make_index("ubis", cfg, data[:300], device="cpu",
                          round_size=256, bg_ops_per_round=8)
    return make, data


def test_tiered_snapshot_roundtrips_through_checkpoint(tmp_path):
    """``tests/test_checkpoint.py``'s cold-tier snapshot contract on the
    port: the snapshot holds the spilled tiles (the live state keeps them
    zeroed), and a fresh driver restored from the files re-derives
    residency and answers search and ``exact`` identically."""
    make, data = _tiered_driver()
    drv = make()
    drv.insert(data, np.arange(1200))
    drv.flush(max_ticks=60)
    drv.force_spill(6)
    assert len(drv.tier.pool) > 0
    q = data[:24]
    s0 = drv.search(q, 10)
    snap = drv.snapshot()
    sp = np.flatnonzero(snap.tier_spilled.numpy())
    assert sp.size and snap.vectors.numpy()[sp].any()
    assert not drv.state.vectors.numpy()[sp].any()
    path = str(tmp_path / "tiered")
    save_pytree(snap, path, extra={"spilled": int(sp.size)})
    restored, extra = restore_pytree(snap, path)
    assert extra["spilled"] == sp.size
    assert restored.rec_meta.dtype == torch.int64
    drv2 = make().load_snapshot(restored)
    assert len(drv2.tier.pool) == sp.size
    s1 = drv2.search(q, 10)
    np.testing.assert_array_equal(s0.ids, s1.ids)
    np.testing.assert_allclose(s0.scores, s1.scores, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(drv.exact(q, 10).ids, drv2.exact(q, 10).ids)
    assert drv2.memory_tiers() == drv.memory_tiers()
    assert drv2.live_count() == drv.live_count() == 1200


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_index_state_files_cross_load(tmp_path, direction):
    """One file format: a state saved by either package restores into
    the other's template, every field equal (uint32 <-> int64)."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import (restore_pytree as j_restore,
                                  save_pytree as j_save)
    from repro.core.types import IndexState as JState
    make, data = _tiered_driver()
    drv = make()
    drv.insert(data[:600], np.arange(600))
    drv.flush(max_ticks=30)
    drv.force_spill(3)
    snap = drv.snapshot()
    want = bridge.state_to_numpy(snap)
    jstate = JState(**{k: jnp.asarray(v) for k, v in want.items()})
    path = str(tmp_path / "ck")
    tree = {"step": torch.tensor(3), "index": [snap]}
    jtree = {"step": jnp.asarray(3), "index": [jstate]}
    if direction == "jax_to_port":
        j_save(jtree, path, extra={"by": "jax"})
        out, extra = restore_pytree(tree, path)
        got = bridge.state_to_numpy(out["index"][0])
        assert out["index"][0].heat.dtype == torch.int64
    else:
        save_pytree(tree, path, extra={"by": "port"})
        out, extra = j_restore(jtree, path)
        jst = jax.device_get(out["index"][0])
        got = {k: np.asarray(getattr(jst, k)) for k in want}
        assert got["heat"].dtype == np.uint32
    assert extra["by"] == direction.split("_")[0]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(out["step"]) == 3


def test_async_save_copies_before_the_next_in_place_round(tmp_path):
    """On the CPU ``tensor.cpu()`` is the tensor itself, and the port's
    rounds write ``IndexState`` in place: the manager's host copy must be
    a real one, or the file would hold the next round's state."""
    import threading
    from unittest import mock

    import repro_torch.checkpoint.manager as manager
    from repro_torch.core import update
    make, data = _tiered_driver()
    drv = make()
    drv.insert(data[:400], np.arange(400), tick_between=False)
    want = {k: v.copy() for k, v in bridge.state_to_numpy(drv.state).items()}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    gate = threading.Event()
    real = manager.save_pytree

    def late_save(*a, **kw):
        gate.wait(10)                 # the file is written after the round
        return real(*a, **kw)
    with mock.patch.object(manager, "save_pytree", late_save):
        mgr.save(1, {"index": drv.state})
        # an in-place round right after ``save``: tombstones and id-map
        # writes on the very tensors the save was handed
        n = 64
        update.delete_round(drv.state, drv.cfg,
                            torch.arange(n, dtype=torch.int32),
                            torch.ones(n, dtype=torch.bool))
        assert not np.array_equal(drv.state.slot_valid.numpy(),
                                  want["slot_valid"])
        gate.set()
        mgr.wait()
    _, out, _ = mgr.restore_latest({"index": drv.state})
    got = bridge.state_to_numpy(out["index"])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
