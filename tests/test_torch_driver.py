"""The port's driver end to end against the JAX driver on one stream.

Both packages get the same seed vectors, the same k-means initial
indices (the JAX draw, injected into the port) and the same stream of
inserts, deletes and ticks.  Then the live id set must be identical,
the port's search must reach recall@10 > 0.9 against its own exact
oracle (the floor of tests/test_search.py), and the share of live
postings below ``l_min`` (``small_frac``, benchmarks/common.py) must be
within 0.02 of the JAX driver's (the absolute floor of
benchmarks/check_regression.py).
"""
import numpy as np
import pytest
import jax
import torch

from conftest import make_clustered
from repro.core import UBISConfig as JConfig, UBISDriver as JDriver
from repro_torch.api import make_index
from repro_torch.core import metrics
from repro_torch.core.build import initial_posting_count
from repro_torch.core.invariants import check_invariants
from repro_torch.core.types import UBISConfig

CFG = dict(dim=16, max_postings=256, capacity=96, l_min=10, l_max=80,
           cache_capacity=1024, max_ids=1 << 14)
DRIVER_KW = dict(round_size=256, bg_ops_per_round=8)


def live_ids(id_loc) -> np.ndarray:
    return np.flatnonzero(np.asarray(id_loc) != -1)


def small_frac(drv, l_min) -> float:
    lens = drv.posting_lengths()
    return float((lens < l_min).mean()) if len(lens) else 0.0


def stream(drv):
    data = make_clustered(3000, d=16, seed=3)
    fresh = make_clustered(1000, d=16, seed=77)
    dels = np.random.default_rng(0).choice(3000, size=800, replace=False)
    drv.insert(data, np.arange(3000))
    drv.flush(max_ticks=50)
    drv.delete(dels)
    drv.insert(fresh, np.arange(10000, 11000))
    drv.flush(max_ticks=50)


@pytest.mark.parametrize("engine", ["ubis", "spfresh"])
def test_driver_stream_matches_jax(engine):
    tcfg = UBISConfig(mode=engine, **CFG)
    seeds = make_clustered(3000, d=16, seed=3)[:800]
    k0 = initial_posting_count(tcfg, len(seeds))
    init = np.asarray(jax.random.choice(jax.random.key(0), len(seeds), (k0,),
                                        replace=False))
    jd = JDriver(JConfig(mode=engine, use_pallas="off", **CFG), seeds,
                 **DRIVER_KW)
    td = make_index(engine, tcfg, seeds, device="cpu", kmeans_init=init,
                    **DRIVER_KW)
    stream(jd)
    stream(td)

    np.testing.assert_array_equal(live_ids(td.state.id_loc.numpy()),
                                  live_ids(jd.state.id_loc))
    for key in ("inserted", "deleted", "rejected", "bg_split", "bg_merge"):
        assert td.stats[key] == jd.stats[key], key
    assert td.live_count() == jd.live_count()
    check_invariants(td.state, tcfg)
    q = make_clustered(64, d=16, seed=11)
    rec = metrics.recall_at_k(td.search(q, 10).ids, td.exact(q, 10).ids)
    assert rec > 0.9, rec
    assert abs(small_frac(td, tcfg.l_min) - small_frac(jd, tcfg.l_min)) \
        <= 0.02
    snap = td.snapshot()
    assert snap.vectors.data_ptr() != td.state.vectors.data_ptr()
    assert torch.equal(snap.id_loc, td.state.id_loc)
    before = td.search(q, 10).ids
    td.delete(np.arange(10000, 10100))          # diverge, then restore
    td.load_snapshot(snap)
    np.testing.assert_array_equal(td.search(q, 10).ids, before)
    assert td.throughput()["tps"] > 0 and td.memory_bytes() > 0
