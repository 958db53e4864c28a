"""The ``StreamingIndex`` contract harness, unedited, on the port's engines.

``contract_harness.run_program`` drives a seed-deterministic random
interleaving of insert / delete / search / tick / flush through an
engine while a pure-Python oracle tracks the live id -> vector multiset:
a recall@k floor against the engine's own ``exact()`` after every tick,
the live multiset at every flush, the trace audit (insert/delete events
against the live delta, tier commits against the stats), and with
``restore_fn`` a snapshot -> restore round trip.  The cases are those of
``tests/test_contract_properties.py``: every engine untiered at seed 0;
the tier-capable engines tiered (``TIER_KW``) at seeds 0, 1 and 2; every
engine through the port's ``QueuedIndex``; ``ubis`` queued and tiered.
``ubis-cluster`` (one worker on the ``LocalBackend``, every message
through the wire codec) runs every case of ``ENGINES``.  The JAX
package's own tiered ``ubis-sharded`` and ``ubis-cluster`` cases fail
here (jax's ``ShardingTypeError``, ROADMAP §3), so the port's tiered
sharded and cluster cases are held by the harness's own oracle: the
live multiset after every flush, recall against ``exact``, the trace
audit and the snapshot -> restore round trip.

The harness reads a snapshot as the JAX package's ``IndexState`` (its
``live_map`` runs the JAX ``unpack_status`` on it), so a thin adapter
hands it the port's snapshot in the checkpoint format
(``bridge.state_to_numpy``) and takes that format back in
``load_snapshot``.  The JAX random draws are injected in every case, so
each program runs the reference's own k-means seeds, codebook samples
and re-train keys.
"""
import types

import numpy as np
import pytest

from contract_harness import make_clustered, run_program
from repro_torch import bridge
from repro_torch.api import ENGINES, engine_spec, list_engines, make_index
from repro_torch.core.types import IndexState, UBISConfig
from repro_torch.distributed import make_mesh
from repro_torch.serving import QueuedIndex
from test_contract_properties import DIM, N_DATA, TIER_KW
from test_torch_pq import jax_draws

N_SEED = 300


def _cfg(**kw):
    base = dict(dim=DIM, max_postings=128, capacity=96, l_min=10,
                l_max=80, nprobe=128, max_ids=1 << 13, cache_capacity=2048)
    base.update(kw)
    return UBISConfig(**base)


class CheckpointView:
    """A port index whose ``snapshot()`` is numpy in the checkpoint
    format and whose ``load_snapshot`` takes that format back; every
    other attribute (``state``, ``obs``, ``cfg``, ...) is the index's."""

    def __init__(self, index):
        self.index = index

    def snapshot(self):
        snap = self.index.snapshot()
        if isinstance(snap, IndexState):
            return types.SimpleNamespace(**bridge.state_to_numpy(snap))
        return snap

    def load_snapshot(self, snap):
        self.index.load_snapshot(bridge.state_from_numpy(
            vars(snap), self.index.cfg, self.index.device))
        return self

    def __getattr__(self, name):
        return getattr(self.index, name)


def _build(engine, data, seed, cfg_kw=None, index_kw=None):
    cfg = _cfg(**(cfg_kw or {}))
    init, pq_init, keys = jax_draws(cfg, N_SEED, seed=seed)
    kw = dict(seed_ids=np.arange(N_SEED), round_size=256,
              bg_ops_per_round=8, insert_retries=4, seed=seed,
              max_nodes=1 << 13, beam=24, device="cpu", kmeans_init=init,
              pq_init=pq_init, pq_keys=keys, **(index_kw or {}))
    idx = CheckpointView(make_index(engine, cfg, data[:N_SEED], **kw))
    seed_ids = (np.arange(N_SEED)
                if engine_spec(engine).audit in ("static", "count")
                else None)
    return idx, seed_ids


def _run(engine, seed, cfg_kw=None, restore: bool = False,
         queued: bool = False, index_kw=None):
    data = make_clustered(N_DATA, d=DIM, k=10, seed=100 + seed)
    idx, seed_ids = _build(engine, data, seed, cfg_kw, index_kw)
    if queued:
        idx = QueuedIndex(idx)
    restore_fn = None
    if restore:
        def restore_fn(snap):
            idx2, _ = _build(engine, data, seed, cfg_kw, index_kw)
            idx2 = idx2.load_snapshot(snap)
            return QueuedIndex(idx2) if queued else idx2
    _, stats = run_program(engine, idx, data, seed, seed_ids=seed_ids,
                           restore_fn=restore_fn)
    return stats


@pytest.mark.parametrize("engine", ENGINES)
def test_contract_random_interleaving(engine):
    stats = _run(engine, seed=0)
    assert stats["inserted"] > 0


TIER_ENGINES = tuple(s.name for s in list_engines() if s.supports_tier)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("engine", TIER_ENGINES)
def test_contract_random_interleaving_tiered(engine, seed):
    stats = _run(engine, seed, cfg_kw=TIER_KW, restore=True)
    assert stats["inserted"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_contract_through_serving_queue(engine):
    stats = _run(engine, seed=0, queued=True)
    assert stats["inserted"] > 0


def test_contract_through_serving_queue_tiered():
    stats = _run("ubis", seed=0, cfg_kw=TIER_KW, restore=True, queued=True)
    assert stats["inserted"] > 0


def _four_shards():
    return dict(mesh=make_mesh((1, 4), ("data", "model"), device="cpu"))


def test_contract_sharded_four_shards():
    stats = _run("ubis-sharded", seed=0, index_kw=_four_shards())
    assert stats["inserted"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contract_sharded_four_shards_tiered(seed):
    stats = _run("ubis-sharded", seed, cfg_kw=TIER_KW, restore=True,
                 index_kw=_four_shards())
    assert stats["inserted"] > 0


def test_contract_sharded_four_shards_through_serving_queue():
    stats = _run("ubis-sharded", seed=0, queued=True,
                 index_kw=_four_shards())
    assert stats["inserted"] > 0
