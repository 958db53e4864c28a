"""``correct`` comes out false for the control (the reference in TF32 in
the program's place) and for each fault a cell can have, planted under
the timed path; true for the program itself (test_ubis_bench_cells)."""
import numpy as np
import pytest

from conftest import run_small
from ubis_bench import faults
from ubis_bench.control import Tf32Index, tf32


def test_tf32_rounding_keeps_ten_bits():
    import torch
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -(1.0 + 3 * 2**-11), 3.0e38])
    got = tf32(x)
    assert got.tolist()[:4] == [1.0 + 2**-10, 1.0, 1.0 + 2**-9,
                                -(1.0 + 2**-9)]
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("cell", ["float-query", "pq16-query"])
def test_control_is_not_correct(cell):
    line = run_small(cell, index_factory=Tf32Index)
    assert line["checks"]["recall10"]["value"] >= 0.9
    assert (line["checks"]["score_err"]["value"]
            > line["checks"]["score_err"]["limit"])
    assert line["correct"] is False


def _patched(monkeypatch, fault):
    from ubis_bench import harness

    def factory(config, seeds, device, seed):
        idx = harness.program_index(config, seeds, device, seed)
        fault(monkeypatch, idx)
        return idx
    return factory


def _state_unchanged(monkeypatch, idx):
    """Updates that acknowledge everything and change nothing."""
    from repro_torch.api.types import UpdateResult
    loaded = {"done": False}
    insert, delete = idx.insert, idx.delete

    def lazy_insert(vecs, ids, **kw):
        if loaded["done"]:
            return UpdateResult(accepted=len(ids))
        return insert(vecs, ids, **kw)

    def lazy_delete(ids):
        loaded["done"] = True
        return UpdateResult(deleted=len(ids))
    monkeypatch.setattr(idx, "insert", lazy_insert)
    monkeypatch.setattr(idx, "delete", lazy_delete)


def _half_batch(monkeypatch, idx):
    """A search that answers the first half of the batch and copies those
    answers over the second half."""
    from repro_torch.core import search as search_mod
    real = search_mod.search

    def half(state, cfg, queries, k, nprobe=None):
        h = (queries.shape[0] + 1) // 2
        found, scores, probe = real(state, cfg, queries[:h], k, nprobe)
        rep = lambda t: t.repeat(2, *([1] * (t.dim() - 1)))[:queries.shape[0]]
        return rep(found), rep(scores), rep(probe)
    monkeypatch.setattr(search_mod, "search", half)


def _answer_altered(monkeypatch, idx):
    """A search whose best answer names the next id, with its score."""
    from repro_torch.core import search as search_mod
    real = search_mod.search

    def altered(state, cfg, queries, k, nprobe=None):
        found, scores, probe = real(state, cfg, queries, k, nprobe)
        found = found.clone()
        found[:, 0] += 1
        return found, scores, probe
    monkeypatch.setattr(search_mod, "search", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
@pytest.mark.parametrize("cell", ["float-query", "pq16-ingest"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    line = run_small(cell, seconds=2.0,
                     index_factory=_patched(monkeypatch, fault))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["float-query", "float-ingest",
                                  "pq16-query", "pq16-ingest"])
def test_lost_inserts_are_not_correct(cell):
    """5% of each window insert acknowledged and lost: the fresh ids'
    recall falls under its limit, whatever the deletes do."""
    # every query of a batch judged, so that some hundreds of fresh ids
    # are due even in a short window
    line = run_small(cell, seconds=3.0, traffic={"recall_sample": 48},
                     index_factory=faults.drop_inserts)
    fresh = line["checks"]["fresh_recall10"]
    assert line["checks"]["bad_ids"]["value"] == 0
    assert fresh["value"] < fresh["limit"], line["checks"]
    assert line["correct"] is False
