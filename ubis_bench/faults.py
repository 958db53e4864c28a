"""Faults planted under the timed path, to show that ``correct`` sees them.

Each is an index factory with the harness's signature (``config,
seed_vectors, device, seed``): the program's index with one guarantee
broken.  ``control.py`` reads them on the chip at a cell's own size and
``tests/test_ubis_bench_control.py`` at a small one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: share of each window insert that ``drop_inserts`` loses
DROP_SHARE = 0.05


def drop_inserts(config: dict, seed_vectors, device, seed: int,
                 share: float = DROP_SHARE):
    """The program's index, which once the load is done (its first
    delete) acknowledges every insert and stores all but ``share`` of
    it: the rows whose id falls in the first ``share`` of each run of
    ``round(1 / share)`` ids."""
    from .harness import program_index
    idx = program_index(config, seed_vectors, device, seed)
    every = int(round(1.0 / share))
    insert, delete = idx.insert, idx.delete
    loaded = {"done": False}

    def lossy_insert(vecs, ids, **kw):
        if not loaded["done"]:
            return insert(vecs, ids, **kw)
        ids = np.asarray(ids)
        keep = ids % every != 0
        r = insert(np.asarray(vecs)[keep], ids[keep], **kw)
        return dataclasses.replace(
            r, accepted=r.accepted + int((~keep).sum()))

    def marking_delete(ids):
        loaded["done"] = True
        return delete(ids)
    idx.insert, idx.delete = lossy_insert, marking_delete
    return idx
