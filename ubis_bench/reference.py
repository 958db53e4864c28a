"""The plain reference that decides ``correct``.

It imports nothing of the program: it reads the stream the harness made
from the seed (row = id), its own record of which ids were live at each
search, and the answers the timed path returned, and judges them in
float64 on the run's device, in blocks of queries, once the program's
state is freed.  The numbers it compares, each against a limit of the
configuration's file (``limits``):

* ``recall10``: mean recall@10 of the sampled queries against the exact
  top-10 over the live set at that search (``recall_at_k`` below);
* ``fresh_recall10``: the same, over only those entries of the exact
  top-10 whose ids the window itself inserted (acknowledged, and so
  searchable from the next search on): an index that acknowledges
  inserts and loses some reads low here however few the fresh ids are
  among the live set;
* ``score_err``: the widest gap, over every sampled answer, between the
  returned score plus ``||q||^2`` and the exact squared distance of the
  returned id, over ``||q||^2 + ||v||^2`` (fp32's scale of the sum);
* ``bad_ids``: over every answer of every batch, ids that were not live
  when the batch was dispatched, or that appear twice in one answer;
* ``lost_batches``: batches that raised or returned no answer.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_FLOATS = 1 << 28       # fp64 score block: 2 GiB a block


def recall_at_k(found_ids, true_ids) -> float:
    """Mean |found ∩ truth| / |truth| over the query batch (recall k@k).
    -1 entries (padding / missing) never count as hits.

    A frozen copy of ``repro_torch/core/metrics.py``'s ``recall_at_k``
    (commit bd85f0a)."""
    found_ids = np.asarray(found_ids)
    true_ids = np.asarray(true_ids)
    hits = 0
    total = 0
    for f, t in zip(found_ids, true_ids):
        t = set(int(x) for x in t if x >= 0)
        if not t:
            continue
        f = set(int(x) for x in f if x >= 0)
        hits += len(f & t)
        total += len(t)
    return hits / total if total else 1.0


def fresh_recall(found_ids, true_ids, fresh_from: int):
    """Hits over the entries of ``true_ids`` that are ``>= fresh_from``:
    (hits, total)."""
    found_ids = np.asarray(found_ids)
    true_ids = np.asarray(true_ids)
    fresh = true_ids >= fresh_from
    hit = (true_ids[:, :, None] == found_ids[:, None, :]).any(-1)
    return int((hit & fresh).sum()), int(fresh.sum())


def exact_topk(base: torch.Tensor, lo: int, q: torch.Tensor, k: int):
    """Ids (``lo`` + row) of the ``k`` nearest rows of ``base`` to each
    query, by float64 squared L2 distance, and those distances."""
    bn = (base * base).sum(1)
    qn = (q * q).sum(1)
    block = max(1, BLOCK_FLOATS // max(1, base.shape[0]))
    ids, dist = [], []
    for off in range(0, q.shape[0], block):
        qb = q[off:off + block]
        d = torch.addmm(bn[None], qb, base.T, alpha=-2.0)
        d += qn[off:off + block, None]
        top, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ids.append(idx + lo)
        dist.append(top)
        del d
    return torch.cat(ids).cpu().numpy(), torch.cat(dist).cpu().numpy()


def bad_id_count(ids: np.ndarray, lo: int, hi: int) -> int:
    """Entries of one batch's answer (Q, k) that name an id outside the
    live range [lo, hi), or an id already named earlier in its row."""
    real = ids >= 0
    stale = int((real & ((ids < lo) | (ids >= hi))).sum())
    srt = np.sort(np.where(real, ids, -1 - np.arange(ids.shape[1])), axis=1)
    dup = int(((np.diff(srt, axis=1) == 0) & (srt[:, 1:] >= 0)).sum())
    return stale + dup


def judge(vectors: np.ndarray, queries: np.ndarray, searches: list, k: int,
          device, fresh_from: int) -> dict:
    """The compared numbers of one run.  ``searches``: one dict a batch
    with ``lo``, ``hi`` (the live id range at dispatch), ``qset`` (which
    pool batch), ``sample`` (query rows to hold against the exact
    answer), ``ids`` and ``scores`` (the answer, or None if lost).
    ``fresh_from``: the first id the window inserted."""
    dev = torch.device(device)
    lost = sum(1 for b in searches if b["ids"] is None)
    top = max((b["hi"] for b in searches), default=0)
    stream = torch.as_tensor(vectors[:top], device=dev)  # float32, row = id
    bad = sum(bad_id_count(b["ids"], b["lo"], b["hi"])
              for b in searches if b["ids"] is not None)
    # group the sampled queries by live range: one exact pass a range
    groups: dict = {}
    for b in searches:
        if b["ids"] is not None and len(b["sample"]):
            groups.setdefault((b["lo"], b["hi"]), []).append(b)
    found, truth, err, fresh_hits, fresh_total = [], [], 0.0, 0, 0
    for (lo, hi), batch in groups.items():
        base = stream[lo:hi].to(torch.float64)
        q = np.concatenate([queries[b["qset"]][b["sample"]] for b in batch])
        got = np.concatenate([b["ids"][b["sample"]] for b in batch])
        got_s = np.concatenate([b["scores"][b["sample"]] for b in batch])
        qd = torch.as_tensor(q, device=dev, dtype=torch.float64)
        t_ids, _ = exact_topk(base, lo, qd, k)
        found.append(got)
        truth.append(t_ids)
        h, n = fresh_recall(got, t_ids, fresh_from)
        fresh_hits, fresh_total = fresh_hits + h, fresh_total + n
        # the returned score of each real answer against its exact value
        rows = torch.as_tensor(np.clip(got, lo, hi - 1) - lo, device=dev,
                               dtype=torch.int64)
        v = base[rows]                                     # (B, k, d)
        qn = (qd * qd).sum(1)[:, None]
        vn = (v * v).sum(-1)
        exact = ((v - qd[:, None]) ** 2).sum(-1)
        gap = (torch.as_tensor(got_s, device=dev, dtype=torch.float64)
               + qn - exact).abs() / (qn + vn)
        ok = torch.as_tensor((got >= lo) & (got < hi), device=dev)
        if ok.any():
            err = max(err, float(gap[ok].max()))
        del base, qd, v
    del stream
    recall = (recall_at_k(np.concatenate(found), np.concatenate(truth))
              if found else 0.0)
    return {"recall10": recall,
            "fresh_recall10": (fresh_hits / fresh_total if fresh_total
                               else 1.0),      # as recall_at_k: none due
            "score_err": err, "bad_ids": bad, "lost_batches": lost}


#: how each compared number meets its limit
AT_LEAST = ("recall10", "fresh_recall10")


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every compared number is within its limit."""
    for name, value in numbers.items():
        limit = limits[name]
        if name in AT_LEAST:
            if not value >= limit:
                return False
        elif not value <= limit:
            return False
    return True
