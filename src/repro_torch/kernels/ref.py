"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth for one CUDA kernel: on a CPU
tensor ``ops`` routes here, and on the card ``chip_smoke.py`` holds each
kernel against its plain version on the same inputs.  They mirror the
JAX package's jnp oracles (``repro/kernels/ref.py``) function for
function.

Distance convention: scores are ``s(q, v) = ||v||^2 - 2 q.v``, which
order like squared L2 (``||q||^2`` is constant per query).

Tie order is part of the answer: the reference breaks every tie lowest
index first, as ``lax.top_k`` does.  PyTorch's own top-k does not
promise that order, so the only top-k in the port is :func:`stable_topk`,
a stable ascending sort and a slice.
"""
from __future__ import annotations

import torch

BIG = 1e30  # masked-score sentinel shared with the CUDA kernels


def stable_topk(scores: torch.Tensor, k: int):
    """The ``k`` smallest entries along the last axis, ascending, ties
    lowest index first.  Returns (values, int64 indices)."""
    s, i = torch.sort(scores, dim=-1, stable=True)
    return s[..., :k], i[..., :k]


def centroid_score(q: torch.Tensor, c: torch.Tensor,
                   vis: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, d), (M, d)[, (M,) bool] -> (Q, M) fp32 scores, BIG where
    ``vis`` is False."""
    q = q.float()
    c = c.float()
    cn = torch.sum(c * c, dim=-1)
    s = cn[None, :] - 2.0 * (q @ c.T)
    if vis is not None:
        s = torch.where(vis[None, :], s, BIG)
    return s


def posting_scan(q: torch.Tensor, tiles: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(Q, d), (G, C, d), (G, C) bool -> (Q, G*C) fp32 scores, BIG at
    invalid slots."""
    G, C, d = tiles.shape
    return centroid_score(q, tiles.reshape(G * C, d), valid.reshape(G * C))


def centroid_topk(q: torch.Tensor, c: torch.Tensor, vis: torch.Tensor,
                  k: int):
    """Masked centroid scores + top-k: (scores (Q, k) ascending,
    idx (Q, k) int32); masked centroids carry BIG."""
    s, i = stable_topk(centroid_score(q, c, vis), k)
    return s, i.to(torch.int32)


def posting_scan_topk(q: torch.Tensor, vectors: torch.Tensor,
                      valid: torch.Tensor, qp_ok: torch.Tensor,
                      probe: torch.Tensor, k: int):
    """Masked probe scan + top-k.

    q (Q, d); vectors (M, C, d); valid (M, C) bool (slot validity and
    posting visibility combined); qp_ok (Q, P); probe (Q, P).  Returns
    (scores (Q, k) ascending, cand (Q, k) int32 flat slot index
    ``probe*C + c``); ties break by position in the flattened (P, C)
    order."""
    q = q.float()
    probe = probe.long()
    tiles = vectors[probe].float()                        # (Q, P, C, d)
    Q, P, C, _ = tiles.shape
    vn = torch.sum(tiles * tiles, dim=-1)
    dots = torch.einsum("qd,qpcd->qpc", q, tiles)
    ok = valid[probe] & (qp_ok != 0)[:, :, None]
    s = torch.where(ok, vn - 2.0 * dots, BIG)
    top, pos = stable_topk(s.reshape(Q, P * C), k)
    cand_all = (probe[:, :, None] * C
                + torch.arange(C, device=q.device)[None, None, :])
    cand = torch.gather(cand_all.reshape(Q, P * C), 1, pos)
    return top, cand.to(torch.int32)
