"""Initial index construction (SPANN-style, paper III-B1).

Seeds the posting pool with k-means centroids over a sample and wires
the centroid neighbourhood graph.  The vectors themselves are then
streamed through the production insert path by the driver.

The k-means initial indices are an argument: the JAX package draws them
with ``jax.random``, which no torch generator reproduces, so the driver
draws them from a ``torch.Generator`` and the parity tests pass the JAX
draw in.  Scoring here uses the plain version (a dense matmul; TF32 is
off package-wide), as the JAX package does with ``backend="ref"``.
"""
from __future__ import annotations

import torch

from ..kernels import ref
from .types import IndexState, UBISConfig, empty_state
from .update import alloc_postings

SAMPLE_CAP = 20000     # k-means sample: the first rows of the seed vectors
TARGET_FILL = 0.7      # seeded postings start at this share of l_max


def kmeans(points: torch.Tensor, k: int, iters: int,
           init_idx: torch.Tensor) -> torch.Tensor:
    """Plain Lloyd k-means from ``points[init_idx]``; empty clusters keep
    their previous centroid.  The centroid sums use ``index_add_``, whose
    float additions run in an unspecified order on a card (atomics): the
    result matches the JAX package to fp32 rounding, not bit for bit."""
    points = points.to(torch.float32)
    n, d = points.shape
    cents = points[init_idx.to(torch.int64)]
    for _ in range(iters):
        assign = torch.argmin(ref.centroid_score(points, cents), dim=-1)
        sums = torch.zeros((k, d), dtype=torch.float32, device=points.device)
        sums.index_add_(0, assign, points)
        counts = torch.zeros((k,), dtype=torch.float32, device=points.device)
        counts.index_add_(0, assign, torch.ones_like(assign,
                                                     dtype=torch.float32))
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def seed_postings(state: IndexState, cfg: UBISConfig, centroids_k, k: int):
    """Allocate ``k`` empty postings at the given centroids and wire the
    centroid neighbourhood graph (top-G nearest other centroids)."""
    state, pids = alloc_postings(state, cfg, k, centroids_k, 0)
    sc = ref.centroid_score(centroids_k, centroids_k)
    sc = sc + torch.eye(k, device=sc.device) * 1e30  # exclude self
    g = min(cfg.graph_degree, max(k - 1, 1))
    _, nn = ref.stable_topk(sc, g)
    rows = torch.full((k, cfg.graph_degree), -1, dtype=torch.int32,
                      device=sc.device)
    rows[:, :g] = pids[nn].to(torch.int32)
    state.nbrs[pids] = rows
    return state, pids


def initial_posting_count(cfg: UBISConfig, n: int) -> int:
    """How many postings ``initial_state`` seeds for ``n`` seed vectors."""
    return max(1, min(int(round(n / (TARGET_FILL * cfg.l_max))),
                      cfg.max_postings // 4))


def initial_state(cfg: UBISConfig, seed_vectors: torch.Tensor,
                  init_idx: torch.Tensor) -> IndexState:
    """Empty index on ``seed_vectors.device`` seeded with centroids fit on
    (a sample of) the data.  ``init_idx``: the k-means initial indices
    into the sample, ``initial_posting_count`` of them."""
    n = seed_vectors.shape[0]
    k0 = initial_posting_count(cfg, n)
    sample = seed_vectors[:SAMPLE_CAP].to(torch.float32)
    if init_idx.shape != (k0,):
        raise ValueError(f"init_idx: shape {tuple(init_idx.shape)}, "
                         f"expected ({k0},)")
    cents = kmeans(sample, k0, cfg.kmeans_iters, init_idx)
    state = empty_state(cfg, seed_vectors.device)
    state, _ = seed_postings(state, cfg, cents, k0)
    return state
