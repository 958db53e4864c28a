"""Initial index construction (SPANN-style, paper III-B1).

Seeds the posting pool with k-means centroids over a sample and wires
the centroid neighbourhood graph.  The vectors themselves are then
streamed through the production insert path by the driver.

The k-means initial indices (and, with ``use_pq``, the generation-0
codebook sample) are arguments: the JAX package draws them with
``jax.random``, which no torch generator reproduces, so the driver draws
them from a ``torch.Generator`` and the parity tests pass the JAX draw
in.  The centroid k-means scores with the plain version (a dense matmul;
TF32 is off package-wide), as the JAX package does with
``backend="ref"``; the codebook fit runs ``kmeans_assign``, a kernel on
the card, as the JAX package's ``init_codebooks(backend=cfg.use_pallas)``
does on the TPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ref
from ..quant import pq
from .types import IndexState, UBISConfig, empty_state
from .update import alloc_postings

SAMPLE_CAP = 20000     # k-means sample: the first rows of the seed vectors
TARGET_FILL = 0.7      # seeded postings start at this share of l_max


def cluster_means(rows: torch.Tensor, assign: torch.Tensor, k: int):
    """(means, counts) of the ``rows`` (host float32) of each of ``k``
    clusters by ``assign`` (any device): one ``index_add_`` on the host,
    in row order.  A card's ``index_add_`` adds floats in no fixed order
    (atomics), so two runs on a card could build indexes that differ in a
    centroid's last bit and then in every later decision; on the host a
    run on the card computes the CPU run's sums bit for bit (a worker's
    replay and two clusters on the same stream build the same index)."""
    a = assign.to("cpu", torch.int64)
    sums = torch.zeros((k,) + rows.shape[1:], dtype=torch.float32)
    sums.index_add_(0, a, rows)
    counts = torch.zeros((k,), dtype=torch.float32)
    counts.index_add_(0, a, torch.ones((a.shape[0],), dtype=torch.float32))
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


def kmeans(points: torch.Tensor, k: int, iters: int,
           init_idx: torch.Tensor) -> torch.Tensor:
    """Plain Lloyd k-means from ``points[init_idx]``; empty clusters keep
    their previous centroid.  The assignment runs on the points' device,
    the centroid sums on the host (``cluster_means``)."""
    points = points.to(torch.float32)
    host = points.cpu()
    cents = points[init_idx.to(torch.int64)]
    for _ in range(iters):
        assign = torch.argmin(ref.centroid_score(points, cents), dim=-1)
        new, counts = cluster_means(host, assign, k)
        cents = torch.where(counts[:, None].to(cents.device) > 0,
                            new.to(cents.device), cents)
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
                  init_idx: torch.Tensor,
                  pq_init_idx: Optional[torch.Tensor] = None) -> IndexState:
    """Empty index on ``seed_vectors.device`` seeded with centroids fit on
    (a sample of) the data.  ``init_idx``: the k-means initial indices
    into the sample, ``initial_posting_count`` of them.  With ``use_pq``,
    ``pq_init_idx``: the ``pq_ksub`` sample rows that warm-start the
    generation-0 codebooks, fit on the same sample."""
    n = seed_vectors.shape[0]
    k0 = initial_posting_count(cfg, n)
    sample = seed_vectors[:SAMPLE_CAP].to(torch.float32)
    if init_idx.shape != (k0,):
        raise ValueError(f"init_idx: shape {tuple(init_idx.shape)}, "
                         f"expected ({k0},)")
    cents = kmeans(sample, k0, cfg.kmeans_iters, init_idx)
    state = empty_state(cfg, seed_vectors.device)
    state, _ = seed_postings(state, cfg, cents, k0)
    if cfg.use_pq:
        if pq_init_idx is None or pq_init_idx.shape != (cfg.pq_ksub,):
            raise ValueError(f"pq_init_idx: expected ({cfg.pq_ksub},) "
                             "sample rows with use_pq")
        state.pq_codebooks[0] = pq.init_codebooks(
            sample, cfg.pq_m, cfg.pq_ksub, cfg.kmeans_iters, pq_init_idx)
    return state
