"""Vector workloads for the UBIS experiments (paper Section V-A).

Two dataset kinds, mirroring the paper's two families:

* ``DriftingVectorStream`` — the Argoverse2 analogue: timestamped
  vectors whose underlying mixture *drifts* over time (cluster centres
  random-walk and new clusters are born), so later batches shift the
  centroid distribution exactly the way streaming trajectories do.
  Vectors arrive in timestamp order.

* ``StaticVectorSet`` — the SIFT/Cohere/GLOVE analogue: a fixed
  Gaussian-mixture set; the update order is simulated (paper: sorted by
  a Gaussian draw), so batches are near-uniform over the space.

A copy of the JAX package's ``repro/data/vectors.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DriftingVectorStream:
    dim: int = 64
    n_clusters: int = 32
    drift: float = 0.35          # per-batch random-walk step of centres
    birth_rate: float = 0.05     # chance a cluster teleports (new region)
    spread: float = 1.0
    scale: float = 8.0
    seed: int = 0
    cursor: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._centres = rng.normal(size=(self.n_clusters, self.dim)) \
            * self.scale

    def next_batch(self, n: int):
        rng = np.random.default_rng((self.seed, 7, self.cursor))
        # drift
        self._centres += rng.normal(
            size=self._centres.shape) * self.drift
        reborn = rng.random(self.n_clusters) < self.birth_rate
        self._centres[reborn] = rng.normal(
            size=(int(reborn.sum()), self.dim)) * self.scale
        a = rng.integers(0, self.n_clusters, n)
        x = self._centres[a] + rng.normal(size=(n, self.dim)) * self.spread
        self.cursor += 1
        return x.astype(np.float32)

    def queries(self, n: int, seed: int = 999):
        rng = np.random.default_rng((self.seed, seed))
        a = rng.integers(0, self.n_clusters, n)
        x = self._centres[a] + rng.normal(size=(n, self.dim)) * self.spread
        return x.astype(np.float32)


@dataclasses.dataclass
class StaticVectorSet:
    n: int = 100_000
    dim: int = 64
    n_clusters: int = 64
    scale: float = 8.0
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._centres = rng.normal(size=(self.n_clusters, self.dim)) \
            * self.scale
        a = rng.integers(0, self.n_clusters, self.n)
        self.vectors = (self._centres[a] + rng.normal(
            size=(self.n, self.dim))).astype(np.float32)
        # simulated update order (paper: Gaussian-sorted -> near-uniform
        # batch sizes); equivalent to a fixed random permutation
        self.order = np.argsort(rng.normal(size=self.n))

    def batches(self, n_batches: int):
        per = self.n // n_batches
        for i in range(n_batches):
            idx = self.order[i * per:(i + 1) * per]
            yield idx.astype(np.int64), self.vectors[idx]

    def queries(self, nq: int, seed: int = 999):
        rng = np.random.default_rng((self.seed, seed))
        a = rng.integers(0, self.n_clusters, nq)
        return (self._centres[a] + rng.normal(
            size=(nq, self.dim))).astype(np.float32)


def make_queries(centres: np.ndarray, nq: int, spread: float = 1.0,
                 seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(centres), nq)
    return (centres[a] + rng.normal(size=(nq, centres.shape[1]))
            * spread).astype(np.float32)
