"""The least time the H100 could take for a search batch's work.

The idea of ``benchmarks/roofline.py`` at commit bd85f0a (operations
and bytes from the shapes, against the chip's peaks), and the bound
``chip_smoke.py`` gives its kernel table, with the published peaks of one
NVIDIA H100 SXM (the data sheet's dense rates, at its 700 W limit) and
the search's own work, counted whatever kernels implement it:

* products at fp32 accuracy against 495 / 3 = 165 TFLOP/s, the 3xTF32
  rate (three TF32 products a fp32 one), the fastest fp32-accurate
  product the card has; the port keeps TF32 off, so no correct
  implementation computes them faster;
* other arithmetic against the 67 TFLOP/s of fp32 outside the tensor
  cores;
* bytes against 3.35 TB/s, each input byte read once.

A batch's least time is the largest of the three terms, over the work
summed over the batches: the phases could overlap across batches, so a
sum of per-phase bounds could be beaten.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PEAK_TF32 = 495e12
PEAK_PRODUCT = PEAK_TF32 / 3.0      # 3xTF32: fp32-accurate products
PEAK_FP32 = 67e12                   # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12                # HBM3


@dataclasses.dataclass
class Work:
    """Operations and bytes: ``products`` (multiply-adds counted as two),
    ``other`` (fp32 arithmetic off the tensor cores), ``bytes``."""

    products: float = 0.0
    other: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.products + o.products, self.other + o.other,
                    self.bytes + o.bytes)

    def seconds(self) -> float:
        return max(self.products / PEAK_PRODUCT, self.other / PEAK_FP32,
                   self.bytes / PEAK_BYTES)


def scores(Q: int, M: int, d: int) -> Work:
    """Scores of Q queries against M rows (phase 1 over every centroid,
    or the cache scan): the products and the rows' norms; the rows and
    the queries read once."""
    return Work(products=2.0 * Q * M * d + 2.0 * M * d,
                bytes=4.0 * (Q * d + M * d))


def float_scan(Q: int, P: int, C: int, d: int, tiles: int) -> Work:
    """Phase 2 on the float plane: each query against the C slots of its
    P probed tiles; the ``tiles`` distinct tiles read once (vectors, ids
    and slot flags)."""
    return Work(products=2.0 * Q * P * C * d + 2.0 * tiles * C * d,
                bytes=tiles * C * (4.0 * d + 4.0 + 1.0))


def pq_scan(Q: int, P: int, C: int, d: int, m: int, ksub: int,
            versions: int, tiles: int, R: int, rows: int) -> Work:
    """Phase 2 on the quant plane: the lookup tables (each query against
    every codebook's centroids), the ADC sums over the probed slots, the
    distinct code tiles read once, then the exact rerank of R candidates
    a query; of the reranked rows only the ``rows`` distinct ones
    returned are counted as read (a lower bound: the candidates are not
    returned)."""
    return Work(products=2.0 * Q * versions * ksub * d + 2.0 * Q * R * d,
                other=1.0 * Q * P * C * m,
                bytes=(tiles * C * (1.0 * m + 4.0 + 1.0)
                       + 4.0 * versions * ksub * d + 4.0 * rows * d))


def search_batch(index: dict, Q: int, probe: np.ndarray,
                 ids: np.ndarray) -> Work:
    """The work of one search batch of ``Q`` queries on an index of the
    configuration ``index`` (UBISConfig's fields), from the probe lists
    ``probe`` (Q, P) and the answer ``ids`` (Q, k) it returned."""
    d, M, C = index["dim"], index["max_postings"], index["capacity"]
    P = probe.shape[1]
    tiles = int(np.unique(probe[probe >= 0]).size)
    work = scores(Q, M, d) + scores(Q, index["cache_capacity"], d)
    if index.get("use_pq"):
        rows = int(np.unique(ids[ids >= 0]).size)
        work = work + pq_scan(Q, P, C, d, index["pq_m"], index["pq_ksub"],
                              index.get("pq_versions", 2), tiles,
                              min(index["rerank_k"], P * C), rows)
    else:
        work = work + float_scan(Q, P, C, d, tiles)
    return work
