"""CUDA kernels over posting tiles: the full masked scan and the fused
probe scan + top-k.

* ``posting_scan`` replaces the Pallas TPU kernel
  ``repro/kernels/posting_scan.py:posting_scan``: every slot of the pool
  scored against a query block, BIG at invalid slots — the exact
  (``brute_force``) oracle.  It runs ``csrc/masked_score.cu`` over the
  tiles viewed as (G*C, d), the same function as ``centroid_score``.
* ``posting_scan_topk`` replaces ``repro/kernels/posting_scan.py:
  posting_scan_topk``: search phase 2, a running top-k over the probed
  tiles, source ``csrc/posting_scan_topk.cu``.

Each source's header note says what bounds it on the H100 and how the
design answers.  The plain versions are
:func:`repro_torch.kernels.ref.posting_scan` and
:func:`repro_torch.kernels.ref.posting_scan_topk`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from .centroid_score import masked_score
from .ref import posting_scan as plain  # noqa: F401  (the plain version)
from .ref import posting_scan_topk as plain_topk  # noqa: F401

SOURCE = "src/repro_torch/csrc/masked_score.cu"
REPLACES = "src/repro/kernels/posting_scan.py:57"
SOURCE_TOPK = "src/repro_torch/csrc/posting_scan_topk.cu"
REPLACES_TOPK = "src/repro/kernels/posting_scan.py:208"
MAX_K = 32
launches = 0
launches_topk = 0


def posting_scan(q: torch.Tensor, tiles: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: (Q, d), (G, C, d), (G, C) bool -> (Q, G*C) fp32
    scores, BIG at invalid slots."""
    global launches
    G, C, d = tiles.shape
    _nvcc.require(tiles, "tiles", torch.float32, (G, C, d))
    _nvcc.require(valid, "valid", torch.bool, (G, C), tiles.device)
    out = masked_score(q, tiles.view(G * C, d), valid.view(G * C),
                       "posting_scan")
    if out.numel():
        launches += 1
    return out


def _lib_topk():
    lib = _nvcc.load("posting_scan_topk")
    fn = lib.posting_scan_topk
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def posting_scan_topk(q: torch.Tensor, vectors: torch.Tensor,
                      valid: torch.Tensor, qp_ok: torch.Tensor,
                      probe: torch.Tensor, k: int):
    """Kernel wrapper: q (Q, d), vectors (M, C, d) fp32, valid (M, C)
    bool, qp_ok and probe (Q, P) int32 -> (scores (Q, k) ascending,
    cand (Q, k) int32 = probe*C + c); ties by position p*C + c.
    Needs 1 <= k <= min(32, P*C)."""
    global launches_topk
    Q, d = q.shape
    M, C, _ = vectors.shape
    P = probe.shape[1]
    dev = q.device
    _nvcc.require(q, "q", torch.float32, (Q, d))
    _nvcc.require(vectors, "vectors", torch.float32, (M, C, d), dev)
    _nvcc.require(valid, "valid", torch.bool, (M, C), dev)
    _nvcc.require(qp_ok, "qp_ok", torch.int32, (Q, P), dev)
    _nvcc.require(probe, "probe", torch.int32, (Q, P), dev)
    if not 1 <= k <= min(MAX_K, P * C):
        raise ValueError(f"posting_scan_topk: k={k} outside "
                         f"[1, min(32, P*C={P * C})]")
    if M * C >= 2 ** 31 or P * C >= 2 ** 31:
        raise ValueError("posting_scan_topk: pool exceeds int32 slot ids")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    err = _lib_topk()(q.data_ptr(), vectors.data_ptr(), valid.data_ptr(),
                      qp_ok.data_ptr(), probe.data_ptr(), Q, M, C, d, P, k,
                      out_s.data_ptr(), out_i.data_ptr(),
                      _nvcc.stream_ptr(dev))
    _nvcc.check(err, "posting_scan_topk")
    launches_topk += 1
    return out_s, out_i
