"""CUDA kernel: fused masked centroid scoring + top-k.

Replaces the Pallas TPU kernel ``repro/kernels/centroid_topk.py:
centroid_topk`` and its ``merge_topk`` running selection: search phase 1
(top-``nprobe`` postings per query) and the vector-cache scan.  No (Q, M)
score matrix is written.  The CUDA source is ``csrc/centroid_topk.cu``;
its header note says what bounds it on the H100 and how the design
answers.  The plain version is :func:`repro_torch.kernels.ref.centroid_topk`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from .ref import centroid_topk as plain  # noqa: F401  (the plain version)

SOURCE = "src/repro_torch/csrc/centroid_topk.cu"
REPLACES = "src/repro/kernels/centroid_topk.py:102"
MAX_K = 32            # one list entry per lane of a warp
_TM = 32              # centroids scored per step (csrc: CT_TM)
_BQ = 64              # queries per block (csrc: CT_BQ)
_TARGET_BLOCKS = 264  # two blocks per SM of an H100
launches = 0


def _lib():
    lib = _nvcc.load("centroid_topk")
    fn = lib.centroid_topk
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def split_centroids(Q: int, M: int) -> tuple:
    """(chunk, nchunks): the centroid axis is cut into chunks, one block
    per (query tile, chunk), so that about two blocks per SM run even
    when the query batch is small."""
    q_tiles = -(-Q // _BQ)
    want = max(1, min(-(-M // _TM), -(-_TARGET_BLOCKS // q_tiles)))
    chunk = -(-M // want)
    chunk = -(-chunk // _TM) * _TM
    return chunk, -(-M // chunk)


def centroid_topk(q: torch.Tensor, c: torch.Tensor, vis: torch.Tensor,
                  k: int):
    """Kernel wrapper: (Q, d), (M, d), (M,) bool -> (scores (Q, k) fp32
    ascending, idx (Q, k) int32), ties lowest index first; masked
    centroids carry BIG.  Needs 1 <= k <= min(32, M)."""
    global launches
    Q, d = q.shape
    M = c.shape[0]
    _nvcc.require(q, "q", torch.float32, (Q, d))
    _nvcc.require(c, "c", torch.float32, (M, d), q.device)
    _nvcc.require(vis, "vis", torch.bool, (M,), q.device)
    if not 1 <= k <= min(MAX_K, M):
        raise ValueError(f"centroid_topk: k={k} outside [1, min(32, M={M})]")
    if M >= 2 ** 31 or (Q + _BQ - 1) // _BQ > 65535:
        raise ValueError(f"centroid_topk: shape ({Q}, {M}) exceeds the grid")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    if Q == 0:
        return out_s, out_i
    chunk, nchunks = split_centroids(Q, M)
    part_s = torch.empty((Q, nchunks, k), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((Q, nchunks, k), dtype=torch.int32, device=q.device)
    err = _lib()(q.data_ptr(), c.data_ptr(), vis.data_ptr(), Q, M, d, k,
                 chunk, nchunks, part_s.data_ptr(), part_i.data_ptr(),
                 out_s.data_ptr(), out_i.data_ptr(),
                 _nvcc.stream_ptr(q.device))
    _nvcc.check(err, "centroid_topk")
    launches += 1
    return out_s, out_i
