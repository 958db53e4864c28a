"""CUDA kernel: fused masked centroid scoring + top-k.

Replaces the Pallas TPU kernel ``repro/kernels/centroid_topk.py:
centroid_topk`` and its ``merge_topk`` running selection: search phase 1
(top-``nprobe`` postings per query) and the vector-cache scan.  No (Q, M)
score matrix is written.  Up to k = 32 the scores are ``masked_score``'s
3xTF32 products (the shared ``csrc/score_tile.cuh``), ranked in a shared
score tile with each list in a warp's registers; a wider k (up to
``MAX_K``) takes the block-wide path of the same source, which keeps the
list in shared memory.  The CUDA source is ``csrc/centroid_topk.cu``;
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
WARP_K = 32           # warp path: one list entry per lane
MAX_K = 1024          # block-wide path (csrc/topk_common.cuh)
_BN = 128             # centroids a tile of the warp path (csrc: score_tile::BN)
_TW = 256             # centroids per round of the wide path (CTW_THREADS)
_TARGET_BLOCKS = 264  # two blocks per SM of an H100
launches = 0


def _lib(name: str):
    fn = getattr(_nvcc.load("centroid_topk"), name)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def query_tile(Q: int) -> int:
    """The warp path's query tile (``csrc/centroid_topk.cu``): 32 rows for
    Q <= 32, else 64."""
    return 32 if Q <= 32 else 64


def split_centroids(Q: int, M: int, wide: bool = False) -> tuple:
    """(chunk, nchunks): the centroid axis is cut into ``nchunks`` chunks
    of ``chunk`` centroids (whole tiles; the last chunk may be shorter),
    one block per (query tile, chunk), so that about two blocks per SM
    run even when the query batch is small.  The wide path's query tile
    is one query."""
    tile, step = (1, _TW) if wide else (query_tile(Q), _BN)
    q_tiles = -(-Q // tile)
    want = max(1, min(-(-M // step), -(-_TARGET_BLOCKS // q_tiles)))
    chunk = -(-M // want)
    chunk = -(-chunk // step) * step
    return chunk, -(-M // chunk)


def centroid_topk(q: torch.Tensor, c: torch.Tensor, vis: torch.Tensor,
                  k: int):
    """Kernel wrapper: (Q, d), (M, d), (M,) bool -> (scores (Q, k) fp32
    ascending, idx (Q, k) int32), ties lowest index first; masked
    centroids carry BIG.  Needs 1 <= k <= min(1024, M); k > 32 takes
    the block-wide path."""
    global launches
    Q, d = q.shape
    M = c.shape[0]
    _nvcc.require(q, "q", torch.float32, (Q, d))
    _nvcc.require(c, "c", torch.float32, (M, d), q.device)
    _nvcc.require(vis, "vis", torch.bool, (M,), q.device)
    if not 1 <= k <= min(MAX_K, M):
        raise ValueError(f"centroid_topk: k={k} outside "
                         f"[1, min({MAX_K}, M={M})]")
    wide = k > WARP_K
    chunk, nchunks = split_centroids(max(Q, 1), M, wide)
    blocks = Q if wide else -(-Q // query_tile(Q)) * nchunks
    if M >= 2 ** 31 or blocks > (65535 if wide else 2 ** 31 - 1):
        raise ValueError(f"centroid_topk: shape ({Q}, {M}) exceeds the grid")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    if Q == 0:
        return out_s, out_i
    part_s = torch.empty((Q, nchunks, k), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((Q, nchunks, k), dtype=torch.int32, device=q.device)
    with _nvcc.on_device(q.device):
        err = _lib("centroid_topk_wide" if wide else "centroid_topk")(
            q.data_ptr(), c.data_ptr(), vis.data_ptr(), Q, M, d, k, chunk,
            nchunks, part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), _nvcc.stream_ptr(q.device))
    _nvcc.check(err, "centroid_topk")
    launches += 1
    return out_s, out_i
