"""CUDA kernel: fused masked centroid scoring + top-k.

Replaces the Pallas TPU kernel ``repro/kernels/centroid_topk.py:
centroid_topk`` and its ``merge_topk`` running selection: search phase 1
(top-``nprobe`` postings per query) and the vector-cache scan.  No (Q, M)
score matrix is written.  Every k scores with ``masked_score``'s 3xTF32
products (the shared ``csrc/score_tile.cuh``), so a k = 64 answer's first
32 are the k = 32 answer, score bits included.  Up to k = 32 each list
lives in a warp's registers; a wider k (up to ``MAX_K``) takes the wide
path of the same source, which keeps each query row's list in shared
memory, cuts it back with a warp radix select, and merges the chunks'
lists in a second launch (:func:`wide_plan` sizes it).  The CUDA source is
``csrc/centroid_topk.cu``; its header note says what bounds it on the H100
and how the design answers.  The plain version is
:func:`repro_torch.kernels.ref.centroid_topk`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _nvcc
from .ref import centroid_topk as plain  # noqa: F401  (the plain version)

SOURCE = "src/repro_torch/csrc/centroid_topk.cu"
REPLACES = "src/repro/kernels/centroid_topk.py:102"
WARP_K = 32           # warp path: one list entry per lane
MAX_K = 1024          # wide path (csrc/topk_common.cuh: TOPK_BLOCK_MAX_K)
SMEM_MAX = 232448     # shared bytes a block may use on the H100
_BN = 128             # centroids a tile (csrc: score_tile::BN)
_TARGET_BLOCKS = 264  # two blocks per SM of an H100
_SMS = 132            # SMs of an H100
_SEL_N = 5120         # csrc/topk_select.cuh: block_select's n at most
_SEL_SCRATCH = 612    # csrc/topk_select.cuh: SEL_SCRATCH_INTS
#: the wide partial kernel's bytes before its lists, by query tile: the
#: warp path's copy ring, score tile and norms (csrc: Split<BQ>, (XN + BN)
#: floats)
_RING_BYTES = {16: 62720, 32: 69632}
_HIST_BYTES = 4 * 256 * 4   # a 256-bin histogram for each of 4 warps
launches = 0          # warp path
launches_wide = 0     # wide path


@functools.cache           # argtypes set once: the launch is on the hot path
def _lib(name: str):
    fn = getattr(_nvcc.load("centroid_topk"), name)
    if name == "centroid_topk_wide":   # + bq, cap; one uint64 scratch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 4)
    else:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def query_tile(Q: int) -> int:
    """The warp path's query tile (``csrc/centroid_topk.cu``): 32 rows for
    Q <= 32, else 64."""
    return 32 if Q <= 32 else 64


class WidePlan(NamedTuple):
    bq: int           # query rows a block
    chunk: int        # centroids a chunk (whole tiles)
    nchunks: int
    cap: int          # composites a row's list holds
    smem: int         # the partial kernel's shared bytes
    merge_smem: int   # the merge's


def _a16(n: int) -> int:
    return -(-n // 16) * 16


#: the lists' length at which two 16-row blocks share an SM (each within
#: 113 KB: the SM's 228 KB less 1 KB a block)
PAIR_CAP = 352


def list_cap(bq: int) -> int:
    """The composites each of ``bq`` row lists may hold beside the wide
    partial kernel's ring and histograms (a multiple of 32)."""
    room = SMEM_MAX - _RING_BYTES[bq] - _HIST_BYTES
    return room // (8 * bq) // 32 * 32


def _wide_launch(Q: int, M: int, k: int, bq: int, cap: int,
                 target: int) -> WidePlan:
    q_tiles = -(-Q // bq)
    want = max(1, min(target // q_tiles, M // k, -(-M // _BN)))
    chunk = -(-(-(-M // want)) // _BN) * _BN
    nchunks = -(-M // chunk)
    n = (nchunks - 1) * min(k, chunk) + min(k, M - (nchunks - 1) * chunk)
    n = min(n, _SEL_N)                   # the merge's window
    return WidePlan(
        bq, chunk, nchunks, cap,
        smem=_RING_BYTES[bq] + bq * cap * 8 + _HIST_BYTES,
        merge_smem=(_a16(8 * n) + _a16(4 * n) + 2 * _a16(8 * k)
                    + _a16(4 * _SEL_SCRATCH)))


def wide_plan(Q: int, M: int, k: int) -> WidePlan:
    """The wide path's launch (``csrc/centroid_topk.cu``: the partial
    kernel, one block per (query tile, chunk), then the merge, one block
    per query, over windows of 5,120 candidates).  The chunks are whole
    tiles of at least k centroids where M allows.  Two layouts, measured
    on the H100 (PERF.md): two blocks an SM (16-row query tiles, lists of
    ``PAIR_CAP``, about 264 blocks) where a list holds three times k plus
    a tile, or where a chunk is at most two tiles (one cut a list); else
    one block an SM (about 132 blocks) with the longest lists that fit,
    so that a list is cut less often: a 32-row query tile where its lists
    hold k plus a tile and the batch is past 32 queries, else 16 rows
    (more blocks at a small batch; room for k = 1024)."""
    pair = _wide_launch(Q, M, k, 16, PAIR_CAP, _TARGET_BLOCKS)
    if k + _BN <= PAIR_CAP and (pair.chunk <= 2 * _BN or
                                3 * k + _BN <= PAIR_CAP):
        return pair
    bq = 32 if Q > 32 and list_cap(32) >= k + _BN else 16
    return _wide_launch(Q, M, k, bq, list_cap(bq), _SMS)


def split_centroids(Q: int, M: int) -> tuple:
    """(chunk, nchunks): the warp path cuts the centroid axis into
    ``nchunks`` chunks of ``chunk`` centroids (whole tiles; the last chunk
    may be shorter), one block per (query tile, chunk), so that about two
    blocks per SM run even when the query batch is small (the wide path:
    :func:`wide_plan`)."""
    q_tiles = -(-Q // query_tile(Q))
    want = max(1, min(-(-M // _BN), -(-_TARGET_BLOCKS // q_tiles)))
    chunk = -(-M // want)
    chunk = -(-chunk // _BN) * _BN
    return chunk, -(-M // chunk)


def centroid_topk(q: torch.Tensor, c: torch.Tensor, vis: torch.Tensor,
                  k: int):
    """Kernel wrapper: (Q, d), (M, d), (M,) bool -> (scores (Q, k) fp32
    ascending, idx (Q, k) int32), ties lowest index first; masked
    centroids carry BIG.  Needs 1 <= k <= min(1024, M); k > 32 takes
    the wide path."""
    global launches, launches_wide
    Q, d = q.shape
    M = c.shape[0]
    dev = q.device
    _nvcc.require(q, "q", torch.float32, (Q, d))
    _nvcc.require(c, "c", torch.float32, (M, d), dev)
    _nvcc.require(vis, "vis", torch.bool, (M,), dev)
    if not 1 <= k <= min(MAX_K, M):
        raise ValueError(f"centroid_topk: k={k} outside "
                         f"[1, min({MAX_K}, M={M})]")
    if k > WARP_K:
        plan = wide_plan(max(Q, 1), M, k)
        chunk, nchunks = plan.chunk, plan.nchunks
        blocks = -(-Q // plan.bq) * nchunks
    else:
        chunk, nchunks = split_centroids(max(Q, 1), M)
        blocks = -(-Q // query_tile(Q)) * nchunks
    if M >= 2 ** 31 or blocks >= 2 ** 31:
        raise ValueError(f"centroid_topk: shape ({Q}, {M}) exceeds the grid")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    with _nvcc.on_device(dev):
        if k > WARP_K:
            part = torch.empty((Q, nchunks, k), dtype=torch.int64, device=dev)
            err = _lib("centroid_topk_wide")(
                q.data_ptr(), c.data_ptr(), vis.data_ptr(), Q, M, d, k,
                plan.bq, chunk, nchunks, plan.cap, part.data_ptr(),
                out_s.data_ptr(), out_i.data_ptr(), _nvcc.stream_ptr(dev))
        else:
            part_s = torch.empty((Q, nchunks, k), dtype=torch.float32,
                                 device=dev)
            part_i = torch.empty((Q, nchunks, k), dtype=torch.int32,
                                 device=dev)
            err = _lib("centroid_topk")(
                q.data_ptr(), c.data_ptr(), vis.data_ptr(), Q, M, d, k,
                chunk, nchunks, part_s.data_ptr(), part_i.data_ptr(),
                out_s.data_ptr(), out_i.data_ptr(), _nvcc.stream_ptr(dev))
    _nvcc.check(err, "centroid_topk")
    if k > WARP_K:
        launches_wide += 1
    else:
        launches += 1
    return out_s, out_i
