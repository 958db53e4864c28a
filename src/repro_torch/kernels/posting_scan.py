"""CUDA kernels over posting tiles: the full masked scan, the probe scan
and the fused probe scan + top-k.

* ``posting_scan`` replaces the Pallas TPU kernel
  ``repro/kernels/posting_scan.py:posting_scan``: every slot of the pool
  scored against a query block, BIG at invalid slots — the exact
  (``brute_force``) oracle.  It runs ``csrc/masked_score.cu`` over the
  tiles viewed as (G*C, d), the same function as ``centroid_score``.
* ``posting_scan_gather`` replaces ``repro/kernels/posting_scan.py:
  posting_scan_gather``: every slot of each query's probed tiles, the
  unfused (Q, P, C) scores that the fused search is held against, tile by
  tile (the (query, probe) pairs grouped by posting, so each distinct
  probed tile is read once), source ``csrc/posting_scan_gather.cu``.
* ``posting_scan_topk`` replaces ``repro/kernels/posting_scan.py:
  posting_scan_topk``: search phase 2, a running top-k over the probed
  tiles (staged by Hopper's bulk copy; at a small batch each query's
  probes split across blocks, :func:`split_probes`), source
  ``csrc/posting_scan_topk.cu``.

Each source's header note says what bounds it on the H100 and how the
design answers.  The plain versions are
:func:`repro_torch.kernels.ref.posting_scan`,
:func:`repro_torch.kernels.ref.posting_scan_gather` and
:func:`repro_torch.kernels.ref.posting_scan_topk`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from .centroid_score import masked_score
from .ref import posting_scan as plain  # noqa: F401  (the plain version)
from .ref import posting_scan_gather as plain_gather  # noqa: F401
from .ref import posting_scan_topk as plain_topk  # noqa: F401

SOURCE = "src/repro_torch/csrc/masked_score.cu"
REPLACES = "src/repro/kernels/posting_scan.py:57"
SOURCE_GATHER = "src/repro_torch/csrc/posting_scan_gather.cu"
REPLACES_GATHER = "src/repro/kernels/posting_scan.py:118"
SOURCE_TOPK = "src/repro_torch/csrc/posting_scan_topk.cu"
REPLACES_TOPK = "src/repro/kernels/posting_scan.py:208"
WARP_K = 32           # warp path: one list entry per lane
MAX_K = 1024          # block-wide path (csrc/topk_common.cuh)
MAX_D = 16384         # the warp path's q row and two one-row stages
MAX_D_GATHER = 12288  # csrc/row_score.cuh: PS_UNIT_FLOATS, one row a unit
_TARGET_BLOCKS = 264  # two blocks per SM of an H100
launches = 0
launches_gather = 0
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


_gather = None


def _lib_gather():
    global _gather
    if _gather is None:             # argtypes once: every call pays for it
        lib = _nvcc.load("posting_scan_gather")
        fn = lib.posting_scan_gather
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        ints = lib.posting_scan_gather_scratch
        ints.argtypes = [ctypes.c_longlong]
        ints.restype = ctypes.c_longlong
        _gather = fn, ints
    return _gather


def posting_scan_gather(q: torch.Tensor, vectors: torch.Tensor,
                        slot_valid: torch.Tensor, vis: torch.Tensor,
                        probe: torch.Tensor):
    """Kernel wrapper: q (Q, d) fp32, vectors (M, C, d) fp32, slot_valid
    (M, C) and vis (M,) bool, probe (Q, P) int32 with entries in [0, M)
    -> (Q, P, C) fp32 scores, BIG where ``slot_valid`` or the posting's
    ``vis`` is False.  Needs d <= 12,288 and 5*Q*P + 4 < 2^31."""
    global launches_gather
    Q, d = q.shape
    M, C, _ = vectors.shape
    P = probe.shape[1]
    dev = q.device
    _nvcc.require(q, "q", torch.float32, (Q, d))
    _nvcc.require(vectors, "vectors", torch.float32, (M, C, d), dev)
    _nvcc.require(slot_valid, "slot_valid", torch.bool, (M, C), dev)
    _nvcc.require(vis, "vis", torch.bool, (M,), dev)
    _nvcc.require(probe, "probe", torch.int32, (Q, P), dev)
    if d > MAX_D_GATHER:
        raise ValueError(f"posting_scan_gather: d={d} exceeds "
                         f"{MAX_D_GATHER}, a row of one staged unit")
    if 5 * Q * P + 4 >= 2 ** 31:
        raise ValueError("posting_scan_gather: Q*P exceeds its int32 "
                         "scratch")
    out = torch.empty((Q, P, C), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if M == 0:
        raise ValueError("posting_scan_gather: probes into an empty pool")
    fn, scratch_ints = _lib_gather()
    scratch = torch.empty(scratch_ints(Q * P), dtype=torch.int32, device=dev)
    with _nvcc.on_device(dev):
        err = fn(q.data_ptr(), vectors.data_ptr(), slot_valid.data_ptr(),
                 vis.data_ptr(), probe.data_ptr(), Q, M, C, d, P,
                 scratch.data_ptr(), out.data_ptr(), _nvcc.stream_ptr(dev))
    _nvcc.check(err, "posting_scan_gather")
    launches_gather += 1
    return out


def _lib_topk(name: str):
    fn = getattr(_nvcc.load("posting_scan_topk"), name)
    ints = 7 if name == "posting_scan_topk" else 6      # + group
    outs = 5 if name == "posting_scan_topk" else 3      # + part_s, part_i
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * ints
                   + [ctypes.c_void_p] * outs)
    fn.restype = ctypes.c_int
    return fn


def split_probes(Q: int, P: int) -> tuple:
    """(group, S): the warp path cuts each query's P probes into S groups
    of ``group`` consecutive probes (the last may be shorter), one block
    per (query, group), so that about two blocks per SM run when the
    batch is small; from 264 queries on, S = 1."""
    S = max(1, min(P, _TARGET_BLOCKS // max(Q, 1), 65535))
    group = -(-P // S)
    return group, -(-P // group)


def posting_scan_topk(q: torch.Tensor, vectors: torch.Tensor,
                      valid: torch.Tensor, qp_ok: torch.Tensor,
                      probe: torch.Tensor, k: int):
    """Kernel wrapper: q (Q, d), vectors (M, C, d) fp32, valid (M, C)
    bool, qp_ok and probe (Q, P) int32 -> (scores (Q, k) ascending,
    cand (Q, k) int32 = probe*C + c); ties by position p*C + c.
    Needs 1 <= k <= min(1024, P*C); k > 32 takes the block-wide path."""
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
                         f"[1, min({MAX_K}, P*C={P * C})]")
    if M * C >= 2 ** 31 or P * C >= 2 ** 31:
        raise ValueError("posting_scan_topk: pool exceeds int32 slot ids")
    if k <= WARP_K and d > MAX_D:
        raise ValueError(f"posting_scan_topk: d={d} exceeds {MAX_D}")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    args = [q.data_ptr(), vectors.data_ptr(), valid.data_ptr(),
            qp_ok.data_ptr(), probe.data_ptr(), Q, M, C, d, P, k]
    if k > WARP_K:
        launch = _lib_topk("posting_scan_topk_wide")
        args += [out_s.data_ptr(), out_i.data_ptr()]
    else:
        group, S = split_probes(Q, P)
        part_s = part_i = None
        if S > 1:
            part_s = torch.empty((Q, S, k), dtype=torch.float32, device=dev)
            part_i = torch.empty((Q, S, k), dtype=torch.int32, device=dev)
        launch = _lib_topk("posting_scan_topk")
        args += [group, out_s.data_ptr(), out_i.data_ptr(),
                 None if part_s is None else part_s.data_ptr(),
                 None if part_i is None else part_i.data_ptr()]
    with _nvcc.on_device(dev):
        err = launch(*args, _nvcc.stream_ptr(dev))
    _nvcc.check(err, "posting_scan_topk")
    launches_topk += 1
    return out_s, out_i
