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
  ``csrc/posting_scan_topk.cu``.  Past k = 32 its wide path stages the
  same tiles and scores each slot with the same arithmetic (so a k = 64
  answer's first 10 are the k = 10 answer, score bits included), then
  picks the k best by one exact selection (:func:`wide_scan_plan`).

Each source's header note says what bounds it on the H100 and how the
design answers.  The plain versions are
:func:`repro_torch.kernels.ref.posting_scan`,
:func:`repro_torch.kernels.ref.posting_scan_gather` and
:func:`repro_torch.kernels.ref.posting_scan_topk`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

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
MAX_K = 1024          # wide path (csrc/topk_common.cuh: TOPK_BLOCK_MAX_K)
MAX_D = 16384         # the warp path's q row and two one-row stages
MAX_D_GATHER = 12288  # csrc/row_score.cuh: PS_UNIT_FLOATS, one row a unit
SMEM_MAX = 232448     # shared bytes a block may use on the H100
MAX_SPLIT = 8         # the wide path's blocks a query: a portable cluster
_TARGET_BLOCKS = 264  # two blocks per SM of an H100
_SMS = 132            # SMs of an H100
_SEL_N = 5120         # csrc/topk_select.cuh: block_select's n at most
_SEL_SCRATCH = 612    # csrc/topk_select.cuh: SEL_SCRATCH_INTS
#: how the wide path reads slot rows (csrc/posting_scan_topk.cu: PswMode):
#: staged by bulk copy, staged by 4-byte cp.async, from device memory
MODE_BULK, MODE_COPY, MODE_DIRECT = 0, 1, 2
launches = 0
launches_gather = 0
launches_topk = 0         # warp path
launches_topk_wide = 0    # wide path


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


@functools.cache           # argtypes set once: the launch is on the hot path
def _lib_topk(name: str):
    fn = getattr(_nvcc.load("posting_scan_topk"), name)
    if name == "posting_scan_topk":      # + group; part_s, part_i
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 5)
    else:                                # + mode, group, nb
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 3)
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


def unit_rows(C: int, d: int) -> int:
    """Rows of a (C, d) tile in one staged unit of PS_UNIT_FLOATS
    (csrc/row_score.cuh: ``unit_rows``)."""
    return min(C, max(1, MAX_D_GATHER // d))


class ScanPlan(NamedTuple):
    mode: int         # MODE_BULK, MODE_COPY or MODE_DIRECT
    group: int        # probes a block
    S: int            # blocks a query, one cluster
    nb: int           # (score, position) pairs a block buffers
    smem: int         # shared bytes a block


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def wide_scan_bytes(mode: int, d: int, C: int, nb: int, k: int,
                    S: int) -> int:
    """The wide kernel's shared bytes (csrc/posting_scan_topk.cu:
    ``psw_layout``): mbarriers, q and two stages of a unit (not where it
    reads device memory), the pair buffer and its keys, the k selected and
    their composites, a split's S lists, the selection's scratch."""
    staged = mode != MODE_DIRECT
    sf = (unit_rows(C, d) * d + 3) & ~3 if staged else 0
    return (_a16(16) + (_a16(4 * ((d + 3) & ~3)) if staged else 0)
            + _a16(8 * sf) + _a16(8 * nb) + _a16(4 * nb) + 2 * _a16(8 * k)
            + (_a16(8 * S * k) if S > 1 else 0)
            + _a16(4 * (_SEL_SCRATCH + MAX_SPLIT)))


def wide_scan_plan(Q: int, P: int, C: int, d: int, k: int,
                   aligned: bool = True) -> ScanPlan:
    """The wide path's launch: grid (Q, S), the S blocks of a query one
    cluster, each over ``group`` consecutive probes.  Below 67 queries
    each query's probes split over S <= 8 blocks (about one block per SM,
    as ``pq_scan_topk``'s ``split_probes``).  A block stages its tiles by
    bulk copy where d % 4 == 0 and the vectors are 16-byte aligned, else
    by cp.async, and buffers all its group's slots (or, where they
    exceed 5,120 or the shared memory, as many as fit, at least k + 256:
    the block selects whenever the buffer fills).  Where no staged layout
    fits (a row past 16,384 floats), the block reads rows and q from
    device memory.  Fewer blocks a query where the split's lists do not
    fit."""
    S0 = max(1, min(P, _SMS // max(Q, 1), MAX_SPLIT))
    staged = MODE_BULK if d % 4 == 0 and aligned else MODE_COPY
    for mode in (staged, MODE_DIRECT):
        for S in dict.fromkeys((S0, 1)):
            group = -(-P // S)
            S = -(-P // group)
            slots = group * C
            if slots <= _SEL_N and \
                    wide_scan_bytes(mode, d, C, slots, k, S) <= SMEM_MAX:
                nb = slots
            else:
                room = SMEM_MAX - wide_scan_bytes(mode, d, C, 0, k, S)
                nb = min(_SEL_N, room // 12 // 4 * 4)
                if nb < k + 256:
                    continue
            return ScanPlan(mode, group, S, nb,
                            wide_scan_bytes(mode, d, C, nb, k, S))
    raise ValueError(f"posting_scan_topk: no layout fits k={k}, d={d}")


def posting_scan_topk(q: torch.Tensor, vectors: torch.Tensor,
                      slot_valid: torch.Tensor, vis: torch.Tensor,
                      qp_ok: Optional[torch.Tensor], probe: torch.Tensor,
                      k: int):
    """Kernel wrapper: q (Q, d), vectors (M, C, d) fp32, slot_valid (M, C)
    and vis (M,) bool, qp_ok (Q, P) int32 or None (every probe counts),
    probe (Q, P) int32 -> (scores (Q, k) ascending, cand (Q, k) int32 =
    probe*C + c); ties by position p*C + c.  Needs 1 <= k <= min(1024,
    P*C); k > 32 takes the wide path (any d), k <= 32 needs d <= 16,384."""
    global launches_topk, launches_topk_wide
    Q, d = q.shape
    M, C, _ = vectors.shape
    P = probe.shape[1]
    dev = q.device
    _nvcc.require(q, "q", torch.float32, (Q, d))
    _nvcc.require(vectors, "vectors", torch.float32, (M, C, d), dev)
    _nvcc.require(slot_valid, "slot_valid", torch.bool, (M, C), dev)
    _nvcc.require(vis, "vis", torch.bool, (M,), dev)
    if qp_ok is not None:
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
    args = [q.data_ptr(), vectors.data_ptr(), slot_valid.data_ptr(),
            vis.data_ptr(), None if qp_ok is None else qp_ok.data_ptr(),
            probe.data_ptr(), Q, M, C, d, P, k]
    if k > WARP_K:
        plan = wide_scan_plan(Q, P, C, d, k, vectors.data_ptr() % 16 == 0)
        launch = _lib_topk("posting_scan_topk_wide")
        args += [plan.mode, plan.group, plan.nb, out_s.data_ptr(),
                 out_i.data_ptr()]
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
    if k > WARP_K:
        launches_topk_wide += 1
    else:
        launches_topk += 1
    return out_s, out_i
