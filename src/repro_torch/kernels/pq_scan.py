"""CUDA kernels of the quant plane's ADC probe scan.

* ``pq_scan_topk`` replaces the Pallas TPU kernel
  ``repro/kernels/pq_scan.py:pq_scan_topk`` (search phase 2 with
  ``use_pq=True``): the ADC score of every slot of the probed code
  tiles, from per-query lookup tables chosen by each posting's codebook
  slot, and the R best, selected once by a radix select (tables and code
  tiles staged by Hopper's bulk copy; at a small batch each query's
  probes split across the blocks of a cluster, :func:`split_probes`).
  Source ``csrc/pq_scan_topk.cu``.
* ``pq_scan_gather`` replaces ``repro/kernels/pq_scan.py:
  pq_scan_gather``: the same scores unselected, (Q, P, C), the unfused
  ADC scan that the fused one is held against (the same staged scan,
  ``csrc/adc_scan.cuh``, with a store for an epilogue; at a small batch
  each query's probes split across blocks, :func:`gather_split`).
  Source ``csrc/pq_scan_gather.cu``.

Each source's header note says what bounds it on the H100 and how the
design answers.  The plain versions are
:func:`repro_torch.kernels.ref.pq_scan_topk` and
:func:`repro_torch.kernels.ref.pq_scan_gather`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _nvcc
from .ref import pq_scan_gather as plain_gather  # noqa: F401
from .ref import pq_scan_topk as plain  # noqa: F401  (the plain version)

SOURCE = "src/repro_torch/csrc/pq_scan_topk.cu"
REPLACES = "src/repro/kernels/pq_scan.py:182"
SOURCE_GATHER = "src/repro_torch/csrc/pq_scan_gather.cu"
REPLACES_GATHER = "src/repro/kernels/pq_scan.py:78"
MAX_K = 1024          # csrc/topk_common.cuh: TOPK_BLOCK_MAX_K
SMEM_MAX = 232448     # shared bytes a block may use on the H100
MAX_SPLIT = 8         # blocks a query: a portable thread-block cluster
MAX_C = 4096          # csrc/pq_scan_topk.cu: PQ_CHUNK_MAX, slots a chunk
_SMS = 132            # SMs of an H100
launches = 0
launches_gather = 0


def topk_smem(V: int, m: int, ksub: int, C: int, k: int, P: int,
              S: int = 1) -> int:
    """The least shared memory ``pq_scan_topk`` needs (csrc/pq_scan_topk.cu,
    ``pq_layout`` with no code ring and one tile a chunk): mbarriers, the
    tables, the block's P probe ids and a probe record, k + C (score,
    position) pairs and their keys, the k selected and their composites,
    a split's S sorted lists, the selection's scratch (SEL_SCRATCH_INTS +
    PQ_MAX_SPLIT ints); each region 16-byte aligned."""
    def a16(n):
        return -(-n // 16) * 16
    lists = S * k * 8 if S > 1 else 0
    return (a16(8 * 17) + _lut_bytes(V, m, ksub) + a16(4 * P) + 16
            + a16(8 * (k + C)) + a16(4 * (k + C))
            + 2 * a16(8 * k) + a16(lists) + a16(4 * (612 + 8)))


def _lut_bytes(V: int, m: int, ksub: int) -> int:
    return -(-4 * V * m * ksub // 16) * 16


#: lookup-table bytes ``pq_scan_topk`` takes at any k <= 1024, C <= 256
#: and P <= 1024 (beside them, at those: 10 KB of pairs, 16 KB of the k
#: selected and their composites, 4 KB of probe ids)
LUT_MAX = SMEM_MAX - topk_smem(0, 0, 0, 256, MAX_K, 1024)
#: lookup-table bytes ``pq_scan_gather`` takes: beside them its block holds
#: only mbarriers (144 bytes) and 256 probe records (csrc/pq_scan_gather.cu)
LUT_MAX_GATHER = SMEM_MAX - 144 - 16 * 256


def _check_luts(name: str, V: int, m: int, ksub: int, limit: int) -> None:
    if _lut_bytes(V, m, ksub) > limit:
        raise ValueError(f"{name}: lookup tables of {V}x{m}x{ksub} floats "
                         "exceed a block's shared memory")


def split_probes(Q: int, P: int) -> tuple:
    """(group, S): each query's P probes go in S groups of ``group``
    consecutive probes (the last may be shorter), one block each, the S
    blocks of a query one cluster (S <= 8), so that about one block per SM
    works at a small batch; S = 1 from 67 queries on."""
    S = max(1, min(P, _SMS // max(Q, 1), MAX_SPLIT))
    group = -(-P // S)
    return group, -(-P // group)


def gather_split(Q: int, P: int) -> tuple:
    """(group, S) for ``pq_scan_gather``: each query's P probes go in S
    groups of ``group`` consecutive probes (the last may be shorter), one
    block each, so that about two blocks per SM work at a small batch
    (nothing is merged, so S is not bound by a cluster); S = 1 from 133
    queries on."""
    S = max(1, min(P, 2 * _SMS // max(Q, 1), 65535))
    group = -(-P // S)
    return group, -(-P // group)


_fn = None
_gather_fn = None


def _lib():
    global _fn
    if _fn is None:                 # argtypes once: every call pays for it
        fn = _nvcc.load("pq_scan_topk").pq_scan_topk
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pq_scan_topk(luts: torch.Tensor, codes: torch.Tensor,
                 slot: torch.Tensor, slot_valid: torch.Tensor,
                 vis: torch.Tensor, qp_ok: Optional[torch.Tensor],
                 probe: torch.Tensor, k: int):
    """Kernel wrapper: luts (Q, V, m, ksub) fp32, codes (M, m, C) uint8,
    slot (M,) int32 (clamped to [0, V) by the kernel), slot_valid (M, C)
    and vis (M,) bool, qp_ok (Q, P) int32 or None (every probe counts),
    probe (Q, P) int32 -> (scores (Q, k) ascending, cand (Q, k) int32 =
    probe*C + c), ties by position p*C + c.  Needs 1 <= k <= min(1024,
    P*C)."""
    global launches
    Q, V, m, ksub = luts.shape
    M, _, C = codes.shape
    P = probe.shape[1]
    dev = luts.device
    _nvcc.require(luts, "luts", torch.float32, (Q, V, m, ksub))
    _nvcc.require(codes, "codes", torch.uint8, (M, m, C), dev)
    _nvcc.require(slot, "slot", torch.int32, (M,), dev)
    _nvcc.require(slot_valid, "slot_valid", torch.bool, (M, C), dev)
    _nvcc.require(vis, "vis", torch.bool, (M,), dev)
    if qp_ok is not None:
        _nvcc.require(qp_ok, "qp_ok", torch.int32, (Q, P), dev)
    _nvcc.require(probe, "probe", torch.int32, (Q, P), dev)
    if not 1 <= k <= min(MAX_K, P * C):
        raise ValueError(f"pq_scan_topk: k={k} outside "
                         f"[1, min({MAX_K}, P*C={P * C})]")
    _check_luts("pq_scan_topk", V, m, ksub,
                SMEM_MAX - topk_smem(0, 0, 0, C, k, P))
    if M * C >= 2 ** 31 or P * C >= 2 ** 31:
        raise ValueError("pq_scan_topk: pool exceeds int32 slot ids")
    if C > MAX_C:
        raise ValueError(f"pq_scan_topk: C={C} exceeds {MAX_C} slots a tile")
    group, S = split_probes(Q, P)
    if S > 1 and topk_smem(V, m, ksub, C, k, group, S) > SMEM_MAX:
        group = P
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    with _nvcc.on_device(dev):
        err = _lib()(luts.data_ptr(), codes.data_ptr(), slot.data_ptr(),
                     slot_valid.data_ptr(), vis.data_ptr(),
                     None if qp_ok is None else qp_ok.data_ptr(),
                     probe.data_ptr(), Q, M, C, V, m, ksub, P, k, group,
                     out_s.data_ptr(), out_i.data_ptr(),
                     _nvcc.stream_ptr(dev))
    _nvcc.check(err, "pq_scan_topk")
    launches += 1
    return out_s, out_i


def pq_scan_gather(luts: torch.Tensor, codes: torch.Tensor,
                   slot: torch.Tensor, slot_valid: torch.Tensor,
                   vis: torch.Tensor, probe: torch.Tensor):
    """Kernel wrapper: luts (Q, V, m, ksub) fp32, codes (M, m, C) uint8,
    slot (M,) int32 (clamped to [0, V) by the kernel), slot_valid (M, C)
    and vis (M,) bool, probe (Q, P) int32 with entries in [0, M) -> (Q, P,
    C) fp32 ADC scores, BIG where ``slot_valid`` or the posting's ``vis``
    is False."""
    global launches_gather, _gather_fn
    Q, V, m, ksub = luts.shape
    M, _, C = codes.shape
    P = probe.shape[1]
    dev = luts.device
    _nvcc.require(luts, "luts", torch.float32, (Q, V, m, ksub))
    _nvcc.require(codes, "codes", torch.uint8, (M, m, C), dev)
    _nvcc.require(slot, "slot", torch.int32, (M,), dev)
    _nvcc.require(slot_valid, "slot_valid", torch.bool, (M, C), dev)
    _nvcc.require(vis, "vis", torch.bool, (M,), dev)
    _nvcc.require(probe, "probe", torch.int32, (Q, P), dev)
    _check_luts("pq_scan_gather", V, m, ksub, LUT_MAX_GATHER)
    out = torch.empty((Q, P, C), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if M == 0:
        raise ValueError("pq_scan_gather: probes into an empty pool")
    if _gather_fn is None:          # argtypes once: every call pays for it
        fn = _nvcc.load("pq_scan_gather").pq_scan_gather
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _gather_fn = fn
    group, _ = gather_split(Q, P)
    with _nvcc.on_device(dev):
        err = _gather_fn(luts.data_ptr(), codes.data_ptr(),
                         slot.data_ptr(), slot_valid.data_ptr(),
                         vis.data_ptr(), probe.data_ptr(), Q, M, C, V, m,
                         ksub, P, group, out.data_ptr(),
                         _nvcc.stream_ptr(dev))
    _nvcc.check(err, "pq_scan_gather")
    launches_gather += 1
    return out
