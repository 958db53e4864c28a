"""CUDA kernels of the quant plane's ADC probe scan.

* ``pq_scan_topk`` replaces the Pallas TPU kernel
  ``repro/kernels/pq_scan.py:pq_scan_topk`` (search phase 2 with
  ``use_pq=True``): the ADC score of every slot of the probed code
  tiles, from per-query lookup tables chosen by each posting's codebook
  slot, and the R best.  Source ``csrc/pq_scan_topk.cu``.
* ``pq_scan_gather`` replaces ``repro/kernels/pq_scan.py:
  pq_scan_gather``: the same scores unselected, (Q, P, C), the unfused
  ADC scan that the fused one is held against.  Source
  ``csrc/pq_scan_gather.cu``.

Each source's header note says what bounds it on the H100 and how the
design answers.  The plain versions are
:func:`repro_torch.kernels.ref.pq_scan_topk` and
:func:`repro_torch.kernels.ref.pq_scan_gather`.
"""
from __future__ import annotations

import ctypes

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
#: lookup-table bytes either kernel takes: what pq_scan_topk leaves beside
#: its selection buffer (k <= 1024: 2048 entries of 8 bytes, and 16)
LUT_MAX = SMEM_MAX - 8 * 2048 - 16
launches = 0
launches_gather = 0


def _check_luts(name: str, V: int, m: int, ksub: int) -> None:
    if 4 * V * m * ksub > LUT_MAX:
        raise ValueError(f"{name}: lookup tables of {V}x{m}x{ksub} floats "
                         "exceed a block's shared memory")


def _lib():
    lib = _nvcc.load("pq_scan_topk")
    fn = lib.pq_scan_topk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def pq_scan_topk(luts: torch.Tensor, codes: torch.Tensor,
                 slot: torch.Tensor, valid: torch.Tensor,
                 qp_ok: torch.Tensor, probe: torch.Tensor, k: int):
    """Kernel wrapper: luts (Q, V, m, ksub) fp32, codes (M, m, C) uint8,
    slot (M,) int32 in [0, V), valid (M, C) bool, qp_ok and probe (Q, P)
    int32 -> (scores (Q, k) ascending, cand (Q, k) int32 = probe*C + c),
    ties by position p*C + c.  Needs 1 <= k <= min(1024, P*C)."""
    global launches
    Q, V, m, ksub = luts.shape
    M, _, C = codes.shape
    P = probe.shape[1]
    dev = luts.device
    _nvcc.require(luts, "luts", torch.float32, (Q, V, m, ksub))
    _nvcc.require(codes, "codes", torch.uint8, (M, m, C), dev)
    _nvcc.require(slot, "slot", torch.int32, (M,), dev)
    _nvcc.require(valid, "valid", torch.bool, (M, C), dev)
    _nvcc.require(qp_ok, "qp_ok", torch.int32, (Q, P), dev)
    _nvcc.require(probe, "probe", torch.int32, (Q, P), dev)
    if not 1 <= k <= min(MAX_K, P * C):
        raise ValueError(f"pq_scan_topk: k={k} outside "
                         f"[1, min({MAX_K}, P*C={P * C})]")
    _check_luts("pq_scan_topk", V, m, ksub)
    if M * C >= 2 ** 31 or P * C >= 2 ** 31:
        raise ValueError("pq_scan_topk: pool exceeds int32 slot ids")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    err = _lib()(luts.data_ptr(), codes.data_ptr(), slot.data_ptr(),
                 valid.data_ptr(), qp_ok.data_ptr(), probe.data_ptr(),
                 Q, M, C, V, m, ksub, P, k, out_s.data_ptr(),
                 out_i.data_ptr(), _nvcc.stream_ptr(dev))
    _nvcc.check(err, "pq_scan_topk")
    launches += 1
    return out_s, out_i


def pq_scan_gather(luts: torch.Tensor, codes: torch.Tensor,
                   slot: torch.Tensor, valid: torch.Tensor,
                   probe: torch.Tensor):
    """Kernel wrapper: luts (Q, V, m, ksub) fp32, codes (M, m, C) uint8,
    slot (M,) int32 in [0, V), valid (M, C) bool, probe (Q, P) int32 with
    entries in [0, M) -> (Q, P, C) fp32 ADC scores, BIG where ``valid`` is
    False."""
    global launches_gather
    Q, V, m, ksub = luts.shape
    M, _, C = codes.shape
    P = probe.shape[1]
    dev = luts.device
    _nvcc.require(luts, "luts", torch.float32, (Q, V, m, ksub))
    _nvcc.require(codes, "codes", torch.uint8, (M, m, C), dev)
    _nvcc.require(slot, "slot", torch.int32, (M,), dev)
    _nvcc.require(valid, "valid", torch.bool, (M, C), dev)
    _nvcc.require(probe, "probe", torch.int32, (Q, P), dev)
    _check_luts("pq_scan_gather", V, m, ksub)
    out = torch.empty((Q, P, C), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _nvcc.load("pq_scan_gather").pq_scan_gather
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err = fn(luts.data_ptr(), codes.data_ptr(), slot.data_ptr(),
             valid.data_ptr(), probe.data_ptr(), Q, M, C, V, m, ksub, P,
             out.data_ptr(), _nvcc.stream_ptr(dev))
    _nvcc.check(err, "pq_scan_gather")
    launches_gather += 1
    return out
