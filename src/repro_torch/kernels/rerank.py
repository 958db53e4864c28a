"""CUDA kernel: the quant plane's fused exact rerank + top-k.

Replaces the Pallas TPU kernel ``repro/kernels/rerank.py:rerank_topk``
(search stage 2 with ``use_pq=True``): gather the R ADC survivors' float
rows, score them exactly, pass the ADC score through for tier-spilled
postings, and keep the k best, ties by ADC rank.  The CUDA source is
``csrc/rerank_topk.cu``; its header note says what bounds it on the H100
and how the design answers.  The plain version is
:func:`repro_torch.kernels.ref.rerank_topk`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from .ref import rerank_topk as plain  # noqa: F401  (the plain version)

SOURCE = "src/repro_torch/csrc/rerank_topk.cu"
REPLACES = "src/repro/kernels/rerank.py:96"
MAX_K = 1024          # csrc/topk_common.cuh: TOPK_BLOCK_MAX_K
launches = 0


_fn = None


def _lib():
    global _fn
    if _fn is None:                 # argtypes once: every call pays for it
        fn = _nvcc.load("rerank_topk").rerank_topk
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rerank_topk(q: torch.Tensor, vectors: torch.Tensor,
                spilled: torch.Tensor, cand: torch.Tensor, adc: torch.Tensor,
                k: int):
    """Kernel wrapper: q (Q, d) fp32, vectors (M, C, d) fp32, spilled (M,)
    bool, cand (Q, R) int32 flat slot ids, adc (Q, R) fp32 -> (scores
    (Q, k) ascending, cand (Q, k) int32), ties lowest ADC rank first.
    Needs 1 <= k <= min(1024, R)."""
    global launches
    Q, d = q.shape
    M, C, _ = vectors.shape
    R = cand.shape[1]
    dev = q.device
    _nvcc.require(q, "q", torch.float32, (Q, d))
    _nvcc.require(vectors, "vectors", torch.float32, (M, C, d), dev)
    _nvcc.require(spilled, "spilled", torch.bool, (M,), dev)
    _nvcc.require(cand, "cand", torch.int32, (Q, R), dev)
    _nvcc.require(adc, "adc", torch.float32, (Q, R), dev)
    if not 1 <= k <= min(MAX_K, R):
        raise ValueError(f"rerank_topk: k={k} outside [1, min({MAX_K}, "
                         f"R={R})]")
    if M * C >= 2 ** 31:
        raise ValueError("rerank_topk: pool exceeds int32 slot ids")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    with _nvcc.on_device(dev):
        err = _lib()(q.data_ptr(), vectors.data_ptr(), spilled.data_ptr(),
                     cand.data_ptr(), adc.data_ptr(), Q, M * C, C, d, R, k,
                     out_s.data_ptr(), out_i.data_ptr(), _nvcc.stream_ptr(dev))
    _nvcc.check(err, "rerank_topk")
    launches += 1
    return out_s, out_i
