"""CUDA kernel: batched nearest-centroid assignment (the PQ Lloyd step
and PQ encoding).

Replaces the Pallas TPU kernel ``repro/kernels/kmeans_assign.py:
kmeans_assign``, which the JAX package vmaps over the PQ subspaces; here
the batch is one grid axis, so one launch serves every subspace (and
every codebook version).  The CUDA source is ``csrc/kmeans_assign.cu``;
its header note says what bounds it on the H100 and how the design
answers.  The plain version is :func:`repro_torch.kernels.ref.kmeans_assign`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _nvcc
from .ref import kmeans_assign as plain  # noqa: F401  (the plain version)

SOURCE = "src/repro_torch/csrc/kmeans_assign.cu"
REPLACES = "src/repro/kernels/kmeans_assign.py:61"
launches = 0


@functools.cache           # argtypes set once: the launch is on the hot path
def _lib():
    lib = _nvcc.load("kmeans_assign")
    fn = lib.kmeans_assign
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor,
                  mask=None):
    """Kernel wrapper: points (Bp, N, d) fp32 with unit feature stride
    (any batch and row strides: a (N, m, d) view transposed to
    (m, N, d) needs no copy), centroids (B, K, d) fp32 contiguous with
    ``B % Bp == 0``, mask (N,) bool or None -> (assign (B, N) int32,
    best (B, N) fp32)."""
    global launches
    Bp, N, d = points.shape
    B, K, _ = centroids.shape
    dev = points.device
    if not points.is_cuda or points.dtype != torch.float32:
        raise ValueError("points: expected a CUDA fp32 tensor")
    if points.stride(2) != 1 and d > 1:
        raise ValueError("points: the feature axis must be contiguous")
    _nvcc.require(centroids, "centroids", torch.float32, (B, K, d), dev)
    if mask is not None:
        _nvcc.require(mask, "mask", torch.bool, (N,), dev)
    if Bp < 1 or B % Bp or K < 1:
        raise ValueError(f"kmeans_assign: {B} centroid batches of {K} over "
                         f"{Bp} point batches")
    if B > 65535 or N >= 2 ** 31 or B * K * d >= 2 ** 62:
        raise ValueError(f"kmeans_assign: shape ({B}, {N}, {K}) exceeds "
                         "the launch grid")
    assign = torch.empty((B, N), dtype=torch.int32, device=dev)
    best = torch.empty((B, N), dtype=torch.float32, device=dev)
    if N == 0:
        return assign, best
    with _nvcc.on_device(dev):
        err = _lib()(points.data_ptr(), points.stride(0),
                     points.stride(1), Bp, centroids.data_ptr(), B, N, K, d,
                     None if mask is None else mask.data_ptr(),
                     assign.data_ptr(), best.data_ptr(),
                     _nvcc.stream_ptr(dev))
    _nvcc.check(err, "kmeans_assign")
    launches += 1
    return assign, best
