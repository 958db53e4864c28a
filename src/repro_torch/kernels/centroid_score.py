"""CUDA kernel: masked centroid scoring, ``(Q, d) x (M, d) -> (Q, M)``.

Replaces the Pallas TPU kernel ``repro/kernels/centroid_score.py:
centroid_score``.  Every insert locate step, the background round's
partner / move-out / reassign scoring and the exact oracle's cache scan
score a query block against the whole centroid table.  The CUDA source
is ``csrc/masked_score.cu`` (shared with ``posting_scan``, which computes
the same function over flattened posting tiles); its header note says
what bounds it on the H100 and how the design answers.  The plain
version is :func:`repro_torch.kernels.ref.centroid_score`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from .ref import centroid_score as plain  # noqa: F401  (the plain version)

SOURCE = "src/repro_torch/csrc/masked_score.cu"
REPLACES = "src/repro/kernels/centroid_score.py:43"
TILE_N = 128          # x rows per block (csrc/masked_score.cu)
launches = 0


def tile_q(Q: int) -> int:
    """The kernel's query tile: 32 rows up to Q = 32, else 128."""
    return 32 if Q <= 32 else 128


def _lib():
    lib = _nvcc.load("masked_score")
    fn = lib.masked_score
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_score(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                 what: str) -> torch.Tensor:
    """Launch ``masked_score`` on q (Q, d), x (N, d) fp32 and mask (N,)
    bool, all contiguous on one card.  Returns (Q, N) fp32."""
    Q, d = q.shape
    N = x.shape[0]
    _nvcc.require(q, "q", torch.float32, (Q, d))
    _nvcc.require(x, "x", torch.float32, (N, d), q.device)
    _nvcc.require(mask, "mask", torch.bool, (N,), q.device)
    blocks = -(-Q // tile_q(Q)) * -(-N // TILE_N)
    if N >= 2 ** 31 or blocks >= 2 ** 31:
        raise ValueError(f"{what}: shape ({Q}, {N}) exceeds the launch grid")
    out = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    if Q == 0 or N == 0:
        return out
    with _nvcc.on_device(q.device):
        err = _lib()(q.data_ptr(), x.data_ptr(), mask.data_ptr(), Q, N, d,
                     out.data_ptr(), _nvcc.stream_ptr(q.device))
    _nvcc.check(err, what)
    return out


def centroid_score(q: torch.Tensor, c: torch.Tensor,
                   vis: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: (Q, d), (M, d), (M,) bool -> (Q, M) fp32 scores,
    BIG where ``vis`` is False."""
    global launches
    out = masked_score(q, c, vis, "centroid_score")
    if out.numel():
        launches += 1
    return out
