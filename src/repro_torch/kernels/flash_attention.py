"""CUDA kernel: online-softmax attention for the serving embed backbone.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:_kernel``
(GQA by index, end-aligned causal masking, a sliding window, masking of
the ragged key end and skipping of fully masked key tiles).  The TPU
wrapper pads D to 128 lanes and Lq/Lk to tile multiples; the CUDA kernel
masks its own ragged edges, so nothing is padded here.  The source is
``csrc/flash_attention.cu``; its header note says what bounds it on the
H100 and how the design answers.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _nvcc
from .ref import flash_attention as plain  # noqa: F401  (the plain version)

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:107"
MAX_D = 128           # csrc/flash_attention.cu: MAX_D
launches = 0


@functools.cache           # argtypes set once: the launch is on the hot path
def _lib():
    lib = _nvcc.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int],
                    scale: float) -> torch.Tensor:
    """Kernel wrapper: q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), all
    contiguous fp32 on one card -> (B, Hq, Lq, D) fp32.  Needs D <= 128,
    ``Hq % Hkv == 0``, Lk >= 1 and a window of at least 1 (or None)."""
    global launches
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    dev = q.device
    _nvcc.require(q, "q", torch.float32, (B, Hq, Lq, D))
    _nvcc.require(k, "k", torch.float32, (B, Hkv, Lk, D), dev)
    _nvcc.require(v, "v", torch.float32, (B, Hkv, Lk, D), dev)
    if not 1 <= D <= MAX_D:
        raise ValueError(f"flash_attention: head dim D={D} outside "
                         f"[1, {MAX_D}] on the card")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of "
                         f"Hkv={Hkv}")
    if Lk < 1:
        raise ValueError("flash_attention: no keys (Lk=0)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} < 1")
    out = torch.empty((B, Hq, Lq, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with _nvcc.on_device(dev):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, Hq, Hkv, Lq, Lk, D, int(bool(causal)),
                     0 if window is None else int(window), float(scale),
                     _nvcc.stream_ptr(dev))
    _nvcc.check(err, "flash_attention")
    launches += 1
    return out
