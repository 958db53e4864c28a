"""Attention of the serving embed backbone.

Counterpart of ``repro/models/attention.py``.  There, on the TPU, both
``chunked_attention`` and ``local_attention`` call the Pallas
``flash_attention`` kernel, and elsewhere they run an online softmax over
key chunks in jnp.  Here both go through ``kernels.ops.flash_attention``,
which picks by device: on the card the hand-written CUDA kernel (there is
no other path on the card), on the CPU its plain version.  Query rows
align to the end of the keys, as in the kernel.

``decode_attention`` and ``cache_update`` (one-token decode against a KV
cache) wait for the decode slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, Lq, D); k, v (B, Hkv, Lk, D) -> (B, Hq, Lq, D)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int) -> torch.Tensor:
    """Sliding-window causal self-attention: a key attends within
    ``(qpos - window, qpos]``; the kernel skips the key tiles outside the
    band, so the work is O(L * window)."""
    return ops.flash_attention(q, k, v, causal=True, window=window)
