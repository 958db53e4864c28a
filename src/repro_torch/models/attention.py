"""Attention of the serving embed backbone.

Counterpart of ``repro/models/attention.py``.  There, on the TPU, both
``chunked_attention`` and ``local_attention`` call the Pallas
``flash_attention`` kernel, and elsewhere they run an online softmax over
key chunks in jnp.  Here both go through ``kernels.ops.flash_attention``,
which picks by device: on the card the hand-written CUDA kernel (there is
no other path on the card), on the CPU its plain version.  Query rows
align to the end of the keys, as in the kernel.

``decode_attention`` and ``cache_update`` (one token against a KV cache)
are einsums and a softmax in the reference too, not a Pallas kernel, so
they stay plain PyTorch on the card, like the decode path's matmuls.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..kernels import ops

NEG = -1e30

Pos = Union[int, torch.Tensor]


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


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Pos,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a cache, in fp32.

    q1 (B, Hq, D); caches (B, Hkv, S, D); ``pos`` (an int or a 0-d
    tensor): the index of the current token, cache entries ``0..pos``
    valid (and with ``window`` only those after ``pos - window``)."""
    B, Hq, D = q1.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q1.reshape(B, Hkv, Hq // Hkv, D).float() / (D ** 0.5)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float())
    kpos = torch.arange(S, device=q1.device)
    mask = kpos <= pos
    if window is not None:
        mask = mask & (kpos > pos - window)
    s = s.masked_fill(~mask, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, D).to(q1.dtype)


def cache_index(pos: Pos, S: int, device) -> torch.Tensor:
    """``pos`` (an int or a 0-d tensor) as the (1,) long index that the
    reference's ``dynamic_update_slice`` writes on a cache of ``S``
    positions: a negative ``pos`` counts from the end, and the result is
    clamped to ``[0, S - 1]``, so a write past the end lands on the last
    entry and raises nothing.  A tensor stays on the device (no sync)."""
    idx = torch.as_tensor(pos, device=device).to(torch.long).reshape(1)
    return torch.where(idx < 0, idx + S, idx).clamp(0, S - 1)


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k1: torch.Tensor, v1: torch.Tensor, idx: torch.Tensor):
    """Write k1, v1 (B, Hkv, D) at ``idx`` (:func:`cache_index`) of the
    caches' sequence axis, **in place**; returns the caches."""
    k_cache.index_copy_(2, idx, k1[:, :, None].to(k_cache.dtype))
    v_cache.index_copy_(2, idx, v1[:, :, None].to(v_cache.dtype))
    return k_cache, v_cache


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k1: torch.Tensor, v1: torch.Tensor, pos: Pos):
    """Write the new token's k1, v1 (B, Hkv, D) at ``pos`` (an int or a
    0-d tensor, clamped as :func:`cache_index` says) of the caches'
    sequence axis, **in place**, and return the caches."""
    return cache_write(k_cache, v_cache, k1, v1,
                       cache_index(pos, k_cache.shape[2], k_cache.device))
