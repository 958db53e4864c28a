"""Building blocks of the serving embed backbone (plain tensor functions).

Counterpart of ``repro/models/layers.py``.  The JAX package's ``Param``,
``axes_of`` and ``shard()`` are sharding machinery with no single-device
counterpart; they wait for the sharded slice.  Parameters are plain
tensors drawn from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

INIT_SCALE = 0.02     # std of every normal draw (before the output scale)


def normal(shape, gen: torch.Generator, device, scale: float = INIT_SCALE
           ) -> torch.Tensor:
    """An fp32 tensor of N(0, scale^2) draws on ``device`` from ``gen``
    (a generator of that device)."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm that scales by ``1 + w`` (zero-initialised ``w``), in fp32;
    not ``torch.nn.RMSNorm``, which scales by ``w``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of the two halves of the last axis (not of
    interleaved pairs).  x (..., L, D) with D even; positions (..., L)."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs              # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP.  x (..., D); w_gate, w_up (D, F); w_down (F, D)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def init_mlp(d_model: int, d_ff: int, gen: torch.Generator, device,
             n_layers_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The MLP's weights, keyed as in the JAX package's parameter tree."""
    return {
        "w_gate": normal((d_model, d_ff), gen, device),
        "w_up": normal((d_model, d_ff), gen, device),
        "w_down": normal((d_ff, d_model), gen, device,
                         INIT_SCALE * n_layers_scale),
    }


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
