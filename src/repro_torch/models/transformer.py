"""Decoder stack of the serving embed backbone.

Counterpart of ``repro/models/transformer.py``.  A config compiles into
*segments* ``(period_descriptors, repeat)`` exactly as there; where the
JAX package stacks a period's weights over ``repeat`` and drives them
with ``lax.scan``, the port builds one :class:`Layer` module per
sub-layer, in execution order, in an ``nn.ModuleList``.  The layouts of
the JAX package are kept at the function boundaries (activations
``(B, L, D)``, attention heads ``(B, H, L, D)``, weights ``(in, out)``).

The prefill/decode paths (``collect_cache``, ``run_decode``, the KV
caches) and cross-attention (``encdec``) belong to the decode slice of
the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch import nn

from . import attention as attn_mod
from .config import ModelConfig
from .layers import INIT_SCALE, apply_mlp, init_mlp, normal, rms_norm, rope

DECODE_SLICE = "belongs to the decode slice of the port"


@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str                   # attn | attn_local
    ffn: str                     # mlp
    cross: bool = False          # cross-attention (enc-dec decoder)
    causal: bool = True


def plan_segments(cfg: ModelConfig) -> List[Tuple[Tuple[SubLayer, ...], int]]:
    if cfg.local_global_pattern is not None:
        pat = cfg.local_global_pattern
        descrs = tuple(
            SubLayer("attn_local" if c == "L" else "attn", "mlp")
            for c in pat)
        reps = cfg.n_layers // len(pat)
        segs = [(descrs, reps)]
        tail = cfg.n_layers - reps * len(pat)
        if tail:
            segs.append(((SubLayer("attn_local", "mlp"),), tail))
        return segs
    cross = cfg.family == "encdec"
    return [((SubLayer("attn", "mlp", cross=cross),), cfg.n_layers)]


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.Module):
    """One sub-layer: pre-normed attention, then a pre-normed MLP, each
    added to the residual.  Its parameters carry the JAX package's names
    (``ln1``, ``attn.wq`` ..., ``ln2``, ``mlp.w_gate`` ...)."""

    def __init__(self, cfg: ModelConfig, d: SubLayer, out_scale: float,
                 gen: torch.Generator, device):
        super().__init__()
        if d.cross:
            raise NotImplementedError(f"cross-attention (encdec) {DECODE_SLICE}")
        self.cfg, self.d = cfg, d
        D, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
        zeros = lambda n: torch.zeros(n, device=device)         # noqa: E731
        self.ln1 = _frozen(zeros(D))
        attn = {"wq": normal((D, Hq * hd), gen, device),
                "wk": normal((D, Hkv * hd), gen, device),
                "wv": normal((D, Hkv * hd), gen, device),
                "wo": normal((Hq * hd, D), gen, device,
                             INIT_SCALE * out_scale)}
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in attn.items()})
        self.ln2 = _frozen(zeros(D))
        self.mlp = nn.ParameterDict({
            k: _frozen(v) for k, v in init_mlp(D, cfg.d_ff, gen, device,
                                               out_scale).items()})

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        x = _apply_attn(self, self.cfg, x, self.d, positions)
        return _apply_ffn(self, self.cfg, x, self.d)


def _qk(p, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor):
    """q (B, Hq, L, hd), k and v (B, Hkv, L, hd) of the normed input h."""
    B, L, _ = h.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    q = (h @ p["wq"]).reshape(B, L, Hq, hd)
    k = (h @ p["wk"]).reshape(B, L, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, L, Hkv, hd)
    q = rope(q.transpose(1, 2), positions[None, None], cfg.rope_theta)
    k = rope(k.transpose(1, 2), positions[None, None], cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def _apply_attn(p: Layer, cfg: ModelConfig, x: torch.Tensor, d: SubLayer,
                positions: torch.Tensor) -> torch.Tensor:
    B, L, _ = x.shape
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    q, k, v = _qk(p.attn, cfg, h, positions)
    window = cfg.sliding_window if d.mixer == "attn_local" else None
    if window is not None:
        o = attn_mod.local_attention(q, k, v, window)
    else:
        o = attn_mod.chunked_attention(q, k, v, causal=d.causal)
    o = o.transpose(1, 2).reshape(B, L, cfg.n_heads * cfg.hd)
    return x + o @ p.attn["wo"]


def _apply_ffn(p: Layer, cfg: ModelConfig, x: torch.Tensor,
               d: SubLayer) -> torch.Tensor:
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if d.ffn == "mlp":
        return x + apply_mlp(p.mlp, h)
    raise ValueError(d.ffn)


def build_layers(cfg: ModelConfig, segments, out_scale: float,
                 gen: torch.Generator, device) -> nn.ModuleList:
    """One :class:`Layer` per sub-layer, in execution order: for each
    segment, for each repeat, for each descriptor of the period."""
    return nn.ModuleList(
        Layer(cfg, d, out_scale, gen, device)
        for descrs, repeat in segments for _ in range(repeat)
        for d in descrs)


def run_segments(layers: nn.ModuleList, cfg: ModelConfig, segments,
                 x: torch.Tensor, positions: torch.Tensor, enc_out=None,
                 collect_cache: bool = False) -> torch.Tensor:
    """Forward through every layer of every segment."""
    if collect_cache:
        raise NotImplementedError(f"collect_cache (prefill) {DECODE_SLICE}")
    if enc_out is not None:
        raise NotImplementedError(f"cross-attention (encdec) {DECODE_SLICE}")
    n = sum(len(descrs) * repeat for descrs, repeat in segments)
    if len(layers) != n:
        raise ValueError(f"run_segments: {len(layers)} layers, the segments "
                         f"of {cfg.name} have {n}")
    for layer in layers:
        x = layer(x, positions)
    return x


def run_decode(*args, **kwargs):
    """One-token decode against KV caches (not ported yet)."""
    raise NotImplementedError(f"run_decode {DECODE_SLICE}")
