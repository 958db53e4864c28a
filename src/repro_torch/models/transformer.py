"""Decoder stack of the serving embed backbone.

Counterpart of ``repro/models/transformer.py``.  A config compiles into
*segments* ``(period_descriptors, repeat)`` exactly as there; where the
JAX package stacks a period's weights over ``repeat`` and drives them
with ``lax.scan``, the port builds one :class:`Layer` module per
sub-layer, in execution order, in an ``nn.ModuleList``.  The layouts of
the JAX package are kept at the function boundaries (activations
``(B, L, D)``, attention heads ``(B, H, L, D)``, weights ``(in, out)``).

Modes: the forward (``run_segments``), prefill (``collect_cache=True``
also returns each layer's KV cache entry) and decode (``run_decode``:
one token against the caches).  The caches are a list with one dict a
layer, in the layers' order: ``k``/``v`` (B, Hkv, S, hd) and, on a
cross-attention layer, ``xk``/``xv`` (B, Hkv, S_src, hd).  A local
layer's cache is a ring of the last ``sliding_window`` positions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn

from . import attention as attn_mod
from .config import ModelConfig
from .layers import INIT_SCALE, apply_mlp, init_mlp, normal, rms_norm, rope

#: logical axes of each parameter leaf, by the leaf's name, as the
#: reference's ``param`` calls name them (``repro/models/{layers,
#: transformer,registry}.py``); a stacked segment adds ``"layers"`` in front
LEAF_AXES = {
    "emb": ("vocab", "embed"), "head": ("embed", "vocab"),
    "ln_f": ("embed",), "ln1": ("embed",), "ln2": ("embed",),
    "ln_x": ("embed",),
    "wq": ("embed", "heads_flat"), "wk": ("embed", "heads_flat"),
    "wv": ("embed", "heads_flat"), "wo": ("heads_flat", "embed"),
    "q_norm": (None,), "k_norm": (None,),
    "w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
    "w_down": ("ffn", "embed"),
}


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


def _attn_weights(cfg: ModelConfig, out_scale: float, gen: torch.Generator,
                  device) -> nn.ParameterDict:
    D, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
    return nn.ParameterDict({k: _frozen(v) for k, v in (
        ("wq", normal((D, Hq * hd), gen, device)),
        ("wk", normal((D, Hkv * hd), gen, device)),
        ("wv", normal((D, Hkv * hd), gen, device)),
        ("wo", normal((Hq * hd, D), gen, device, INIT_SCALE * out_scale)))})


class Layer(nn.Module):
    """One sub-layer: pre-normed self-attention, then (on an enc-dec
    decoder layer) pre-normed cross-attention, then a pre-normed MLP,
    each added to the residual.  Its parameters carry the JAX package's
    names (``ln1``, ``attn.wq`` ... ``attn.q_norm``, ``ln_x``,
    ``cross.wq`` ..., ``ln2``, ``mlp.w_gate`` ...) and are drawn in that
    order."""

    def __init__(self, cfg: ModelConfig, d: SubLayer, out_scale: float,
                 gen: torch.Generator, device):
        super().__init__()
        self.cfg, self.d = cfg, d
        D = cfg.d_model
        zeros = lambda n: _frozen(torch.zeros(n, device=device))  # noqa: E731
        self.ln1 = zeros(D)
        self.attn = _attn_weights(cfg, out_scale, gen, device)
        if cfg.qk_norm:
            self.attn["q_norm"] = zeros(cfg.hd)
            self.attn["k_norm"] = zeros(cfg.hd)
        if d.cross:
            self.ln_x = zeros(D)
            self.cross = _attn_weights(cfg, out_scale, gen, device)
        self.ln2 = zeros(D)
        self.mlp = nn.ParameterDict({
            k: _frozen(v) for k, v in init_mlp(D, cfg.d_ff, gen, device,
                                               out_scale).items()})

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                enc_out=None, collect: bool = False):
        """-> (x, this layer's cache entry, empty unless ``collect``)."""
        x, cache = _apply_attn(self, self.cfg, x, self.d, positions, collect)
        if self.d.cross and enc_out is not None:
            x, xk, xv = _apply_cross(self, self.cfg, x, enc_out)
            if collect:
                cache["xk"], cache["xv"] = xk.contiguous(), xv.contiguous()
        return _apply_ffn(self, self.cfg, x, self.d), cache


def _qk(p, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor):
    """q (B, Hq, L, hd), k and v (B, Hkv, L, hd) of the normed input h."""
    B, L, _ = h.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    q = (h @ p["wq"]).reshape(B, L, Hq, hd)
    k = (h @ p["wk"]).reshape(B, L, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, L, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q.transpose(1, 2), positions[None, None], cfg.rope_theta)
    k = rope(k.transpose(1, 2), positions[None, None], cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def _apply_attn(p: Layer, cfg: ModelConfig, x: torch.Tensor, d: SubLayer,
                positions: torch.Tensor, collect: bool = False):
    """-> (x + attention, the cache entry ``{"k", "v"}`` if ``collect``).
    A local layer keeps the last ``w`` positions, rolled so that
    position t sits at slot ``t % w``, as ``run_decode`` writes them."""
    B, L, _ = x.shape
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    q, k, v = _qk(p.attn, cfg, h, positions)
    window = cfg.sliding_window if d.mixer == "attn_local" else None
    if window is not None:
        o = attn_mod.local_attention(q, k, v, window)
    else:
        o = attn_mod.chunked_attention(q, k, v, causal=d.causal)
    o = o.transpose(1, 2).reshape(B, L, cfg.n_heads * cfg.hd)
    x = x + o @ p.attn["wo"]
    if not collect:
        return x, {}
    if window is not None:
        # with L < w the slice holds L entries and the roll is the identity
        return x, {"k": torch.roll(k[:, :, -window:], L % window, dims=2),
                   "v": torch.roll(v[:, :, -window:], L % window, dims=2)}
    return x, {"k": k.contiguous(), "v": v.contiguous()}


def _apply_cross(p: Layer, cfg: ModelConfig, x: torch.Tensor,
                 enc_out: torch.Tensor):
    """Cross-attention: q from the decoder's x, k/v from the encoder's
    output (no causal mask, Lq != Lk).  -> (x + attention, k, v)."""
    B, L, _ = x.shape
    S = enc_out.shape[1]
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    h = rms_norm(x, p.ln_x, cfg.norm_eps)
    q = (h @ p.cross["wq"]).reshape(B, L, Hq, hd).transpose(1, 2)
    k = (enc_out @ p.cross["wk"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    v = (enc_out @ p.cross["wv"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    o = attn_mod.chunked_attention(q, k, v, causal=False)
    o = o.transpose(1, 2).reshape(B, L, Hq * hd)
    return x + o @ p.cross["wo"], k, v


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
                 collect_cache: bool = False):
    """Forward through every layer of every segment; with
    ``collect_cache`` also the list of the layers' cache entries."""
    n = sum(len(descrs) * repeat for descrs, repeat in segments)
    if len(layers) != n:
        raise ValueError(f"run_segments: {len(layers)} layers, the segments "
                         f"of {cfg.name} have {n}")
    caches = []
    for layer in layers:
        x, c = layer(x, positions, enc_out, collect_cache)
        caches.append(c)
    return (x, caches) if collect_cache else x


# ---------------------------------------------------------------------------
# decode path (caches updated in place)
# ---------------------------------------------------------------------------

def layer_cache_spec(cfg: ModelConfig, d: SubLayer, batch: int,
                     seq_len: int) -> Dict[str, Tuple[tuple, tuple]]:
    """One sub-layer's cache: name -> (shape, logical axes).  A global
    layer holds ``seq_len`` positions on the ``"kv_seq"`` axis, a local
    layer a ring of ``sliding_window``, a cross layer ``max(1,
    prefix_len)`` source positions."""
    hd, Hkv = cfg.hd, cfg.n_kv
    seq = ("batch", None, "kv_seq", None)
    flat = ("batch", None, None, None)
    c: Dict[str, Tuple[tuple, tuple]] = {}
    if d.mixer == "attn":
        c["k"] = c["v"] = ((batch, Hkv, seq_len, hd), seq)
    elif d.mixer == "attn_local":
        c["k"] = c["v"] = ((batch, Hkv, cfg.sliding_window, hd), flat)
    if d.cross:
        c["xk"] = c["xv"] = ((batch, Hkv, max(1, cfg.prefix_len), hd), flat)
    return c


def init_layer_cache(cfg: ModelConfig, d: SubLayer, batch: int,
                     seq_len: int, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    """One sub-layer's zeroed cache (``layer_cache_spec``)."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, _) in layer_cache_spec(
                cfg, d, batch, seq_len).items()}


def _decode_sublayer(p: Layer, cfg: ModelConfig, c: Dict[str, torch.Tensor],
                     x1: torch.Tensor, d: SubLayer, posv: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """x1 (B, D) one token at ``posv`` (a (1,) long tensor); ``c`` this
    layer's cache, written in place at ``idx`` (``attention.cache_index``
    of its slot)."""
    B, _ = x1.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    h = rms_norm(x1, p.ln1, cfg.norm_eps)
    q = (h @ p.attn["wq"]).reshape(B, Hq, hd)
    k1 = (h @ p.attn["wk"]).reshape(B, Hkv, hd)
    v1 = (h @ p.attn["wv"]).reshape(B, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.attn["q_norm"], cfg.norm_eps)
        k1 = rms_norm(k1, p.attn["k_norm"], cfg.norm_eps)
    q = rope(q[:, :, None], posv[None, None], cfg.rope_theta)[:, :, 0]
    k1 = rope(k1[:, :, None], posv[None, None], cfg.rope_theta)[:, :, 0]
    # a local layer's ring holds positions (pos - w, pos]: all valid once
    # warm, so its mask is the global one
    kc, vc = attn_mod.cache_write(c["k"], c["v"], k1, v1, idx)
    o = attn_mod.decode_attention(q, kc, vc, posv)
    x1 = x1 + o.reshape(B, Hq * hd) @ p.attn["wo"]
    if d.cross:
        h = rms_norm(x1, p.ln_x, cfg.norm_eps)
        q = (h @ p.cross["wq"]).reshape(B, Hq, hd)
        o = attn_mod.decode_attention(q, c["xk"], c["xv"],
                                      c["xk"].shape[2] - 1)
        x1 = x1 + o.reshape(B, Hq * hd) @ p.cross["wo"]
    h = rms_norm(x1, p.ln2, cfg.norm_eps)
    return x1 + apply_mlp(p.mlp, h)


def run_decode(layers: nn.ModuleList, cfg: ModelConfig, caches,
               x1: torch.Tensor, pos):
    """One-token decode through every layer: x1 (B, D) at ``pos`` (an
    int or a 0-d tensor).  The caches (one dict a layer) are updated in
    place; returns (x1, caches)."""
    if len(caches) != len(layers):
        raise ValueError(f"run_decode: {len(caches)} layer caches for "
                         f"{len(layers)} layers")
    posv = (pos.to(x1.device, torch.long).reshape(1) if torch.is_tensor(pos)
            else torch.full((1,), int(pos), device=x1.device))
    idxs: Dict[tuple, torch.Tensor] = {}   # a write index a cache kind
    for layer, c in zip(layers, caches):
        local, S = layer.d.mixer == "attn_local", c["k"].shape[2]
        if (local, S) not in idxs:
            slot = posv % cfg.sliding_window if local else posv
            idxs[local, S] = attn_mod.cache_index(slot, S, x1.device)
        x1 = _decode_sublayer(layer, cfg, c, x1, layer.d, posv,
                              idxs[local, S])
    return x1, caches
