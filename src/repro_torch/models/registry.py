"""Model registry: config -> ``LM`` module (forward, ``train_loss``,
``prefill``, ``decode_step``, caches), plus the architecture catalogue.

Counterpart of ``repro/models/registry.py``.  ``LM`` owns its parameters
as an ``nn.Module``: drawn on its device from a seeded
``torch.Generator`` (the JAX package draws from a ``jax.random`` key,
whose numbers no torch generator reproduces; ``repro_torch.bridge``
carries the JAX draws across where the two must compute the same thing).
The draws go in this order: ``emb``, the decoder layers, ``head`` (so a
seed gives the serving path the weights it gave before the head was
drawn), then the encoder's layers.  The serving path needs one forward:
embedding -> every layer -> ``ln_f`` (:meth:`LM.hidden`).  The weights
stay frozen: the reference's flash kernel has no backward, so
``train_loss`` is a forward loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..core.driver import resolve_device
from .config import ModelConfig
from .layers import normal, rms_norm
from .transformer import (LEAF_AXES, SubLayer, build_layers,
                          init_layer_cache, layer_cache_spec, plan_segments,
                          run_decode, run_segments)

ENC_SRC_LEN = 1024  # audio-frontend stub length (encdec)
NEG = -1e30         # the logit of a padded vocab entry


def chunked_lm_loss(x: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 1024,
                    vocab_real: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy over the positions where ``mask`` is set,
    without materialising (B, L, V) logits at once: ``chunk`` positions
    at a time.  ``vocab_real``: the padded vocab's logits are masked out
    of the softmax.  The reference pads the last chunk with masked rows,
    which add nothing; here the last chunk is just shorter.  All masked
    gives 0 (the count is clamped at 1)."""
    L = x.shape[1]
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, L, chunk):
        logits = (x[:, c0:c0 + chunk] @ head).float()
        V = logits.shape[-1]
        if vocab_real is not None and vocab_real < V:
            pad = torch.arange(V, device=x.device) >= vocab_real
            logits = logits.masked_fill(pad, NEG)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          targets[:, c0:c0 + chunk, None].long())[..., 0]
        m = mask[:, c0:c0 + chunk].float()
        s = s + ((lse - ll) * m).sum()
        n = n + m.sum()
    return s / n.clamp_min(1.0)


class Encoder(nn.Module):
    """The enc-dec family's bidirectional encoder: its layers and
    ``ln_f`` (the reference's ``enc`` subtree)."""

    def __init__(self, cfg: ModelConfig, segments, out_scale: float,
                 gen: torch.Generator, device):
        super().__init__()
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, device=device),
                                 requires_grad=False)
        self.layers = build_layers(cfg, segments, out_scale, gen, device)


class LM(nn.Module):
    """One architecture, fully assembled, its weights drawn from ``seed``
    on ``device`` (default: the card; without CUDA that raises unless
    ``device="cpu"`` is passed)."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = plan_segments(cfg)
        self.enc_segments = (
            [((SubLayer("attn", "mlp", causal=False),), cfg.encoder_layers)]
            if cfg.family == "encdec" else [])
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        n_total = max(cfg.n_layers + cfg.encoder_layers, 1)
        out_scale = 1.0 / (2.0 * n_total) ** 0.5
        frozen = lambda t: nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.emb = frozen(normal((cfg.vocab_padded, cfg.d_model), gen,
                                 self.device))
        self.ln_f = frozen(torch.zeros(cfg.d_model, device=self.device))
        self.layers = build_layers(cfg, self.segments, out_scale, gen,
                                   self.device)
        if not cfg.tie_embeddings:
            self.head = frozen(normal((cfg.d_model, cfg.vocab_padded), gen,
                                      self.device))
        if self.enc_segments:
            self.enc = Encoder(cfg, self.enc_segments, out_scale, gen,
                               self.device)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) int -> final-normed hidden states (B, L, d_model)."""
        tokens = tokens.to(self.device)
        x = self.emb[tokens.long()]
        positions = torch.arange(tokens.shape[1], device=self.device)
        x = run_segments(self.layers, self.cfg, self.segments, x, positions)
        return rms_norm(x, self.ln_f, self.cfg.norm_eps)

    forward = hidden

    # -- shapes without allocating ------------------------------------------

    def param_shapes(self, dtype=torch.float32):
        """(parameter name -> a tensor of its shape and ``dtype`` (None:
        its own) on the ``meta`` device, name -> its logical axes).  A
        layer's leaf carries no ``"layers"`` axis: the port keeps one
        module a layer where the reference stacks a segment."""
        sd = self.state_dict()
        vals = {k: torch.empty(t.shape, dtype=dtype or t.dtype,
                               device="meta") for k, t in sd.items()}
        return vals, {k: LEAF_AXES[k.rsplit(".", 1)[-1]] for k in sd}

    # -- forward paths --------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _encode(self, src: torch.Tensor) -> torch.Tensor:
        if not self.enc_segments:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) has no "
                             "encoder for a 'src'")
        positions = torch.arange(src.shape[1], device=self.device)
        x = run_segments(self.enc.layers, self.cfg, self.enc_segments, src,
                         positions)
        return rms_norm(x, self.enc.ln_f, self.cfg.norm_eps)

    def _inputs(self, batch: Dict[str, Any]):
        """The embedded tokens, after the ``prefix`` embeddings (vlm) if
        any; the encoder's output of ``src`` (encdec) or None; the prefix
        length."""
        x = self.emb[self._tensor(batch["tokens"]).long()]
        enc_out, prefix_len = None, 0
        if "prefix" in batch:                      # vlm patch embeddings
            prefix = self._tensor(batch["prefix"]).to(x.dtype)
            x = torch.cat([prefix, x], dim=1)
            prefix_len = prefix.shape[1]
        if "src" in batch:                         # audio frames (encdec)
            enc_out = self._encode(self._tensor(batch["src"]).to(x.dtype))
        return x, enc_out, prefix_len

    def _head(self) -> torch.Tensor:
        return self.emb.T if self.cfg.tie_embeddings else self.head

    def _mask_pad_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        if self.cfg.vocab_padded > self.cfg.vocab:
            pad = torch.arange(logits.shape[-1],
                               device=logits.device) >= self.cfg.vocab
            logits = logits.masked_fill(pad, NEG)
        return logits

    def train_loss(self, batch: Dict[str, Any]):
        """Next-token loss of ``batch["targets"]`` (B, L) int (< 0:
        masked), a forward pass only.  -> (loss, {"lm_loss": loss})."""
        cfg = self.cfg
        x, enc_out, prefix_len = self._inputs(batch)
        positions = torch.arange(x.shape[1], device=self.device)
        x = run_segments(self.layers, cfg, self.segments, x, positions,
                         enc_out=enc_out)
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        if prefix_len:
            x = x[:, prefix_len:]
        targets = self._tensor(batch["targets"]).long()
        loss = chunked_lm_loss(x, self._head(), targets.clamp_min(0),
                               targets >= 0, vocab_real=cfg.vocab)
        return loss, {"lm_loss": loss}

    def prefill(self, batch: Dict[str, Any]):
        """-> (the last position's logits (B, vocab_padded) fp32, padded
        entries -1e30; the caches, one dict a layer, each as long as the
        input: L for a global layer, ``min(L, sliding_window)`` for a
        local one)."""
        cfg = self.cfg
        x, enc_out, _ = self._inputs(batch)
        positions = torch.arange(x.shape[1], device=self.device)
        x, caches = run_segments(self.layers, cfg, self.segments, x,
                                 positions, enc_out=enc_out,
                                 collect_cache=True)
        x = rms_norm(x[:, -1], self.ln_f, cfg.norm_eps)
        return self._mask_pad_vocab((x @ self._head()).float()), caches

    def decode_step(self, caches: List[Dict[str, torch.Tensor]], token,
                    pos):
        """token (B,) int at position ``pos`` (an int or a 0-d tensor);
        caches as :meth:`init_cache` or :meth:`prefill` give them.
        Returns (logits (B, vocab_padded) fp32, the caches).

        The caches are updated **in place** and returned (the reference
        returns new arrays).  A ``pos`` past a cache's end writes its
        last entry, as the reference's clamped update does."""
        cfg = self.cfg
        x1 = self.emb[self._tensor(token).long()]
        x1, caches = run_decode(self.layers, cfg, caches, x1, pos)
        x1 = rms_norm(x1, self.ln_f, cfg.norm_eps)
        return self._mask_pad_vocab((x1 @ self._head()).float()), caches

    # -- caches ----------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int, dtype=torch.float32,
                   device=None) -> List[Dict[str, torch.Tensor]]:
        """Zeroed caches, one dict a layer (``layer_cache_spec``), on
        ``device`` (default: the model's)."""
        dev = self.device if device is None else torch.device(device)
        return [init_layer_cache(self.cfg, layer.d, batch, seq_len, dtype,
                                 dev) for layer in self.layers]

    def grow_caches(self, caches: List[Dict[str, torch.Tensor]],
                    seq_len: int) -> List[Dict[str, torch.Tensor]]:
        """``caches`` (as :meth:`prefill` gives them, only as long as its
        input) written into positions [0, L) of fresh ``init_cache(B,
        seq_len)``, so that decode steps can run past L: a decode at a
        position past a cache's end overwrites its last entry (the
        reference's clamped update)."""
        leaf = caches[0]["k"]
        out = self.init_cache(leaf.shape[0], seq_len, leaf.dtype,
                              leaf.device)
        for c, p in zip(out, caches):
            for name, t in p.items():
                c[name][:, :, :t.shape[2]] = t
        return out

    def cache_shapes(self, batch: int, seq_len: int, dtype=torch.float32):
        """(:meth:`init_cache` on the ``meta`` device, the same list with
        each leaf's logical axes)."""
        specs = [layer_cache_spec(self.cfg, layer.d, batch, seq_len)
                 for layer in self.layers]
        return (self.init_cache(batch, seq_len, dtype, "meta"),
                [{k: ax for k, (_, ax) in s.items()} for s in specs])


# ---------------------------------------------------------------------------
# catalogue (the serving backbone's only arch)
# ---------------------------------------------------------------------------

_CONFIGS: Dict[str, ModelConfig] = {
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv=4, d_ff=5632, vocab=32000),
}

ARCH_IDS = list(_CONFIGS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _CONFIGS:
        raise ValueError(f"unknown arch {arch_id!r}; choose from "
                         f"{ARCH_IDS}")
    return _CONFIGS[arch_id]


def get_model(arch_id: str, *, reduced: bool = False, device=None,
              seed: int = 0, **overrides) -> LM:
    """The catalogue's ``arch_id`` (its ``reduced()`` CPU-size variant
    with ``reduced=True``), config fields overridden by ``overrides``."""
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return LM(cfg, device=device, seed=seed)
