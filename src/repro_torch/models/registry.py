"""Model registry: config -> ``LM`` module, plus the architecture catalogue.

Counterpart of ``repro/models/registry.py``.  ``LM`` owns its parameters
as an ``nn.Module``: drawn on its device from a seeded
``torch.Generator`` (the JAX package draws from a ``jax.random`` key,
whose numbers no torch generator reproduces; ``repro_torch.bridge``
carries the JAX draws across where the two must compute the same thing).
The serving path needs one forward: embedding -> every layer -> ``ln_f``
(:meth:`LM.hidden`).  The JAX kernel has no backward, and nothing here
trains; ``prefill``, ``decode_step``, ``train_loss`` and ``init_cache``
belong to the decode slice and raise.  So does the output ``head``, which
only the loss and the decode step read: ``LM`` draws none, and the
``qk_norm`` architectures raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ..core.driver import resolve_device
from .config import ModelConfig
from .layers import normal, rms_norm
from .transformer import DECODE_SLICE, build_layers, plan_segments, run_segments


class LM(nn.Module):
    """One architecture, fully assembled, its weights drawn from ``seed``
    on ``device`` (default: the card; without CUDA that raises unless
    ``device="cpu"`` is passed)."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        if cfg.family == "encdec":
            raise NotImplementedError(f"the encoder-decoder family "
                                      f"{DECODE_SLICE}")
        if cfg.qk_norm:
            raise NotImplementedError(f"qk_norm {DECODE_SLICE}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = plan_segments(cfg)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        n_total = max(cfg.n_layers + cfg.encoder_layers, 1)
        out_scale = 1.0 / (2.0 * n_total) ** 0.5
        frozen = lambda t: nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.emb = frozen(normal((cfg.vocab_padded, cfg.d_model), gen,
                                 self.device))
        self.ln_f = frozen(torch.zeros(cfg.d_model, device=self.device))
        self.layers = build_layers(cfg, self.segments, out_scale, gen,
                                   self.device)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) int -> final-normed hidden states (B, L, d_model)."""
        tokens = tokens.to(self.device)
        x = self.emb[tokens.long()]
        positions = torch.arange(tokens.shape[1], device=self.device)
        x = run_segments(self.layers, self.cfg, self.segments, x, positions)
        return rms_norm(x, self.ln_f, self.cfg.norm_eps)

    forward = hidden

    def train_loss(self, *args, **kwargs):
        raise NotImplementedError(f"train_loss {DECODE_SLICE}")

    def prefill(self, *args, **kwargs):
        raise NotImplementedError(f"prefill {DECODE_SLICE}")

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError(f"decode_step {DECODE_SLICE}")

    def init_cache(self, *args, **kwargs):
        raise NotImplementedError(f"init_cache {DECODE_SLICE}")


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
