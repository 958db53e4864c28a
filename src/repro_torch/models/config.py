"""Model configuration schema of the serving embed backbone.

A copy of the JAX package's ``repro/models/config.py`` (pure Python; the
port keeps its own so that it never imports the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture of the serving embed backbone."""

    name: str
    family: str                       # dense | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                      # query heads
    n_kv: int                         # kv heads (GQA)
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # local/global interleave: window size + pattern period; pattern
    # "LLLLLG" means 5 local then 1 global
    sliding_window: Optional[int] = None
    local_global_pattern: Optional[str] = None
    # encoder-decoder: encoder layer count (decoder = n_layers)
    encoder_layers: int = 0
    # multimodal stubs: number of prefix embeddings supplied by frontend
    prefix_len: int = 0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        """Embedding tables pad the vocab to a multiple of 256 so the
        vocab axis divides any mesh axis (pad logits are masked out of
        the loss and the decode head)."""
        return -(-self.vocab // 256) * 256

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=min(self.n_heads, 4) or 0,
            n_kv=min(self.n_kv, 2) or 0,
            d_ff=256,
            vocab=min(self.vocab, 512),
            head_dim=32 if self.n_heads else None,
            encoder_layers=min(self.encoder_layers, 2),
            prefix_len=min(self.prefix_len, 4),
            sliding_window=(64 if self.sliding_window else None),
        )
        if self.local_global_pattern is not None:
            kw["local_global_pattern"] = self.local_global_pattern
            kw["n_layers"] = len(self.local_global_pattern)
        kw.update(overrides)
        return dataclasses.replace(self, **kw)
