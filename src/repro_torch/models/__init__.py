"""Serving embed backbone (attention-only), on PyTorch."""
from .config import ModelConfig
from .registry import ARCH_IDS, LM, get_config, get_model

__all__ = ["ModelConfig", "LM", "ARCH_IDS", "get_config", "get_model"]
