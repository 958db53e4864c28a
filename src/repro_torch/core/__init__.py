"""UBIS core on PyTorch: the single-device float and quant planes."""
from . import balance, build, metrics, search, update, version_manager
from .driver import UBISDriver
from .types import (BackgroundRound, IndexState, RoundResult, UBISConfig,
                    empty_state, state_memory_bytes)

__all__ = [
    "BackgroundRound", "IndexState", "RoundResult", "UBISConfig",
    "UBISDriver", "balance", "build", "empty_state", "metrics", "search",
    "state_memory_bytes", "update", "version_manager",
]
