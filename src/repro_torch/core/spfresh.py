"""SPFresh baseline (paper III-B2): the in-place LIRE protocol with
posting-level locking and strict split/merge triggers.

The substrate is shared with UBIS; ``mode="spfresh"`` switches the
driver/balance semantics:
  * blocked jobs (target not NORMAL) are rejected + retried — the lock;
  * splits trigger only on insert overflow; merges only when a search
    touches an undersized posting;
  * plain farthest-init 2-means splits, no balance-factor branch —
    which is what litters small postings (paper Fig. 5).
"""
from __future__ import annotations

import dataclasses

from .driver import UBISDriver
from .types import UBISConfig


def spfresh_config(cfg: UBISConfig) -> UBISConfig:
    return dataclasses.replace(cfg, mode="spfresh")


def SPFreshDriver(cfg: UBISConfig, seed_vectors, **kw) -> UBISDriver:
    """A UBISDriver with SPFresh semantics."""
    return UBISDriver(spfresh_config(cfg), seed_vectors, **kw)
