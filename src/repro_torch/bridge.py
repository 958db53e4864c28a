"""Carry an index state between the JAX package and the port as numpy.

The format is the JAX package's checkpoint format
(``repro/checkpoint/manager.py:31-36``): a dict of numpy arrays keyed by
``IndexState`` field name.  The fields the JAX package keeps as uint32
(``UINT32_FIELDS``) are int64 in the port and are cast both ways; every
other field keeps its dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.types import UINT32_FIELDS, IndexState, UBISConfig, empty_state

FIELDS = tuple(f.name for f in dataclasses.fields(IndexState))


def state_from_numpy(arrays: Dict[str, np.ndarray], cfg: UBISConfig,
                     device) -> IndexState:
    """An ``IndexState`` on ``device`` from numpy arrays keyed by field
    name; shapes are checked against ``cfg``."""
    missing = set(FIELDS) - set(arrays)
    extra = set(arrays) - set(FIELDS)
    if missing or extra:
        raise ValueError(f"state_from_numpy: missing {sorted(missing)}, "
                         f"unknown {sorted(extra)}")
    ref = empty_state(cfg, "meta")
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        want = getattr(ref, name)
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(f"state_from_numpy: {name} has shape "
                             f"{a.shape}, cfg wants {tuple(want.shape)}")
        if name in UINT32_FIELDS:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.array(a, order="C")).to(device)
        out[name] = t.to(want.dtype)
    return IndexState(**out)


def state_to_numpy(state: IndexState) -> Dict[str, np.ndarray]:
    """Numpy arrays keyed by field name, in the JAX package's dtypes."""
    out = {}
    for name in FIELDS:
        a = getattr(state, name).cpu().numpy()
        out[name] = a.astype(np.uint32) if name in UINT32_FIELDS else a
    return out
