"""Carry state between the JAX package and the port as numpy.

* An index state, in the JAX package's checkpoint format
  (``repro/checkpoint/manager.py:31-36``): a dict of numpy arrays keyed
  by ``IndexState`` field name.  The fields the JAX package keeps as
  uint32 (``UINT32_FIELDS``) are int64 in the port and are cast both
  ways; every other field keeps its dtype.
* The embed backbone's weights: the JAX package's parameter tree
  (``values(LM.init(key))`` as nested dicts of numpy arrays, each
  period's weights stacked over its repeats) as the port's ``LM``
  state dict (one module per layer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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


def lm_state_from_numpy(tree: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (a ``repro_torch.models.LM``) holding
    the JAX package's weights ``tree``: keys ``emb``, ``ln_f`` and
    ``seg{s}`` -> ``{i}`` -> ``ln1``/``attn``/``ln2``/``mlp`` leaves of
    shape ``(repeat, ...)``; its ``head`` is skipped (the port's ``LM``
    has none until the decode slice).  Layer n of the port is repeat r of
    descriptor i of segment s, in execution order.  Shapes are checked
    against the model's; the tensors land on the model's device."""
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}

    def put(key, a):
        a = np.asarray(a)
        if key not in want:
            raise ValueError(f"lm_state_from_numpy: {key} is not a "
                             f"parameter of the port's model")
        if tuple(a.shape) != tuple(want[key].shape):
            raise ValueError(f"lm_state_from_numpy: {key} has shape "
                             f"{a.shape}, the model wants "
                             f"{tuple(want[key].shape)}")
        out[key] = torch.from_numpy(np.array(a, np.float32, order="C")).to(
            want[key].device)

    for name in ("emb", "ln_f"):
        put(name, tree[name])
    n = 0
    for si, (descrs, repeat) in enumerate(model.segments):
        seg = tree[f"seg{si}"]
        for r in range(repeat):
            for i in range(len(descrs)):
                for group, leaf in seg[str(i)].items():
                    if isinstance(leaf, dict):
                        for name, a in leaf.items():
                            put(f"layers.{n}.{group}.{name}",
                                np.asarray(a)[r])
                    else:
                        put(f"layers.{n}.{group}", np.asarray(leaf)[r])
                n += 1
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"lm_state_from_numpy: no weights for {missing}")
    return out
