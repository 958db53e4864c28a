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
* The backbone's KV caches: the JAX package's cache tree (a list per
  segment of ``{str(i): {"k", "v"[, "xk", "xv"]}}``, each leaf stacked
  over the segment's repeats) as the port's list of one dict a layer,
  and back.

Layer n of the port is repeat r of descriptor i of segment s, in
execution order (``_layer_index``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

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


def _layer_index(segments):
    """(layer n, segment s, repeat r, descriptor i) in execution order."""
    n = 0
    for si, (descrs, repeat) in enumerate(segments):
        for r in range(repeat):
            for i in range(len(descrs)):
                yield n, si, r, i
                n += 1


def lm_state_from_numpy(tree: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (a ``repro_torch.models.LM``) holding
    the JAX package's weights ``tree``: ``emb``, ``ln_f``, ``head``
    (untied models), ``seg{s}`` -> ``{i}`` -> ``ln1``/``attn``/``ln_x``/
    ``cross``/``ln2``/``mlp`` leaves of shape ``(repeat, ...)``, and on
    an enc-dec model ``enc`` -> ``ln_f`` and its own ``seg{s}`` (the
    port's ``enc.layers``).  Shapes are checked against the model's, and
    every parameter of the model must get a value; the tensors land on
    the model's device."""
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

    def put_layers(prefix, sub, segments):
        for n, si, r, i in _layer_index(segments):
            for group, leaf in sub[f"seg{si}"][str(i)].items():
                if isinstance(leaf, dict):
                    for name, a in leaf.items():
                        put(f"{prefix}.{n}.{group}.{name}", np.asarray(a)[r])
                else:
                    put(f"{prefix}.{n}.{group}", np.asarray(leaf)[r])

    for name in ("emb", "ln_f", "head"):
        if name in tree:
            put(name, tree[name])
    put_layers("layers", tree, model.segments)
    if "enc" in tree:
        put("enc.ln_f", tree["enc"]["ln_f"])
        put_layers("enc.layers", tree["enc"], model.enc_segments)
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"lm_state_from_numpy: no weights for {missing}")
    return out


def lm_caches_from_numpy(caches, model) -> List[Dict[str, torch.Tensor]]:
    """The port's caches (one dict a layer, on the model's device) from
    the JAX package's cache tree: a list per segment of ``{str(i): {"k",
    "v"[, "xk", "xv"]}}``, each leaf ``(repeat, B, Hkv, S, hd)``."""
    if len(caches) != len(model.segments):
        raise ValueError(f"lm_caches_from_numpy: {len(caches)} segments, "
                         f"the model has {len(model.segments)}")
    out: List[Dict[str, torch.Tensor]] = []
    for n, si, r, i in _layer_index(model.segments):
        layer = {}
        for name, a in caches[si][str(i)].items():
            a = np.asarray(a)
            if a.shape[:1] != (model.segments[si][1],) or a.ndim != 5:
                raise ValueError(f"lm_caches_from_numpy: {name} of segment "
                                 f"{si} has shape {a.shape}, not (repeat="
                                 f"{model.segments[si][1]}, B, Hkv, S, hd)")
            layer[name] = torch.from_numpy(np.array(a[r], order="C")).to(
                model.device)
        out.append(layer)
    return out


def lm_caches_to_numpy(caches, model) -> List[Dict[str, Dict[str, np.ndarray]]]:
    """The JAX package's cache tree (a list per segment of ``{str(i):
    {leaf: (repeat, ...)}}``) from the port's caches, one dict a layer."""
    index = list(_layer_index(model.segments))
    if len(caches) != len(index):
        raise ValueError(f"lm_caches_to_numpy: {len(caches)} layer caches, "
                         f"the model has {len(index)} layers")
    out = [{str(i): {} for i in range(len(descrs))}
           for descrs, _ in model.segments]
    for n, si, _, i in index:            # repeats come in order
        for name, t in caches[n].items():
            out[si][str(i)].setdefault(name, []).append(
                t.detach().cpu().numpy())
    return [{i: {name: np.stack(rows) for name, rows in leaves.items()}
             for i, leaves in seg.items()} for seg in out]
