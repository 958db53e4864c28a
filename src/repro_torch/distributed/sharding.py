"""The sharded plane's mesh: S logical shards of one device.

The JAX package runs the sharded programs under ``shard_map`` over a
``("data", "model")`` device mesh: the posting pool shards over
``model``, query batches over ``data``.  Here the ``model`` axis is S
*logical* shards held by one process on one device: each shard owns a
contiguous block of ``max_postings / S`` postings (views into the global
tensors) and its own replica of every replicated field
(``core/sharded.py``), and a program runs its per-shard stages one shard
after another.  The collectives become plain functions over the S
per-shard values, taken **in shard order** (the merges' tie order
depends on it):

  * ``all_gather(tiled=True)`` -> :func:`all_gather` (``torch.cat``);
  * ``psum`` -> :func:`psum` (a sum, added in shard order);
  * ``pmax`` -> :func:`pmax`.

The ``data`` axis only sets the multiple that query batches pad to:
every query's answer is independent of the others, so padding changes
no answer.  A model axis across several cards (one process per card)
needs a machine with more than one card and is not part of this module.

The backbone's logical-axis rules (:func:`make_rules`) and their mapping
of a leaf's logical axes onto mesh axes (:func:`logical_to_spec`, a
tuple where the reference builds a ``PartitionSpec``) are the
reference's, over the port's ``Mesh.axis_names``; they read the axes
that ``LM.param_shapes`` and ``LM.cache_shapes`` return.  Placing
tensors by them needs several cards too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes by name (``shape``), their order (``axis_names``) and
    the device every shard lives on."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError("one size per axis name")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")
        if "model" not in self.axis_names:
            raise ValueError("the mesh needs a 'model' axis")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(n) for n in self.axis_sizes)))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None) -> Mesh:
    """A mesh of ``axis_shapes`` over ``axis_names`` (the arguments of
    ``jax.make_mesh``) on ``device`` (the card unless ``"cpu"``)."""
    from ..core.driver import resolve_device
    return Mesh(tuple(int(n) for n in axis_shapes), tuple(axis_names),
                resolve_device(device))


def default_mesh(cfg, device=None) -> Mesh:
    """The JAX package's rule: one ``model`` shard per device of the
    kind, falling back toward fewer shards until ``max_postings``
    divides.  The port runs on one device, so this is S = 1 on the CPU
    and on a one-card machine; S > 1 on one device (the layout the tests
    and ``chip_smoke.py`` use) is asked for with :func:`make_mesh`."""
    from ..core.driver import resolve_device
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    m = n
    while m > 1 and (cfg.max_postings % m or n % m):
        m -= 1
    return Mesh((n // m, m), ("data", "model"), dev)


def all_gather(xs: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the shards' values joined
    along ``axis`` in shard order."""
    return torch.cat(list(xs), dim=axis)


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``lax.psum``: the shards' values added in shard order.  Where one
    shard contributes a value and the others zeros, the sum is that value
    bit for bit, floats included."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def pmax(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``lax.pmax``: the largest of the shards' values."""
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


def make_rules(mesh: Mesh, kind: str = "train",
               long_context: bool = False) -> Dict[str, Any]:
    """Logical axis -> mesh axis (a name, a tuple of names or None) for a
    workload ``kind`` ("train" or "decode"): the batch and the FSDP
    parameter dim over ``data`` (with ``pod`` in front where the mesh
    has one), the tensor-parallel dims over ``model``, and on decode the
    KV caches' sequence axis over ``model`` (over the whole mesh, the
    batch unsharded, with ``long_context``)."""
    fsdp: Any = ("pod", "data") if "pod" in mesh.axis_names else "data"
    rules: Dict[str, Any] = {
        "batch": fsdp,
        "embed": fsdp,          # FSDP parameter dim
        "embed_out": None,
        "vocab": "model",
        "heads_flat": "model",
        "heads": "model",
        "ffn": "model",
        "experts": "model",
        "expert_ffn": None,
        "expert_cap": fsdp,
        "kv_seq": "model" if kind == "decode" else None,
        "layers": None,
    }
    if kind == "decode" and long_context:
        rules["batch"] = None
        rules["expert_cap"] = None
        rules["kv_seq"] = ("data", "model")
    return rules


def logical_to_spec(logical: Sequence[Optional[str]],
                    rules: Dict[str, Any]) -> Tuple[Any, ...]:
    """A leaf's logical axes -> its mesh axes, one entry a dim (None:
    replicated; a name the rules lack maps to None, as in the
    reference)."""
    return tuple(None if a is None else rules.get(a) for a in logical)
