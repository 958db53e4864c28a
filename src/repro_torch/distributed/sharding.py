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
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

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
