"""The sharded plane's mesh: a grid of devices, data rows by model shards.

The JAX package runs the sharded programs under ``shard_map`` over a
``("data", "model")`` device mesh (``("pod", "data", "model")`` on a
pod): the posting pool shards over ``model``, query batches over the
data axes, and every field is whole over ``data``, so each data row
holds a whole replica of the shards.  JAX's sharded driver is a single
controller: one Python process drives every device of the mesh.  So is
the port's.  A :class:`Mesh` names one ``torch.device`` a cell of the
grid (``Mesh.devices``, row-major over the axes, the order of
``jax.make_mesh``): D rows (the product of the axes other than
``model``) of S ``model`` shards.  Cell (r, s) holds shard s's rows and
its replica of every replicated field in storage of its own
(``core/sharded.py``); each program runs a row's S stages, stage s under
its cell's device, and the collectives copy each shard's value onto the
device that consumes it and combine **in shard order** (the merges' tie
order depends on it):

  * ``all_gather(tiled=True)`` -> :func:`all_gather` (``torch.cat``);
  * ``psum`` -> :func:`psum` (a sum, added in shard order);
  * ``pmax`` -> :func:`pmax`.

Row r's controller, its shard 0's device (``mesh.row(r).device``),
runs the row's merges; the mesh's controller (``Mesh.device``) is cell
(0, 0)'s.  A search splits its batch over the rows; an update runs on every
row, so the rows stay identical.

On one card every cell is that card: the same code, each cell with its
own storage.  On several cards the launches of a stage return at once,
so the stages of a program, and the rows of a search, overlap across
the cards as they do under ``shard_map``; a copy between cards is
ordered after the producing stage and before the consuming one by the
two devices' current streams (PyTorch's device-to-device copy waits on
both).

The backbone's logical-axis rules (:func:`make_rules`) and their mapping
of a leaf's logical axes onto mesh axes (:func:`logical_to_spec`, a
tuple where the reference builds a ``PartitionSpec``) are the
reference's, over the port's ``Mesh.axis_names``; they read the axes
that ``LM.param_shapes`` and ``LM.cache_shapes`` return.
:func:`to_named_sharding` and :func:`batch_sharding` turn a tree of
logical axes into a tree of :class:`Placement` (the reference's
``NamedSharding``), and :func:`place` / :func:`gather` lay a tensor out
over the grid's cells by one and take it back.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def check_device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its card index resolved; raises
    ``RuntimeError`` when the card is missing."""
    d = torch.device(d)
    if d.type != "cuda":
        return d
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = d.index
    if index is None and n:
        index = torch.cuda.current_device()
    if index is None or not 0 <= index < n:
        raise RuntimeError(f"CUDA device {d} is not available: this "
                           f"machine has {n} cards")
    return torch.device("cuda", index)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes by name (``shape``), their order (``axis_names``) and
    the device of every cell (``devices``, row-major over the axes).  The
    grid is D rows (:attr:`n_rows`, the axes other than ``model``) of S
    ``model`` shards (:attr:`n_shards`).  ``device``, the controller, is
    cell (0, 0)'s: the driver's merges and host reads run there."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError("one size per axis name")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")
        if "model" not in self.axis_names:
            raise ValueError("the mesh needs a 'model' axis")
        cells = math.prod(int(n) for n in self.axis_sizes)
        if len(self.devices) != cells:
            raise ValueError(
                f"the mesh's grid {tuple(self.axis_sizes)} has {cells} "
                f"cells and names {len(self.devices)} devices: one device "
                "a cell")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(n) for n in self.axis_sizes)))

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def n_shards(self) -> int:
        return self.shape["model"]

    @property
    def n_rows(self) -> int:
        return len(self.devices) // self.n_shards

    @functools.cached_property
    def grid(self) -> np.ndarray:
        """(D, S): the index into ``devices`` of cell (row, shard)."""
        idx = np.arange(len(self.devices)).reshape(self.axis_sizes)
        idx = np.moveaxis(idx, self.axis_names.index("model"), -1)
        return idx.reshape(-1, self.n_shards)

    def row_devices(self, r: int) -> Tuple[torch.device, ...]:
        """Row ``r``'s devices, shard by shard."""
        return tuple(self.devices[i] for i in self.grid[r])

    def row(self, r: int) -> "Mesh":
        """Row ``r`` as a mesh of its own: every axis but ``model`` of
        size 1, so its controller is the row's."""
        return Mesh(tuple(n if a == "model" else 1
                          for a, n in zip(self.axis_names, self.axis_sizes)),
                    self.axis_names, self.row_devices(r))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``axis_shapes`` over ``axis_names`` (the arguments of
    ``jax.make_mesh``): every cell on ``device`` (the card unless
    ``"cpu"``), or cell i on ``devices[i]``, one a cell in row-major
    order over the axes (the order ``jax.make_mesh`` lays them out in)."""
    from ..core.driver import resolve_device
    sizes = tuple(int(n) for n in axis_shapes)
    names = tuple(axis_names)
    if devices is not None:
        if device is not None:
            raise ValueError("pass device= or devices=, not both")
        devs = tuple(check_device(d) for d in devices)
    else:
        devs = (check_device(resolve_device(device)),) * math.prod(sizes)
    return Mesh(sizes, names, devs)


def model_shards(max_postings: int, n_devices: int) -> int:
    """The JAX package's rule (``repro/api/sharded_driver.py:79-86``):
    every device on the ``model`` axis, falling back toward fewer shards
    until ``max_postings`` and the device count divide."""
    n = m = int(n_devices)
    while m > 1 and (max_postings % m or n % m):
        m -= 1
    return m


def default_mesh(cfg, device=None) -> Mesh:
    """The JAX rule over the cards of this process: n cards give m =
    :func:`model_shards` ``model`` shards and n // m data rows, every
    card a cell (``repro/api/sharded_driver.py:79-86``).  On the CPU
    (1, 1)."""
    from ..core.driver import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return Mesh((1, 1), ("data", "model"), (dev,))
    n = torch.cuda.device_count()
    m = model_shards(cfg.max_postings, n)
    return Mesh((n // m, m), ("data", "model"),
                tuple(check_device(torch.device("cuda", i))
                      for i in range((n // m) * m)))


def _to(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def all_gather(xs: Sequence[torch.Tensor], axis: int = 0,
               device=None) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the shards' values joined
    along ``axis`` in shard order, on ``device`` (shard 0's when None)."""
    dst = xs[0].device if device is None else device
    return torch.cat([_to(x, dst) for x in xs], dim=axis)


def psum(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """``lax.psum``: the shards' values added in shard order, on
    ``device`` (shard 0's when None).  Where one shard contributes a value
    and the others zeros, the sum is that value bit for bit, floats
    included."""
    dst = xs[0].device if device is None else device
    out = _to(xs[0], dst)
    for x in xs[1:]:
        out = out + _to(x, dst)
    return out


def pmax(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """``lax.pmax``: the largest of the shards' values, on ``device``
    (shard 0's when None)."""
    dst = xs[0].device if device is None else device
    out = _to(xs[0], dst)
    for x in xs[1:]:
        out = torch.maximum(out, _to(x, dst))
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


# ---------------------------------------------------------------------------
# placements: the reference's NamedSharding trees
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor lives: the mesh and one mesh-axis entry a dim
    (None, a name or a tuple of names), the reference's
    ``NamedSharding(mesh, PartitionSpec(*spec))``.  A dim whose entry
    names mesh axes splits over them (over the product of their sizes,
    the first named axis major: ``("data", "model")`` splits over the
    whole grid row-major); a tensor is whole over every axis that no
    entry names, so one that names none is whole on every cell."""

    mesh: Mesh
    spec: Tuple[Any, ...]

    @property
    def model_dim(self) -> Optional[int]:
        for i, e in enumerate(self.spec):
            if e == "model" or (isinstance(e, tuple) and "model" in e):
                return i
        return None

    @property
    def splits(self) -> List[Tuple[int, Tuple[str, ...]]]:
        """(dim, the mesh axes it splits over) for every split dim."""
        out = []
        for i, e in enumerate(self.spec):
            names = e if isinstance(e, tuple) else (e,)
            axes = tuple(a for a in names if a in self.mesh.axis_names)
            if axes:
                out.append((i, axes))
        return out

    def blocks(self) -> List[Tuple[int, ...]]:
        """Cell i's block index along each split dim, cell by cell."""
        sizes = self.mesh.shape
        coords = dict(zip(self.mesh.axis_names, np.unravel_index(
            np.arange(len(self.mesh.devices)), self.mesh.axis_sizes)))
        per_dim = [np.ravel_multi_index([coords[a] for a in axes],
                                        [sizes[a] for a in axes])
                   for _, axes in self.splits]
        return [tuple(int(b[i]) for b in per_dim)
                for i in range(len(self.mesh.devices))]


def _is_axes(x) -> bool:
    """A leaf of a logical tree: a tuple of axis names (or None)."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _tree_map(fn, tree):
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else type(tree)(out)
    if tree is None:
        return None
    raise TypeError(f"not a tree of logical axes: {type(tree).__name__}")


def to_named_sharding(mesh: Mesh, logical_tree, rules: Dict[str, Any]):
    """Tree of logical axes (tuples, as ``LM.param_shapes`` returns them)
    -> tree of :class:`Placement` (``repro/distributed/sharding.py:89-96``)."""
    return _tree_map(lambda ax: Placement(mesh, logical_to_spec(ax, rules)),
                     logical_tree)


def batch_sharding(mesh: Mesh, ax_tree, rules: Dict[str, Any]):
    """Tree of logical-axes tuples -> tree of :class:`Placement`
    (``repro/distributed/sharding.py:99-110``: the reference takes
    tuples or ``PartitionSpec`` leaves; the port's specs are tuples)."""
    return _tree_map(
        lambda ax: Placement(mesh, tuple(None if a is None else rules.get(a)
                                         for a in ax)),
        ax_tree)


def place(t: torch.Tensor, placement: Placement) -> List[torch.Tensor]:
    """``t`` laid out over ``placement.mesh.devices``: cell i's part (its
    block of every split dim, the whole tensor where no dim splits), a
    copy of its own on ``devices[i]``."""
    mesh = placement.mesh
    sizes = mesh.shape
    splits = placement.splits
    for dim, axes in splits:
        k, n = math.prod(sizes[a] for a in axes), t.shape[dim]
        if n % k:
            raise ValueError(f"dim {dim} of size {n} does not divide over "
                             f"{k} shards ({' x '.join(axes)})")
    out = []
    for dev, block in zip(mesh.devices, placement.blocks()):
        p = t
        for (dim, axes), b in zip(splits, block):
            w = t.shape[dim] // math.prod(sizes[a] for a in axes)
            p = p.narrow(dim, b * w, w)
        out.append(p.to(dev, copy=True).contiguous())
    return out


def gather(parts: Sequence[torch.Tensor], placement: Placement,
           device=None) -> torch.Tensor:
    """:func:`place`'s inverse: the whole tensor on ``device`` (the
    mesh's controller when None), in storage of its own, each block
    read from the first cell that holds it."""
    dst = torch.device(placement.mesh.device if device is None else device)
    splits = placement.splits
    if not splits:
        return parts[0].to(dst, copy=True)
    held = {}
    for p, block in zip(parts, placement.blocks()):
        held.setdefault(block, p)
    sizes = placement.mesh.shape
    # a copy to the host is waited for; one between cards is ordered by
    # the two devices' streams
    blocking = dst.type == "cpu"

    def join(level: int, prefix: tuple) -> torch.Tensor:
        if level == len(splits):
            p = held[prefix]
            return p.to(dst) if blocking else _to(p, dst)
        dim, axes = splits[level]
        k = math.prod(sizes[a] for a in axes)
        return torch.cat([join(level + 1, prefix + (b,)) for b in range(k)],
                         dim=dim)
    return join(0, ())
