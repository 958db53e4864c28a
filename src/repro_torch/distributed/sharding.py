"""The sharded plane's mesh: one ``model`` shard a device.

The JAX package runs the sharded programs under ``shard_map`` over a
``("data", "model")`` device mesh: the posting pool shards over
``model``, query batches over ``data``.  JAX's sharded driver is a
single controller: one Python process drives every device of the mesh.
So is the port's.  A :class:`Mesh` names one ``torch.device`` per
``model`` shard (``Mesh.devices``): shard s's rows and its replica of
every replicated field live on ``devices[s]`` in storage of their own
(``core/sharded.py``), each program runs shard s's stage under that
device, and the collectives copy each shard's value onto the device
that consumes it and combine **in shard order** (the merges' tie order
depends on it):

  * ``all_gather(tiled=True)`` -> :func:`all_gather` (``torch.cat``);
  * ``psum`` -> :func:`psum` (a sum, added in shard order);
  * ``pmax`` -> :func:`pmax`.

On one card ``devices`` is that card S times: the same code, each shard
with its own storage.  On several cards the launches of a stage return
at once, so the S stages of a program overlap across the cards as they
do under ``shard_map``; a copy between cards is ordered after the
producing stage and before the consuming one by the two devices' current
streams (PyTorch's device-to-device copy waits on both).

The ``data`` axis only sets the multiple that query batches pad to:
every query's answer is independent of the others, so padding changes
no answer.  It holds no devices: a data x model mesh over cards, which
would replicate the pool over ``data``, is not ported, and a mesh whose
device list is not one device a ``model`` shard raises.

The backbone's logical-axis rules (:func:`make_rules`) and their mapping
of a leaf's logical axes onto mesh axes (:func:`logical_to_spec`, a
tuple where the reference builds a ``PartitionSpec``) are the
reference's, over the port's ``Mesh.axis_names``; they read the axes
that ``LM.param_shapes`` and ``LM.cache_shapes`` return.
:func:`to_named_sharding` and :func:`batch_sharding` turn a tree of
logical axes into a tree of :class:`Placement` (the reference's
``NamedSharding``), and :func:`place` / :func:`gather` lay a tensor out
over ``mesh.devices`` by one and take it back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    the device of every ``model`` shard (``devices``).  ``device``, the
    controller, is shard 0's: the merges and the host reads run there."""

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
        S = self.shape["model"]
        if len(self.devices) != S:
            raise ValueError(
                f"the mesh has {S} model shards and names "
                f"{len(self.devices)} devices: one device a model shard "
                "(a data x model mesh over cards is not ported)")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(n) for n in self.axis_sizes)))

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``axis_shapes`` over ``axis_names`` (the arguments of
    ``jax.make_mesh``): every ``model`` shard on ``device`` (the card
    unless ``"cpu"``), or shard j on ``devices[j]``, one a shard."""
    from ..core.driver import resolve_device
    sizes = tuple(int(n) for n in axis_shapes)
    names = tuple(axis_names)
    if devices is not None:
        if device is not None:
            raise ValueError("pass device= or devices=, not both")
        devs = tuple(check_device(d) for d in devices)
    else:
        S = dict(zip(names, sizes)).get("model", 1)
        devs = (check_device(resolve_device(device)),) * S
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
    :func:`model_shards` ``model`` shards, one a card on the first m
    cards, and a data axis of n // m (the query batches' multiple; it
    holds no devices).  On the CPU S = 1."""
    from ..core.driver import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return Mesh((1, 1), ("data", "model"), (dev,))
    n = torch.cuda.device_count()
    m = model_shards(cfg.max_postings, n)
    return Mesh((n // m, m), ("data", "model"),
                tuple(check_device(torch.device("cuda", i))
                      for i in range(m)))


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
    ``NamedSharding(mesh, PartitionSpec(*spec))``.  Only ``model`` holds
    devices: the dim whose entry names ``model`` splits over
    ``mesh.devices``; a tensor with no such dim is whole on every
    shard's device."""

    mesh: Mesh
    spec: Tuple[Any, ...]

    @property
    def model_dim(self) -> Optional[int]:
        for i, e in enumerate(self.spec):
            if e == "model" or (isinstance(e, tuple) and "model" in e):
                return i
        return None


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
    """``t`` laid out over ``placement.mesh.devices``: shard j's part (its
    block of the ``model`` dim, or the whole tensor where no dim names
    ``model``), a copy of its own on ``devices[j]``."""
    devs = placement.mesh.devices
    dim = placement.model_dim
    if dim is None:
        return [t.to(d, copy=True) for d in devs]
    S = len(devs)
    n = t.shape[dim]
    if n % S:
        raise ValueError(f"dim {dim} of size {n} does not divide over "
                         f"{S} model shards")
    return [p.to(d, copy=True).contiguous()
            for p, d in zip(torch.split(t, n // S, dim=dim), devs)]


def gather(parts: Sequence[torch.Tensor], placement: Placement,
           device=None) -> torch.Tensor:
    """:func:`place`'s inverse: the whole tensor on ``device`` (the
    mesh's controller when None), in storage of its own."""
    dst = placement.mesh.device if device is None else device
    dim = placement.model_dim
    if dim is None:
        return parts[0].to(dst, copy=True)
    if len(parts) == 1:
        return parts[0].to(dst, copy=True)
    return all_gather(parts, dim, dst)
