"""Fault-tolerant checkpointing of torch state, in the JAX package's
file format.

Properties:
  * atomic  - write to ``step_XXXX.tmp`` then rename; a crash mid-write
              never corrupts the latest checkpoint;
  * async   - serialization runs on a background thread (one save in
              flight at a time); the host copy is taken on the caller's
              thread first, and it is a real copy: the port's rounds
              update an ``IndexState`` in place, so a save must not see
              the next round's writes;
  * keep-N  - bounded disk usage;
  * elastic - checkpoints hold host arrays keyed by tree path, and a
              restore places each on the template's device (or the one
              asked for), whatever device the save came from; a
              ``ShardedState`` template (a sharded driver's
              ``sharded``) is restored laid out over its mesh's devices,
              each shard's rows copied from the host to its own device
              (the reference's per-sharding ``device_put``,
              ``repro/checkpoint/manager.py:84``).

The file is the JAX package's (``repro/checkpoint/manager.py``): one npz
keyed by tree path plus a pickled ``.meta`` beside it.  Keys join the
path's parts with ``/``: a dict key or a list/tuple index as is, an
``IndexState`` field as ``.field`` (JAX's attribute key), so either
package restores the other's files.  An ``IndexState`` is written in the
JAX dtypes (``bridge.state_to_numpy``: its uint32 fields as uint32), and
a restore casts every array to its template's dtype.

Cluster checkpoints (one npz per worker and a digest-carrying manifest,
renamed in last) are :func:`save_cluster_checkpoint` and
:func:`load_cluster_checkpoint`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..core.types import IndexState

_STEP_RE = re.compile(r"step_(\d+)$")


def _sharded(tree) -> bool:
    from ..core.sharded import ShardedState
    return isinstance(tree, ShardedState)


def _host_state(sh) -> IndexState:
    """A ``ShardedState`` as one ``IndexState`` on the host: each shard's
    rows copied from its own device, one replica of the replicated
    fields."""
    return IndexState(**{f.name: sh.field(f.name, "cpu")
                         for f in dataclasses.fields(IndexState)})


def _items(tree, prefix: str):
    """(key, leaf) pairs in the JAX flatten order: dict keys sorted,
    sequences in order, ``IndexState`` fields in declaration order (a
    ``ShardedState`` as the whole index); ``None`` is an empty
    subtree."""
    if tree is None:
        return
    if _sharded(tree):
        tree = _host_state(tree)
    if isinstance(tree, IndexState):
        from ..bridge import state_to_numpy
        for name, a in state_to_numpy(tree).items():
            yield _join(prefix, "." + name), a
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], _join(prefix, str(k)))
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, _join(prefix, str(i)))
        return
    yield prefix, tree


def _join(prefix: str, part: str) -> str:
    return part if not prefix else prefix + "/" + part


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _items(tree, "")}


def save_pytree(tree, path: str, extra: Optional[dict] = None):
    """Atomic single-file save (npz + pickled key list and extras)."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    with open(tmp + ".meta", "wb") as f:
        pickle.dump({"treedef_repr": f"{type(tree).__name__} of "
                                     f"{len(flat)} arrays",
                     "keys": sorted(flat.keys()),
                     "extra": extra or {}}, f)
    os.replace(tmp + ".meta", path + ".meta")
    os.replace(tmp, path)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _restore(tmpl, prefix: str, data, device):
    if tmpl is None:
        return None
    if isinstance(tmpl, IndexState):
        return IndexState(**{
            f.name: _leaf(getattr(tmpl, f.name), _join(prefix, "." + f.name),
                          data, device)
            for f in dataclasses.fields(IndexState)})
    if _sharded(tmpl):
        # the whole index on the host, then each shard's part to its own
        # device; the template's layout decides (``device`` is not used)
        whole = {}
        for f in dataclasses.fields(IndexState):
            part = getattr(tmpl.shards[0], f.name)
            shape = tuple(part.shape)
            if tmpl.placements[f.name].model_dim is not None:
                shape = (shape[0] * tmpl.n_shards,) + shape[1:]
            whole[f.name] = torch.empty(shape, dtype=part.dtype,
                                        device="meta")
        state = _restore(IndexState(**whole), prefix, data, "cpu")
        return type(tmpl)(state, tmpl.mesh)
    if isinstance(tmpl, dict):
        return {k: _restore(v, _join(prefix, str(k)), data, device)
                for k, v in tmpl.items()}
    if isinstance(tmpl, (list, tuple)):
        out = [_restore(v, _join(prefix, str(i)), data, device)
               for i, v in enumerate(tmpl)]
        return out if isinstance(tmpl, list) else type(tmpl)(out)
    return _leaf(tmpl, prefix, data, device)


def _leaf(tmpl, key: str, data, device):
    if key not in data:
        raise KeyError(f"checkpoint has no array {key!r}")
    arr = data[key]
    shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"checkpoint/template shape mismatch at {key}: "
                         f"{arr.shape} vs {shape}")
    if torch.is_tensor(tmpl):
        arr = np.array(arr.astype(_np_dtype(tmpl)), order="C")
        return torch.from_numpy(arr).to(
            tmpl.device if device is None else device)
    return arr.astype(np.asarray(tmpl).dtype)


def restore_pytree(template, path: str, *, device=None):
    """Restore into the structure of ``template``: every array cast to
    its template leaf's dtype and, for a tensor leaf, placed on the
    template leaf's device, or on ``device`` when given (the torch
    counterpart of the JAX package's ``shardings=``).  Returns (tree,
    extra)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    out = _restore(template, "", data, device)
    with open(path + ".meta", "rb") as f:
        meta = pickle.load(f)
    return out, meta.get("extra", {})


# ---------------------------------------------------------------------
# cluster checkpoints: per-worker snapshots + a digest-carrying manifest
# ---------------------------------------------------------------------

CLUSTER_MANIFEST = "manifest.json"


class ClusterManifestError(RuntimeError):
    """A cluster checkpoint is partial, corrupt, or from a different
    protocol schema: restores must fail loudly, never half-load."""


def save_cluster_checkpoint(directory: str, states, digests,
                            extra: Optional[dict] = None) -> dict:
    """Write one npz per worker state plus ``manifest.json``.

    ``states`` are flat field -> numpy dicts
    (``cluster.protocol.state_to_payload``); ``digests`` the matching
    live-multiset digests.  Worker files land first, the manifest is
    renamed into place last: a crash mid-save leaves either a complete
    checkpoint or one with no manifest (which restore rejects), never a
    silently partial one."""
    from ..cluster import protocol as _proto
    os.makedirs(directory, exist_ok=True)
    paths = []
    for w, st in enumerate(states):
        name = f"worker_{w:03d}.npz"
        tmp = os.path.join(directory, name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in st.items()})
        os.replace(tmp, os.path.join(directory, name))
        paths.append(name)
    manifest = {
        "schema_version": _proto.SCHEMA_VERSION,
        "n_workers": len(paths),
        "paths": paths,
        "digests": [int(d) for d in digests],
        "combined_digest": _proto.combine_digests(digests),
        "extra": extra or {},
    }
    tmp = os.path.join(directory, CLUSTER_MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(directory, CLUSTER_MANIFEST))
    return manifest


def load_cluster_checkpoint(directory: str, *,
                            expect_workers: Optional[int] = None):
    """Load and verify a cluster checkpoint -> (payloads, manifest).

    Raises :class:`ClusterManifestError` on a missing manifest (partial
    write), a schema mismatch, a missing worker file, a worker-count
    mismatch, or a per-worker live-multiset digest that disagrees with
    the manifest (a corrupt or swapped shard file)."""
    from ..cluster import protocol as _proto
    mpath = os.path.join(directory, CLUSTER_MANIFEST)
    if not os.path.exists(mpath):
        raise ClusterManifestError(
            f"no {CLUSTER_MANIFEST} in {directory!r}: partial or "
            "foreign checkpoint")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("schema_version") != _proto.SCHEMA_VERSION:
        raise ClusterManifestError(
            f"checkpoint schema {manifest.get('schema_version')!r} != "
            f"this build's {_proto.SCHEMA_VERSION}")
    if (expect_workers is not None
            and manifest.get("n_workers") != expect_workers):
        raise ClusterManifestError(
            f"checkpoint has {manifest.get('n_workers')} workers, "
            f"cluster has {expect_workers}")
    payloads = []
    for w, name in enumerate(manifest["paths"]):
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            raise ClusterManifestError(
                f"worker file {name!r} missing from {directory!r}: "
                "partial checkpoint")
        with np.load(path) as data:
            payload = {k: data[k] for k in data.files}
        digest = _proto.live_multiset_digest(payload)
        if digest != manifest["digests"][w]:
            raise ClusterManifestError(
                f"worker {w} digest mismatch: file {digest} != "
                f"manifest {manifest['digests'][w]} (corrupt or "
                "swapped shard file)")
        payloads.append(payload)
    return payloads, manifest


# ---------------------------------------------------------------------


def _host_copy(tree):
    """A host copy of ``tree`` that no later in-place round can change:
    tensors copied to the CPU (``copy=True``: on the CPU ``.cpu()``
    would return the same tensor), numpy arrays copied."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, IndexState):
        return IndexState(**{f.name: _host_copy(getattr(tree, f.name))
                             for f in dataclasses.fields(IndexState)})
    if _sharded(tree):
        return _host_state(tree)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_host_copy(v) for v in tree]
        return out if isinstance(tree, list) else type(tree)(out)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and not name.endswith(".tmp"):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: Optional[dict] = None):
        """Async (default) atomic save; blocks only if a save is already
        in flight (bounded staleness of one)."""
        self.wait()
        # the host copy on the caller's thread (on the card, the
        # device-to-host copy), so the thread only does file IO and
        # serializes the state as it was at this call
        host_tree = _host_copy(tree)

        def work():
            save_pytree(host_tree, self._path(step), extra)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore_latest(self, template, *, device=None):
        step = self.latest_step()
        if step is None:
            return None, None, {}
        tree, extra = restore_pytree(template, self._path(step),
                                     device=device)
        return step, tree, extra

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            for suffix in ("", ".meta"):
                try:
                    os.remove(self._path(s) + suffix)
                except OSError:
                    pass
