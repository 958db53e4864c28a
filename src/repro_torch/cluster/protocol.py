"""The coordinator/worker wire protocol: schema-versioned messages of
plain-numpy payloads.

Every message that crosses the process boundary is a dict

    {"v": SCHEMA_VERSION, "kind": <command>, "seq": <int>, "payload": {...}}

whose payload is built from JSON-native values plus numpy arrays.  The
codec separates the two: arrays are lifted out of the tree into a side
table and shipped as raw little-endian bytes (``tobytes``: lossless,
which is what makes the LocalBackend's codec round trip bit-identical
to the in-process driver), while the remaining tree plus the array
dtypes and shapes travel as a JSON header.  A frame on a byte stream is

    [u64 frame length][u32 header length][header JSON][array bytes...]

so a worker subprocess speaks the protocol over plain pipes.  The format
is the JAX package's byte for byte (``repro/cluster/protocol.py``): one
payload encodes to the same bytes in both packages, and each decodes the
other's frames.

The codec knows numpy arrays only.  A torch tensor in a payload is
refused (``ProtocolError``), never coerced: a worker converts its
tensors to numpy (``.cpu().numpy()``) before it replies.

Message catalog (worker commands; see ``cluster/worker.py``):

  control   - ``init``, ``ping``, ``sleep``, ``shutdown``
  foreground- ``insert_rounds``, ``cache_put``, ``delete``, ``search``,
              ``exact``
  tick legs - ``tick_begin`` (background program; observation up),
              ``plan_inputs``, ``tick_exec`` (migrate moves + drain +
              retrain slot down; tier observation up), ``tick_end``
              (tier lanes down; commits + report up)
  tier      - ``force_spill``, ``force_promote``
  state     - ``snapshot``, ``load_state``, ``live_count``,
              ``posting_lengths``, ``memory``, ``occupancy``,
              ``extract`` (cross-worker balance donor), ``stats``

Schema versioning: ``decode_message`` refuses any frame whose ``v``
differs from :data:`SCHEMA_VERSION`, and checkpoints carry the same
version in their manifest (``checkpoint/manager.py``).

Index states travel in the JAX package's checkpoint format
(``bridge.state_to_numpy``: the uint32 fields as uint32), so the
multiset digest of a port payload equals the JAX digest of the same
state and a port checkpoint loads in the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Optional

import numpy as np

SCHEMA_VERSION = 1

_ND = "__nd__"
_U64 = 0xFFFFFFFFFFFFFFFF
#: the 0-d ``IndexState`` fields: the codec ships a 0-d array with shape
#: (1,) (``np.ascontiguousarray``), as the JAX package's codec does
_SCALAR_FIELDS = ("free_top", "global_version", "pq_active")


class ProtocolError(RuntimeError):
    """Malformed frame or schema-version mismatch."""


def _pack_tree(x, arrays: list):
    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        arrays.append(a)
        return {_ND: len(arrays) - 1, "dtype": a.dtype.name,
                "shape": list(a.shape)}
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        if _ND in x:
            raise ProtocolError("payload dicts may not use the "
                                f"reserved key {_ND!r}")
        return {str(k): _pack_tree(v, arrays) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_pack_tree(v, arrays) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise ProtocolError(f"unserializable payload value: {type(x)}")


def _unpack_tree(x, arrays: list):
    if isinstance(x, dict):
        if _ND in x:
            return arrays[x[_ND]]
        return {k: _unpack_tree(v, arrays) for k, v in x.items()}
    if isinstance(x, list):
        return [_unpack_tree(v, arrays) for v in x]
    return x


def encode_message(kind: str, payload: Optional[dict], seq: int,
                   v: int = SCHEMA_VERSION) -> bytes:
    """One serialized message (header JSON + raw array bytes)."""
    arrays: list = []
    tree = _pack_tree(payload or {}, arrays)
    header = json.dumps({
        "v": int(v), "kind": str(kind), "seq": int(seq),
        "payload": tree,
        "nbytes": [a.nbytes for a in arrays],
    }).encode()
    # the arrays' own buffers go into the join: one copy of the bytes
    return b"".join([struct.pack("<I", len(header)), header]
                    + [a.reshape(-1).view(np.uint8) for a in arrays])


def decode_message(buf: bytes) -> dict:
    """Inverse of :func:`encode_message`; validates the schema version."""
    if len(buf) < 4:
        raise ProtocolError("truncated frame")
    (hlen,) = struct.unpack_from("<I", buf, 0)
    try:
        head = json.loads(buf[4:4 + hlen].decode())
    except Exception as e:  # noqa: BLE001 - re-raise as protocol error
        raise ProtocolError(f"bad frame header: {e}") from e
    if head.get("v") != SCHEMA_VERSION:
        raise ProtocolError(
            f"schema version mismatch: got {head.get('v')!r}, "
            f"this build speaks {SCHEMA_VERSION}")
    arrays = []
    off = 4 + hlen
    meta = _array_meta(head["payload"])
    for i, nb in enumerate(head["nbytes"]):
        dtype, shape = meta[i]
        if off + nb > len(buf):
            raise ProtocolError("truncated frame: array bytes missing")
        arrays.append(np.frombuffer(buf, dtype=np.dtype(dtype), count=(
            nb // np.dtype(dtype).itemsize), offset=off).reshape(shape)
            .copy())
        off += nb
    return {"v": head["v"], "kind": head["kind"], "seq": head["seq"],
            "payload": _unpack_tree(head["payload"], arrays)}


def _array_meta(tree, out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        if _ND in tree:
            out[tree[_ND]] = (tree["dtype"], tree["shape"])
        else:
            for v in tree.values():
                _array_meta(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _array_meta(v, out)
    return out


# ---------------------------------------------------------------- framing


def write_frame(fh, buf: bytes) -> None:
    fh.write(struct.pack("<Q", len(buf)))
    fh.write(buf)
    fh.flush()


def read_frame(fh) -> Optional[bytearray]:
    """Read one length-prefixed frame (into one buffer, no joins); None
    on clean EOF."""
    head = fh.read(8)
    if not head:
        return None
    if len(head) < 8:
        raise ProtocolError("truncated frame length")
    (n,) = struct.unpack("<Q", head)
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = fh.readinto(view[got:])
        if not k:
            raise ProtocolError("EOF mid-frame")
        got += k
    return buf


# ------------------------------------------------------- state transport


def state_to_payload(state) -> dict:
    """A port ``IndexState`` as a flat field -> numpy dict in the JAX
    package's dtypes (protocol- and checkpoint-safe)."""
    from .. import bridge
    return bridge.state_to_numpy(state)


def payload_to_state(payload: dict, device="cpu"):
    """An ``IndexState`` on ``device`` from :func:`state_to_payload`
    output (or the JAX package's); the uint32 fields become int64."""
    import torch

    from .. import bridge
    from ..core.types import UINT32_FIELDS, IndexState
    names = set(bridge.FIELDS)
    if set(payload) != names:
        raise ProtocolError(
            f"state payload fields mismatch: missing "
            f"{sorted(names - set(payload))}, "
            f"unexpected {sorted(set(payload) - names)}")
    out = {}
    for k in bridge.FIELDS:
        a = np.asarray(payload[k])
        if k in UINT32_FIELDS:
            a = a.astype(np.int64)
        if k in _SCALAR_FIELDS:
            a = a.reshape(())
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device)
    return IndexState(**out)


def cfg_to_payload(cfg) -> dict:
    """A ``UBISConfig`` as a JSON-safe dict (dtype by name)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return d


def payload_to_cfg(payload: dict):
    """The port's ``UBISConfig`` from :func:`cfg_to_payload` output (or
    the JAX package's: its ``use_pallas`` knob has no meaning here)."""
    import torch

    from ..core.types import UBISConfig
    d = dict(payload)
    d.pop("use_pallas", None)
    d["dtype"] = getattr(torch, d["dtype"])
    return UBISConfig(**d)


# ------------------------------------------------------ multiset digest


def _numpy_fields(state) -> dict:
    from ..core.types import IndexState
    if isinstance(state, IndexState):
        return state_to_payload(state)
    if isinstance(state, dict):
        return state
    return vars(state)


def live_multiset_digest(state) -> int:
    """Order-independent digest of the live id -> vector multiset
    (postings + cache), combinable across workers by uint64 addition:
    the sum of each live row's ``crc32`` over its ``<q`` id and its
    float32 vector bytes.  ``state``: a port ``IndexState``, a payload
    dict or any object with the fields as numpy attributes.

    This is the checkpoint manifest's integrity field: a restore that
    loads a mismatched or partially written shard set produces a digest
    that disagrees with the manifest and fails loudly
    (``checkpoint.manager.load_cluster_checkpoint``)."""
    f = _numpy_fields(state)
    status = np.asarray(f["rec_meta"]).astype(np.int64) & 3
    vis = np.asarray(f["allocated"]) & (status != 3)
    sv = np.asarray(f["slot_valid"]) & vis[:, None]
    rows = [_rows(np.asarray(f["ids"])[sv], np.asarray(f["vectors"])[sv]),
            _rows(np.asarray(f["cache_ids"])[np.asarray(f["cache_valid"])],
                  np.asarray(f["cache_vecs"])[np.asarray(f["cache_valid"])])]
    total = 0
    for buf in rows:
        for r in buf:
            total += zlib.crc32(r)
    return total & _U64


def _rows(ids: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """One byte row per entry: the ``<q`` id, then the vector's bytes."""
    vecs = np.ascontiguousarray(vecs)
    vb = vecs.view(np.uint8).reshape(len(ids), vecs.shape[-1]
                                     * vecs.itemsize)
    out = np.empty((len(ids), 8 + vb.shape[1]), np.uint8)
    out[:, :8] = ids.astype("<i8").view(np.uint8).reshape(-1, 8)
    out[:, 8:] = vb
    return out


def combine_digests(digests) -> int:
    total = 0
    for d in digests:
        total = (total + int(d)) & _U64
    return total
