"""Fine-grained version manager — the *Posting Recorder* (paper IV-B1).

One 8-byte word per posting, kept as two lanes (int64 tensors here,
uint32 in the JAX package):

    rec_meta = status(2 bits) | weight(30 bits)
    rec_succ = succ1(16 bits) | succ2(16 bits)

CAS is replaced by deterministic batched transitions: each round writes
at most one winning value per posting word (first writer in job order),
so the scatters that apply them never see a duplicate index.
"""
from __future__ import annotations

import torch

from .types import NO_SUCC, STATUS_DELETED

_STATUS_BITS = 2
_STATUS_MASK = (1 << _STATUS_BITS) - 1
_WEIGHT_MASK = (1 << 30) - 1


def _i64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64)


def _i64_pair(a, b):
    """Both as int64 tensors, on the device of whichever is a tensor."""
    dev = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)),
               None)
    return _i64(a, dev), _i64(b, dev)


# --- packing ---------------------------------------------------------------

def pack_meta(status, weight) -> torch.Tensor:
    status, weight = _i64_pair(status, weight)
    return (status & _STATUS_MASK) | ((weight & _WEIGHT_MASK) << _STATUS_BITS)


def unpack_status(meta: torch.Tensor) -> torch.Tensor:
    return (meta & _STATUS_MASK).to(torch.int32)


def unpack_weight(meta: torch.Tensor) -> torch.Tensor:
    return (meta >> _STATUS_BITS) & _WEIGHT_MASK


def pack_succ(succ1, succ2) -> torch.Tensor:
    s1, s2 = _i64_pair(succ1, succ2)
    return ((s1 & 0xFFFF) << 16) | (s2 & 0xFFFF)


def unpack_succ(succ: torch.Tensor):
    s1 = ((succ >> 16) & 0xFFFF).to(torch.int32)
    s2 = (succ & 0xFFFF).to(torch.int32)
    return s1, s2


def succ_ids(succ: torch.Tensor):
    """Successor ids as int32, -1 where absent."""
    s1, s2 = unpack_succ(succ)
    return (torch.where(s1 == NO_SUCC, -1, s1),
            torch.where(s2 == NO_SUCC, -1, s2))


# --- snapshot visibility (paper: weight vs. global version) ---------------

def visible(meta, allocated, global_version) -> torch.Tensor:
    """A posting is visible to a snapshot iff it is allocated, not
    deleted, and its weight (creation version) <= the snapshot version."""
    return (allocated & (unpack_status(meta) != STATUS_DELETED)
            & (unpack_weight(meta) <= global_version))


# --- batched transitions ---------------------------------------------------

def first_occurrence_mask(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask marking the first occurrence of each value in ``x``
    (stable sort, O(J log J)): the one-winner-per-word rule."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    xs = x[order]
    firsts = torch.ones((n,), dtype=torch.bool, device=x.device)
    firsts[1:] = xs[1:] != xs[:-1]
    out = torch.empty((n,), dtype=torch.bool, device=x.device)
    out[order] = firsts
    return out


def masked_set_(arr: torch.Tensor, idx: torch.Tensor, values,
                mask: torch.Tensor) -> torch.Tensor:
    """``arr[idx[j]] = values[j]`` for every j where ``mask[j]``, in place
    along dim 0, without a host sync; the masked-out entries change
    nothing.  The writers that ``mask`` keeps must have distinct
    indices (the rounds make winners unique before they scatter).

    The JAX package routes masked entries out of bounds and lets
    ``mode="drop"`` discard them; PyTorch raises on an out-of-bounds
    index instead.  Here every masked entry is aimed at the target of
    the first kept writer and carries that writer's value, so all
    duplicate writes to that row are identical and the scatter stays
    deterministic; with no kept writer they rewrite row 0 with itself.
    """
    n = idx.shape[0]
    if n == 0:
        return arr
    idx = idx.to(torch.int64)
    values = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    values = values.expand((n,) + arr.shape[1:])
    any_ = mask.any()
    first = torch.argmax(mask.to(torch.uint8))
    tgt0 = torch.where(any_, idx[first], 0)
    val0 = torch.where(any_, values[first], arr[0])
    m = mask.reshape((n,) + (1,) * (arr.dim() - 1))
    arr[torch.where(mask, idx, tgt0)] = torch.where(m, values, val0)
    return arr


def masked_add_(arr: torch.Tensor, idx: torch.Tensor, values,
                mask: torch.Tensor) -> torch.Tensor:
    """``arr[idx[j]] += values[j]`` where ``mask[j]`` (integer ``arr``:
    exact in any order), in place; masked entries add 0 to row 0."""
    if idx.shape[0] == 0:
        return arr
    values = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    values = values.expand(idx.shape)
    arr.index_add_(0, torch.where(mask, idx.to(torch.int64), 0),
                   torch.where(mask, values, torch.zeros_like(values)))
    return arr


def transition(rec_meta, pids, new_status, new_weight=None) -> torch.Tensor:
    """Set status (and optionally weight) for a batch of posting ids.

    ``pids`` may hold -1 padding; it is skipped.  When a pid appears
    twice, the *first* occurrence wins (CAS: one winner per word per
    round).  Returns a new tensor."""
    pids = torch.as_tensor(pids, device=rec_meta.device).to(torch.int64)
    M = rec_meta.shape[0]
    first = first_occurrence_mask(pids) & (pids >= 0)
    cur = rec_meta[pids.clamp(0, M - 1)]
    weight = (unpack_weight(cur) if new_weight is None
              else _i64(new_weight, rec_meta.device).expand(pids.shape))
    status = _i64(new_status, rec_meta.device).expand(pids.shape)
    return masked_set_(rec_meta.clone(), pids, pack_meta(status, weight),
                       first)


def set_successors(rec_succ, pids, succ1, succ2) -> torch.Tensor:
    pids = torch.as_tensor(pids, device=rec_succ.device).to(torch.int64)
    first = first_occurrence_mask(pids) & (pids >= 0)
    s1 = _i64(succ1, rec_succ.device).expand(pids.shape)
    s2 = _i64(succ2, rec_succ.device).expand(pids.shape)
    packed = pack_succ(torch.where(s1 < 0, NO_SUCC, s1),
                       torch.where(s2 < 0, NO_SUCC, s2))
    return masked_set_(rec_succ.clone(), pids, packed, first)


def retire(rec_meta, rec_succ, pids, succ1, succ2, version):
    """Retire a batch of postings: DELETED + retirement version +
    successor pointers.  -1 padding skipped; duplicates resolve
    first-writer-wins."""
    rec_meta = transition(rec_meta, pids, STATUS_DELETED, version)
    rec_succ = set_successors(rec_succ, pids, succ1, succ2)
    return rec_meta, rec_succ


def chase_successors(rec_meta, rec_succ, allocated, centroids, pids, points,
                     depth: int):
    """Resolve DELETED postings to a live successor (paper IV-B2, branch 2).

    For each (pid, point): while the target is DELETED and has
    successors, move to the successor whose centroid is nearer to the
    point; bounded by ``depth``.  Returns (resolved_pid, dead_end)."""
    pid = pids.to(torch.int64)
    points = points.to(torch.float32)
    for _ in range(depth):
        dead = unpack_status(rec_meta[pid]) == STATUS_DELETED
        s1, s2 = succ_ids(rec_succ[pid])
        has1 = s1 >= 0
        has2 = s2 >= 0
        c1 = centroids[s1.clamp(min=0)].float()
        c2 = centroids[s2.clamp(min=0)].float()
        d1 = torch.where(has1, torch.sum((points - c1) ** 2, -1), torch.inf)
        d2 = torch.where(has2, torch.sum((points - c2) ** 2, -1), torch.inf)
        nxt = torch.where(d1 <= d2, s1, s2).to(torch.int64)
        pid = torch.where(dead & (has1 | has2), nxt, pid)
    status = unpack_status(rec_meta[pid.clamp(min=0)])
    dead_end = (pid < 0) | (status == STATUS_DELETED)
    return pid.to(torch.int32), dead_end
