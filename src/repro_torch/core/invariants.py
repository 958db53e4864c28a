"""Structural invariants of an index state, checked on its own device.

The port's counterpart of ``check_invariants`` in the JAX package's
``tests/test_background_round.py``, written with tensor ops so that it
runs at a realistic size on the card:

* every visible posting's length equals its live slots, and
  ``length <= used <= capacity``;
* no live id appears twice across the postings and the cache;
* ``id_loc`` tracks exactly the live ids, each at its slot (``pid*C + c``)
  or cache entry (``-2 - slot``);
* the free stack holds distinct, unallocated postings and, with the
  allocated ones, accounts for the whole pool.
"""
from __future__ import annotations

import torch

from .types import STATUS_DELETED, IndexState, UBISConfig


def _fail(why: str):
    raise AssertionError(why)


def check_invariants(state: IndexState, cfg: UBISConfig) -> None:
    """Raise ``AssertionError`` naming the first invariant that fails."""
    C = cfg.capacity
    alloc = state.allocated
    live_p = alloc & ((state.rec_meta & 3) != STATUS_DELETED)
    sv = state.slot_valid & live_p[:, None]
    lengths = state.lengths.to(torch.int64)
    used = state.used.to(torch.int64)
    if bool((live_p & (lengths != sv.sum(-1))).any()):
        _fail("length mismatch: a visible posting's length is not its "
              "live slot count")
    if bool((live_p & ((used < lengths) | (used > C))).any()):
        _fail("used out of [length, capacity] at a visible posting")

    slot_flat = torch.nonzero(sv.reshape(-1))[:, 0]
    slot_ids = state.ids.reshape(-1)[slot_flat].to(torch.int64)
    cache_slot = torch.nonzero(state.cache_valid)[:, 0]
    cache_ids = state.cache_ids[cache_slot].to(torch.int64)
    live_ids = torch.cat([slot_ids, cache_ids])
    if torch.unique(live_ids).numel() != live_ids.numel():
        _fail("duplicated live id")
    if bool((live_ids < 0).any()) or bool((live_ids >= cfg.max_ids).any()):
        _fail("live id outside [0, max_ids)")

    id_loc = state.id_loc.to(torch.int64)
    tracked = torch.nonzero(id_loc != -1)[:, 0]
    if tracked.numel() != live_ids.numel():
        _fail(f"id_loc desync: tracks {tracked.numel()}, audit found "
              f"{live_ids.numel()}")
    want = torch.cat([slot_flat, -2 - cache_slot])
    if not torch.equal(id_loc[live_ids], want):
        _fail("id_loc desync: a live id points elsewhere")

    top = int(state.free_top)
    free = state.free_list[:top].to(torch.int64)
    if torch.unique(free).numel() != top:
        _fail("free stack holds duplicates")
    if bool(alloc[free].any()):
        _fail("free stack aliases a live posting")
    if top + int(alloc.sum()) != cfg.max_postings:
        _fail("free stack and allocated bitmap do not cover the pool")
