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
  allocated ones, accounts for the whole pool;
* with ``use_pq``, the quant invariant of ``tests/test_pq.py``: for
  every valid slot of every live float-resident posting, ``codes[p, :,
  c] == encode(codebooks[pq_posting_slot[p]], vectors[p, c])``;
* with ``use_tier``, :func:`check_residency` (the counterpart of
  ``_audit_residency`` in ``tests/test_tier.py``): a spilled posting's
  device tile is all zero and its pool tile encodes to its codes, a hot
  posting is not pooled, the pool holds one tile per spilled posting.
"""
from __future__ import annotations

import torch

from ..quant import pq
from .types import (STATUS_DELETED, IndexState, UBISConfig,
                    state_memory_bytes, state_tier_bytes)

CODES_CHUNK = 4096     # postings re-encoded at a time by check_codes


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
    if cfg.use_pq:
        check_codes(state, cfg)


def _check_tiles(state: IndexState, cfg: UBISConfig, pids: torch.Tensor,
                 tiles_of, where: str) -> None:
    """Every valid slot of postings ``pids`` holds the code of its float
    vector (``tiles_of(p)``: the float tiles of pids ``p``) under the
    posting's codebook slot."""
    slot = state.pq_posting_slot[pids]
    for s in range(cfg.pq_versions):
        sel = pids[slot == s]
        for off in range(0, sel.numel(), CODES_CHUNK):
            p = sel[off:off + CODES_CHUNK]
            want = pq.encode_tiles(state.pq_codebooks[s],
                                   tiles_of(p).float())         # (b, m, C)
            bad = (want != state.codes[p]) & state.slot_valid[p][:, None, :]
            if bool(bad.any()):
                first = int(p[torch.nonzero(bad.any(-1).any(-1))[0, 0]])
                _fail(f"codes diverged from the {where} at posting "
                      f"{first} (codebook slot {s})")


def check_codes(state: IndexState, cfg: UBISConfig) -> None:
    """The quant invariant: every valid slot of every live float-resident
    posting holds the code of its float vector under the posting's
    codebook slot (spilled postings: :func:`check_residency`)."""
    live_p = state.allocated & ((state.rec_meta & 3) != STATUS_DELETED)
    pids = torch.nonzero(live_p & ~state.tier_spilled)[:, 0]
    _check_tiles(state, cfg, pids, lambda p: state.vectors[p],
                 "float plane")


def check_residency(state: IndexState, cfg: UBISConfig, pool) -> None:
    """The cold tier's residency invariant against the host ``pool``
    (``core/tier.HostTierPool``): every live spilled posting's device
    tile is all zero and its pool tile encodes to its codes under its
    pinned codebook slot; no hot posting is pooled; the pool holds one
    tile per spilled posting, so the host bytes of ``state_tier_bytes``
    are the pool's and device + host is the untiered total."""
    live_p = state.allocated & ((state.rec_meta & 3) != STATUS_DELETED)
    spilled = state.tier_spilled
    if bool((spilled & ~live_p).any()):
        _fail("a retired or free posting is flagged spilled")
    sp = torch.nonzero(spilled)[:, 0]
    pooled = torch.as_tensor(pool.pids(), dtype=torch.int64,
                             device=state.device)
    if not torch.equal(sp, pooled):
        in_pool = torch.zeros_like(spilled)
        in_pool[pooled] = True
        hot = torch.nonzero(in_pool & ~spilled)[:, 0]
        if hot.numel():
            _fail(f"hot posting {int(hot[0])} still pooled")
        _fail(f"spilled posting {int(sp[~in_pool[sp]][0])} missing from "
              "the pool")
    if bool(state.vectors[sp].any()):
        _fail("a spilled posting's device tile is not zeroed")
    dev = state.device
    _check_tiles(state, cfg, sp,
                 lambda p: pool.tiles(p.cpu().numpy()).to(dev),
                 "pooled float tile")
    tiers = state_tier_bytes(state)
    if tiers["host"] != pool.nbytes():
        _fail(f"host bytes {tiers['host']} != the pool's {pool.nbytes()}")
    if tiers["device"] + tiers["host"] != state_memory_bytes(state):
        _fail("device + host bytes differ from the untiered total")
