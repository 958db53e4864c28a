"""Product quantization for the posting tiles (the quant plane).

The port of ``repro/quant/pq.py``.  An ``(M, m, C)`` uint8 code array
sits beside the float posting tiles; search scans the probed code tiles
with ADC lookup tables (``kernels/pq_scan.py``) and exact-reranks the
best ``cfg.rerank_k`` float candidates (``kernels/rerank.py``).

Codebooks are versioned: ``state.pq_codebooks`` holds ``V =
cfg.pq_versions`` slots, each posting records the slot its codes were
written under (``pq_posting_slot``), and search builds one lookup table
per slot.  A re-train writes the new generation into the oldest slot and
re-encodes the postings still pinned to it; every other posting upgrades
when a background round rewrites its tile.

Invariant (``core/invariants.py``): for every valid slot of every live
posting, ``codes[p, :, c] == encode(codebooks[slot[p]], vectors[p, c])``.

Encoding is the nearest-centroid assignment per subspace, so it runs on
``ops.kmeans_assign`` (a kernel on the card), one launch for all
subspaces: a vector's codes then do not depend on the batch it was
encoded in, which is what lets the invariant hold bit for bit on the
card.  The random draws of the JAX package (the generation-0 sample and
the re-train sample keys) are arguments here.
"""
from __future__ import annotations

import torch

from ..core.version_manager import masked_set_
from ..kernels import ops


# ---------------------------------------------------------------------------
# encode / decode / lookup tables (pure functions of one codebook set)
# ---------------------------------------------------------------------------

def _subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, d) -> the (m, N, d/m) view of its subspace slices."""
    n, d = x.shape
    return x.float().reshape(n, m, d // m).transpose(0, 1)


def encode(codebooks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes per subspace: codebooks (m, ksub, dsub),
    x (N, d) -> (N, m) uint8."""
    assign, _ = ops.kmeans_assign(_subspaces(x, codebooks.shape[0]),
                                  codebooks)
    return assign.to(torch.uint8).T.contiguous()


def encode_all_versions(codebooks_v: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Encode under every codebook slot at once: codebooks_v (V, m, ksub,
    dsub), x (N, d) -> (V, N, m) uint8 (one kernel launch)."""
    V, m, ksub, dsub = codebooks_v.shape
    assign, _ = ops.kmeans_assign(_subspaces(x, m),
                                  codebooks_v.reshape(V * m, ksub, dsub))
    return assign.reshape(V, m, -1).transpose(1, 2).to(torch.uint8)


def decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codebooks (m, ksub, dsub), codes (N, m) -> (N, m*dsub) fp32."""
    m, _, dsub = codebooks.shape
    j = torch.arange(m, device=codes.device)[None, :]
    return codebooks[j, codes.long()].reshape(codes.shape[0], m * dsub)


def encode_tiles(codebooks: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """Encode whole posting tiles: (B, C, d) -> (B, m, C) subspace-major."""
    B, C, d = tiles.shape
    codes = encode(codebooks, tiles.reshape(B * C, d))       # (B*C, m)
    return codes.reshape(B, C, -1).transpose(1, 2).contiguous()


def lookup_tables(codebooks_v: torch.Tensor,
                  queries: torch.Tensor) -> torch.Tensor:
    """ADC tables for every codebook slot: codebooks_v (V, m, ksub,
    dsub), queries (Q, d) -> (Q, V, m, ksub) fp32 with ``T[q, s, j, k] =
    ||cb||^2 - 2 q_j.cb``, so that ``sum_j T[q, s, j, code_j]`` follows
    the score convention ``||v||^2 - 2 q.v`` on the decoded vector."""
    V, m, ksub, dsub = codebooks_v.shape
    qs = queries.float().reshape(queries.shape[0], m, dsub)
    cb = codebooks_v.float()
    cn = torch.sum(cb * cb, dim=-1)                          # (V, m, ksub)
    dots = torch.einsum("qjd,sjkd->qsjk", qs, cb)
    return cn[None] - 2.0 * dots


# ---------------------------------------------------------------------------
# codebook training: masked Lloyd per subspace, all subspaces at once
# ---------------------------------------------------------------------------

def train_codebooks(sample: torch.Tensor, mask: torch.Tensor,
                    init: torch.Tensor, iters: int) -> torch.Tensor:
    """Refine codebooks on a masked sample, one k-means per subspace.

    sample (S, d); mask (S,) bool; init (m, ksub, dsub) warm start.
    Empty clusters keep their previous centroid.  The assignment step is
    ``ops.kmeans_assign`` over all m subspaces in one launch; the
    centroid sums are one host ``index_add_`` into (m, ksub + 1) rows
    (``build.cluster_means``: a card's adds in no fixed order), where
    row ``ksub`` of each subspace takes the masked points and is sliced
    off (the JAX package drops them with an out-of-bounds scatter)."""
    from ..core.build import cluster_means
    m, ksub, dsub = init.shape
    pts = _subspaces(sample, m)                              # (m, S, dsub)
    rows = pts.reshape(-1, dsub).float().cpu()
    dev = sample.device
    offs = torch.arange(m, device=dev)[:, None] * (ksub + 1)
    cents = init.float()
    for _ in range(iters):
        assign, _ = ops.kmeans_assign(pts, cents, mask)
        tgt = (torch.where(mask[None, :], assign.long(), ksub)
               + offs).reshape(-1)
        new, counts = cluster_means(rows, tgt, m * (ksub + 1))
        new = new.view(m, ksub + 1, dsub)[:, :ksub].to(dev)
        counts = counts.view(m, ksub + 1)[:, :ksub].to(dev)
        cents = torch.where(counts[..., None] > 0, new, cents)
    return cents


def init_codebooks(vectors: torch.Tensor, m: int, ksub: int, iters: int,
                   init_idx: torch.Tensor) -> torch.Tensor:
    """Generation-0 codebooks from a seed sample (build time), warm
    started from the ``ksub`` rows ``init_idx`` (the JAX package draws
    them with ``jax.random.choice(key, n, (ksub,), replace=n < ksub)``)."""
    n, d = vectors.shape
    init = vectors[init_idx.long()].float().reshape(ksub, m, d // m)
    mask = torch.ones((n,), dtype=torch.bool, device=vectors.device)
    return train_codebooks(vectors, mask, init.transpose(0, 1), iters)


# ---------------------------------------------------------------------------
# background re-train round (scheduled from UBISDriver.tick())
# ---------------------------------------------------------------------------

REENCODE_FEW = 128     # pinned postings re-encoded one by one up to this


def retrain_round(state, cfg, keys: torch.Tensor):
    """Train the next codebook generation and install it in the oldest
    slot; the float plane is untouched.  ``keys``: (M*C,) uniform draws
    in [0, 1) that pick the training sample (the JAX package draws them
    with ``jax.random.uniform``).  Updates ``state`` in place.

    Steps: (1) sample up to ``cfg.pq_sample`` live vectors: the valid
    rows sorted by key (stable), invalid rows pushed past every valid
    one; (2) warm-start Lloyd from the active codebooks; (3) re-encode
    the postings still pinned to the evicted slot under the new
    generation (up to ``REENCODE_FEW`` of them gathered first by a
    stable sort, else the whole pool encoded and selected); (4) rotate
    ``pq_active``."""
    M, C, d = state.vectors.shape
    V = cfg.pq_versions
    flat_valid = (state.slot_valid
                  & ~state.tier_spilled[:, None]).reshape(-1)
    order = torch.argsort(torch.where(flat_valid, keys.float(), 2.0),
                          stable=True)[:cfg.pq_sample]
    sample = state.vectors.reshape(M * C, d)[order].float()
    smask = flat_valid[order]

    active = int(state.pq_active)
    evict = (active + 1) % V
    new_cb = train_codebooks(sample, smask, state.pq_codebooks[active],
                             cfg.kmeans_iters)
    state.pq_codebooks[evict] = new_cb
    state.pq_slot_gen[evict] = (state.pq_slot_gen[active] + 1) & 0xFFFFFFFF

    pinned = state.allocated & (state.pq_posting_slot == evict)
    n_pinned = int(pinned.sum())
    R = min(M, REENCODE_FEW)
    if 0 < n_pinned <= R:
        pick = torch.argsort((~pinned).to(torch.uint8), stable=True)[:R]
        fresh = encode_tiles(new_cb, state.vectors[pick].float())
        masked_set_(state.codes, pick, fresh, pinned[pick])
    elif n_pinned > R:
        fresh = encode_tiles(new_cb, state.vectors.float())
        state.codes = torch.where(pinned[:, None, None], fresh, state.codes)
    state.pq_posting_slot = torch.where(
        pinned, evict, state.pq_posting_slot).to(torch.int32)
    state.pq_active = torch.full((), evict, dtype=torch.int32,
                                 device=state.device)
    return state
