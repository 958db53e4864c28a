"""Core datatypes for the UBIS updatable cluster-based index (PyTorch).

The index is a dataclass of fixed-shape tensors on one device.
Postings are fixed-capacity tiles of a pooled ``(max_postings, capacity,
dim)`` tensor; a free stack provides allocation; the paper's 8-byte
*Posting Recorder* word is kept as two lanes per posting (see
``version_manager.py``).

The JAX package keeps the recorder words, the heat counter, the global
version and the codebook generations as uint32.  PyTorch has no uint32
arithmetic, so the port keeps them as int64 (every uint32 value fits)
and ``repro_torch.bridge`` casts at the boundary.

Unlike the JAX package, the round functions update the large tensors of
an ``IndexState`` in place (the posting pool alone is gigabytes at a
realistic size) and return the same object.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# ---------------------------------------------------------------------------
# Posting status codes (paper Section IV-B1: 2 bits, four states).
# ---------------------------------------------------------------------------
STATUS_NORMAL = 0
STATUS_SPLITTING = 1
STATUS_MERGING = 2
STATUS_DELETED = 3

# Sentinel for "no successor" in the recorder's new-postings region.
NO_SUCC = 0xFFFF
# Sentinel for empty id slots.
NO_ID = -1

# ---------------------------------------------------------------------------
# Background-op kind codes (the int lane of a batched background round).
# ---------------------------------------------------------------------------
KIND_NONE = 0
KIND_SPLIT = 1
KIND_MERGE = 2
KIND_COMPACT = 3

#: IndexState fields the JAX package stores as uint32 (int64 here).
UINT32_FIELDS = frozenset({"rec_meta", "rec_succ", "heat", "global_version",
                           "pq_slot_gen"})


@dataclasses.dataclass(frozen=True)
class UBISConfig:
    """Static configuration.  The fields and defaults are the JAX
    package's, without its ``use_pallas`` backend knob: here the device
    of the tensors chooses between a kernel and its plain version."""

    dim: int = 64
    max_postings: int = 4096          # posting pool size (must be < 0xFFFF)
    capacity: int = 96                # physical tile size (>= l_max slack)
    l_min: int = 10                   # merge threshold  (paper Section V-A)
    l_max: int = 80                   # split threshold  (paper Section V-A)
    balance_factor: float = 0.15      # paper Fig. 9 default
    nprobe: int = 32                  # postings probed per query (paper: 32)
    cache_capacity: int = 2048        # vector cache (Section IV-B2)
    graph_degree: int = 8             # centroid neighbourhood graph degree
    kmeans_iters: int = 6             # Lloyd iterations for (2-)means
    max_ids: int = 1 << 20            # id -> location map size
    succ_chase_depth: int = 4         # bounded DELETED pointer chasing
    dtype: Any = torch.float32        # vector storage dtype
    mode: str = "ubis"                # "ubis" | "spfresh" (baseline semantics)
    shard_probe_cap: int = 0          # sharded search: probes a shard scans
    # --- product-quantization plane --------------------------------------
    use_pq: bool = False
    pq_m: int = 8
    pq_ksub: int = 256
    pq_versions: int = 2
    pq_sample: int = 2048
    rerank_k: int = 64
    # --- cold-tier host spill (core/tier.py) -----------------------------
    use_tier: bool = False
    tier_hot_max: int = 0
    tier_cold_heat: int = 1
    tier_promote_heat: int = 8

    def __post_init__(self):
        checks = (
            (self.max_postings < NO_SUCC, "successor ids are 16-bit"),
            (self.capacity >= self.l_max, "tile must hold an over-full posting"),
            (self.capacity <= 2 * self.l_max,
             "median-bisection split guard needs capacity/2 <= l_max"),
            (self.mode in ("ubis", "spfresh"), f"unknown mode {self.mode!r}"),
            (not self.use_pq or self.dim % self.pq_m == 0,
             "pq_m must divide dim"),
            (2 <= self.pq_ksub <= 256, "codes are uint8"),
            (self.pq_versions >= 2, "need >= 2 slots for lazy re-encode"),
            (self.rerank_k >= 1, "rerank_k must be >= 1"),
            (not self.use_tier or self.use_pq, "use_tier requires use_pq"),
        )
        for ok, why in checks:
            if not ok:
                raise ValueError(f"UBISConfig: {why}")

    @property
    def pq_m_eff(self) -> int:
        """Subspace count of the (always present) code arrays: one
        subspace when the quant plane is off."""
        return self.pq_m if self.use_pq else 1

    @property
    def pq_dsub(self) -> int:
        return self.dim // self.pq_m_eff

    @property
    def is_ubis(self) -> bool:
        return self.mode == "ubis"


@dataclasses.dataclass
class IndexState:
    """The full index as tensors on one device (all fixed shape).

    Shapes use ``M = max_postings``, ``C = capacity``, ``d = dim``,
    ``K = cache_capacity``, ``N = max_ids``; field for field the JAX
    package's ``IndexState``.
    """

    # --- posting tiles -----------------------------------------------------
    vectors: torch.Tensor        # (M, C, d) vector payloads
    ids: torch.Tensor            # (M, C) int32 external ids, NO_ID = empty
    slot_valid: torch.Tensor     # (M, C) bool, live (non-tombstoned) slots
    used: torch.Tensor           # (M,) int32 append high-water mark per tile
    lengths: torch.Tensor        # (M,) int32 live vector count per posting
    centroids: torch.Tensor      # (M, d)
    # --- posting recorder (version manager) -------------------------------
    rec_meta: torch.Tensor       # (M,) int64: status(2) | weight(30)
    rec_succ: torch.Tensor       # (M,) int64: succ1(16) | succ2(16)
    allocated: torch.Tensor      # (M,) bool, slot is in use
    # --- centroid neighbourhood graph --------------------------------------
    nbrs: torch.Tensor           # (M, G) int32 neighbour posting ids, -1 pad
    # --- vector cache (Section IV-B2, splitting/merging branch) -----------
    cache_vecs: torch.Tensor     # (K, d)
    cache_ids: torch.Tensor      # (K,) int32
    cache_target: torch.Tensor   # (K,) int32 posting the vector was bound for
    cache_valid: torch.Tensor    # (K,) bool
    # --- allocation + versions ---------------------------------------------
    free_list: torch.Tensor      # (M,) int32 stack of free posting ids
    free_top: torch.Tensor       # () int32 entries on the free stack
    global_version: torch.Tensor  # () int64 monotone version counter
    # --- id -> flat location (pid * C + slot), -1 absent, -2-s cached -----
    id_loc: torch.Tensor         # (N,) int32
    # --- product-quantization plane (use_pq) -------------------------------
    codes: torch.Tensor          # (M, m, C) uint8
    pq_codebooks: torch.Tensor   # (V, m, ksub, dsub) f32
    pq_slot_gen: torch.Tensor    # (V,) int64
    pq_active: torch.Tensor      # () int32
    pq_posting_slot: torch.Tensor  # (M,) int32
    # --- cold-tier residency (use_tier) ------------------------------------
    heat: torch.Tensor           # (M,) int64 touch counter (uint32 values)
    tier_spilled: torch.Tensor   # (M,) bool float tile in the host pool

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def live_vector_count(self) -> torch.Tensor:
        """Vectors in *visible* postings (retired postings keep their
        tile data until GC but own no live vectors)."""
        vis = self.allocated & ((self.rec_meta & 3) != STATUS_DELETED)
        return torch.sum(self.lengths * vis)

    # ---- rows by posting id: the interface this state shares with a
    # sharded index's global view (``core.sharded.GlobalView``)

    def row_parts(self, name: str, pids: torch.Tensor) -> list:
        """``[(positions in pids, rows)]``, the rows of field ``name`` at
        ``pids`` where they live: here one part, on this state's device."""
        return [(torch.arange(pids.numel()), self.get_rows(name, pids))]

    def get_rows(self, name: str, pids: torch.Tensor) -> torch.Tensor:
        """``<name>[pids]`` on this state's device."""
        return getattr(self, name)[pids.to(device=self.device,
                                           dtype=torch.int64)]

    def set_rows(self, name: str, pids: torch.Tensor, value,
                 valid: torch.Tensor) -> None:
        """``<name>[pids[j]] = value[j]`` where ``valid[j]``, in place."""
        from .version_manager import masked_set_
        masked_set_(getattr(self, name), pids, value, valid)


@dataclasses.dataclass
class BackgroundRound:
    """Outcome of one batched background round (0-dim int tensors); the
    driver reads it once per tick."""

    executed: torch.Tensor    # ops that ran (splits + merges + compacts)
    n_split: torch.Tensor     # true 2-means splits
    n_merge: torch.Tensor     # merges (incl. partnerless self-rebuilds)
    n_compact: torch.Tensor   # compactions (incl. split ops demoted in-round)
    deferred: torch.Tensor    # ops reverted to NORMAL (no slots / conflicts)
    moved_out: torch.Tensor   # small-side vectors appended to nearer postings
    spilled: torch.Tensor     # move-outs that diverted to the vector cache
    reassigned: torch.Tensor  # fused post-op reassign moves
    freed: torch.Tensor       # empty split-b slots returned to the free list

    def to_host(self) -> dict:
        """All counters as Python ints, in one device-to-host copy."""
        names = [f.name for f in dataclasses.fields(self)]
        vals = torch.stack([getattr(self, n).reshape(()).to(torch.int64)
                            for n in names]).tolist()
        return dict(zip(names, vals))


@dataclasses.dataclass
class RoundResult:
    """Outcome of one foreground update round (fixed shape, padded)."""

    accepted: torch.Tensor   # (J,) bool appended directly to a posting
    cached: torch.Tensor     # (J,) bool parked in the vector cache
    rejected: torch.Tensor   # (J,) bool dropped (SPFresh lock / cache full)
    target: torch.Tensor     # (J,) int32 resolved posting id (-1 if rejected)


def empty_state(cfg: UBISConfig, device) -> IndexState:
    """A fully deallocated index on ``device`` (build populates it)."""
    M, C, d = cfg.max_postings, cfg.capacity, cfg.dim
    K, G, N = cfg.cache_capacity, cfg.graph_degree, cfg.max_ids
    i32, i64 = torch.int32, torch.int64

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return IndexState(
        vectors=torch.zeros((M, C, d), dtype=cfg.dtype, device=device),
        ids=full((M, C), NO_ID, i32),
        slot_valid=full((M, C), False, torch.bool),
        used=full((M,), 0, i32),
        lengths=full((M,), 0, i32),
        centroids=torch.zeros((M, d), dtype=cfg.dtype, device=device),
        rec_meta=full((M,), STATUS_DELETED, i64),       # weight 0
        rec_succ=full((M,), (NO_SUCC << 16) | NO_SUCC, i64),
        allocated=full((M,), False, torch.bool),
        nbrs=full((M, G), -1, i32),
        cache_vecs=torch.zeros((K, d), dtype=cfg.dtype, device=device),
        cache_ids=full((K,), NO_ID, i32),
        cache_target=full((K,), -1, i32),
        cache_valid=full((K,), False, torch.bool),
        free_list=torch.arange(M - 1, -1, -1, dtype=i32, device=device),
        free_top=full((), M, i32),
        global_version=full((), 0, i64),
        id_loc=full((N,), -1, i32),
        codes=torch.zeros((M, cfg.pq_m_eff, C), dtype=torch.uint8,
                          device=device),
        pq_codebooks=torch.zeros(
            (cfg.pq_versions, cfg.pq_m_eff, cfg.pq_ksub, cfg.pq_dsub),
            dtype=torch.float32, device=device),
        pq_slot_gen=full((cfg.pq_versions,), 0, i64),
        pq_active=full((), 0, i32),
        pq_posting_slot=full((M,), 0, i32),
        heat=full((M,), 0, i64),
        tier_spilled=full((M,), False, torch.bool),
    )


def state_memory_bytes(state: IndexState) -> int:
    """Device bytes held by the index's tensors."""
    return int(sum(t.numel() * t.element_size()
                   for t in (getattr(state, f.name)
                             for f in dataclasses.fields(state))))


def tile_bytes(state: IndexState) -> int:
    """Bytes of one float posting tile (the unit the cold tier moves)."""
    return int(state.vectors[0].numel() * state.vectors.element_size())


def state_tier_bytes(state: IndexState) -> dict:
    """Device/host byte split under cold-tier residency: ``host`` is the
    float bytes of spilled tiles (held by the driver's host pool; the
    device copies are zeroed), ``device`` everything else, so ``device +
    host == state_memory_bytes``, the untiered total, by construction.
    The zeroed device tiles keep their allocation, as in the JAX
    package: the split is what a paging allocator would hold per tier."""
    host = int(state.tier_spilled.sum()) * tile_bytes(state)
    return {"device": state_memory_bytes(state) - host, "host": host}
