"""Distributed UBIS: the index over the cells of a data x model mesh.

The JAX package shards the posting pool over the ``model`` axis of a
device mesh, keeps every field whole over ``data`` (so each data row
holds a whole replica of the shards), and runs each program under
``shard_map``.  Here cell (r, s) of the mesh's grid lives on row r's
s-th device (``distributed/sharding.py``; on one card every cell is on
that card):

  * shard s owns its ``max_postings / S`` rows of every ``"model"``
    field of :func:`index_specs` and its own replica of every replicated
    field (the id map, the vector cache, the free-stack top, the global
    version, the codebooks), each a tensor of its own on its device,
    laid out from ``index_specs()`` by ``to_named_sharding`` and
    ``place`` (the reference's ``device_put`` by ``NamedSharding``,
    ``repro/api/sharded_driver.py:134-141``); every data row holds the
    S shards again (:class:`ShardRow`);
  * a program is the reference's per-shard stages over one row, stage s
    under shard s's device, separated by the collectives the reference
    calls, in the same order.  Each collective copies the shards' values
    onto the device that consumes them next (the search's final merge
    and the insert's routing run on the row's controller, its shard 0's
    device) and combines them in shard order; each program copies its
    queries or jobs to each shard once.  Each stage reads its own
    replica, so a shard never sees another shard's write of a replicated
    field within a program, as on a pod.  The replicas are identical
    after every program (:func:`check_replicas`);
  * over the rows, as under ``shard_map`` with the queries on the data
    axes and the jobs replicated: a search splits its batch into one
    contiguous block a row and joins the rows' answers in row order; an
    update program runs on every row, in row order, and returns row 0's
    outputs, so the rows stay identical bit for bit; ``exact`` runs on
    row 0;
  * code that works on the whole index (the codebook re-train, the
    cold tier, ``snapshot``) reads it through a global view:
    :meth:`ShardedState.gather` (an ordinary ``IndexState`` on the
    controller, a copy of row 0) and :meth:`ShardedState.scatter` back
    to every row, or :class:`GlobalView`, which gathers one field at a
    time from row 0 and writes rows on the shards that own them in
    every row.

One shard owns each posting, so structural updates (split / merge /
compact / GC) stay shard-local; only search and insert communicate:

  * search  — per-shard phase-1 top-nprobe, all-gather the (score, id)
              candidates, global re-rank, per-shard phase-2 scan of the
              postings it owns, all-gather per-shard top-k, final merge;
  * insert  — per-shard locate (scores vs. local centroids), global
              argmin over the gathered per-shard bests routes each job
              to its owner shard, which applies the conflict-free append.

Every top-k here is the stable one (ties lowest index first, as
``lax.top_k`` breaks them), and gathers are in shard order.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..distributed.sharding import (Mesh, all_gather, gather, place, pmax,
                                    psum, to_named_sharding)
from ..kernels import ops
from ..kernels.ref import BIG, stable_topk
from ..quant import pq
from . import balance, update, version_manager as vm
from .types import (NO_SUCC, STATUS_DELETED, STATUS_NORMAL, IndexState,
                    UBISConfig)
from .version_manager import masked_set_


def index_specs() -> dict:
    """Field -> ``"model"`` (rows shard over the model axis) or ``None``
    (replicated): the layout of the JAX package's ``index_specs``.  The
    id map and the vector cache are replicated (the cache is small and
    every search scans it); PQ codes and the tier flags follow their
    posting, the versioned codebooks are replicated."""
    model = {"vectors", "ids", "slot_valid", "used", "lengths", "centroids",
             "rec_meta", "rec_succ", "allocated", "nbrs", "free_list",
             "codes", "pq_posting_slot", "heat", "tier_spilled"}
    return {f.name: ("model" if f.name in model else None)
            for f in dataclasses.fields(IndexState)}


FIELDS = tuple(index_specs())
MODEL_FIELDS = tuple(f for f, ax in index_specs().items() if ax)
REPLICATED_FIELDS = tuple(f for f, ax in index_specs().items() if not ax)


def index_placements(mesh: Mesh) -> dict:
    """Field -> its ``Placement`` on ``mesh``: :func:`index_specs` as
    logical axes (a sharded field's leading dim on ``model``) through
    ``to_named_sharding``."""
    logical = {f: (ax,) if ax else () for f, ax in index_specs().items()}
    return to_named_sharding(mesh, logical, {"model": "model"})


def _shard_context(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardRow:
    """One data row of a :class:`ShardedState`: S shards, shard s on the
    row's s-th device, the interface a program reads.

    ``shards[s]`` is shard s's state: its ``max_postings / S`` rows of
    each sharded field and its replica of each replicated field, every
    one a tensor of its own on its device.  A program reads shard s with
    :meth:`local` and gives it back with :meth:`store`; ``mesh`` is the
    row as a mesh of its own (``mesh.device``: the row's controller)."""

    def __init__(self, mesh: Mesh, shards: list, pool: int):
        self.mesh = mesh
        self.devices = mesh.devices
        self.n_shards = len(shards)
        self.pool = pool
        self.shards = shards

    @property
    def rows(self) -> list:
        """A row is a mesh of one row: the programs take it as they take
        a :class:`ShardedState`."""
        return [self]

    def on(self, s: int):
        """The context of shard ``s``'s stage: its device is current."""
        return _shard_context(self.devices[s])

    def to_shards(self, x: torch.Tensor) -> list:
        """``x`` on every shard's device, in shard order (one copy a
        device it is not on yet; the same tensor where it is)."""
        return [x.to(d, non_blocking=True) for d in self.devices]

    def local(self, s: int) -> IndexState:
        """Shard ``s``'s state (its own tensors, in a new record)."""
        st = self.shards[s]
        return IndexState(**{f: getattr(st, f) for f in FIELDS})

    def store(self, s: int, local: IndexState) -> None:
        """Take shard ``s``'s state back after a stage (the fields a stage
        replaced instead of writing in place included).  Raises
        ``ValueError`` for a tensor that is not on the shard's device."""
        dev = self.devices[s]
        for f in FIELDS:
            t = getattr(local, f)
            if t.device != dev:
                raise ValueError(f"shard {s}'s {f} is on {t.device}, not "
                                 f"on its own device {dev}")
        self.shards[s] = IndexState(**{f: getattr(local, f)
                                       for f in FIELDS})


class ShardedState:
    """An ``IndexState`` held as D data rows of S shards, cell (r, s) on
    ``mesh.row_devices(r)[s]`` (:class:`ShardRow`: ``rows[r]``, or
    :meth:`row`).

    The rows are replicas of one another: a program keeps them
    identical, and every write from outside a program reaches every row
    (:meth:`store`, :meth:`scatter`, :meth:`replicate`,
    ``GlobalView.set_rows`` and field assignment).  Every read is row
    0's: ``shards``, :meth:`local`, :meth:`field`, :meth:`gather` and
    the :class:`GlobalView` (``state``).  :meth:`replicate` broadcasts
    row 0's shard 0's replicated fields to every other cell (the
    ``device_put`` of the reference)."""

    def __init__(self, state, mesh: Mesh):
        S = mesh.n_shards
        M = state.allocated.shape[0]
        if M % S:
            raise ValueError(f"max_postings {M} must divide the model axis "
                             f"({S} shards)")
        self.mesh = mesh
        self.n_shards = S
        self.n_rows = mesh.n_rows
        self.pool = M // S
        self.placements = index_placements(mesh)
        self._row_placements = index_placements(mesh.row(0))
        parts = {f: place(getattr(state, f), self.placements[f])
                 for f in FIELDS}
        self.rows = [
            ShardRow(mesh.row(r), [IndexState(**{f: parts[f][i]
                                                 for f in FIELDS})
                                   for i in mesh.grid[r]], self.pool)
            for r in range(self.n_rows)]

    def row(self, r: int) -> ShardRow:
        """Data row ``r``: the S shards a program runs on."""
        return self.rows[r]

    @property
    def shards(self) -> list:
        """Row 0's shards."""
        return self.rows[0].shards

    @property
    def devices(self) -> tuple:
        """Every cell's device, row by row (row 0's S first)."""
        return tuple(d for row in self.rows for d in row.devices)

    # ---- one shard of row 0; a store reaches every row -------------------

    def local(self, s: int) -> IndexState:
        """Row 0's shard ``s`` (its own tensors, in a new record)."""
        return self.rows[0].local(s)

    def store(self, s: int, local: IndexState) -> None:
        """Take shard ``s``'s state back into row 0 (``ShardRow.store``)
        and copy it into shard ``s`` of every other row."""
        self.rows[0].store(s, local)
        for row in self.rows[1:]:
            for f in FIELDS:
                _assign(row.shards[s], f, getattr(local, f))

    # ---- the replicas ---------------------------------------------------

    def replicate(self) -> None:
        """Every cell's replica := row 0's shard 0's replicated fields,
        copied onto the cell's device in place."""
        src = self.shards[0]
        for row in self.rows:
            for dst in row.shards:
                if dst is src:
                    continue
                for f in REPLICATED_FIELDS:
                    _assign(dst, f, getattr(src, f))

    # ---- the global view ------------------------------------------------

    @property
    def state(self) -> "GlobalView":
        """The whole index seen from the controller (:class:`GlobalView`)."""
        return GlobalView(self)

    def field(self, name: str, device=None) -> torch.Tensor:
        """One field of the whole index, a copy on ``device`` (the
        controller when None), read from row 0: a sharded field gathered
        in shard order, a replicated one shard 0's replica."""
        return gather([getattr(st, name) for st in self.shards],
                      self._row_placements[name], device)

    def gather(self, device=None) -> IndexState:
        """The whole index as an ordinary ``IndexState`` on ``device``
        (the controller when None), in storage of its own."""
        return IndexState(**{f: self.field(f, device) for f in FIELDS})

    def scatter(self, state, fields=None) -> None:
        """Write a whole-index ``state`` (or the named ``fields`` of it)
        back over every row's shards: each shard's rows of a sharded
        field, and every shard's replica of a replicated one."""
        for f in FIELDS if fields is None else fields:
            self.scatter_field(f, getattr(state, f))

    def scatter_field(self, name: str, value: torch.Tensor) -> None:
        whole = self.placements[name].model_dim is None
        for row in self.rows:
            for s, st in enumerate(row.shards):
                lo = s * self.pool
                _assign(st, name, value if whole
                        else value[lo:lo + self.pool])

    def memory_bytes(self) -> int:
        """Bytes of the index as the reference counts its global arrays:
        one row's shards' rows of the sharded fields, one replica of the
        replicated ones."""
        def nbytes(st, f):
            t = getattr(st, f)
            return int(t.numel() * t.element_size())
        return (sum(nbytes(st, f) for st in self.shards
                    for f in MODEL_FIELDS)
                + sum(nbytes(self.shards[0], f) for f in REPLICATED_FIELDS))

    # ---- rows by global pid ----------------------------------------------

    def by_shard(self, pids: torch.Tensor):
        """(shard, positions in ``pids``, local pids) for every shard that
        owns one of the global ``pids`` (a host read of ``pids``)."""
        p = pids.detach().to("cpu", torch.int64).reshape(-1)
        M = self.pool * self.n_shards
        if p.numel() and (int(p.min()) < 0 or int(p.max()) >= M):
            raise IndexError(f"pid outside [0, {M})")
        owner = torch.div(p, self.pool, rounding_mode="floor")
        for s in range(self.n_shards):
            at = torch.nonzero(owner == s).reshape(-1)
            if at.numel():
                yield s, at, p[at] - s * self.pool


def _assign(st: IndexState, name: str, value: torch.Tensor) -> None:
    """``st.<name>`` := ``value``, copied in place where the shapes and
    dtypes agree (the shard keeps its storage), else a new copy on the
    shard's device."""
    cur = getattr(st, name)
    if cur.shape == value.shape and cur.dtype == value.dtype:
        if cur.data_ptr() != value.data_ptr() or cur.device != value.device:
            cur.copy_(value, non_blocking=True)
    else:
        setattr(st, name, value.to(cur.device, copy=True))


_INPLACE_DUNDERS = frozenset({
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__imatmul__",
    "__itruediv__", "__ifloordiv__", "__imod__", "__ipow__", "__iand__",
    "__ior__", "__ixor__", "__ilshift__", "__irshift__"})
_CONVERSIONS = frozenset({"cpu", "cuda", "to", "type", "numpy"})


class GatheredCopy(torch.Tensor):
    """A sharded field read through :class:`GlobalView`: a copy gathered
    onto the controller.  A write into it would not reach the shards, so
    an in-place op on it, or on a view of it, raises ``RuntimeError``;
    what is computed from it is an ordinary tensor."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        written = list(args[:1]) if (
            name in _INPLACE_DUNDERS
            or (name.endswith("_") and not name.startswith("_"))) else []
        out = kwargs.get("out")
        if out is not None:
            written += list(out) if isinstance(out, (tuple, list)) else [out]
        if any(isinstance(t, cls) for t in written):
            raise RuntimeError(
                f"{name} would write into a sharded field read through the "
                "global view, a gathered copy: assign the field, use "
                "set_rows, or gather() ... scatter()")
        with torch._C.DisableTorchFunctionSubclass():
            ret = func(*args, **kwargs)
            if not isinstance(ret, torch.Tensor):
                return ret
            if name in _CONVERSIONS:
                # a copy on another device, or this one where it already
                # is: an ordinary tensor either way
                return ret.as_subclass(torch.Tensor)
            if any(isinstance(a, cls) and _aliases(ret, a) for a in args):
                return ret.as_subclass(cls)     # a view stays read-only
        return ret


def _aliases(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.device == b.device and a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr())


class GlobalView:
    """The whole index from the controller, field by field, for the code
    that reads it by field and writes it by posting (the cold tier, the
    metrics, the invariants):

      * reading a sharded field gathers a copy of row 0's onto the
        controller, a :class:`GatheredCopy` that refuses in-place writes;
        reading a replicated field gives row 0's shard 0's replica (a
        write into it lands there, and :meth:`ShardedState.replicate`
        carries it to every other cell);
      * assigning a field scatters it to every row (a replicated one to
        every shard);
      * :meth:`get_rows` / :meth:`row_parts` read rows by global pid on
        row 0's shards that own them, :meth:`set_rows` writes them on
        the owning shard of every row: the row interface ``IndexState``
        shares."""

    def __init__(self, sh: ShardedState):
        object.__setattr__(self, "_sh", sh)

    def __getattr__(self, name):
        sh = object.__getattribute__(self, "_sh")
        if name in MODEL_FIELDS:
            return sh.field(name).as_subclass(GatheredCopy)
        if name in REPLICATED_FIELDS:
            return getattr(sh.shards[0], name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name not in FIELDS:
            raise AttributeError(f"{name} is not an IndexState field")
        self._sh.scatter_field(name, value)

    @property
    def device(self) -> torch.device:
        return self._sh.mesh.device

    def live_vector_count(self) -> torch.Tensor:
        return psum([st.live_vector_count() for st in self._sh.shards],
                    self.device)

    def row_parts(self, name: str, pids: torch.Tensor) -> list:
        """``field[pids]`` of a sharded field where it lives in row 0:
        (positions in ``pids``, the owning shard's rows on its own
        device), shard by shard."""
        sh = self._sh
        row = sh.rows[0]
        out = []
        for s, at, loc in sh.by_shard(pids):
            with row.on(s):
                out.append((at, getattr(row.shards[s], name)[
                    loc.to(row.devices[s])]))
        return out

    def get_rows(self, name: str, pids: torch.Tensor) -> torch.Tensor:
        """``field[pids]`` of a sharded field, on the controller."""
        ref = getattr(self._sh.shards[0], name)
        out = torch.empty((pids.numel(),) + tuple(ref.shape[1:]),
                          dtype=ref.dtype, device=self.device)
        for at, rows in self.row_parts(name, pids):
            out[at.to(self.device)] = rows.to(self.device)
        return out

    def set_rows(self, name: str, pids: torch.Tensor, value,
                 valid: torch.Tensor) -> None:
        """``field[pids[j]] = value[j]`` where ``valid[j]`` (``masked_set_``
        on each owning shard, in every row); ``value`` a scalar or one
        row a pid."""
        sh = self._sh
        for s, at, loc in sh.by_shard(pids):
            v = value
            if torch.is_tensor(value) and value.dim():
                v = value[at.to(value.device)]
            ok = valid[at.to(valid.device)]
            for row in sh.rows:
                dev = row.devices[s]
                with row.on(s):
                    masked_set_(getattr(row.shards[s], name), loc.to(dev),
                                v.to(dev) if torch.is_tensor(v) else v,
                                ok.to(dev))


def _cell(r: int, s: int) -> str:
    return f"shard {s}" if r == 0 else f"row {r}'s shard {s}"


def check_replicas(sh: ShardedState) -> None:
    """Raise ``AssertionError`` unless every shard's replica of every
    replicated field equals row 0's shard 0's, and every row's shards
    equal row 0's, every field, bit for bit."""
    ref = sh.shards[0]
    for s in range(1, sh.n_shards):
        st = sh.shards[s]
        for f in REPLICATED_FIELDS:
            t = getattr(st, f)
            if not torch.equal(t, getattr(ref, f).to(t.device)):
                raise AssertionError(f"replica of {f} on shard {s} differs "
                                     "from shard 0's")
    for r in range(1, sh.n_rows):
        for s, st in enumerate(sh.rows[r].shards):
            for f in FIELDS:
                t, want = getattr(st, f), getattr(sh.shards[s], f)
                if t.shape != want.shape or not torch.equal(
                        t, want.to(t.device)):
                    raise AssertionError(f"{f} of {_cell(r, s)} differs "
                                         f"from row 0's shard {s}'s")


def audit_placement(sh: ShardedState) -> None:
    """Raise ``AssertionError`` unless every tensor of every cell (r, s)
    lies on row r's s-th device and no two cells share storage."""
    owner = {}
    for r, row in enumerate(sh.rows):
        for s, st in enumerate(row.shards):
            for f in FIELDS:
                t = getattr(st, f)
                if t.device != row.devices[s]:
                    raise AssertionError(f"{_cell(r, s)}'s {f} is on "
                                         f"{t.device}, not on "
                                         f"{row.devices[s]}")
                if not t.numel():
                    continue
                key = (t.device, t.untyped_storage().data_ptr())
                if owner.setdefault(key, (r, s, f))[:2] != (r, s):
                    o = owner[key]
                    raise AssertionError(
                        f"{_cell(r, s)}'s {f} shares storage with "
                        f"{_cell(o[0], o[1])}'s {o[2]}")


def _every_row(run_row):
    """An update program over every data row, in row order: each row
    runs ``run_row`` on its own replica with the jobs on its controller
    (the reference's jobs are replicated, ``P()``), so the rows stay
    identical; returns (sh, row 0's outputs)."""
    def run(sh, *args):
        outs = None
        for row in sh.rows:
            ctrl = row.mesh.device
            got = run_row(row, *(a.to(ctrl, non_blocking=True)
                                 if torch.is_tensor(a) else a for a in args))
            if outs is None:
                outs = got[1:]
        return (sh,) + tuple(outs)
    return run


def _split_rows(run_row):
    """A search over the data rows: the batch split into one contiguous
    block a row (``P("data")`` on dim 0), every row's search launched
    before any is read, the answers joined on the controller in row
    order."""
    def run(sh, queries: torch.Tensor):
        D = len(sh.rows)
        if D == 1:
            return run_row(sh.rows[0], queries)
        Q = queries.shape[0]
        if Q % D:
            raise ValueError(f"a batch of {Q} queries does not divide over "
                             f"the {D} data rows")
        outs = [run_row(row, blk.to(row.mesh.device, non_blocking=True))
                for row, blk in zip(sh.rows, torch.split(queries, Q // D))]
        ctrl = sh.mesh.device
        return tuple(all_gather([o[i] for o in outs], 0, ctrl)
                     for i in range(2))
    return run


def _local_topk(scores, ids, k):
    s, idx = stable_topk(scores, k)
    return s, torch.gather(ids, -1, idx)


def _owned_cache_slice(state: IndexState, my: int, n_shard: int):
    """This shard's 1/S slice of the replicated vector cache: (vecs,
    valid, ids), with the rows of the clamped overlap masked OUT of
    ``valid``.  Ceil-div slices of a capacity S does not divide overlap
    at the end (the ``start`` clamp); the ownership mask keeps every
    cache slot scanned by exactly one shard, so the merge can never
    count an entry twice.  Shared by the sharded search and exact."""
    K_all = state.cache_vecs.shape[0]
    Ks = -(-K_all // n_shard)
    start = min(my * Ks, K_all - Ks)
    cvs = state.cache_vecs[start:start + Ks]
    cval = state.cache_valid[start:start + Ks]
    cid = state.cache_ids[start:start + Ks]
    own = (torch.arange(Ks, device=cval.device) + start) >= my * Ks
    return cvs, cval & own, cid


def _rebase_succ(rec_succ, offset: int, limit: int):
    """Shift stored successor pids by ``offset``; anything landing outside
    [0, limit) becomes no-successor (``NO_SUCC`` stays ``NO_SUCC``)."""
    s1, s2 = vm.succ_ids(rec_succ)

    def shift(s):
        t = torch.where(s >= 0, s.to(torch.int64) + offset, -1)
        return torch.where((t >= 0) & (t < limit), t, -1)

    t1, t2 = shift(s1), shift(s2)
    return vm.pack_succ(torch.where(t1 < 0, NO_SUCC, t1),
                        torch.where(t2 < 0, NO_SUCC, t2))


def _pq_phase2(state: IndexState, cfg: UBISConfig, queries, probe, mine,
               vis, k: int):
    """Sharded search phase 2 served from PQ codes (``cfg.use_pq``): per
    shard, the ADC scan of the owned probed tiles' codes with the
    ownership mask applied in the kernel, then the exact rerank of the
    local top ``rerank_k``.  Returns this shard's (scores, ids)."""
    C = state.vectors.shape[1]
    R = min(cfg.rerank_k, probe.shape[1] * C)
    luts = pq.lookup_tables(state.pq_codebooks, queries)   # (Q, V, m, ksub)
    adc_top, cand = ops.pq_scan_topk(
        luts, state.codes, state.pq_posting_slot, state.slot_valid, vis,
        probe, k=R, qp_ok=mine)
    exact, cand_sel = ops.rerank_topk(queries, state.vectors,
                                      state.tier_spilled, cand, adc_top,
                                      k=min(k, R))
    ids = state.ids.reshape(-1)[cand_sel.to(torch.int64)]
    return exact, torch.where(exact < BIG / 2, ids, -1)


def make_sharded_search(cfg: UBISConfig, mesh: Mesh, k: int,
                        nprobe: int | None = None,
                        shard_cache_scan: bool = True):
    """The sharded search: (sh, queries (Q, d)) -> (ids (Q, k) int32,
    scores (Q, k)) on the controller, the batch split over the data rows
    (Q a multiple of D; a :class:`ShardRow` takes any Q).
    ``shard_cache_scan``: each shard scans only its 1/S slice of the
    replicated cache (else shard 0 scans all of it); the merge
    all-gather combines the partial top-ks.
    ``cfg.shard_probe_cap`` > 0 compacts each shard's phase-2 scan to its
    first that many owned probes (phase-1 order, best first)."""
    if nprobe is None:
        nprobe = cfg.nprobe
    probe_cap = cfg.shard_probe_cap

    def run(sh: ShardRow, queries: torch.Tensor):
        S, M_local, ctrl = sh.n_shards, sh.pool, sh.mesh.device
        qs = sh.to_shards(queries.to(torch.float32))
        locs = [sh.local(s) for s in range(S)]
        # phase 1 local: fused centroid score + per-shard top-nprobe
        p_local = min(nprobe, M_local)
        vis, s1, pid = [], [], []
        for my, st in enumerate(locs):
            with sh.on(my):
                v = vm.visible(st.rec_meta, st.allocated, st.global_version)
                sc, lp = ops.centroid_topk(qs[my], st.centroids, v,
                                           k=p_local)
            vis.append(v)
            s1.append(sc)
            pid.append(lp)
        # global re-rank of the gathered candidates
        s1_all = all_gather(s1, 1, ctrl)
        pid_all = all_gather(pid, 1, ctrl).to(torch.int64)
        owner = torch.arange(S, device=ctrl).repeat_interleave(
            p_local)[None, :].expand(s1_all.shape)
        _, sel = stable_topk(s1_all, nprobe)
        owners = sh.to_shards(torch.gather(owner, 1, sel))
        pids = sh.to_shards(torch.gather(pid_all, 1, sel))
        cap = probe_cap if probe_cap else nprobe
        s_parts, i_parts = [], []
        for my, st in enumerate(locs):
            with sh.on(my):
                # phase 2: scan the selected postings THIS shard owns
                mine = owners[my] == my
                if cap < nprobe:
                    order = torch.argsort((~mine).to(torch.uint8), dim=1,
                                          stable=True)[:, :cap]
                    pid_cap = torch.gather(pids[my], 1, order)
                    mine_cap = torch.gather(mine, 1, order)
                else:
                    pid_cap, mine_cap = pids[my], mine
                safe_pid = torch.where(mine_cap, pid_cap, 0)
                if cfg.use_pq:
                    s2, i2 = _pq_phase2(st, cfg, qs[my], safe_pid, mine_cap,
                                        vis[my], k)
                else:
                    C = st.vectors.shape[1]
                    k_local = min(k, safe_pid.shape[1] * C)
                    s2, cand2 = ops.posting_scan_topk(
                        qs[my], st.vectors, st.slot_valid, vis[my],
                        safe_pid, k=k_local, qp_ok=mine_cap)
                    i2 = st.ids.reshape(-1)[cand2.to(torch.int64)]
                # cache scan: a 1/S slice per shard (or shard 0 scans all)
                if shard_cache_scan:
                    cvs, cval_own, cid = _owned_cache_slice(st, my, S)
                    s3, cpos = ops.centroid_topk(qs[my], cvs, cval_own,
                                                 k=min(k, cvs.shape[0]))
                    i3 = cid[cpos.to(torch.int64)]
                else:
                    cval = st.cache_valid & (my == 0)
                    s3, cpos = ops.centroid_topk(
                        qs[my], st.cache_vecs, cval,
                        k=min(k, st.cache_vecs.shape[0]))
                    i3 = st.cache_ids[cpos.to(torch.int64)]
                s_parts.append(torch.cat([s2, s3], dim=1))
                i_parts.append(torch.cat([i2, i3], dim=1))
        # global merge, on the controller
        sf, idf = _local_topk(all_gather(s_parts, 1, ctrl),
                              all_gather(i_parts, 1, ctrl), k)
        return torch.where(sf < BIG / 2, idf, -1), sf

    return _split_rows(run)


def make_sharded_insert(cfg: UBISConfig, mesh: Mesh,
                        route_alpha: float = 0.0):
    """The sharded insert round: (sh, vecs, ids, valid) -> (sh, accepted
    (J,) bool, routed (J,) int32), the masks on the controller.  Like
    every update program it runs on every data row (``_every_row``) and
    returns row 0's outputs.

    Each shard locates jobs against its local centroids (NORMAL, not
    spilled postings only); a global argmin routes each job to its owner
    shard, which runs the conflict-free batched append on its sub-pool.
    Blocked jobs are *rejected*: the cache is replicated, so the driver
    parks them.  ``routed`` is the GLOBAL pid located for each job (-1
    when nothing was insertable), the parked jobs' cache target.
    ``route_alpha`` > 0 penalizes each job's per-shard best score by
    ``route_alpha * saturation * range`` (saturation: the shard's live
    vectors over its pool's ``M_local * l_max``; range: the job's finite
    score spread), so a nearly-full shard only wins a job it is
    decisively closest to."""
    C = cfg.capacity

    def run(sh: ShardRow, vecs, ids, valid):
        S, M_local, ctrl = sh.n_shards, sh.pool, sh.mesh.device
        vs, js, oks = sh.to_shards(vecs), sh.to_shards(ids), \
            sh.to_shards(valid)
        locs = [sh.local(s) for s in range(S)]
        best_local, best_pid, sat = [], [], []
        for my, st in enumerate(locs):
            with sh.on(my):
                status = vm.unpack_status(st.rec_meta)
                insertable = (st.allocated & (status == STATUS_NORMAL)
                              & ~st.tier_spilled)
                sc = ops.centroid_score(vs[my], st.centroids, insertable)
                bp = torch.argmin(sc, dim=1)
                best_local.append(torch.gather(sc, 1, bp[:, None])[:, 0])
                best_pid.append(bp)
                del sc
                if route_alpha:
                    alive = st.allocated & (status != STATUS_DELETED)
                    live = torch.where(alive, st.lengths, 0).sum()
                    sat.append((live.to(torch.float32)
                                / float(M_local * cfg.l_max))[None])
        # global owner = argmin over shards (lowest shard on a tie)
        all_best = all_gather([b[None] for b in best_local], 0, ctrl)
        if route_alpha:
            sat_all = all_gather(sat, 0, ctrl)                   # (S,)
            finite = all_best < BIG / 2
            vmin = torch.where(finite, all_best, BIG).min(dim=0).values
            vmax = torch.where(finite, all_best, -BIG).max(dim=0).values
            rng_j = torch.clamp(vmax - vmin, min=0.0)
            all_best = torch.where(
                finite,
                all_best + route_alpha * sat_all[:, None] * rng_j[None, :],
                all_best)
        owners = sh.to_shards(torch.argmin(all_best, dim=0))
        routed_c, claim_c, flat_c, won_c = [], [], [], []
        for my, st in enumerate(locs):
            with sh.on(my):
                claim = (owners[my] == my) & (best_local[my] < BIG / 2)
                mine = oks[my] & claim
                routed_c.append(torch.where(claim, best_pid[my]
                                            + my * M_local, 0))
                claim_c.append(claim.to(torch.int64))
                st, ok, flat_local = update.batched_append(
                    st, cfg, vs[my], js[my],
                    torch.where(mine, best_pid[my], -1), mine,
                    update_id_loc=False)
                won = mine & ok
                flat_c.append(torch.where(
                    won, my * (M_local * C) + flat_local, 0))
                won_c.append(won.to(torch.int64))
            locs[my] = st
        routed = psum(routed_c, ctrl)
        routable = psum(claim_c, ctrl) > 0
        routed = torch.where(valid & routable, routed, -1)
        # the replicated id map: one-hot sums, one winner per job
        accepted = valid & (psum(won_c, ctrl) > 0)
        flats = sh.to_shards(psum(flat_c, ctrl).to(torch.int32))
        accs = sh.to_shards(accepted)
        safe = sh.to_shards(ids.to(torch.int64).clamp(0, cfg.max_ids - 1))
        for my, st in enumerate(locs):
            with sh.on(my):
                masked_set_(st.id_loc, safe[my], flats[my], accs[my])
                st.global_version = st.global_version + 1
            sh.store(my, st)
        return sh, accepted, routed.to(torch.int32)

    return _every_row(run)


def make_sharded_delete(cfg: UBISConfig, mesh: Mesh):
    """The sharded delete round: (sh, del_ids, valid) -> (sh, done (J,)
    bool on the controller).  Locations come from the replicated id map,
    so routing is free: each shard tombstones the locations in its own
    span (``update.apply_tombstones(base=)``), and the cache and id-map
    updates are computed identically on every shard from its replica.
    UBIS semantics only."""
    C = cfg.capacity

    def run(sh: ShardRow, del_ids, valid):
        done0 = None
        safe = del_ids.to(torch.int64).clamp(0, cfg.max_ids - 1)
        firsts = sh.to_shards(vm.first_occurrence_mask(safe) & valid)
        safes = sh.to_shards(safe)
        for my in range(sh.n_shards):
            st = sh.local(my)
            with sh.on(my):
                loc = st.id_loc[safes[my]]
                in_post = firsts[my] & (loc >= 0)
                in_cache = firsts[my] & (loc <= -2)
                st, done = update.apply_tombstones(
                    st, cfg, safes[my], loc, in_post, in_cache,
                    base=my * sh.pool * C)
            sh.store(my, st)
            if done0 is None:
                done0 = done
        return sh, done0

    return _every_row(run)


def make_sharded_background(cfg: UBISConfig, mesh: Mesh, bg_ops: int = 8,
                            reassign: bool = True, gc_k: int = 64):
    """The sharded background tick: (sh, gc_min_version) -> (sh, executed,
    reclaimed, pressure (S, 4) int32), on the controller.

    Every shard runs the same program over the postings it owns: select
    the top ``bg_ops`` candidates, mark, execute
    (``balance.background_round`` with ``use_cache=False``: the cache is
    replicated, so split-side spills fold back into child ``a``), then
    epoch GC of up to ``gc_k`` of its retired postings older than
    ``gc_min_version``.  The shard-specific steps, as in the reference:

      * a local free view is derived from ``allocated`` on entry; the
        state leaves with a fail-safe EMPTY stack (``free_top = 0``);
      * successor pointers are stored global and used local: localized
        on entry (cross-shard successors dead-end), and only the words
        the round rewrote are rebased back on exit;
      * the id map's local rewrites are rebased by the shard's pool
        offset and merged with one sum of deltas (in shard order);
      * ``global_version`` is the max over shards.

    ``pressure`` is ``balance.shard_pressure`` per shard, after the
    round and GC: the rebalance planner's input."""
    C = cfg.capacity

    def run(sh: ShardRow, gc_min_version):
        S, M_local, ctrl = sh.n_shards, sh.pool, sh.mesh.device
        locs, olds, deltas, execs, gcs = [], [], [], [], []
        for my in range(S):
            st = sh.local(my)
            base_pid = my * M_local
            with sh.on(my):
                st = update.rebuild_free_stack(st)
                old_succ_global = st.rec_succ.clone()
                succ_local0 = _rebase_succ(old_succ_global, -base_pid,
                                           M_local)
                st.rec_succ = succ_local0.clone()
                old_id_loc = st.id_loc.clone()
                kinds, pids = balance.select_candidates(st, cfg, bg_ops)
                st.rec_meta = balance.mark_selected(st.rec_meta, kinds, pids)
                st, rr = balance.background_round(st, cfg, kinds, pids,
                                                  reassign=reassign,
                                                  use_cache=False)
                st, n_gc = balance.gc_round(st, cfg, gc_min_version, gc_k)
                # the id map's rewrites, rebased from local to global flats
                il = st.id_loc.to(torch.int64)
                old = old_id_loc.to(torch.int64)
                changed = il != old
                rebased = torch.where(changed & (il >= 0),
                                      il + my * (M_local * C), il)
                deltas.append(torch.where(changed, rebased - old, 0))
                succ_changed = st.rec_succ != succ_local0
                st.rec_succ = torch.where(
                    succ_changed,
                    _rebase_succ(st.rec_succ, base_pid, cfg.max_postings),
                    old_succ_global)
            locs.append(st)
            olds.append(old)
            execs.append(rr.executed.to(torch.int64))
            gcs.append(n_gc.to(torch.int64))
        totals = sh.to_shards(psum(deltas, ctrl))
        versions = sh.to_shards(pmax([st.global_version for st in locs],
                                     ctrl))
        pressure = []
        for my, st in enumerate(locs):
            with sh.on(my):
                st.id_loc = (olds[my] + totals[my]).to(torch.int32)
                st.free_top = torch.zeros_like(st.free_top)
                st.global_version = versions[my].clone()
                pressure.append(balance.shard_pressure(
                    st, cfg, base_pid=my * M_local)[None])
            sh.store(my, st)
        return (sh, psum(execs, ctrl), psum(gcs, ctrl),
                all_gather(pressure, 0, ctrl))

    return _every_row(run)


def make_sharded_migrate(cfg: UBISConfig, mesh: Mesh, jobs: int = 8):
    """The cross-shard posting migration round: (sh, src_pids (B,),
    dst_shards (B,), valid (B,)) -> (sh, migrated (B,) bool, new_pids (B,)
    int32) on the controller, B = ``jobs`` (another width raises
    ``ValueError``).

    ``new_pids`` is the landing GLOBAL pid per job (-1 when the job did
    not move): the cold tier remaps its host-pool entries by it, because
    a **spilled** posting migrates without promotion (its zeroed tile,
    codes, heat and ``tier_spilled`` flag travel verbatim).  Three steps:

      * extraction: the owner shard's tile, ids, slot validity, used and
        live counts, centroid, codes, codebook slot, heat and spill flag
        of each job reach every shard as a one-hot sum (exactly one shard
        adds a value, the others zeros, so the copy is bit-exact).  Only
        allocated NORMAL postings move;
      * installation: the receiver grants slots from its local free view
        in batch order while they last, writes the payload verbatim into
        them with an empty neighbour row (the donor's row holds
        shard-local pids) and claims the recorder word at the round's
        version;
      * hand-off: the donor retires its copy (DELETED, no successors) and
        every shard applies the identical id-map rewrite from the
        replicated payload.

    The free stack leaves fail-safe EMPTY."""
    C = cfg.capacity

    def run(sh: ShardRow, src_pids, dst_shards, valid):
        if src_pids.shape[0] != jobs:
            raise ValueError(f"migrate round built for jobs={jobs}, "
                             f"got batch of {src_pids.shape[0]}")
        S, M_local, ctrl = sh.n_shards, sh.pool, sh.mesh.device
        B = jobs
        src = src_pids.to(torch.int64)
        dst = dst_shards.to(torch.int64)
        locs = []
        for my in range(S):
            with sh.on(my):
                locs.append(update.rebuild_free_stack(sh.local(my)))
        src_shard = torch.div(src, M_local, rounding_mode="floor")
        job_ok = (valid & (src >= 0) & (src < S * M_local)
                  & vm.first_occurrence_mask(src)
                  & (dst >= 0) & (dst < S) & (dst != src_shard))
        srcs, oks = sh.to_shards(src), sh.to_shards(job_ok)

        # ---- donor extraction: one-hot sums replicate each payload ----
        names = ("vectors", "ids", "slot_valid", "used", "lengths",
                 "centroids", "codes", "pq_posting_slot", "heat",
                 "tier_spilled")
        parts = {n: [] for n in names}
        donates, sls = [], []
        for my, st in enumerate(locs):
            with sh.on(my):
                src_local = srcs[my] - my * M_local
                sl = src_local.clamp(0, M_local - 1)
                status = vm.unpack_status(st.rec_meta)
                donate = (oks[my] & (src_local >= 0)
                          & (src_local < M_local)
                          & st.allocated[sl] & (status[sl] == STATUS_NORMAL))
                for n in names:
                    x = getattr(st, n)[sl]
                    if x.dtype in (torch.bool, torch.uint8):
                        x = x.to(torch.int64)
                    mask = donate.reshape((B,) + (1,) * (x.dim() - 1))
                    parts[n].append(torch.where(mask, x,
                                                torch.zeros_like(x)))
            donates.append(donate)
            sls.append(sl)
        pay = {n: psum(v, ctrl) for n, v in parts.items()}
        movable = psum([d.to(torch.int64) for d in donates], ctrl) > 0

        # ---- receiver admission: sequential free-stack grant scan -----
        movables, dsts = sh.to_shards(movable), sh.to_shards(dst)
        grants, news = [], []
        for my, st in enumerate(locs):
            with sh.on(my):
                want = movables[my] & (dsts[my] == my)
                granted, starts = balance._grant(want.to(torch.int64),
                                                 st.free_top)
                grant = want & granted
                idx = (st.free_top - 1 - starts).clamp(0, M_local - 1)
                grants.append(grant)
                news.append(torch.where(
                    grant, st.free_list[idx].to(torch.int64), -1))
        new_global = psum([torch.where(g, n + my * M_local, 0)
                           for my, (g, n) in enumerate(zip(grants, news))],
                          ctrl)
        migrated = psum([g.to(torch.int64) for g in grants], ctrl) > 0
        new_global = torch.where(migrated, new_global, -1)

        ids_flat = pay["ids"].reshape(B * C)
        live_flat = ((pay["slot_valid"] > 0) & migrated[:, None]).reshape(
            B * C) & (ids_flat >= 0)
        new_flat = (new_global[:, None] * C + torch.arange(
            C, device=ctrl)[None, :]).reshape(-1).to(torch.int32)
        safe_flat = ids_flat.to(torch.int64).clamp(0, cfg.max_ids - 1)
        # the payload and the id-map rewrite, copied to each shard once
        pays = {n: sh.to_shards(v) for n, v in pay.items()}
        migs, lives, safes, flats = (sh.to_shards(migrated),
                                     sh.to_shards(live_flat),
                                     sh.to_shards(safe_flat),
                                     sh.to_shards(new_flat))
        for my, st in enumerate(locs):
            with sh.on(my):
                p = {n: v[my] for n, v in pays.items()}
                ver = st.global_version + 1
                g, tgt = grants[my], news[my]
                # ---- install on the receiver --------------------------
                masked_set_(st.vectors, tgt, p["vectors"], g)
                masked_set_(st.ids, tgt, p["ids"], g)
                masked_set_(st.slot_valid, tgt, p["slot_valid"] > 0, g)
                masked_set_(st.used, tgt, p["used"], g)
                masked_set_(st.lengths, tgt, p["lengths"], g)
                masked_set_(st.centroids, tgt, p["centroids"], g)
                masked_set_(st.nbrs, tgt, -1, g)
                masked_set_(st.codes, tgt, p["codes"].to(torch.uint8), g)
                masked_set_(st.pq_posting_slot, tgt, p["pq_posting_slot"],
                            g)
                masked_set_(st.heat, tgt, p["heat"], g)
                masked_set_(st.tier_spilled, tgt, p["tier_spilled"] > 0, g)
                masked_set_(st.rec_meta, tgt,
                            vm.pack_meta(STATUS_NORMAL, ver), g)
                masked_set_(st.rec_succ, tgt, (NO_SUCC << 16) | NO_SUCC, g)
                masked_set_(st.allocated, tgt, True, g)
                # ---- donor retirement (no successors) -----------------
                retire = donates[my] & migs[my]
                gone = torch.where(retire, sls[my], -1)
                st.rec_meta = vm.transition(st.rec_meta, gone,
                                            STATUS_DELETED, ver.expand((B,)))
                st.rec_succ = vm.set_successors(st.rec_succ, gone, -1, -1)
                masked_set_(st.tier_spilled, sls[my], False, retire)
                # ---- the replicated id map: one rewrite on every shard
                masked_set_(st.id_loc, safes[my], flats[my], lives[my])
                st.free_top = torch.zeros_like(st.free_top)
                st.global_version = ver
            sh.store(my, st)
        return sh, migrated, new_global.to(torch.int32)

    return _every_row(run)


def make_sharded_exact(cfg: UBISConfig, mesh: Mesh, k: int):
    """The exact top-k oracle over the sharded live contents: (sh,
    queries) -> (ids, scores) on the controller, the sharded form of
    ``search.brute_force``, on row 0 (every row holds the same index, and
    the oracle gains nothing from the data axis).  Each shard scans
    every slot it owns (slot
    validity, visibility, not spilled) and its 1/S slice of the cache,
    takes a local top-k of its own id rows, and one gather + merge gives
    the global result.  The caller chunks the queries: a shard's score
    block is Q x (M_local * C + its cache slice)."""

    def run(sh: ShardRow, queries: torch.Tensor):
        S, ctrl = sh.n_shards, sh.mesh.device
        qs = sh.to_shards(queries.to(torch.float32))
        s_parts, i_parts = [], []
        for my in range(S):
            st = sh.local(my)
            with sh.on(my):
                vis = vm.visible(st.rec_meta, st.allocated,
                                 st.global_version)
                valid = st.slot_valid & (vis & ~st.tier_spilled)[:, None]
                s = ops.posting_scan(qs[my], st.vectors, valid)
                cvs, cval_own, cid = _owned_cache_slice(st, my, S)
                cs = ops.centroid_score(qs[my], cvs, cval_own)
                scores = torch.cat([s, cs], dim=1)
                del s, cs
                flat = torch.cat([st.ids.reshape(-1), cid])
                top, idx = stable_topk(scores, min(k, scores.shape[1]))
                del scores
                s_parts.append(top)
                i_parts.append(flat[idx])
        sf, idf = _local_topk(all_gather(s_parts, 1, ctrl),
                              all_gather(i_parts, 1, ctrl), k)
        return torch.where(sf < BIG / 2, idf, -1), sf


    def on_row0(sh, queries: torch.Tensor):
        return run(sh.rows[0], queries)
    return on_row0
