"""FreshDiskANN-lite: the graph-based comparison baseline (paper V-A).

A reduced-scale but behaviourally faithful Vamana/FreshDiskANN: a fixed
out-degree proximity graph, greedy beam search, RobustPrune(alpha)
insertion with back-edges, lazy tombstone deletes with periodic
consolidation.  The beam search is tensor code on the index's device,
batched over the queries: ``L`` rounds of argmin, neighbour gather,
distance, duplicate mask and a stable merge (the JAX package's vmapped
``fori_loop``).  The insert path (RobustPrune, back-edges,
consolidation) is host numpy, as in the JAX package.

The paper's observations this must reproduce: (a) competitive QPS,
(b) recall degradation under heavy streaming churn (fresh inserts
re-wire neighbourhoods and tombstones break navigability until
consolidation), (c) higher memory than the cluster-based index.

Tie order follows the reference: the merges sort stably
(``torch.argsort(stable=True)``, as ``jnp.argsort``), ``torch.argmin``
takes the first index as ``jnp.argmin`` does, and ``exact`` keeps
numpy's default ``argsort``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from ..api.types import SearchResult, TickReport, UpdateResult
from .driver import resolve_device

BIG = 1e30
EXACT_CHUNK_FLOATS = 1 << 26  # exact(): difference block per query chunk


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    dim: int = 64
    max_nodes: int = 1 << 17
    degree: int = 32              # R (memory-index out-degree)
    beam: int = 40                # L (search candidate list)
    alpha: float = 1.2            # RobustPrune slack
    consolidate_every: int = 4096  # deletes between consolidations


@dataclasses.dataclass
class GraphState:
    vectors: torch.Tensor    # (N, d) f32
    nbrs: torch.Tensor       # (N, R) int32, -1 pad
    valid: torch.Tensor      # (N,) bool (tombstones False)
    ids: torch.Tensor        # (N,) int32 external ids
    n_used: torch.Tensor     # () int32
    entry: torch.Tensor      # () int32 medoid / entry point

    def clone(self) -> "GraphState":
        return GraphState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


def empty_graph(cfg: GraphConfig, device) -> GraphState:
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)
    return GraphState(
        vectors=full((cfg.max_nodes, cfg.dim), 0.0, torch.float32),
        nbrs=full((cfg.max_nodes, cfg.degree), -1, torch.int32),
        valid=full((cfg.max_nodes,), False, torch.bool),
        ids=full((cfg.max_nodes,), -1, torch.int32),
        n_used=full((), 0, torch.int32),
        entry=full((), 0, torch.int32),
    )


def _dist(a, b):
    d = a - b
    return (d * d).sum(-1)


def beam_search(state: GraphState, cfg: GraphConfig, queries: torch.Tensor,
                iters: Optional[int] = None):
    """Batched greedy beam search.  Returns (cand (Q, L) int64 node
    indices sorted by distance, -1 empty; dists (Q, L) f32)."""
    L, R = cfg.beam, cfg.degree
    if iters is None:
        iters = L
    q = queries.float()
    Q, dev = q.shape[0], q.device
    rows = torch.arange(Q, device=dev)
    entry = state.entry.long()
    cand = torch.full((Q, L), -1, dtype=torch.int64, device=dev)
    cand[:, 0] = entry
    dist = torch.full((Q, L), BIG, dtype=torch.float32, device=dev)
    dist[:, 0] = _dist(q, state.vectors[entry][None])
    expanded = torch.zeros((Q, L), dtype=torch.bool, device=dev)
    fresh = torch.zeros((Q, R), dtype=torch.bool, device=dev)
    for _ in range(iters):
        # best unexpanded candidate
        score = torch.where(expanded | (cand < 0), BIG, dist)
        i = torch.argmin(score, dim=1)
        has = score[rows, i] < BIG / 2
        expanded[rows, i] = True
        node = cand[rows, i].clamp(min=0)
        nb = state.nbrs[node].long()                        # (Q, R)
        nb_ok = (nb >= 0) & has[:, None]
        nbv = state.vectors[nb.clamp(min=0)]                # (Q, R, d)
        nd = torch.where(nb_ok, _dist(q[:, None], nbv), BIG)
        # skip neighbours already in the list
        dup = (nb[:, :, None] == cand[:, None, :]).any(2)
        nd = torch.where(dup, BIG, nd)
        # merge: keep top-L by distance
        all_c = torch.cat([cand, nb], 1)
        all_d = torch.cat([dist, nd], 1)
        all_e = torch.cat([expanded, fresh], 1)
        order = torch.argsort(all_d, dim=1, stable=True)[:, :L]
        cand = torch.gather(all_c, 1, order)
        dist = torch.gather(all_d, 1, order)
        expanded = torch.gather(all_e, 1, order)
    return cand, dist


def _search_topk(state: GraphState, cfg: GraphConfig, queries, k: int):
    cand, dist = beam_search(state, cfg, queries)
    safe = cand.clamp(min=0)
    ok = (cand >= 0) & state.valid[safe]
    dist = torch.where(ok, dist, BIG)
    order = torch.argsort(dist, dim=1, stable=True)[:, :k]
    ids = torch.gather(state.ids[safe], 1, order)
    d = torch.gather(dist, 1, order)
    return torch.where(d < BIG / 2, ids, -1), d


def robust_prune(q_vec, cand_idx, cand_dist, vectors, R, alpha):
    """NumPy RobustPrune (host-side insert path)."""
    order = np.argsort(cand_dist)
    chosen: list = []
    for i in order:
        c = int(cand_idx[i])
        if c < 0 or cand_dist[i] >= BIG / 2:
            continue
        if any(c == x for x in chosen):
            continue
        ok = True
        for x in chosen:
            dxc = float(np.sum((vectors[x] - vectors[c]) ** 2))
            if alpha * dxc < cand_dist[i]:
                ok = False
                break
        if ok:
            chosen.append(c)
        if len(chosen) >= R:
            break
    return chosen


class FreshDiskANN:
    """Host-driven streaming graph index (insert path mirrors the
    paper's in-memory index + periodic consolidation).  The graph lives
    on ``device`` (the card unless ``device="cpu"``), with a host copy
    of the vectors and edges that the insert path edits."""

    def __init__(self, cfg: GraphConfig, seed_vectors: np.ndarray,
                 seed_ids: np.ndarray, *, obs=None, device=None):
        from ..obs import Obs
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = empty_graph(cfg, self.device)
        self._host_vec = np.zeros((cfg.max_nodes, cfg.dim), np.float32)
        self._host_nbrs = np.full((cfg.max_nodes, cfg.degree), -1,
                                  np.int32)
        self._id2node: dict = {}
        self._deletes_pending = 0
        # same stats schema as every other engine; graph-irrelevant keys
        # stay 0
        self.obs = obs if obs is not None else Obs()
        self.stats = self.obs.driver_stats()
        if len(seed_vectors):
            self.insert(seed_vectors, seed_ids)

    # -- helpers -----------------------------------------------------------

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _sync_device(self):
        """Copy the host graph's used rows to the device (rows past
        ``n_used`` are never written)."""
        n = int(self.state.n_used)
        self.state.vectors[:n] = self._dev(self._host_vec[:n])
        self.state.nbrs[:n] = self._dev(self._host_nbrs[:n])

    def _set_valid(self, nodes, value: bool) -> None:
        self.state.valid[self._dev(np.asarray(nodes, np.int64))] = value

    def insert(self, vecs: np.ndarray, ids: np.ndarray,
               _chunk: int = 128) -> UpdateResult:
        """Chunked internally: each sub-batch links against a graph that
        already contains its predecessors (sequential-insert fidelity)."""
        if len(vecs) > _chunk:
            t0 = time.perf_counter()
            n_acc = 0
            for off in range(0, len(vecs), _chunk):
                n_acc += self.insert(vecs[off:off + _chunk],
                                     ids[off:off + _chunk]).accepted
            return UpdateResult(accepted=n_acc,
                                seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        vecs = np.asarray(vecs, np.float32)
        ids = np.asarray(ids, np.int64)
        cfg = self.cfg
        # upsert semantics: re-inserting a live external id retires its
        # old node first, else the stale duplicate stays valid forever
        # (deletes only track the newest node per id)
        stale = [self._id2node[int(i)] for i in ids
                 if int(i) in self._id2node]
        if stale:
            self._set_valid(stale, False)
            self._deletes_pending += len(stale)
        n0 = int(self.state.n_used)
        n_new = len(vecs)
        # batched candidate search against the current graph
        if n0 > 0:
            cand, cd = beam_search(self.state, cfg, self._dev(vecs))
            cand = cand.to(torch.int32).cpu().numpy()
            cd = cd.cpu().numpy()
        else:
            cand = np.full((n_new, cfg.beam), -1, np.int32)
            cd = np.full((n_new, cfg.beam), BIG, np.float32)
        valid_np = self.state.valid.cpu().numpy()
        new_nodes = np.arange(n0, n0 + n_new)
        self._host_vec[new_nodes] = vecs
        back: dict = defaultdict(list)
        for j, node in enumerate(new_nodes):
            cj = cand[j]
            dj = np.where((cj >= 0) & valid_np[np.maximum(cj, 0)],
                          cd[j], BIG)
            chosen = robust_prune(vecs[j], cj, dj, self._host_vec,
                                  cfg.degree, cfg.alpha)
            self._host_nbrs[node, :len(chosen)] = chosen
            for c in chosen:
                back[c].append(node)
        # back-edges with prune-on-overflow
        for c, incoming in back.items():
            row = [x for x in self._host_nbrs[c] if x >= 0]
            row.extend(incoming)
            if len(row) > cfg.degree:
                dists = np.sum(
                    (self._host_vec[row] - self._host_vec[c]) ** 2, -1)
                chosen = robust_prune(
                    self._host_vec[c], np.array(row), dists,
                    self._host_vec, cfg.degree, cfg.alpha)
                row = chosen
            self._host_nbrs[c, :] = -1
            self._host_nbrs[c, :len(row)] = row[:cfg.degree]
        for j, node in enumerate(new_nodes):
            self._id2node[int(ids[j])] = int(node)
        nodes_t = self._dev(new_nodes)
        self.state.valid[nodes_t] = True
        self.state.ids[nodes_t] = self._dev(ids.astype(np.int32))
        self.state.n_used.fill_(n0 + n_new)
        self._sync_device()
        if n0 == 0:
            # entry point: medoid of the first batch
            med = int(np.argmin(np.sum(
                (vecs - vecs.mean(0)) ** 2, -1)))
            self.state.entry.fill_(med)
        dt = time.perf_counter() - t0
        self.stats["insert_time"] += dt
        self.stats["inserted"] += n_new
        return UpdateResult(accepted=n_new, seconds=dt)

    def delete(self, ids: np.ndarray) -> UpdateResult:
        t0 = time.perf_counter()
        nodes = [self._id2node[i] for i in np.asarray(ids, np.int64)
                 if int(i) in self._id2node]
        if nodes:
            self._set_valid(nodes, False)
            for i in np.asarray(ids, np.int64):
                self._id2node.pop(int(i), None)
        self._deletes_pending += len(nodes)
        if self._deletes_pending >= self.cfg.consolidate_every:
            self.consolidate()
        dt = time.perf_counter() - t0
        self.stats["delete_time"] += dt
        self.stats["deleted"] += len(nodes)
        return UpdateResult(deleted=len(nodes), seconds=dt)

    def consolidate(self):
        """FreshDiskANN's StreamingMerge analogue: splice tombstoned
        nodes out of neighbour lists (one-hop patch + prune)."""
        valid = self.state.valid.cpu().numpy()
        n = int(self.state.n_used)
        for u in range(n):
            if not valid[u]:
                continue
            row = self._host_nbrs[u]
            dead = [x for x in row if x >= 0 and not valid[x]]
            if not dead:
                continue
            keep = [x for x in row if x >= 0 and valid[x]]
            # adopt the dead neighbours' live neighbours
            for dnode in dead:
                keep.extend(x for x in self._host_nbrs[dnode]
                            if x >= 0 and valid[x])
            keep = list(dict.fromkeys(keep))[:4 * self.cfg.degree]
            if keep:
                dists = np.sum(
                    (self._host_vec[keep] - self._host_vec[u]) ** 2, -1)
                keep = robust_prune(self._host_vec[u], np.array(keep),
                                    dists, self._host_vec,
                                    self.cfg.degree, self.cfg.alpha)
            self._host_nbrs[u, :] = -1
            self._host_nbrs[u, :len(keep)] = keep
        self._deletes_pending = 0
        self._sync_device()

    def search(self, queries: np.ndarray, k: int) -> SearchResult:
        t0 = time.perf_counter()
        ids, d = _search_topk(self.state, self.cfg,
                              self._dev(np.asarray(queries, np.float32)), k)
        ids, d = ids.cpu().numpy(), d.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["search_time"] += dt
        self.stats["queries"] += len(queries)
        return SearchResult(ids=ids, scores=d, seconds=dt)

    def tick(self) -> TickReport:
        return TickReport()

    def flush(self, max_ticks: int = 0) -> int:
        self.consolidate()
        return 1

    # ---- StreamingIndex protocol surface ------------------------------

    def snapshot(self) -> GraphState:
        return self.state.clone()

    def memory_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in (
            getattr(self.state, f.name)
            for f in dataclasses.fields(GraphState))))

    def memory_tiers(self) -> dict:
        return {"device": self.memory_bytes(), "host": 0}

    def exact(self, queries: np.ndarray, k: int) -> SearchResult:
        """Exact top-k over the live (non-tombstoned) nodes, on the host,
        in query chunks (the same numpy calls per query row as one
        block)."""
        valid = self.state.valid.cpu().numpy()
        live = np.flatnonzero(valid)
        q = np.asarray(queries, np.float32)
        if live.size == 0:
            shape = (len(q), k)
            return SearchResult(ids=np.full(shape, -1, np.int32),
                                scores=np.full(shape, BIG, np.float32))
        vecs = self._host_vec[live]
        ids = self.state.ids.cpu().numpy()[live]
        chunk = max(1, EXACT_CHUNK_FLOATS // vecs.size)
        found, scores = [], []
        for off in range(0, len(q), chunk):
            d2 = ((q[off:off + chunk, None, :] - vecs[None]) ** 2).sum(-1)
            order = np.argsort(d2, axis=1)[:, :k]
            found.append(ids[order])
            scores.append(np.take_along_axis(d2, order, axis=1))
        found = np.concatenate(found)
        scores = np.concatenate(scores)
        if found.shape[1] < k:   # fewer live nodes than k
            padn = k - found.shape[1]
            found = np.pad(found, ((0, 0), (0, padn)), constant_values=-1)
            scores = np.pad(scores, ((0, 0), (0, padn)),
                            constant_values=BIG)
        return SearchResult(ids=found, scores=scores)

    def posting_lengths(self) -> np.ndarray:
        return np.empty((0,), np.int32)

    def live_count(self) -> int:
        return int(self.state.valid.sum())

    def throughput(self) -> dict:
        from .metrics import throughput_from_stats
        return throughput_from_stats(self.stats)
