"""Serving driver: streaming retrieval over fresh documents.

    python -m repro_torch.launch.serve [--full] [--docs N] [--seq L] ...

Counterpart of ``repro/launch/serve.py``, the paper's scenario: an
embedding model turns a stream of fresh documents into vectors, UBIS
indexes them online (insert, delete, split and merge concurrent with
search), and queries are answered from the same index.
``RetrievalServer`` is a thin client of ``repro_torch.serving``: every
ingest batch and every query goes through a ``ServingEngine``, and the
default ``tick_every=1`` runs one background tick per ingest batch.

Everything runs on the card unless ``ServeConfig.device`` (or the CLI's
``--device``) asks for the CPU; without CUDA the default raises.  The
backbone's attention runs the hand-written ``flash_attention`` kernel on
the card, and nothing on the card takes its plain version.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..api import SearchResult, make_index
from ..bridge import lm_state_from_numpy
from ..core import metrics as ubis_metrics
from ..core.driver import resolve_device
from ..core.types import UBISConfig
from ..models import get_model
from ..obs import Obs
from ..serving import ServingConfig, ServingEngine


@dataclasses.dataclass
class ServeConfig:
    arch: str = "tinyllama-1.1b"
    reduced: bool = True
    embed_dim: int = 64              # random projection of hidden states
    k: int = 10
    seed: int = 0
    # background-tick cadence: one index.tick() per N ingest batches
    # (0 = never)
    tick_every: int = 1
    # observability plane: sampled live-recall probe fraction, optional
    # torch.profiler capture directory
    recall_probe: float = 0.0
    obs_profile_dir: Optional[str] = None
    device: Optional[str] = None     # None: the card


class EmbeddingServer:
    """Embeds token sequences with the LM backbone: the final hidden
    states, mean-pooled over all positions, times a frozen random
    projection to ``embed_dim``.

    ``params`` (the JAX package's parameter tree as numpy arrays, see
    ``repro_torch.bridge.lm_state_from_numpy``) and ``proj`` ((d_model,
    embed_dim)) are injected where two implementations must compute the
    same thing; by default both are drawn from ``cfg.seed`` with
    ``torch.Generator``s on the device (the projection from seed + 1,
    N(0, 1 / d_model))."""

    def __init__(self, cfg: ServeConfig, *, params=None, proj=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = get_model(cfg.arch, reduced=cfg.reduced,
                               device=self.device, seed=cfg.seed)
        if params is not None:
            self.model.load_state_dict(lm_state_from_numpy(params,
                                                           self.model))
        d_model = self.model.cfg.d_model
        if proj is None:
            gen = torch.Generator(device=self.device).manual_seed(
                cfg.seed + 1)
            proj = torch.randn((d_model, cfg.embed_dim), generator=gen,
                               device=self.device) / (d_model ** 0.5)
        if not torch.is_tensor(proj):
            proj = torch.from_numpy(np.array(proj, np.float32))
        self.proj = proj.to(device=self.device, dtype=torch.float32)
        if tuple(self.proj.shape) != (d_model, cfg.embed_dim):
            raise ValueError(f"proj has shape {tuple(self.proj.shape)}, "
                             f"expected {(d_model, cfg.embed_dim)}")

    def embed(self, tokens) -> np.ndarray:
        """tokens (B, L) -> (B, embed_dim) fp32."""
        tokens = torch.as_tensor(np.asarray(tokens), device=self.device)
        with torch.inference_mode():
            x = self.model.hidden(tokens)
            return (x.mean(dim=1) @ self.proj).cpu().numpy()


class RetrievalServer:
    """Batched streaming retrieval endpoint over a ``make_index`` engine
    (``ubis`` or ``spfresh``).

    All traffic rides the serving engine's queue.  The default
    ``serving_cfg`` keeps the synchronous loop (each ingest batch
    flushes at once and ticks per ``ServeConfig.tick_every``); pass a
    ``ServingConfig`` with real deadlines for open-loop serving.  The
    index and the backbone live on ``cfg.device`` (default: the card).
    """

    def __init__(self, cfg: ServeConfig,
                 index_cfg: Optional[UBISConfig] = None,
                 seed_vectors: Optional[np.ndarray] = None,
                 engine: str = "ubis",
                 serving_cfg: Optional[ServingConfig] = None,
                 **engine_kw):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self._embedder: Optional[EmbeddingServer] = None
        if index_cfg is None:
            index_cfg = UBISConfig(dim=cfg.embed_dim, max_postings=2048,
                                   capacity=96, max_ids=1 << 20)
        if seed_vectors is None:
            seed_vectors = np.random.default_rng(cfg.seed).normal(
                size=(1024, index_cfg.dim)).astype(np.float32)
        # one plane covers the driver's internals AND the request spans
        self.obs = engine_kw.pop("obs", None) or Obs()
        self.index = make_index(engine, index_cfg, seed_vectors,
                                obs=self.obs, device=self.device,
                                **engine_kw)
        if serving_cfg is None:
            serving_cfg = ServingConfig(default_k=cfg.k,
                                        tick_every=cfg.tick_every,
                                        recall_probe=cfg.recall_probe,
                                        obs_profile_dir=cfg.obs_profile_dir)
        self.engine = ServingEngine(self.index, serving_cfg, obs=self.obs)
        self._next_id = 0
        self.stats = {"ingested": 0, "queries": 0}

    @property
    def embedder(self) -> EmbeddingServer:
        """The backbone, built at first use: vector-only serving never
        pays for it."""
        if self._embedder is None:
            self._embedder = EmbeddingServer(self.cfg)
        return self._embedder

    # -- streaming ingestion ------------------------------------------------

    def ingest_tokens(self, token_batch: np.ndarray) -> np.ndarray:
        """Embed + insert a batch of fresh documents; returns their ids."""
        return self.ingest_vectors(self.embedder.embed(token_batch))

    def ingest_vectors(self, vecs: np.ndarray) -> np.ndarray:
        """Enqueue + flush one ingest batch (ticks follow the engine's
        ``tick_every`` cadence)."""
        ids = np.arange(self._next_id, self._next_id + len(vecs))
        self._next_id += len(vecs)
        self.engine.submit_insert(vecs, ids)
        self.engine.drain()
        self.stats["ingested"] += len(vecs)
        return ids

    def delete(self, ids: np.ndarray):
        self.engine.submit_delete(ids)
        self.engine.drain()

    # -- queries -------------------------------------------------------------

    def query_tokens(self, token_batch: np.ndarray,
                     k: Optional[int] = None) -> SearchResult:
        return self.query_vectors(self.embedder.embed(token_batch), k)

    def query_vectors(self, vecs: np.ndarray,
                      k: Optional[int] = None) -> SearchResult:
        """Queue + resolve a query batch, one request per row."""
        k = k or self.cfg.k
        tickets = [self.engine.submit_search(v, k) for v in
                   np.atleast_2d(np.asarray(vecs, np.float32))]
        self.engine.drain()
        rows = [t.result() for t in tickets]
        self.stats["queries"] += len(rows)
        return SearchResult(ids=np.concatenate([r.ids for r in rows]),
                            scores=np.concatenate([r.scores for r in rows]))

    def recall_check(self, vecs: np.ndarray, k: int = 10) -> float:
        found = self.index.search(vecs, k).ids
        true = self.index.exact(vecs, k).ids
        return ubis_metrics.recall_at_k(found, np.asarray(true))

    # -- observability -------------------------------------------------------

    def metrics_text(self) -> str:
        """Prometheus text exposition of the whole plane (driver stats,
        request-span histograms, live-recall gauge)."""
        return self.obs.to_prometheus()

    def metrics_snapshot(self) -> dict:
        """JSON-ready flat snapshot of every registered series."""
        return self.obs.snapshot()

    def trace_events(self, kind: Optional[str] = None):
        """Structured trace events (the newest ``TRACE_CAPACITY``)."""
        return self.obs.events(kind)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="the catalogue's full width (default: reduced)")
    ap.add_argument("--engine", default="ubis", help="ubis or spfresh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--tick-every", type=int, default=1,
                    help="background tick per N ingest batches (0=never)")
    ap.add_argument("--recall-probe", type=float, default=0.0,
                    help="shadow-execute this fraction of served query "
                         "batches against exact() (live recall gauge)")
    ap.add_argument("--obs-profile-dir", default=None,
                    help="capture a torch.profiler trace of the first "
                         "working pump of the serving queue here")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus exposition at exit")
    args = ap.parse_args(argv)

    cfg = ServeConfig(arch=args.arch, reduced=not args.full,
                      tick_every=args.tick_every,
                      recall_probe=args.recall_probe,
                      obs_profile_dir=args.obs_profile_dir,
                      device=args.device)
    server = RetrievalServer(cfg, engine=args.engine)
    rng = np.random.default_rng(0)
    vocab = server.embedder.model.cfg.vocab
    t0 = time.perf_counter()
    for off in range(0, args.docs, args.batch):
        n = min(args.batch, args.docs - off)
        toks = rng.integers(0, vocab, (n, args.seq)).astype(np.int32)
        server.ingest_tokens(toks)
    server.index.flush()
    t_ing = time.perf_counter() - t0
    qt = rng.integers(0, vocab, (args.queries, args.seq)).astype(np.int32)
    t0 = time.perf_counter()
    res = server.query_tokens(qt)
    t_q = time.perf_counter() - t0
    rec = server.recall_check(server.embedder.embed(qt))
    n_docs = server.stats["ingested"]
    print(f"ingested {n_docs} docs in {t_ing:.1f}s ({n_docs / t_ing:.0f} "
          f"docs/s, {n_docs * args.seq / t_ing:.0f} tokens/s); "
          f"{res.ids.shape[0]} queries in {t_q:.2f}s; recall@10 {rec:.3f} "
          f"(device {server.device})")
    if args.metrics:
        print(server.metrics_text())
    return 0


if __name__ == "__main__":
    sys.exit(main())
