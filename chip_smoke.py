#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # the full run, one card

Phases, in order (any failure exits non-zero before the last line):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the parallel ``nvcc`` build of every kernel source.
2. Each of the eight kernels against its plain PyTorch version on the
   card: at the main paths' shapes on integer-valued data (exact
   arithmetic in any summation order, so ids and scores must match
   exactly), with the block-wide top-k past k = 32 (k = 64, 192), and at
   the edge shapes of the CPU tests (d=100 with odd C, m=10, ksub=100,
   all masked, integer ties, spilled postings and empty ADC slots);
   ``flash_attention`` at tests/test_kernels.py's 12 shapes and at the
   serving path's (B=64, Hq=32, Hkv=4, L=512, D=64, causal), within 2e-4
   abs and rel (softmax is not exact on real data).
3. Two main paths at SIFT1M's shape through ``make_index``, each with
   the launch counts reset just before it and read just after it.
   (a) the float plane; (b) the quant plane (``use_pq=True``, PQ16:
   m=16, ksub=256, two codebook versions, rerank_k=192, a codebook
   re-train every 32 ticks).  Each loads 1,000,000 clustered 128-d
   vectors made from ``--seed`` with numpy through insert rounds (with
   background ticks), then runs 5 streaming steps of 20k drifted
   inserts, 10k deletes of the oldest ids, ``tick()``, a 256-query
   search at k=10 and the exact oracle on the same queries.  Checks:
   recall@10 >= 0.9 at every step, ``live_count()`` equals inserted -
   deleted, the id_loc <-> slots invariants (and on the quant path the
   codes <-> floats invariant and at least one re-train), and every
   kernel of the path launched.  Then recall@10 on harder queries,
   reported and not gated, and the two paths' recalls side by side.
   (c) the quant path once more on the float path's data, one streaming
   step, its recall reported and not gated (see ``QUANT_DATA``).
   (d) the serving path: ``RetrievalServer`` over the full-width
   tinyllama-1.1b backbone (22 layers, d_model 2048, 32/4 heads, weights
   drawn from ``--seed``) and the default ``ubis`` index (64-d
   embeddings, one tick per ingest batch) ingests 2,048 documents of 512
   uniform random tokens in 32 batches of 64, flushes, answers 256
   queries of 64 tokens through the serving queue and runs the recall
   check.  Gates: recall@10 >= 0.9, ``live_count()`` = 2,048, the last
   batch's first 8 documents find themselves at k=3, every kernel of the
   path launched, one embedded batch with the kernel within 1e-4 of the
   same model with the plain attention (fp32 summation order through 22
   layers), and the Prometheus exposition parses and holds the request
   latency histogram.
4. Each kernel timed (CUDA events, median of 20 runs after warm-up) on
   its path's own inputs, beside its plain version, its bound and, where
   one PyTorch call computes the same product, that call (``addmm`` /
   ``baddbmm``; for ``flash_attention`` at the serving path's shape the
   faster of two ``scaled_dot_product_attention`` calls, one with
   ``enable_gqa`` and one on expanded k and v, each with the backend it
   ran) as a library yardstick; the kernel is
   also held against its plain version there.  The block-wide top-k is
   timed at k = 64 and 192 too.  Then a load chunk and a streaming step
   of the float path, a streaming step of the quant path and one
   embedded batch of the serving path run under ``torch.profiler``:
   their wall time, device time by kernel and device busy share.
5. The card's name and power limit, the kernel line ``{"kernels":
   [...]}``, then as the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
TOL = 1e-4           # relative to the score scale: fp32 summation order
ATTN_TOL = 2e-4      # abs and rel: tests/test_kernels.py:127
#: the kernels each main path must launch
PATH_KERNELS = {
    "float": ("centroid_score", "centroid_topk", "posting_scan",
              "posting_scan_topk"),
    "quant": ("centroid_score", "centroid_topk", "posting_scan",
              "pq_scan_topk", "rerank_topk", "kmeans_assign"),
    "serve": ("flash_attention", "centroid_score", "centroid_topk",
              "posting_scan", "posting_scan_topk"),
}
#: the serving path's attention shape: (B, Hq, Hkv, L, D), causal
SERVE_ATTN = (64, 32, 4, 512, 64)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def score_scale(s) -> float:
    real = s[s < 1e29]
    return max(1.0, float(real.abs().max())) if real.numel() else 1.0


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def require_exact(name, got, want) -> None:
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            bad = (g != w).sum().item() if g.shape == w.shape else "shape"
            fail(f"{name}: kernel differs from plain version ({bad} "
                 f"entries) where the arithmetic is exact")


def require_close(name, got, want) -> float:
    err = max_err(got, want)
    tol = TOL * score_scale(want)
    if err > tol:
        fail(f"{name}: max |kernel - plain| = {err:.3g} > {tol:.3g}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_assign(name, got, want, scores) -> None:
    """kmeans_assign on real-valued data: the best scores within the
    tolerance, and where the picks differ, the kernel's pick scores
    (by the plain version's arithmetic) within the tolerance of the best:
    a near-tie that the two summation orders round apart."""
    require_close(name, got[1], want[1])
    diff = (got[0] != want[0]) & (want[0] >= 0)
    if bool(diff.any()):
        pick = torch.gather(scores, -1, got[0].clamp(min=0).long()[..., None])
        require_close(name + " near-tie picks", pick[..., 0][diff],
                      want[1][diff])


def kernel_checks(ops, ref, dev, seed: int) -> None:
    g = np.random.default_rng(seed)

    def ints(shape, lo=-3, hi=4):
        return torch.as_tensor(g.integers(lo, hi, shape).astype(np.float32),
                               device=dev)

    def normal(shape):
        return torch.as_tensor(g.standard_normal(shape, np.float32),
                               device=dev)

    def mask(shape, p=0.7):
        return torch.as_tensor(g.random(shape) < p, device=dev)

    def index(hi, shape, dtype=np.int32):
        return torch.as_tensor(g.integers(0, hi, shape).astype(dtype),
                               device=dev)

    def run(label, x):
        exact = label.startswith("int")

        def check(n, a, b):
            if exact:
                require_exact(n, a, b)
            else:
                require_close(n, a[0], b[0])
                require_exact(n + " ids", a[1:], b[1:])

        q, c, vis, tiles, valid = x["q"], x["c"], x["vis"], x["tiles"], x["valid"]
        probe, qp_ok, pvis = x["probe"], x["qp_ok"], x["pvis"]
        out = ops.centroid_score(q, c, vis)
        check(f"centroid_score[{label}]", (out,), (ref.centroid_score(q, c, vis),))
        for k in x["k_c"]:
            out = ops.centroid_topk(q, c, vis, k=k)
            check(f"centroid_topk k={k}[{label}]", out,
                  ref.centroid_topk(q, c, vis, k))
        out = ops.posting_scan(q, tiles, valid)
        check(f"posting_scan[{label}]", (out,), (ref.posting_scan(q, tiles, valid),))
        pvalid = valid & pvis[:, None]
        for k in x["k_p"]:
            out = ops.posting_scan_topk(q, tiles, valid, pvis, probe, k=k,
                                        qp_ok=qp_ok)
            check(f"posting_scan_topk k={k}[{label}]", out,
                  ref.posting_scan_topk(q, tiles, pvalid, qp_ok, probe, k))
        # the quant plane: same summation order as the plain version, so
        # the ADC scan is exact on real-valued tables too
        luts, codes, slot, R = x["luts"], x["codes"], x["slot"], x["R"]
        adc, cand = ops.pq_scan_topk(luts, codes, slot, valid, pvis, probe,
                                     k=R, qp_ok=qp_ok)
        require_exact(f"pq_scan_topk R={R}[{label}]", (adc, cand),
                      ref.pq_scan_topk(luts, codes, slot, pvalid, qp_ok,
                                       probe, R))
        adc = torch.where(x["empty"], x["empty_val"], adc)
        out = ops.rerank_topk(q, tiles, x["spilled"], cand, adc, k=x["k_r"])
        check(f"rerank_topk[{label}]", out,
              ref.rerank_topk(q, tiles, x["spilled"], cand, adc, x["k_r"]))
        pts, cents, kmask = x["pts"], x["cents"], x["kmask"]
        out = ops.kmeans_assign(pts, cents, kmask)
        want = ref.kmeans_assign(pts, cents, kmask)
        if exact:
            require_exact(f"kmeans_assign[{label}]", out, want)
        else:
            cf = cents.float()
            full = ((cf * cf).sum(-1)[:, None, :]
                    - 2.0 * torch.bmm(pts.float(), cf.transpose(1, 2)))
            check_assign(f"kmeans_assign[{label}]", out, want, full)
        torch.cuda.synchronize()
        say(f"  kernels vs plain [{label}]: ok")

    def case(Q, M, d, G, C, P, k_c, k_p, gen, *, m, ksub, R, k_r, N,
             p_vis=0.7, p_spill=0.0, p_empty=0.0):
        tiles = gen((G, C, d))
        empty = torch.as_tensor(g.random((Q, R)) < p_empty, device=dev)
        big_or_inf = torch.where(
            torch.as_tensor(g.random((Q, R)) < 0.5, device=dev),
            torch.tensor(1e30, device=dev), torch.tensor(float("inf"),
                                                         device=dev))
        dsub = d // m
        return dict(
            q=gen((Q, d)), c=gen((M, d)), vis=mask((M,), p_vis), tiles=tiles,
            valid=mask((G, C), p_vis), pvis=mask((G,), max(p_vis, 0.9)
                                                 if p_vis else 0.0),
            probe=index(G, (Q, P)),
            qp_ok=torch.as_tensor((g.random((Q, P)) < 0.9).astype(np.int32),
                                  device=dev),
            k_c=k_c, k_p=k_p, luts=gen((Q, 2, m, ksub)),
            codes=index(ksub, (G, m, C), np.uint8), slot=index(2, (G,)), R=R,
            k_r=k_r, spilled=mask((G,), p_spill), empty=empty,
            empty_val=big_or_inf,
            # kmeans_assign as the PQ fit calls it: the (N, d) sample seen
            # as m subspaces (a strided view), m codebooks of ksub
            pts=gen((N, d)).view(N, m, dsub).transpose(0, 1),
            cents=gen((m, ksub, dsub)), kmask=mask((N,), max(p_vis, 0.5)))

    # main-path shapes: insert locate / phase 1 / exact chunk / phase 2 on
    # the float path; ADC scan at R=192, rerank, the PQ16 codebook fit on
    # the quant path
    run("int main-path shapes",
        case(256, 65504, 128, 65504, 96, 32, (32, 64, 192), (10, 192), ints,
             m=16, ksub=256, R=192, k_r=10, N=20000))
    run("int d=100 odd C m=10 ksub=100 spilled",
        case(19, 333, 100, 9, 33, 3, (7, 64), (7, 64), ints, m=10, ksub=100,
             R=64, k_r=7, N=257, p_spill=0.3, p_empty=0.2))
    run("int ties", case(70, 500, 16, 40, 24, 6, (32, 64), (32, 64),
                         lambda s: ints(s, -1, 2), m=4, ksub=16, R=64,
                         k_r=32, N=300))
    run("int all masked", case(9, 100, 16, 8, 24, 4, (5, 64), (9, 48), ints,
                               m=4, ksub=16, R=48, k_r=9, N=64, p_vis=0.0,
                               p_empty=1.0))
    run("float d=100 odd C m=10 ksub=100",
        case(19, 333, 100, 9, 33, 3, (7, 64), (7, 64), normal, m=10,
             ksub=100, R=64, k_r=7, N=257, p_spill=0.3, p_empty=0.2))
    run("float Q=1 k=32/192",
        case(1, 1000, 128, 50, 96, 32, (32, 192), (32, 192), normal, m=16,
             ksub=256, R=192, k_r=10, N=2048))


def require_attn_close(name, got, want) -> float:
    """|kernel - plain| <= ATTN_TOL * (1 + |plain|) everywhere: every row
    of these shapes has at least one valid key (a row with none has no
    right answer, see ``ref.flash_attention``)."""
    err = (got.double() - want.double()).abs()
    if not bool((err <= ATTN_TOL * (1 + want.double().abs())).all()):
        fail(f"{name}: max |kernel - plain| = {float(err.max()):.3g} "
             f"beyond {ATTN_TOL} abs + rel")
    return float(err.max())


def attention_checks(ops, ref, dev, seed: int) -> None:
    """``flash_attention`` against its plain version at the 12 shapes of
    tests/test_kernels.py:114-117 (ragged tiles, Lq != Lk end alignment,
    GQA 2:1 and 8:1, D = 16/32/64) and at the serving path's shape."""
    g = np.random.default_rng(seed + 1)

    def normal(shape):
        return torch.as_tensor(g.standard_normal(shape, np.float32),
                               device=dev)

    n = 0
    for Lq, Lk, D, Hq, Hkv in ((37, 53, 16, 4, 2), (64, 64, 32, 2, 2),
                               (16, 128, 64, 8, 1)):
        for causal in (True, False):
            for window in (None, 9):
                q, k, v = (normal((2, Hq, Lq, D)), normal((2, Hkv, Lk, D)),
                           normal((2, Hkv, Lk, D)))
                require_attn_close(
                    f"flash_attention {Lq}x{Lk} D={D} {Hq}/{Hkv} "
                    f"causal={causal} window={window}",
                    ops.flash_attention(q, k, v, causal=causal,
                                        window=window),
                    ref.flash_attention(q, k, v, causal=causal,
                                        window=window))
                n += 1
    B, Hq, Hkv, L, D = SERVE_ATTN
    q, k, v = (normal((B, Hq, L, D)), normal((B, Hkv, L, D)),
               normal((B, Hkv, L, D)))
    err = require_attn_close("flash_attention at the serving path's shape",
                             ops.flash_attention(q, k, v),
                             ref.flash_attention(q, k, v))
    torch.cuda.synchronize()
    say(f"  flash_attention vs plain at {n} test shapes and the serving "
        f"shape {SERVE_ATTN}: ok (max abs err there {err:.3g}, tolerance "
        f"{ATTN_TOL} abs + rel)")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

class Stream:
    """Clustered vectors whose cluster centres drift between steps.

    The centres are N(0, scale^2 I).  ``tau=None``: each vector is its
    centre plus isotropic N(0, I) noise.  Else the spread around a centre
    has a decaying spectrum, like real descriptor data: its standard
    deviation along the i-th axis of a random rotation is proportional
    to exp(-i / tau) (the total variance stays ``dim``), so most of it
    lies in a few dozen directions."""

    def __init__(self, dim: int, n_clusters: int, seed: int, tau=None,
                 scale: float = 3.0):
        self.rng = np.random.default_rng(seed)
        self.centers = (self.rng.standard_normal((n_clusters, dim),
                                                 np.float32) * scale)
        self.basis = None
        if tau is not None:
            rot = np.linalg.qr(self.rng.standard_normal((dim, dim)))[0]
            sd = np.exp(-np.arange(dim) / tau)
            sd *= np.sqrt(dim / (sd * sd).sum())
            self.basis = (sd[:, None] * rot).astype(np.float32)

    def noise(self, n: int) -> np.ndarray:
        x = self.rng.standard_normal((n, self.centers.shape[1]), np.float32)
        return x if self.basis is None else x @ self.basis

    def draw(self, n: int) -> np.ndarray:
        a = self.rng.integers(0, len(self.centers), n)
        x = self.noise(n)
        x += self.centers[a]
        return x

    def drift(self, step: float) -> None:
        self.centers += (self.rng.standard_normal(self.centers.shape,
                                                  np.float32) * step)


#: The quant path's data: overlapping clusters (centres N(0, 1.5^2 I))
#: with a decaying spread spectrum (tau=16).  On the float path's data
#: (well separated centres, N(0, 9 I), isotropic N(0, I) spread) PQ16 over
#: raw vectors spends its 256 centroids per subspace on the centres and
#: cannot rank a cluster's members (phase 3c reports that recall; the
#: JAX package, with the same algorithm, behaves the same way: see
#: PERF.md, the quant path).
QUANT_DATA = dict(scale=1.5, tau=16)


def quant_config(dim: int) -> dict:
    """The quant path's plane: PQ16 at dim 128 (m = dim // 8, the first
    variant of ``benchmarks/figures.py``'s figpq sweep), 256 centroids
    per subspace, two codebook versions, rerank_k=192 (figures.py:141)."""
    return dict(use_pq=True, pq_m=dim // 8, pq_ksub=256, pq_versions=2,
                pq_sample=2048, rerank_k=192)


def main_path(dev, *, n: int, dim: int, max_postings: int,
              cache_capacity: int, steps: int, fresh: int, dels: int,
              queries: int, chunk: int, seed: int, round_size: int,
              bg_ops: int, quant: bool = False, pq_retrain_every: int = 32,
              data=None, gate: bool = True, log=say):
    """Drive ``make_index("ubis", ...)`` through load + streaming steps,
    on the float plane or (``quant``) the quant plane; ``data``: keyword
    arguments of ``Stream``; ``gate=False`` reports recall@10 without
    failing below 0.9.  Returns (driver, last queries, per-phase seconds,
    recalls, stream)."""
    from repro_torch.api import make_index
    from repro_torch.core import metrics
    from repro_torch.core.invariants import check_invariants
    from repro_torch.core.types import UBISConfig

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = UBISConfig(dim=dim, max_postings=max_postings, capacity=96,
                     l_min=10, l_max=80, balance_factor=0.15, nprobe=32,
                     cache_capacity=cache_capacity, max_ids=1 << 21,
                     **(quant_config(dim) if quant else {}))
    secs = {}
    t = time.perf_counter()
    stream = Stream(dim, max(8, n // 500), seed, **(data or {}))
    base = stream.draw(n)
    secs["data"] = time.perf_counter() - t

    t = time.perf_counter()
    drv = make_index("ubis", cfg, base, device=dev, seed=seed,
                     round_size=round_size, bg_ops_per_round=bg_ops,
                     drain_per_tick=round_size,
                     pq_retrain_every=pq_retrain_every)
    sync()
    secs["build"] = time.perf_counter() - t

    t = time.perf_counter()
    ticks = 0
    for off in range(0, n, chunk):
        drv.insert(base[off:off + chunk], np.arange(off, min(n, off + chunk)))
        for _ in range(64):
            ticks += 1
            r = drv.tick()
            if r.executed == 0 and r.marked == 0:
                break
    sync()
    secs["load"] = time.perf_counter() - t
    log(f"  loaded {n} vectors: {secs['load']:.1f} s, {ticks} ticks, "
        f"rejected {drv.stats['rejected']:.0f}, live postings "
        f"{len(drv.posting_lengths())}")

    next_id, oldest = n, 0
    recalls = []
    secs.update(insert=0.0, delete=0.0, tick=0.0, search=0.0, exact=0.0)
    for step in range(steps):
        stream.drift(0.05)
        t = time.perf_counter()
        drv.insert(stream.draw(fresh), np.arange(next_id, next_id + fresh))
        next_id += fresh
        sync()
        secs["insert"] += time.perf_counter() - t
        t = time.perf_counter()
        drv.delete(np.arange(oldest, oldest + dels))
        oldest += dels
        sync()
        secs["delete"] += time.perf_counter() - t
        t = time.perf_counter()
        drv.tick()
        sync()
        secs["tick"] += time.perf_counter() - t
        q = stream.draw(queries)
        t = time.perf_counter()
        found = drv.search(q, 10).ids
        secs["search"] += time.perf_counter() - t
        t = time.perf_counter()
        truth = drv.exact(q, 10).ids
        secs["exact"] += time.perf_counter() - t
        rec = metrics.recall_at_k(found, truth)
        recalls.append(rec)
        log(f"  step {step}: recall@10 {rec:.4f} "
            + (f"(gate >= 0.9, margin {rec - 0.9:+.4f})" if gate
               else "(not gated)"))
        if gate and not rec >= 0.9:
            fail(f"recall@10 {rec:.4f} < 0.9 at step {step}")
    if found.shape != (queries, 10) or not np.isfinite(
            drv.exact(q[:4], 10).scores).all():
        fail("search/exact returned the wrong shape or non-finite scores")
    live = drv.live_count()
    want = int(drv.stats["inserted"] - drv.stats["deleted"])
    if live != want:
        fail(f"live_count {live} != inserted - deleted {want}")
    check_invariants(drv.state, cfg)       # with use_pq: codes == encode
    if quant and drv.stats["pq_retrains"] < 1:
        fail("the quant path never re-trained its codebooks")
    return drv, q, secs, recalls, stream


def hard_recall(drv, stream, queries: int,
                alphas=(1.0, 0.5, 0.25, 0.0)) -> dict:
    """recall@10 of ``search`` against ``exact`` on queries
    ``alpha * centre + N(0, I)``: at alpha=1 a query sits in its cluster;
    toward 0 it sits between many clusters, and its neighbours spread
    over more postings than ``nprobe`` covers."""
    from repro_torch.core import metrics
    out = {}
    for alpha in alphas:
        pick = stream.rng.integers(0, len(stream.centers), queries)
        q = alpha * stream.centers[pick] + stream.noise(queries)
        out[alpha] = metrics.recall_at_k(drv.search(q, 10).ids,
                                         drv.exact(q, 10).ids)
    return out


def float_plane_recall(drv, q) -> float:
    """recall@10 of the float plane's search (``posting_scan_topk``) on a
    quant driver's state: the same index, searched without the codes."""
    import dataclasses

    from repro_torch.core import metrics
    from repro_torch.core.search import search
    cfg = dataclasses.replace(drv.cfg, use_pq=False)
    found, _, _ = search(drv.state, cfg,
                         torch.as_tensor(q, device=drv.device), 10)
    return metrics.recall_at_k(found.cpu().numpy(), drv.exact(q, 10).ids)


def plain_attention(ref):
    """``ops.flash_attention`` with the kernel's plain version in its
    place: the comparison run of the serving path's backbone."""
    def fn(q, k, v, *, causal=True, window=None, scale=None):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return fn


def serve_path(dev, ops, ref, *, seed: int, reduced: bool = False,
               docs: int = 2048, seq: int = 512, batch: int = 64,
               queries: int = 256, qseq: int = 64, log=say):
    """Drive ``RetrievalServer`` (tinyllama-1.1b, full width unless
    ``reduced``) through ingest -> flush -> query -> recall check ->
    freshness probe, with the launch counts reset before and read after.
    Returns (server, counts, the last ingested token batch, secs)."""
    from repro_torch.launch.serve import RetrievalServer, ServeConfig
    from repro_torch.obs import parse_exposition

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    secs = {}
    t = time.perf_counter()
    server = RetrievalServer(ServeConfig(
        arch="tinyllama-1.1b", reduced=reduced, embed_dim=64, k=10,
        tick_every=1, seed=seed, device=str(dev)))
    emb = server.embedder
    sync()
    secs["build"] = time.perf_counter() - t
    mcfg = emb.model.cfg
    n_params = sum(p.numel() for p in emb.model.parameters())
    log(f"  backbone {mcfg.name}: {mcfg.n_layers} layers, d_model "
        f"{mcfg.d_model}, {mcfg.n_heads}/{mcfg.n_kv} heads x {mcfg.hd}, "
        f"d_ff {mcfg.d_ff}, vocab {mcfg.vocab}: {n_params / 1e9:.3f} B "
        f"parameters drawn in {secs['build']:.1f} s")
    rng = np.random.default_rng(seed)

    ops.reset_launch_counts()
    t = time.perf_counter()
    for _ in range(docs // batch):
        toks = rng.integers(0, mcfg.vocab, (batch, seq)).astype(np.int32)
        ids = server.ingest_tokens(toks)
    sync()
    secs["ingest"] = time.perf_counter() - t
    t = time.perf_counter()
    flush_ticks = server.index.flush()
    sync()
    secs["flush"] = time.perf_counter() - t
    qt = rng.integers(0, mcfg.vocab, (queries, qseq)).astype(np.int32)
    t = time.perf_counter()
    res = server.query_tokens(qt)
    secs["query"] = time.perf_counter() - t
    t = time.perf_counter()
    rec = server.recall_check(server.embedder.embed(qt), k=10)
    secs["recall_check"] = time.perf_counter() - t
    found = server.query_vectors(server.embedder.embed(toks[:8]), k=3).ids
    counts = ops.launch_counts()

    n = server.stats["ingested"]
    lat = server.obs.histogram("serve_latency_seconds")
    log(f"  ingested {n} docs x {seq} tokens in {secs['ingest']:.2f} s: "
        f"{n / secs['ingest']:.1f} docs/s, {n * seq / secs['ingest']:.0f} "
        f"tokens/s (embed + insert + a tick per batch); flush "
        f"{flush_ticks} ticks {secs['flush']:.2f} s; {queries} queries x "
        f"{qseq} tokens in {secs['query']:.3f} s (embed + queue); serving "
        f"latency of the search requests p50 {lat.quantile(0.5) * 1e3:.3f} "
        f"ms, p99 {lat.quantile(0.99) * 1e3:.3f} ms over {lat.count}")
    log(f"  seconds per phase: {json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    log(f"  launches on the serve path: {json.dumps(counts)}")
    log(f"  index stats: live postings {len(server.index.posting_lengths())}, "
        + json.dumps({k: server.index.stats[k] for k in (
            "inserted", "bg_split", "bg_merge", "bg_compact", "drained")}))
    log(f"  recall@10 {rec:.4f} (gate >= 0.9, margin {rec - 0.9:+.4f})")
    if not rec >= 0.9:
        fail(f"serve path: recall@10 {rec:.4f} < 0.9")
    if res.ids.shape != (queries, 10) or not np.isfinite(res.scores).all():
        fail("serve path: query_tokens returned the wrong shape or "
             "non-finite scores")
    live = server.index.live_count()
    if live != docs:
        fail(f"serve path: live_count {live} != {docs} ingested")
    fresh = sum(int(ids[i]) in set(f.tolist()) for i, f in enumerate(found))
    log(f"  freshness: {fresh}/8 of the last batch find themselves at k=3")
    if fresh != 8:
        fail(f"serve path: only {fresh}/8 fresh documents found at k=3")
    for name in PATH_KERNELS["serve"]:
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the serve path")

    # one embedded batch, kernel against plain attention on the same card
    got = emb.embed(toks)
    with mock.patch.object(ops, "flash_attention", plain_attention(ref)):
        want = emb.embed(toks)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    log(f"  embedding with the kernel vs plain attention: max abs err "
        f"{err:.3g} = {err / scale:.3g} of the scale {scale:.3g} (gate "
        f"1e-4: fp32 summation order through {mcfg.n_layers} layers)")
    if not err <= 1e-4 * scale:
        fail(f"serve path: kernel embedding off by {err / scale:.3g} of "
             "its scale")
    if not np.isfinite(got).all():
        fail("serve path: non-finite embeddings")
    del got, want
    text = server.metrics_text()
    series = parse_exposition(text)
    if series.get("serve_latency_seconds_count", 0) <= 0:
        fail("serve path: the exposition holds no serve_latency_seconds")
    log(f"  metrics_text: {len(series)} series parse, "
        f"serve_latency_seconds_count {series['serve_latency_seconds_count']:g}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return server, counts, toks, secs


# ---------------------------------------------------------------------------
# phase 4: timing on the main path's inputs
# ---------------------------------------------------------------------------

def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_row(ops, counts, name, fn, plain, library, compare, ops_n,
              bytes_n) -> dict:
    """One entry of the kernel line: the kernel held against its plain
    version on these inputs, then both (and the library call) timed."""
    err = compare(fn(), plain())
    b_ms, b_by = bound(ops_n, bytes_n)
    _, _, source, replaces = ops.KERNELS[name]
    row = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=counts[name], max_abs_err=err,
        ms=median_ms(fn), plain_ms=median_ms(plain),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=(median_ms(library) if library else None))
    torch.cuda.synchronize()
    return row


def time_kernels(ops, ref, drv, q_np, counts) -> list:
    from repro_torch.core import version_manager as vm
    from repro_torch.core.types import STATUS_DELETED
    st, dev = drv.state, drv.device
    M, C, d = st.vectors.shape
    q = torch.as_tensor(q_np, device=dev)
    vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
    insertable = st.allocated & (vm.unpack_status(st.rec_meta)
                                 != STATUS_DELETED)
    locate = torch.as_tensor(
        np.resize(q_np, (drv.round_size, d)), device=dev)     # one round
    cen = st.centroids
    cn = (cen * cen).sum(-1)
    valid = st.slot_valid & vis[:, None]
    flat = st.vectors.view(M * C, d)
    vn = (flat * flat).sum(-1)
    qx = q[:32]                                               # exact chunk
    _, probe = ops.centroid_topk(q, cen, vis, k=drv.cfg.nprobe)
    qp_ok = torch.ones(probe.shape, dtype=torch.int32, device=dev)
    P = probe.shape[1]
    rows = []

    def row(*args):
        rows.append(timed_row(ops, counts, *args))

    def close(a, b):
        return require_close("main-path inputs", a, b)

    def close_topk(score_of):
        def cmp(a, b):
            err = require_close("main-path inputs", a[0], b[0])
            # the kernel's picks, rescored by the plain version
            require_close("main-path picks", a[0], score_of(a[1]))
            if (a[1].sort(-1).values.diff(dim=-1) == 0).any():
                fail("top-k kernel returned a duplicate id")
            return err
        return cmp

    J = locate.shape[0]
    row("centroid_score",
        lambda: ops.centroid_score(locate, cen, insertable),
        lambda: ref.centroid_score(locate, cen, insertable),
        lambda: torch.addmm(cn[None], locate, cen.T, alpha=-2), close,
        2.0 * J * M * d + 2.0 * M * d, 4.0 * (J * d + M * d + J * M) + M)
    k_c = drv.cfg.nprobe
    full_c = ref.centroid_score(q, cen, vis)
    row("centroid_topk",
        lambda: ops.centroid_topk(q, cen, vis, k=k_c),
        lambda: ref.centroid_topk(q, cen, vis, k_c), None,
        close_topk(lambda i: torch.gather(full_c, 1, i.long())),
        2.0 * len(q) * M * d + 2.0 * M * d,
        4.0 * (len(q) * d + M * d) + M + 8.0 * len(q) * k_c)
    del full_c
    N = M * C
    row("posting_scan",
        lambda: ops.posting_scan(qx, st.vectors, valid),
        lambda: ref.posting_scan(qx, st.vectors, valid),
        lambda: torch.addmm(vn[None], qx, flat.T, alpha=-2), close,
        2.0 * len(qx) * N * d + 2.0 * N * d,
        4.0 * (len(qx) * d + N * d + len(qx) * N) + N)

    def rescore(cand):
        v = flat[cand.long()]
        s = (v * v).sum(-1) - 2 * torch.einsum("qd,qkd->qk", q, v)
        return torch.where(valid.view(-1)[cand.long()], s, 1e30)

    U = int(torch.unique(probe).numel())
    Q = len(q)
    row("posting_scan_topk",
        lambda: ops.posting_scan_topk(q, st.vectors, st.slot_valid, vis,
                                      probe, k=10),
        lambda: ref.posting_scan_topk(q, st.vectors, valid, qp_ok, probe, 10),
        None, close_topk(rescore),
        2.0 * Q * P * C * d + 2.0 * U * C * d,
        4.0 * Q * d + U * C * (4.0 * d + 1) + 8.0 * Q * P + 8.0 * Q * 10)
    return rows


def time_quant_kernels(ops, ref, qdrv, fdrv, q_np, counts) -> list:
    """The quant path's kernels on its own inputs after the load and the
    streaming steps: the ADC scan at R = rerank_k, the rerank of its
    output, and kmeans_assign at the generation-0 fit's shape (16
    subspaces x 20,000 live rows x 256 centroids x 8).  Also the
    block-wide top-k of the float kernels past k = 32 (printed)."""
    from repro_torch.core import version_manager as vm
    from repro_torch.quant import pq
    st, dev, cfg = qdrv.state, qdrv.device, qdrv.cfg
    M, C, d = st.vectors.shape
    Q = len(q_np)
    q = torch.as_tensor(q_np, device=dev)
    vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
    _, probe = ops.centroid_topk(q, st.centroids, vis, k=cfg.nprobe)
    P = probe.shape[1]
    qp_ok = torch.ones(probe.shape, dtype=torch.int32, device=dev)
    luts = pq.lookup_tables(st.pq_codebooks, q)
    V, m, ksub = luts.shape[1:]
    slot = st.pq_posting_slot.clamp(0, V - 1)
    valid = st.slot_valid & vis[:, None]
    R = min(cfg.rerank_k, P * C)
    U = int(torch.unique(probe).numel())
    rows = []

    def exact(a, b):
        require_exact("main-path inputs", a, b)
        return 0.0

    scan = lambda: ops.pq_scan_topk(                          # noqa: E731
        luts, st.codes, st.pq_posting_slot, st.slot_valid, vis, probe, k=R)
    rows.append(timed_row(
        ops, counts, "pq_scan_topk", scan,
        lambda: ref.pq_scan_topk(luts, st.codes, slot, valid, qp_ok, probe,
                                 R), None, exact,
        1.0 * Q * P * C * m,
        4.0 * luts.numel() + U * C * (m + 1.0) + 4.0 * M + 8.0 * Q * P
        + 8.0 * Q * R))

    adc, cand = scan()
    flat = st.vectors.view(M * C, d)

    def rescore(c):
        v = flat[c.long()]
        return (v * v).sum(-1) - 2 * torch.einsum("qd,qkd->qk", q, v)

    def close_picks(a, b):
        err = require_close("main-path inputs", a[0], b[0])
        require_close("main-path picks", a[0], rescore(a[1]))
        return err

    kr = 10
    rows.append(timed_row(
        ops, counts, "rerank_topk",
        lambda: ops.rerank_topk(q, st.vectors, st.tier_spilled, cand, adc,
                                k=kr),
        lambda: ref.rerank_topk(q, st.vectors, st.tier_spilled, cand, adc,
                                kr), None, close_picks,
        4.0 * Q * R * d,
        4.0 * Q * R * d + 4.0 * Q * d + 9.0 * Q * R + 8.0 * Q * kr))

    N = 20000
    live = torch.nonzero(valid.view(-1))[:N, 0]
    sample = flat[live].contiguous()
    N = sample.shape[0]
    cents = st.pq_codebooks[int(st.pq_active)].contiguous()   # (m, ksub, ds)
    B, K, ds = cents.shape
    pts = sample.view(N, B, ds).transpose(0, 1)
    pts_c = pts.contiguous()
    cn = (cents * cents).sum(-1)[:, None, :]
    full = cn - 2.0 * torch.bmm(pts_c, cents.transpose(1, 2))

    def assign_close(a, b):
        check_assign("main-path inputs", a, b, full)
        return max_err(a[1], b[1])

    rows.append(timed_row(
        ops, counts, "kmeans_assign",
        lambda: ops.kmeans_assign(pts, cents),
        lambda: ref.kmeans_assign(pts, cents),
        lambda: torch.baddbmm(cn, pts_c, cents.transpose(1, 2), alpha=-2),
        assign_close, 2.0 * B * N * K * ds + 2.0 * B * K * ds,
        4.0 * (B * N * ds + B * K * ds) + 8.0 * B * N))
    del full

    # the block-wide top-k of the float kernels, past one warp
    fst = fdrv.state
    fvis = vm.visible(fst.rec_meta, fst.allocated, fst.global_version)
    fq = torch.as_tensor(q_np, device=fdrv.device)
    _, fprobe = ops.centroid_topk(fq, fst.centroids, fvis, k=cfg.nprobe)
    fok = torch.ones(fprobe.shape, dtype=torch.int32, device=dev)
    fvalid = fst.slot_valid & fvis[:, None]
    wide = {}
    for k in (32, 64, 192):
        wide[f"centroid_topk k={k}"] = (
            median_ms(lambda: ops.centroid_topk(fq, fst.centroids, fvis,
                                                k=k)),
            median_ms(lambda: ref.centroid_topk(fq, fst.centroids, fvis, k)))
    for k in (10, 64, 192):
        wide[f"posting_scan_topk k={k}"] = (
            median_ms(lambda: ops.posting_scan_topk(
                fq, fst.vectors, fst.slot_valid, fvis, fprobe, k=k)),
            median_ms(lambda: ref.posting_scan_topk(
                fq, fst.vectors, fvalid, fok, fprobe, k)))
    say("  top-k past one warp on the float path's inputs (ms kernel / "
        "plain): " + "; ".join(f"{n}: {a:.4f} / {b:.4f}"
                               for n, (a, b) in wide.items()))
    return rows


def sdpa_backend(fn) -> tuple:
    """The backend a ``scaled_dot_product_attention`` call dispatched to,
    read off the names of the device kernels one call launches under
    ``torch.profiler``: (label, the names)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({ev.key for ev in prof.key_averages()
                    if str(ev.device_type).endswith("CUDA")})
    low = " ".join(names).lower()
    for keys, label in ((("memeff", "fmha", "efficient"), "efficient"),
                        (("flash",), "flash"), (("cudnn",), "cudnn")):
        if any(key in low for key in keys):
            return label, names
    return "math", names


def time_attention(ops, ref, dev, counts, seed: int) -> dict:
    """``flash_attention`` at the serving path's shape (every layer of
    the backbone gives it B=64, Hq=32, Hkv=4, L=512, D=64, causal), on
    random normal q, k, v.  The yardstick is the faster of two
    ``scaled_dot_product_attention`` calls with ``is_causal=True`` (its
    top-left causal alignment equals the end alignment here, Lq = Lk):
    one with ``enable_gqa=True``, one on k and v expanded to Hq heads by
    ``repeat_interleave`` inside the timed call (fp32 GQA may leave the
    fused backends; the expanded call can take the memory-efficient one).
    Each is checked against the plain version, and the backend each ran
    is printed."""
    import torch.nn.functional as F
    g = np.random.default_rng(seed + 2)
    B, Hq, Hkv, L, D = SERVE_ATTN
    G = Hq // Hkv
    q, k, v = (torch.as_tensor(g.standard_normal(s, np.float32), device=dev)
               for s in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    plain = lambda: ref.flash_attention(q, k, v, causal=True)  # noqa: E731
    row = timed_row(
        ops, counts, "flash_attention",
        lambda: ops.flash_attention(q, k, v, causal=True), plain, None,
        lambda a, b: require_attn_close("flash_attention, timed inputs", a,
                                        b),
        4.0 * B * Hq * D * L * (L + 1) / 2,
        4.0 * (2 * B * Hq * L * D + 2 * B * Hkv * L * D))
    sdpa = {
        "enable_gqa": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        "repeat_interleave": lambda: F.scaled_dot_product_attention(
            q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
            is_causal=True)}
    want = plain()
    times = {}
    for name, fn in sdpa.items():
        require_attn_close(f"sdpa {name}", fn(), want)
        label, names = sdpa_backend(fn)
        times[name] = median_ms(fn)
        say(f"  sdpa {name}: {times[name]:.4f} ms, backend {label} "
            f"(kernels: {'; '.join(n[:60] for n in names[:4])})")
    del want
    row["library_ms"] = min(times.values())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row


def profile_windows(drv, stream, qdrv, qstream, embed_batch) -> dict:
    """Device time by kernel over four windows, with ``torch.profiler``:
    on the float path one load chunk (20k inserts, then ticks until
    quiescent) and one streaming step (20k inserts, 10k deletes, a tick,
    a 256-query search); on the quant path one streaming step; on the
    serving path one embedded batch of 64 x 512 tokens.  The busy
    share is device time over wall time (one stream, so kernels do not
    overlap); the wall time includes the profiler's own host overhead."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    next_id = int(drv.state.id_loc.shape[0]) - 200_000
    windows = {}

    def load_chunk():
        drv.insert(stream.draw(20000), np.arange(next_id, next_id + 20000))
        for _ in range(64):
            r = drv.tick()
            if r.executed == 0 and r.marked == 0:
                break

    def step(drv, stream):
        drv.insert(stream.draw(20000),
                   np.arange(next_id + 20000, next_id + 40000))
        drv.delete(np.arange(next_id, next_id + 10000))
        drv.tick()
        drv.search(stream.draw(256), 10)

    for name, fn in (("load_chunk", load_chunk),
                     ("stream_step", lambda: step(drv, stream)),
                     ("quant_stream_step", lambda: step(qdrv, qstream)),
                     ("serve_embed_batch", embed_batch)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        # device-side events only: an aten op's own entry repeats the
        # time of the kernels it launched
        rows = sorted(((ev.key, dev_us(ev) / 1e3, ev.count)
                       for ev in prof.key_averages()
                       if str(ev.device_type).endswith("CUDA")
                       and dev_us(ev) > 0),
                      key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e3
        windows[name] = {
            "wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if wall else 0.0,
            "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in rows[:10]]}
        say(f"  profile {name}: wall {wall:.4f} s, device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}%)")
        for k, ms, c in rows[:6]:
            say(f"    {ms:9.3f} ms  {c:6d} calls  {k[:70]}")
    return windows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}")
    sys.path.insert(0, src)
    from repro_torch.kernels import _nvcc, ops, ref

    dev = torch.device("cuda")
    smi = smi_line()
    say(f"phase 1: {smi}")
    say(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    built = _nvcc.build()
    say(f"  nvcc build (parallel, {len(built)} sources): "
        f"{time.perf_counter() - t:.1f} s  {json.dumps(built)}")
    for name in _nvcc.kernel_names():
        for line in _nvcc.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    say("phase 2: kernels against their plain versions")
    t = time.perf_counter()
    kernel_checks(ops, ref, dev, args.seed)
    attention_checks(ops, ref, dev, args.seed)
    torch.cuda.empty_cache()
    say(f"  {time.perf_counter() - t:.1f} s")

    paths, counts = {}, {}
    for label, quant in (("float", False), ("quant", True)):
        say(f"phase 3{'ab'[quant]}: {label} path, n=1000000 x 128-d"
            + (", PQ16 (m=16, ksub=256), rerank_k=192" if quant else ""))
        ops.reset_launch_counts()
        drv, q, secs, recalls, stream = main_path(
            dev, n=1_000_000, dim=128, max_postings=65504,
            cache_capacity=4096, steps=5, fresh=20000, dels=10000,
            queries=256, chunk=20000, seed=args.seed, round_size=2048,
            bg_ops=64, quant=quant, data=QUANT_DATA if quant else None)
        launched = ops.launch_counts()
        say(f"  seconds per phase: {json.dumps({k: round(v, 3) for k, v in secs.items()})}")
        say(f"  launches on the {label} path: {json.dumps(launched)}")
        keys = ("inserted", "deleted", "rejected", "bg_split", "bg_merge",
                "bg_compact", "bg_deferred") + (
                    ("pq_retrains", "pq_generation") if quant else ())
        say(f"  live {drv.live_count()}; stats "
            f"{json.dumps({k: drv.stats[k] for k in keys})}")
        for name in PATH_KERNELS[label]:
            if launched[name] <= 0:
                fail(f"kernel {name} was never launched on the {label} path")
        hard = hard_recall(drv, stream, 256)
        say("  recall@10 on harder queries (alpha * centre + N(0, I), not "
            "gated): " + ", ".join(f"alpha={a}: {r:.4f}"
                                   for a, r in hard.items()))
        paths[label] = (drv, q, recalls, stream)
        counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    say("  recall@10 per step (gated >= 0.9 on both paths): float "
        f"{paths['float'][2]}, quant {paths['quant'][2]}")
    qdrv, qq = paths["quant"][:2]
    say("  recall@10 of the last step's queries on the quant state (not "
        f"gated): ADC + rerank {paths['quant'][2][-1]:.4f}, float-plane "
        f"search {float_plane_recall(qdrv, qq):.4f}")

    say("phase 3c: the quant path on the float path's data (1 step, not "
        "gated)")
    drv, *_ = main_path(
        dev, n=1_000_000, dim=128, max_postings=65504, cache_capacity=4096,
        steps=1, fresh=20000, dels=10000, queries=256, chunk=20000,
        seed=args.seed, round_size=2048, bg_ops=64, quant=True, gate=False)
    del drv
    torch.cuda.empty_cache()

    say("phase 3d: the serving path, RetrievalServer over tinyllama-1.1b at "
        "full width, 2048 docs x 512 tokens")
    server, launched, toks, _ = serve_path(dev, ops, ref, seed=args.seed)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}

    say("phase 4: kernel times on the main paths' inputs")
    fdrv, fq, _, fstream = paths["float"]
    qdrv, qq, _, qstream = paths["quant"]
    rows = time_kernels(ops, ref, fdrv, fq, counts)
    rows += time_quant_kernels(ops, ref, qdrv, fdrv, qq, counts)
    rows.append(time_attention(ops, ref, dev, counts, args.seed))
    for r in rows:
        say(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}), "
            f"launches {r['launches']}, max err {r['max_abs_err']:.3g}")
    say("phase 4b: device time by kernel (torch.profiler)")
    profile_windows(fdrv, fstream, qdrv, qstream,
                    lambda: server.embedder.embed(toks))
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
