#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # the full run, one card
    python3 chip_smoke.py --parent-log P.log   # beside another run's times
                                               # (kernels, phases 3h, 3i)
    python3 chip_smoke.py --parent-tree DIR    # and another tree's kernels

Phases, in order (any failure exits non-zero before the last line):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the parallel ``nvcc`` build of every kernel source.
2. Each of the ten kernels against its plain PyTorch version on the
   card: at the main paths' shapes on integer-valued data (exact
   arithmetic in any summation order, so ids and scores must match
   exactly), with the wide top-k past k = 32 (k = 64, 192), and at
   the edge shapes of the CPU tests (d=100 with odd C, m=10, ksub=100,
   all masked, integer ties, spilled postings and empty ADC slots);
   ``flash_attention`` (3xTF32 on the tensor cores) at 28 shapes
   (``ATTN_SHAPES``: tests/test_kernels.py's three, D = 8, 72, 100 and
   128, Lq != Lk under a window, GQA 8:1 at D = 128; causal or not, with
   and without a window) and at the serving path's (B=64, Hq=32, Hkv=4,
   L=512, D=64, causal), within 2e-4 abs and rel (softmax is not exact
   on real data); ``kmeans_assign`` at ``KMEANS_SHAPES`` (N = 2,049, d =
   1, 3, 16, 100, K*d past one shared-memory stage; 32 codebooks over
   16), exact on integer inputs.  ``masked_score``
   (``centroid_score``, ``posting_scan``; 3xTF32 on the tensor cores) at
   Q = 1, 31, 32, 33, 2048 (both query tiles), x rows not a multiple of
   its 128-row tile, d = 96, 100, 128, 300, aligned and one float off: exact on
   integer inputs, within the tolerance on normal ones.  ``centroid_topk``
   and ``posting_scan_topk`` at Q = 1, 31, 32, 33, 256 x d = 96, 100, 128,
   300 x k = 1, 10, 32, aligned and one float off, on integer data, ties,
   all masked, duplicated probes and ``qp_ok`` zeros: exact; and on normal
   data ``centroid_topk`` equals the stable top-k of ``centroid_score``
   bit for bit.  Their wide paths (k > 32) at k = 33, 64, 192, 264 and
   1024 (``WIDE_CT``, ``WIDE_PS``: both query tiles, d = 99 and C = 33,
   a split over a cluster, rows past 16,384 floats) on integer data,
   ties, all masked, one float off, duplicated probes and ``qp_ok``
   zeros: exact; and on normal data at the main shapes a k = 64 or 192
   answer's first 32 (phase 1, the cache scan) or 10 (phase 2) are the
   k = 32 or 10 answer, score bits included, and the centroid scores
   are ``centroid_score``'s.  ``pq_scan_topk`` and ``rerank_topk`` at Q = 1, 31, 32,
   33, 256 x k = 1, 10, 32, 33, 64, 192 (1024 where P*C allows), on the
   quant path's tiles, m*C and d unaligned (C = 33, m = 10, d = 100, d =
   99), P*C past one 4,096-slot chunk and R past one 2,048-candidate
   chunk, tables and rows one float off, all masked, ties, duplicated
   probes, ``qp_ok`` zeros and none, spilled postings, empty ADC slots of
   BIG and +inf, scores at the selection's range bound: exact, and the
   scan bit for bit on real-valued tables.  ``posting_scan_gather`` and
   ``pq_scan_gather`` at Q = 1, 31, 32, 33, 256 on the oracle's tiles, d
   = 99, a tile of four 48 KB staging units, m*C and C no multiples of
   16: on integer data, one long run of pairs on a posting, duplicated
   probes, every posting invisible, inputs one float off: exact; on
   normal data the ADC gather bit for bit, the float gather within the
   tolerance.  The phase runs under a watchdog: a kernel that hangs
   fails the run.
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
   (e) the unfused search oracle on both states with the last step's
   256 queries: ``centroid_score`` -> stable top-``nprobe`` ->
   ``posting_scan_gather`` -> the cache -> stable top-10 equal to the
   fused search, ids and scores bit for bit; ``pq_scan_gather`` on the
   quant search's probes and tables -> stable top-``rerank_k`` equal to
   ``pq_scan_topk`` exactly.
   (f) the tiered path: the quant path with the cold tier
   (``use_tier``, ``tier_async``, 256 moves per tick, ``TIER_HOT_MAX``
   float-resident postings), at least ``TIER_SHARE`` of the live
   postings spilled after the load, the same steps and gates plus the
   residency invariant; its counters, the memory split and search
   seconds beside the quant path's; 64 tiles spilled and promoted back
   bit for bit.
   (c) the quant path once more on the float path's data at
   ``QUANT_3C`` vectors, one streaming step, its recall reported and not
   gated (see ``QUANT_DATA``).
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
   (g) the front door.  The float path once more with ``fused_tick=True``
   (device-side candidate selection) and ``Obs(trace_path=...)``, on
   3a's seed: 3a's gates, a final live map (id -> vector bytes) equal to
   3a's, the float path's kernels launched, and the trace audit (one
   JSONL line per event; insert minus delete events equal to the live
   count); then one more identical step on both drivers, its tick
   profiled fused against unfused (wall, device busy share).  Every
   engine of ``list_engines()`` (ubis, spfresh, spann, freshdiskann,
   ubis-sharded on its default mesh: one shard on a one-card machine;
   ubis-cluster: one in-process worker, every message through the codec)
   through one kwargs dict at d = 128 (``max_postings`` 65,504,
   ``capacity`` 96, ``nprobe`` 32; the graph's registry defaults), over
   a ``DriftingVectorStream`` of 400 clusters: the cluster engines 20k
   seed vectors and 5 batches of 20k inserts and 10k deletes,
   freshdiskann (host-Python inserts) 2,048 and 2 batches of 2,048 and
   1,024; each batch ticks until quiescent (at most 64 ticks), then a
   256-query search at k=10 and ``exact``.
   Gates: the contract harness's recall floors, ``live_count()`` =
   inserted - deleted (spann: its build, every update refused), deleted
   ids never returned, the cluster engines' kernels launched; printed:
   seconds by phase, recall and ``memory_bytes``.  Then the sequential
   single-posting ops against one ``background_round`` on a marked
   state at d = 128: the same live map, the invariants on both.
   Phase 3h, the sharded plane: ``make_index("ubis-sharded", ...)`` on
   S = 4 shards of the card (``make_mesh((1, 4))``, 16,376 postings a
   shard, each shard's rows and replicas in storage of its own).  3h-1:
   the float path's configuration and data at ``SHARD_LOAD`` vectors
   (1,000,000 until phase 3i came: the whole script's time), loaded
   through the sharded insert rounds, then 3 streaming steps;
   3h-2: the quant path's final state adopted (``load_snapshot``), then
   2 steps; 3h-3: figskew's stream (16 clusters, Zipf 1.5 popularity,
   ``benchmarks/figures.py:293-383``) at d = 128, 200,000 vectors in 10
   flushed batches, uniform with rebalance on, Zipf on, Zipf off and
   uniform off (each run's recall also at nprobe 128, not gated).
   Gates: recall@10 >= 0.9 against the sharded ``exact`` at every step,
   ``live_count()`` against the stats, the invariants (and the codes
   invariant) on ``snapshot()``, the replicas identical after the load
   and every step, every shard's tensors on its device and no storage
   shared by two shards at every stage (the S = 4 audit), every tick's
   pressure rows summing to the live postings' vectors, the sharded
   ``exact`` equal to the single-device
   ``brute_force`` of the snapshot (a differing id only at a near-tie),
   the path's kernels launched (``pq_scan_topk`` and ``rerank_topk``
   under the ownership mask), and each of them held against its plain
   version on the path's own inputs at their first few shapes
   (``held_on_path``: the shard-local pools, the ownership masks); Zipf
   on: max/min occupancy <= 1.5, migrations > 0, recall@10 within 2
   points of the uniform run (the off runs are reported, not gated).
   Phase 3i, the cluster plane (``make_index("ubis-cluster", ...)``),
   after the card's compute mode is read (two worker processes need two
   CUDA contexts: ``Default`` or the run fails).  3i-1: the float path's
   configuration on two worker processes (``backend="multiprocess"``,
   ``python -m repro_torch.cluster.worker``, 32,752 postings and one
   shard each): the 1M load and 2 steps with 3a's gates, worker live
   max/min <= 1.5, the invariants on each worker's snapshot and every
   float kernel launched in the worker processes (their own counts);
   then ``checkpoint``, one more step, SIGKILL of worker 0 between
   commands, the next call's recovery (``worker_lost``, then
   ``worker_restarted`` from the checkpoint with commands replayed) to
   the digest before the kill, and a fresh two-worker cluster's
   ``restore`` to the manifest's digest, its search equal to the
   original's at checkpoint time, ids bit for bit.  3i-2: ``workers=1``
   on the ``LocalBackend`` (every message through the codec) with
   ``mesh_shape=(1, 4)`` against ``ubis-sharded`` on ``make_mesh((1,
   4))``, the tiered path's configuration (``tier_hot_max`` scaled to
   200,000 vectors) over 3h-3's Zipf stream at 200,000 vectors, spills
   and promotes forced between batches, a re-train every 8 ticks: the
   per-op tape, the snapshot and the stats identical, migrations,
   re-trains and spills > 0, the replicas identical after every tick
   leg, and every quant kernel held against its plain version on the
   worker's own inputs (``held_on_path``).  3i-3: figdist's stream
   (``benchmarks/figures.py:386-440``, 16 clusters, Zipf 1.5) at d =
   128, 200,000 vectors in 10 batches each flushed for at most 8 ticks,
   over two workers on the local and on the multiprocess backend: the
   tapes, digests and searches equal, max/min <= 1.5, recall@10 >= 0.9
   against ``exact`` at nprobe 128.
   Phase 3k, where the process sees two or more cards (else it prints
   that it did not run and why): 3h-3's Zipf stream (200,000 vectors, 10
   flushed batches, rebalance on) on S = min(4, cards) shards, first all
   on the first card, then one a card (``make_mesh(..., devices=)``):
   the search and exact ids and scores, the stats, the occupancy and the
   snapshot equal bit for bit, the placement audited, and every float
   kernel of the path launched and held against its plain version on a
   later card's inputs; then the same for the quant plane (PQ16) on the
   stream's first 4 batches with a codebook re-train every 4 ticks
   (its five kernels held on a later card), and each plane's unfused
   gather launched on the last shard's card against its plain version.
   Where the process sees four cards, each plane also runs on the data
   x model mesh (2, 2) over ``cuda:0-3`` against (1, 2) on the first
   card, bit for bit, every kernel held on a row-1 card's inputs.
   Phase 3l (after 3h, on one card): the data x model mesh (2, 2), all
   four cells on the card, against (1, 2) there, over the same Zipf
   stream and its quant leg: bit for bit, ``check_replicas`` (every
   row's cells equal row 0's) after every batch, 100 storages audited,
   every kernel of the (2, 2) path launched and held against its plain
   version; each layout's seconds and 256-query search ms.
   Phase 3j, the backbone's decode path: ``get_model("tinyllama-1.1b")``
   at full width and depth from ``--seed`` prefills 16 prompts of 512
   tokens made from the seed (22 ``flash_attention`` launches, the first
   layer's held against the plain version on its q/k/v), the caches go
   into positions [0, 512) of ``init_cache(16, 576)`` and 64 greedy
   ``decode_step`` calls follow, the launch counts reset just before
   and read just after.  Gates, each within ``LOGIT_TOL`` of the largest
   |logit|: (i) teacher-forced on the kernel run's tokens, the prefill's
   and every step's logits against the same run with the plain
   attention in the kernel's place; (ii) prefill's last logits on 4
   prompts of 128 tokens against 128 one-token decode steps from an
   empty cache.  Then six variants at ``reduced=True`` (``qk_norm``,
   ``"LLG"`` with window 8 and a tail, tied embeddings, ``vocab=500``,
   enc-dec with 2 encoder layers and a ``src``, a vlm ``prefix``), each
   gated on (ii) with each kind of its ``flash_attention`` calls (the
   encoder's, the cross-attention's, the windowed layers') held against
   the plain version on its own inputs.  Printed: prefill ms and
   tokens/s, decode ms a step and tokens/s, weight and cache bytes.
4. Each kernel timed (CUDA events, median of 20 runs after warm-up) on
   its path's own inputs, beside its plain version, its bound and, where
   one PyTorch call computes the same product, that call (``addmm`` /
   ``baddbmm``, the gather's with ``index_select`` inside the call; for
   ``flash_attention`` at the serving path's shape the faster of two
   ``scaled_dot_product_attention`` calls, one with ``enable_gqa`` and
   one on expanded k and v, each with the backend it ran; printed also
   at phase 3j's prefill shape) as a library
   yardstick; the kernel is also held against its plain version there.
   The wide top-k paths are timed at k = 64 and 192 too (the cache
   scan, phase 1 and phase 2 at Q = 256 and 32, beside the parent tree's,
   and the wide ``centroid_topk``'s two launch layouts; with
   ``--parent-tree`` the parent's kernels also run phase 2's prefix
   check, printed), and
   ``kmeans_assign`` at the insert round's encode (2,048 rows under all
   V*m codebooks) and the re-train's full re-encode (every pool slot).
   ``centroid_score``, ``posting_scan`` and ``flash_attention`` also
   report the 3xTF32 route's bound (bytes, or three TF32 products at 495
   TFLOP/s).  ``centroid_topk`` (with the cache scan) and
   ``posting_scan_topk`` are also timed at the serving batch (Q = 32),
   each with its device time alone (``torch.profiler``), and so are
   ``pq_scan_topk`` (Q = 256 and 32, R = 192), ``rerank_topk`` (quant
   state, k = 10; tiered state, k = 192) and the two gathers (Q = 256
   and 32), the wrapper's own elementwise kernels listed apart; with
   ``--parent-tree`` (another checkout, unpacked) that tree's kernels
   are timed on the same inputs (the probed tiles and the reranked rows
   gathered into tables of their own) in a fresh process, before and
   after this tree's, and this tree's in a fresh process too.  With
   ``--parent-log`` (another tree's output, run first on
   the same card) each kernel's line also shows that run's time.  The insert
   locate's argmin is held against the plain version's (a differing pick
   must be a near-tie within the tolerance).  Then a load
   chunk and a streaming step of the float path, a streaming step of the
   quant and of the tiered path, one embedded batch of the serving
   path and one decode step of phase 3j run under ``torch.profiler``:
   their wall time, device time by kernel and device busy share, and on
   the tiered step the copies by stream and their overlap with the main
   stream's kernels.
5. The card's name and power limit, the kernel line ``{"kernels":
   [...]}``, then as the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# TF32 on the tensor cores, dense; 3xTF32 issues three products per fp32 one
PEAK_TF32 = 495e12
TOL = 1e-4           # relative to the score scale: fp32 summation order
PHASE2_LIMIT_S = 240  # phase 2's watchdog, seconds
ATTN_TOL = 2e-4      # abs and rel: tests/test_kernels.py:127
#: the kernels each main path must launch
PATH_KERNELS = {
    "float": ("centroid_score", "centroid_topk", "posting_scan",
              "posting_scan_topk"),
    "quant": ("centroid_score", "centroid_topk", "posting_scan",
              "pq_scan_topk", "rerank_topk", "kmeans_assign"),
    "serve": ("flash_attention", "centroid_score", "centroid_topk",
              "posting_scan", "posting_scan_topk"),
    "tier": ("centroid_score", "centroid_topk", "posting_scan",
             "pq_scan_topk", "rerank_topk", "kmeans_assign"),
    "oracle": ("centroid_score", "posting_scan_gather", "pq_scan_gather"),
    "decode": ("flash_attention",),
}
#: substrings of the port's own device kernels' names (csrc/*.cu): phase
#: 4b lists each of them in a window, past the six that take the most time
PORT_KERNELS = ("masked_score", "centroid_topk", "topk_merge", "posting_scan",
                "pq_scan", "rerank_topk", "kmeans_assign", "flash_attention")
#: the serving path's attention shape: (B, Hq, Hkv, L, D), causal
SERVE_ATTN = (64, 32, 4, 512, 64)
#: the tiered path's device high-watermark (float-resident postings), and
#: the least share of live postings it must leave spilled after the load
TIER_HOT_MAX = 4096
TIER_SHARE = 0.75
#: the tiered path's codebook re-train cadence in ticks.  A re-train first
#: promotes every spilled posting pinned to the codebook slot it evicts,
#: so each spilled posting returns within two re-trains; at the quant
#: path's cadence (32 ticks) and 256 moves per tick the pool held 7,168
#: of 19,291 live postings after the load (PERF.md, the tiered path)
TIER_RETRAIN_EVERY = 256


def wide_text(ops) -> str:
    """The wide top-k paths' (k > 32) share of the launches counted since
    the last reset."""
    return f"; of them wide (k > 32): {json.dumps(ops.wide_launch_counts())}"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def watchdog(seconds: float, what: str):
    """Fail the run if the block takes longer than ``seconds``: a kernel
    that hangs (a wrong mbarrier phase or byte count) blocks the host in a
    synchronize forever, and this ends the process instead."""
    def fire():
        print(f"chip_smoke: FAIL: {what} still running after {seconds:.0f} "
              "s (a kernel hangs?)", file=sys.stderr, flush=True)
        os._exit(1)
    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


#: the sources whose ptxas report phase 1 prints one line per instance
PTXAS_BY_INSTANCE = ("centroid_topk", "posting_scan_topk", "masked_score",
                     "pq_scan_topk", "rerank_topk", "posting_scan_gather",
                     "pq_scan_gather")


def ptxas_instances(log: str) -> list:
    """(entry, spill store bytes, registers) of each kernel instance in an
    ``-Xptxas -v`` report, names demangled by ``c++filt`` where it runs and
    cut to the kernel and its template arguments."""
    rows, entry, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill = m.group(1), "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, spill, m.group(1)))
            entry = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               timeout=30).stdout.split("\n")
    except (OSError, subprocess.SubprocessError):
        names = [r[0] for r in rows]
    out = []
    for (_, spill, regs), name in zip(rows, names):
        name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::",
                                                 ""))
        out.append((name.replace("void ", ""), spill, regs))
    return out


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
        out = ops.posting_scan_gather(q, tiles, valid, pvis, probe)
        check(f"posting_scan_gather[{label}]", (out,),
              (ref.posting_scan_gather(q, tiles, pvalid, probe),))
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
        require_exact(f"pq_scan_gather[{label}]",
                      (ops.pq_scan_gather(luts, codes, slot, valid, pvis,
                                          probe),),
                      (ref.pq_scan_gather(luts, codes, slot, pvalid, probe),))
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


#: phase 2's shapes for ``masked_score`` (``centroid_score`` and
#: ``posting_scan``): both query tiles (Q <= 32 and above), x rows not a
#: multiple of the 128-row tile, d not a multiple of the 32-deep slice
#: (100 not even of 8; 300 spans ten slices), and q and x at one float past
#: an aligned start
MASKED_Q = (1, 31, 32, 33, 2048)
MASKED_D = (96, 100, 128, 300)


def masked_score_checks(ops, ref, dev, seed: int) -> None:
    """``centroid_score`` (1,000 centroids) and ``posting_scan`` (9 x 37
    tiles) against their plain versions at every shape of ``MASKED_Q`` x
    ``MASKED_D``, aligned and not: exact on integer-valued inputs (3xTF32
    splits an integer below 2^11 into hi = itself and lo = 0), within
    ``TOL * scale`` on normal ones."""
    g = np.random.default_rng(seed + 2)

    def at(kind, shape, off):
        arr = (g.integers(-3, 4, shape).astype(np.float32) if kind == "int"
               else g.standard_normal(shape, np.float32))
        flat = torch.zeros(arr.size + off, device=dev)
        flat[off:] = torch.as_tensor(arr.ravel(), device=dev)
        return flat[off:].view(shape)

    n, worst = 0, 0.0
    for kind in ("int", "float"):
        for d in MASKED_D:
            for Q in MASKED_Q:
                for off in (0, 1):
                    q, c, tiles = (at(kind, (Q, d), off),
                                   at(kind, (1000, d), off),
                                   at(kind, (9, 37, d), off))
                    vis = torch.as_tensor(g.random(1000) < 0.7, device=dev)
                    valid = torch.as_tensor(g.random((9, 37)) < 0.7,
                                            device=dev)
                    for name, got, want in (
                            ("centroid_score", ops.centroid_score(q, c, vis),
                             ref.centroid_score(q, c, vis)),
                            ("posting_scan",
                             ops.posting_scan(q, tiles, valid),
                             ref.posting_scan(q, tiles, valid))):
                        label = f"{name}[{kind} Q={Q} d={d} offset={off}]"
                        if kind == "int":
                            require_exact(label, (got,), (want,))
                        else:
                            worst = max(worst, require_close(label, got,
                                                             want))
                        n += 1
    torch.cuda.synchronize()
    say(f"  masked_score vs plain at {n} shapes (Q {MASKED_Q}, d "
        f"{MASKED_D}, aligned and one float off): integer exact, normal "
        f"max abs err {worst:.3g}")


#: phase 2's shapes for the warp paths of ``centroid_topk`` and
#: ``posting_scan_topk``: both query tiles of the centroid kernel (Q <= 32
#: and above) and one probe group or several for the scan (Q = 256 takes
#: one), d not a multiple of a 32-deep slice or of 4 floats' copies, k at
#: both ends of the warp path, aligned and one float off
TOPK_Q = (1, 31, 32, 33, 256)
TOPK_D = (96, 100, 128, 300)
TOPK_K = (1, 10, 32)


def topk_checks(ops, ref, dev, seed: int) -> None:
    """``centroid_topk`` (300 centroids) and ``posting_scan_topk`` (5
    probes into 20 tiles of 33 slots: P * C = 165, no multiple of a tile)
    against their plain versions at every shape of ``TOPK_Q`` x ``TOPK_D``
    x ``TOPK_K``, aligned and one float off, exact on integer inputs:
    values in [-3, 3], ties (values in [-1, 1]), all masked; for the scan
    also duplicated probes and a quarter of ``qp_ok`` zero.  Then on
    normal data ``ops.centroid_topk`` equals the stable top-k of
    ``ops.centroid_score`` bit for bit, ties included (each centroid
    twice): one mainloop (``csrc/score_tile.cuh``) scores both."""
    g = np.random.default_rng(seed + 3)

    def at(arr, off):
        flat = torch.zeros(arr.size + off, device=dev)
        flat[off:] = torch.as_tensor(arr.ravel(), device=dev)
        return flat[off:].view(arr.shape)

    def mask(shape, p):
        return torch.as_tensor(g.random(shape) < p, device=dev)

    n = 0
    for kind in ("int", "ties", "masked", "dup", "qp0"):
        lo, hi = (-1, 2) if kind == "ties" else (-3, 4)
        p_vis = 0.0 if kind == "masked" else 0.7
        for d in TOPK_D:
            for Q in TOPK_Q:
                for k in TOPK_K:
                    for off in (0, 1):
                        def ints(shape):
                            return at(g.integers(lo, hi, shape).astype(
                                np.float32), off)
                        q, c, tiles = ints((Q, d)), ints((300, d)), ints(
                            (20, 33, d))
                        vis, valid = mask(300, p_vis), mask((20, 33), p_vis)
                        pvis = mask(20, 0.9)
                        probe = torch.as_tensor(g.integers(0, 20, (Q, 5)).astype(
                            np.int32), device=dev)
                        if kind == "dup":
                            probe = torch.cat([probe[:, :3], probe[:, :3]], 1)
                        qp_ok = mask(probe.shape, 0.75 if kind == "qp0"
                                     else 1.0).to(torch.int32)
                        label = f"[{kind} Q={Q} d={d} k={k} offset={off}]"
                        if kind in ("int", "ties", "masked"):
                            require_exact(
                                "centroid_topk" + label,
                                ops.centroid_topk(q, c, vis, k=k),
                                ref.centroid_topk(q, c, vis, k))
                            n += 1
                        require_exact(
                            "posting_scan_topk" + label,
                            ops.posting_scan_topk(q, tiles, valid, pvis,
                                                  probe, k=k, qp_ok=qp_ok),
                            ref.posting_scan_topk(q, tiles,
                                                  valid & pvis[:, None],
                                                  qp_ok, probe, k))
                        n += 1
    m = 0
    for Q, d in ((1, 128), (31, 100), (33, 300), (256, 128)):
        half = g.standard_normal((650, d), np.float32)
        c = torch.as_tensor(np.concatenate([half, half[::-1]]), device=dev)
        q = torch.as_tensor(g.standard_normal((Q, d), np.float32),
                            device=dev)
        vis = mask(1300, 0.8)
        for k in TOPK_K:
            ws, wi = ref.stable_topk(ops.centroid_score(q, c, vis), k)
            require_exact(f"centroid_topk vs centroid_score[Q={Q} d={d} "
                          f"k={k}]", ops.centroid_topk(q, c, vis, k=k),
                          (ws, wi.to(torch.int32)))
            m += 1
    torch.cuda.synchronize()
    say(f"  centroid_topk and posting_scan_topk vs plain at {n} integer "
        f"shapes (Q {TOPK_Q}, d {TOPK_D}, k {TOPK_K}, aligned and one float "
        f"off; ties, all masked, duplicated probes, qp_ok zeros): exact; "
        f"centroid_topk == stable top-k of centroid_score on normal data at "
        f"{m} shapes: bit for bit")


#: phase 2's shapes for the wide paths (k > 32) of ``centroid_topk``
#: (Q, M, d) and ``posting_scan_topk`` (Q, G, C, P, d): both query tiles
#: (16 and 32 rows) and both layouts (one or two blocks an SM), d not a
#: multiple of 4 (the 4-byte copies; d = 99 and C = 33, odd, at k =
#: 1024), the scan split over a cluster (Q < 67) or not, rows past 16,384
#: floats (read from device memory); ``kernel_checks`` and
#: ``prefix_checks`` add the main shapes, lists cut within a chunk
WIDE_K = (33, 64, 192, 264, 1024)
WIDE_CT = ((1, 1100, 99), (31, 1100, 128), (33, 4096, 100), (256, 4096, 128))
WIDE_PS = ((1, 40, 33, 32, 99), (31, 40, 33, 32, 128), (33, 60, 96, 32, 100),
           (256, 60, 96, 32, 128), (3, 10, 40, 8, 16400))


def wide_checks(ops, ref, dev, seed: int) -> None:
    """The wide paths against their plain versions at every shape of
    ``WIDE_CT`` / ``WIDE_PS`` x ``WIDE_K`` (k up to M or P*C), exact on
    integer inputs: values in [-3, 3], ties (values in [-1, 1]), all
    masked; aligned and one float off; for the scan also duplicated
    probes and a quarter of ``qp_ok`` zero.  Then ``prefix_checks`` on
    real-valued data."""
    g = np.random.default_rng(seed + 7)

    def at(arr, off):
        flat = torch.zeros(arr.size + off, device=dev)
        flat[off:] = torch.as_tensor(arr.ravel(), device=dev)
        return flat[off:].view(arr.shape)

    def mask(shape, p):
        return torch.as_tensor(g.random(shape) < p, device=dev)

    n = 0
    for kind in ("int", "ties", "masked", "dup"):
        lo, hi = (-1, 2) if kind == "ties" else (-3, 4)
        p_vis = 0.0 if kind == "masked" else 0.7
        off = int(kind in ("ties", "dup"))
        for Q, M, d in WIDE_CT:
            if kind == "dup":
                continue
            q, c = (at(g.integers(lo, hi, s).astype(np.float32), off)
                    for s in ((Q, d), (M, d)))
            vis = mask(M, p_vis)
            for k in WIDE_K:
                require_exact(f"centroid_topk[{kind} Q={Q} M={M} d={d} "
                              f"k={k} offset={off}]",
                              ops.centroid_topk(q, c, vis, k=k),
                              ref.centroid_topk(q, c, vis, k))
                n += 1
        for Q, G, C, P, d in WIDE_PS:
            q, tiles = (at(g.integers(lo, hi, s).astype(np.float32), off)
                        for s in ((Q, d), (G, C, d)))
            valid, pvis = mask((G, C), p_vis), mask(G, 0.9)
            probe = torch.as_tensor(g.integers(0, G, (Q, P)).astype(
                np.int32), device=dev)
            if kind == "dup":
                probe[:, P // 2:] = probe[:, :P - P // 2]
            qp_ok = (mask((Q, P), 0.75).to(torch.int32) if kind == "dup"
                     else None)
            full = (torch.ones((Q, P), dtype=torch.int32, device=dev)
                    if qp_ok is None else qp_ok)
            for k in WIDE_K:
                if k > P * C:
                    continue
                require_exact(
                    f"posting_scan_topk[{kind} Q={Q} C={C} P={P} d={d} "
                    f"k={k} offset={off}]",
                    ops.posting_scan_topk(q, tiles, valid, pvis, probe, k=k,
                                          qp_ok=qp_ok),
                    ref.posting_scan_topk(q, tiles, valid & pvis[:, None],
                                          full, probe, k))
                n += 1
    torch.cuda.synchronize()
    say(f"  wide top-k (k {WIDE_K}) vs plain at {n} integer shapes "
        f"(centroid_topk {WIDE_CT}, posting_scan_topk {WIDE_PS}; ties, all "
        "masked, one float off, duplicated probes, qp_ok zeros): exact")
    bad = prefix_checks(ops, dev, seed)
    if bad:
        fail("wide top-k prefix check: " + "; ".join(bad))
    say("  wide top-k prefix on normal data at the main shapes: "
        "centroid_topk(k)[:, :32] == centroid_topk(32) and == centroid_score "
        "at its picks, posting_scan_topk(k)[:, :10] == posting_scan_topk(10), "
        "k = 64, 192, ids and score bits: ok")


def prefix_checks(ops, dev, seed: int) -> list:
    """On normal data at the main paths' shapes (phase 1: 256 and 32 x
    65,504 x 128, 70% visible; the cache scan 256 x 4,096; phase 2: 256
    and 32 queries x 32 probes into 2,000 tiles of 96 x 128): for k = 64
    and 192, ``centroid_topk(k)``'s first 32 columns are
    ``centroid_topk(32)``'s ids and score bits, and its scores are
    ``centroid_score``'s at its picks; ``posting_scan_topk(k)``'s first
    10 are ``posting_scan_topk(10)``'s.  Where the wide path scored with
    other arithmetic than the warp path, a near-tie orders them apart.
    Returns the failures (uses only ``ops``' public functions, so it runs
    on another tree's kernels too)."""
    g = np.random.default_rng(seed + 8)

    def normal(*shape):
        return torch.as_tensor(g.standard_normal(shape, np.float32),
                               device=dev)

    bad = []

    def same(label, a, b):
        for x, y, what in ((a[0], b[0], "score bits"), (a[1], b[1], "ids")):
            if not torch.equal(x.contiguous().view(torch.int32),
                               y.contiguous().view(torch.int32)):
                bad.append(f"{label}: {what} differ at "
                           f"{int((x != y).sum())} entries")

    c, vis = normal(65504, 128), torch.as_tensor(g.random(65504) < 0.7,
                                                 device=dev)
    cache = normal(4096, 128)
    cache_ok = torch.ones(4096, dtype=torch.bool, device=dev)
    for label, q, cen, ok in (("phase 1 Q=256", normal(256, 128), c, vis),
                              ("phase 1 Q=32", normal(32, 128), c, vis),
                              ("cache scan", normal(256, 128), cache,
                               cache_ok)):
        s32 = ops.centroid_topk(q, cen, ok, k=32)
        full = ops.centroid_score(q, cen, ok)
        for k in (64, 192):
            s, i = ops.centroid_topk(q, cen, ok, k=k)
            same(f"centroid_topk {label} k={k} vs k=32",
                 (s[:, :32], i[:, :32]), s32)
            same(f"centroid_topk {label} k={k} vs centroid_score",
                 (s, i), (torch.gather(full, 1, i.long()), i))
    tiles, svalid = normal(2000, 96, 128), torch.as_tensor(
        g.random((2000, 96)) < 0.9, device=dev)
    pvis = torch.ones(2000, dtype=torch.bool, device=dev)
    for Q in (256, 32):
        q = normal(Q, 128)
        probe = torch.as_tensor(g.integers(0, 2000, (Q, 32)).astype(
            np.int32), device=dev)
        s10 = ops.posting_scan_topk(q, tiles, svalid, pvis, probe, k=10)
        for k in (64, 192):
            s, i = ops.posting_scan_topk(q, tiles, svalid, pvis, probe, k=k)
            same(f"posting_scan_topk Q={Q} k={k} vs k=10",
                 (s[:, :10], i[:, :10]), s10)
    torch.cuda.synchronize()
    return bad


#: phase 2's shapes for the quant plane's phase-2 kernels: ``pq_scan_topk``
#: at (C, m, ksub, M, P): the quant path's tiles, m*C not a multiple of 16
#: (the plain-load instance), and P*C past one chunk of 4,096 slots;
#: ``rerank_topk`` at (M, C, d, R): d a multiple of 4 and not, and R past
#: one chunk of 2,048 candidates
QUANT_Q = (1, 31, 32, 33, 256)
PQ_SHAPES = ((96, 16, 256, 200, 32), (33, 10, 100, 50, 5),
             (96, 16, 256, 300, 64))
PQ_K = (1, 10, 32, 33, 64, 192, 1024)
RR_SHAPES = ((200, 33, 100, 192), (200, 33, 99, 192), (60, 96, 128, 2500))
RR_K = (1, 10, 32, 33, 64, 192)


def quant_checks(ops, ref, dev, seed: int) -> None:
    """``pq_scan_topk`` and ``rerank_topk`` against their plain versions
    at every shape of ``QUANT_Q`` x ``PQ_SHAPES`` / ``RR_SHAPES`` x the k
    of ``PQ_K`` / ``RR_K`` that the shape allows, exact.  The scan: on
    integer tables (values in [-3, 3]), ties (in [-1, 1]), all probes
    masked, duplicated probes, a quarter of ``qp_ok`` zero, no ``qp_ok``,
    tables one float off 16-byte alignment, and on real-valued tables
    (its sum runs in the plain version's order, so it is bit for bit
    there too).  The rerank: on integer rows and queries, ties, a third of
    the postings spilled, a fifth of the ADC slots empty (BIG or +inf),
    and rows one float off alignment."""
    g = np.random.default_rng(seed + 5)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def off(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    n = 0
    for C, m, ksub, M, P in PQ_SHAPES:
        for kind in ("int", "ties", "masked", "dup", "qp0", "null",
                     "offset", "real"):
            for Q in QUANT_Q:
                lo, hi = (-1, 2) if kind == "ties" else (-3, 4)
                luts = (g.standard_normal((Q, 2, m, ksub), np.float32)
                        if kind == "real" else
                        g.integers(lo, hi, (Q, 2, m, ksub)).astype(np.float32))
                luts = t(luts)
                if kind == "offset":
                    luts = off(luts)
                codes = t(g.integers(0, ksub, (M, m, C)).astype(np.uint8))
                slot = t(g.integers(-1, 3, M).astype(np.int32))
                valid = t(g.random((M, C)) < (0.0 if kind == "masked"
                                              else 0.7))
                vis = t(g.random(M) < 0.9)
                probe = g.integers(0, M, (Q, P)).astype(np.int32)
                if kind == "dup":
                    probe[:, P // 2:] = probe[:, :P - P // 2]
                probe = t(probe)
                qp_ok = t((g.random((Q, P)) < (0.75 if kind == "qp0"
                                               else 1.0)).astype(np.int32))
                for k in PQ_K:
                    if k > P * C:
                        continue
                    got = ops.pq_scan_topk(
                        luts, codes, slot, valid, vis, probe, k=k,
                        qp_ok=None if kind == "null" else qp_ok)
                    require_exact(
                        f"pq_scan_topk[{kind} Q={Q} C={C} m={m} P={P} k={k}]",
                        got, ref.pq_scan_topk(luts, codes,
                                              slot.clamp(0, 1),
                                              valid & vis[:, None], qp_ok,
                                              probe, k))
                    n += 1
    # the selection's range bound: scores within a few hundred ulps on
    # both sides of BIG / 2 (m = 1: a score is one table entry), k = the
    # count below it, so that the bin taken whole holds keys above too
    for Q in (1, 1, 1):
        near = g.uniform(0, 6e-5, (Q, 2, 1, 256))
        luts = t((5e29 * np.where(g.random(near.shape) < 0.5, 1 - near,
                                  1 + near)).astype(np.float32))
        codes = t(g.integers(0, 256, (40, 1, 96)).astype(np.uint8))
        slot = t(g.integers(0, 2, 40).astype(np.int32))
        valid = t(g.random((40, 96)) < 0.8)
        vis = torch.ones(40, dtype=torch.bool, device=dev)
        probe = t(g.integers(0, 40, (Q, 8)).astype(np.int32))
        qp_ok = torch.ones((Q, 8), dtype=torch.int32, device=dev)
        full = ref.pq_scan_gather(luts, codes, slot, valid, probe)
        k = max(1, min(1024, int((full < 5e29).sum())))
        require_exact(f"pq_scan_topk[range bound k={k}]",
                      ops.pq_scan_topk(luts, codes, slot, valid, vis, probe,
                                       k=k),
                      ref.pq_scan_topk(luts, codes, slot, valid, qp_ok,
                                       probe, k))
        n += 1
    r = 0
    for M, C, d, R in RR_SHAPES:
        for kind in ("int", "ties", "spilled", "empty", "offset"):
            for Q in QUANT_Q:
                lo, hi = (-1, 2) if kind == "ties" else (-3, 4)
                q = t(g.integers(lo, hi, (Q, d)).astype(np.float32))
                vecs = t(g.integers(lo, hi, (M, C, d)).astype(np.float32))
                if kind == "offset":
                    vecs = off(vecs)
                spilled = t(g.random(M) < (0.3 if kind == "spilled" else 0.0))
                cand = t(np.stack([g.permutation(M * C)[:R]
                                   for _ in range(Q)]).astype(np.int32))
                adc = np.sort(g.integers(-50, 50, (Q, R)),
                              axis=1).astype(np.float32)
                if kind == "empty":
                    adc = np.where(g.random((Q, R)) < 0.2,
                                   np.where(g.random((Q, R)) < 0.5, 1e30,
                                            np.inf), adc).astype(np.float32)
                adc = t(adc)
                for k in RR_K:
                    require_exact(
                        f"rerank_topk[{kind} Q={Q} d={d} R={R} k={k}]",
                        ops.rerank_topk(q, vecs, spilled, cand, adc, k=k),
                        ref.rerank_topk(q, vecs, spilled, cand, adc, k))
                    r += 1
    torch.cuda.synchronize()
    say(f"  pq_scan_topk vs plain at {n} shapes (Q {QUANT_Q}, (C, m, ksub, "
        f"M, P) {PQ_SHAPES}, k {PQ_K}; integer, ties, all masked, "
        f"duplicated probes, qp_ok zeros and none, tables one float off, "
        f"real-valued tables, scores at the range bound): exact; rerank_topk at {r} shapes (Q "
        f"{QUANT_Q}, (M, C, d, R) {RR_SHAPES}, k {RR_K}; integer, ties, "
        "spilled, empty ADC slots BIG and +inf, rows one float off): exact")


#: phase 2's shapes for the two gathers: ``posting_scan_gather`` at (C, d,
#: M, P): the oracle's tiles, d no multiple of 4 (the plain-copy
#: instance), a tile of four 48 KB staging units; ``pq_scan_gather`` at
#: (C, m, ksub, M, P): the quant path's tiles, m*C and C no multiples of
#: 16, C = 20 (m*C a multiple of 16, C not); at Q = 1, 31, 32, 33, 256
#: (the ADC scan's probe split and the inversion's edges)
GATHER_Q = (1, 31, 32, 33, 256)
PSG_SHAPES = ((96, 128, 400, 32), (33, 99, 50, 5), (133, 300, 20, 4))
PQG_SHAPES = ((96, 16, 256, 200, 32), (33, 10, 100, 50, 5),
              (20, 4, 16, 60, 6))
GATHER_KINDS = ("int", "same", "dup", "masked", "offset", "normal")


def gather_checks(ops, ref, dev, seed: int) -> None:
    """``posting_scan_gather`` and ``pq_scan_gather`` against their plain
    versions at every shape of ``PSG_SHAPES`` / ``PQG_SHAPES`` x
    ``GATHER_Q`` x ``GATHER_KINDS``: integer data (exact), every pair on
    one posting (one long run, cut into chunks), duplicated probes within
    a query and across queries, every posting invisible, inputs one float
    off 16-byte alignment (q and the vectors; the tables), and normal data
    (the float gather within the tolerance; the ADC gather bit for bit:
    it sums in the plain version's order).  A quarter of the postings are
    invisible and the codebook slots run -1 .. V (clamped)."""
    g = np.random.default_rng(seed + 7)

    def t(a, off=0):
        flat = torch.zeros(a.size + off, dtype=torch.float32, device=dev)
        flat[off:] = torch.as_tensor(a.ravel(), device=dev)
        return flat[off:].view(a.shape)

    def data(kind, shape):
        return (g.standard_normal(shape, np.float32) if kind == "normal"
                else g.integers(-3, 4, shape).astype(np.float32))

    def probes(kind, M, Q, P):
        if kind == "same":
            return torch.full((Q, P), M // 2, dtype=torch.int32, device=dev)
        pr = g.integers(0, M, (Q, P)).astype(np.int32)
        if kind == "dup":
            pr[:, P - P // 2:] = pr[:, :P // 2]
            pr[Q // 2] = pr[0]
        return torch.as_tensor(pr, device=dev)

    def vis_of(kind, M):
        return torch.as_tensor(np.zeros(M, bool) if kind == "masked"
                               else np.arange(M) % 4 != 1, device=dev)

    n, worst = 0, 0.0
    for C, d, M, P in PSG_SHAPES:
        for kind in GATHER_KINDS:
            for Q in GATHER_Q:
                off = 1 if kind == "offset" else 0
                q, vecs = t(data(kind, (Q, d)), off), t(data(kind, (M, C, d)),
                                                        off)
                sv = torch.as_tensor(g.random((M, C)) < 0.7, device=dev)
                vis, pr = vis_of(kind, M), probes(kind, M, Q, P)
                got = ops.posting_scan_gather(q, vecs, sv, vis, pr)
                want = ref.posting_scan_gather(q, vecs, sv & vis[:, None], pr)
                label = f"posting_scan_gather[{kind} Q={Q} C={C} d={d}]"
                if kind == "normal":
                    worst = max(worst, require_close(label, got, want))
                else:
                    require_exact(label, (got,), (want,))
                n += 1
    m_ = 0
    for C, m, ksub, M, P in PQG_SHAPES:
        for kind in GATHER_KINDS:
            for Q in GATHER_Q:
                V = 2
                luts = t(data(kind, (Q, V, m, ksub)),
                         1 if kind == "offset" else 0)
                codes = torch.as_tensor(g.integers(0, ksub, (M, m, C)).astype(
                    np.uint8), device=dev)
                slot = torch.as_tensor((np.arange(M) % (V + 2) - 1).astype(
                    np.int32), device=dev)
                sv = torch.as_tensor(g.random((M, C)) < 0.7, device=dev)
                vis, pr = vis_of(kind, M), probes(kind, M, Q, P)
                require_exact(
                    f"pq_scan_gather[{kind} Q={Q} C={C} m={m}]",
                    (ops.pq_scan_gather(luts, codes, slot, sv, vis, pr),),
                    (ref.pq_scan_gather(luts, codes, slot.clamp(0, V - 1),
                                        sv & vis[:, None], pr),))
                m_ += 1
    torch.cuda.synchronize()
    say(f"  posting_scan_gather vs plain at {n} shapes (Q {GATHER_Q}, (C, d, "
        f"M, P) {PSG_SHAPES}; {', '.join(GATHER_KINDS)}): exact on integer "
        f"data, normal max abs err {worst:.3g}; pq_scan_gather at {m_} "
        f"shapes ((C, m, ksub, M, P) {PQG_SHAPES}, the same kinds, slots "
        "-1 .. V): exact, real-valued tables included")


def require_attn_close(name, got, want) -> float:
    """|kernel - plain| <= ATTN_TOL * (1 + |plain|) everywhere: every row
    of these shapes has at least one valid key (a row with none has no
    right answer, see ``ref.flash_attention``)."""
    err = (got.double() - want.double()).abs()
    if not bool((err <= ATTN_TOL * (1 + want.double().abs())).all()):
        fail(f"{name}: max |kernel - plain| = {float(err.max()):.3g} "
             f"beyond {ATTN_TOL} abs + rel")
    return float(err.max())


#: phase 2's shapes for ``flash_attention`` (Lq, Lk, D, Hq, Hkv): the three
#: of tests/test_kernels.py:114-117, then head dims at the kernel's edges
#: (one MMA k-step; 72 and 100 not a multiple of 16 or of 4; 128, its
#: widest), Lq != Lk under the window, GQA 8:1 at D = 128
ATTN_SHAPES = ((37, 53, 16, 4, 2), (64, 64, 32, 2, 2), (16, 128, 64, 8, 1),
               (70, 70, 8, 2, 1), (33, 77, 72, 4, 2), (40, 100, 100, 2, 1),
               (65, 130, 128, 8, 1))


def attention_checks(ops, ref, dev, seed: int) -> None:
    """``flash_attention`` against its plain version at every shape of
    ``ATTN_SHAPES``, causal or not, with and without a window of 9 (ragged
    tiles, Lq != Lk end alignment, GQA 2:1 and 8:1, D = 8 to 128), and at
    the serving path's shape."""
    g = np.random.default_rng(seed + 1)

    def normal(shape):
        return torch.as_tensor(g.standard_normal(shape, np.float32),
                               device=dev)

    n = 0
    for Lq, Lk, D, Hq, Hkv in ATTN_SHAPES:
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
    say(f"  flash_attention vs plain at {n} shapes (D "
        f"{sorted({s[2] for s in ATTN_SHAPES})}) and the serving shape "
        f"{SERVE_ATTN}: ok (max abs err there {err:.3g}, tolerance "
        f"{ATTN_TOL} abs + rel)")


#: phase 2's edge shapes for ``kmeans_assign`` (N, K, d), 32 codebooks over
#: 16 point batches (V*m over m, as the insert round encodes): N past a
#: multiple of a block's points, d of 1 and 3 (padded in registers), 16,
#: 100 (the path past 32 features), and K*d past one shared-memory stage
KMEANS_SHAPES = ((2049, 256, 8), (300, 16, 1), (300, 16, 3), (600, 64, 16),
                 (257, 100, 100), (100, 2100, 16))


def kmeans_checks(ops, ref, dev, seed: int) -> None:
    """``kmeans_assign`` against its plain version at ``KMEANS_SHAPES`` on
    integer-valued inputs (every sum exact): ids and scores equal."""
    g = np.random.default_rng(seed + 3)
    for N, K, d in KMEANS_SHAPES:
        pts = torch.as_tensor(g.integers(-3, 4, (N, 16 * d)).astype(
            np.float32), device=dev).view(N, 16, d).transpose(0, 1)
        cents = torch.as_tensor(g.integers(-3, 4, (32, K, d)).astype(
            np.float32), device=dev)
        mask = torch.as_tensor(g.random(N) < 0.8, device=dev)
        require_exact(f"kmeans_assign[N={N} K={K} d={d}]",
                      ops.kmeans_assign(pts, cents, mask),
                      ref.kmeans_assign(pts, cents, mask))
    torch.cuda.synchronize()
    say(f"  kmeans_assign vs plain at {len(KMEANS_SHAPES)} edge shapes "
        f"(N, K, d) {KMEANS_SHAPES}, 32 codebooks over 16: exact")


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
#: phase 3c's load (1,000,000 until phase 3i came: the whole script's
#: time); the float path's stream at this size has 1,000 centres
QUANT_3C = 500_000


def quant_config(dim: int) -> dict:
    """The quant path's plane: PQ16 at dim 128 (m = dim // 8, the first
    variant of ``benchmarks/figures.py``'s figpq sweep), 256 centroids
    per subspace, two codebook versions, rerank_k=192 (figures.py:141)."""
    return dict(use_pq=True, pq_m=dim // 8, pq_ksub=256, pq_versions=2,
                pq_sample=2048, rerank_k=192)


def instrument_tier(tier) -> None:
    """Reporting hooks on a driver's ``TierManager``: ``retrain_promoted``
    counts the spilled postings that ``promote_retrain_pinned`` moves back
    before each codebook re-train (the driver's stats fold them into
    ``tier_promoted``); ``host_s`` holds the host seconds and calls of
    the search's exact rerank (``rerank``) and of the exact oracle's pool
    scan (``exact_merge``)."""
    tier.retrain_promoted = 0
    tier.host_s = {"rerank": [0.0, 0], "exact_merge": [0.0, 0]}
    inner = tier.promote_retrain_pinned

    def counted(state):
        state, n = inner(state)
        tier.retrain_promoted += n
        return state, n
    tier.promote_retrain_pinned = counted
    for name in tier.host_s:
        def timed(*a, _fn=getattr(tier, name), _name=name, **k):
            t = time.perf_counter()
            out = _fn(*a, **k)
            tier.host_s[_name][0] += time.perf_counter() - t
            tier.host_s[_name][1] += 1
            return out
        setattr(tier, name, timed)


def hot_postings(drv) -> int:
    """Float-resident NORMAL postings: what the watermark counts."""
    st = drv.state
    return int((st.allocated & ((st.rec_meta & 3) == 0)
                & ~st.tier_spilled).sum())


def spilled_share(drv) -> float:
    """Spilled postings over live (allocated, not DELETED) postings."""
    st = drv.state
    live = st.allocated & ((st.rec_meta & 3) != 3)
    return int((st.tier_spilled & live).sum()) / max(1, int(live.sum()))


def main_path(dev, *, n: int, dim: int, max_postings: int,
              cache_capacity: int, steps: int, fresh: int, dels: int,
              queries: int, chunk: int, seed: int, round_size: int,
              bg_ops: int, quant: bool = False, pq_retrain_every: int = 32,
              tier_hot_max: int = 0, data=None, gate: bool = True,
              index_kw=None, engine: str = "ubis", hook=None, log=say):
    """Drive ``make_index("ubis", ...)`` through load + streaming steps,
    on the float plane or (``quant``) the quant plane, with the cold tier
    when ``tier_hot_max`` > 0 (``tier_async``, 256 moves per tick; at
    least ``TIER_SHARE`` of the live postings spilled after the load);
    ``data``: keyword arguments of ``Stream``; ``gate=False`` reports
    recall@10 without failing below 0.9; ``index_kw``: more keyword
    arguments of ``make_index`` (``fused_tick``, ``obs``, ``mesh``,
    ``workers``); ``engine``: ``ubis``, ``ubis-sharded`` or
    ``ubis-cluster``; ``hook(drv, stage)`` runs
    after the build, the load and each step.  Returns (driver, last queries,
    per-phase seconds, recalls, stream)."""
    from repro_torch.api import make_index
    from repro_torch.core.invariants import check_invariants, check_residency
    from repro_torch.core.types import UBISConfig

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    tier = tier_hot_max > 0
    cfg = UBISConfig(dim=dim, max_postings=max_postings, capacity=96,
                     l_min=10, l_max=80, balance_factor=0.15, nprobe=32,
                     cache_capacity=cache_capacity, max_ids=1 << 21,
                     **(quant_config(dim) if quant else {}),
                     **(dict(use_tier=True, tier_hot_max=tier_hot_max)
                        if tier else {}))
    secs = {}
    t = time.perf_counter()
    stream = Stream(dim, max(8, n // 500), seed, **(data or {}))
    base = stream.draw(n)
    secs["data"] = time.perf_counter() - t

    t = time.perf_counter()
    drv = make_index(engine, cfg, base, device=dev, seed=seed,
                     round_size=round_size, bg_ops_per_round=bg_ops,
                     drain_per_tick=round_size,
                     pq_retrain_every=pq_retrain_every,
                     **(dict(tier_async=True, tier_moves_per_tick=256)
                        if tier else {}), **(index_kw or {}))
    sync()
    secs["build"] = time.perf_counter() - t
    if tier:
        instrument_tier(drv.tier)
    if hook is not None:
        hook(drv, "built")

    t = time.perf_counter()
    ticks = 0
    for off in range(0, n, chunk):
        drv.insert(base[off:off + chunk], np.arange(off, min(n, off + chunk)))
        for _ in range(64):
            ticks += 1
            r = drv.tick()
            if (r.executed == 0 and r.marked == 0 and r.spilled == 0
                    and r.promoted == 0 and r.migrated == 0):
                break
    sync()
    secs["load"] = time.perf_counter() - t
    log(f"  loaded {n} vectors: {secs['load']:.1f} s, {ticks} ticks, "
        f"rejected {drv.stats['rejected']:.0f}, live postings "
        f"{len(drv.posting_lengths())}")
    if tier:
        # settle: tick until the float-resident postings are back under
        # the watermark (the last chunk's appends leave them too warm to
        # spill at once)
        settle = 0
        while settle < 64 and hot_postings(drv) > tier_hot_max:
            drv.tick()
            settle += 1
        sync()
        secs["settle"] = time.perf_counter() - t - secs["load"]
        share = spilled_share(drv)
        log(f"  settled in {settle} ticks ({secs['settle']:.1f} s); "
            f"re-trains {drv.stats['pq_retrains']:.0f}, postings they "
            f"promoted {drv.tier.retrain_promoted}")
        log(f"  tier_hot_max {tier_hot_max}: {100 * share:.2f}% of the live "
            f"postings spilled after the load ({len(drv.tier.pool)} tiles, "
            f"{drv.tier.pool.nbytes()} bytes in the pinned pool; gate >= "
            f"{100 * TIER_SHARE:.0f}%)")
        if not share >= TIER_SHARE:
            fail(f"only {100 * share:.2f}% of the live postings spilled "
                 "after the load")

    if hook is not None:
        hook(drv, "load")
    q, recalls = stream_steps(drv, stream, secs, steps=steps, fresh=fresh,
                              dels=dels, queries=queries, next_id=n,
                              oldest=0, gate=gate, hook=hook, log=log)
    live = drv.live_count()
    want = int(drv.stats["inserted"] - drv.stats["deleted"])
    if live != want:
        fail(f"live_count {live} != inserted - deleted {want}")
    # the sharded rounds leave the free stack fail-safe EMPTY: the
    # invariants read a snapshot, which rebuilds and checks it; a
    # cluster's snapshot holds each worker's state, under its worker cfg
    if engine == "ubis-cluster":
        from repro_torch.core.types import IndexState
        snap = drv.snapshot()
        for st in getattr(snap, "states", [snap]):
            check_invariants(IndexState(**{k: v.to(dev) for k, v in
                                           vars(st).items()}),
                             drv._worker_cfg)
        del snap
    else:
        check_invariants(drv.snapshot() if engine == "ubis-sharded"
                         else drv.state, cfg)   # use_pq: codes == encode
    if tier:
        check_residency(drv.state, cfg, drv.tier.pool)
    if quant and drv.stats["pq_retrains"] < 1:
        fail("the quant path never re-trained its codebooks")
    return drv, q, secs, recalls, stream


def stream_steps(drv, stream, secs, *, steps: int, fresh: int, dels: int,
                 queries: int, next_id: int, oldest: int, gate: bool = True,
                 hook=None, log=say):
    """Streaming steps on ``drv``: each drifts the stream, inserts
    ``fresh`` vectors (ids from ``next_id``), deletes the ``dels`` oldest
    (ids from ``oldest``), ticks, searches ``queries`` at k=10 and holds
    the result against ``exact`` (recall@10 gated >= 0.9 unless ``gate``
    is false).  Adds the seconds to ``secs``; ``hook(drv, "step N")``
    runs after each step.  Returns (last queries, recalls); the next
    fresh id and the oldest live id are left on ``stream``."""
    from repro_torch.core import metrics

    def sync():
        if drv.device.type == "cuda":
            torch.cuda.synchronize()

    recalls = []
    for key in ("insert", "delete", "tick", "search", "exact"):
        secs.setdefault(key, 0.0)
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
        if hook is not None:
            hook(drv, f"step {step}")
    if found.shape != (queries, 10) or not np.isfinite(
            drv.exact(q[:4], 10).scores).all():
        fail("search/exact returned the wrong shape or non-finite scores")
    stream.next_id, stream.oldest = next_id, oldest   # where a caller resumes
    return q, recalls


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


def oracle_checks(ops, ref, fdrv, qdrv, fq_np, qq_np, log=say) -> dict:
    """Phase 3e, the unfused search oracle (tests/test_pq.py:104-130 on the
    card), with the launch counts reset before and read after.

    Float: ``centroid_score`` -> a stable top-``nprobe`` ->
    ``posting_scan_gather`` -> the cache scores -> a stable top-10 equals
    the fused ``search`` on the float state, ids and scores bit for bit
    (the gather and ``posting_scan_topk`` walk a row with one function,
    and ``centroid_topk`` ranks the very scores ``centroid_score``
    writes).
    Quant: ``pq_scan_gather`` on the search's own probes and tables -> a
    stable top-``rerank_k`` equals ``pq_scan_topk``'s candidates and
    scores exactly.  Each gather is also held against its plain version
    on the same inputs.  Returns the launch counts and the inputs phase 4
    times the two gathers on."""
    from repro_torch.core import version_manager as vm
    from repro_torch.core.search import search
    from repro_torch.quant import pq

    ops.reset_launch_counts()
    st, cfg = fdrv.state, fdrv.cfg
    q = torch.as_tensor(fq_np, device=fdrv.device)
    Q, k = q.shape[0], 10
    found, scores, _ = search(st, cfg, q, k)
    vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
    _, pr = ref.stable_topk(ops.centroid_score(q, st.centroids, vis),
                            cfg.nprobe)
    ps = ops.posting_scan_gather(q, st.vectors, st.slot_valid, vis, pr)
    cs = ops.centroid_score(q, st.cache_vecs, st.cache_valid)
    all_s = torch.cat([ps.reshape(Q, -1), cs], 1)
    all_i = torch.cat([st.ids[pr].reshape(Q, -1),
                       st.cache_ids.expand(Q, -1)], 1)
    want_s, idx = ref.stable_topk(all_s, k)
    want = torch.where(want_s < 5e29, torch.gather(all_i, 1, idx), -1)
    # one row walk scores the gather and the fused scan (row_score.cuh),
    # and one mainloop the cache's two calls: the composition is exact
    require_exact("oracle: fused search vs unfused composition",
                  (found, scores), (want, want_s))
    gather_err = require_close(
        "posting_scan_gather, oracle inputs", ps,
        ref.posting_scan_gather(q, st.vectors, st.slot_valid & vis[:, None],
                                pr))
    log(f"  float: fused search == unfused composition on {Q} queries, "
        f"ids and scores bit for bit; posting_scan_gather vs plain max err "
        f"{gather_err:.3g}")

    st, cfg = qdrv.state, qdrv.cfg
    qq = torch.as_tensor(qq_np, device=qdrv.device)
    _, _, probe = search(st, cfg, qq, k)
    qvis = vm.visible(st.rec_meta, st.allocated, st.global_version)
    luts = pq.lookup_tables(st.pq_codebooks, qq)
    C = st.vectors.shape[1]
    R = min(cfg.rerank_k, probe.shape[1] * C)
    adc, cand = ops.pq_scan_topk(luts, st.codes, st.pq_posting_slot,
                                 st.slot_valid, qvis, probe, k=R)
    g = ops.pq_scan_gather(luts, st.codes, st.pq_posting_slot,
                           st.slot_valid, qvis, probe)
    gs, pos = ref.stable_topk(g.reshape(Q, -1), R)
    flat = (probe.long()[:, :, None] * C
            + torch.arange(C, device=qq.device)[None, None, :])
    require_exact("oracle: pq_scan_topk vs pq_scan_gather + stable top-R",
                  (adc, cand.long()),
                  (gs, torch.gather(flat.reshape(Q, -1), 1, pos)))
    V = luts.shape[1]
    slot = st.pq_posting_slot.clamp(0, V - 1)
    require_exact("pq_scan_gather, oracle inputs", (g,),
                  (ref.pq_scan_gather(luts, st.codes, slot,
                                      st.slot_valid & qvis[:, None], probe),))
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    log(f"  quant: pq_scan_topk == pq_scan_gather + stable top-{R} on {Q} "
        f"queries (exact); launches {json.dumps(counts)}")
    for name in PATH_KERNELS["oracle"]:
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the oracle path")
    return counts, dict(q=q, probe=pr, vis=vis, qq=qq, qprobe=probe,
                        qvis=qvis, luts=luts)


def tier_checks(drv, secs, quant_secs, steps: int, log=say) -> None:
    """Phase 3f's end: the tier's counters, the memory split and search
    seconds per batch beside the untiered quant path's; then 64 postings'
    tiles copied, ``force_spill`` of the 64 coldest hot postings (those),
    ``force_promote`` of every spilled posting, and the 64 restored bit
    for bit; the spilled share restored with ``force_spill`` and the
    residency invariant checked again."""
    from repro_torch.core import version_manager as vm
    from repro_torch.core.invariants import check_residency
    st, tier = drv.state, drv.tier
    tiers = drv.memory_tiers()
    if tiers["device"] + tiers["host"] != drv.memory_bytes():
        fail(f"memory_tiers {tiers} do not sum to {drv.memory_bytes()}")
    log(f"  spilled share {100 * spilled_share(drv):.2f}%, pool "
        f"{len(tier.pool)} tiles / {tier.pool.nbytes()} bytes; counters "
        + json.dumps({k: drv.stats[k] for k in (
            "tier_spilled", "tier_promoted", "tier_resident",
            "search_spilled_hits")})
        + f"; memory_tiers {json.dumps(tiers)} (untiered "
        f"{drv.memory_bytes()})")
    log(f"  search seconds per 256-query batch: tiered "
        f"{secs['search'] / steps:.4f} (ADC + host rerank), untiered "
        f"quant path {quant_secs['search'] / steps:.4f}; exact "
        f"{secs['exact'] / steps:.4f} (device scan + host pool scan), "
        f"untiered {quant_secs['exact'] / steps:.4f}; host seconds, "
        "calls: " + ", ".join(f"{k} {v[0]:.4f}, {v[1]}"
                              for k, v in tier.host_s.items()))
    n_spilled = len(tier.pool)
    pids = tier.planner.force_spills(
        64, st.heat.cpu().numpy(), st.tier_spilled.cpu().numpy(),
        st.allocated.cpu().numpy(),
        vm.unpack_status(st.rec_meta).cpu().numpy())
    idx = torch.as_tensor(pids.astype(np.int64), device=drv.device)
    before = st.vectors[idx].clone()
    if not bool(before.any()):
        fail("tier round trip: the 64 tiles are all zero")
    was = st.tier_spilled.clone()
    if drv.force_spill(64) != 64:
        fail("force_spill(64) did not spill 64 postings")
    now = torch.nonzero(drv.state.tier_spilled & ~was)[:, 0]
    if not torch.equal(now, idx.sort().values):
        fail("force_spill(64) spilled other postings than the 64 coldest")
    if bool(drv.state.vectors[idx].any()):
        fail("force_spill left a device tile nonzero")
    n = drv.force_promote()
    if n != n_spilled + 64 or bool(drv.state.tier_spilled.any()):
        fail(f"force_promote moved {n}, expected {n_spilled + 64}")
    if not torch.equal(drv.state.vectors[idx], before):
        fail("spill + promote did not restore the 64 tiles bit for bit")
    log(f"  64 tiles spilled and promoted (with {n_spilled} others): "
        "bit-identical")
    drv.force_spill(n_spilled)
    check_residency(drv.state, drv.cfg, tier.pool)
    log(f"  respilled {n_spilled}: share {100 * spilled_share(drv):.2f}%, "
        "residency invariant holds")


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
    log(f"  launches on the serve path: {json.dumps(counts)}"
        + wide_text(ops))
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
# phase 3g: the front door
# ---------------------------------------------------------------------------

#: phase 3g's engine stream, per engine: (seed vectors, batches, inserts
#: and deletes a batch).  The graph baseline's insert path is host Python
#: (RobustPrune and its back-edges, about 4 ms an insert on the card's
#: host at a few thousand nodes), so its stream is a tenth as wide.  The
#: batches were cut from 10 (freshdiskann 8) to keep the whole run within
#: its budget beside phase 3h.
ENGINE_DEPTH = {"ubis": (20000, 5, 20000, 10000),
                "spfresh": (20000, 5, 20000, 10000),
                "ubis-sharded": (20000, 5, 20000, 10000),
                "ubis-cluster": (20000, 5, 20000, 10000),
                "spann": (20000, 5, 20000, 10000),
                "freshdiskann": (2048, 2, 2048, 1024)}
#: the stream's clusters: with nprobe = 32 the probes must cover a
#: query's neighbours (figengines' 32 clusters would put a few thousand
#: live vectors, tens of postings, in each)
ENGINE_CLUSTERS = 400
#: recall@10 floors against each engine's own exact(), those of the
#: contract harness (tests/contract_harness.py)
RECALL_FLOOR = {"ubis": 0.9, "spfresh": 0.9, "freshdiskann": 0.15,
                "spann": 0.8, "ubis-sharded": 0.9, "ubis-cluster": 0.9}
#: phase 3g's index configuration: the float path's
FRONT_CFG = dict(dim=128, max_postings=65504, capacity=96, l_min=10,
                 l_max=80, balance_factor=0.15, nprobe=32,
                 cache_capacity=4096, max_ids=1 << 21)
#: the kernels a cluster engine's stream must launch (freshdiskann's beam
#: search is plain tensor code, no kernel of the port)
ENGINE_KERNELS = ("centroid_score", "centroid_topk", "posting_scan",
                  "posting_scan_topk")


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def live_pairs(state) -> tuple:
    """(ids ascending, their vectors) over every live slot (visible
    postings and the cache), on the device: the live map id -> vector
    bytes.  Fails on a duplicated id."""
    vis = state.allocated & ((state.rec_meta & 3) != 3)
    slot = state.slot_valid & vis[:, None]
    ids = torch.cat([state.ids[slot], state.cache_ids[state.cache_valid]])
    vecs = torch.cat([state.vectors[slot],
                      state.cache_vecs[state.cache_valid]])
    order = torch.argsort(ids.long(), stable=True)
    ids, vecs = ids[order], vecs[order]
    if bool((ids[1:] == ids[:-1]).any()):
        fail("a live id is held twice")
    return ids, vecs


def same_live_map(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(live_pairs(a),
                                                  live_pairs(b)))


def window(fn) -> tuple:
    """Run ``fn`` under ``torch.profiler``: (wall seconds, device busy
    seconds or None where no device event reached ``key_averages``,
    [(kernel, device ms, calls)] by time).  Device-side events only: an
    aten op's own entry repeats the time of its kernels."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t
    rows = sorted(((ev.key, dev_us(ev) / 1e3, ev.count)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA")
                   and dev_us(ev) > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3 if rows else None
    return wall, busy, rows, prof


def busy_text(wall: float, busy) -> str:
    if busy is None:
        return "device busy not measured (no profiler events)"
    return f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%)"


def trace_audit(path: str, obs, live: int, log=say) -> None:
    """The JSONL sink holds one line per emitted event, its newest lines
    are the ring's events, and its insert/delete events sum to the live
    count (the index started empty)."""
    obs.tracer.close()
    with open(path) as f:
        evs = [json.loads(line) for line in f]
    ring = obs.events()
    if [e["seq"] for e in evs] != list(range(len(evs))) or (
            evs[-len(ring):] != ring or ring[-1]["seq"] + 1 != len(evs)):
        fail(f"the JSONL trace holds {len(evs)} lines, not one per event")
    net = (sum(e["accepted"] + e["cached"] for e in evs
               if e["kind"] == "insert")
           - sum(e["deleted"] for e in evs if e["kind"] == "delete"))
    kinds = {}
    for e in evs:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    log(f"  trace audit: {len(evs)} JSONL lines ({json.dumps(kinds)}), "
        f"{len(ring)} in the ring (capacity {obs.tracer.capacity}); "
        f"insert - delete events {net}, live {live}")
    if net != live:
        fail(f"the trace's insert/delete events sum to {net}, live {live}")
    os.remove(path)


def fused_path(dev, ops, fdrv, fsecs, seed: int, log=say) -> dict:
    """3g (1): the float path with ``fused_tick=True`` on 3a's seed,
    traced to a JSONL file: 3a's gates, 3a's final live map, the float
    path's kernels, the trace audit; then one more identical step on both
    drivers and its tick profiled, fused against unfused.  Returns the
    launch counts."""
    from repro_torch.obs import Obs
    path = os.path.join(ROOT, "chiprun_out", "front_door_trace.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    obs = Obs(trace_path=path)
    ops.reset_launch_counts()
    drv, _, secs, recalls, _ = main_path(
        dev, n=1_000_000, dim=128, max_postings=65504, cache_capacity=4096,
        steps=5, fresh=20000, dels=10000, queries=256, chunk=20000,
        seed=seed, round_size=2048, bg_ops=64,
        index_kw=dict(fused_tick=True, obs=obs), log=log)
    launched = ops.launch_counts()
    log(f"  launches on the fused path: {json.dumps(launched)}"
        + wide_text(ops))
    for name in PATH_KERNELS["float"]:
        if launched[name] <= 0:
            fail(f"kernel {name} was never launched on the fused path")
    if not drv.fused_tick:
        fail("the fused driver does not run fused_tick")
    if not same_live_map(drv.state, fdrv.state):
        fail("fused_tick's live map differs from the unfused float path's")
    log(f"  live map (id -> vector bytes) equal to 3a's: "
        f"{drv.live_count()} ids; recall@10 per step {recalls}")
    trace_audit(path, obs, drv.live_count(), log)
    for label, s in (("unfused (3a)", fsecs), ("fused", secs)):
        log(f"  {label}: load {s['load']:.3f} s (ticks included), the "
            f"steps' ticks {s['tick']:.4f} s, inserts {s['insert']:.3f} s")
    extra = Stream(128, 2000, seed + 7)
    x = extra.draw(20000)
    for label, d in (("unfused (3a)", fdrv), ("fused", drv)):
        d.insert(x, np.arange(1_500_000, 1_520_000))
        d.delete(np.arange(100_000, 110_000))
        box = []
        wall, busy, rows, _ = window(lambda: box.append(d.tick()))
        r = box[0]
        log(f"  one tick after one more step, {label}: wall {wall:.4f} s, "
            f"{busy_text(wall, busy)}, "
            f"executed {r.executed}, drained {r.drained}, marked "
            f"{r.marked}; top: " + ", ".join(
                f"{k[:40]} {ms:.3f} ms" for k, ms, _ in rows[:3]))
    del drv
    torch.cuda.empty_cache()
    return launched


def settle(idx, most: int = 64) -> int:
    """Tick until quiescent (no op executed, marked or migrated), at most
    ``most`` ticks, as the float path's load does after each chunk; the
    build-once and graph engines' ticks do nothing and stop at once."""
    for i in range(most):
        r = idx.tick()
        if r.executed == 0 and r.marked == 0 and r.migrated == 0:
            return i + 1
    return most


def engine_streams(dev, ops, seed: int, log=say) -> dict:
    """3g (2): every engine of ``list_engines()`` through one kwargs dict
    over a ``DriftingVectorStream`` at the float path's width: per batch
    inserts, deletes of the oldest live ids, ticks until quiescent, a
    256-query search at k = 10 and ``exact``.  Gates: the contract harness's recall floor
    at every batch, ``live_count()`` = inserted - deleted (spann: its
    build count, every update refused), deleted ids never returned, and
    the cluster engines' kernels launched.  Returns the launch counts."""
    from repro_torch.api import list_engines, make_index
    from repro_torch.core import metrics
    from repro_torch.core.types import UBISConfig
    from repro_torch.data import DriftingVectorStream
    cfg = UBISConfig(**FRONT_CFG)
    kw = dict(device=dev, seed=seed, round_size=2048, bg_ops_per_round=64,
              drain_per_tick=2048)
    counts = {}
    for spec in list_engines():
        name = spec.name
        n_seed, batches, ins, dels = ENGINE_DEPTH[name]
        log(f"  {name} ({spec.audit} audit): {n_seed} seed vectors, "
            f"{batches} batches of {ins} inserts and {dels} deletes")
        stream = DriftingVectorStream(dim=128, n_clusters=ENGINE_CLUSTERS,
                                      seed=seed)
        seeds = stream.next_batch(n_seed)
        ops.reset_launch_counts()
        t = time.perf_counter()
        idx = make_index(name, cfg, seeds, seed_ids=np.arange(n_seed), **kw)
        sync()
        secs = dict(build=time.perf_counter() - t, insert=0.0, delete=0.0,
                    tick=0.0, search=0.0, exact=0.0)
        live = (np.arange(n_seed) if spec.audit != "state"
                else np.zeros(0, np.int64))
        deleted = np.zeros(0, np.int64)
        next_id, recalls = n_seed, []

        def timed(key, fn):
            t = time.perf_counter()
            out = fn()
            sync()
            secs[key] += time.perf_counter() - t
            return out
        for b in range(batches):
            x = stream.next_batch(ins)
            ids = np.arange(next_id, next_id + ins)
            next_id += ins
            r = timed("insert", lambda: idx.insert(x, ids))
            if not spec.updatable:
                if (r.accepted, r.cached, r.rejected) != (0, 0, ins):
                    fail(f"{name} applied an insert: {r}")
            else:
                applied = np.ones(ins, bool)
                if r.rejected:
                    loc = idx.state.id_loc
                    applied = (loc[torch.as_tensor(ids, device=loc.device)]
                               .cpu().numpy() != -1)
                if int(applied.sum()) != r.accepted + r.cached:
                    fail(f"{name}: insert counts {r} disagree with the "
                         "id map")
                live = np.concatenate([live, ids[applied]])
            picks = live[:dels]
            r = timed("delete", lambda: idx.delete(picks))
            if not spec.updatable:
                if (r.deleted, r.blocked) != (0, len(picks)):
                    fail(f"{name} applied a delete: {r}")
            else:
                if r.blocked:
                    idx.flush(max_ticks=40)
                    r.deleted += idx.delete(picks).deleted
                if r.deleted != len(picks):
                    fail(f"{name} deleted {r.deleted} of {len(picks)}")
                live, deleted = live[dels:], np.concatenate([deleted, picks])
            timed("tick", lambda: settle(idx))
            q = stream.queries(256)
            found = timed("search", lambda: idx.search(q, 10)).ids
            truth = timed("exact", lambda: idx.exact(q, 10)).ids
            rec = metrics.recall_at_k(found, truth)
            recalls.append(round(rec, 4))
            if not rec >= RECALL_FLOOR[name]:
                fail(f"{name}: recall@10 {rec:.4f} < {RECALL_FLOOR[name]} "
                     f"at batch {b}")
            if np.isin(found, deleted).any():
                fail(f"{name}: a deleted id came back from search")
            if found.shape != (256, 10):
                fail(f"{name}: search returned shape {found.shape}")
        if idx.live_count() != len(live):
            fail(f"{name}: live_count {idx.live_count()} != {len(live)}")
        launched = ops.launch_counts()
        if name != "freshdiskann":
            for k in ENGINE_KERNELS:
                if launched[k] <= 0:
                    fail(f"kernel {k} was never launched by {name}")
        log(f"    seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})}"
            f"; recall@10 {recalls} (floor {RECALL_FLOOR[name]}); live "
            f"{idx.live_count()} (stats: inserted "
            f"{idx.stats['inserted']:.0f}, rejected "
            f"{idx.stats['rejected']:.0f}, deleted "
            f"{idx.stats['deleted']:.0f}); memory_bytes "
            f"{idx.memory_bytes()}; "
            f"launches {json.dumps({k: v for k, v in launched.items() if v})}")
        counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
        del idx
        torch.cuda.empty_cache()
    return counts


def sequential_checks(dev, ops, seed: int, log=say) -> dict:
    """3g (3): the sequential single-posting ops against one batched
    ``background_round`` on the card, on a state at the float path's
    width (d = 128, capacity 96) marked as the driver marks: a load
    without ticks (oversize postings) and random deletes (tombstones,
    small postings).  The two states hold the same live map (id ->
    vector bytes; posting ids may differ, as the batch resolves
    conflicts explicitly), equal to the marked state's, and both pass the
    invariants.  Returns the launch counts."""
    from repro_torch.api import make_index
    from repro_torch.core import balance, update
    from repro_torch.core.invariants import check_invariants
    from repro_torch.core.types import (KIND_COMPACT, KIND_MERGE, KIND_SPLIT,
                                        STATUS_MERGING, STATUS_SPLITTING,
                                        UBISConfig)
    cfg = UBISConfig(**dict(FRONT_CFG, max_postings=4096))
    ops.reset_launch_counts()
    stream = Stream(128, 400, seed + 11)
    drv = make_index("ubis", cfg, stream.draw(20000), device=dev, seed=seed,
                     round_size=2048, bg_ops_per_round=64)
    drv.insert(stream.draw(22000), np.arange(22000), tick_between=False)
    drv.delete(np.random.default_rng(seed).choice(22000, 3000,
                                                  replace=False))
    st = drv.state
    split_due, merge_due, compact_due = (
        x.cpu().numpy() for x in balance.detect(st, cfg))
    lengths = st.lengths.cpu().numpy()
    split = np.flatnonzero(split_due)
    split = split[np.argsort(-lengths[split])]
    merge = np.flatnonzero(merge_due)
    merge = merge[np.argsort(lengths[merge])]
    jobs = ([("split", int(p)) for p in split]
            + [("compact", int(p)) for p in np.flatnonzero(compact_due)]
            + [("merge", int(p)) for p in merge])
    seen, picked = set(), []
    for kind, p in jobs:
        if p not in seen:
            seen.add(p)
            picked.append((kind, p))
    jobs = picked[:64]
    for status, kinds_ in ((STATUS_SPLITTING, ("split", "compact")),
                           (STATUS_MERGING, ("merge",))):
        pids = [p for k, p in jobs if k in kinds_]
        if pids:
            st = update.mark_status(st, torch.tensor(pids, device=dev),
                                    status)
    drv.state = st
    code = {"split": KIND_SPLIT, "merge": KIND_MERGE,
            "compact": KIND_COMPACT}
    kinds = torch.tensor([code[k] for k, _ in jobs], device=dev)
    pids = torch.tensor([p for _, p in jobs], device=dev)
    by_kind = {k: sum(1 for j, _ in jobs if j == k) for k in code}
    if not (by_kind["split"] and by_kind["merge"]):
        fail(f"the marked batch lacks splits or merges: {by_kind}")
    t = time.perf_counter()
    seq = balance.execute_sequential(drv.snapshot(), cfg, jobs)
    sync()
    t_seq = time.perf_counter() - t
    t = time.perf_counter()
    bat, rr = balance.background_round(drv.snapshot(), cfg, kinds, pids)
    sync()
    t_bat = time.perf_counter() - t
    for label, out in (("sequential", seq), ("batched", bat)):
        check_invariants(out, cfg)
        if not same_live_map(out, st):
            fail(f"the {label} execution changed the live map")
    rr = rr.to_host()
    log(f"  marked batch {json.dumps(by_kind)} on {drv.live_count()} live "
        f"vectors: sequential {t_seq:.3f} s, batched {t_bat:.3f} s "
        f"(executed {rr['executed']}, deferred {rr['deferred']}); live "
        "maps equal, invariants hold")
    del drv, seq, bat
    torch.cuda.empty_cache()
    return ops.launch_counts()


# ---------------------------------------------------------------------------
# phase 3h: the sharded plane, S logical shards of the card
# ---------------------------------------------------------------------------

#: model-axis shards of phase 3h (16,376 postings a shard at 65,504)
SHARDS = 4
#: 3h-1's load: 500,000 seed vectors seed 8,929 postings, every one on
#: shard 0 (contiguous pids), so thousands of postings must move before
#: the shards' live vectors are within ``rebalance_ratio``
SHARD_LOAD = 500_000
#: 3h-1/3h-2's ``migrate_per_tick``
SHARD_MIGRATE = 512
#: 3h-3, figskew's stream at d = 128: (clusters, Zipf exponent, vectors,
#: batches, ``migrate_per_tick``, ticks a flush at most, the wider nprobe
#: of the ungated recall)
SKEW = dict(clusters=16, zipf=1.5, n=200_000, batches=10, migrate=256,
            flush=32, wide=128)
#: the kernels the sharded planes must launch
SHARD_KERNELS = {"float": ("centroid_score", "centroid_topk",
                           "posting_scan_topk", "posting_scan"),
                 "quant": ("centroid_score", "centroid_topk",
                           "pq_scan_topk", "rerank_topk", "kmeans_assign")}


#: shapes a kernel that ``held_on_path`` holds against its plain version:
#: the first call at each new shape, up to this many shapes a kernel on
#: each device
HELD_SHAPES = 8
#: rows of a ``kmeans_assign`` call that ``held_on_path`` compares (rows
#: are independent; a full re-encode's plain version would score every
#: row against every codeword at once)
HELD_ASSIGN_ROWS = 8192


def _rescored_picks(name, got, score_of, label) -> None:
    """A top-k kernel's picks rescored by the plain arithmetic: each pick
    with a real score (< BIG/2) scores what the kernel says, within the
    tolerance, and no real pick repeats."""
    s, i = got[0], got[1].long()
    real = s < 5e29
    again = torch.where(real, score_of(torch.where(real, i, 0)), s)
    require_close(f"{name} picks [{label}]", s, again)
    fill = -1 - torch.arange(i.shape[1], device=i.device)[None, :]
    srt = torch.where(real, i, fill).sort(-1).values
    if (srt.diff(dim=-1) == 0).any():
        fail(f"{name} [{label}]: the kernel returned a duplicate id")


def _hold(name, ref, b, got, want) -> str:
    """``got`` (the kernel) against ``want`` (the plain version) on the
    bound arguments ``b`` of one ``ops`` call; returns what was held."""
    a = b.arguments
    shapes = "x".join(str(tuple(v.shape)) for v in a.values()
                      if torch.is_tensor(v))
    if name == "flash_attention":
        label = (f"{shapes} causal={a.get('causal', True)} "
                 f"window={a.get('window')}")
        require_attn_close(f"{name} [{label}]", got, want)
        return label
    label = shapes + (f" k={a['k']}" if "k" in a else "")
    if name in ("centroid_score", "posting_scan"):
        require_close(f"{name} [{label}]", got, want)
        return label
    if name == "pq_scan_topk":
        require_exact(f"{name} [{label}]", got, want)
        ok = a.get("qp_ok")
        return label + ("" if ok is None else
                        f", qp_ok {float(ok.float().mean()):.3f} set")
    require_close(f"{name} [{label}]", got[0], want[0])
    q = a["q"]
    if name == "centroid_topk":
        c = a["c"]
        vis = a.get("vis")
        full = ref.centroid_score(q, c, torch.ones(
            c.shape[0], dtype=torch.bool, device=c.device) if vis is None
            else vis)
        _rescored_picks(name, got, lambda i: torch.gather(full, 1, i), label)
        return label
    vec = a["vectors"]
    M, C, d = vec.shape
    flat = vec.reshape(M * C, d)

    def plain_score(i):
        v = flat[i]
        return (v * v).sum(-1) - 2 * torch.einsum("qd,qkd->qk", q, v)
    if name == "posting_scan_topk":
        probe = a["probe"].long()
        ok = a.get("qp_ok")
        ok = torch.ones(probe.shape, dtype=torch.bool, device=q.device) \
            if ok is None else ok.bool()
        vis = (a["slot_valid"] & a["vis"][:, None]).reshape(-1)

        def score_of(i):
            # a pick lies in a probed posting the query owns, in a valid slot
            owned = ((probe[:, None, :] == (i // C)[:, :, None])
                     & ok[:, None, :]).any(-1)
            return torch.where(owned & vis[i], plain_score(i), 1e30)
        _rescored_picks(name, got, score_of, label)
        return label + f", qp_ok {float(ok.float().mean()):.3f} set"
    # rerank_topk: a pick is one of the ADC stage's candidates, rescored
    # as the plain version rescores it (a spilled posting keeps its ADC
    # score)
    cand, adc = a["cand"].long(), a["adc"].float()
    spilled = a["tier_spilled"]

    def score_of(i):
        hit = cand[:, None, :] == i[:, :, None]
        pos = hit.int().argmax(-1)
        ad = torch.gather(adc, 1, pos)
        s = torch.where(spilled[i // C], ad, plain_score(i))
        return torch.where(hit.any(-1) & (ad < 5e29), s, 1e30)
    _rescored_picks(name, got, score_of, label)
    return label


@contextmanager
def held_on_path(ops, ref, names, log=say):
    """While the block runs, the first call at each new shape (up to
    ``HELD_SHAPES`` a kernel on each device) that the path makes through
    ``ops`` to a kernel in ``names`` is held against the wrapper's plain
    version on the same tensors before the path sees its result: the
    path's own shapes and masks (the shard-local pools, the ownership
    masks).  The kernel's launch is the path's and counts; the plain
    version launches nothing.  On exit, fails unless every kernel of
    ``names`` was held at least once; prints what was held."""
    import inspect
    held = {n: [] for n in names}
    saved = {n: getattr(ops, n) for n in names}

    def plain(fn, *args, **kw):
        with mock.patch.object(ops, "_on_card", lambda *t: False):
            return fn(*args, **kw)

    def wrap(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            out = fn(*args, **kw)
            b = sig.bind(*args, **kw)
            first = next(v for v in b.arguments.values()
                         if torch.is_tensor(v))
            key = (str(first.device),) + tuple(
                (k, tuple(v.shape)) if torch.is_tensor(v) else (k, v)
                for k, v in b.arguments.items())
            seen = held[name]
            on_dev = [s[0] for s in seen if s[0][0] == key[0]]
            if len(on_dev) >= HELD_SHAPES or key in on_dev:
                return out
            if name == "kmeans_assign":
                pts, cen, msk = (b.arguments["points"],
                                 b.arguments["centroids"],
                                 b.arguments.get("mask"))
                n = min(pts.shape[-2], HELD_ASSIGN_ROWS)
                sub = (pts[..., :n, :], cen, None if msk is None
                       else msk[:n])
                want = plain(fn, *sub)
                g = (out[0][..., :n], out[1][..., :n])
                p3, c3 = (sub[0] if pts.dim() == 3 else sub[0][None],
                          cen if cen.dim() == 3 else cen[None])
                p3 = p3[torch.arange(c3.shape[0]) % p3.shape[0]]
                cf = c3.float()
                full = ((cf * cf).sum(-1)[:, None, :]
                        - 2.0 * torch.bmm(p3.float(), cf.transpose(1, 2)))
                if pts.dim() == 2:
                    full = full[0]
                label = f"{tuple(pts.shape)}x{tuple(cen.shape)}, {n} rows"
                check_assign(f"kmeans_assign [{label}]", g, want, full)
                del full
            else:
                want = plain(fn, *args, **kw)
                label = _hold(name, ref, b, out, want)
            del want
            if first.device.index:          # a card past the first
                label = f"{label} on {first.device}"
            seen.append((key, label))
            return out
        return call

    with mock.patch.multiple(ops, **{n: wrap(n, f)
                                     for n, f in saved.items()}):
        yield held
    for n, seen in held.items():
        if not seen:
            fail(f"kernel {n} was never held against its plain version on "
                 "this path's inputs")
        log(f"  {n} held against its plain version on the path's inputs: "
            + "; ".join(lbl for _, lbl in seen))


def shard_mesh(dev):
    from repro_torch.distributed import make_mesh
    return make_mesh((1, SHARDS), ("data", "model"), device=dev)


def audit_placement(sh) -> None:
    """Every tensor of shard s on ``mesh.devices[s]`` and no two shards
    sharing a storage (``core.sharded.audit_placement``), or fail."""
    from repro_torch.core import sharded
    try:
        sharded.audit_placement(sh)
    except AssertionError as e:
        fail(f"sharded placement: {e}")


def audit_pressure(drv) -> None:
    """Record, at every background program, the pressure rows' live
    vectors beside the live postings' total at that moment
    (``drv.pressure_audit``)."""
    drv.pressure_audit = []
    inner = drv.exec_background

    def run():
        ex, gc, press = inner()
        drv.pressure_audit.append((int(press[:, 3].sum()),
                                   int(drv.state.live_vector_count())))
        return ex, gc, press
    drv.exec_background = run


def shard_hook(log=say):
    """main_path's hook for a sharded driver: the replicas identical and
    the pressure rows equal to the live postings' vectors at every tick
    so far; prints the occupancy and the migrations."""
    def hook(drv, stage):
        if stage == "built":
            audit_pressure(drv)
            return
        drv.check_replicas()
        audit_placement(drv.sharded)
        bad = [a for a in drv.pressure_audit if a[0] != a[1]]
        if bad:
            fail(f"pressure rows disagree with the live postings {stage}: "
                 f"{bad[:3]}")
        n = len(drv.pressure_audit)
        drv.pressure_audit.clear()
        log(f"  {stage}: replicas identical; every shard's tensors on its "
            f"device, in storage of its own; {n} ticks' pressure rows = "
            f"live postings' vectors; occupancy "
            f"{drv.shard_occupancy().tolist()}, migrated "
            f"{drv.stats['migrated']:.0f}, rejected "
            f"{drv.stats['rejected']:.0f}")
    return hook


def exact_against_brute_force(drv, q_np, log=say) -> None:
    """The sharded ``exact`` against the single-device ``brute_force`` of
    the snapshot on the same queries (32 a chunk): equal ids, or at a
    differing position scores within the tolerance (a near-tie)."""
    from repro_torch.core.search import brute_force
    snap = drv.snapshot()
    got = drv.exact(q_np, 10)
    ids, scores = [], []
    for off in range(0, len(q_np), 32):
        f, s = brute_force(snap, drv.cfg, torch.as_tensor(
            q_np[off:off + 32], device=drv.device), 10)
        ids.append(f.cpu().numpy())
        scores.append(s.cpu().numpy())
    ids, scores = np.concatenate(ids), np.concatenate(scores)
    del snap
    torch.cuda.empty_cache()
    diff = got.ids != ids
    tol = TOL * score_scale(torch.from_numpy(scores))
    gap = float(np.abs(got.scores - scores)[diff].max()) if diff.any() \
        else 0.0
    if diff.any() and not gap <= tol:
        fail(f"sharded exact differs from brute_force at {int(diff.sum())} "
             f"positions, score gap {gap:.3g} > {tol:.3g}")
    log(f"  sharded exact vs single-device brute_force of the snapshot: "
        f"{int(diff.sum())} of {diff.size} ids differ (near-ties, score gap "
        f"{gap:.3g} <= {tol:.3g}); max score err "
        f"{float(np.abs(got.scores - scores).max()):.3g}")


def sharded_path(dev, ops, qpath, seed: int, log=say):
    """Phase 3h-1 and 3h-2.  Returns (launches, the float driver, its
    stream, per-phase seconds)."""
    from repro_torch.api import make_index
    from repro_torch.core.invariants import check_invariants
    from repro_torch.kernels import ref
    mesh = shard_mesh(dev)
    launches = {}

    def need(label, launched):
        for name in SHARD_KERNELS[label]:
            if launched[name] <= 0:
                fail(f"kernel {name} was never launched on the sharded "
                     f"{label} path")
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v

    log(f"  3h-1: float, {SHARD_LOAD:,} x 128-d, {SHARDS} shards, "
        f"migrate_per_tick {SHARD_MIGRATE}")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with held_on_path(ops, ref, SHARD_KERNELS["float"], log):
        drv, q, secs, recalls, stream = main_path(
            dev, n=SHARD_LOAD, dim=128, max_postings=65504,
            cache_capacity=4096, steps=3, fresh=20000, dels=10000,
            queries=256, chunk=20000, seed=seed, round_size=2048, bg_ops=64,
            engine="ubis-sharded", hook=shard_hook(log), log=log,
            index_kw=dict(mesh=mesh, migrate_per_tick=SHARD_MIGRATE))
    launched = ops.launch_counts()
    log(f"  seconds per phase: "
        f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    log(f"  launches on the sharded float path: {json.dumps(launched)}"
        + wide_text(ops))
    need("float", launched)
    placement_line(drv.sharded, log)
    exact_against_brute_force(drv, q, log)
    log(f"  recall@10 per step (gated >= 0.9): {recalls}; live "
        f"{drv.live_count()}; migrated {drv.stats['migrated']:.0f}; "
        f"pressure rows {drv.shard_pressure().tolist()}; 3h-1 "
        f"{time.perf_counter() - t0:.1f} s")

    qdrv, qstream = qpath
    log(f"  3h-2: the quant path's state adopted on {SHARDS} shards "
        "(load_snapshot), 2 steps")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    sq = make_index("ubis-sharded", qdrv.cfg, qstream.draw(1000), device=dev,
                    seed=seed, mesh=mesh, round_size=2048,
                    bg_ops_per_round=64, drain_per_tick=2048,
                    migrate_per_tick=SHARD_MIGRATE)
    audit_pressure(sq)
    sq.load_snapshot(qdrv.snapshot())
    live0 = sq.live_count()
    shard_hook(log)(sq, "adopted")
    qsecs = {}
    with held_on_path(ops, ref, SHARD_KERNELS["quant"], log):
        _, qrecalls = stream_steps(sq, qstream, qsecs, steps=2, fresh=20000,
                                   dels=10000, queries=256,
                                   next_id=qstream.next_id,
                                   oldest=qstream.oldest,
                                   hook=shard_hook(log), log=log)
    launched = ops.launch_counts()
    log(f"  seconds per phase: "
        f"{json.dumps({k: round(v, 3) for k, v in qsecs.items()})}")
    log(f"  launches on the sharded quant path: {json.dumps(launched)}"
        + wide_text(ops))
    need("quant", launched)
    want = live0 + int(sq.stats["inserted"] - sq.stats["deleted"])
    if sq.live_count() != want:
        fail(f"sharded quant live_count {sq.live_count()} != {want}")
    check_invariants(sq.snapshot(), sq.cfg)     # with the codes invariant
    log(f"  recall@10 per step (gated >= 0.9): {qrecalls}; live "
        f"{sq.live_count()}; migrated {sq.stats['migrated']:.0f}; "
        f"invariants and codes hold; 3h-2 {time.perf_counter() - t0:.1f} s")
    del sq
    torch.cuda.empty_cache()
    return launches, drv, stream, secs


def placement_line(sh, log=say) -> None:
    """Audit the cells' placement and print what was audited."""
    from repro_torch.core.sharded import FIELDS
    audit_placement(sh)
    tensors = [getattr(st, f) for row in sh.rows for st in row.shards
               for f in FIELDS]
    stores = {(t.device, t.untyped_storage().data_ptr()) for t in tensors
              if t.numel()}
    log(f"  {sh.n_rows} x {sh.n_shards} placement audit: {len(tensors)} "
        f"tensors, each on its cell's device "
        f"({', '.join(str(d) for d in sh.devices)}), {len(stores)} "
        "storages, none shared by two cells")


def skew_runs(dev, ops, seed: int, log=say) -> dict:
    """Phase 3h-3: figskew's three runs at d = 128 on ``SHARDS`` shards;
    each batch inserted, then flushed.  A fourth, uniform with rebalance
    off, and each run's recall at nprobe ``SKEW["wide"]`` beside the
    gated nprobe (reported, not gated) tell a recall lost to migration
    from one lost to the stream.  Returns the launches."""
    from repro_torch.api import make_index
    from repro_torch.core import metrics
    from repro_torch.core.types import UBISConfig
    mesh = shard_mesh(dev)
    cfg = UBISConfig(dim=128, max_postings=65504, capacity=96, l_min=10,
                     l_max=80, nprobe=32, cache_capacity=4096,
                     max_ids=1 << 21)
    K, per = SKEW["clusters"], SKEW["n"] // SKEW["batches"]
    rng = np.random.default_rng(seed + 13)
    cents = (rng.standard_normal((K, 128)) * 5).astype(np.float32)
    queries = (cents[rng.integers(0, K, 256)]
               + rng.standard_normal((256, 128))).astype(np.float32)

    def draw(kind, n):
        if kind == "uniform":
            a = rng.integers(0, K, n)
        else:
            w = 1.0 / (np.arange(K) + 1) ** SKEW["zipf"]
            a = rng.choice(K, size=n, p=w / w.sum())
        return (cents[a] + rng.standard_normal((n, 128))).astype(np.float32)

    ops.reset_launch_counts()
    res = {}
    for kind, reb in (("uniform", True), ("zipf", True), ("zipf", False),
                      ("uniform", False)):
        t0 = time.perf_counter()
        batches = [draw(kind, per) for _ in range(SKEW["batches"])]
        drv = make_index("ubis-sharded", cfg, batches[0], device=dev,
                         seed=seed, mesh=mesh, round_size=2048,
                         bg_ops_per_round=64, drain_per_tick=2048,
                         migrate_per_tick=SKEW["migrate"], rebalance=reb)
        audit_pressure(drv)
        ticks = 0
        for bi, b in enumerate(batches):
            drv.insert(b, np.arange(bi * per, (bi + 1) * per))
            ticks += drv.flush(max_ticks=SKEW["flush"])
        shard_hook(lambda m: None)(drv, f"{kind}/{reb}")
        if drv.live_count() != int(drv.stats["inserted"]):
            fail(f"skew {kind}: live_count {drv.live_count()} != inserted "
                 f"{drv.stats['inserted']:.0f}")
        truth = drv.exact(queries, 10).ids
        rec = metrics.recall_at_k(drv.search(queries, 10).ids, truth)
        wide = metrics.recall_at_k(
            drv.search(queries, 10, nprobe=SKEW["wide"]).ids, truth)
        spread = metrics.occupancy_spread(drv.shard_occupancy())
        name = f"{kind}/{'on' if reb else 'off'}"
        res[name] = dict(recall=rec, recall_wide=wide,
                         migrated=int(drv.stats["migrated"]),
                         rejected=int(drv.stats["rejected"]), ticks=ticks,
                         occupancy=drv.shard_occupancy().tolist(),
                         seconds=time.perf_counter() - t0, **spread)
        log(f"  3h-3 {name}: {json.dumps(res[name])}")
        del drv
        torch.cuda.empty_cache()
    z, u = res["zipf/on"], res["uniform/on"]
    if not z["occ_ratio"] <= 1.5:
        fail(f"zipf/on max/min occupancy {z['occ_ratio']:.3f} > 1.5")
    if not z["migrated"] > 0:
        fail("zipf/on migrated nothing")
    if not z["recall"] >= u["recall"] - 0.02:
        fail(f"zipf/on recall@10 {z['recall']:.4f} more than 2 points under "
             f"uniform/on's {u['recall']:.4f}")
    log(f"  3h-3 gates: zipf/on max/min {z['occ_ratio']:.3f} <= 1.5, "
        f"migrated {z['migrated']}, recall@10 {z['recall']:.4f} vs uniform "
        f"{u['recall']:.4f} (zipf/off, not gated: max/min "
        f"{res['zipf/off']['occ_ratio']:.3f})")
    log(f"  3h-3 recall@10 at nprobe {cfg.nprobe} / {SKEW['wide']} (not "
        "gated): " + ", ".join(f"{n} {r['recall']:.4f} / "
                               f"{r['recall_wide']:.4f}"
                               for n, r in res.items()))
    log("  3h-3 launches" + wide_text(ops))
    return ops.launch_counts()


# ---------------------------------------------------------------------------
# phase 3k: the sharded plane with one shard a card
# ---------------------------------------------------------------------------

def card(i: int) -> torch.device:
    return torch.device("cuda", i)


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


#: 3k's quant leg: the first batches of the Zipf stream (of ``SKEW``'s
#: ten) and its codebook re-train cadence in ticks
SKEW_QUANT = dict(batches=4, retrain=4)


def gather_witness(drv, queries, quant: bool, log=say) -> None:
    """The unfused gather of the plane (``posting_scan_gather`` or
    ``pq_scan_gather``) launched on the last shard's own state, on its
    card, and held against its plain version on the same inputs: the
    per-device opt-in and grid cache of a gather past the first card.
    Made after the path's launches were read, so it does not count."""
    from repro_torch.core import version_manager as vm
    from repro_torch.kernels import ops, ref
    from repro_torch.quant import pq
    row = drv.sharded.row(0)
    s = row.n_shards - 1
    st, dev = row.local(s), row.devices[s]
    with row.on(s):
        q = torch.as_tensor(queries, device=dev)
        vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
        _, pr = ref.stable_topk(ref.centroid_score(q, st.centroids, vis),
                                min(drv.cfg.nprobe, row.pool))
        valid = st.slot_valid & vis[:, None]
        if quant:
            luts = pq.lookup_tables(st.pq_codebooks, q)
            slot = st.pq_posting_slot.clamp(0, luts.shape[1] - 1)
            name = "pq_scan_gather"
            got = ops.pq_scan_gather(luts, st.codes, st.pq_posting_slot,
                                     st.slot_valid, vis, pr)
            require_exact(f"{name} on {dev}", (got,),
                          (ref.pq_scan_gather(luts, st.codes, slot, valid,
                                              pr),))
            err = 0.0
        else:
            name = "posting_scan_gather"
            got = ops.posting_scan_gather(q, st.vectors, st.slot_valid, vis,
                                          pr)
            err = require_close(f"{name} on {dev}", got,
                                ref.posting_scan_gather(q, st.vectors, valid,
                                                        pr))
        torch.cuda.synchronize(dev)
    log(f"  {name} on shard {s}'s state on {dev} {tuple(got.shape)}: "
        f"held against its plain version (max err {err:.3g}"
        f"{', exact' if quant else ''})")


#: ``exact``'s kernel: ``exact`` runs on row 0 alone, so on a grid this
#: kernel is held on the last row's card apart from the path
#: (:func:`exact_witness`)
EXACT_KERNELS = ("posting_scan",)


def exact_witness(drv, queries, log=say) -> None:
    """``exact``'s kernel launched on the last row's last shard, on its
    card, and held against its plain version on the same inputs: a
    grid's ``exact`` runs on row 0, so the path never launches it
    there.  Made after the path's launches were read, so it does not
    count."""
    from repro_torch.core import version_manager as vm
    from repro_torch.kernels import ops, ref
    row = drv.sharded.row(drv.sharded.n_rows - 1)
    s = row.n_shards - 1
    st, dev = row.local(s), row.devices[s]
    with row.on(s):
        q = torch.as_tensor(queries, device=dev)
        vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
        valid = st.slot_valid & (vis & ~st.tier_spilled)[:, None]
        got = ops.posting_scan(q, st.vectors, valid)
        err = require_close(f"posting_scan on {dev}", got,
                            ref.posting_scan(q, st.vectors, valid))
        torch.cuda.synchronize(dev)
    log(f"  posting_scan on row {drv.sharded.n_rows - 1}'s shard {s} on "
        f"{dev} {tuple(got.shape)}: held against its plain version (max "
        f"err {err:.3g})")


def skew_layouts(ops, ref, phase: str, plane: str, cfg, batches, queries,
                 meshes: dict, seed: int, log=say, held_on=None,
                 witness: bool = False, **kw) -> dict:
    """One plane of a layout comparison (phases 3k and 3l): the stream
    on each mesh of ``meshes`` (label -> mesh, two of them: the layout
    it is held to, then the layout under test), every batch inserted,
    flushed and followed by the rows' and replicas' check; the two runs'
    search and exact ids and scores, stats, occupancy and every snapshot
    field equal bit for bit.  The run under test is the path: its
    launches are counted from zero, every kernel of
    ``SHARD_KERNELS[plane]`` must launch, and each is held against its
    plain version on its inputs, at least once on a device of
    ``held_on`` (device names) where given.  ``witness``: each plane's
    gather on the last shard's card too.  Returns the path's launches."""
    from repro_torch.api import make_index
    from repro_torch.core import metrics
    from repro_torch.core.sharded import FIELDS
    cards = torch.cuda.device_count()
    per = len(batches[0])
    names = SHARD_KERNELS[plane]
    runs, launched = {}, {}
    (base, _), (test, _) = list(meshes.items())
    for label, mesh in meshes.items():
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        path = label == test
        held = (held_on_path(ops, ref, names, log) if path
                else nullcontext())
        with held as seen:
            drv = make_index("ubis-sharded", cfg, batches[0], mesh=mesh,
                             seed=seed, round_size=2048,
                             bg_ops_per_round=64, drain_per_tick=2048,
                             migrate_per_tick=SKEW["migrate"], **kw)
            ticks = 0
            for bi, b in enumerate(batches):
                drv.insert(b, np.arange(bi * per, (bi + 1) * per))
                ticks += drv.flush(max_ticks=SKEW["flush"])
                try:
                    drv.check_replicas()
                except AssertionError as e:
                    fail(f"{phase} {plane} {label}, batch {bi}: {e}")
            found = drv.search(queries, 10)
            # the first search at a shape holds its kernels: time another
            warm = drv.search(queries, 10)
            truth = drv.exact(queries, 10)
        sync_all()
        if not np.array_equal(warm.ids, found.ids):
            fail(f"{phase} {plane} {label}: a second search differs")
        if path:
            launched = ops.launch_counts()
            log(f"  {phase} {plane} launches on the {label} path: "
                f"{json.dumps(launched)}")
            row0 = EXACT_KERNELS if drv.sharded.n_rows > 1 else ()
            for name in names:
                if launched[name] <= 0:
                    fail(f"kernel {name} was never launched on the "
                         f"{label} sharded {plane} path")
                if held_on and name not in row0 and not any(
                        key[0] in held_on for key, _ in seen[name]):
                    fail(f"kernel {name} was never held on the inputs of "
                         f"{' or '.join(sorted(held_on))}")
            if held_on and row0 and set(row0) & set(names):
                exact_witness(drv, queries[:32], log)
            if witness:
                gather_witness(drv, queries[:32], plane == "quant", log)
        drv.check_replicas()
        placement_line(drv.sharded, log)
        snap = drv.snapshot()
        runs[label] = dict(
            ids=found.ids, scores=found.scores, exact=truth.ids,
            exact_scores=truth.scores, occ=drv.shard_occupancy(),
            stats={k: float(drv.stats[k]) for k in (
                "inserted", "rejected", "migrated", "bg_ops", "bg_gc",
                "host_cached", "drained", "pq_retrains")},
            snap={f: getattr(snap, f).cpu() for f in FIELDS},
            recall=metrics.recall_at_k(found.ids, truth.ids),
            seconds=time.perf_counter() - t0, ticks=ticks,
            search_s=float(warm.seconds))
        r = runs[label]
        log(f"  {phase} {plane} {label} ("
            f"{', '.join(str(d) for d in mesh.devices)}): "
            f"{r['seconds']:.1f} s, {ticks} ticks, recall@10 "
            f"{r['recall']:.4f}, migrated {r['stats']['migrated']:.0f}, "
            f"occupancy {r['occ'].tolist()}, search of {len(queries)} "
            f"{r['search_s'] * 1e3:.3f} ms (warm)")
        del drv, snap
        for i in range(cards):
            with torch.cuda.device(i):
                torch.cuda.empty_cache()
    a, b = runs[base], runs[test]
    for key in ("ids", "scores", "exact", "exact_scores", "occ"):
        if not np.array_equal(a[key], b[key]):
            fail(f"{phase} {plane}: {key} differ between {base} and {test}")
    if a["stats"] != b["stats"]:
        fail(f"{phase} {plane}: stats differ: {a['stats']} vs "
             f"{b['stats']}")
    for f in a["snap"]:
        if not torch.equal(a["snap"][f], b["snap"][f]):
            fail(f"{phase} {plane}: snapshot field {f} differs between "
                 f"{base} and {test}")
    log(f"  {phase} {plane}: {test} = {base}, bit for bit: search and "
        "exact ids and scores, stats, occupancy, snapshot "
        f"({len(a['snap'])} fields); rows identical after every batch")
    return launched


def skew_stream(seed: int):
    """3h-3's Zipf stream for phases 3k and 3l (``SKEW``: 16 clusters,
    Zipf 1.5, 200,000 x 128-d in 10 batches) at ``max_postings`` 65,504:
    (the float config, the batches, 256 queries)."""
    from repro_torch.core.types import UBISConfig
    cfg = UBISConfig(dim=128, max_postings=65504, capacity=96, l_min=10,
                     l_max=80, nprobe=32, cache_capacity=4096,
                     max_ids=1 << 21)
    K, per = SKEW["clusters"], SKEW["n"] // SKEW["batches"]
    rng = np.random.default_rng(seed + 17)
    cents = (rng.standard_normal((K, 128)) * 5).astype(np.float32)
    queries = (cents[rng.integers(0, K, 256)]
               + rng.standard_normal((256, 128))).astype(np.float32)
    w = 1.0 / (np.arange(K) + 1) ** SKEW["zipf"]
    batches = [(cents[rng.choice(K, size=per, p=w / w.sum())]
                + rng.standard_normal((per, 128))).astype(np.float32)
               for _ in range(SKEW["batches"])]
    return cfg, batches, queries


def both_planes(ops, ref, phase: str, seed: int, pairs, log=say) -> dict:
    """The float stream, then its quant leg (PQ16, ``quant_config``, the
    first ``SKEW_QUANT`` batches, a codebook re-train every
    ``SKEW_QUANT["retrain"]`` ticks), through :func:`skew_layouts` for
    each (meshes, held_on, witness) of ``pairs``.  Returns the paths'
    launches."""
    import dataclasses
    cfg, batches, queries = skew_stream(seed)
    qcfg = dataclasses.replace(cfg, **quant_config(128))
    launched = {}
    for plane, c, bs, kw in (
            ("float", cfg, batches, {}),
            ("quant", qcfg, batches[:SKEW_QUANT["batches"]],
             dict(pq_retrain_every=SKEW_QUANT["retrain"]))):
        for meshes, held_on, witness in pairs:
            for k, v in skew_layouts(ops, ref, phase, plane, c, bs, queries,
                                     meshes, seed, log, held_on=held_on,
                                     witness=witness, **kw).items():
                launched[k] = launched.get(k, 0) + v
    return launched


def multi_card_skew(ops, ref, seed: int, log=say) -> dict:
    """Phase 3k, where the process sees two or more cards: 3h-3's Zipf
    stream (:func:`skew_stream`, rebalance on) on S = min(``SHARDS``,
    cards) shards, then its quant leg, each first all on the first card,
    then one a card, every kernel held on a card past the first and each
    plane's unfused gather on the last card (:func:`gather_witness`);
    where the process sees four cards, also the data x model mesh (2, 2)
    over ``cuda:0-3`` against (1, 2) on the first card, every kernel
    held on a row-1 card.  Returns the launches of the multi-card runs;
    on a one-card machine prints why it did not run and returns {}."""
    from repro_torch.distributed import make_mesh
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"  3k not run: the process sees {cards} card "
            f"({torch.cuda.get_device_name(0)}); one shard a card needs "
            "two or more")
        return {}
    S = min(SHARDS, cards)
    names = ("data", "model")
    pairs = [({"one card": make_mesh((1, S), names, devices=[card(0)] * S),
               "one shard a card": make_mesh(
                   (1, S), names, devices=[card(i) for i in range(S)])},
              {str(card(i)) for i in range(1, S)}, True)]
    if cards >= 4:
        grid = make_mesh((2, 2), names, devices=[card(i) for i in range(4)])
        pairs.append(({"(1, 2) on one card": make_mesh(
                           (1, 2), names, devices=[card(0)] * 2),
                       "(2, 2) one cell a card": grid},
                      {str(d) for d in grid.row_devices(1)}, False))
    else:
        log(f"  3k (2, 2) leg not run: the process sees {cards} cards, "
            "the grid needs four")
    return both_planes(ops, ref, "3k", seed, pairs, log)


# ---------------------------------------------------------------------------
# phase 3l: the data x model mesh on one card
# ---------------------------------------------------------------------------

def rows_on_one_card(ops, ref, seed: int, log=say) -> dict:
    """Phase 3l: the data x model mesh (2, 2), all four cells on the
    first card, against (1, 2) there: 3h-3's Zipf stream and its quant
    leg (:func:`both_planes`), bit for bit, the rows identical after
    every batch, 100 storages audited.  Returns the (2, 2) runs'
    launches."""
    from repro_torch.distributed import make_mesh
    names = ("data", "model")
    pairs = [({"(1, 2)": make_mesh((1, 2), names, devices=[card(0)] * 2),
               "(2, 2)": make_mesh((2, 2), names,
                                   devices=[card(0)] * 4)}, None, False)]
    return both_planes(ops, ref, "3l", seed, pairs, log)


# ---------------------------------------------------------------------------
# phase 3i: the cluster plane (coordinator, worker processes, recovery)
# ---------------------------------------------------------------------------

#: 3i-1's worker processes, one logical shard each (32,752 postings)
CLUSTER_WORKERS = 2
#: where 3i-1 writes its checkpoint, inside the checkout (.gitignore)
CLUSTER_CKPT = os.path.join(ROOT, "_cluster_ckpt")
#: 3i-2's tiered seam: the float-resident postings of ``TIER_HOT_MAX``
#: scaled from 1M vectors to 200,000, the re-train cadence in ticks, and
#: the forced spills and promotes between batches
SEAM = dict(hot_max=TIER_HOT_MAX * 200_000 // 1_000_000, retrain=8,
            spill=64, promote=32)
#: 3i-3, figdist's stream (``benchmarks/figures.py:386-440``) at d = 128:
#: vectors, batches, ticks a flush at most, the gated recall's nprobe
FIGDIST = dict(n=200_000, batches=10, flush=8, nprobe=128)


def compute_mode() -> str:
    """The card's compute mode (``nvidia-smi``); two worker processes
    need two CUDA contexts on it, which only ``Default`` allows."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"unknown ({out.stderr.strip()})"


def worker_launches(coord, reset: bool = False) -> dict:
    """The kernel launches counted in the coordinator's worker processes
    (each counts its own), summed; ``reset`` zeroes them first."""
    total: dict = {}
    for w in range(coord.n_workers):
        got = coord.backend.call(w, "launches", {"reset": reset})
        for k, v in got["launches"].items():
            total[k] = total.get(k, 0) + int(v)
    return total


def need_launched(label: str, launched: dict, names) -> None:
    for name in names:
        if launched.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on {label}")


def journal_bytes(coord) -> int:
    """Host bytes of the arrays the coordinator's journal holds."""
    def nbytes(x) -> int:
        if isinstance(x, np.ndarray):
            return x.nbytes
        if isinstance(x, dict):
            return sum(nbytes(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(nbytes(v) for v in x)
        return 0
    return sum(nbytes(p) for j in coord._journal for _, p in j)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def cluster_float_path(dev, ops, seed: int, log=say) -> dict:
    """Phase 3i-1: the float path's deployment on two worker processes,
    then the failure plane (checkpoint, a step, SIGKILL of worker 0,
    recovery by journal replay, a fresh cluster's restore).  Returns the
    worker processes' launches."""
    import shutil

    from repro_torch.api import make_index
    from repro_torch.core import metrics
    from repro_torch.obs import Obs
    obs = Obs()
    launched: dict = {}

    def hook(drv, stage):
        if stage == "built":
            worker_launches(drv, reset=True)
            return
        live = drv.worker_live()
        log(f"  {stage}: worker live {live.tolist()}, max/min "
            f"{metrics.occupancy_spread(live)['occ_ratio']:.3f}")

    t0 = time.perf_counter()
    drv, q, secs, recalls, stream = main_path(
        dev, n=1_000_000, dim=128, max_postings=65504, cache_capacity=4096,
        steps=2, fresh=20000, dels=10000, queries=256, chunk=20000,
        seed=seed, round_size=2048, bg_ops=64, engine="ubis-cluster",
        hook=hook, log=log, index_kw=dict(
            workers=CLUSTER_WORKERS, backend="multiprocess", obs=obs))
    for k, v in worker_launches(drv).items():
        launched[k] = launched.get(k, 0) + v
    need_launched("the cluster's float path (worker processes)", launched,
                  SHARD_KERNELS["float"])
    live = drv.worker_live()
    ratio = metrics.occupancy_spread(live)["occ_ratio"]
    log(f"  seconds per phase: "
        f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    log(f"  launches in the worker processes: {json.dumps(launched)}")
    log(f"  recall@10 per step (gated >= 0.9): {recalls}; live "
        f"{drv.live_count()} = inserted - deleted; worker live "
        f"{live.tolist()}, max/min {ratio:.3f} (gate <= 1.5); invariants "
        "hold on every worker's snapshot")
    if not ratio <= 1.5:
        fail(f"cluster worker live max/min {ratio:.3f} > 1.5")

    # the failure plane, as examples/elastic_restart.py runs it
    shutil.rmtree(CLUSTER_CKPT, ignore_errors=True)
    q_ck = stream.draw(256)
    t = time.perf_counter()
    manifest = drv.checkpoint(CLUSTER_CKPT)
    ck_s = time.perf_counter() - t
    ck_bytes = dir_bytes(CLUSTER_CKPT)
    ids_ck = drv.search(q_ck, 10).ids
    stream_steps(drv, stream, secs, steps=1, fresh=20000, dels=10000,
                 queries=256, next_id=stream.next_id, oldest=stream.oldest,
                 log=log)
    t = time.perf_counter()
    before = drv.snapshot().digest
    snap_s = time.perf_counter() - t
    jbytes = journal_bytes(drv)
    t = time.perf_counter()
    drv.backend.kill_worker(0)                # SIGKILL between commands
    drv.live_count()                          # the first call recovers
    rec_s = time.perf_counter() - t
    after = drv.snapshot().digest
    lost, rst = obs.events("worker_lost"), obs.events("worker_restarted")
    if not lost or not rst or not rst[-1]["from_checkpoint"] \
            or not rst[-1]["replayed"] > 0 or rst[-1]["worker"] != 0:
        fail(f"no recovery of worker 0 from the checkpoint: lost {lost}, "
             f"restarted {rst}")
    if after != before:
        fail(f"the live multiset changed across the restart: digest "
             f"{after:#x} != {before:#x}")
    log(f"  checkpoint {ck_s:.1f} s ({ck_bytes} bytes on disk, combined "
        f"digest {manifest['combined_digest']:#x}); a snapshot of both "
        f"workers with their digests {snap_s:.1f} s; SIGKILL of worker 0 "
        f"after one more step, recovered in {rec_s:.1f} s (worker_lost: "
        f"{lost[-1]['reason']}; from_checkpoint, {rst[-1]['replayed']} "
        f"commands replayed, journal {jbytes} bytes of arrays); digest "
        f"{after:#x} = the digest before the kill")
    cfg = drv.cfg
    drv.close()
    del drv
    t = time.perf_counter()
    fresh = make_index("ubis-cluster", cfg, stream.draw(1000),
                       device=dev, seed=seed, round_size=2048,
                       bg_ops_per_round=64, drain_per_tick=2048,
                       workers=CLUSTER_WORKERS, backend="multiprocess")
    start_s = time.perf_counter() - t
    t = time.perf_counter()
    fresh.restore(CLUSTER_CKPT)
    res_s = time.perf_counter() - t
    try:
        got = fresh.snapshot().digest
        if got != manifest["combined_digest"]:
            fail(f"restored digest {got:#x} != the manifest's "
                 f"{manifest['combined_digest']:#x}")
        ids = fresh.search(q_ck, 10).ids
        if not np.array_equal(ids, ids_ck):
            fail(f"the restored cluster's search differs from the "
                 f"original's at checkpoint time at "
                 f"{int((ids != ids_ck).sum())} of {ids.size} ids")
        for k, v in worker_launches(fresh).items():
            launched[k] = launched.get(k, 0) + v
        log(f"  a fresh {CLUSTER_WORKERS}-worker cluster (started in "
            f"{start_s:.1f} s: two processes, init) restored the checkpoint "
            f"in {res_s:.1f} s (files read, digests verified, load_state): "
            f"digest = the manifest's; its 256-query search "
            f"= the original's at checkpoint time, ids bit for bit; "
            f"worker live {fresh.worker_live().tolist()}")
    finally:
        fresh.close()
        shutil.rmtree(CLUSTER_CKPT, ignore_errors=True)
    log(f"  3i-1 {time.perf_counter() - t0:.1f} s")
    return launched


def figskew_batches(seed: int, n: int, batches: int, salt: int):
    """figskew/figdist's Zipf stream at d = 128 (16 clusters, Zipf 1.5,
    centres N(0, 25 I)): ``batches`` batches of ``n // batches`` vectors
    and 256 queries."""
    K = SKEW["clusters"]
    rng = np.random.default_rng(seed + salt)
    cents = (rng.standard_normal((K, 128)) * 5).astype(np.float32)
    queries = (cents[rng.integers(0, K, 256)]
               + rng.standard_normal((256, 128))).astype(np.float32)
    w = 1.0 / (np.arange(K) + 1) ** SKEW["zipf"]
    per = n // batches
    out = []
    for _ in range(batches):
        a = rng.choice(K, size=per, p=w / w.sum())
        out.append((cents[a] + rng.standard_normal((per, 128)))
                   .astype(np.float32))
    return out, queries


def seam_tape(idx, batches, queries) -> list:
    """3i-2's per-op tape: each batch inserted, spills forced after
    every third, a flush of at most 8 ticks, promotes forced, a search."""
    tape = []
    per = len(batches[0])
    for b, vecs in enumerate(batches):
        r = idx.insert(vecs, np.arange(b * per, (b + 1) * per))
        tape.append(("insert", r.accepted, r.cached, r.rejected))
        if b % 3 == 1:
            tape.append(("spill", idx.force_spill(SEAM["spill"])))
        for _ in range(8):
            t = idx.tick()
            tape.append(("tick", t.executed, t.drained, t.migrated,
                         t.pq_retrained, t.spilled, t.promoted))
            if t.executed == 0 and t.migrated == 0:
                break
        if b % 3 == 2:
            tape.append(("promote", idx.force_promote(SEAM["promote"])))
        res = idx.search(queries, 10)
        tape.append(("search", res.ids.copy(), res.scores.copy()))
    return tape


def seam_check(dev, ops, ref, seed: int, log=say) -> dict:
    """Phase 3i-2: ``workers=1`` on the ``LocalBackend`` (every message
    through the codec) against ``ubis-sharded`` on the same mesh, the
    tiered path's configuration over 3h-3's Zipf stream.  Returns the
    launches of the cluster's run."""
    from repro_torch import bridge
    from repro_torch.api import make_index
    from repro_torch.core.types import UBISConfig
    t0 = time.perf_counter()
    cfg = UBISConfig(dim=128, max_postings=65504, capacity=96, l_min=10,
                     l_max=80, nprobe=32, cache_capacity=4096,
                     max_ids=1 << 21, **quant_config(128), use_tier=True,
                     tier_hot_max=SEAM["hot_max"])
    batches, queries = figskew_batches(seed, 200_000, 10, salt=23)
    kw = dict(device=dev, seed=seed, round_size=2048, bg_ops_per_round=64,
              drain_per_tick=2048, migrate_per_tick=SKEW["migrate"],
              pq_retrain_every=SEAM["retrain"], tier_moves_per_tick=256)
    runs = {}
    for name in ("ubis-sharded", "ubis-cluster"):
        t = time.perf_counter()
        if name == "ubis-sharded":
            idx = make_index(name, cfg, batches[0], mesh=shard_mesh(dev),
                             **kw)
            drv = idx
            legs = None
        else:
            idx = make_index(name, cfg, batches[0], workers=1,
                             mesh_shape=(1, SHARDS), **kw)
            rt = idx.backend.runtime(0)
            drv = rt.drv
            legs = {"n": 0}
            handle = rt.handle

            def checked(kind, payload, _handle=handle):
                out = _handle(kind, payload)
                if kind in ("tick_begin", "tick_exec", "tick_end",
                            "cache_put", "force_spill", "force_promote",
                            "load_state"):
                    rt.drv.check_replicas()
                    legs["n"] += 1
                return out
            rt.handle = checked
        ops.reset_launch_counts()
        with (held_on_path(ops, ref, SHARD_KERNELS["quant"], log)
              if name == "ubis-cluster" else nullcontext()):
            tape = seam_tape(idx, batches, queries)
        launched = ops.launch_counts()
        need_launched(f"3i-2's {name}", launched, SHARD_KERNELS["quant"])
        drv.check_replicas()
        snap = bridge.state_to_numpy(idx.snapshot())
        stats = {k: float(idx.stats[k]) for k in (
            "inserted", "rejected", "migrated", "pq_retrains",
            "tier_spilled", "tier_promoted", "host_cached")}
        runs[name] = (tape, snap, stats, launched)
        log(f"  3i-2 {name}: {len(tape)} ops, stats {json.dumps(stats)}, "
            f"{time.perf_counter() - t:.1f} s"
            + (f"; replicas identical after each of {legs['n']} tick legs "
               "and tier writes" if legs else ""))
        idx.close()
        del idx, drv
        torch.cuda.empty_cache()
    (ta, sa, xa, _), (tb, sb, xb, launched) = (runs["ubis-sharded"],
                                               runs["ubis-cluster"])
    if len(ta) != len(tb):
        fail(f"3i-2 tapes differ in length: {len(ta)} vs {len(tb)}")
    for i, (a, b) in enumerate(zip(ta, tb)):
        same = (a[0] == b[0] and (np.array_equal(a[1], b[1])
                                  and np.array_equal(a[2], b[2])
                                  if a[0] == "search" else a == b))
        if not same:
            fail(f"3i-2 tapes differ at op {i}: {a[:4]} vs {b[:4]}")
    bad = [k for k in sa if not np.array_equal(sa[k], sb[k])]
    if bad:
        fail(f"3i-2 snapshots differ in {bad}")
    if xa != xb:
        fail(f"3i-2 stats differ: {xa} vs {xb}")
    if not xb["migrated"] > 0 or not xb["pq_retrains"] > 0 \
            or not xb["tier_spilled"] > 0:
        fail(f"3i-2 ran no migration, re-train or spill: {xb}")
    log(f"  3i-2: the per-op tape ({len(tb)} ops: counts, search ids and "
        f"scores), every snapshot field and the stats identical; migrated "
        f"{xb['migrated']:.0f}, re-trains {xb['pq_retrains']:.0f}, spilled "
        f"{xb['tier_spilled']:.0f}; 3i-2 {time.perf_counter() - t0:.1f} s")
    return launched


def figdist_runs(dev, ops, seed: int, log=say) -> dict:
    """Phase 3i-3: figdist's stream into ``workers=2`` over the local and
    the multiprocess backend.  Returns the launches (in-process and in
    the worker processes)."""
    from repro_torch.api import make_index
    from repro_torch.core import metrics
    from repro_torch.core.types import UBISConfig
    t0 = time.perf_counter()
    cfg = UBISConfig(dim=128, max_postings=65504, capacity=96, l_min=10,
                     l_max=80, nprobe=32, cache_capacity=4096,
                     max_ids=1 << 21)
    batches, queries = figskew_batches(seed, FIGDIST["n"],
                                       FIGDIST["batches"], salt=29)
    per = len(batches[0])
    launched: dict = {}
    runs = {}
    for backend in ("local", "multiprocess"):
        t = time.perf_counter()
        ops.reset_launch_counts()
        idx = make_index("ubis-cluster", cfg, batches[0], device=dev,
                         seed=seed, workers=2, backend=backend,
                         round_size=2048, bg_ops_per_round=64,
                         drain_per_tick=2048, spread_per_tick=256)
        try:
            if backend == "multiprocess":
                worker_launches(idx, reset=True)
            tape = []
            for b, vecs in enumerate(batches):
                r = idx.insert(vecs, np.arange(b * per, (b + 1) * per))
                ticks = idx.flush(max_ticks=FIGDIST["flush"])
                tape.append((r.accepted, r.cached, r.rejected, ticks,
                             idx.worker_live().tolist()))
            found = idx.search(queries, 10, nprobe=FIGDIST["nprobe"])
            truth = idx.exact(queries, 10)
            rec = metrics.recall_at_k(found.ids, truth.ids)
            live = idx.worker_live()
            spread = metrics.occupancy_spread(live)
            digest = idx.snapshot().digest
            got = (worker_launches(idx) if backend == "multiprocess"
                   else ops.launch_counts())
            need_launched(f"3i-3 {backend}", got, SHARD_KERNELS["float"])
            for k, v in got.items():
                launched[k] = launched.get(k, 0) + v
            runs[backend] = (tape, digest, found.ids, found.scores)
            log(f"  3i-3 {backend}: recall@10 at nprobe {FIGDIST['nprobe']} "
                f"{rec:.4f} (gate >= 0.9), worker live {live.tolist()}, "
                f"max/min {spread['occ_ratio']:.3f} (gate <= 1.5), migrated "
                f"{idx.stats['migrated']:.0f}, rejected "
                f"{idx.stats['rejected']:.0f}, digest {digest:#x}, "
                f"{time.perf_counter() - t:.1f} s")
            if not rec >= 0.9:
                fail(f"3i-3 {backend}: recall@10 {rec:.4f} < 0.9")
            if not spread["occ_ratio"] <= 1.5:
                fail(f"3i-3 {backend}: max/min {spread['occ_ratio']:.3f} "
                     "> 1.5")
        finally:
            idx.close()
        torch.cuda.empty_cache()
    (ta, da, ia, sa), (tb, db, ib, sb) = runs["local"], runs["multiprocess"]
    if ta != tb or da != db or not np.array_equal(ia, ib) \
            or not np.array_equal(sa, sb):
        fail(f"3i-3: the multiprocess run differs from the local one "
             f"(tapes equal {ta == tb}, digests {da:#x} / {db:#x})")
    log(f"  3i-3: the local and multiprocess tapes (per batch: counts, "
        f"ticks, worker live), final digests and search ids and scores "
        f"equal; 3i-3 {time.perf_counter() - t0:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 3j: the backbone's decode path
# ---------------------------------------------------------------------------

#: phase 3j at full width: ``batch`` prompts of ``prompt`` tokens, ``steps``
#: greedy decode steps into caches of ``ctx`` positions; gate (ii) on
#: ``cons_batch`` prompts of ``cons_len`` tokens
DECODE = dict(batch=16, prompt=512, steps=64, ctx=576, cons_batch=4,
              cons_len=128)
#: |logits - reference| <= LOGIT_TOL x the largest |logit| of the real
#: vocab: fp32 summation order through every layer (the serving path's
#: gate on its embeddings)
LOGIT_TOL = 1e-4
#: ``flash_attention``'s shape in the decode path's prefill (B, Hq, Hkv, L,
#: D), causal: phase 4 times it beside the serving path's
DECODE_ATTN = (16, 32, 4, 512, 64)
#: phase 3j's variants at ``reduced=True``: config overrides, the extra
#: input (a vlm ``prefix``, an enc-dec ``src``, ``prefix_len`` rows), and
#: the (Lq, Lk, causal, window) calls of ``flash_attention`` that must be
#: held against the plain version on their own inputs
DECODE_PROMPT = (4, 40)
DECODE_VARIANTS = {
    "qk_norm": (dict(qk_norm=True), None, {(40, 40, True, None)}),
    "local-global LLG, window 8, a tail": (
        dict(local_global_pattern="LLG", n_layers=4, sliding_window=8),
        None, {(40, 40, True, 8), (40, 40, True, None)}),
    "tie_embeddings": (dict(tie_embeddings=True), None,
                       {(40, 40, True, None)}),
    "vocab 500": (dict(vocab=500), None, {(40, 40, True, None)}),
    "encdec": (dict(family="encdec", encoder_layers=2, prefix_len=4), "src",
               {(4, 4, False, None), (40, 4, False, None),
                (40, 40, True, None)}),
    "vlm prefix": (dict(family="vlm", prefix_len=4), "prefix",
                   {(44, 44, True, None), (24, 24, True, None)}),
}


def require_logits(label, got, want) -> float:
    """``got`` within ``LOGIT_TOL`` of the largest |``want``| over the
    real vocab (the padded entries are -1e30 in both); returns the error
    over that scale."""
    real = want > -1e29
    if not torch.equal(real, got > -1e29):
        fail(f"{label}: the padded vocab's logits differ")
    err = float((got.double() - want.double()).abs()[real].max())
    scale = float(want[real].abs().max())
    if not err <= LOGIT_TOL * scale:
        fail(f"{label}: max |logits - reference| {err:.3g} > {LOGIT_TOL} x "
             f"{scale:.3g}")
    if not bool(torch.isfinite(got[real]).all()):
        fail(f"{label}: non-finite logits")
    return err / scale


def stepwise_matches_prefill(model, batch: dict, label: str,
                             log=say) -> float:
    """Gate (ii): prefill's last logits equal those of one-token decode
    steps over the same tokens from an empty cache (an enc-dec model's
    cross caches taken from prefill's; with a vlm ``prefix``, steps over
    the second half after a prefill of the prefix and the first half)."""
    want, pre = model.prefill(batch)
    toks = batch["tokens"]
    B, L = toks.shape
    P = batch["prefix"].shape[1] if "prefix" in batch else 0
    caches, start = model.init_cache(B, P + L), 0
    if P:
        start = L // 2
        _, part = model.prefill({**batch, "tokens": toks[:, :start]})
        caches = model.grow_caches(part, P + L)
    if "src" in batch:
        for c, p in zip(caches, pre):
            c["xk"].copy_(p["xk"])
            c["xv"].copy_(p["xv"])
    for t in range(start, L):
        got, caches = model.decode_step(caches, toks[:, t], P + t)
    rel = require_logits(f"{label}: prefill vs decode steps", got, want)
    log(f"  gate (ii) {label}: prefill's last logits vs {L - start} "
        f"one-token decode steps (B={B}, {P + L} positions): max err "
        f"{rel:.3g} of the largest |logit| (gate {LOGIT_TOL})")
    return rel


def decode_path(dev, ops, ref, smi: str, *, seed: int,
                reduced: bool = False, log=say, **size):
    """Phase 3j at full width: ``get_model("tinyllama-1.1b")`` prefills
    ``batch`` prompts of ``prompt`` tokens (its ``flash_attention`` held
    against the plain version on the first layer's q/k/v), the caches
    go into ``init_cache(batch, ctx)``, then ``steps`` greedy decode
    steps; the launch counts reset just before and read just after.
    Gates (i) (teacher-forced against the plain attention's run) and
    (ii), then prefill and decode timed.  Returns (the path's launch
    counts, one decode step for phase 4b)."""
    from repro_torch.models import get_model
    sz = dict(DECODE, **size)
    B, L, steps, ctx = sz["batch"], sz["prompt"], sz["steps"], sz["ctx"]
    t = time.perf_counter()
    model = get_model("tinyllama-1.1b", reduced=reduced, device=str(dev),
                      seed=seed)
    sync()
    cfg = model.cfg
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    log(f"  {cfg.name}: {len(model.layers)} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads x {cfg.hd}, vocab {cfg.vocab} "
        f"(head untied): {weight_bytes:,} bytes of fp32 weights drawn in "
        f"{time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(seed + 13)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, L)), device=dev)

    ops.reset_launch_counts()
    with held_on_path(ops, ref, ("flash_attention",), log=log):
        logits, pre = model.prefill({"tokens": toks})
    caches = model.grow_caches(pre, ctx)
    fed, got, lg = [], [], logits
    for i in range(steps):
        fed.append(lg.argmax(-1))
        lg, caches = model.decode_step(caches, fed[-1], L + i)
        got.append(lg)
    sync()
    launched = ops.launch_counts()
    log(f"  launches on the decode path: {json.dumps(launched)}")
    if launched["flash_attention"] != len(model.layers):
        fail(f"decode path: {launched['flash_attention']} flash_attention "
             f"launches, not one a layer ({len(model.layers)})")
    for name in PATH_KERNELS["decode"]:
        if launched[name] <= 0:
            fail(f"kernel {name} was never launched on the decode path")
    cache_bytes = sum(x.numel() * x.element_size() for c in caches
                      for x in c.values())

    with mock.patch.object(ops, "flash_attention", plain_attention(ref)):
        plogits, ppre = model.prefill({"tokens": toks})
    worst = require_logits("decode path: prefill", logits, plogits)
    pc = model.grow_caches(ppre, ctx)
    del ppre, plogits
    for i in range(steps):
        plg, pc = model.decode_step(pc, fed[i], L + i)
        worst = max(worst, require_logits(f"decode path: step {i}", got[i],
                                          plg))
    del pc, got
    log(f"  gate (i), teacher-forced on the kernel run's {steps} tokens: "
        f"prefill and every step's logits, kernel against plain attention: "
        f"max err {worst:.3g} of the largest |logit| (gate {LOGIT_TOL})")
    stepwise_matches_prefill(model, {"tokens": toks[:sz["cons_batch"],
                                                    :sz["cons_len"]]},
                             cfg.name, log)

    times = []
    for _ in range(3):
        sync()
        t = time.perf_counter()
        model.prefill({"tokens": toks})
        sync()
        times.append(time.perf_counter() - t)
    pre_s = float(np.median(times))
    caches = model.grow_caches(pre, ctx)
    del pre
    sync()
    t = time.perf_counter()
    for i in range(steps):
        model.decode_step(caches, fed[i], L + i)
    sync()
    step_s = (time.perf_counter() - t) / steps
    log(f"  {smi}: prefill {B} x {L} tokens {pre_s * 1e3:.3f} ms (median "
        f"of 3: {B * L / pre_s:.0f} tokens/s); decode {step_s * 1e3:.3f} ms "
        f"a step at B={B}, context {L}-{L + steps} ({B / step_s:.1f} "
        f"tokens/s, {steps} steps); weights {weight_bytes:,} bytes, KV "
        f"cache {cache_bytes:,} bytes ({B} x {ctx} positions)")

    def one_step():
        model.decode_step(caches, fed[-1], L + steps - 1)
    return launched, one_step


def held_kinds(held) -> set:
    """(Lq, Lk, causal, window) of each ``flash_attention`` call held."""
    out = set()
    for key, _ in held["flash_attention"]:
        a = dict(key[1:])                   # key[0]: the inputs' device
        out.add((a["q"][2], a["k"][2], a.get("causal", True),
                 a.get("window")))
    return out


def decode_variants(dev, ops, ref, seed: int, log=say) -> dict:
    """Phase 3j's variants at ``reduced=True``: gate (ii) on each, and
    every kind of ``flash_attention`` call of the variant (the encoder's,
    the cross-attention's, the windowed layers') held against the plain
    version on its own inputs.  Returns the launch counts."""
    from repro_torch.models import get_model
    total = {}
    for name, (over, extra, kinds) in DECODE_VARIANTS.items():
        model = get_model("tinyllama-1.1b", reduced=True, device=str(dev),
                          seed=seed, **over)
        cfg = model.cfg
        rng = np.random.default_rng(seed + 17)
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, DECODE_PROMPT), device=dev)}
        if extra is not None:
            batch[extra] = torch.as_tensor(0.5 * rng.standard_normal(
                (DECODE_PROMPT[0], cfg.prefix_len, cfg.d_model),
                dtype=np.float32), device=dev)
        ops.reset_launch_counts()
        with held_on_path(ops, ref, ("flash_attention",), log=log) as held:
            stepwise_matches_prefill(model, batch, name, log)
        missing = kinds - held_kinds(held)
        if missing:
            fail(f"decode variant {name}: flash_attention calls {missing} "
                 "were not held against the plain version")
        total = {k: total.get(k, 0) + v
                 for k, v in ops.launch_counts().items()}
    return total


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


#: profiler sessions ``device_kernels`` opens before it gives up on a call
#: whose device events never reach ``key_averages``
PROFILE_TRIES = 6
#: sessions that came back short of device events, calls given up on, and
#: the first few shortfalls (kernel, events seen, calls made)
PROFILE_MISSES = {"retried": 0, "not_measured": 0, "short": []}


def device_kernels(fn, reps: int = 20, kernel: str | None = None) -> dict:
    """Device kernel name -> mean device ms a call of ``fn`` (``reps``
    calls under ``torch.profiler``): the time on the card alone, where
    ``median_ms`` also holds the host's launch of a short kernel, and a
    kernel apart from a wrapper's elementwise passes.  A call of ``fn``
    launches the same kernels every time, so a whole session holds each
    kernel's events a multiple of ``reps`` times; a session short of
    that, or without an event naming ``kernel`` (if given), lost events
    on the way to ``key_averages`` and is opened again, up to
    ``PROFILE_TRIES`` sessions; after that the result is empty: not
    measured, never zero or a part."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # one kernel's events may come in more than one entry
        out, seen = {}, {}
        for ev in prof.key_averages():
            if not str(ev.device_type).endswith("CUDA"):
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0:
                out[ev.key] = out.get(ev.key, 0.0) + us / reps / 1e3
                seen[ev.key] = seen.get(ev.key, 0) + ev.count
        short = [(k[:40], n, reps) for k, n in seen.items() if n % reps]
        if not short and any(kernel is None or kernel in name
                             for name in out):
            return out
        PROFILE_MISSES["retried"] += 1
        if len(PROFILE_MISSES["short"]) < 6:
            PROFILE_MISSES["short"].append(short[:2] or [(kernel, 0, reps)])
    PROFILE_MISSES["not_measured"] += 1
    return {}


def device_ms(fn, kernel: str | None = None, reps: int = 20):
    """Mean device time of the ``kernel`` launches (every device event if
    None) that a call of ``fn`` makes (``device_kernels``); None where the
    profiler saw none of them."""
    kern = device_kernels(fn, reps, kernel)
    return sum(ms for name, ms in kern.items()
               if kernel is None or kernel in name) if kern else None


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_3xtf32(ops: float, nbytes: float) -> float:
    """The least time of the 3xTF32 route (``masked_score``): bytes at the
    HBM rate or three TF32 products per fp32 one at the tensor cores'
    rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES, 3.0 * ops / PEAK_TF32) * 1e3


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
    # the insert locate's pick (update.py: argmin over the scores): where
    # the kernel's pick differs, its plain score is within the tolerance
    # of the plain best (a near-tie the two roundings order apart)
    got = ops.centroid_score(locate, cen, insertable)
    want = ref.centroid_score(locate, cen, insertable)
    gi, wi = got.argmin(-1), want.argmin(-1)
    check_assign("insert locate argmin",
                 (gi, got.gather(1, gi[:, None])[:, 0]),
                 (wi, want.gather(1, wi[:, None])[:, 0]), want)
    say(f"  insert locate argmin ({J} x {M}): {int((gi != wi).sum())} of "
        f"{J} picks differ from the plain version's, each within the "
        "tolerance of its best")
    del got, want
    work = {"centroid_score": (2.0 * J * M * d + 2.0 * M * d,
                               4.0 * (J * d + M * d + J * M) + M)}
    row("centroid_score",
        lambda: ops.centroid_score(locate, cen, insertable),
        lambda: ref.centroid_score(locate, cen, insertable),
        lambda: torch.addmm(cn[None], locate, cen.T, alpha=-2), close,
        *work["centroid_score"])
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
    work["posting_scan"] = (2.0 * len(qx) * N * d + 2.0 * N * d,
                            4.0 * (len(qx) * d + N * d + len(qx) * N) + N)
    row("posting_scan",
        lambda: ops.posting_scan(qx, st.vectors, valid),
        lambda: ref.posting_scan(qx, st.vectors, valid),
        lambda: torch.addmm(vn[None], qx, flat.T, alpha=-2), close,
        *work["posting_scan"])
    for r in rows:
        if r["name"] in work:
            say(f"  {r['name']}: {r['ms']:.4f} ms, fp32 bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), 3xTF32 bound "
                f"{bound_3xtf32(*work[r['name']]):.4f} ms, addmm "
                f"{r['library_ms']:.4f} ms")

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


def quant_inputs(ops, drv, q_np, k_rerank: int) -> dict:
    """The quant plane's phase-2 inputs on ``drv``'s state: the lookup
    tables of the last step's queries, the code tiles of the distinct
    probed postings (probe ids renumbered) with their codebook slot,
    ``slot_valid`` and visibility, the ADC stage's output at R =
    rerank_k, and for the rerank the rows of the postings its candidates
    fall in (candidate ids renumbered) with their spilled flags.  Saved
    so that another tree's kernels can be timed on the same bytes
    (``--parent-tree``)."""
    from repro_torch.core import version_manager as vm
    from repro_torch.quant import pq
    st, cfg = drv.state, drv.cfg
    q = torch.as_tensor(q_np, device=drv.device)
    vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
    _, probe = ops.centroid_topk(q, st.centroids, vis, k=cfg.nprobe)
    C = st.vectors.shape[1]
    R = min(cfg.rerank_k, probe.shape[1] * C)
    luts = pq.lookup_tables(st.pq_codebooks, q)
    uniq, inv = torch.unique(probe, return_inverse=True)
    x = dict(q=q, luts=luts.contiguous(), codes=st.codes[uniq].contiguous(),
             slot=st.pq_posting_slot[uniq].contiguous(),
             slot_valid=st.slot_valid[uniq].contiguous(),
             vis=vis[uniq].contiguous(),
             probe=inv.to(torch.int32).contiguous(), R=R, k=k_rerank)
    adc, cand = ops.pq_scan_topk(x["luts"], x["codes"], x["slot"],
                                 x["slot_valid"], x["vis"], x["probe"], k=R)
    cand = uniq[(cand // C).long()].to(torch.int32) * C + cand % C
    rows, rinv = torch.unique(cand // C, return_inverse=True)
    x.update(adc=adc, cand=(rinv * C + cand % C).to(torch.int32).contiguous(),
             vecs=st.vectors[rows.long()].contiguous(),
             spilled=st.tier_spilled[rows.long()].contiguous())
    return x


def topk_inputs(ops, drv, q_np, qdrv=None, qq_np=None, tdrv=None,
                tq_np=None) -> dict:
    """Phase 4's top-k and gather inputs.  Rows 2, 4 and 5 on the float
    state: the last step's queries, the centroids, the cache, and the
    tiles the queries probe, gathered into a table of their own (U
    distinct probed postings; probe ids renumbered).  Rows 6-8
    (``quant_inputs``) on the quant state, the rerank at k = 10, and on
    the tiered state at k = max(10, rerank_k), as ``dispatch_search``
    asks there.  All of it is
    saved so that another tree's kernels can be timed on the same bytes
    (``--parent-tree``)."""
    from repro_torch.core import version_manager as vm
    st = drv.state
    q = torch.as_tensor(q_np, device=drv.device)
    vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
    _, probe = ops.centroid_topk(q, st.centroids, vis, k=drv.cfg.nprobe)
    uniq, inv = torch.unique(probe, return_inverse=True)
    x = dict(q=q, cen=st.centroids, vis=vis, cache=st.cache_vecs,
             cache_ok=st.cache_valid, nprobe=drv.cfg.nprobe,
             vecs=st.vectors[uniq].contiguous(),
             slot_valid=st.slot_valid[uniq].contiguous(),
             pvis=vis[uniq].contiguous(),
             probe=inv.to(torch.int32).contiguous())
    if qdrv is not None:
        x["quant"] = quant_inputs(ops, qdrv, qq_np, 10)
    if tdrv is not None:
        x["tier"] = quant_inputs(ops, tdrv, tq_np,
                                 max(10, tdrv.cfg.rerank_k))
    return x


#: the k at which phase 4 times the wide top-k paths (rerank_k = 192)
WIDE_TIMED_K = (64, 192)


def topk_cases(ops, x) -> dict:
    """The calls that phase 4 times for rows 2 and 4-8: name -> a call
    through ``ops``, which may be another tree's module (only its public
    functions are used)."""
    q, q32, P = x["q"], x["q"][:32], x["nprobe"]
    cases = {
        "centroid_topk Q=256": lambda: ops.centroid_topk(
            q, x["cen"], x["vis"], k=P),
        "centroid_topk Q=32": lambda: ops.centroid_topk(
            q32, x["cen"], x["vis"], k=P),
        "centroid_topk cache scan": lambda: ops.centroid_topk(
            q, x["cache"], x["cache_ok"], k=10),
        "posting_scan_topk Q=256": lambda: ops.posting_scan_topk(
            q, x["vecs"], x["slot_valid"], x["pvis"], x["probe"], k=10),
        "posting_scan_topk Q=32": lambda: ops.posting_scan_topk(
            q32, x["vecs"], x["slot_valid"], x["pvis"], x["probe"][:32],
            k=10),
    }
    # the wide paths at the shapes they run: (a) the tiered search's cache
    # scan at k = rerank_k, (b) phase 1 past nprobe 32, (c) phase 2 past k
    # = 32
    for k in WIDE_TIMED_K:
        cases[f"centroid_topk cache scan k={k}"] = (
            lambda k=k: ops.centroid_topk(q, x["cache"], x["cache_ok"], k=k))
        for Q in (256, 32):
            cases[f"centroid_topk Q={Q} k={k}"] = (
                lambda Q=Q, k=k: ops.centroid_topk(q[:Q], x["cen"], x["vis"],
                                                   k=k))
            cases[f"posting_scan_topk Q={Q} k={k}"] = (
                lambda Q=Q, k=k: ops.posting_scan_topk(
                    q[:Q], x["vecs"], x["slot_valid"], x["pvis"],
                    x["probe"][:Q], k=k))
    if "quant" in x:
        a = x["quant"]
        cases["pq_scan_topk Q=256"] = lambda: ops.pq_scan_topk(
            a["luts"], a["codes"], a["slot"], a["slot_valid"], a["vis"],
            a["probe"], k=a["R"])
        cases["pq_scan_topk Q=32"] = lambda: ops.pq_scan_topk(
            a["luts"][:32], a["codes"], a["slot"], a["slot_valid"],
            a["vis"], a["probe"][:32], k=a["R"])
    for key, name in (("quant", "rerank_topk Q=256 k=10"),
                      ("tier", "rerank_topk tiered k=192")):
        if key in x:
            b = x[key]
            cases[name] = (lambda b=b: ops.rerank_topk(
                b["q"], b["vecs"], b["spilled"], b["cand"], b["adc"],
                k=b["k"]))
    for Q in (256, 32):
        cases[f"posting_scan_gather Q={Q}"] = (
            lambda Q=Q: ops.posting_scan_gather(
                q[:Q], x["vecs"], x["slot_valid"], x["pvis"],
                x["probe"][:Q]))
        if "quant" in x:
            a = x["quant"]
            cases[f"pq_scan_gather Q={Q}"] = (
                lambda Q=Q: ops.pq_scan_gather(
                    a["luts"][:Q], a["codes"], a["slot"], a["slot_valid"],
                    a["vis"], a["probe"][:Q]))
    return cases


def topk_work(x) -> dict:
    """name -> (operations, bytes) of each ``topk_cases`` call: each input
    read once (for the scans only the distinct probed tiles), each output
    written once; for the rerank the candidates' rows that are read (not
    a spilled posting's, not an empty ADC slot's)."""
    d = x["q"].shape[1]
    C = x["vecs"].shape[1]
    out = {}
    for name, Q, M, k in (("centroid_topk Q=256", len(x["q"]),
                           len(x["cen"]), x["nprobe"]),
                          ("centroid_topk Q=32", 32, len(x["cen"]),
                           x["nprobe"]),
                          ("centroid_topk cache scan", len(x["q"]),
                           len(x["cache"]), 10)):
        out[name] = (2.0 * Q * M * d + 2.0 * M * d,
                     4.0 * (Q * d + M * d) + M + 8.0 * Q * k)
    for k in WIDE_TIMED_K:
        for name, Q, M in ((f"centroid_topk cache scan k={k}", len(x["q"]),
                            len(x["cache"])),
                           (f"centroid_topk Q=256 k={k}", 256,
                            len(x["cen"])),
                           (f"centroid_topk Q=32 k={k}", 32, len(x["cen"]))):
            out[name] = (2.0 * Q * M * d + 2.0 * M * d,
                         4.0 * (Q * d + M * d) + M + 8.0 * Q * k)
    for Q in (256, 32):
        probe = x["probe"][:Q]
        P = probe.shape[1]
        U = int(torch.unique(probe).numel())
        for k in (10,) + WIDE_TIMED_K:
            name = (f"posting_scan_topk Q={Q}" if k == 10
                    else f"posting_scan_topk Q={Q} k={k}")
            out[name] = (2.0 * Q * P * C * d + 2.0 * U * C * d,
                         4.0 * Q * d + U * C * (4.0 * d + 1) + 8.0 * Q * P
                         + 8.0 * Q * k)
    if "quant" in x:
        a = x["quant"]
        _, V, m, ksub = a["luts"].shape
        for name, probe in (("pq_scan_topk Q=256", a["probe"]),
                            ("pq_scan_topk Q=32", a["probe"][:32])):
            Q, P = probe.shape
            U = int(torch.unique(probe).numel())
            out[name] = (1.0 * Q * P * C * m,
                         4.0 * Q * V * m * ksub + U * C * (m + 1.0)
                         + 4.0 * U + 8.0 * Q * P + 8.0 * Q * a["R"])
    for key, name in (("quant", "rerank_topk Q=256 k=10"),
                      ("tier", "rerank_topk tiered k=192")):
        if key in x:
            b = x[key]
            Q, R = b["cand"].shape
            read = ((b["adc"] < 5e29)
                    & ~b["spilled"][(b["cand"] // C).long()])
            rows = float(read.sum())
            out[name] = (4.0 * rows * d,
                         4.0 * rows * d + 4.0 * Q * d + 9.0 * Q * R
                         + 8.0 * Q * b["k"])
    for Q in (256, 32):
        probe = x["probe"][:Q]
        U = int(torch.unique(probe).numel())
        out[f"posting_scan_gather Q={Q}"] = gather_work(
            Q, probe.shape[1], U, C, d)
        if "quant" in x:
            a = x["quant"]
            probe = a["probe"][:Q]
            U = int(torch.unique(probe).numel())
            out[f"pq_scan_gather Q={Q}"] = pq_gather_work(
                Q, probe.shape[1], U, C, *a["luts"].shape[1:])
    return out


def gather_work(Q: int, P: int, U: int, C: int, d: int) -> tuple:
    """``posting_scan_gather``'s operations and bytes: every (query,
    probe) slot's dot product and each distinct probed tile's norms; the
    queries, the U distinct tiles with their slot_valid rows, the probes
    read once, the (Q, P, C) scores written once."""
    return (2.0 * Q * P * C * d + 2.0 * U * C * d,
            4.0 * Q * d + U * C * (4.0 * d + 1) + 4.0 * Q * P
            + 4.0 * Q * P * C)


def pq_gather_work(Q: int, P: int, U: int, C: int, V: int, m: int,
                   ksub: int) -> tuple:
    """``pq_scan_gather``'s operations and bytes: m lookups and adds a
    slot; the tables, the U distinct code tiles with their slot_valid
    rows and codebook slots, the probes read once, the scores written
    once."""
    return (1.0 * Q * P * C * m,
            4.0 * Q * V * m * ksub + U * C * (m + 1.0) + 4.0 * U
            + 4.0 * Q * P + 4.0 * Q * P * C)


#: run in a checkout (another tree's, or this one's) by ``--parent-tree``:
#: its ``ops`` timed on this run's inputs with this file's timers, in a
#: fresh process
PARENT_TIMER = """
import json, sys, torch
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import ops
x = torch.load({path!r}, map_location="cuda")
times = {{n: [cs.median_ms(f, cs.TOPK_REPS),
              cs.device_kernels(f, kernel=n.split()[0])]
          for n, f in cs.topk_cases(ops, x).items()}}
print(json.dumps({{"times": times, "misses": cs.PROFILE_MISSES}}))
"""
#: calls a median of phase 4's top-k times takes (a call's time holds the
#: host's launch, which varies from call to call)
TOPK_REPS = 50


def tree_topk_times(tree: str, path: str) -> tuple:
    """``tree``'s top-k and gather kernels timed in a fresh process on
    the inputs saved at ``path``: (name -> [ms a call, device kernels],
    that process's ``PROFILE_MISSES``)."""
    tree, path = os.path.abspath(tree), os.path.abspath(path)
    out = subprocess.run(
        [sys.executable, "-c", PARENT_TIMER.format(
            src=os.path.join(tree, "src"), root=ROOT, path=path)],
        capture_output=True, text=True, timeout=600, cwd=tree)
    if out.returncode != 0:
        fail(f"timing {tree} in a fresh process: exit {out.returncode}: "
             f"{out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return res["times"], res["misses"]


def short_kernel(k: str) -> str:
    """A device kernel's name without its return type, namespace, template
    arguments and parameters."""
    return re.sub(r"^void |<.*$|\(.*$", "",
                  k.replace("(anonymous namespace)::", ""))


def kernel_split(kern: dict, name: str) -> tuple:
    """(the named kernel's device ms, with its merge or its gather's
    inversion; those kernels' ms by short name; the other kernels' ms by
    short name) from ``device_kernels``."""
    def short(k):
        return short_kernel(k)[:40]

    def mine(k):
        return name in k or "topk_merge" in k
    parts = {short(k): v for k, v in kern.items() if mine(k)}
    rest = {short(k): v for k, v in kern.items() if not mine(k)}
    return sum(parts.values()), parts, rest


def time_topk_shapes(ops, x, parent_tree=None) -> None:
    """Rows 2 and 4-8 on ``topk_inputs``: the index paths' batch (Q =
    256), the serving batch (Q = 32), the cache scan, the ADC scan, the
    rerank (quant k = 10, tiered k = 192) and the two gathers (Q = 256
    and 32): the time a call (CUDA events, median of 50) and the device
    time (``device_kernels``, mean of 20): all of it, the kernel's own
    (with its merge, or the gather's inversion, each listed) and the
    wrapper's other kernels listed apart; beside the fp32 bound and, for
    the centroid kernel, the 3xTF32 bound.  This tree's kernels are also
    timed in a fresh process on the same inputs: a call's host time
    differs between a fresh process and this one, and this process's
    profiler sessions lose device events after the paths have run (the
    fresh process's shortfalls are printed beside).  With
    ``parent_tree`` (another checkout, a parent commit) its kernels are
    timed in a fresh process before and after this tree's: parent,
    change (fresh), change, parent."""
    work = topk_work(x)
    path = os.path.join(parent_tree or ROOT, "_topk_inputs.pt")
    before = after = {}
    torch.save(x, path)
    if parent_tree:
        before, _ = tree_topk_times(parent_tree, path)
    sub, misses = tree_topk_times(ROOT, path)
    mine = {n: (median_ms(f, TOPK_REPS),
                device_kernels(f, kernel=n.split()[0]))
            for n, f in topk_cases(ops, x).items()}
    if parent_tree:
        after, _ = tree_topk_times(parent_tree, path)
    os.remove(path)

    def dev(kern, name):
        if not kern:
            return "not measured on the card (no profiler events)"
        own, parts, rest = kernel_split(kern, name.split()[0])
        text = f"{sum(kern.values()):.4f} ms on the card ({own:.4f} kernel"
        if len(parts) > 1:
            text += " = " + " + ".join(f"{k} {v:.4f}"
                                       for k, v in parts.items())
        if rest:
            text += "; wrapper " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in rest.items())
        return text + ")"

    for name, (ms, kern) in mine.items():
        b, by = bound(*work[name])
        line = (f"  {name}: {ms:.4f} ms a call, {dev(kern, name)};"
                f" bound {b:.4f} ms ({by})")
        if name.startswith("centroid_topk"):
            line += f", 3xTF32 {bound_3xtf32(*work[name]):.4f} ms"
        say(line)
        say(f"    in a fresh process: {sub[name][0]:.4f} ms a call, "
            f"{dev(sub[name][1], name)}")
        if name in before:
            say(f"    parent tree: {before[name][0]:.4f} / "
                f"{after[name][0]:.4f} ms a call; "
                f"{dev(before[name][1], name)} / "
                f"{dev(after[name][1], name)}")
    say(f"  the fresh process's profiler sessions: {misses['retried']} "
        f"opened again, {misses['not_measured']} calls not measured; "
        f"first shortfalls {misses['short']}")


#: run in another checkout by ``--parent-tree``: ``prefix_checks`` on that
#: tree's kernels, in a fresh process
PARENT_PREFIX = """
import json, sys, torch
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import ops
print(json.dumps(cs.prefix_checks(ops, torch.device("cuda"), {seed})))
"""


def parent_prefix(tree: str, seed: int) -> None:
    """Phase 2's prefix check (``prefix_checks``) on ``tree``'s kernels:
    printed, not gated (an older tree's wide path may score with other
    arithmetic than its warp path)."""
    tree = os.path.abspath(tree)
    out = subprocess.run(
        [sys.executable, "-c", PARENT_PREFIX.format(
            src=os.path.join(tree, "src"), root=ROOT, seed=seed)],
        capture_output=True, text=True, timeout=600, cwd=tree)
    if out.returncode != 0:
        fail(f"the prefix check on {tree}: exit {out.returncode}: "
             f"{out.stderr[-2000:]}")
    bad = json.loads(out.stdout.strip().splitlines()[-1])
    say(f"  parent tree's wide top-k prefix check (phase 2's, not gated): "
        + ("; ".join(bad) if bad else "passes"))


def time_wide_layouts(ops, x) -> None:
    """The wide ``centroid_topk``'s two launch layouts (kernels/
    centroid_topk.py: ``wide_plan``) at phase 4's wide shapes, each
    forced: one block an SM with the longest lists that fit, and two an
    SM (16-row tiles, lists of ``PAIR_CAP``) where k fits them; device
    time alone (``device_ms``), and both answers equal."""
    from repro_torch.kernels import centroid_topk as ct

    def one(Q, M, k):
        bq = 32 if Q > 32 and ct.list_cap(32) >= k + 128 else 16
        return ct._wide_launch(Q, M, k, bq, ct.list_cap(bq), ct._SMS)

    def two(Q, M, k):
        return ct._wide_launch(Q, M, k, 16, ct.PAIR_CAP, ct._TARGET_BLOCKS)

    q = x["q"]
    shapes = [(f"cache scan k={k}", q, x["cache"], x["cache_ok"], k)
              for k in WIDE_TIMED_K]
    shapes += [(f"Q={Q} k={k}", q[:Q], x["cen"], x["vis"], k)
               for Q in (256, 32) for k in WIDE_TIMED_K]
    plan, parts = ct.wide_plan, []
    try:
        for label, qq, cen, ok, k in shapes:
            times, outs = [], []
            for name, layout in (("one an SM", one), ("two an SM", two)):
                if name == "two an SM" and k + 128 > ct.PAIR_CAP:
                    continue
                ct.wide_plan = layout
                fn = (lambda qq=qq, cen=cen, ok=ok, k=k:
                      ops.centroid_topk(qq, cen, ok, k=k))
                outs.append(fn())
                p = layout(len(qq), len(cen), k)
                times.append(f"{name} (bq {p.bq}, lists {p.cap}, "
                             f"{-(-len(qq) // p.bq) * p.nchunks} blocks) "
                             f"{ms_text(device_ms(fn, 'centroid_topk'))}")
            ct.wide_plan = plan
            chosen = plan(len(qq), len(cen), k)
            for o in outs[1:]:
                require_exact(f"wide layouts [{label}]", o, outs[0])
            parts.append(f"{label}: " + ", ".join(times)
                         + f" (taken: bq {chosen.bq}, lists {chosen.cap})")
    finally:
        ct.wide_plan = plan
    say("  wide centroid_topk layouts (device time, torch.profiler): "
        + "; ".join(parts))


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
        assign_close, *assign_work(B, B, N, K, ds)))
    del full
    on_card = device_ms(lambda: ops.kmeans_assign(pts, cents),
                        "kmeans_assign")
    say(f"  kmeans_assign at the fit shape ({B} x {N} x {K} x {ds}): "
        f"{rows[-1]['ms']:.4f} ms a call, {ms_text(on_card)} of it on the "
        "card (torch.profiler, mean of 20)")
    time_assign_shapes(ops, ref, st, flat, live)

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
    for k in WIDE_TIMED_K:
        wide[f"centroid_topk cache scan k={k}"] = (
            median_ms(lambda: ops.centroid_topk(fq, fst.cache_vecs,
                                                fst.cache_valid, k=k)),
            median_ms(lambda: ref.centroid_topk(fq, fst.cache_vecs,
                                                fst.cache_valid, k)))
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


def assign_work(B: int, Bp: int, N: int, K: int, ds: int) -> tuple:
    """``kmeans_assign``'s operations and bytes: B codebooks of K x ds
    over Bp point batches of N rows; (assign, best) written once."""
    return (2.0 * B * N * K * ds + 2.0 * B * K * ds,
            4.0 * (Bp * N * ds + B * K * ds) + 8.0 * B * N)


def time_assign_shapes(ops, ref, st, flat, live) -> None:
    """``kmeans_assign`` at its two other main-path shapes on the quant
    state (printed): the insert round's ``encode_all_versions`` (2,048
    rows under all V*m codebooks, over m point batches) beside its plain
    version and ``baddbmm``, and the re-train's full re-encode (every
    slot of the pool, ``encode_tiles``) with no plain run (its score
    matrix would take 103 GB), held against the plain version on its
    first 65,536 rows; its library yardstick is ``baddbmm`` over the
    rows in 48 chunks, summed in one timed call."""
    M, C, d = st.vectors.shape
    V, m, K, ds = st.pq_codebooks.shape
    cb_all = st.pq_codebooks.reshape(V * m, K, ds).contiguous()
    rows = flat[live[:2048]].contiguous()
    J = rows.shape[0]
    pts = rows.view(J, m, ds).transpose(0, 1)
    rep = pts.repeat(V, 1, 1).contiguous()
    cn = (cb_all * cb_all).sum(-1)[:, None, :]
    full = cn - 2.0 * torch.bmm(rep, cb_all.transpose(1, 2))
    check_assign("kmeans_assign, insert round's shape",
                 ops.kmeans_assign(pts, cb_all),
                 ref.kmeans_assign(pts, cb_all), full)
    del full
    ins = (median_ms(lambda: ops.kmeans_assign(pts, cb_all)),
           median_ms(lambda: ref.kmeans_assign(pts, cb_all)),
           median_ms(lambda: torch.baddbmm(cn, rep, cb_all.transpose(1, 2),
                                           alpha=-2)),
           bound(*assign_work(V * m, m, J, K, ds)))
    cb = st.pq_codebooks[int(st.pq_active)].contiguous()
    every = st.vectors.view(M * C, m, ds).transpose(0, 1)
    got = ops.kmeans_assign(every, cb)
    head = every[:, :65536]
    cn1 = (cb * cb).sum(-1)[:, None, :]
    check_assign("kmeans_assign, full re-encode's shape (first rows)",
                 (got[0][:, :65536], got[1][:, :65536]),
                 ref.kmeans_assign(head, cb),
                 cn1 - 2.0 * torch.bmm(head.contiguous(),
                                       cb.transpose(1, 2)))
    del got
    cbt = cb.transpose(1, 2)
    tile = M * C // 48                  # a 2 GB score block a chunk

    def library():
        """The same scores by ``baddbmm`` (no argmin), chunk by chunk."""
        buf = torch.empty((m, tile, K), device=cb.device)
        for off in range(0, M * C, tile):
            part = every[:, off:off + tile]
            if part.shape[1] == tile:
                torch.baddbmm(cn1, part, cbt, alpha=-2, out=buf)
            else:
                torch.baddbmm(cn1, part, cbt, alpha=-2)
    enc = (median_ms(lambda: ops.kmeans_assign(every, cb), reps=5, warm=1),
           bound(*assign_work(m, m, M * C, K, ds)),
           median_ms(library, reps=5, warm=1))
    torch.cuda.synchronize()
    say(f"  kmeans_assign at the insert round's encode ({J} rows x {V * m} "
        f"codebooks over {m}, {K} x {ds}): {ins[0]:.4f} ms (plain "
        f"{ins[1]:.4f}, baddbmm {ins[2]:.4f}, bound {ins[3][0]:.4f} by "
        f"{ins[3][1]}); at the full re-encode ({M * C} rows x {m} "
        f"codebooks, {K} x {ds}): {enc[0]:.4f} ms (bound {enc[1][0]:.4f} "
        f"by {enc[1][1]}, baddbmm in {-(-M * C // tile)} chunks of {tile} "
        f"rows {enc[2]:.4f})")


def time_gathers(ops, ref, fdrv, qdrv, x, counts) -> list:
    """The two gather kernels on phase 3e's inputs: the float state's
    (256 queries x 32 probes x 96 slots x 128-d) and the quant state's
    (PQ16 tables of both codebook slots).  Bounds count only the distinct
    probed tiles, each read once, and the (Q, P, C) output.  The library
    yardstick of ``posting_scan_gather`` is ``torch.baddbmm`` over the
    probed tiles and their norms gathered by ``index_select`` inside the
    timed call; ``pq_scan_gather`` has none (no single PyTorch call does a
    per-code table-lookup sum)."""
    rows = []
    st = fdrv.state
    q, pr, vis = x["q"], x["probe"], x["vis"]
    M, C, d = st.vectors.shape
    Q, P = pr.shape
    U = int(torch.unique(pr).numel())
    flat_pr = pr.reshape(-1).long()
    vn = (st.vectors * st.vectors).sum(-1)                    # (M, C)
    valid = st.slot_valid & vis[:, None]
    rows.append(timed_row(
        ops, counts, "posting_scan_gather",
        lambda: ops.posting_scan_gather(q, st.vectors, st.slot_valid, vis,
                                        pr),
        lambda: ref.posting_scan_gather(q, st.vectors, valid, pr),
        lambda: torch.baddbmm(
            vn.index_select(0, flat_pr).view(Q, P * C, 1),
            st.vectors.index_select(0, flat_pr).view(Q, P * C, d),
            q[:, :, None], alpha=-2),
        lambda a, b: require_close("posting_scan_gather, timed inputs", a,
                                   b),
        *gather_work(Q, P, U, C, d)))
    st = qdrv.state
    luts, qpr, qvis = x["luts"], x["qprobe"], x["qvis"]
    V, m, ksub = luts.shape[1:]
    U = int(torch.unique(qpr).numel())
    slot = st.pq_posting_slot.clamp(0, V - 1)
    qvalid = st.slot_valid & qvis[:, None]

    def exact(a, b):
        require_exact("pq_scan_gather, timed inputs", (a,), (b,))
        return 0.0

    rows.append(timed_row(
        ops, counts, "pq_scan_gather",
        lambda: ops.pq_scan_gather(luts, st.codes, st.pq_posting_slot,
                                   st.slot_valid, qvis, qpr),
        lambda: ref.pq_scan_gather(luts, st.codes, slot, qvalid, qpr),
        None, exact, *pq_gather_work(Q, P, U, C, V, m, ksub)))
    return rows


def sdpa_backend(fn) -> tuple:
    """The backend a ``scaled_dot_product_attention`` call dispatched to,
    read off the names of the device kernels one call launches under
    ``torch.profiler`` (``device_kernels``): (label, the names); "not
    measured" where the profiler saw no device event."""
    names = sorted(device_kernels(fn, reps=1))
    if not names:
        return "not measured", names
    low = " ".join(names).lower()
    for keys, label in ((("memeff", "fmha", "efficient"), "efficient"),
                        (("flash",), "flash"), (("cudnn",), "cudnn")):
        if any(key in low for key in keys):
            return label, names
    return "math", names


def time_attention(ops, ref, dev, counts, seed: int,
                   shape=SERVE_ATTN) -> dict:
    """``flash_attention`` at a backbone's shape (B, Hq, Hkv, L, D),
    causal, on random normal q, k, v: by default the serving path's
    (every layer of the backbone gives it B=64, Hq=32, Hkv=4, L=512,
    D=64), or phase 3j's prefill's (``DECODE_ATTN``).  The yardstick is
    the faster of two
    ``scaled_dot_product_attention`` calls with ``is_causal=True`` (its
    top-left causal alignment equals the end alignment here, Lq = Lk):
    one with ``enable_gqa=True``, one on k and v expanded to Hq heads by
    ``repeat_interleave`` inside the timed call (fp32 GQA may leave the
    fused backends; the expanded call can take the memory-efficient one).
    Each is checked against the plain version, and the backend each ran
    is printed."""
    import torch.nn.functional as F
    g = np.random.default_rng(seed + 2)
    B, Hq, Hkv, L, D = shape
    G = Hq // Hkv
    q, k, v = (torch.as_tensor(g.standard_normal(s, np.float32), device=dev)
               for s in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    plain = lambda: ref.flash_attention(q, k, v, causal=True)  # noqa: E731
    work = (4.0 * B * Hq * D * L * (L + 1) / 2,
            4.0 * (2 * B * Hq * L * D + 2 * B * Hkv * L * D))
    row = timed_row(
        ops, counts, "flash_attention",
        lambda: ops.flash_attention(q, k, v, causal=True), plain, None,
        lambda a, b: require_attn_close("flash_attention, timed inputs", a,
                                        b), *work)
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
    on_card = device_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                        "flash_attention")
    say(f"  flash_attention at {shape}: {row['ms']:.4f} ms a call "
        f"(plain {row['plain_ms']:.4f} ms; {ms_text(on_card)} "
        f"on the card, torch.profiler), fp32 bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), 3xTF32 bound {bound_3xtf32(*work):.4f} ms, "
        f"faster SDPA {row['library_ms']:.4f} ms")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row


def copy_overlap(prof) -> dict:
    """The tier's copies in a profiled window, from its Chrome trace:
    per stream the device copies (count, microseconds, by direction) and
    the kernels' count; ``overlap_us``, the copy time on streams other
    than the one with the most kernels (the tier's side stream) that ran
    while a kernel ran on that main stream."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    per, kern = {}, {}
    for ev in events:
        cat = str(ev.get("cat", "")).lower()
        if ev.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy"):
            continue
        sid = (ev.get("args") or {}).get("stream", ev.get("tid"))
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
        if cat == "kernel":
            kern.setdefault(sid, []).append(span)
            continue
        name = str(ev.get("name", ""))
        way = ("DtoH" if "DtoH" in name else "HtoD" if "HtoD" in name
               else "DtoD")
        row = per.setdefault(sid, {})
        n, us = row.get(way, (0, 0.0))
        row[way] = (n + 1, us + span[1] - span[0])
        row.setdefault("spans", []).append(span)
    main = max(kern, key=lambda k: len(kern[k])) if kern else None
    busy = sorted(kern.get(main, []))
    overlap = 0.0
    for sid, row in per.items():
        if sid == main:
            continue
        for a, b in row["spans"]:
            for c, e in busy:
                if c >= b:
                    break
                overlap += max(0.0, min(b, e) - max(a, c))
    streams = {str(sid): {k: v for k, v in row.items() if k != "spans"}
               for sid, row in per.items()}
    for sid, spans in kern.items():
        streams.setdefault(str(sid), {})["kernels"] = len(spans)
    return {"main_stream": str(main), "streams": streams,
            "overlap_us": overlap}


def profile_windows(drv, stream, qdrv, qstream, tdrv, tstream,
                    embed_batch, sdrv, sstream, decode_step) -> dict:
    """Device time by kernel over seven windows, with ``torch.profiler``:
    on the float path one load chunk (20k inserts, then ticks until
    quiescent) and one streaming step (20k inserts, 10k deletes, a tick,
    a 256-query search); on the quant path, the tiered path and the
    sharded float path (phase 3h-1's driver) one streaming step each; on
    the serving path one embedded batch of 64 x 512 tokens; on the
    decode path one decode step (B=16, 576 cache positions).  The busy
    share is device time over wall time (kernels of one stream do not
    overlap; on the tiered path the tier's copies run on a side stream,
    reported apart with their overlap); the wall time includes the
    profiler's own host overhead."""
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
                     ("tier_stream_step", lambda: step(tdrv, tstream)),
                     ("sharded_stream_step", lambda: step(sdrv, sstream)),
                     ("serve_embed_batch", embed_batch),
                     ("decode_step", decode_step)):
        wall, busy, rows, prof = window(fn)
        windows[name] = {
            "wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if busy is not None else None,
            "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in rows[:10]]}
        say(f"  profile {name}: wall {wall:.4f} s, {busy_text(wall, busy)}")
        for i, (k, ms, c) in enumerate(rows):
            if i < 6 or any(p in k for p in PORT_KERNELS):
                say(f"    {ms:9.3f} ms  {c:6d} calls  {k[:70]}")
        wide = [(k, ms) for k, ms, _ in rows if "_wide" in k]
        if wide:
            windows[name]["wide_topk_ms"] = sum(ms for _, ms in wide)
            say(f"    the wide top-k (k > 32) apart: "
                f"{sum(ms for _, ms in wide):.3f} ms = " + " + ".join(
                    f"{short_kernel(k)} {ms:.3f}" for k, ms in wide))
        if name == "tier_stream_step":
            windows[name]["copies"] = cp = copy_overlap(prof)
            say(f"    tier copies by stream (main {cp['main_stream']}): "
                f"{json.dumps(cp['streams'])}; side-stream copy time "
                f"overlapping main-stream kernels {cp['overlap_us']:.1f} us")
    return windows


def guard_cost(ops, dev, n: int = 200_000) -> None:
    """Host microseconds a launch pays for the device guard of the
    kernel wrappers (the card already current: the common case, and
    every sharded stage's) and for ``ops``' same-device check of the
    inputs, each the mean of ``n`` calls."""
    from repro_torch.kernels import _nvcc
    d = torch.device(dev.type, torch.cuda.current_device())
    q = torch.zeros(4, 8, device=d)
    c = torch.zeros(16, 8, device=d)
    v = torch.ones(16, dtype=torch.bool, device=d)
    t = time.perf_counter()
    for _ in range(n):
        with _nvcc.on_device(d):
            pass
    guard = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for _ in range(n):
        ops._on_card(q, c, v)
    check = (time.perf_counter() - t) / n * 1e6
    say(f"  device guard a launch (card current): {guard:.3f} us; the "
        f"inputs' same-device check a call: {check:.3f} us (host time, "
        f"mean of {n:,})")


def parent_phase_times(path: str) -> dict:
    """Phase -> seconds from the ``  phase 3h: ... s`` lines of another
    run's standard output."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"\s+phase (3[a-z]): ([0-9.]+) s", line)
            if m:
                out[m.group(1)] = float(m.group(2))
    return out


def parent_phase_text(times: dict, phase: str) -> str:
    return (f" (parent tree, same call: {times[phase]:.1f} s)"
            if phase in times else "")


def parent_times(path: str) -> dict:
    """Kernel name -> ms from the ``{"kernels": ...}`` line of another
    run's standard output."""
    with open(path) as f:
        for line in f:
            if line.startswith('{"kernels"'):
                return {r["name"]: r["ms"] for r in json.loads(line)["kernels"]}
    fail(f"no kernel line in {path}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-tree", metavar="DIR",
                    help="another checkout (a parent commit, unpacked): "
                         "its centroid_topk, posting_scan_topk, pq_scan_topk, "
                         "rerank_topk and the two gathers are timed on this "
                         "run's inputs in phase 4, before and after this "
                         "tree's")
    ap.add_argument("--parent-log", metavar="PATH",
                    help="the standard output of another tree's "
                         "chip_smoke.py run earlier on the same card (a "
                         "parent commit): its kernel times are printed "
                         "beside this run's in phase 4")
    args = ap.parse_args()

    t_start = time.perf_counter()
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
    for name in _nvcc.kernel_names():        # one entry per instance
        log = _nvcc.build_log(name)
        if name in PTXAS_BY_INSTANCE:
            for entry, spill, regs in ptxas_instances(log):
                say(f"  ptxas {name}: {entry}: registers {regs}, spill "
                    f"stores {spill} bytes")
            continue
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        say(f"  ptxas {name}: registers {'/'.join(regs)}; spill stores "
            f"{'/'.join(spills)} bytes")

    say("phase 2: kernels against their plain versions")
    t = time.perf_counter()
    with watchdog(PHASE2_LIMIT_S, "phase 2"):
        kernel_checks(ops, ref, dev, args.seed)
        masked_score_checks(ops, ref, dev, args.seed)
        topk_checks(ops, ref, dev, args.seed)
        wide_checks(ops, ref, dev, args.seed)
        quant_checks(ops, ref, dev, args.seed)
        gather_checks(ops, ref, dev, args.seed)
        attention_checks(ops, ref, dev, args.seed)
        kmeans_checks(ops, ref, dev, args.seed)
        torch.cuda.empty_cache()
    say(f"  {time.perf_counter() - t:.1f} s")
    guard_cost(ops, dev)

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
        say(f"  launches on the {label} path: {json.dumps(launched)}"
            + wide_text(ops))
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
        paths[label] = (drv, q, recalls, stream, secs)
        counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    say("  recall@10 per step (gated >= 0.9 on both paths): float "
        f"{paths['float'][2]}, quant {paths['quant'][2]}")
    qdrv, qq = paths["quant"][:2]
    say("  recall@10 of the last step's queries on the quant state (not "
        f"gated): ADC + rerank {paths['quant'][2][-1]:.4f}, float-plane "
        f"search {float_plane_recall(qdrv, qq):.4f}")

    say("phase 3e: the unfused search oracle on the float and quant states")
    launched, oracle_in = oracle_checks(ops, ref, paths["float"][0], qdrv,
                                        paths["float"][1], qq)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}

    say(f"phase 3f: tiered path (use_tier, tier_async, 256 moves per tick, "
        f"tier_hot_max {TIER_HOT_MAX}, a re-train every {TIER_RETRAIN_EVERY} "
        "ticks), the quant path's configuration and data")
    ops.reset_launch_counts()
    tdrv, tq, tsecs, trecalls, tstream = main_path(
        dev, n=1_000_000, dim=128, max_postings=65504, cache_capacity=4096,
        steps=5, fresh=20000, dels=10000, queries=256, chunk=20000,
        seed=args.seed, round_size=2048, bg_ops=64, quant=True,
        pq_retrain_every=TIER_RETRAIN_EVERY, tier_hot_max=TIER_HOT_MAX,
        data=QUANT_DATA)
    launched = ops.launch_counts()
    say(f"  seconds per phase: {json.dumps({k: round(v, 3) for k, v in tsecs.items()})}")
    say(f"  launches on the tier path: {json.dumps(launched)}"
        + wide_text(ops))
    for name in PATH_KERNELS["tier"]:
        if launched[name] <= 0:
            fail(f"kernel {name} was never launched on the tier path")
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    say(f"  recall@10 per step (gated >= 0.9): tiered {trecalls}, untiered "
        f"quant {paths['quant'][2]}")
    tier_checks(tdrv, tsecs, paths["quant"][4], len(trecalls))

    say(f"phase 3c: the quant path on the float path's data at {QUANT_3C:,} "
        "vectors (1 step, not gated)")
    drv, *_ = main_path(
        dev, n=QUANT_3C, dim=128, max_postings=65504, cache_capacity=4096,
        steps=1, fresh=20000, dels=10000, queries=256, chunk=20000,
        seed=args.seed, round_size=2048, bg_ops=64, quant=True, gate=False)
    del drv
    torch.cuda.empty_cache()

    say("phase 3d: the serving path, RetrievalServer over tinyllama-1.1b at "
        "full width, 2048 docs x 512 tokens")
    server, launched, toks, _ = serve_path(dev, ops, ref, seed=args.seed)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}

    say("phase 3g: the front door (make_index over list_engines(), "
        "fused_tick, the sequential ops, the JSONL tracer)")
    for launched in (
            fused_path(dev, ops, paths["float"][0], paths["float"][4],
                       args.seed),
            engine_streams(dev, ops, args.seed),
            sequential_checks(dev, ops, args.seed)):
        counts = {k: counts.get(k, 0) + v for k, v in launched.items()}

    parent_phase = (parent_phase_times(args.parent_log) if args.parent_log
                    else {})
    say(f"phase 3h: the sharded plane, make_index('ubis-sharded') on "
        f"{SHARDS} shards of the card, each in storage of its own")
    t = time.perf_counter()
    launched, sdrv, sstream, _ = sharded_path(
        dev, ops, (paths["quant"][0], paths["quant"][3]), args.seed)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    launched = skew_runs(dev, ops, args.seed)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    say(f"  phase 3h: {time.perf_counter() - t:.1f} s"
        + parent_phase_text(parent_phase, "3h"))

    say("phase 3l: the data x model mesh (2, 2) on the card, every cell "
        "in storage of its own, against (1, 2)")
    t = time.perf_counter()
    launched = rows_on_one_card(ops, ref, args.seed)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    say(f"  phase 3l: {time.perf_counter() - t:.1f} s")

    mode = compute_mode()
    say(f"phase 3i: the cluster plane, make_index('ubis-cluster'); compute "
        f"mode {mode}")
    if mode != "Default":
        fail(f"compute mode {mode}: two worker processes need two CUDA "
             "contexts on the card (Default)")
    t = time.perf_counter()
    for launched in (cluster_float_path(dev, ops, args.seed),
                     seam_check(dev, ops, ref, args.seed),
                     figdist_runs(dev, ops, args.seed)):
        counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    say(f"  phase 3i: {time.perf_counter() - t:.1f} s"
        + parent_phase_text(parent_phase, "3i"))

    say("phase 3j: the backbone's decode path, tinyllama-1.1b at full width "
        f"(prefill {DECODE['batch']} x {DECODE['prompt']}, KV caches of "
        f"{DECODE['ctx']}, {DECODE['steps']} greedy decode steps), then "
        "six variants at reduced size")
    t = time.perf_counter()
    launched, decode_step = decode_path(dev, ops, ref, smi, seed=args.seed)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    launched = decode_variants(dev, ops, ref, args.seed)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    torch.cuda.empty_cache()
    say(f"  phase 3j: {time.perf_counter() - t:.1f} s")

    say(f"phase 3k: the sharded plane with one shard a card "
        f"({torch.cuda.device_count()} cards in this process)")
    t = time.perf_counter()
    for k, v in multi_card_skew(ops, ref, args.seed).items():
        counts[k] = counts.get(k, 0) + v        # {} on a one-card machine
    say(f"  phase 3k: {time.perf_counter() - t:.1f} s")

    say("phase 4: kernel times on the main paths' inputs")
    fdrv, fq, _, fstream, _ = paths["float"]
    qdrv, qq, _, qstream, _ = paths["quant"]
    rows = time_kernels(ops, ref, fdrv, fq, counts)
    x = topk_inputs(ops, fdrv, fq, qdrv, qq, tdrv, tq)
    time_topk_shapes(ops, x, args.parent_tree)
    time_wide_layouts(ops, x)
    del x
    if args.parent_tree:
        parent_prefix(args.parent_tree, args.seed)
    rows += time_quant_kernels(ops, ref, qdrv, fdrv, qq, counts)
    rows += time_gathers(ops, ref, fdrv, qdrv, oracle_in, counts)
    rows.append(time_attention(ops, ref, dev, counts, args.seed))
    time_attention(ops, ref, dev, counts, args.seed, DECODE_ATTN)
    before = parent_times(args.parent_log) if args.parent_log else {}
    for r in rows:
        was = (f", parent tree {before[r['name']]:.4f} ms"
               if r["name"] in before else "")
        say(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f"{was}), launches {r['launches']}, max err "
            f"{r['max_abs_err']:.3g}")
    say("phase 4b: device time by kernel (torch.profiler)")
    profile_windows(fdrv, fstream, qdrv, qstream, tdrv, tstream,
                    lambda: server.embedder.embed(toks), sdrv, sstream,
                    decode_step)
    tdrv.close()
    say(f"  profiler sessions short of the expected device events: "
        f"{PROFILE_MISSES['retried']} opened again, "
        f"{PROFILE_MISSES['not_measured']} calls not measured; first "
        f"shortfalls (kernel, events, calls): {PROFILE_MISSES['short']}")
    say(f"  chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
