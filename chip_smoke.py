#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # the full run, one card

Phases, in order (any failure exits non-zero before the last line):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the parallel ``nvcc`` build of every kernel source.
2. Each of the four kernels against its plain PyTorch version on the
   card: at the main path's shapes on integer-valued data (exact
   arithmetic in any summation order, so ids and scores must match
   exactly) and at the edge shapes of the CPU tests (d=100 with odd C,
   all masked, integer ties).
3. The main path at SIFT1M's shape through ``make_index``: 1,000,000
   clustered 128-d vectors made from ``--seed`` with numpy are loaded
   through insert rounds (with background ticks), then 5 streaming steps
   of 20k drifted inserts, 10k deletes of the oldest ids, ``tick()``, a
   256-query search at k=10 and the exact oracle on the same queries.
   Checks: recall@10 >= 0.9 at every step, ``live_count()`` equals
   inserted - deleted, the id_loc <-> slots invariants, and every kernel
   launched during the path (launch counts are reset just before it).
   Then recall@10 on harder queries, reported and not gated: queries
   pulled from their cluster centre toward the origin, where their
   neighbours spread over more postings than ``nprobe`` covers.
4. Each kernel timed (CUDA events, median of 20 runs after warm-up) on
   the main path's own inputs, beside its plain version and, for the two
   score-matrix kernels, ``torch.addmm`` as a library yardstick; the
   kernel is also held against its plain version there, within
   1e-4 * score scale (fp32 sums in another order).  Then one more load
   chunk and one more streaming step run under ``torch.profiler``: their
   wall time, device time by kernel and device busy share are printed.
5. The kernel line ``{"kernels": [...]}``, then as the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
TOL = 1e-4           # relative to the score scale: fp32 summation order


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

    def run(label, data):
        q, c, vis, tiles, valid, probe, qp_ok, k_c, k_p = data
        exact = label.startswith("int")
        check = ((lambda n, a, b: require_exact(n, a, b)) if exact
                 else (lambda n, a, b: [require_close(n, a[0], b[0])]
                       + [require_exact(n + " ids", a[1:], b[1:])]))
        out = ops.centroid_score(q, c, vis)
        check(f"centroid_score[{label}]", (out,), (ref.centroid_score(q, c, vis),))
        out = ops.centroid_topk(q, c, vis, k=k_c)
        check(f"centroid_topk[{label}]", out, ref.centroid_topk(q, c, vis, k_c))
        out = ops.posting_scan(q, tiles, valid)
        check(f"posting_scan[{label}]", (out,), (ref.posting_scan(q, tiles, valid),))
        out = ops.posting_scan_topk(q, tiles, valid, torch.ones(
            tiles.shape[0], dtype=torch.bool, device=dev), probe, k=k_p,
            qp_ok=qp_ok)
        check(f"posting_scan_topk[{label}]", out,
              ref.posting_scan_topk(q, tiles, valid, qp_ok, probe, k_p))
        torch.cuda.synchronize()
        say(f"  kernels vs plain [{label}]: ok")

    def case(Q, M, d, G, C, P, k_c, k_p, gen, p_vis=0.7):
        q, c, tiles = gen((Q, d)), gen((M, d)), gen((G, C, d))
        probe = torch.as_tensor(g.integers(0, G, (Q, P)).astype(np.int32),
                                device=dev)
        qp_ok = torch.as_tensor((g.random((Q, P)) < 0.9).astype(np.int32),
                                device=dev)
        return (q, c, mask((M,), p_vis), tiles, mask((G, C), p_vis), probe,
                qp_ok, k_c, k_p)

    # main-path shapes: insert locate / phase 1 / exact chunk / phase 2
    run("int main-path shapes",
        case(256, 65504, 128, 65504, 96, 32, 32, 10, ints))
    run("int d=100 odd C", case(19, 333, 100, 9, 33, 3, 7, 7, ints))
    run("int ties", case(70, 500, 16, 40, 24, 6, 32, 32,
                         lambda s: ints(s, -1, 2)))
    run("int all masked", case(9, 100, 16, 8, 24, 4, 5, 9, ints, 0.0))
    run("float d=100 odd C", case(19, 333, 100, 9, 33, 3, 7, 7, normal))
    run("float Q=1 k=32", case(1, 1000, 128, 50, 96, 32, 32, 32, normal))


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

class Stream:
    """Clustered vectors whose cluster centres drift between steps."""

    def __init__(self, dim: int, n_clusters: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.centers = (self.rng.standard_normal((n_clusters, dim),
                                                 np.float32) * 3.0)

    def draw(self, n: int) -> np.ndarray:
        a = self.rng.integers(0, len(self.centers), n)
        x = self.rng.standard_normal((n, self.centers.shape[1]), np.float32)
        x += self.centers[a]
        return x

    def drift(self, step: float) -> None:
        self.centers += (self.rng.standard_normal(self.centers.shape,
                                                  np.float32) * step)


def main_path(dev, *, n: int, dim: int, max_postings: int,
              cache_capacity: int, steps: int, fresh: int, dels: int,
              queries: int, chunk: int, seed: int, round_size: int,
              bg_ops: int, log=say):
    """Drive ``make_index("ubis", ...)`` through load + streaming steps.
    Returns (driver, last queries, per-phase seconds, recalls, stream)."""
    from repro_torch.api import make_index
    from repro_torch.core import metrics
    from repro_torch.core.invariants import check_invariants
    from repro_torch.core.types import UBISConfig

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = UBISConfig(dim=dim, max_postings=max_postings, capacity=96,
                     l_min=10, l_max=80, balance_factor=0.15, nprobe=32,
                     cache_capacity=cache_capacity, max_ids=1 << 21)
    secs = {}
    t = time.perf_counter()
    stream = Stream(dim, max(8, n // 500), seed)
    base = stream.draw(n)
    secs["data"] = time.perf_counter() - t

    t = time.perf_counter()
    drv = make_index("ubis", cfg, base, device=dev, seed=seed,
                     round_size=round_size, bg_ops_per_round=bg_ops,
                     drain_per_tick=round_size)
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
        log(f"  step {step}: recall@10 {rec:.4f} (gate >= 0.9, margin "
            f"{rec - 0.9:+.4f})")
        if not rec >= 0.9:
            fail(f"recall@10 {rec:.4f} < 0.9 at step {step}")
    if found.shape != (queries, 10) or not np.isfinite(
            drv.exact(q[:4], 10).scores).all():
        fail("search/exact returned the wrong shape or non-finite scores")
    live = drv.live_count()
    want = int(drv.stats["inserted"] - drv.stats["deleted"])
    if live != want:
        fail(f"live_count {live} != inserted - deleted {want}")
    check_invariants(drv.state, cfg)
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
        q = alpha * stream.centers[pick] + stream.rng.standard_normal(
            (queries, stream.centers.shape[1]), np.float32)
        out[alpha] = metrics.recall_at_k(drv.search(q, 10).ids,
                                         drv.exact(q, 10).ids)
    return out


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

    def row(name, fn, plain, library, compare, ops_n, bytes_n):
        err = compare(fn(), plain())
        b_ms, b_by = bound(ops_n, bytes_n)
        _, _, source, replaces = ops.KERNELS[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=err,
            ms=median_ms(fn), plain_ms=median_ms(plain),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=(median_ms(library) if library else None)))
        torch.cuda.synchronize()

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


def profile_windows(drv, stream) -> dict:
    """Device time by kernel over two windows of the main path, with
    ``torch.profiler``: one load chunk (20k inserts, then ticks until
    quiescent) and one streaming step (20k inserts, 10k deletes, a tick,
    a 256-query search).  The busy share is device time over wall time
    (one stream, so kernels do not overlap); the wall time includes the
    profiler's own host overhead."""
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

    def step():
        drv.insert(stream.draw(20000),
                   np.arange(next_id + 20000, next_id + 40000))
        drv.delete(np.arange(next_id, next_id + 10000))
        drv.tick()
        drv.search(stream.draw(256), 10)

    for name, fn in (("load_chunk", load_chunk), ("stream_step", step)):
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
    torch.cuda.empty_cache()
    say(f"  {time.perf_counter() - t:.1f} s")

    say("phase 3: main path, n=1000000 x 128-d")
    ops.reset_launch_counts()
    drv, q, secs, recalls, stream = main_path(
        dev, n=1_000_000, dim=128, max_postings=65504,
        cache_capacity=4096, steps=5, fresh=20000, dels=10000,
        queries=256, chunk=20000, seed=args.seed, round_size=2048,
        bg_ops=64)
    counts = ops.launch_counts()
    say(f"  seconds per phase: {json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    say(f"  launches on the main path: {json.dumps(counts)}")
    say(f"  recall@10 per step: {recalls}; live {drv.live_count()}; "
        f"stats {json.dumps({k: drv.stats[k] for k in ('inserted', 'deleted', 'rejected', 'bg_split', 'bg_merge', 'bg_compact', 'bg_deferred')})}")
    for name, n_launch in counts.items():
        if n_launch <= 0:
            fail(f"kernel {name} was never launched on the main path")
    hard = hard_recall(drv, stream, 256)
    say("  recall@10 on harder queries (alpha * centre + N(0, I), not "
        "gated): " + ", ".join(f"alpha={a}: {r:.4f}" for a, r in hard.items()))

    say("phase 4: kernel times on the main path's inputs")
    rows = time_kernels(ops, ref, drv, q, counts)
    say("phase 4b: device time by kernel (torch.profiler)")
    profile_windows(drv, stream)
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
