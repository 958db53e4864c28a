"""The port's kernels against the JAX package, on the same numpy inputs.

For each of the four kernels on the single-device float path, the
port's plain version (what ``repro_torch.kernels.ops`` runs on a CPU
tensor) is held against JAX ``ops.*`` with ``backend="pallas"`` (the
Pallas kernel in interpret mode, as tests/test_kernels.py runs it) and
with ``backend="ref"``.  Ids and tie order must match exactly.  Scores
must match within ``1e-4 * scale`` (scale: the largest real score):
the two frameworks sum the dot products in different orders, so fp32
results differ in the last bits.  Integer-valued inputs make every sum
exact, so there the scores match exactly too.

The quant plane's three kernels are held against the JAX package in
tests/test_torch_pq.py.  The launch sizing of the split top-k kernels
is plain Python and is tested here.  The CUDA kernels themselves run only
on a card:
the ``cuda``-marked tests compare each of the seven kernels, and the
wide top-k past k = 32, with its plain version and skip without
one (``chip_smoke.py`` runs the same checks on the card).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

BACKENDS = ["pallas", "ref"]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    real = want[want < 1e29]
    scale = max(1.0, float(np.abs(real).max())) if real.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def _data(rng, kind, shape):
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "ties":
        return rng.integers(-1, 2, shape).astype(np.float32)
    return rng.integers(-3, 4, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# (Q, M, d, kind, p_visible): aligned, d=100, integer ties, all masked.
# The three d=16 cases share one shape, so JAX compiles each kernel once.
SCORE_CASES = [(8, 64, 16, "normal", 0.7), (17, 33, 100, "normal", 0.7),
               (8, 64, 16, "ties", 0.7), (8, 64, 16, "int", 0.0)]


@pytest.mark.parametrize("Q,M,d,kind,p", SCORE_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_centroid_score_matches_jax(Q, M, d, kind, p, backend):
    rng = np.random.default_rng(Q * M + d + len(kind))
    q, c = _data(rng, kind, (Q, d)), _data(rng, kind, (M, d))
    vis = rng.random(M) < p
    want = jops.centroid_score(jnp.asarray(q), jnp.asarray(c),
                               jnp.asarray(vis), backend=backend)
    got = ops.centroid_score(_t(q), _t(c), _t(vis))
    _close(got.numpy(), want)


# (Q, M, d, k, kind, p_visible)
TOPK_CASES = [(8, 64, 16, 32, "normal", 0.7), (9, 70, 100, 7, "normal", 0.7),
              (8, 64, 16, 32, "ties", 0.7), (8, 64, 16, 32, "int", 0.0)]


@pytest.mark.parametrize("Q,M,d,k,kind,p", TOPK_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_centroid_topk_matches_jax(Q, M, d, k, kind, p, backend):
    rng = np.random.default_rng(Q * M + k + len(kind))
    q, c = _data(rng, kind, (Q, d)), _data(rng, kind, (M, d))
    vis = rng.random(M) < p
    ws, wi = jops.centroid_topk(jnp.asarray(q), jnp.asarray(c),
                                jnp.asarray(vis), k=k, backend=backend)
    gs, gi = ops.centroid_topk(_t(q), _t(c), _t(vis), k=k)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gs.numpy(), ws)


# (Q, G, C, d, kind, p_valid)
SCAN_CASES = [(5, 3, 24, 16, "normal", 0.6), (6, 4, 33, 100, "normal", 0.6),
              (5, 3, 24, 16, "ties", 0.6), (5, 3, 24, 16, "int", 0.0)]


@pytest.mark.parametrize("Q,G,C,d,kind,p", SCAN_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_posting_scan_matches_jax(Q, G, C, d, kind, p, backend):
    rng = np.random.default_rng(Q * G * C + d + len(kind))
    q, tiles = _data(rng, kind, (Q, d)), _data(rng, kind, (G, C, d))
    valid = rng.random((G, C)) < p
    want = jops.posting_scan(jnp.asarray(q), jnp.asarray(tiles),
                             jnp.asarray(valid), backend=backend)
    got = ops.posting_scan(_t(q), _t(tiles), _t(valid))
    _close(got.numpy(), want)


# (Q, M, C, P, d, k, kind, p_valid)
PTOPK_CASES = [(6, 12, 24, 4, 16, 32, "normal", 0.6),
               (5, 9, 33, 3, 100, 7, "normal", 0.6),
               (6, 12, 24, 4, 16, 32, "ties", 0.6),
               (6, 12, 24, 4, 16, 32, "int", 0.0)]


@pytest.mark.parametrize("Q,M,C,P,d,k,kind,p", PTOPK_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_posting_scan_topk_matches_jax(Q, M, C, P, d, k, kind, p, backend):
    rng = np.random.default_rng(Q * M * C + k + len(kind))
    q, vecs = _data(rng, kind, (Q, d)), _data(rng, kind, (M, C, d))
    slot_valid = rng.random((M, C)) < p
    vis = rng.random(M) < 0.8
    probe = rng.integers(0, M, (Q, P)).astype(np.int32)
    qp_ok = (rng.random((Q, P)) < 0.8).astype(np.int32)
    ws, wi = jops.posting_scan_topk(
        jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(slot_valid),
        jnp.asarray(vis), jnp.asarray(probe), k=k, qp_ok=jnp.asarray(qp_ok),
        backend=backend)
    gs, gi = ops.posting_scan_topk(_t(q), _t(vecs), _t(slot_valid), _t(vis),
                                   _t(probe), k=k, qp_ok=_t(qp_ok))
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gs.numpy(), ws)


def test_stable_topk_breaks_ties_lowest_index_first():
    s = torch.zeros((2, 5))
    s[1, 3] = -1.0
    vals, idx = ref.stable_topk(s, 4)
    assert idx.tolist() == [[0, 1, 2, 3], [3, 0, 1, 2]]
    assert vals[1].tolist() == [-1.0, 0.0, 0.0, 0.0]


def test_cpu_tensors_take_the_plain_version():
    """On the CPU no kernel launches: every launch count stays 0."""
    ops.reset_launch_counts()
    q, c = torch.randn(3, 8), torch.randn(10, 8)
    ops.centroid_score(q, c)
    ops.centroid_topk(q, c, k=2)
    ops.centroid_topk(q, c, k=10)
    ops.posting_scan(q, c.reshape(2, 5, 8), torch.ones(2, 5, dtype=torch.bool))
    ops.kmeans_assign(q, c)
    luts = torch.randn(3, 2, 4, 16)
    codes = torch.randint(0, 16, (2, 4, 5), dtype=torch.uint8)
    ones = torch.ones(2, 5, dtype=torch.bool)
    probe = torch.zeros(3, 2, dtype=torch.int32)
    adc, cand = ops.pq_scan_topk(luts, codes, torch.zeros(2), ones,
                                 ones[:, 0], probe, k=6)
    ops.pq_scan_gather(luts, codes, torch.zeros(2), ones, ones[:, 0], probe)
    ops.posting_scan_gather(q, c.reshape(2, 5, 8), ones, ones[:, 0], probe)
    ops.rerank_topk(q, c.reshape(2, 5, 8), ~ones[:, 0], cand, adc, k=3)
    ops.flash_attention(torch.randn(1, 2, 3, 8), torch.randn(1, 1, 5, 8),
                        torch.randn(1, 1, 5, 8), window=2)
    assert len(ops.launch_counts()) == 10
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the launch sizing of the two split top-k kernels (plain Python: runs here)
# ---------------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("Q", [1, 31, 32, 33, 256, 2048, 100000])
@pytest.mark.parametrize("M", [1, 127, 300, 4096, 65504])
def test_split_centroids_covers_each_centroid_once(Q, M, wide):
    from repro_torch.kernels import centroid_topk as ct
    chunk, nchunks = (ct.wide_plan(Q, M, ct.WARP_K + 1)[1:3] if wide
                      else ct.split_centroids(Q, M))
    assert chunk % 128 == 0 and nchunks >= 1    # whole tiles a chunk
    seen = np.zeros(M, np.int64)
    for i in range(nchunks):
        lo, hi = i * chunk, min(M, (i + 1) * chunk)
        assert hi > lo                       # no empty chunk
        seen[lo:hi] += 1
    assert (seen == 1).all()
    tile = ct.wide_plan(Q, M, ct.WARP_K + 1).bq if wide else \
        ct.query_tile(Q)
    q_tiles = -(-Q // tile)
    assert q_tiles * nchunks < 2 ** 31       # the 1-D grid's limit
    assert ct.query_tile(Q) == (32 if Q <= 32 else 64)


@pytest.mark.parametrize("Q", [32, 256])
def test_split_centroids_gives_two_blocks_per_sm(Q):
    """At the serving batch and the index paths' batch, against the main
    path's 65,504 centroids: about two blocks per SM of an H100."""
    from repro_torch.kernels import centroid_topk as ct
    _, nchunks = ct.split_centroids(Q, 65504)
    blocks = -(-Q // ct.query_tile(Q)) * nchunks
    assert 1.5 * H100_SMS <= blocks <= 2.5 * H100_SMS


@pytest.mark.parametrize("Q", [1, 31, 32, 33, 256, 300, 100000])
@pytest.mark.parametrize("P", [1, 3, 32, 64])
def test_split_probes_covers_each_probe_once(Q, P):
    from repro_torch.kernels import posting_scan as ps
    group, S = ps.split_probes(Q, P)
    assert group >= 1 and 1 <= S <= 65535   # the grid's y limit
    seen = np.zeros(P, np.int64)
    for s in range(S):
        lo, hi = s * group, min(P, (s + 1) * group)
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if Q >= 264:
        assert S == 1                        # the batch fills the card


@pytest.mark.parametrize("Q", [32, 256])
def test_split_probes_gives_two_blocks_per_sm(Q):
    """nprobe = 32 at the serving batch (32) and the index paths' (256)."""
    from repro_torch.kernels import posting_scan as ps
    _, S = ps.split_probes(Q, 32)
    assert 1.5 * H100_SMS <= Q * S <= 2.5 * H100_SMS


WIDE_K = [33, 64, 192, 264, 1023, 1024]


@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("Q", [1, 31, 32, 33, 256, 100000])
@pytest.mark.parametrize("M", [1024, 1100, 4096, 65504])
def test_centroid_wide_plan_covers_and_fits(Q, M, k):
    """The wide path's launch: whole-tile chunks covering every centroid
    once, none empty; both kernels within a block's shared memory; lists
    that hold k plus one tile; chunks of at least k centroids where M
    allows; the 1-D grid within its limit."""
    from repro_torch.kernels import centroid_topk as ct
    plan = ct.wide_plan(Q, M, k)
    assert plan.bq in (16, 32) and plan.chunk % 128 == 0
    seen = np.zeros(M, np.int64)
    for i in range(plan.nchunks):
        lo, hi = i * plan.chunk, min(M, (i + 1) * plan.chunk)
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan.cap >= k + 128 and plan.cap % 2 == 0
    assert plan.smem <= ct.SMEM_MAX and plan.merge_smem <= ct.SMEM_MAX
    assert plan.chunk >= k or plan.nchunks == 1
    assert -(-Q // plan.bq) * plan.nchunks < 2 ** 31
    if Q <= 32:
        assert plan.bq == 16                 # more blocks at a small batch


def test_centroid_wide_plan_at_every_k():
    """Every k of the wide path at the main shapes fits (the partial
    kernel's bytes do not depend on d: the ring stages 32-deep slices)."""
    from repro_torch.kernels import centroid_topk as ct
    for k in range(33, 1025):
        for Q, M in ((256, 65504), (32, 65504), (256, 4096), (1, 1100)):
            plan = ct.wide_plan(Q, M, k)
            assert plan.smem <= ct.SMEM_MAX >= plan.merge_smem
            assert plan.cap >= k + 128
            assert plan.chunk >= k or plan.nchunks == 1
    # phase 1 past nprobe 32 (one block an SM at k = 192, two at k = 64)
    # and the tiered search's cache scan at rerank_k (two blocks an SM)
    assert ct.wide_plan(256, 65504, 192)[:4] == (32, 4096, 16, 608)
    assert ct.wide_plan(256, 65504, 64)[:4] == (16, 4096, 16, 352)
    assert ct.wide_plan(256, 4096, 192)[:4] == (16, 256, 16, 352)
    assert ct.wide_plan(32, 65504, 192)[:4] == (16, 1024, 64, 1280)
    pair = ct.wide_plan(256, 65504, 64).smem
    assert 2 * (pair + 1024) <= 233472       # two blocks an SM


def _scan_walk(plan, P, C, d, k):
    """The wide scan kernel's walk: each block's probes, unit by unit, in
    batches of at most 256 rows; the buffer selects (keeps k) when a batch
    would overflow it.  Returns the positions each block scores, in order;
    asserts the buffer never overflows."""
    from repro_torch.kernels import posting_scan as ps
    R = ps.unit_rows(C, d)
    blocks = []
    for b in range(plan.S):
        pos, fill = [], 0
        for p in range(b * plan.group, min(P, (b + 1) * plan.group)):
            for r0 in range(0, C, R):
                rows = min(R, C - r0)
                for rb in range(0, rows, 256):
                    nrow = min(256, rows - rb)
                    if fill + nrow > plan.nb:
                        assert fill > k
                        fill = k
                    fill += nrow
                    assert fill <= plan.nb
                    pos += [p * C + r0 + r for r in range(rb, rb + nrow)]
        blocks.append(pos)
    return blocks


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", [1, 3, 16, 100, 128, 256, 16384, 20000])
@pytest.mark.parametrize("P,C", [(1, 1024), (5, 33), (32, 96), (64, 257)])
def test_posting_wide_plan_covers_and_fits(P, C, d, aligned):
    """The wide scan's launch at k = 33 .. 1024: every slot scored once,
    in position order within a block; the layout within a block's shared
    memory; at most 8 blocks a query (one cluster) and 5,120 pairs a
    buffer; staged tiles wherever the warp path's rows fit (d <= 16,384),
    by bulk copy where d % 4 == 0 and the rows are aligned."""
    from repro_torch.kernels import posting_scan as ps
    for Q in (1, 32, 256):
        for k in range(33, min(1024, P * C) + 1, 37):
            plan = ps.wide_scan_plan(Q, P, C, d, k, aligned)
            assert plan.smem <= ps.SMEM_MAX
            assert plan.smem == ps.wide_scan_bytes(plan.mode, d, C, plan.nb,
                                                   k, plan.S)
            assert 1 <= plan.S <= ps.MAX_SPLIT and plan.nb <= 5120
            assert plan.nb >= min(k + 256, plan.group * C)
            assert plan.S == -(-P // plan.group)
            if Q >= 67:
                assert plan.S == 1
            if d <= ps.MAX_D:
                assert plan.mode == (ps.MODE_BULK if d % 4 == 0 and aligned
                                     else ps.MODE_COPY)
            else:
                assert plan.mode == ps.MODE_DIRECT
            if k in (33, 1024 - 1024 % 37) or P * C <= 1100:
                pos = _scan_walk(plan, P, C, d, k)
                flat = [x for b in pos for x in b]
                assert flat == list(range(P * C))


def test_posting_wide_plan_at_the_main_shapes():
    """nprobe = 32 tiles of 96 x 128: one block a query at Q = 256, each
    buffering all 3,072 slots (one selection); four a query at Q = 32."""
    from repro_torch.kernels import posting_scan as ps
    for k in (64, 192):
        plan = ps.wide_scan_plan(256, 32, 96, 128, k)
        assert (plan.mode, plan.group, plan.S, plan.nb) == \
            (ps.MODE_BULK, 32, 1, 3072)
        plan = ps.wide_scan_plan(32, 32, 96, 128, k)
        assert (plan.group, plan.S, plan.nb) == (8, 4, 768)


def _warp_select(comp, kk):
    """warp_select on composites: block_select's rule over their order
    keys, the kept entries in array order; returns them and the largest."""
    s = (comp >> np.uint64(32)).astype(np.uint32)
    keep_s, keep_i = _block_select(_key_score(s), np.arange(len(comp)), kk)
    idx = np.sort(keep_i)
    return comp[idx], comp[idx].max()


def _key_score(key):
    """key_score: the float whose order key is ``key``."""
    key = np.asarray(key, np.uint32).astype(np.int64)
    b = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return b.astype(np.uint32).view(np.float32)


def _emulate_centroid_wide(row, k, chunk, cap, window=5120):
    """The wide centroid kernel on one query's scores (index = position):
    each chunk's list grows a 128-wide tile at a time by the composites
    below its threshold and is cut to k (warp_select) when the next tile
    might not fit; the chunks' lists, in chunk order, then go through
    block_select, ``window`` at a time behind the k kept, and the rank
    sort."""
    parts = []
    idx = np.arange(len(row), dtype=np.uint64)
    comp = (_order_key(row).astype(np.uint64) << np.uint64(32)) | idx
    for c0 in range(0, len(row), chunk):
        buf, thr = comp[:0], np.uint64(2 ** 64 - 1)
        for n0 in range(c0, min(len(row), c0 + chunk), 128):
            tile = comp[n0:min(len(row), c0 + chunk, n0 + 128)]
            buf = np.concatenate([buf, tile[tile < thr]])
            if len(buf) + 128 > cap:
                buf, thr = _warp_select(buf, k)
        if len(buf) > k:
            buf, _ = _warp_select(buf, k)
        parts.append(buf)
    allc = np.concatenate(parts)
    assert (np.diff(allc & np.uint64(0xFFFFFFFF)) > 0).all()  # index order
    s = _key_score((allc >> np.uint64(32)).astype(np.uint32))
    key = (allc & np.uint64(0xFFFFFFFF)).astype(np.int64)
    nb = min(len(s), window)
    run_s, run_k = s[:0], key[:0]
    w0 = 0
    while w0 < len(s):                       # the merge's windows
        cnt = min(nb - len(run_s), len(s) - w0)
        run_s, run_k = _block_select(
            np.concatenate([run_s, s[w0:w0 + cnt]]),
            np.concatenate([run_k, key[w0:w0 + cnt]]),
            min(k, len(run_s) + cnt))
        w0 += cnt
    return _rank_emit(run_s, run_k)


@pytest.mark.parametrize("kind", ["ties", "big", "normal"])
@pytest.mark.parametrize("chunk,cap,window", [
    (4096, 608, 5120), (256, 608, 5120), (1024, 192, 5120),
    (384, 1280, 5120), (256, 352, 700)])
@pytest.mark.parametrize("k", [33, 64, 192, 500])
def test_wide_centroid_selection_matches_stable_topk(k, chunk, cap, window,
                                                     kind):
    """The wide centroid path's selection (threshold filter, in-place cuts,
    chunk lists merged in order, in windows behind the k kept) gives the
    stable top-k: ties lowest index first, -0.0 equal to +0.0, BIG below
    +inf."""
    cap = max(cap, k + 128)
    window = max(window, k + 256)
    rng = np.random.default_rng(k + chunk + cap + len(kind))
    row = _tie_row(rng, 3000, kind)
    got_s, got_k = _emulate_centroid_wide(row, k, chunk, cap, window)
    want_s, want_k = ref.stable_topk(torch.from_numpy(row)[None], k)
    np.testing.assert_array_equal(got_k, want_k[0].numpy())
    np.testing.assert_array_equal(got_s.view(np.uint32) & 0x7FFFFFFF,
                                  want_s[0].numpy().view(np.uint32)
                                  & 0x7FFFFFFF)


# ---------------------------------------------------------------------------
# the quant plane's selection rule (csrc/topk_select.cuh) emulated in numpy,
# and pq_scan_topk's launch sizing (plain Python: runs here)
# ---------------------------------------------------------------------------

BIG = 1e30


def _order_key(s):
    """order_key: the float's bits made unsigned in the floats' order,
    -0.0 first made +0.0."""
    b = np.asarray(s, np.float32).view(np.uint32).astype(np.int64)
    b = np.where((b & 0x7FFFFFFF) == 0, 0, b)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def _block_select(s, key, kk):
    """block_select: the range the kk-th smallest key lies in (the least
    key to the largest below BIG's, where those reach kk), digit passes of
    up to 8 bits from the first bit the range's ends differ in over the
    keys in the range that share the prefix so far, stopping once the
    chosen bin is taken whole; then every key below the threshold and the
    first ``krem`` in the range at it, in array order, those below
    first."""
    if kk >= len(s):
        return s, key
    ok = _order_key(s)
    big = int(_order_key(np.float32(BIG / 2)))
    real = ok[ok < big]
    hi = int(real.max()) if len(real) >= kk else int(ok.max())
    lo = int(ok.min())
    top = (lo ^ hi).bit_length()
    mask = (0xFFFFFFFF << top) & 0xFFFFFFFF
    prefix = lo & mask
    krem = kk
    while top > 0:
        width = min(8, top)
        shift = top - width
        cand = ok[(ok <= hi) & ((ok & mask) == prefix)]
        hist = np.bincount((cand >> shift) & ((1 << width) - 1),
                           minlength=256)
        ex = np.cumsum(hist) - hist
        dg = int(np.nonzero((ex < krem) & (krem <= ex + hist))[0][0])
        krem -= int(ex[dg])
        prefix |= dg << shift
        mask |= ((1 << width) - 1) << shift
        top = shift
        if hist[dg] == krem:
            break
    mk = ok & mask
    take = np.concatenate([np.nonzero(mk < prefix)[0],
                           np.nonzero((mk == prefix) & (ok <= hi))[0][:krem]])
    return s[take], key[take]


def _composite(s, key):
    return (_order_key(s).astype(np.uint64) << np.uint64(32)) | \
        key.astype(np.uint64)


def _rank_emit(s, key):
    """block_rank_emit: each pair lands at the number of composites (order
    key << 32 | key) below its own."""
    c = _composite(s, key)
    rank = (c[None, :] < c[:, None]).sum(1)
    assert sorted(rank.tolist()) == list(range(len(s)))
    out_s, out_k = np.empty_like(s), np.empty_like(key)
    out_s[rank], out_k[rank] = s, key
    return out_s, out_k


def _emulate_pq_select(row, k, chunk, group):
    """pq_scan_topk's selection over one query's scores (position = index):
    each group of ``group`` positions selected chunk by chunk with the
    kept pairs in front; one group sorts its list and is done, several
    (a cluster) sort theirs and rank each pair by its index in its own
    list plus the composites below it in the others, keeping ranks < k."""
    lists = []
    for g0 in range(0, len(row), group):
        run_s = np.empty(0, np.float32)
        run_k = np.empty(0, np.int64)
        for c0 in range(g0, min(len(row), g0 + group), chunk):
            c1 = min(len(row), g0 + group, c0 + chunk)
            u_s = np.concatenate([run_s, row[c0:c1]])
            u_k = np.concatenate([run_k, np.arange(c0, c1)])
            run_s, run_k = _block_select(u_s, u_k, min(k, len(u_s)))
        lists.append(_rank_emit(run_s, run_k))
    if len(lists) == 1:
        return lists[0]
    out_s, out_k = np.empty(k, np.float32), np.empty(k, np.int64)
    comps = [_composite(*lst) for lst in lists]
    for b, (ls, lk) in enumerate(lists):
        for i in range(len(ls)):
            rank = i + sum(int(np.searchsorted(c, comps[b][i]))
                           for r, c in enumerate(comps) if r != b)
            if rank < k:
                out_s[rank], out_k[rank] = ls[i], lk[i]
    return out_s, out_k


def _tie_row(rng, n, kind):
    if kind == "normal":
        return rng.normal(size=n).astype(np.float32)
    vals = np.array([-1.0, -0.0, 0.0, 1.0, 2.5, BIG, np.inf], np.float32)
    if kind == "big":
        vals = vals[4:]
    return vals[rng.integers(0, len(vals), n)]


@pytest.mark.parametrize("kind", ["ties", "big", "normal"])
@pytest.mark.parametrize("chunk,group", [(700, 700), (96, 700), (96, 288),
                                         (700, 192)])
@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 64, 192, 699, 700])
def test_selection_rule_matches_stable_topk(k, chunk, group, kind):
    """The radix select, the stable compaction and the rank sort give the
    stable top-k (ties lowest position first, -0.0 equal to +0.0, BIG
    below +inf), whether the slots come in one chunk or several and in
    one probe group or several merged by rank."""
    rng = np.random.default_rng(k + chunk + group + len(kind))
    row = _tie_row(rng, 700, kind)
    got_s, got_k = _emulate_pq_select(row, k, chunk, group)
    want_s, want_k = ref.stable_topk(torch.from_numpy(row)[None], k)
    np.testing.assert_array_equal(got_k, want_k[0].numpy())
    np.testing.assert_array_equal(got_s, want_s[0].numpy())


@pytest.mark.parametrize("k", [1, 33, 192, 500])
def test_selection_rule_keeps_out_of_range_keys_out_of_a_taken_bin(k):
    """Exactly k scores just below BIG / 2, the range's bound, among BIG
    and scores just above it: the k-th smallest is the largest below, and
    the scores just above share its bin; the bin is taken whole, but only
    for the keys in the range."""
    rng = np.random.default_rng(k)
    near = rng.uniform(0, 6e-5, 700)         # within ~800 ulps of BIG / 2
    row = np.where(rng.random(700) < 0.5, np.float32(BIG),
                   5e29 * (1 + near)).astype(np.float32)
    pos = rng.choice(700, k, replace=False)
    row[pos] = (5e29 * (1 - near[pos])).astype(np.float32)
    for chunk, group in ((700, 700), (96, 700), (700, 350)):
        got_s, got_k = _emulate_pq_select(row, k, chunk, group)
        want_s, want_k = ref.stable_topk(torch.from_numpy(row)[None], k)
        np.testing.assert_array_equal(got_k, want_k[0].numpy())
        np.testing.assert_array_equal(got_s, want_s[0].numpy())


def test_order_key_orders_floats():
    s = np.array([-np.inf, -BIG, -2.5, -1e-40, -0.0, 0.0, 1e-40, 1.0, BIG,
                  np.inf], np.float32)
    ok = _order_key(s)
    assert (np.diff(ok[[0, 1, 2, 3, 5, 6, 7, 8, 9]]) > 0).all()
    assert ok[4] == ok[5]                    # -0.0 == +0.0


@pytest.mark.parametrize("Q", [1, 31, 32, 33, 66, 67, 256, 100000])
@pytest.mark.parametrize("P", [1, 3, 32, 64, 1024])
def test_pq_split_probes_covers_each_probe_once(Q, P):
    from repro_torch.kernels import pq_scan as pqs
    group, S = pqs.split_probes(Q, P)
    assert group >= 1 and 1 <= S <= pqs.MAX_SPLIT    # one portable cluster
    seen = np.zeros(P, np.int64)
    for s in range(S):
        lo, hi = s * group, min(P, (s + 1) * group)
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if Q * 2 > H100_SMS:
        assert S == 1                        # the batch fills the card


def test_pq_split_probes_fills_the_card_at_the_serving_batch():
    """nprobe = 32, R = 192 at Q = 32: four blocks a query, one tile a warp
    (8 probes a block), 128 of the 132 SMs; one block a query at Q = 256."""
    from repro_torch.kernels import pq_scan as pqs
    assert pqs.split_probes(32, 32) == (8, 4)
    assert pqs.split_probes(256, 32) == (32, 1)


def test_pq_table_limits():
    """LUT_MAX tables fit pq_scan_topk's least layout at k = 1024, C = 256
    and P = 1024, 16 bytes more do not; the gather's limit did not shrink below
    its earlier 216,048 bytes (the tables are all its block holds)."""
    from repro_torch.kernels import pq_scan as pqs
    n = pqs.LUT_MAX // 4
    limit = pqs.SMEM_MAX - pqs.topk_smem(0, 0, 0, 256, 1024, 1024)
    assert pqs.topk_smem(1, 1, n, 256, 1024, 1024) <= pqs.SMEM_MAX
    pqs._check_luts("t", 1, 1, n, limit)
    with pytest.raises(ValueError, match="exceed"):
        pqs._check_luts("t", 1, 1, n + 4, limit)
    assert pqs.LUT_MAX_GATHER >= 216048
    assert pqs.topk_smem(2, 16, 256, 96, 192, 32) < pqs.SMEM_MAX // 4


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs this check on the card)")
    return torch.device("cuda")


def _card_inputs(dev, Q=37, M=300, G=20, C=33, d=100, P=5):
    rng = np.random.default_rng(5)
    ints = lambda s: torch.as_tensor(                          # noqa: E731
        rng.integers(-3, 4, s).astype(np.float32), device=dev)
    return dict(q=ints((Q, d)), c=ints((M, d)), tiles=ints((G, C, d)),
                vis=torch.as_tensor(rng.random(M) < 0.7, device=dev),
                valid=torch.as_tensor(rng.random((G, C)) < 0.7, device=dev),
                probe=torch.as_tensor(rng.integers(0, G, (Q, P)).astype(
                    np.int32), device=dev))


def _counted(name, fn):
    before = ops.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    return out


def _offset(t, off):
    """``t`` as a contiguous view ``off`` floats past an aligned start
    (one float breaks the 16-byte alignment of the kernel's wide copies)."""
    flat = torch.zeros(t.numel() + off, device=t.device)
    flat[off:] = t.flatten()
    return flat[off:].view(t.shape)


# masked_score's shapes: both query tiles (Q <= 32 and above), x rows not
# a multiple of the 128-row tile (M = 300, G * C = 660), d not a multiple
# of the 32-deep slice (100 not even of 8; 300 spans ten slices), aligned
# and one float off
MASKED_CASES = [(Q, d, off) for Q in (1, 31, 32, 33, 2048)
                for d in (96, 100, 128, 300) for off in (0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,d,off", MASKED_CASES)
def test_card_centroid_score_kernel(cuda_dev, Q, d, off):
    x = _card_inputs(cuda_dev, Q=Q, d=d)
    q, c = _offset(x["q"], off), _offset(x["c"], off)
    got = _counted("centroid_score",
                   lambda: ops.centroid_score(q, c, x["vis"]))
    assert torch.equal(got, ref.centroid_score(q, c, x["vis"]))


# the top-k kernels' shapes: both query tiles of centroid_topk (Q <= 32
# and above) and one probe group or several for posting_scan_topk (Q = 256
# takes one), d not a multiple of a 32-deep slice or of 4 floats' copies,
# k at both ends of the warp path; M = 300 and P * C = 5 * 33 are not
# multiples of any tile, and each case runs aligned and one float off
TOPK_CASES_CARD = [(Q, d, k, off) for Q in (1, 31, 32, 33, 256)
                   for d in (96, 100, 128, 300)
                   for k, off in ((1, 0), (10, 1), (32, 0), (32, 1))]
# integer data kinds: values in [-3, 3], ties (values in [-1, 1]), all
# masked (every score BIG: order by index alone)
TOPK_KINDS = ["int", "ties", "masked"]


def _topk_inputs(dev, Q, d, off, kind, M=300, G=20, C=33, P=5):
    x = _card_inputs(dev, Q=Q, M=M, G=G, C=C, d=d, P=P)
    if kind == "ties":
        rng = np.random.default_rng(Q + d)
        for name in ("q", "c", "tiles"):
            x[name] = torch.as_tensor(rng.integers(
                -1, 2, tuple(x[name].shape)).astype(np.float32), device=dev)
    if kind == "masked":
        x["vis"] = torch.zeros_like(x["vis"])
        x["valid"] = torch.zeros_like(x["valid"])
    for name in ("q", "c", "tiles"):
        x[name] = _offset(x[name], off)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TOPK_KINDS)
@pytest.mark.parametrize("Q,d,k,off", TOPK_CASES_CARD)
def test_card_centroid_topk_kernel(cuda_dev, Q, d, k, off, kind):
    x = _topk_inputs(cuda_dev, Q, d, off, kind)
    gs, gi = _counted("centroid_topk", lambda: ops.centroid_topk(
        x["q"], x["c"], x["vis"], k=k))
    ws, wi = ref.centroid_topk(x["q"], x["c"], x["vis"], k)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,d", [(1, 128), (31, 100), (33, 300), (256, 128)])
def test_card_centroid_topk_ranks_centroid_score_exactly(cuda_dev, Q, d):
    """On real-valued data the top-k kernel ranks the very scores
    ``centroid_score`` writes (one mainloop, ``csrc/score_tile.cuh``): its
    output equals the stable top-k of ``ops.centroid_score`` bit for bit,
    ties included (every centroid appears twice)."""
    rng = np.random.default_rng(Q + d)
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    half = rng.normal(size=(650, d)).astype(np.float32)
    c = t(np.concatenate([half, half[::-1]]))
    q = t(rng.normal(size=(Q, d)).astype(np.float32))
    vis = t(rng.random(1300) < 0.8)
    for k in (1, 10, 32):
        gs, gi = ops.centroid_topk(q, c, vis, k=k)
        ws, wi = ref.stable_topk(ops.centroid_score(q, c, vis), k)
        assert torch.equal(gs, ws) and torch.equal(gi, wi.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,d,off", MASKED_CASES)
def test_card_posting_scan_kernel(cuda_dev, Q, d, off):
    x = _card_inputs(cuda_dev, Q=Q, d=d)
    q, tiles = _offset(x["q"], off), _offset(x["tiles"], off)
    got = _counted("posting_scan",
                   lambda: ops.posting_scan(q, tiles, x["valid"]))
    assert torch.equal(got, ref.posting_scan(q, tiles, x["valid"]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TOPK_KINDS + ["dup", "qp0"])
@pytest.mark.parametrize("Q,d,k,off", TOPK_CASES_CARD)
def test_card_posting_scan_topk_kernel(cuda_dev, Q, d, k, off, kind):
    """Beside the integer kinds: duplicated probes (each probe listed twice:
    equal scores, ties by position) and a quarter of ``qp_ok`` zero."""
    x = _topk_inputs(cuda_dev, Q, d, off, "int" if kind in ("dup", "qp0")
                     else kind)
    G = x["tiles"].shape[0]
    probe, P = x["probe"], x["probe"].shape[1]
    if kind == "dup":
        probe = torch.cat([probe[:, :3], probe[:, :3]], 1)
        P = 6
    rng = np.random.default_rng(Q * d + k)
    ok = torch.as_tensor((rng.random((Q, P)) >= (0.25 if kind == "qp0"
                                                  else 0.0)).astype(np.int32),
                         device=cuda_dev)
    vis = torch.as_tensor(rng.random(G) < 0.9, device=cuda_dev)
    gs, gi = _counted("posting_scan_topk", lambda: ops.posting_scan_topk(
        x["q"], x["tiles"], x["valid"], vis, probe, k=k, qp_ok=ok))
    ws, wi = ref.posting_scan_topk(x["q"], x["tiles"],
                                   x["valid"] & vis[:, None], ok, probe, k)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)


def _wide_inputs(dev, Q=37, M=300, G=40, C=33, d=100, P=8):
    """Integer-valued inputs with P*C = 264 slots per query, so that k
    and nprobe reach 192 (the quant path's rerank_k)."""
    x = _card_inputs(dev, Q=Q, M=M, G=G, C=C, d=d, P=P)
    x["qp_ok"] = torch.as_tensor(
        (np.random.default_rng(6).random((Q, P)) < 0.9).astype(np.int32),
        device=dev)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 64, 192, 264])
def test_card_topk_kernels_answer_past_a_warp(cuda_dev, k):
    """Past 32 the top-k kernels take their wide paths (lists in shared
    memory, an exact selection); ids, scores and tie order equal the
    plain version's (integer data: exact), and search answers at k and
    nprobe past 32."""
    from repro_torch.api import make_index
    from repro_torch.core.types import UBISConfig
    x = _wide_inputs(cuda_dev)
    G = x["tiles"].shape[0]
    vis = torch.ones(G, dtype=torch.bool, device=cuda_dev)
    gs, gi = _counted("centroid_topk", lambda: ops.centroid_topk(
        x["q"], x["c"], x["vis"], k=k))
    ws, wi = ref.centroid_topk(x["q"], x["c"], x["vis"], k)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)
    gs, gi = _counted("posting_scan_topk", lambda: ops.posting_scan_topk(
        x["q"], x["tiles"], x["valid"], vis, x["probe"], k=k,
        qp_ok=x["qp_ok"]))
    ws, wi = ref.posting_scan_topk(x["q"], x["tiles"], x["valid"],
                                   x["qp_ok"], x["probe"], k)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)

    if k != 64:
        return
    rng = np.random.default_rng(0)
    data = rng.normal(size=(600, 16)).astype(np.float32)
    cfg = UBISConfig(dim=16, max_postings=128, capacity=32, l_min=4,
                     l_max=24, nprobe=8, cache_capacity=64, max_ids=1 << 10)
    drv = make_index("ubis", cfg, data[:200], device=cuda_dev)
    drv.insert(data, np.arange(len(data)))
    assert drv.search(data[:4], 64).ids.shape == (4, 64)
    got = drv.search(data[:4], 10, nprobe=64).ids
    assert (got[:, 0] == np.arange(4)).all()       # each finds itself


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 192])
def test_card_wide_topk_prefix_is_the_warp_answer(cuda_dev, k):
    """On real-valued data the wide paths score with the warp paths'
    arithmetic: a k answer's first 32 (``centroid_topk``) or 10
    (``posting_scan_topk``) are the narrower answer, ids and score bits,
    and the centroid scores are ``centroid_score``'s at the picks."""
    rng = np.random.default_rng(k)
    normal = lambda *s: torch.as_tensor(                      # noqa: E731
        rng.standard_normal(s, np.float32), device=cuda_dev)
    q, c, tiles = normal(37, 128), normal(3000, 128), normal(60, 96, 128)
    vis = torch.as_tensor(rng.random(3000) < 0.7, device=cuda_dev)
    ws, wi = ops.centroid_topk(q, c, vis, k=32)
    gs, gi = _counted("centroid_topk",
                      lambda: ops.centroid_topk(q, c, vis, k=k))
    assert ops.wide_launch_counts()["centroid_topk"] >= 1
    assert torch.equal(gi[:, :32], wi)
    assert torch.equal(gs[:, :32].view(torch.int32), ws.view(torch.int32))
    full = ops.centroid_score(q, c, vis)
    assert torch.equal(torch.gather(full, 1, gi.long()).view(torch.int32),
                       gs.view(torch.int32))
    valid = torch.as_tensor(rng.random((60, 96)) < 0.9, device=cuda_dev)
    pvis = torch.ones(60, dtype=torch.bool, device=cuda_dev)
    probe = torch.as_tensor(rng.integers(0, 60, (37, 32)).astype(np.int32),
                            device=cuda_dev)
    ws, wi = ops.posting_scan_topk(q, tiles, valid, pvis, probe, k=10)
    gs, gi = _counted("posting_scan_topk", lambda: ops.posting_scan_topk(
        q, tiles, valid, pvis, probe, k=k))
    assert torch.equal(gi[:, :10], wi)
    assert torch.equal(gs[:, :10].view(torch.int32), ws.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 33])
def test_card_wide_topk_at_k_1024_odd_d_and_c(cuda_dev, Q):
    """k = 1024 at d = 99 and C = 33 (the 4-byte copies, units of odd
    rows; the scan split over a cluster at Q = 1): the plain version's
    ids, scores and tie order on integer data."""
    rng = np.random.default_rng(Q)
    ints = lambda *s: torch.as_tensor(                        # noqa: E731
        rng.integers(-2, 3, s).astype(np.float32), device=cuda_dev)
    q, c, tiles = ints(Q, 99), ints(1100, 99), ints(40, 33, 99)
    vis = torch.as_tensor(rng.random(1100) < 0.7, device=cuda_dev)
    got = ops.centroid_topk(q, c, vis, k=1024)
    want = ref.centroid_topk(q, c, vis, 1024)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    valid = torch.as_tensor(rng.random((40, 33)) < 0.7, device=cuda_dev)
    pvis = torch.as_tensor(rng.random(40) < 0.9, device=cuda_dev)
    probe = torch.as_tensor(rng.integers(0, 40, (Q, 32)).astype(np.int32),
                            device=cuda_dev)
    got = ops.posting_scan_topk(q, tiles, valid, pvis, probe, k=1024)
    ones = torch.ones((Q, 32), dtype=torch.int32, device=cuda_dev)
    want = ref.posting_scan_topk(q, tiles, valid & pvis[:, None], ones,
                                 probe, 1024)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_card_topk_kernels_refuse_k_past_the_cap(cuda_dev):
    """The wide paths' selection takes k up to 1024
    (``TOPK_BLOCK_MAX_K``); past it the kernels raise, on the card only."""
    x = _wide_inputs(cuda_dev, M=1100, G=40, C=33, P=32)
    G = x["tiles"].shape[0]
    vis = torch.ones(G, dtype=torch.bool, device=cuda_dev)
    with pytest.raises(ValueError, match="centroid_topk: k=1025"):
        ops.centroid_topk(x["q"], x["c"], x["vis"], k=1025)
    with pytest.raises(ValueError, match="posting_scan_topk: k=1025"):
        ops.posting_scan_topk(x["q"], x["tiles"], x["valid"], vis,
                              x["probe"], k=1025)
    assert ops.centroid_topk(x["q"], x["c"], x["vis"], k=1024)[1].shape \
        == (37, 1024)
    _, idx = ops.centroid_topk(x["q"].cpu(), x["c"].cpu(), x["vis"].cpu(),
                               k=1025)
    assert idx.shape == (37, 1025)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,d,p", [(2048, 256, 8, 1.0), (257, 100, 10, 0.7),
                                     (300, 16, 100, 0.0), (2049, 256, 8, 0.7),
                                     (300, 16, 1, 0.9), (300, 16, 3, 0.9),
                                     (600, 64, 16, 0.9), (100, 2100, 16, 1.0)])
def test_card_kmeans_assign_kernel(cuda_dev, N, K, d, p):
    """32 codebooks over 16 point batches (V*m over m, as the insert round
    encodes), exact on integer inputs: N past a multiple of the points a
    block owns (2,049), d of 1, 3 (padded in registers), 16 and 100 (the
    path past 32), and K*d past one shared-memory stage (2,100 x 16)."""
    rng = np.random.default_rng(N + K)
    ints = lambda s: torch.as_tensor(                          # noqa: E731
        rng.integers(-3, 4, s).astype(np.float32), device=cuda_dev)
    pts, cents = ints((N, 16 * d)), ints((32, K, d))
    mask = torch.as_tensor(rng.random(N) < p, device=cuda_dev)
    view = pts.view(N, 16, d).transpose(0, 1)        # (16, N, d), strided
    got = _counted("kmeans_assign",
                   lambda: ops.kmeans_assign(view, cents, mask))
    want = ref.kmeans_assign(view, cents, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


QUANT_Q = [1, 31, 32, 33, 256]
PQ_K = [1, 10, 32, 33, 64, 192, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "ties", "masked", "dup", "qp0",
                                  "null", "offset", "real"])
@pytest.mark.parametrize("C,m,ksub,M,P", [(96, 16, 256, 200, 32),
                                          (33, 10, 100, 50, 5),
                                          (96, 16, 256, 300, 64)])
@pytest.mark.parametrize("Q", QUANT_Q)
def test_card_pq_scan_topk_kernel(cuda_dev, Q, C, m, ksub, M, P, kind):
    """Exact at every k of ``PQ_K`` that P*C allows: the quant path's
    tiles (one probe group a block from Q = 67 on, a cluster of four or
    eight below), m*C not a multiple of 16 (the plain-load instance), P*C
    past one 4,096-slot chunk; integer tables, ties, all masked,
    duplicated probes, qp_ok zeros and none, tables one float off 16-byte
    alignment (the plain-load instance).  The m lookups are summed in
    the plain version's order, so real-valued tables match bit for bit
    too."""
    rng = np.random.default_rng(Q + C + m + P + len(kind))
    V = 2
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    lo, hi = (-1, 2) if kind == "ties" else (-3, 4)
    luts = t(rng.normal(size=(Q, V, m, ksub)).astype(np.float32)
             if kind == "real" else
             rng.integers(lo, hi, (Q, V, m, ksub)).astype(np.float32))
    if kind == "offset":
        luts = _offset(luts, 1)
    codes = t(rng.integers(0, ksub, (M, m, C)).astype(np.uint8))
    slot = t(rng.integers(-1, V + 1, M).astype(np.int32))
    valid = t(rng.random((M, C)) < (0.0 if kind == "masked" else 0.7))
    vis = t(rng.random(M) < 0.9)
    probe = rng.integers(0, M, (Q, P)).astype(np.int32)
    if kind == "dup":
        probe[:, P // 2:] = probe[:, :P - P // 2]
    probe = t(probe)
    qp_ok = t((rng.random((Q, P)) < (0.75 if kind == "qp0" else 1.0))
              .astype(np.int32))
    for k in [k for k in PQ_K if k <= P * C]:
        gs, gi = _counted("pq_scan_topk", lambda: ops.pq_scan_topk(
            luts, codes, slot, valid, vis, probe, k=k,
            qp_ok=None if kind == "null" else qp_ok))
        ws, wi = ref.pq_scan_topk(luts, codes, slot.clamp(0, V - 1),
                                  valid & vis[:, None], qp_ok, probe, k)
        assert torch.equal(gi, wi) and torch.equal(gs, ws), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "ties", "spilled", "empty",
                                  "offset"])
@pytest.mark.parametrize("M,C,d,R", [(200, 33, 100, 192), (200, 33, 99, 192),
                                     (60, 96, 128, 2500)])
@pytest.mark.parametrize("Q", QUANT_Q)
def test_card_rerank_topk_kernel(cuda_dev, Q, M, C, d, R, kind):
    """Spilled postings keep their ADC score, empty ADC slots (BIG and
    +inf) score BIG, ties go to the lower ADC rank: exact on integer data
    at k = 1, 10, 32 (warp lists), 33, 64 and 192 (the block selection),
    d a multiple of 4 and not, rows one float off 16-byte alignment (the
    scalar instance), R past one 2,048-candidate chunk."""
    rng = np.random.default_rng(Q + M + d + R + len(kind))
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    lo, hi = (-1, 2) if kind == "ties" else (-3, 4)
    q = t(rng.integers(lo, hi, (Q, d)).astype(np.float32))
    vecs = t(rng.integers(lo, hi, (M, C, d)).astype(np.float32))
    if kind == "offset":
        vecs = _offset(vecs, 1)
    spilled = t(rng.random(M) < (0.3 if kind == "spilled" else 0.0))
    cand = t(np.stack([rng.permutation(M * C)[:R] for _ in range(Q)])
             .astype(np.int32))
    adc = np.sort(rng.integers(-50, 50, (Q, R)), axis=1).astype(np.float32)
    if kind == "empty":
        adc = np.where(rng.random((Q, R)) < 0.2,
                       np.where(rng.random((Q, R)) < 0.5, 1e30, np.inf),
                       adc).astype(np.float32)
    adc = t(adc)
    for k in [1, 10, 32, 33, 64, 192]:
        gs, gi = _counted("rerank_topk", lambda: ops.rerank_topk(
            q, vecs, spilled, cand, adc, k=k))
        ws, wi = ref.rerank_topk(q, vecs, spilled, cand, adc, k)
        assert torch.equal(gi, wi) and torch.equal(gs, ws), k


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["ubis", "spfresh"])
def test_card_quant_engines_run(cuda_dev, engine):
    """Both engines on the quant plane, end to end on the card: the
    quant kernels launch, the codes invariant holds after re-trains, and
    search finds what the exact oracle finds."""
    from repro_torch.api import make_index
    from repro_torch.core import metrics
    from repro_torch.core.invariants import check_invariants
    from repro_torch.core.types import UBISConfig
    rng = np.random.default_rng(1)
    cents = rng.normal(size=(12, 16)) * 5
    data = (cents[rng.integers(0, 12, 3000)]
            + rng.normal(size=(3000, 16))).astype(np.float32)
    cfg = UBISConfig(dim=16, max_postings=256, capacity=96, l_min=10,
                     l_max=80, cache_capacity=1024, max_ids=1 << 14,
                     use_pq=True, pq_m=4, pq_ksub=256, rerank_k=192)
    ops.reset_launch_counts()
    drv = make_index(engine, cfg, data[:800], device=cuda_dev,
                     round_size=256, bg_ops_per_round=8, pq_retrain_every=2)
    drv.insert(data, np.arange(len(data)))
    drv.flush(max_ticks=20)
    check_invariants(drv.state, cfg)
    assert drv.stats["pq_retrains"] >= 1
    q = data[:64] + rng.normal(size=(64, 16)).astype(np.float32) * 0.1
    rec = metrics.recall_at_k(drv.search(q, 10).ids, drv.exact(q, 10).ids)
    assert rec > 0.9, rec
    counts = ops.launch_counts()
    for name in ("kmeans_assign", "pq_scan_topk", "rerank_topk"):
        assert counts[name] > 0, name
