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
tests/test_torch_pq.py.  The CUDA kernels themselves run only on a card:
the ``cuda``-marked tests compare each of the seven kernels, and the
block-wide top-k past k = 32, with its plain version and skip without
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
    ops.rerank_topk(q, c.reshape(2, 5, 8), ~ones[:, 0], cand, adc, k=3)
    ops.flash_attention(torch.randn(1, 2, 3, 8), torch.randn(1, 1, 5, 8),
                        torch.randn(1, 1, 5, 8), window=2)
    assert len(ops.launch_counts()) == 8
    assert set(ops.launch_counts().values()) == {0}


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


@pytest.mark.cuda
def test_card_centroid_score_kernel(cuda_dev):
    x = _card_inputs(cuda_dev)
    got = _counted("centroid_score",
                   lambda: ops.centroid_score(x["q"], x["c"], x["vis"]))
    assert torch.equal(got, ref.centroid_score(x["q"], x["c"], x["vis"]))


@pytest.mark.cuda
def test_card_centroid_topk_kernel(cuda_dev):
    x = _card_inputs(cuda_dev)
    gs, gi = _counted("centroid_topk", lambda: ops.centroid_topk(
        x["q"], x["c"], x["vis"], k=32))
    ws, wi = ref.centroid_topk(x["q"], x["c"], x["vis"], 32)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)


@pytest.mark.cuda
def test_card_posting_scan_kernel(cuda_dev):
    x = _card_inputs(cuda_dev)
    got = _counted("posting_scan",
                   lambda: ops.posting_scan(x["q"], x["tiles"], x["valid"]))
    assert torch.equal(got, ref.posting_scan(x["q"], x["tiles"], x["valid"]))


@pytest.mark.cuda
def test_card_posting_scan_topk_kernel(cuda_dev):
    x = _card_inputs(cuda_dev)
    G = x["tiles"].shape[0]
    vis = torch.ones(G, dtype=torch.bool, device=cuda_dev)
    gs, gi = _counted("posting_scan_topk", lambda: ops.posting_scan_topk(
        x["q"], x["tiles"], x["valid"], vis, x["probe"], k=10))
    ok = torch.ones(x["probe"].shape, dtype=torch.int32, device=cuda_dev)
    ws, wi = ref.posting_scan_topk(x["q"], x["tiles"], x["valid"], ok,
                                   x["probe"], 10)
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
    """Past 32 the top-k kernels keep the list block-wide in shared
    memory; ids, scores and tie order equal the plain version's (integer
    data: exact), and search answers at k and nprobe past 32."""
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
def test_card_topk_kernels_refuse_k_past_the_cap(cuda_dev):
    """The block-wide selection takes k up to 1024
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
                                     (300, 16, 100, 0.0)])
def test_card_kmeans_assign_kernel(cuda_dev, N, K, d, p):
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


@pytest.mark.cuda
@pytest.mark.parametrize("C,m,ksub,P,k", [(96, 16, 256, 32, 192),
                                          (33, 10, 100, 8, 64),
                                          (33, 4, 16, 3, 10)])
def test_card_pq_scan_topk_kernel(cuda_dev, C, m, ksub, P, k):
    """The m lookups are summed in the plain version's order, so the
    kernel matches it bit for bit even on real-valued tables."""
    rng = np.random.default_rng(C + m + k)
    Q, M, V = 37, 200, 2
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    luts = t(rng.normal(size=(Q, V, m, ksub)).astype(np.float32))
    codes = t(rng.integers(0, ksub, (M, m, C)).astype(np.uint8))
    slot = t(rng.integers(0, V, M).astype(np.int32))
    valid = t(rng.random((M, C)) < 0.7)
    vis = t(rng.random(M) < 0.9)
    probe = t(rng.integers(0, M, (Q, P)).astype(np.int32))
    qp_ok = t((rng.random((Q, P)) < 0.9).astype(np.int32))
    gs, gi = _counted("pq_scan_topk", lambda: ops.pq_scan_topk(
        luts, codes, slot, valid, vis, probe, k=k, qp_ok=qp_ok))
    ws, wi = ref.pq_scan_topk(luts, codes, slot, valid & vis[:, None],
                              qp_ok, probe, k)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("R,k,ps,pe", [(192, 10, 0.0, 0.0),
                                       (192, 192, 0.3, 0.2),
                                       (64, 10, 0.0, 1.0)])
def test_card_rerank_topk_kernel(cuda_dev, R, k, ps, pe):
    """Spilled postings keep their ADC score, empty ADC slots score BIG,
    ties go to the lower ADC rank (integer data: exact)."""
    rng = np.random.default_rng(R + k)
    Q, M, C, d = 37, 200, 33, 100
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    q = t(rng.integers(-1, 2, (Q, d)).astype(np.float32))
    vecs = t(rng.integers(-1, 2, (M, C, d)).astype(np.float32))
    spilled = t(rng.random(M) < ps)
    cand = t(np.stack([rng.permutation(M * C)[:R] for _ in range(Q)])
             .astype(np.int32))
    adc = np.sort(rng.integers(-50, 50, (Q, R)), axis=1).astype(np.float32)
    empty = rng.random((Q, R)) < pe
    adc = t(np.where(empty, np.where(rng.random((Q, R)) < 0.5, 1e30,
                                     np.inf), adc).astype(np.float32))
    gs, gi = _counted("rerank_topk", lambda: ops.rerank_topk(
        q, vecs, spilled, cand, adc, k=k))
    ws, wi = ref.rerank_topk(q, vecs, spilled, cand, adc, k)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)


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
