"""The two unfused probe scans, ``posting_scan_gather`` and
``pq_scan_gather``, against the JAX package, and the unfused search
oracle built on them.

* The port's plain versions (what ``repro_torch.kernels.ops`` runs on a
  CPU tensor) against JAX ``ops.*_gather`` with ``backend="pallas"``
  (the Pallas kernels in interpret mode, as tests/test_kernels.py:43-76
  and 281-330 drive them) and ``backend="ref"``, at aligned and
  misaligned shapes (d=100, odd C, m=10, ksub=100), with invalid slots,
  invisible postings and codebook slots outside [0, V) (clamped).  On
  integer-valued data every sum is exact, so the scores match exactly;
  on real-valued data within ``1e-4 * scale``.  The plain ADC gather
  sums the m lookups in the order of the plain ``pq_scan_topk``, so the
  two agree exactly on the same tables.
* The port's counterpart of tests/test_pq.py:104-130: centroid scores,
  a stable top-``nprobe``, ``posting_scan_gather``, the cache scores and
  a stable top-k equal the port's ``search`` bit for bit, and
  ``pq_scan_gather`` on the search's own probes and tables, with a stable
  top-``rerank_k``, equals ``pq_scan_topk``.
* The cases the card kernels' schedules turn on, held against JAX the
  same way: every query probing one posting (one long run of pairs, cut
  into chunks on the card), duplicated probes inside a query and across
  queries, a tile past one 48 KB staging unit (C = 133, d = 300), m*C
  and C no multiples of 16 (the ADC scan's unstaged instance) and
  codebook slots at -1 and V.
* On the card (``cuda``-marked, skipped here): each kernel against its
  plain version at every case above, its launch counted, and the float
  gather's scores at ``posting_scan_topk``'s picks equal to that kernel's
  bit for bit (one row walk, ``csrc/row_score.cuh``, scores both).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from conftest import make_clustered
from repro.kernels import ops as jops
from repro_torch.api import make_index
from repro_torch.core import version_manager as vm
from repro_torch.core.search import search
from repro_torch.core.types import UBISConfig
from repro_torch.kernels import ops, ref
from repro_torch.quant import pq
from test_torch_kernels import (BACKENDS, _close, _counted, _data, _t,
                                cuda_dev)  # noqa: F401  (a fixture)

BIG = 1e30


# (Q, M, C, P, d, kind): aligned (the TPU's 128 lanes), d=100 with odd C,
# integer data, integer ties, wide odd C
PSG_CASES = [(6, 12, 128, 4, 128, "normal"), (5, 9, 33, 3, 100, "normal"),
             (6, 12, 100, 4, 100, "int"), (4, 8, 24, 5, 16, "ties"),
             (2, 8, 130, 3, 96, "int")]


@pytest.mark.parametrize("Q,M,C,P,d,kind", PSG_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_posting_scan_gather_matches_jax(Q, M, C, P, d, kind, backend):
    rng = np.random.default_rng(Q * M * C + d + len(kind))
    q, vecs = _data(rng, kind, (Q, d)), _data(rng, kind, (M, C, d))
    slot_valid = rng.random((M, C)) > 0.3
    vis = rng.random(M) > 0.2
    probe = rng.integers(0, M, (Q, P)).astype(np.int32)
    want = np.asarray(jops.posting_scan_gather(
        jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(slot_valid),
        jnp.asarray(vis), jnp.asarray(probe), backend=backend))
    got = ops.posting_scan_gather(_t(q), _t(vecs), _t(slot_valid), _t(vis),
                                  _t(probe))
    assert got.dtype == torch.float32 and got.shape == (Q, P, C)
    masked = ~(slot_valid & vis[:, None])[probe]
    assert (got.numpy()[masked] == BIG).all() and masked.any()
    if kind == "normal":
        _close(got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# (Q, V, m, ksub, M, C, P, kind): aligned, misaligned (ksub=100, odd C,
# m=10), three codebook slots, integer tables
PQG_CASES = [(6, 2, 8, 128, 12, 128, 4, "normal"),
             (4, 2, 10, 100, 9, 33, 4, "normal"),
             (3, 3, 4, 256, 9, 128, 5, "int"),
             (2, 3, 8, 200, 7, 133, 3, "int")]


@pytest.mark.parametrize("Q,V,m,ksub,M,C,P,kind", PQG_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_pq_scan_gather_matches_jax(Q, V, m, ksub, M, C, P, kind, backend):
    rng = np.random.default_rng(Q * V * m + ksub + C)
    luts = _data(rng, kind, (Q, V, m, ksub))
    codes = rng.integers(0, ksub, (M, m, C)).astype(np.uint8)
    # slots outside [0, V) are clamped, as JAX ops.pq_scan_gather does
    slot = rng.integers(-1, V + 1, (M,)).astype(np.int32)
    slot_valid = rng.random((M, C)) > 0.3
    vis = rng.random(M) > 0.2
    probe = rng.integers(0, M, (Q, P)).astype(np.int32)
    want = np.asarray(jops.pq_scan_gather(
        jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(slot),
        jnp.asarray(slot_valid), jnp.asarray(vis), jnp.asarray(probe),
        backend=backend))
    got = ops.pq_scan_gather(_t(luts), _t(codes), _t(slot), _t(slot_valid),
                             _t(vis), _t(probe))
    assert got.dtype == torch.float32 and got.shape == (Q, P, C)
    if kind == "normal":
        _close(got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    # the plain ADC gather is the plain fused scan before its selection
    valid = _t(slot_valid & vis[:, None])
    cslot = _t(np.clip(slot, 0, V - 1))
    ok = torch.ones((Q, P), dtype=torch.int32)
    s, _ = ref.pq_scan_topk(_t(luts), _t(codes), cslot, valid, ok,
                            _t(probe), P * C)
    assert torch.equal(s, torch.sort(got.reshape(Q, -1), 1).values)


def _probes(rng, Q, M, P, how):
    """(Q, P) int32 probe ids: ``random``; ``same``, every pair on one
    posting; ``dup``, the last P // 2 of each row repeating its first and
    query 1 repeating query 0."""
    if how == "same":
        return np.full((Q, P), M // 2, np.int32)
    probe = rng.integers(0, M, (Q, P)).astype(np.int32)
    if how == "dup":
        probe[:, P - P // 2:] = probe[:, :P // 2]
        probe[1] = probe[0]
    return probe


# (Q, M, C, P, d, kind, probes): one long run (Q*P pairs on one posting),
# duplicated probes, a tile of four 48 KB staging units (C=133, d=300), a
# pool of one posting (no sort pass on the card)
PSG_EDGE = [(12, 6, 24, 3, 16, "int", "same"),
            (6, 8, 24, 5, 16, "int", "dup"),
            (3, 4, 133, 2, 300, "normal", "random"),
            (4, 1, 24, 2, 16, "int", "random")]


@pytest.mark.parametrize("Q,M,C,P,d,kind,how", PSG_EDGE)
@pytest.mark.parametrize("backend", BACKENDS)
def test_posting_scan_gather_edges_match_jax(Q, M, C, P, d, kind, how,
                                             backend):
    rng = np.random.default_rng(Q * M * C + d + len(how))
    q, vecs = _data(rng, kind, (Q, d)), _data(rng, kind, (M, C, d))
    slot_valid = rng.random((M, C)) > 0.3
    vis = np.arange(M) % 4 != 1
    probe = _probes(rng, Q, M, P, how)
    want = np.asarray(jops.posting_scan_gather(
        jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(slot_valid),
        jnp.asarray(vis), jnp.asarray(probe), backend=backend))
    got = ops.posting_scan_gather(_t(q), _t(vecs), _t(slot_valid), _t(vis),
                                  _t(probe)).numpy()
    if kind == "normal":
        _close(got, want)
    else:
        np.testing.assert_array_equal(got, want)
    if how != "random":        # a repeated probe's scores repeat exactly
        h = P // 2 if how == "dup" else P - 1
        np.testing.assert_array_equal(got[:, P - h:], got[:, :h])


# (Q, V, m, ksub, M, C, P, kind, probes): one long run, duplicated probes
# with C = 20 (no multiple of 16), m*C = 108 (none either); every case has
# codebook slots -1 .. V (clamped)
PQG_EDGE = [(12, 2, 4, 16, 6, 32, 3, "int", "same"),
            (6, 3, 4, 16, 8, 20, 5, "normal", "dup"),
            (4, 2, 3, 32, 7, 36, 3, "int", "random")]


@pytest.mark.parametrize("Q,V,m,ksub,M,C,P,kind,how", PQG_EDGE)
@pytest.mark.parametrize("backend", BACKENDS)
def test_pq_scan_gather_edges_match_jax(Q, V, m, ksub, M, C, P, kind, how,
                                        backend):
    rng = np.random.default_rng(Q * V * m + ksub + C + len(how))
    luts = _data(rng, kind, (Q, V, m, ksub))
    codes = rng.integers(0, ksub, (M, m, C)).astype(np.uint8)
    slot = (np.arange(M) % (V + 2) - 1).astype(np.int32)      # -1 .. V
    slot_valid = rng.random((M, C)) > 0.3
    vis = np.arange(M) % 4 != 1
    probe = _probes(rng, Q, M, P, how)
    want = np.asarray(jops.pq_scan_gather(
        jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(slot),
        jnp.asarray(slot_valid), jnp.asarray(vis), jnp.asarray(probe),
        backend=backend))
    got = ops.pq_scan_gather(_t(luts), _t(codes), _t(slot), _t(slot_valid),
                             _t(vis), _t(probe)).numpy()
    if kind == "normal":
        _close(got, want)
    else:
        np.testing.assert_array_equal(got, want)
    # the plain version sums in the kernels' order: exact against itself
    # on the clamped slots
    cslot = _t(np.clip(slot, 0, V - 1))
    plain = ref.pq_scan_gather(_t(luts), _t(codes), cslot,
                               _t(slot_valid & vis[:, None]), _t(probe))
    assert torch.equal(torch.from_numpy(got), plain)


@pytest.mark.parametrize("Q,P", [(1, 32), (31, 32), (32, 32), (33, 5),
                                 (132, 32), (133, 32), (256, 32), (7, 1)])
def test_gather_split_covers_each_probe_once(Q, P):
    """The ADC gather's probe groups tile [0, P) with S blocks a query: S
    = 1 from 133 queries on, about two blocks an SM of an H100 below."""
    from repro_torch.kernels import pq_scan
    group, S = pq_scan.gather_split(Q, P)
    assert group >= 1 and 1 <= S <= 65535
    assert (S - 1) * group < P <= S * group
    if Q >= 133:
        assert S == 1
    else:
        assert Q * S <= 2 * 132 and (S == P or Q * (S + 1) > 2 * 132)


def test_gathers_mask_every_slot_when_nothing_is_visible():
    rng = np.random.default_rng(0)
    q, vecs = _data(rng, "int", (3, 16)), _data(rng, "int", (5, 24, 16))
    none = torch.zeros(5, dtype=torch.bool)
    probe = _t(rng.integers(0, 5, (3, 2)).astype(np.int32))
    ones = torch.ones((5, 24), dtype=torch.bool)
    out = ops.posting_scan_gather(_t(q), _t(vecs), ones, none, probe)
    assert (out == BIG).all()
    luts = _t(_data(rng, "int", (3, 2, 4, 16)))
    codes = _t(rng.integers(0, 16, (5, 4, 24)).astype(np.uint8))
    out = ops.pq_scan_gather(luts, codes, torch.zeros(5, dtype=torch.int32),
                             ones, none, probe)
    assert (out == BIG).all()


# ---------------------------------------------------------------------------
# the unfused search oracle (tests/test_pq.py:104-130)
# ---------------------------------------------------------------------------

def _streamed(use_pq: bool):
    """A port index after churn, with vectors parked in the cache."""
    data = np.round(make_clustered(1500, d=16, k=8, seed=3))
    cfg = UBISConfig(dim=16, max_postings=256, capacity=32, l_min=4,
                     l_max=24, nprobe=8, cache_capacity=256, max_ids=1 << 12,
                     use_pq=use_pq, pq_m=4, pq_ksub=16, rerank_k=48)
    drv = make_index("ubis", cfg, data[:400], device="cpu", round_size=128,
                     bg_ops_per_round=8)
    drv.insert(data[:1200], np.arange(1200), tick_between=False)
    drv.delete(np.arange(0, 1200, 5))
    drv.tick()
    drv.insert(data[1200:], np.arange(1200, 1500), tick_between=False)
    return drv


def test_unfused_float_oracle_equals_search():
    """The fused search (centroid_topk -> posting_scan_topk -> cache scan
    -> merge) equals the composition over the full (Q, P, C) gather, ids
    and scores bit for bit."""
    drv = _streamed(use_pq=False)
    st, cfg, k = drv.state, drv.cfg, 10
    assert bool(st.cache_valid.any())
    q = _t(np.round(make_clustered(32, d=16, k=8, seed=7)))
    found, scores, probe = search(st, cfg, q, k)
    vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
    _, pr = ref.stable_topk(ops.centroid_score(q, st.centroids, vis),
                            cfg.nprobe)
    assert torch.equal(pr.to(torch.int32), probe)
    ps = ops.posting_scan_gather(q, st.vectors, st.slot_valid, vis, pr)
    cs = ops.centroid_score(q, st.cache_vecs, st.cache_valid)
    Q = q.shape[0]
    all_s = torch.cat([ps.reshape(Q, -1), cs], 1)
    all_i = torch.cat([st.ids[pr].reshape(Q, -1),
                       st.cache_ids.expand(Q, -1)], 1)
    want_s, idx = ref.stable_topk(all_s, k)
    want = torch.where(want_s < BIG / 2, torch.gather(all_i, 1, idx), -1)
    assert torch.equal(found, want) and torch.equal(scores, want_s)


def test_unfused_adc_oracle_equals_pq_scan_topk():
    """The ADC stage of the quant search equals ``pq_scan_gather`` on its
    own probes and tables plus a stable top-rerank_k, exactly."""
    drv = _streamed(use_pq=True)
    st, cfg = drv.state, drv.cfg
    q = _t(np.round(make_clustered(32, d=16, k=8, seed=7)))
    _, _, probe = search(st, cfg, q, 10)
    vis = vm.visible(st.rec_meta, st.allocated, st.global_version)
    luts = pq.lookup_tables(st.pq_codebooks, q)
    C = cfg.capacity
    R = min(cfg.rerank_k, probe.shape[1] * C)
    adc, cand = ops.pq_scan_topk(luts, st.codes, st.pq_posting_slot,
                                 st.slot_valid, vis, probe, k=R)
    g = ops.pq_scan_gather(luts, st.codes, st.pq_posting_slot,
                           st.slot_valid, vis, probe)
    s, pos = ref.stable_topk(g.reshape(len(q), -1), R)
    flat = probe.long()[:, :, None] * C + torch.arange(C)[None, None, :]
    assert torch.equal(adc, s)
    assert torch.equal(cand.long(),
                       torch.gather(flat.reshape(len(q), -1), 1, pos))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_psg(dev, Q, M, C, P, d, kind, how, off=0):
    """A float gather case on the card: inputs (``off`` floats past an
    aligned start for q and the vectors), the kernel's scores and the
    plain version's."""
    rng = np.random.default_rng(Q * M * C + d + len(how) + off)

    def t(a):
        flat = torch.zeros(a.size + off, dtype=torch.float32, device=dev)
        flat[off:] = torch.as_tensor(a.ravel(), device=dev)
        return flat[off:].view(a.shape)
    q, vecs = t(_data(rng, kind, (Q, d))), t(_data(rng, kind, (M, C, d)))
    slot_valid = torch.as_tensor(rng.random((M, C)) < 0.7, device=dev)
    vis = torch.as_tensor(np.arange(M) % 4 != 1, device=dev)
    probe = torch.as_tensor(_probes(rng, Q, M, P, how), device=dev)
    got = _counted("posting_scan_gather", lambda: ops.posting_scan_gather(
        q, vecs, slot_valid, vis, probe))
    want = ref.posting_scan_gather(q, vecs, slot_valid & vis[:, None], probe)
    return got, want


#: every CPU case of both float gather lists, as (Q, M, C, P, d, kind, how)
PSG_ALL = [c + ("random",) for c in PSG_CASES] + PSG_EDGE


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("Q,M,C,P,d,kind,how", PSG_ALL)
def test_card_posting_scan_gather_cases(cuda_dev, Q, M, C, P, d, kind, how,
                                        off):
    got, want = _card_psg(cuda_dev, Q, M, C, P, d, kind, how, off)
    if kind == "normal":
        _close(got.cpu().numpy(), want.cpu().numpy())
    else:
        assert torch.equal(got, want)


#: every CPU case of both ADC gather lists, as (Q, V, m, ksub, M, C, P,
#: kind, how)
PQG_ALL = [c[:7] + (c[7], "random") for c in PQG_CASES] + PQG_EDGE


@pytest.mark.cuda
@pytest.mark.parametrize("Q,V,m,ksub,M,C,P,kind,how", PQG_ALL)
def test_card_pq_scan_gather_cases(cuda_dev, Q, V, m, ksub, M, C, P, kind,
                                   how):
    """Exact on any tables: the kernel sums in the plain version's order."""
    rng = np.random.default_rng(Q * V * m + ksub + C + len(how))
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    luts = t(_data(rng, kind, (Q, V, m, ksub)))
    codes = t(rng.integers(0, ksub, (M, m, C)).astype(np.uint8))
    slot = t((np.arange(M) % (V + 2) - 1).astype(np.int32))
    slot_valid = t(rng.random((M, C)) < 0.7)
    vis = t(np.arange(M) % 4 != 1)
    probe = t(_probes(rng, Q, M, P, how))
    got = _counted("pq_scan_gather", lambda: ops.pq_scan_gather(
        luts, codes, slot, slot_valid, vis, probe))
    want = ref.pq_scan_gather(luts, codes, slot.clamp(0, V - 1),
                              slot_valid & vis[:, None], probe)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 37, 256])
def test_card_gather_scores_equal_posting_scan_topk(cuda_dev, Q):
    """On normal data the float gather's score at each of
    ``posting_scan_topk``'s picks is that kernel's score, bit for bit:
    both walk a row with ``row_walk``, in the same staging units."""
    rng = np.random.default_rng(Q)
    M, C, P, d = 300, 96, 32, 128
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    q, vecs = t(_data(rng, "normal", (Q, d))), t(_data(rng, "normal",
                                                       (M, C, d)))
    slot_valid = t(rng.random((M, C)) < 0.8)
    vis = t(rng.random(M) < 0.9)
    probe = t(np.stack([rng.permutation(M)[:P] for _ in range(Q)])
              .astype(np.int32))                # distinct within a query
    gath = ops.posting_scan_gather(q, vecs, slot_valid, vis, probe)
    for k in (1, 10, 32):
        s, cand = ops.posting_scan_topk(q, vecs, slot_valid, vis, probe, k=k)
        p = (probe.long()[:, :, None] == (cand.long() // C)[:, None, :])
        p = p.int().argmax(1)                               # (Q, k)
        at = gath[torch.arange(Q, device=cuda_dev)[:, None], p,
                  cand.long() % C]
        assert torch.equal(at, s)


@pytest.mark.cuda
@pytest.mark.parametrize("C,d,kind", [(96, 128, "int"), (33, 100, "int"),
                                      (33, 100, "normal")])
def test_card_posting_scan_gather_kernel(cuda_dev, C, d, kind):
    rng = np.random.default_rng(C + d)
    Q, M, P = 37, 200, 8
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    q, vecs = t(_data(rng, kind, (Q, d))), t(_data(rng, kind, (M, C, d)))
    slot_valid = t(rng.random((M, C)) < 0.7)
    vis = t(rng.random(M) < 0.9)
    probe = t(rng.integers(0, M, (Q, P)).astype(np.int32))
    got = _counted("posting_scan_gather", lambda: ops.posting_scan_gather(
        q, vecs, slot_valid, vis, probe))
    want = ref.posting_scan_gather(q, vecs, slot_valid & vis[:, None], probe)
    if kind == "int":
        assert torch.equal(got, want)
    else:
        _close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("C,m,ksub,kind", [(96, 16, 256, "normal"),
                                           (33, 10, 100, "normal"),
                                           (33, 4, 16, "int")])
def test_card_pq_scan_gather_kernel(cuda_dev, C, m, ksub, kind):
    """Same summation order as the plain version: exact on real-valued
    tables too."""
    rng = np.random.default_rng(C + m + ksub)
    Q, M, V, P = 37, 200, 2, 8
    t = lambda a: torch.as_tensor(a, device=cuda_dev)          # noqa: E731
    luts = t(_data(rng, kind, (Q, V, m, ksub)))
    codes = t(rng.integers(0, ksub, (M, m, C)).astype(np.uint8))
    slot = t(rng.integers(-1, V + 1, M).astype(np.int32))
    slot_valid = t(rng.random((M, C)) < 0.7)
    vis = t(rng.random(M) < 0.9)
    probe = t(rng.integers(0, M, (Q, P)).astype(np.int32))
    got = _counted("pq_scan_gather", lambda: ops.pq_scan_gather(
        luts, codes, slot, slot_valid, vis, probe))
    want = ref.pq_scan_gather(luts, codes, slot.clamp(0, V - 1),
                              slot_valid & vis[:, None], probe)
    assert torch.equal(got, want)
