"""The one entry point to the port's kernels: dispatch by device.

A tensor on the CPU goes to the kernel's plain version (``ref.py``); a
tensor on a CUDA card goes to the hand-written kernel, or the call
raises.  There is no fallback from the card to the plain version.
Callers pass logical shapes and any float dtype; the wrappers here cast
to fp32 and make the operands contiguous, as the kernels need.

Each kernel wrapper counts its launches in a plain int
(:func:`launch_counts`), so a run can show that its path went through
the kernels.  The JAX package's trace-time fallback plane
(``repro/kernels/ops.py:42-135``) has no counterpart: nothing here can
fall back, so the ``kernel_fallback*`` counters read 0 (``obs.Obs``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import centroid_score as _cs
from . import centroid_topk as _ct
from . import flash_attention as _fa
from . import kmeans_assign as _ka
from . import posting_scan as _ps
from . import pq_scan as _pq
from . import ref
from . import rerank as _rr


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def centroid_score(q: torch.Tensor, c: torch.Tensor,
                   vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, d), (M, d)[, (M,) bool] -> (Q, M) scores; masked -> BIG."""
    if vis is None:
        vis = torch.ones((c.shape[0],), dtype=torch.bool, device=c.device)
    if _on_card(q):
        return _cs.centroid_score(_f32(q), _f32(c), vis.contiguous())
    return ref.centroid_score(q, c, vis)


def centroid_topk(q: torch.Tensor, c: torch.Tensor,
                  vis: Optional[torch.Tensor] = None, *, k: int):
    """Fused phase 1: (Q, d), (M, d)[, (M,) bool] -> (scores (Q, k)
    ascending, idx (Q, k) int32); masked centroids -> BIG; ties lowest
    index first."""
    M = c.shape[0]
    if not 0 < k <= M:
        raise ValueError(f"centroid_topk: k={k} outside [1, M={M}]")
    if vis is None:
        vis = torch.ones((M,), dtype=torch.bool, device=c.device)
    if _on_card(q):
        return _ct.centroid_topk(_f32(q), _f32(c), vis.contiguous(), k)
    return ref.centroid_topk(q, c, vis, k)


def posting_scan(q: torch.Tensor, tiles: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(Q, d), (G, C, d), (G, C) bool -> (Q, G*C) scores; invalid -> BIG."""
    if _on_card(q):
        return _ps.posting_scan(_f32(q), _f32(tiles), valid.contiguous())
    return ref.posting_scan(q, tiles, valid)


def posting_scan_topk(q: torch.Tensor, vectors: torch.Tensor,
                      slot_valid: torch.Tensor, vis: torch.Tensor,
                      probe: torch.Tensor, *, k: int,
                      qp_ok: Optional[torch.Tensor] = None):
    """Fused phase 2: probe scan + top-k.  q (Q, d); vectors (M, C, d);
    slot_valid (M, C) bool; vis (M,) bool; probe (Q, P); optional
    per-(query, probe) mask qp_ok.  Returns (scores (Q, k) ascending,
    cand (Q, k) int32 flat slot index ``probe*C + c``)."""
    Q = q.shape[0]
    C = vectors.shape[1]
    P = probe.shape[1]
    if not 0 < k <= P * C:
        raise ValueError(f"posting_scan_topk: k={k} outside [1, P*C]")
    valid = slot_valid & vis[:, None]
    if qp_ok is None:
        qp_ok = torch.ones((Q, P), dtype=torch.int32, device=q.device)
    qp_ok = qp_ok.to(torch.int32)
    if _on_card(q):
        return _ps.posting_scan_topk(
            _f32(q), _f32(vectors), valid.contiguous(), qp_ok.contiguous(),
            probe.to(torch.int32).contiguous(), k)
    return ref.posting_scan_topk(q, vectors, valid, qp_ok, probe, k)


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor,
                  mask: Optional[torch.Tensor] = None):
    """(N, d), (K, d)[, (N,) bool] -> (assign (N,) int32, best (N,) f32):
    the nearest centroid, ties lowest index first; masked points get -1
    and BIG.  Batched: points (Bp, N, d) and centroids (B, K, d) with
    ``B % Bp == 0`` give (B, N) each, batch b scoring ``points[b % Bp]``
    (one launch for every PQ subspace and codebook version)."""
    flat = points.dim() == 2
    if flat:
        points, centroids = points[None], centroids[None]
    if _on_card(points):
        if points.dtype != torch.float32 or points.stride(-1) != 1:
            points = points.float().contiguous()
        a, b = _ka.kmeans_assign(points, _f32(centroids),
                                 None if mask is None else mask.contiguous())
    else:
        a, b = ref.kmeans_assign(points, centroids, mask)
    return (a[0], b[0]) if flat else (a, b)


def pq_scan_topk(luts: torch.Tensor, codes: torch.Tensor,
                 posting_slot: torch.Tensor, slot_valid: torch.Tensor,
                 vis: torch.Tensor, probe: torch.Tensor, *, k: int,
                 qp_ok: Optional[torch.Tensor] = None):
    """Fused ADC scan + top-k (quant-plane phase 2).  luts (Q, V, m,
    ksub); codes (M, m, C) uint8; posting_slot (M,); slot_valid (M, C)
    bool; vis (M,) bool; probe (Q, P); optional per-(query, probe) mask
    qp_ok.  Returns (scores (Q, k) ascending, cand (Q, k) int32 flat slot
    index ``probe*C + c``); masked candidates carry BIG."""
    Q, V = luts.shape[:2]
    C = codes.shape[2]
    P = probe.shape[1]
    if not 0 < k <= P * C:
        raise ValueError(f"pq_scan_topk: k={k} outside [1, P*C]")
    slot = posting_slot.to(torch.int32).clamp(0, V - 1)
    valid = slot_valid & vis[:, None]
    if qp_ok is None:
        qp_ok = torch.ones((Q, P), dtype=torch.int32, device=luts.device)
    qp_ok = qp_ok.to(torch.int32)
    if _on_card(luts):
        return _pq.pq_scan_topk(
            _f32(luts), codes.contiguous(), slot.contiguous(),
            valid.contiguous(), qp_ok.contiguous(),
            probe.to(torch.int32).contiguous(), k)
    return ref.pq_scan_topk(luts, codes, slot, valid, qp_ok, probe, k)


def rerank_topk(q: torch.Tensor, vectors: torch.Tensor,
                tier_spilled: torch.Tensor, cand: torch.Tensor,
                adc: torch.Tensor, *, k: int):
    """Fused exact rerank of the ADC survivors: q (Q, d); vectors (M, C,
    d); tier_spilled (M,) bool; cand (Q, R) flat slot ids; adc (Q, R)
    their ADC scores.  Returns (scores (Q, k) ascending, cand (Q, k)
    int32), ties lowest ADC rank first."""
    R = cand.shape[1]
    if not 0 < k <= R:
        raise ValueError(f"rerank_topk: k={k} outside [1, R={R}]")
    if _on_card(q):
        return _rr.rerank_topk(_f32(q), _f32(vectors),
                               tier_spilled.contiguous(),
                               cand.to(torch.int32).contiguous(), _f32(adc),
                               k)
    return ref.rerank_topk(q, vectors, tier_spilled, cand, adc, k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, Hq, Lq, D), (B, Hkv, Lk, D) x2 -> (B, Hq, Lq, D) fp32:
    attention with GQA (q head h reads kv head ``h // (Hq // Hkv)``),
    query rows aligned to the end of the keys, optional causal mask and
    sliding ``window``; ``scale`` defaults to ``1 / sqrt(D)``."""
    B, Hq, Lq, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or \
            k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if _on_card(q):
        return _fa.flash_attention(_f32(q), _f32(k), _f32(v), causal=causal,
                                   window=window, scale=scale)
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------

#: kernel name -> (module, counter attribute, source, TPU kernel replaced)
KERNELS = {
    "centroid_score": (_cs, "launches", _cs.SOURCE, _cs.REPLACES),
    "centroid_topk": (_ct, "launches", _ct.SOURCE, _ct.REPLACES),
    "posting_scan": (_ps, "launches", _ps.SOURCE, _ps.REPLACES),
    "posting_scan_topk": (_ps, "launches_topk", _ps.SOURCE_TOPK,
                          _ps.REPLACES_TOPK),
    "pq_scan_topk": (_pq, "launches", _pq.SOURCE, _pq.REPLACES),
    "rerank_topk": (_rr, "launches", _rr.SOURCE, _rr.REPLACES),
    "kmeans_assign": (_ka, "launches", _ka.SOURCE, _ka.REPLACES),
    "flash_attention": (_fa, "launches", _fa.SOURCE, _fa.REPLACES),
}


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr, _, _) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr, _, _ in KERNELS.values():
        setattr(mod, attr, 0)
