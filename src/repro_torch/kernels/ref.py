"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth for one CUDA kernel: on a CPU
tensor ``ops`` routes here, and on the card ``chip_smoke.py`` holds each
kernel against its plain version on the same inputs.  They mirror the
JAX package's jnp oracles (``repro/kernels/ref.py``) function for
function.

Distance convention: scores are ``s(q, v) = ||v||^2 - 2 q.v``, which
order like squared L2 (``||q||^2`` is constant per query).

Tie order is part of the answer: the reference breaks every tie lowest
index first, as ``lax.top_k`` does.  PyTorch's own top-k does not
promise that order, so the only top-k in the port is :func:`stable_topk`,
a stable ascending sort and a slice.
"""
from __future__ import annotations

import torch

BIG = 1e30  # masked-score sentinel shared with the CUDA kernels


def stable_topk(scores: torch.Tensor, k: int):
    """The ``k`` smallest entries along the last axis, ascending, ties
    lowest index first.  Returns (values, int64 indices)."""
    s, i = torch.sort(scores, dim=-1, stable=True)
    return s[..., :k], i[..., :k]


def centroid_score(q: torch.Tensor, c: torch.Tensor,
                   vis: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, d), (M, d)[, (M,) bool] -> (Q, M) fp32 scores, BIG where
    ``vis`` is False."""
    q = q.float()
    c = c.float()
    cn = torch.sum(c * c, dim=-1)
    s = cn[None, :] - 2.0 * (q @ c.T)
    if vis is not None:
        s = torch.where(vis[None, :], s, BIG)
    return s


def posting_scan(q: torch.Tensor, tiles: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(Q, d), (G, C, d), (G, C) bool -> (Q, G*C) fp32 scores, BIG at
    invalid slots."""
    G, C, d = tiles.shape
    return centroid_score(q, tiles.reshape(G * C, d), valid.reshape(G * C))


def centroid_topk(q: torch.Tensor, c: torch.Tensor, vis: torch.Tensor,
                  k: int):
    """Masked centroid scores + top-k: (scores (Q, k) ascending,
    idx (Q, k) int32); masked centroids carry BIG."""
    s, i = stable_topk(centroid_score(q, c, vis), k)
    return s, i.to(torch.int32)


def posting_scan_topk(q: torch.Tensor, vectors: torch.Tensor,
                      valid: torch.Tensor, qp_ok: torch.Tensor,
                      probe: torch.Tensor, k: int):
    """Masked probe scan + top-k.

    q (Q, d); vectors (M, C, d); valid (M, C) bool (slot validity and
    posting visibility combined); qp_ok (Q, P); probe (Q, P).  Returns
    (scores (Q, k) ascending, cand (Q, k) int32 flat slot index
    ``probe*C + c``); ties break by position in the flattened (P, C)
    order."""
    q = q.float()
    probe = probe.long()
    tiles = vectors[probe].float()                        # (Q, P, C, d)
    Q, P, C, _ = tiles.shape
    vn = torch.sum(tiles * tiles, dim=-1)
    dots = torch.einsum("qd,qpcd->qpc", q, tiles)
    ok = valid[probe] & (qp_ok != 0)[:, :, None]
    s = torch.where(ok, vn - 2.0 * dots, BIG)
    top, pos = stable_topk(s.reshape(Q, P * C), k)
    cand_all = (probe[:, :, None] * C
                + torch.arange(C, device=q.device)[None, None, :])
    cand = torch.gather(cand_all.reshape(Q, P * C), 1, pos)
    return top, cand.to(torch.int32)


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor,
                  mask: torch.Tensor | None = None):
    """Nearest-centroid assignment, batched.

    points (Bp, N, d); centroids (B, K, d) with ``B % Bp == 0``: batch b
    scores ``points[b % Bp]`` against ``centroids[b]``.  Returns (assign
    (B, N) int32, best (B, N) fp32), the lowest index winning ties;
    points masked out by ``mask`` (N,) get -1 and BIG."""
    B, Bp = centroids.shape[0], points.shape[0]
    p = points.float().repeat(B // Bp, 1, 1)
    c = centroids.float()
    cn = torch.sum(c * c, dim=-1)
    s = cn[:, None, :] - 2.0 * torch.bmm(p, c.transpose(1, 2))
    assign = torch.argmin(s, dim=-1)          # the first minimum
    best = torch.gather(s, -1, assign[..., None])[..., 0]
    assign = assign.to(torch.int32)
    if mask is not None:
        assign = torch.where(mask[None, :], assign, -1)
        best = torch.where(mask[None, :], best, BIG)
    return assign, best


def pq_scan_topk(luts: torch.Tensor, codes: torch.Tensor,
                 slot: torch.Tensor, valid: torch.Tensor,
                 qp_ok: torch.Tensor, probe: torch.Tensor, k: int):
    """Masked ADC probe scan + top-k (quant-plane phase 2).

    luts (Q, V, m, ksub); codes (M, m, C) uint8; slot (M,) codebook slot
    of each posting, in [0, V); valid (M, C) bool (slot validity and
    posting visibility combined); qp_ok (Q, P); probe (Q, P).  Returns
    (scores (Q, k) ascending, cand (Q, k) int32 flat slot index
    ``probe*C + c``); masked candidates carry BIG, ties break by position
    in the flattened (P, C) order.  The m lookups are summed in order
    j = 0..m-1, as the CUDA kernel sums them."""
    Q, V, m, ksub = luts.shape
    probe = probe.long()
    C = codes.shape[2]
    P = probe.shape[1]
    codes_g = codes[probe].long()                          # (Q, P, m, C)
    base = slot.long()[probe] * (m * ksub)                 # (Q, P)
    flat = luts.float().reshape(Q, V * m * ksub)
    raw = None
    for j in range(m):
        idx = (base[:, :, None] + j * ksub + codes_g[:, :, j, :])
        picked = torch.gather(flat, 1, idx.reshape(Q, P * C))
        raw = picked if raw is None else raw + picked
    ok = valid[probe] & (qp_ok != 0)[:, :, None]
    s = torch.where(ok.reshape(Q, P * C), raw, BIG)
    top, pos = stable_topk(s, k)
    cand_all = (probe[:, :, None] * C
                + torch.arange(C, device=luts.device)[None, None, :])
    cand = torch.gather(cand_all.reshape(Q, P * C), 1, pos)
    return top, cand.to(torch.int32)


def rerank_topk(q: torch.Tensor, vectors: torch.Tensor,
                tier_spilled: torch.Tensor, cand: torch.Tensor,
                adc: torch.Tensor, k: int):
    """Exact rerank of the ADC stage's survivors (quant plane stage 2).

    q (Q, d); vectors (M, C, d); tier_spilled (M,) bool; cand (Q, R)
    flat slot ids from :func:`pq_scan_topk`; adc (Q, R) their ADC
    scores.  Each candidate is rescored ``||v||^2 - 2 q.v`` from its
    float row, except that a tier-spilled posting keeps its ADC score,
    and an empty ADC slot (``adc >= BIG/2``) scores BIG.  Returns
    (scores (Q, k) ascending, cand (Q, k) int32), ties lowest ADC rank
    first."""
    M, C, d = vectors.shape
    cand = cand.long()
    cv = vectors.reshape(M * C, d)[cand].float()           # (Q, R, d)
    exact = (torch.sum(cv * cv, -1)
             - 2.0 * torch.einsum("qd,qrd->qr", q.float(), cv))
    adc = adc.float()
    exact = torch.where(tier_spilled[cand // C], adc, exact)
    exact = torch.where(adc < BIG / 2, exact, BIG)
    top, pos = stable_topk(exact, k)
    return top, torch.gather(cand, 1, pos).to(torch.int32)


NEG = -1e30  # attention mask value, as the Pallas kernel masks (not -inf)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention in one pass, with the Pallas kernel's semantics.

    q (B, Hq, Lq, D); k, v (B, Hkv, Lk, D) -> (B, Hq, Lq, D) fp32.  GQA:
    q head h reads kv head ``h // (Hq // Hkv)``.  Query row i sits at
    position ``Lk - Lq + i`` (the ends align); ``causal`` keeps keys at
    or before it and ``window`` keys in ``(qpos - window, qpos]``.  Masked
    logits are ``NEG`` and the denominator is clamped at 1e-30, so a row
    with no valid key gets an average of ``v``, never NaN (the kernel's
    average there depends on its tiling: no implementation is right
    for such a row).  ``scale`` defaults to ``1 / sqrt(D)`` and, as in
    the kernel, multiplies q before the product."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of "
                         f"Hkv={Hkv}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, Lq, D) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    qpos = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    # in place: at the serving path's shape s alone is 2 GiB
    p = s.masked_fill_(~mask, NEG)
    p = p.sub_(p.amax(-1, keepdim=True)).exp_()
    den = p.sum(-1, keepdim=True).clamp_min_(1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / den
    return out.reshape(B, Hq, Lq, D)
