// posting_scan_topk: per query, scan the P probed posting tiles and keep
// the k smallest of
//     s[p, c] = ok(p, c) ? ||v||^2 - 2 q . v : BIG,   v = vectors[probe[p], c]
//     ok(p, c) = slot_valid[pid, c] && vis[pid] && (qp_ok == null ||
//                qp_ok[p] != 0),                     pid = probe[p]
// ascending, ties by the position p*C + c in the flattened (P, C) order
// (not by the emitted id); the candidate id written out is probe[p]*C + c.
//
// Replaces the Pallas TPU kernel src/repro/kernels/posting_scan.py:
// posting_scan_topk (the probe-indexed tile stream with merge_topk carried
// in the output block).
//
// Bound on the H100: device-memory bytes.  Each probed tile (96 x 128 fp32,
// 48 KB at the main path's shapes) is used for 2 FLOP per byte, far below
// the card's ~20 FLOP/byte fp32 balance point: 403 MB of tiles for 256
// queries x 32 probes, or 262 MB if every distinct probed tile were read
// once (0.078 ms at 3.35 TB/s).
// Design, k <= 32: a block serves one query and a group of its probes,
// grid (Q, S); at a small batch S > 1 splits the probes so that about two
// blocks per SM run, and topk_merge_parts (topk_common.cuh) merges the
// groups' lists.  The block streams its probed tiles through shared memory
// in units: a unit is a row slice of one tile of at most 48 KB
// (PS_UNIT_FLOATS), so any (C, d) fits and two blocks share an SM.  A
// two-stage ring keeps the next unit's copy in flight while the current
// one is scored: one thread issues it as a Hopper bulk copy (bulk_copy.cuh,
// completion counted in bytes on an mbarrier) where the tile is 16-byte
// aligned and d % 4 == 0, else every thread copies 4-byte cp.async
// elements (the BULK = false instance).  Each thread scores one slot row
// at a time from shared memory, with no reduction across lanes: it walks
// the row's features from a start rotated by the row (rows a stride of
// d floats apart then fall in distinct banks), as
//     vn = fmaf(v, v, vn);  dot = fmaf(q, v, dot)     (in that order)
// and s = vn - 2 * dot, so integer inputs are exact (row_score.cuh, which
// posting_scan_gather.cu shares: the two give a row the same bits).  Each
// warp keeps its own k-list in registers (lane j = j-th best); a unit's 32
// candidates of a warp are filtered against the list's k-th entry with one
// ballot before any insert (topk_insert_lanes).  At the end one warp merges the block's
// lists.  Selection is by the (score, position) pair in lexicographic
// order, so the tie order depends neither on which warp or block saw
// which probe nor on the order they finish in.
//
// Wide path, 32 < k <= 1024 (a caller's top 64-100, any d and C): the
// warp path's staging and arithmetic, and one exact selection, modelled
// on pq_scan_topk.cu.  Bound: the bytes above, 0.078 ms at 256 queries x
// 32 probes of 96 x 128 (Q = 32: 0.014 ms).  Design:
// - Staging and scoring: a block serves one query and a group of its
//   probes; its units (unit_rows, cut exactly as the warp path cuts them)
//   come through the same two-stage ring (bulk copy where d % 4 == 0 and
//   the rows are aligned, else 4-byte cp.async), and each slot row is
//   scored by row_walk from row_start of its index in its unit, so every
//   score has the warp path's bits (and posting_scan_gather's): a k = 64
//   answer's first 10 are the k = 10 answer.  Rows past 16,384 floats
//   (no warp path there) do not fit two stages beside the selection; the
//   block reads them, and q, from device memory (PSW_DIRECT).
// - Selection: each slot's (score, position) and its order key go to a
//   shared buffer, 256 rows a pass; block_select and block_rank_emit
//   (topk_select.cuh) pick and sort the k best.  Where the group's slots
//   exceed the buffer (5,120 pairs, or what fits), the buffer is cut to
//   its k best whenever the next pass would not fit; the kept pairs stay
//   in front, equal scores in position order, as the tie rule needs.
// - Small batches: below 67 queries S <= 8 blocks of a query (a cluster)
//   split its probes and merge their sorted lists by rank in distributed
//   shared memory, as pq_scan_topk does (S = 4 at Q = 32).
// What sets the pace: the bytes, and the row walks at one block an SM
// (96 rows a unit: 96 of the 256 threads score, a chain of 2 d FMAs a
// row); the selection of 192 of 3,072 pairs takes a few microseconds.
#include <algorithm>
#include <cooperative_groups.h>

#include "bulk_copy.cuh"
#include "row_score.cuh"
#include "topk_select.cuh"

namespace cg = cooperative_groups;

#define PS_MAX_THREADS 256

template <bool BULK, bool V4>
__global__ void __launch_bounds__(PS_MAX_THREADS, 2)
posting_scan_topk_kernel(const float* __restrict__ q,
                         const float* __restrict__ vec,
                         const uint8_t* __restrict__ slot_valid,
                         const uint8_t* __restrict__ vis,
                         const int* __restrict__ qp_ok,
                         const int* __restrict__ probe, int M, int C, int d,
                         int P, int k, int group, int R, int stage_floats,
                         float* __restrict__ out_s, int* __restrict__ out_i,
                         float* __restrict__ part_s,
                         int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  const int dq = (d + 3) & ~3;
  float* qs = smem;                                   // [dq]
  float* stage = smem + dq;                           // [2][stage_floats]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + 2 * stage_floats);
  float* ms = reinterpret_cast<float*>(full + 2);     // [warps][32]
  int* mi = reinterpret_cast<int*>(ms + blockDim.x);  // [warps][32]
  const int qq = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p_begin = blockIdx.y * group;
  const int upt = (C + R - 1) / R;                    // units a tile
  const int units = (min(P, p_begin + group) - p_begin) * upt;
  const int* prow = probe + (size_t)qq * P;

  // unit u: rows [r0, r0 + rows) of probe p's tile
  auto unit = [&](int u, int& p, int& r0, int& rows, int& pid) {
    p = p_begin + u / upt;
    r0 = (u % upt) * R;
    rows = min(R, C - r0);
    pid = min(max(prow[p], 0), M - 1);   // probes come from centroid_topk
  };
  auto issue = [&](int u) {
    int p, r0, rows, pid;
    unit(u, p, r0, rows, pid);
    const float* src = vec + ((size_t)pid * C + r0) * d;
    float* dst = stage + (u & 1) * stage_floats;
    if (BULK) {
      if (tid == 0) {
        const uint32_t bytes = (uint32_t)(rows * d) * 4u;
        mbar_arrive_expect(&full[u & 1], bytes);
        bulk_copy_g2s(dst, src, bytes, &full[u & 1]);
      }
    } else {
      for (int e = tid; e < rows * d; e += blockDim.x)
        cp_async4(dst + e, src + e, 4);
    }
  };

  for (int t = tid; t < d; t += blockDim.x) qs[t] = q[(size_t)qq * d + t];
  if (BULK && tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int u = 0; u < 2; ++u) {
    if (u < units) issue(u);
    if (!BULK) cp_async_commit();
  }

  const int dw = V4 ? d / 4 : d;             // words a row (row_score.cuh)
  float ls;
  int li;
  topk_empty(ls, li);
  for (int u = 0; u < units; ++u) {
    if (BULK) {
      mbar_wait(&full[u & 1], (u >> 1) & 1);
    } else {
      cp_async_wait<1>();
      __syncthreads();
    }
    const float* tile = stage + (u & 1) * stage_floats;
    int p, r0, rows, pid;
    unit(u, p, r0, rows, pid);
    const bool p_ok = (qp_ok == nullptr || qp_ok[(size_t)qq * P + p] != 0) &&
                      vis[pid] != 0;
    for (int rb = warp * 32; rb < rows; rb += blockDim.x) {  // warp-uniform
      const int r = rb + lane;
      const bool has = r < rows;
      float sc = REPRO_BIG;
      if (has) {
        float vn = 0.f, dot = 0.f;
        row_walk<V4, true, true>(tile + r * d, qs, dw, row_start(r, dw), vn,
                                 dot);
        if (p_ok && slot_valid[(size_t)pid * C + r0 + r])
          sc = vn - 2.f * dot;
      }
      topk_insert_lanes(ls, li, sc, p * C + r0 + r, has, k, lane);
    }
    __syncthreads();                  // every thread is done with the stage
    if (u + 2 < units) issue(u + 2);
    if (!BULK) cp_async_commit();
  }

  ms[tid] = ls;
  mi[tid] = li;
  __syncthreads();
  if (warp != 0) return;
  topk_empty(ls, li);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const float s = ms[w * 32 + lane];
    const int i = mi[w * 32 + lane];
    topk_insert_lanes(ls, li, s, i, lane < k && i != INT_MAX, k, lane);
  }
  if (lane >= k) return;
  if (part_s == nullptr) {            // one group: the final list
    const int p = li / C;
    out_s[(size_t)qq * k + lane] = ls;
    out_i[(size_t)qq * k + lane] = prow[p] * C + (li - p * C);
  } else {
    const size_t o = ((size_t)qq * gridDim.y + blockIdx.y) * k + lane;
    part_s[o] = ls;
    part_i[o] = li;
  }
}

template <bool BULK, bool V4>
static int launch_scan(dim3 grid, int threads, size_t smem, cudaStream_t st,
                       const float* q, const float* vec,
                       const uint8_t* slot_valid, const uint8_t* vis,
                       const int* qp_ok, const int* probe, int M, int C,
                       int d, int P, int k, int group, int R,
                       int stage_floats, float* out_s, int* out_i,
                       float* part_s, int* part_i) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        posting_scan_topk_kernel<BULK, V4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  posting_scan_topk_kernel<BULK, V4><<<grid, threads, smem, st>>>(
      q, vec, slot_valid, vis, qp_ok, probe, M, C, d, P, k, group, R,
      stage_floats, out_s, out_i, part_s, part_i);
  return (int)cudaGetLastError();
}

// q (Q, d), vectors (M, C, d) fp32; slot_valid (M, C) and vis (M,) bool
// bytes; qp_ok (Q, P) int32 or null (every probe counts); probe (Q, P)
// int32; 1 <= k <= min(32, P*C).  out_s (Q, k) fp32, out_i (Q, k) int32.  The
// probes go in groups of ``group`` (kernels/posting_scan.py sizes them),
// S = ceil(P / group) blocks a query, S <= 65535; with S > 1, part_s and
// part_i are (Q, S, k) scratch, else unused.
extern "C" int posting_scan_topk(const float* q, const float* vec,
                                 const uint8_t* slot_valid,
                                 const uint8_t* vis, const int* qp_ok,
                                 const int* probe, int Q, int M, int C, int d,
                                 int P, int k, int group, float* out_s,
                                 int* out_i, float* part_s, int* part_i,
                                 void* stream) {
  if (k < 1 || k > 32 || group < 1) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  const int S = (P + group - 1) / group;
  const int R = unit_rows(C, d);                 // rows a unit
  const int threads = std::min(PS_MAX_THREADS, (R + 31) / 32 * 32);
  const int stage_floats = (R * d + 3) & ~3;
  const size_t smem = sizeof(float) * (((d + 3) & ~3) + 2 * stage_floats) +
                      2 * sizeof(uint64_t) +
                      threads * (sizeof(float) + sizeof(int));
  const bool v4 = d % 4 == 0;
  const bool bulk = v4 && (uintptr_t)vec % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* ps = S > 1 ? part_s : nullptr;
  int* pi = S > 1 ? part_i : nullptr;
  const dim3 grid(Q, S);
  int err = bulk ? launch_scan<true, true>(grid, threads, smem, st, q, vec,
                                           slot_valid, vis, qp_ok, probe, M,
                                           C, d, P, k, group, R, stage_floats,
                                           out_s, out_i, ps, pi)
            : v4 ? launch_scan<false, true>(grid, threads, smem, st, q, vec,
                                            slot_valid, vis, qp_ok, probe, M,
                                            C, d, P, k, group, R,
                                            stage_floats, out_s, out_i, ps,
                                            pi)
                 : launch_scan<false, false>(grid, threads, smem, st, q, vec,
                                             slot_valid, vis, qp_ok, probe, M,
                                             C, d, P, k, group, R,
                                             stage_floats, out_s, out_i, ps,
                                             pi);
  if (err || S == 1) return err;
  topk_merge_parts<<<Q, MERGE_WARPS * 32, 0, st>>>(part_s, part_i, S, k,
                                                    probe, P, C, out_s, out_i);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide path, 32 < k <= TOPK_BLOCK_MAX_K (the header note says how).
// ---------------------------------------------------------------------------

#define PSW_MAX_SPLIT 8        // blocks a query: a portable cluster
#define PSW_BUF_MAX (SEL_MAX_ROUNDS * SEL_THREADS)   // block_select's n

// How a block reads its slot rows: staged by bulk copy (16-byte aligned
// rows, d % 4 == 0), staged by 4-byte cp.async, or straight from device
// memory, q too (a row too wide for two stages beside the selection).
enum PswMode { PSW_BULK = 0, PSW_COPY = 1, PSW_DIRECT = 2 };

struct PswLayout {
  size_t bars, qs, stage, u, uk, sel, rk, lists, scratch, bytes;
  int stage_floats;
};

static size_t psw_a16(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

// Shared-memory layout (16-byte aligned regions): the stages' mbarriers,
// q and two stages of R rows (not in PSW_DIRECT), the nb-pair buffer and
// its order keys, the k selected and their composites, a split's S sorted
// lists (S > 1), the selection's scratch and the lists' lengths.
// kernels/posting_scan.py: wide_scan_plan computes the same bytes.
static PswLayout psw_layout(int mode, int d, int R, int nb, int k, int S) {
  PswLayout L;
  const bool staged = mode != PSW_DIRECT;
  L.stage_floats = staged ? (R * d + 3) & ~3 : 0;
  size_t o = 0;
  L.bars = o;
  o += psw_a16(16);
  L.qs = o;
  o += staged ? psw_a16((size_t)((d + 3) & ~3) * 4) : 0;
  L.stage = o;
  o += psw_a16((size_t)2 * L.stage_floats * 4);
  L.u = o;
  o += psw_a16((size_t)nb * 8);
  L.uk = o;
  o += psw_a16((size_t)nb * 4);
  L.sel = o;
  o += psw_a16((size_t)k * 8);
  L.rk = o;
  o += psw_a16((size_t)k * 8);
  L.lists = o;
  o += S > 1 ? psw_a16((size_t)S * k * 8) : 0;
  L.scratch = o;
  o += psw_a16((SEL_SCRATCH_INTS + PSW_MAX_SPLIT) * 4);
  L.bytes = o;
  return L;
}

template <int MODE, bool V4>
__global__ void __launch_bounds__(SEL_THREADS)
posting_scan_topk_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ vec,
                              const uint8_t* __restrict__ slot_valid,
                              const uint8_t* __restrict__ vis,
                              const int* __restrict__ qp_ok,
                              const int* __restrict__ probe, int M, int C,
                              int d, int P, int k, int group, int R, int nb,
                              PswLayout lay, float* __restrict__ out_s,
                              int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(wsmem + lay.bars);
  float* qs = reinterpret_cast<float*>(wsmem + lay.qs);
  float* stage = reinterpret_cast<float*>(wsmem + lay.stage);
  float2* u = reinterpret_cast<float2*>(wsmem + lay.u);
  uint32_t* uk = reinterpret_cast<uint32_t*>(wsmem + lay.uk);  // u's keys
  float2* sel = reinterpret_cast<float2*>(wsmem + lay.sel);
  uint64_t* rk = reinterpret_cast<uint64_t*>(wsmem + lay.rk);
  uint64_t* lists = reinterpret_cast<uint64_t*>(wsmem + lay.lists);  // [S][k]
  int* scratch = reinterpret_cast<int*>(wsmem + lay.scratch);
  int* lens = scratch + SEL_SCRATCH_INTS;   // [S]: the lists' lengths
  const int tid = threadIdx.x;
  const int qq = blockIdx.x;
  const int S = gridDim.y;
  const int pb = blockIdx.y * group;
  const int pe = min(P, pb + group);
  const int upt = (C + R - 1) / R;                    // units a tile
  const int units = (pe - pb) * upt;
  const int* prow = probe + (size_t)qq * P;
  const int sf = lay.stage_floats;

  if (S > 1)                 // paired with the wait before the first store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // unit x: rows [r0, r0 + rows) of probe p's tile, cut as the warp path
  // cuts it (a row's walk starts from its index in its unit)
  auto unit = [&](int x, int& p, int& r0, int& rows, int& pid) {
    p = pb + x / upt;
    r0 = (x % upt) * R;
    rows = min(R, C - r0);
    pid = min(max(prow[p], 0), M - 1);   // probes come from centroid_topk
  };
  auto issue = [&](int x) {
    int p, r0, rows, pid;
    unit(x, p, r0, rows, pid);
    const float* src = vec + ((size_t)pid * C + r0) * d;
    float* dst = stage + (x & 1) * sf;
    if (MODE == PSW_BULK) {
      if (tid == 0) {
        const uint32_t bytes = (uint32_t)(rows * d) * 4u;
        mbar_arrive_expect(&full[x & 1], bytes);
        bulk_copy_g2s(dst, src, bytes, &full[x & 1]);
      }
    } else {
      for (int e = tid; e < rows * d; e += SEL_THREADS)
        cp_async4(dst + e, src + e, 4);
    }
  };

  if (MODE != PSW_DIRECT) {
    for (int t = tid; t < d; t += SEL_THREADS) qs[t] = q[(size_t)qq * d + t];
    if (MODE == PSW_BULK && tid == 0) {
      mbar_init(&full[0], 1);
      mbar_init(&full[1], 1);
      mbar_fence_init();
    }
    __syncthreads();
    for (int x = 0; x < 2; ++x) {
      if (x < units) issue(x);
      if (MODE == PSW_COPY) cp_async_commit();
    }
  }
  const float* qv = MODE == PSW_DIRECT ? q + (size_t)qq * d : qs;
  const int dw = V4 ? d / 4 : d;             // words a row (row_score.cuh)

  int fill = 0;                              // pairs in u, block-uniform
  for (int x = 0; x < units; ++x) {
    if (MODE == PSW_BULK) {
      mbar_wait(&full[x & 1], (x >> 1) & 1);
    } else if (MODE == PSW_COPY) {
      cp_async_wait<1>();
      __syncthreads();
    }
    int p, r0, rows, pid;
    unit(x, p, r0, rows, pid);
    const float* tile = MODE == PSW_DIRECT
                            ? vec + ((size_t)pid * C + r0) * d
                            : stage + (x & 1) * sf;
    const bool p_ok =
        (qp_ok == nullptr || qp_ok[(size_t)qq * P + p] != 0) && vis[pid] != 0;
    for (int rb = 0; rb < rows; rb += SEL_THREADS) {   // block-uniform
      const int nrow = min(SEL_THREADS, rows - rb);
      if (fill + nrow > nb) {     // keep the k best in front (fill > k)
        __syncthreads();
        block_select(u, uk, fill, k, sel, rk, scratch);
        for (int i = tid; i < k; i += SEL_THREADS) {
          u[i] = sel[i];
          uk[i] = (uint32_t)(rk[i] >> 32);
        }
        fill = k;                 // below the next select's first barrier
      }
      const int r = rb + tid;
      if (r < rows) {
        float vn = 0.f, dot = 0.f;
        row_walk<V4, true, true>(tile + (size_t)r * d, qv, dw,
                                 row_start(r, dw), vn, dot);
        float sc = REPRO_BIG;
        if (p_ok && slot_valid[(size_t)pid * C + r0 + r])
          sc = vn - 2.f * dot;
        u[fill + tid] = sel_pair(sc, p * C + r0 + r);
        uk[fill + tid] = order_key(sc);
      }
      fill += nrow;
    }
    if (MODE != PSW_DIRECT) {
      __syncthreads();                // every thread is done with the stage
      if (x + 2 < units) issue(x + 2);
      if (MODE == PSW_COPY) cp_async_commit();
    }
  }
  __syncthreads();
  const int kk = min(k, fill);
  block_select(u, uk, fill, kk, sel, rk, scratch);

  auto emit_out = [=](int r, float s, int pos) {
    const int p = pos / C;
    out_s[(size_t)qq * k + r] = s;
    out_i[(size_t)qq * k + r] = prow[p] * C + (pos - p * C);
  };
  if (S == 1) {
    block_rank_emit(sel, rk, kk, [=](int r, float s, int pos, uint64_t) {
      emit_out(r, s, pos);
    });
    return;
  }
  // the cluster's merge, as pq_scan_topk.cu's: each block sorts its list
  // and writes the sorted composites into every block's slot for it; after
  // one cluster barrier a pair's rank among all S lists is its own index
  // plus, in each other list, the number of composites below its own, and
  // the pairs ranked below k are written out
  cg::cluster_group cl = cg::this_cluster();
  const int me = (int)cl.block_rank();
  float2* srt = u;
  uint64_t* dst[PSW_MAX_SPLIT];
#pragma unroll
  for (int r = 0; r < PSW_MAX_SPLIT; ++r)
    dst[r] = cl.map_shared_rank(lists + (size_t)me * k, r < S ? r : me);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all started
  if (tid < S) *cl.map_shared_rank(lens + me, tid) = kk;
  block_rank_emit(sel, rk, kk, [&](int r, float s, int pos, uint64_t c) {
    srt[r] = sel_pair(s, pos);
#pragma unroll
    for (int b = 0; b < PSW_MAX_SPLIT; ++b)
      if (b < S) dst[b][r] = c;
  });
  cl.sync();                                  // every list has landed
  int len[PSW_MAX_SPLIT];
#pragma unroll
  for (int r = 0; r < PSW_MAX_SPLIT; ++r)
    len[r] = r < S && r != me ? lens[r] : 0;
  int top = 1;
  while (top * 2 <= k) top *= 2;
  const uint64_t* own = lists + (size_t)me * k;
  for (int i = tid; i < kk; i += SEL_THREADS) {
    const uint64_t e = own[i];
    int at[PSW_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < PSW_MAX_SPLIT; ++r) at[r] = 0;
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int r = 0; r < PSW_MAX_SPLIT; ++r)
        if (at[r] + step <= len[r] &&
            lists[(size_t)r * k + at[r] + step - 1] < e)
          at[r] += step;
    }
    int rank = i;
#pragma unroll
    for (int r = 0; r < PSW_MAX_SPLIT; ++r) rank += at[r];
    if (rank < k) emit_out(rank, srt[i].x, __float_as_int(srt[i].y));
  }
}

template <int MODE, bool V4>
static int launch_wide(int Q, int S, const PswLayout& lay, cudaStream_t st,
                       const float* q, const float* vec,
                       const uint8_t* slot_valid, const uint8_t* vis,
                       const int* qp_ok, const int* probe, int M, int C,
                       int d, int P, int k, int group, int R, int nb,
                       float* out_s, int* out_i) {
  auto kern = posting_scan_topk_wide_kernel<MODE, V4>;
  static unsigned long long opted = 0;
  const int opt = allow_smem((const void*)kern, opted);
  if (opt) return opt;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q, S);
  cfg.blockDim = dim3(SEL_THREADS);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, q, vec, slot_valid, vis,
                                       qp_ok, probe, M, C, d, P, k, group, R,
                                       nb, lay, out_s, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// As posting_scan_topk, for 1 <= k <= min(TOPK_BLOCK_MAX_K, P*C) (the
// wrapper takes it past 32), any d and C.  ``mode``: PSW_BULK (needs d % 4
// == 0 and 16-byte aligned vectors), PSW_COPY or PSW_DIRECT; the probes go
// in groups of ``group``, S = ceil(P / group) <= 8 blocks a query, one
// cluster; ``nb`` pairs a block buffers before it selects, <= 5,120 and
// either >= k + 256 or >= group*C.  kernels/posting_scan.py: wide_scan_plan
// sizes them so that the layout fits TOPK_SMEM_MAX bytes.
extern "C" int posting_scan_topk_wide(const float* q, const float* vec,
                                      const uint8_t* slot_valid,
                                      const uint8_t* vis, const int* qp_ok,
                                      const int* probe, int Q, int M, int C,
                                      int d, int P, int k, int mode,
                                      int group, int nb, float* out_s,
                                      int* out_i, void* stream) {
  if (k < 1 || k > TOPK_BLOCK_MAX_K || group < 1 || C < 1 || d < 1 ||
      (long long)P * C < k || mode < PSW_BULK || mode > PSW_DIRECT ||
      nb > PSW_BUF_MAX ||
      (nb < k + SEL_THREADS && (long long)nb < (long long)group * C))
    return (int)cudaErrorInvalidValue;
  const int S = (P + group - 1) / group;
  if (S > PSW_MAX_SPLIT) return (int)cudaErrorInvalidValue;
  const bool v4 = d % 4 == 0;
  if (mode == PSW_BULK && (!v4 || (uintptr_t)vec % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int R = unit_rows(C, d);
  const PswLayout lay = psw_layout(mode, d, R, nb, k, S);
  if (lay.bytes > TOPK_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == PSW_BULK)
    return launch_wide<PSW_BULK, true>(Q, S, lay, st, q, vec, slot_valid, vis,
                                       qp_ok, probe, M, C, d, P, k, group, R,
                                       nb, out_s, out_i);
  if (mode == PSW_COPY && v4)
    return launch_wide<PSW_COPY, true>(Q, S, lay, st, q, vec, slot_valid, vis,
                                       qp_ok, probe, M, C, d, P, k, group, R,
                                       nb, out_s, out_i);
  if (mode == PSW_COPY)
    return launch_wide<PSW_COPY, false>(Q, S, lay, st, q, vec, slot_valid,
                                        vis, qp_ok, probe, M, C, d, P, k,
                                        group, R, nb, out_s, out_i);
  return launch_wide<PSW_DIRECT, false>(Q, S, lay, st, q, vec, slot_valid,
                                        vis, qp_ok, probe, M, C, d, P, k,
                                        group, R, nb, out_s, out_i);
}
