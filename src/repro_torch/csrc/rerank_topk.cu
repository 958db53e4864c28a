// rerank_topk: the quant plane's exact rerank.  Per query, for each of the
// R candidates r of the ADC stage (flat slot id cand[q, r], ADC score
// adc[q, r]):
//     e[r] = spilled[cand / C] ? adc[q, r] : ||v||^2 - 2 q.v,  v = rows[cand]
//     e[r] = adc[q, r] < BIG/2 ? e[r] : BIG
// and the k smallest e, ascending, ties by the lower ADC rank r (the order
// in which the ADC stage ranked them); the id written out is cand[q, r].
//
// Replaces the Pallas TPU kernel src/repro/kernels/rerank.py:rerank_topk,
// which streams the candidate rows from HBM one at a time with a DMA per
// row.
//
// Bound on the H100: device-memory bytes, the rows that must be read, d
// floats each, gathered at random (192 x 128 x 4 = 96 KB a query at the
// quant path's shapes), against 4 FLOP per float read.  A row read alone
// is one round trip to device memory, so the design keeps many in flight:
// - One block serves one query.  Its threads first read the query's
//   candidate ids and ADC scores once, coalesced, into shared memory, and
//   settle there every candidate that needs no row: an empty ADC slot
//   scores BIG, a spilled posting's candidate keeps its ADC score (on the
//   tiered path most candidates; their rows are never read).
// - The rows: eight lanes share a row, 16-byte loads (lane j of the eight
//   takes float4s j, j + 8, ...: 4 each at d = 128), so a warp scores four
//   rows at once, and each group of eight lanes issues the loads of
//   RR_FLIGHT rows before any reduction; the block's 32 groups take the
//   candidates in turn, so all eight warps work at R = 192.  Each lane
//   sums its part in order, then three shuffles sum the eight parts.
//   Where d % 4 != 0 or the rows are not 16-byte aligned (the V4 = false
//   instance) the lanes take single floats.
// - Selection, once.  k <= 32: each warp keeps a k-list in registers
//   (topk_insert_lanes, keyed by r) over its share of the scores, and one
//   warp merges the eight.  k > 32 (the tiered path asks 192): block_select
//   and one block_rank_emit over the R (score, r) pairs and their order
//   keys (topk_select.cuh), with the k kept so far in front of the next
//   chunk's where R exceeds a chunk of 2,048.  No 512-entry buffer is
//   sorted again and again.
// - Small batches: one block a query even at Q = 32.  A block's time is
//   about two round trips to device memory (its 32 groups hold 128 rows in
//   flight), and at Q = 32 the 32 blocks still keep 2 MB of rows in
//   flight, what the card's bandwidth-latency product asks; a split of R
//   across blocks would add a merge to every query.
#include "topk_select.cuh"

#define RR_GROUP 8          // lanes a row
#define RR_GROUPS (SEL_THREADS / RR_GROUP)
#define RR_FLIGHT 4         // rows a group loads before it reduces
#define RR_CHUNK 2048       // candidates staged at a time

// Shared-memory layout, 16-byte aligned regions: the query row, the
// chunk's row ids and pre-set scores, the pair buffer (with the k kept in
// front where k > 32), the k selected and their composites (k > 32), the
// selection's scratch, the eight warps' lists (k <= 32).
struct RrLayout {
  int ci, pre, u, uk, sel, rk, scratch, ms, mi, bytes;  // offsets; total
};

__host__ __device__ inline int rr_take(int& o, int bytes) {
  const int at = o;
  o += (bytes + 15) & ~15;
  return at;
}

__host__ __device__ inline RrLayout rr_layout(int d, int chunk, int k) {
  const int wk = k > 32 ? k : 0;
  RrLayout L;
  int o = 0;
  rr_take(o, 4 * d);
  L.ci = rr_take(o, 4 * chunk);
  L.pre = rr_take(o, 4 * chunk);
  L.u = rr_take(o, 8 * (chunk + wk));
  L.uk = rr_take(o, 4 * (chunk + wk));
  L.sel = rr_take(o, 8 * wk);
  L.rk = rr_take(o, 8 * wk);
  L.scratch = rr_take(o, 4 * SEL_SCRATCH_INTS);
  L.ms = rr_take(o, 4 * SEL_THREADS);
  L.mi = rr_take(o, 4 * SEL_THREADS);
  L.bytes = o;
  return L;
}

template <bool V4>
__global__ void __launch_bounds__(SEL_THREADS, 2)
rerank_topk_kernel(const float* __restrict__ q, const float* __restrict__ rows,
                   const uint8_t* __restrict__ spilled,
                   const int* __restrict__ cand,
                   const float* __restrict__ adc, int N, int C, int d, int R,
                   int k, int chunk, float* __restrict__ out_s,
                   int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool wide = k > 32;
  const RrLayout lay = rr_layout(d, chunk, k);
  float* qs = reinterpret_cast<float*>(smem);                // [d]
  int* ci = reinterpret_cast<int*>(smem + lay.ci);           // [chunk]
  float* pre = reinterpret_cast<float*>(smem + lay.pre);     // [chunk]
  float2* u = reinterpret_cast<float2*>(smem + lay.u);
  uint32_t* uk = reinterpret_cast<uint32_t*>(smem + lay.uk); // u's keys
  float2* sel = reinterpret_cast<float2*>(smem + lay.sel);   // [k] (wide)
  uint64_t* rk = reinterpret_cast<uint64_t*>(smem + lay.rk); // [k] (wide)
  int* scratch = reinterpret_cast<int*>(smem + lay.scratch);
  float* ms = reinterpret_cast<float*>(smem + lay.ms);
  int* mi = reinterpret_cast<int*>(smem + lay.mi);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = tid / RR_GROUP;
  const int sub = tid % RR_GROUP;
  const int qq = blockIdx.x;
  const int* crow = cand + (size_t)qq * R;
  const float* arow = adc + (size_t)qq * R;
  for (int t = tid; t < d; t += SEL_THREADS) qs[t] = q[(size_t)qq * d + t];

  float ls;
  int li;
  topk_empty(ls, li);
  int nrun = 0;
  for (int r0 = 0; r0 < R; r0 += chunk) {
    const int len = min(chunk, R - r0);
    // ids and ADC scores, coalesced; a candidate that needs no row is
    // settled here (ci = -1, pre = its score)
    for (int i = tid; i < len; i += SEL_THREADS) {
      const int c = min(max(crow[r0 + i], 0), N - 1);
      const float a = arow[r0 + i];
      const bool empty = !(a < REPRO_BIG / 2);
      const bool sp = !empty && spilled[c / C];
      ci[i] = empty || sp ? -1 : c;
      pre[i] = empty ? REPRO_BIG : a;
    }
    for (int i = tid; i < nrun; i += SEL_THREADS) {
      u[i] = sel[i];
      uk[i] = (uint32_t)(rk[i] >> 32);
    }
    __syncthreads();
    // warp-uniform trips (the shuffles below take the whole warp): the
    // warp's four groups take candidates wb + (grp & 3) + 32 b
    for (int wb = grp & ~3; wb < len; wb += RR_GROUPS * RR_FLIGHT) {
      const int base = wb + (grp & 3);
      int row[RR_FLIGHT];
      float vn[RR_FLIGHT], dot[RR_FLIGHT];
#pragma unroll
      for (int b = 0; b < RR_FLIGHT; ++b) {
        const int r = base + b * RR_GROUPS;
        row[b] = r < len ? ci[r] : -1;
        vn[b] = 0.f;
        dot[b] = 0.f;
      }
      if (V4) {
        const int d4 = d >> 2;
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        const float4* r4 = reinterpret_cast<const float4*>(rows);
#pragma unroll 2
        for (int f = sub; f < d4; f += RR_GROUP) {
          const float4 w = q4[f];
          float4 v[RR_FLIGHT];
#pragma unroll
          for (int b = 0; b < RR_FLIGHT; ++b)
            v[b] = row[b] >= 0 ? __ldg(r4 + (size_t)row[b] * d4 + f)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int b = 0; b < RR_FLIGHT; ++b) {
            vn[b] = fmaf(v[b].x, v[b].x, vn[b]);
            vn[b] = fmaf(v[b].y, v[b].y, vn[b]);
            vn[b] = fmaf(v[b].z, v[b].z, vn[b]);
            vn[b] = fmaf(v[b].w, v[b].w, vn[b]);
            dot[b] = fmaf(w.x, v[b].x, dot[b]);
            dot[b] = fmaf(w.y, v[b].y, dot[b]);
            dot[b] = fmaf(w.z, v[b].z, dot[b]);
            dot[b] = fmaf(w.w, v[b].w, dot[b]);
          }
        }
      } else {
#pragma unroll 2
        for (int f = sub; f < d; f += RR_GROUP) {
          const float w = qs[f];
          float v[RR_FLIGHT];
#pragma unroll
          for (int b = 0; b < RR_FLIGHT; ++b)
            v[b] = row[b] >= 0 ? __ldg(rows + (size_t)row[b] * d + f) : 0.f;
#pragma unroll
          for (int b = 0; b < RR_FLIGHT; ++b) {
            vn[b] = fmaf(v[b], v[b], vn[b]);
            dot[b] = fmaf(w, v[b], dot[b]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < RR_FLIGHT; ++b) {
#pragma unroll
        for (int o = RR_GROUP / 2; o > 0; o >>= 1) {
          vn[b] += __shfl_xor_sync(REPRO_FULL_MASK, vn[b], o);
          dot[b] += __shfl_xor_sync(REPRO_FULL_MASK, dot[b], o);
        }
        const int r = base + b * RR_GROUPS;
        if (sub == 0 && r < len) {
          const float e = row[b] >= 0 ? vn[b] - 2.f * dot[b] : pre[r];
          u[nrun + r] = sel_pair(e, r0 + r);
          uk[nrun + r] = order_key(e);
        }
      }
    }
    __syncthreads();
    if (wide) {
      const int n = nrun + len;
      const int kk = min(k, n);
      block_select(u, uk, n, kk, sel, rk, scratch);
      nrun = kk;
    } else {
      for (int i0 = warp * 32; i0 < len; i0 += SEL_THREADS) {  // warp-uniform
        const int i = i0 + lane;
        const bool has = i < len;
        const float2 e = has ? u[i] : sel_pair(CUDART_INF_F, INT_MAX);
        topk_insert_lanes(ls, li, e.x, __float_as_int(e.y), has, k, lane);
      }
      __syncthreads();                 // u is rewritten by the next chunk
    }
  }

  if (wide) {
    block_rank_emit(sel, rk, k, [=](int r, float s, int key, uint64_t) {
      out_s[(size_t)qq * k + r] = s;
      out_i[(size_t)qq * k + r] = crow[key];
    });
    return;
  }
  ms[tid] = ls;
  mi[tid] = li;
  __syncthreads();
  if (warp != 0) return;
  topk_empty(ls, li);
  for (int w = 0; w < SEL_WARPS; ++w) {
    const float s = ms[w * 32 + lane];
    const int i = mi[w * 32 + lane];
    topk_insert_lanes(ls, li, s, i, lane < k && i != INT_MAX, k, lane);
  }
  if (lane < k) {
    out_s[(size_t)qq * k + lane] = ls;
    out_i[(size_t)qq * k + lane] = crow[li];
  }
}

template <bool V4>
static int launch(int Q, size_t smem, cudaStream_t st, const float* q,
                  const float* rows, const uint8_t* spilled, const int* cand,
                  const float* adc, int N, int C, int d, int R, int k,
                  int chunk, float* out_s, int* out_i) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rerank_topk_kernel<V4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rerank_topk_kernel<V4><<<Q, SEL_THREADS, smem, st>>>(
      q, rows, spilled, cand, adc, N, C, d, R, k, chunk, out_s, out_i);
  return (int)cudaGetLastError();
}

// q (Q, d) fp32; rows (N = M*C, d) fp32; spilled (M,) bool bytes;
// cand (Q, R) int32 in [0, N); adc (Q, R) fp32;
// 1 <= k <= min(TOPK_BLOCK_MAX_K, R).  out_s (Q, k) fp32, out_i (Q, k) int32.
extern "C" int rerank_topk(const float* q, const float* rows,
                           const uint8_t* spilled, const int* cand,
                           const float* adc, int Q, int N, int C, int d,
                           int R, int k, float* out_s, int* out_i,
                           void* stream) {
  if (k < 1 || k > TOPK_BLOCK_MAX_K || k > R) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  const int chunk = R < RR_CHUNK ? R : RR_CHUNK;
  const size_t smem = rr_layout(d, chunk, k).bytes;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const bool v4 = d % 4 == 0 && (uintptr_t)rows % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return v4 ? launch<true>(Q, smem, st, q, rows, spilled, cand, adc, N, C, d,
                           R, k, chunk, out_s, out_i)
            : launch<false>(Q, smem, st, q, rows, spilled, cand, adc, N, C,
                            d, R, k, chunk, out_s, out_i);
}
