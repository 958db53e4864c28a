// pq_scan_topk: per query, the ADC score of every slot of its P probed
// posting tiles and the k smallest of
//     s[p, c] = ok(p, c) ? sum_{j=0}^{m-1} lut[q, slot[pid], j, codes[pid, j, c]]
//                        : BIG,                      pid = probe[q, p]
//     ok(p, c) = vis[pid] && slot_valid[pid, c] && (qp_ok == null || qp_ok[q, p])
// ascending, ties by the position p*C + c in the flattened (P, C) order;
// the id written out is probe[q, p]*C + c.  The m lookups are summed in
// order j = 0..m-1 in fp32, as the plain version does, so the two agree
// bit for bit.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_scan.py:pq_scan_topk.
// The TPU has no lane gather, so that kernel turns each lookup into a
// one-hot matrix product on the MXU.  Hopper indexes shared memory
// directly.
//
// Bound on the H100: device-memory bytes.  Each probed code tile is m*C
// bytes (1.5 KB at m=16, C=96), read once per query that probes it, and
// the tables Q*V*m*ksub*4 bytes (32 KB a query at V=2, m=16, ksub=256),
// read once, against m shared-memory lookups and adds a slot: 0.0054 ms at
// the quant path's Q=256, P=32.  The kernel's own costs are the lookups
// (random banks: about 3.5 shared-memory cycles a warp's lookup), the
// copies' latency and the selection; the design answers those:
// - Staging and scoring (adc_scan.cuh, shared with pq_scan_gather.cu, so
//   the two give the same scores).  A block serves one query and a group
//   of its probes: the query's tables by one bulk copy, each warp's code
//   tiles and slot_valid rows through its own two-stage ring of bulk
//   copies, the first tiles on their way before the block reads its
//   probes' slots and masks (one record a probe, in shared memory) and
//   before the wait on the tables; lane c scores slots c, c + 32, ... .
//   Where the tables, tiles or slot_valid rows are not 16-byte aligned or
//   m*C or C is no multiple of 16, the BULK = false instance reads them
//   from device memory.
// - Selection, once.  Each slot's (score, position) goes to a shared
//   buffer with the score's order key beside it (3,072 of them, 36 KB at
//   P*C = 3,072), and block_select (topk_select.cuh) picks the k best by a
//   radix select over the keys and one stable compaction; block_rank_emit
//   sorts those k once.  Where the probes' slots exceed the buffer (4,096
//   slots, whole tiles), the probes go in chunks and the k kept so far go
//   in front of the next chunk's slots: equal scores then still stand in
//   position order, which the tie rule needs.
// - Small batches.  Below 67 queries each query's probes split into S <=
//   8 groups (kernels/pq_scan.py: split_probes), one block each, so that
//   about one block per SM works (Q = 32: S = 4, 8 probes a block, one
//   tile a warp).  The S blocks of a query form a thread-block cluster.
//   Each selects and sorts its group's best k and writes their composites
//   into every block of the cluster (distributed shared memory, stores
//   that wait on nothing); after one cluster barrier each block ranks its
//   own k among all S lists (its index in its list plus, in each other
//   list, a binary search) and writes out those ranked below k.  The
//   cluster keeps the merge in the launch and in shared memory, where a
//   merge kernel would add a launch and a round trip through device
//   memory to every call; eight blocks a query measured slower than four
//   (twice the table copies, half the warps idle).
#include <algorithm>
#include <cooperative_groups.h>

#include "adc_scan.cuh"
#include "topk_select.cuh"

namespace cg = cooperative_groups;

static_assert(SEL_THREADS == ADC_THREADS, "one block scans and selects");

#define PQ_CHUNK_MAX 4096    // slots of a chunk (whole tiles)
#define PQ_CHUNK_TILES 256   // tiles of a chunk at most
#define PQ_MAX_SPLIT 8       // blocks a query: a portable cluster

struct PqLayout {
  size_t lut, ring, praw, info, u, uk, sel, rk, lists, scratch, bytes;
  int stage_bytes, valid_off;
};

// Shared-memory layout: mbarriers (ADC_BARS), the tables,
// the ring of code tiles with their slot_valid rows (BULK only), the
// block's probe ids, the chunk's probe records, the pair buffer and its
// keys, the k selected and their composites, a split's S sorted lists
// (S > 1), the selection's scratch and the lists' lengths.
static PqLayout pq_layout(bool bulk, int lut_n, int m, int C, int k,
                          int chunk_tiles, int group, int S) {
  PqLayout L;
  adc_stage_bytes(bulk, m, C, L.valid_off, L.stage_bytes);
  const bool multi = chunk_tiles < group;
  const int ucap = std::max((multi ? k : 0) + chunk_tiles * C,
                            S > 1 ? k : 0);
  size_t o = 0;
  auto take = [&](size_t bytes) {         // 16-byte aligned regions
    const size_t at = o;
    o += (bytes + 15) & ~(size_t)15;
    return at;
  };
  take(8 * ADC_BARS);
  L.lut = take((size_t)lut_n * 4);
  L.ring = take((size_t)ADC_WARPS * ADC_STAGES * L.stage_bytes);
  L.praw = take((size_t)group * 4);
  L.info = take((size_t)chunk_tiles * 16);
  L.u = take((size_t)ucap * 8);
  L.uk = take((size_t)ucap * 4);
  L.sel = take((size_t)k * 8);
  L.rk = take((size_t)k * 8);
  L.lists = take(S > 1 ? (size_t)S * k * 8 : 0);
  L.scratch = take((SEL_SCRATCH_INTS + PQ_MAX_SPLIT) * 4);
  L.bytes = o;
  return L;
}

template <bool BULK>
__global__ void __launch_bounds__(SEL_THREADS)
pq_scan_topk_kernel(const float* __restrict__ luts,
                    const uint8_t* __restrict__ codes,
                    const int* __restrict__ slot,
                    const uint8_t* __restrict__ slot_valid,
                    const uint8_t* __restrict__ vis,
                    const int* __restrict__ qp_ok,
                    const int* __restrict__ probe, int M, int C, int V,
                    int m, int ksub, int P, int k, int group,
                    int chunk_tiles, PqLayout lay,
                    float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AdcRing ring{smem + lay.ring, reinterpret_cast<uint64_t*>(smem),
                     lay.stage_bytes, lay.valid_off};
  float* lut = reinterpret_cast<float*>(smem + lay.lut);
  int* praw = reinterpret_cast<int*>(smem + lay.praw);     // the group's probes
  int4* info = reinterpret_cast<int4*>(smem + lay.info);  // a chunk's probes
  float2* u = reinterpret_cast<float2*>(smem + lay.u);
  uint32_t* uk = reinterpret_cast<uint32_t*>(smem + lay.uk);  // u's keys
  float2* sel = reinterpret_cast<float2*>(smem + lay.sel);
  uint64_t* rk = reinterpret_cast<uint64_t*>(smem + lay.rk);
  int* scratch = reinterpret_cast<int*>(smem + lay.scratch);
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + lay.lists);  // [S][k]
  int* lens = scratch + SEL_SCRATCH_INTS;   // [S]: the lists' lengths

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qq = blockIdx.x;
  const int S = gridDim.y;
  const int pb = blockIdx.y * group;
  const int pe = min(P, pb + group);
  const int lut_n = V * m * ksub;
  const int* prow = probe + (size_t)qq * P;

  if (S > 1)                 // paired with the wait before the first store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  adc_start<BULK>(ring, lut, luts + (size_t)qq * lut_n, lut_n);
  for (int t = tid; t < pe - pb; t += SEL_THREADS) praw[t] = prow[pb + t];
  __syncthreads();

  int nrun = 0;     // pairs kept from earlier chunks, in sel
  int g = 0;        // code tiles this warp has consumed (its ring phase)
  for (int c0 = pb; c0 < pe; c0 += chunk_tiles) {
    const int nt = min(pe, c0 + chunk_tiles) - c0;
    if (BULK && lane == 0)                   // the first tiles on their way
      adc_prime(ring, warp, g, nt, codes, slot_valid, M, m, C,
                [&](int t) { return praw[c0 + t - pb]; });
    // each probe's posting, table offset and mask, read once
    for (int t = tid; t < nt; t += SEL_THREADS) {
      const int p = c0 + t;
      info[t] = adc_record(praw[p - pb], M, slot, V, m, ksub, vis,
                           qp_ok == nullptr || qp_ok[(size_t)qq * P + p] != 0);
    }
    for (int i = tid; i < nrun; i += SEL_THREADS) {
      u[i] = sel[i];
      uk[i] = (uint32_t)(rk[i] >> 32);
    }
    __syncthreads();
    if (BULK) mbar_wait(&ring.bars[0], 0);
    adc_scan_chunk<BULK, false>(
        ring, lut, info, nt, g, codes, slot_valid, m, C, ksub,
        [&](int t, int c, float sc) {
          const int at = nrun + t * C + c;
          u[at] = sel_pair(sc, (c0 + t) * C + c);
          uk[at] = order_key(sc);
        },
        [](int, int, float4) {});
    __syncthreads();
    const int n = nrun + nt * C;
    const int kk = min(k, n);
    block_select(u, uk, n, kk, sel, rk, scratch);
    nrun = kk;
  }

  auto emit_out = [=](int r, float s, int pos) {
    const int p = pos / C;
    out_s[(size_t)qq * k + r] = s;
    out_i[(size_t)qq * k + r] = praw[p - pb] * C + (pos - p * C);
  };
  if (S == 1) {
    block_rank_emit(sel, rk, nrun, [=](int r, float s, int pos, uint64_t) {
      emit_out(r, s, pos);
    });
    return;
  }
  // the cluster's merge: each block sorts its list and writes the sorted
  // composites into every block's slot for it (distributed shared memory,
  // stores that wait on nothing); after one cluster barrier a pair's rank
  // among all S lists is its own index plus, in each other list, the
  // number of composites below its own (binary searches, the S - 1 lists
  // in lockstep), and the pairs ranked below k are written out
  cg::cluster_group cl = cg::this_cluster();
  const int me = (int)cl.block_rank();
  float2* srt = u;
  uint64_t* dst[PQ_MAX_SPLIT];
#pragma unroll
  for (int r = 0; r < PQ_MAX_SPLIT; ++r)
    dst[r] = cl.map_shared_rank(lists + (size_t)me * k, r < S ? r : me);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all started
  if (tid < S) *cl.map_shared_rank(lens + me, tid) = nrun;
  block_rank_emit(sel, rk, nrun, [&](int r, float s, int pos, uint64_t c) {
    srt[r] = sel_pair(s, pos);
#pragma unroll
    for (int b = 0; b < PQ_MAX_SPLIT; ++b)
      if (b < S) dst[b][r] = c;
  });
  cl.sync();                                  // every list has landed
  int len[PQ_MAX_SPLIT];
#pragma unroll
  for (int r = 0; r < PQ_MAX_SPLIT; ++r)
    len[r] = r < S && r != me ? lens[r] : 0;
  int top = 1;
  while (top * 2 <= k) top *= 2;
  const uint64_t* own = lists + (size_t)me * k;
  for (int i = tid; i < nrun; i += SEL_THREADS) {
    const uint64_t e = own[i];
    int at[PQ_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < PQ_MAX_SPLIT; ++r) at[r] = 0;
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int r = 0; r < PQ_MAX_SPLIT; ++r)
        if (at[r] + step <= len[r] &&
            lists[(size_t)r * k + at[r] + step - 1] < e)
          at[r] += step;
    }
    int rank = i;
#pragma unroll
    for (int r = 0; r < PQ_MAX_SPLIT; ++r) rank += at[r];
    if (rank < k) emit_out(rank, srt[i].x, __float_as_int(srt[i].y));
  }
}

template <bool BULK>
static int launch(int Q, int S, size_t smem, cudaStream_t st,
                  const float* luts, const uint8_t* codes, const int* slot,
                  const uint8_t* slot_valid, const uint8_t* vis,
                  const int* qp_ok, const int* probe, int M, int C, int V,
                  int m, int ksub, int P, int k, int group, int chunk_tiles,
                  const PqLayout& lay, float* out_s, int* out_i) {
  auto kern = pq_scan_topk_kernel<BULK>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q, S);
  cfg.blockDim = dim3(SEL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, luts, codes, slot,
                                       slot_valid, vis, qp_ok, probe, M, C, V,
                                       m, ksub, P, k, group, chunk_tiles, lay,
                                       out_s, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// luts (Q, V, m, ksub) fp32; codes (M, m, C) uint8; slot (M,) int32 (the
// kernel clamps it to [0, V)); slot_valid (M, C) and vis (M,) bool bytes;
// qp_ok (Q, P) int32 or null (every probe counts); probe (Q, P) int32;
// 1 <= k <= min(TOPK_BLOCK_MAX_K, P*C); C <= PQ_CHUNK_MAX.  The probes
// go in groups of ``group`` (kernels/pq_scan.py sizes them), S =
// ceil(P / group) <= 8 blocks a query, one cluster.  out_s (Q, k) fp32,
// out_i (Q, k) int32.  Returns cudaErrorInvalidValue where the tables and
// the selection do not fit a block's shared memory (kernels/pq_scan.py
// checks that first).
extern "C" int pq_scan_topk(const float* luts, const uint8_t* codes,
                            const int* slot, const uint8_t* slot_valid,
                            const uint8_t* vis, const int* qp_ok,
                            const int* probe, int Q, int M, int C, int V,
                            int m, int ksub, int P, int k, int group,
                            float* out_s, int* out_i, void* stream) {
  if (k < 1 || k > TOPK_BLOCK_MAX_K || group < 1 || C < 1 ||
      C > PQ_CHUNK_MAX)
    return (int)cudaErrorInvalidValue;
  const int S = (P + group - 1) / group;
  if (S > PQ_MAX_SPLIT) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  const int lut_n = V * m * ksub;
  const int G = std::min(P, group);
  bool bulk = adc_bulk_ok(luts, lut_n, codes, m, C, slot_valid);
  int tiles = std::max(1, std::min({G, PQ_CHUNK_MAX / C, PQ_CHUNK_TILES}));
  PqLayout lay = pq_layout(bulk, lut_n, m, C, k, tiles, G, S);
  const size_t smem_max = 232448;
  if (lay.bytes > smem_max && bulk) {         // no room for the ring
    bulk = false;
    lay = pq_layout(bulk, lut_n, m, C, k, tiles, G, S);
  }
  while (lay.bytes > smem_max && tiles > 1) {
    tiles = (tiles + 1) / 2;
    lay = pq_layout(bulk, lut_n, m, C, k, tiles, G, S);
  }
  if (lay.bytes > smem_max) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bulk ? launch<true>(Q, S, lay.bytes, st, luts, codes, slot,
                             slot_valid, vis, qp_ok, probe, M, C, V, m, ksub,
                             P, k, group, tiles, lay, out_s, out_i)
              : launch<false>(Q, S, lay.bytes, st, luts, codes, slot,
                              slot_valid, vis, qp_ok, probe, M, C, V, m,
                              ksub, P, k, group, tiles, lay, out_s, out_i);
}
