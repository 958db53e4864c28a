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
// - Staging.  A block serves one query and a group of its probes.  One
//   thread copies the query's tables (all V codebook slots, contiguous)
//   into shared memory with one Hopper bulk copy on an mbarrier
//   (bulk_copy.cuh).  Each warp streams its own probed tiles (tiles w,
//   w + 8, ... of the chunk) through a ring of two stages: one bulk copy
//   of the m*C code bytes and one of the C slot_valid bytes a tile, so its
//   next tile is in flight while it scores one, and a warp waits on no
//   other warp.  The first tiles are on their way before the block reads
//   its probes' slots and masks (one record a probe, in shared memory)
//   and before the wait on the tables.  Lane c scores slots c, c + 32,
//   ...: m byte loads from the staged tile (consecutive lanes on
//   consecutive bytes) and m table lookups.  Where the tables, tiles or
//   slot_valid rows are not 16-byte aligned or m*C or C is no multiple of
//   16 (the BULK = false instance), every thread copies table floats and
//   lanes read code and slot_valid bytes from device memory.
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

#include "bulk_copy.cuh"
#include "topk_select.cuh"

namespace cg = cooperative_groups;

#define PQ_WARPS SEL_WARPS
#define PQ_STAGES 2          // code-tile stages a warp
#define PQ_CHUNK_MAX 4096    // slots of a chunk (whole tiles)
#define PQ_CHUNK_TILES 256   // tiles of a chunk at most
#define PQ_MAX_SPLIT 8       // blocks a query: a portable cluster

struct PqLayout {
  size_t lut, ring, praw, info, u, uk, sel, rk, lists, scratch, bytes;
  int stage_bytes, valid_off;
};

// Shared-memory layout: mbarriers (1 + PQ_WARPS * PQ_STAGES), the tables,
// the ring of code tiles with their slot_valid rows (BULK only), the
// block's probe ids, the chunk's probe records, the pair buffer and its
// keys, the k selected and their composites, a split's S sorted lists
// (S > 1), the selection's scratch and the lists' lengths.
static PqLayout pq_layout(bool bulk, int lut_n, int m, int C, int k,
                          int chunk_tiles, int group, int S) {
  PqLayout L;
  L.valid_off = bulk ? ((m * C + 15) & ~15) : 0;
  L.stage_bytes = bulk ? L.valid_off + ((C + 15) & ~15) : 0;
  const bool multi = chunk_tiles < group;
  const int ucap = std::max((multi ? k : 0) + chunk_tiles * C,
                            S > 1 ? k : 0);
  size_t o = 0;
  auto take = [&](size_t bytes) {         // 16-byte aligned regions
    const size_t at = o;
    o += (bytes + 15) & ~(size_t)15;
    return at;
  };
  take(8 * (1 + PQ_WARPS * PQ_STAGES));
  L.lut = take((size_t)lut_n * 4);
  L.ring = take((size_t)PQ_WARPS * PQ_STAGES * L.stage_bytes);
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
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [0]: tables
  float* lut = reinterpret_cast<float*>(smem + lay.lut);
  uint8_t* ring = smem + lay.ring;
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
  const int mc = m * C;
  const int* prow = probe + (size_t)qq * P;
  const float* lq = luts + (size_t)qq * lut_n;
  auto stage = [&](int g) {
    return ring + (size_t)(warp * PQ_STAGES + g % PQ_STAGES) * lay.stage_bytes;
  };
  // lane 0: tile t of the chunk (posting pid) into the stage of use g
  auto issue = [&](int g, int pid) {
    uint64_t* bar = &bars[1 + warp * PQ_STAGES + g % PQ_STAGES];
    uint8_t* dst = stage(g);
    mbar_arrive_expect(bar, (uint32_t)(mc + C));
    bulk_copy_g2s(dst, codes + (size_t)pid * mc, (uint32_t)mc, bar);
    bulk_copy_g2s(dst + lay.valid_off, slot_valid + (size_t)pid * C,
                  (uint32_t)C, bar);
  };

  if (S > 1)                 // paired with the wait before the first store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (BULK) {
    if (tid == 0) {
      for (int b = 0; b < 1 + PQ_WARPS * PQ_STAGES; ++b) mbar_init(&bars[b], 1);
      mbar_fence_init();
      mbar_arrive_expect(&bars[0], (uint32_t)lut_n * 4u);
      bulk_copy_g2s(lut, lq, (uint32_t)lut_n * 4u, &bars[0]);
    }
  } else {
    for (int e = tid; e < lut_n; e += SEL_THREADS) lut[e] = lq[e];
  }
  for (int t = tid; t < pe - pb; t += SEL_THREADS) praw[t] = prow[pb + t];
  __syncthreads();

  int nrun = 0;     // pairs kept from earlier chunks, in sel
  int g = 0;        // code tiles this warp has consumed (its ring phase)
  for (int c0 = pb; c0 < pe; c0 += chunk_tiles) {
    const int nt = min(pe, c0 + chunk_tiles) - c0;
    if (BULK && lane == 0)                   // the first tiles on their way
      for (int j = 0; j < PQ_STAGES && warp + j * PQ_WARPS < nt; ++j)
        issue(g + j, min(max(praw[c0 + warp + j * PQ_WARPS - pb], 0), M - 1));
    // each probe's posting, table offset and mask, read once
    for (int t = tid; t < nt; t += SEL_THREADS) {
      const int p = c0 + t;
      const int pid = min(max(praw[p - pb], 0), M - 1);
      const bool ok = vis[pid] && (qp_ok == nullptr ||
                                   qp_ok[(size_t)qq * P + p] != 0);
      info[t] = make_int4(pid, min(max(slot[pid], 0), V - 1) * m * ksub,
                          ok, 0);
    }
    for (int i = tid; i < nrun; i += SEL_THREADS) {
      u[i] = sel[i];
      uk[i] = (uint32_t)(rk[i] >> 32);
    }
    __syncthreads();
    if (BULK) mbar_wait(&bars[0], 0);
    for (int t = warp; t < nt; t += PQ_WARPS, ++g) {    // warp-uniform
      const int4 in = info[t];
      const float* L = lut + in.y;
      const uint8_t* cd;
      const uint8_t* ok;
      if (BULK) {
        mbar_wait(&bars[1 + warp * PQ_STAGES + g % PQ_STAGES],
                  (uint32_t)(g / PQ_STAGES) & 1u);
        cd = stage(g);
        ok = cd + lay.valid_off;
      } else {
        cd = codes + (size_t)in.x * mc;
        ok = slot_valid + (size_t)in.x * C;
      }
      const int pos0 = (c0 + t) * C;
      float2* dst = u + nrun + t * C;
      uint32_t* dkey = uk + nrun + t * C;
      for (int c = lane; c < C; c += 32) {
        float acc = L[cd[c]];
        for (int j = 1; j < m; ++j) acc += L[j * ksub + cd[j * C + c]];
        const float sc = in.z && ok[c] ? acc : REPRO_BIG;
        dst[c] = sel_pair(sc, pos0 + c);
        dkey[c] = order_key(sc);
      }
      if (BULK) {
        __syncwarp();                  // every lane is done with the stage
        if (lane == 0 && t + PQ_STAGES * PQ_WARPS < nt)
          issue(g + PQ_STAGES, info[t + PQ_STAGES * PQ_WARPS].x);
      }
    }
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
  bool bulk = (uintptr_t)luts % 16 == 0 && lut_n % 4 == 0 &&
              (uintptr_t)codes % 16 == 0 && (m * C) % 16 == 0 &&
              (uintptr_t)slot_valid % 16 == 0 && C % 16 == 0;
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
