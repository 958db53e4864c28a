// The quant plane's ADC probe scan, staged: shared by pq_scan_topk.cu (which
// selects the best k of the scores) and pq_scan_gather.cu (which writes them
// all), so the two agree bit for bit by construction.
//
// A block serves one query and a group of its probes, with ADC_WARPS warps.
//   s[p, c] = ok(p) && slot_valid[pid, c]
//             ? sum_{j=0}^{m-1} lut[q, slot[pid], j, codes[pid, j, c]] : BIG
// with pid = probe[q, p] and slot[pid] clamped to [0, V); the m lookups are
// summed in order j = 0..m-1 in fp32, as the plain versions sum them.
// - Tables: one thread copies the query's V*m*ksub floats (all codebook
//   slots, contiguous) into shared memory with one Hopper bulk copy on an
//   mbarrier (bulk_copy.cuh), or every thread copies floats (BULK false).
// - Code tiles: each warp streams its own probed tiles (tiles w, w + 8, ...
//   of a chunk) through a ring of ADC_STAGES stages: one bulk copy of the
//   m*C code bytes and one of the C slot_valid bytes a tile, so its next
//   tile is in flight while it scores one, and a warp waits on no other
//   warp.  The first tiles of a chunk are issued from the raw probe ids,
//   before the probe records are built; a later tile whose probe does not
//   count (an invisible posting, a zero qp_ok) is not copied: its stage's
//   barrier takes a bare arrival.  Where the tables, tiles or slot_valid
//   rows are not 16-byte aligned or m*C or C is no multiple of 16 (BULK
//   false), lanes read code and slot_valid bytes from device memory.
// - Scores: lane c scores slots c, c + 32, ...: m byte loads from the tile
//   (consecutive lanes on consecutive bytes) and m table lookups (random
//   banks: about 3.5 shared-memory cycles a warp's lookup); or, from a
//   staged tile (QUAD), lane l scores slots 4l .. 4l + 3, 4l + 128, ...:
//   m word loads (four codes each) and 4m lookups, a quarter of the code
//   loads.  Each slot's sum runs j = 0..m-1 either way.  A probe that does
//   not count gives BIG with no lookups.
#pragma once

#include "bulk_copy.cuh"

#define ADC_THREADS 256
#define ADC_WARPS (ADC_THREADS / 32)
#define ADC_STAGES 2              // code-tile stages a warp
#define ADC_BARS (1 + ADC_WARPS * ADC_STAGES)   // [0]: the tables
#define ADC_BIG 1e30f

// A warp's ring of code-tile stages, each the m*C code bytes then the C
// slot_valid bytes (at valid_off), all 16-byte aligned.
struct AdcRing {
  uint8_t* ring;
  uint64_t* bars;           // ADC_BARS mbarriers
  int stage_bytes, valid_off;
};

// (valid_off, stage_bytes) of a stage; (0, 0) where nothing is staged
inline void adc_stage_bytes(bool bulk, int m, int C, int& valid_off,
                            int& stage_bytes) {
  valid_off = bulk ? ((m * C + 15) & ~15) : 0;
  stage_bytes = bulk ? valid_off + ((C + 15) & ~15) : 0;
}

// the BULK instance's conditions: 16-byte aligned sources, sizes a
// multiple of 16 bytes
inline bool adc_bulk_ok(const float* luts, int lut_n, const uint8_t* codes,
                        int m, int C, const uint8_t* slot_valid) {
  return (uintptr_t)luts % 16 == 0 && lut_n % 4 == 0 &&
         (uintptr_t)codes % 16 == 0 && (m * C) % 16 == 0 &&
         (uintptr_t)slot_valid % 16 == 0 && C % 16 == 0;
}

// mbarriers initialised and the query's tables on their way (BULK), or
// copied by every thread; a block barrier must follow before any use
template <bool BULK>
__device__ __forceinline__ void adc_start(const AdcRing& R, float* lut,
                                          const float* lq, int lut_n) {
  if (BULK) {
    if (threadIdx.x == 0) {
      for (int b = 0; b < ADC_BARS; ++b) mbar_init(&R.bars[b], 1);
      mbar_fence_init();
      mbar_arrive_expect(&R.bars[0], (uint32_t)lut_n * 4u);
      bulk_copy_g2s(lut, lq, (uint32_t)lut_n * 4u, &R.bars[0]);
    }
  } else {
    for (int e = threadIdx.x; e < lut_n; e += ADC_THREADS) lut[e] = lq[e];
  }
}

__device__ __forceinline__ uint8_t* adc_stage(const AdcRing& R, int warp,
                                              int g) {
  return R.ring + (size_t)(warp * ADC_STAGES + g % ADC_STAGES) *
                      R.stage_bytes;
}

// lane 0 of ``warp``: posting pid's code tile and slot_valid row into the
// stage of the warp's use g, or (copy false) a bare arrival there
__device__ __forceinline__ void adc_issue(const AdcRing& R, int warp, int g,
                                          const uint8_t* codes,
                                          const uint8_t* slot_valid, int pid,
                                          int m, int C, bool copy) {
  uint64_t* bar = &R.bars[1 + warp * ADC_STAGES + g % ADC_STAGES];
  if (!copy) {
    mbar_arrive(bar);
    return;
  }
  const int mc = m * C;
  uint8_t* dst = adc_stage(R, warp, g);
  mbar_arrive_expect(bar, (uint32_t)(mc + C));
  bulk_copy_g2s(dst, codes + (size_t)pid * mc, (uint32_t)mc, bar);
  bulk_copy_g2s(dst + R.valid_off, slot_valid + (size_t)pid * C,
                (uint32_t)C, bar);
}

// lane 0 of each warp (BULK): the warp's first ADC_STAGES tiles of a chunk
// of nt probes, from their raw ids (praw(t), clamped here)
template <class Raw>
__device__ __forceinline__ void adc_prime(const AdcRing& R, int warp, int g,
                                          int nt, const uint8_t* codes,
                                          const uint8_t* slot_valid, int M,
                                          int m, int C, Raw praw) {
  for (int j = 0; j < ADC_STAGES && warp + j * ADC_WARPS < nt; ++j)
    adc_issue(R, warp, g + j, codes, slot_valid,
              min(max(praw(warp + j * ADC_WARPS), 0), M - 1), m, C, true);
}

// a probe's record: (pid clamped, table offset of its clamped codebook
// slot, whether the probe counts, 0)
__device__ __forceinline__ int4 adc_record(int raw, int M, const int* slot,
                                           int V, int m, int ksub,
                                           const uint8_t* vis, bool qp) {
  const int pid = min(max(raw, 0), M - 1);
  return make_int4(pid, min(max(slot[pid], 0), V - 1) * m * ksub,
                   vis[pid] && qp, 0);
}

// The warp's pass over a chunk of nt probes (records info[0, nt)): for its
// tiles t = warp, warp + ADC_WARPS, ..., wait on the stage (BULK), score
// every slot c and hand emit(t, c, score) each, or (BULK and QUAD: C % 16
// == 0, the staged rows word-aligned) emit4(t, c, the scores of slots c ..
// c + 3), a lane reading four codes in one word; then issue the tile
// ADC_STAGES uses ahead.  g counts the warp's ring uses (its phases).
// pq_scan_topk takes one slot a lane (QUAD false): consecutive lanes then
// write consecutive entries of its selection buffer, with no bank conflict.
template <bool BULK, bool QUAD, class Emit, class Emit4>
__device__ __forceinline__ void adc_scan_chunk(
    const AdcRing& R, const float* lut, const int4* info, int nt, int& g,
    const uint8_t* codes, const uint8_t* slot_valid, int m, int C, int ksub,
    Emit emit, Emit4 emit4) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mc = m * C;
  for (int t = warp; t < nt; t += ADC_WARPS, ++g) {   // warp-uniform
    const int4 in = info[t];
    const float* L = lut + in.y;
    const uint8_t* cd;
    const uint8_t* ok;
    if (BULK) {
      mbar_wait(&R.bars[1 + warp * ADC_STAGES + g % ADC_STAGES],
                (uint32_t)(g / ADC_STAGES) & 1u);
      cd = adc_stage(R, warp, g);
      ok = cd + R.valid_off;
    } else {
      cd = codes + (size_t)in.x * mc;
      ok = slot_valid + (size_t)in.x * C;
    }
    if (!in.z) {
      for (int c = lane; c < C; c += 32) emit(t, c, ADC_BIG);
    } else if (BULK && QUAD) {         // C % 16 == 0: four slots a lane
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(cd);
      const uint32_t* okw = reinterpret_cast<const uint32_t*>(ok);
      const int row = C / 4;           // words a code row
      for (int c4 = lane; c4 < row; c4 += 32) {
        uint32_t w = cw[c4];
        float a0 = L[w & 255u], a1 = L[(w >> 8) & 255u];
        float a2 = L[(w >> 16) & 255u], a3 = L[w >> 24];
        for (int j = 1; j < m; ++j) {
          const float* Lj = L + j * ksub;
          w = cw[j * row + c4];
          a0 += Lj[w & 255u];
          a1 += Lj[(w >> 8) & 255u];
          a2 += Lj[(w >> 16) & 255u];
          a3 += Lj[w >> 24];
        }
        const uint32_t o = okw[c4];
        emit4(t, 4 * c4, make_float4(o & 255u ? a0 : ADC_BIG,
                                     (o >> 8) & 255u ? a1 : ADC_BIG,
                                     (o >> 16) & 255u ? a2 : ADC_BIG,
                                     o >> 24 ? a3 : ADC_BIG));
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        float acc = L[cd[c]];
        for (int j = 1; j < m; ++j) acc += L[j * ksub + cd[j * C + c]];
        emit(t, c, ok[c] ? acc : ADC_BIG);
      }
    }
    if (BULK) {
      __syncwarp();                    // every lane is done with the stage
      const int n = t + ADC_STAGES * ADC_WARPS;
      if (lane == 0 && n < nt)
        adc_issue(R, warp, g + ADC_STAGES, codes, slot_valid, info[n].x, m,
                  C, info[n].z != 0);
    }
  }
}
