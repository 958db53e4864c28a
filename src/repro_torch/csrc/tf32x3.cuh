// fp32 products on Hopper's TF32 tensor cores (3xTF32), and the cp.async
// copies that stage their operands; shared by masked_score.cu and
// flash_attention.cu.
//
// 3xTF32: each fp32 operand a splits into hi = tf32_rna(a) and lo =
// tf32_rna(a - hi), and a.b is taken as lo.hi + hi.lo + hi.hi (the small
// products first).  a = hi + lo + r with |r| <= 2^-22 |a|, and the dropped
// lo.lo is below 2^-22 |a||b|, so each product carries a relative error of
// about 3 * 2^-22 (fp32's own is 2^-24) before the fp32 accumulation; an
// integer below 2^11 splits into itself and 0, so its products are exact.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// hi = tf32_rna(v), lo = tf32_rna(v - hi), rounded as cvt.rna.tf32.f32
// rounds a finite value (to nearest, ties away from zero: add half a TF32
// ulp to the magnitude's bits, drop the 13 low bits), with integer and
// logic operations: on the H100, cvt issues at a quarter of the ALU rate
// and set the pace of both kernels that split every operand they load.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// acc (16x8 fp32) += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float* acc, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
