// Split-precision TF32 tensor-core products (3xTF32) and cp.async helpers
// for flash_attention.cu, ssd_scan.cu and bsr_spmm.cu (sm_90a).
//
// A TF32 operand keeps 10 of f32's 23 mantissa bits. Each f32 operand is
// split as hi = tf32(a), lo = tf32(a - hi), and a product is accumulated
// in f32 as lo_a hi_b + hi_a lo_b + hi_a hi_b (the small terms first).
// The dropped lo_a lo_b term and the rounding of lo leave a relative error
// near 2^-21 per product: f32-level, where one TF32 pass gives 2^-11.
//
// mma.sync.aligned.m16n8k8 fragment layouts (PTX ISA), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4);
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g);
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1).
#pragma once

#include <cstdint>

namespace tf32 {

// x rounded to TF32, to nearest with ties away from zero: the result of
// cvt.rna.tf32.f32 for finite x below the largest TF32 value. Half an ulp
// is added to the magnitude bits and the 13 low bits are cleared: two
// integer operations, which keep the splitting off the conversion unit.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An f32 operand as (hi, lo) TF32 parts.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  Split s;
  s.hi = to_tf32(x);
  s.lo = to_tf32(x - __uint_as_float(s.hi));
  return s;
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  // not volatile: the product has no side effect, so the compiler may
  // interleave the independent products of a tile
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32; a[4] and b[2] are the fragments' f32 values, split.
struct FragA {
  Split v[4];
};
struct FragB {
  Split v[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  f.v[0] = split(a0);
  f.v[1] = split(a1);
  f.v[2] = split(a2);
  f.v[3] = split(a3);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  f.v[0] = split(b0);
  f.v[1] = split(b1);
  return f;
}

__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, b.v[0].hi, b.v[1].hi);
  mma(d, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].lo, b.v[1].lo);
  mma(d, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].hi, b.v[1].hi);
}

// d += A B in 3xTF32, the product summed from zero and then added to d in
// f32, rounded to nearest. The tensor cores truncate as they add into an
// accumulator, so a long sum held in one accumulator drifts further from
// the exact one than the plain f32 version does; step by step it does not.
__device__ __forceinline__ void mma3_add(float (&d)[4], const FragA& a,
                                         const FragB& b) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3(p, a, b);
#pragma unroll
  for (int c = 0; c < 4; ++c) d[c] += p[c];
}

// Asynchronous global -> shared copies; `valid` false writes zeros (the
// source is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32
