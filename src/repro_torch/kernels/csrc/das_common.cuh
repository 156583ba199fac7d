// Delay-and-sum accumulation shared by das_beamform.cu and
// fused_pipeline.cu; bsr_spmm.cu takes the precision codes and operand
// rounding from here too.
//
// One warp owns one pixel; lane f owns frame f (frames past 32 loop in
// strides of 32). Per channel, every lane reads the same table entry
// (a broadcast load) and its own two IQ samples: rows iq[idx, c, :] and
// iq[idx + 1, c, :] are n_f contiguous float2 values, so a warp's reads
// coalesce. Channels are summed in ascending order in f32 registers.
//
// The arithmetic repeats the plain version's expression order (lerp,
// rotate, apodize, add) and the build passes -fmad=false, so each
// per-channel term rounds exactly as in the plain PyTorch version; only
// the order of the channel sum differs from torch's reduction.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum Precision { PREC_F32 = 0, PREC_BF16 = 1, PREC_F16 = 2 };

// Round an f32 operand to the requested precision and back (identity
// at f32): reduced precision casts operands, never the accumulation.
template <int P>
__device__ __forceinline__ float round_operand(float x) {
  if constexpr (P == PREC_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (P == PREC_F16) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

// sum_c apod * rot * lerp(iq[:, c, f]) for pixel p, frame f of one
// acquisition. Tables are (n_pix, n_c) (rot: float2); iq_b is
// (n_s, n_c, n_f) float2.
template <int P>
__device__ __forceinline__ float2 das_pixel_frame(
    const int* __restrict__ idx, const float* __restrict__ frac,
    const float* __restrict__ apod, const float2* __restrict__ rot,
    const float2* __restrict__ iq_b, int p, int f, int n_c, int n_f) {
  const size_t row = (size_t)p * n_c;
  float acc_re = 0.0f;
  float acc_im = 0.0f;
#pragma unroll 4
  for (int c = 0; c < n_c; ++c) {
    const int i0 = __ldg(idx + row + c);
    const float fr = __ldg(frac + row + c);
    const float a = __ldg(apod + row + c);
    const float2 r = __ldg(rot + row + c);
    const float2 s0 = __ldg(iq_b + ((size_t)i0 * n_c + c) * n_f + f);
    const float2 s1 = __ldg(iq_b + ((size_t)(i0 + 1) * n_c + c) * n_f + f);
    const float w0 = round_operand<P>(1.0f - fr);
    const float w1 = round_operand<P>(fr);
    const float vr = round_operand<P>(s0.x) * w0 + round_operand<P>(s1.x) * w1;
    const float vi = round_operand<P>(s0.y) * w0 + round_operand<P>(s1.y) * w1;
    const float re = vr * r.x - vi * r.y;
    const float im = vr * r.y + vi * r.x;
    acc_re = acc_re + re * a;
    acc_im = acc_im + im * a;
  }
  return make_float2(acc_re, acc_im);
}

// Pixels (warps) per block of the DAS kernels.
constexpr int kDasWarps = 8;
