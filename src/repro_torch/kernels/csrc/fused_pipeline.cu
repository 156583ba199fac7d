// RF -> envelope / power-Doppler R0 for Hopper (sm_90a), two launches.
//
// Replaces fused_pipeline_pallas
// (src/repro/kernels/fused_pipeline/kernel.py), which demodulates the
// whole RF block once into VMEM scratch at grid step 0 and lets its
// sequential grid of pixel tiles reuse it. CUDA blocks run in parallel
// and in no order, so that trick does not carry over. Here:
//
//   1. demod_kernel reads int16 RF directly (exact, half the bytes of an
//      f32 copy), mixes with the carrier and runs the decimating SAME FIR
//      with taps in ascending order, writing IQ (B, n_s, n_c, n_f, 2) f32
//      to a scratch buffer the wrapper allocates. At batch 4 and the
//      paper's geometry that is 22 MB, which stays in the 50 MB L2.
//   2. das_head_kernel runs the das_beamform loop (das_common.cuh) on
//      that IQ with the head's tile-local half as epilogue: the envelope
//      sqrt(re^2 + im^2) (bmode), or the wall filter along frames (taps
//      ascending) and the frame power sum (power_doppler, one float per
//      pixel). The head's global half (normalize by max, dB, smooth)
//      stays in PyTorch outside.
//
// Bound: f32 operations (the DAS arithmetic, 2.15 GFLOP at batch 4, over
// 51 MB of RF + delay tables + envelope). The IQ round trip through L2
// and the per-pixel IQ re-reads are what this design adds over it.

#include "das_common.cuh"

enum Head { HEAD_BMODE = 0, HEAD_POWER = 1 };

template <int P>
__global__ void demod_kernel(const int16_t* __restrict__ rf,
                             const float2* __restrict__ carrier,
                             const float* __restrict__ lpf,
                             float2* __restrict__ iq, int batch, int n_l,
                             int n_c, int n_f, int n_s, int n_taps, int decim,
                             int pad_lo) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)batch * n_s * n_c * n_f;
  if (i >= total) return;
  const int f = (int)(i % n_f);
  size_t r = i / n_f;
  const int c = (int)(r % n_c);
  r /= n_c;
  const int s = (int)(r % n_s);
  const int b = (int)(r / n_s);
  const int16_t* rf_b = rf + (size_t)b * n_l * n_c * n_f;
  float acc_re = 0.0f;
  float acc_im = 0.0f;
  for (int t = 0; t < n_taps; ++t) {
    const int l = s * decim + t - pad_lo;
    float m_re = 0.0f;  // SAME zero padding outside [0, n_l)
    float m_im = 0.0f;
    if (l >= 0 && l < n_l) {
      const float x = (float)rf_b[((size_t)l * n_c + c) * n_f + f];
      const float2 car = __ldg(carrier + l);
      m_re = x * car.x;
      m_im = x * car.y;
    }
    const float h = round_operand<P>(__ldg(lpf + t));
    acc_re = acc_re + h * round_operand<P>(m_re);
    acc_im = acc_im + h * round_operand<P>(m_im);
  }
  iq[i] = make_float2(acc_re, acc_im);
}

template <int P, int H>
__global__ void __launch_bounds__(kDasWarps * 32)
das_head_kernel(const int* __restrict__ idx, const float* __restrict__ frac,
                const float* __restrict__ apod,
                const float2* __restrict__ rot,
                const float2* __restrict__ iq,
                const float* __restrict__ wall, float* __restrict__ out,
                int batch, int n_pix, int n_c, int n_s, int n_f,
                int n_wall) {
  // Power head: each warp keeps its pixel's n_f beamformed samples here
  // so the wall filter can read neighbouring frames.
  extern __shared__ float2 bf_smem[];
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kDasWarps + warp;
  const int lane = threadIdx.x & 31;
  if (p >= n_pix) return;  // warp-uniform: the ragged last block
  float2* bf = bf_smem + (size_t)warp * n_f;
  const int n_fp = n_f - n_wall + 1;
  for (int b = 0; b < batch; ++b) {
    const float2* iq_b = iq + (size_t)b * n_s * n_c * n_f;
    if constexpr (H == HEAD_BMODE) {
      float* out_p = out + ((size_t)b * n_pix + p) * n_f;
      for (int f = lane; f < n_f; f += 32) {
        const float2 z =
            das_pixel_frame<P>(idx, frac, apod, rot, iq_b, p, f, n_c, n_f);
        out_p[f] = sqrtf(z.x * z.x + z.y * z.y);
      }
    } else {
      for (int f = lane; f < n_f; f += 32) {
        bf[f] = das_pixel_frame<P>(idx, frac, apod, rot, iq_b, p, f, n_c,
                                   n_f);
      }
      __syncwarp();
      float part = 0.0f;
      for (int g = lane; g < n_fp; g += 32) {
        float zr = 0.0f;
        float zi = 0.0f;
        for (int t = 0; t < n_wall; ++t) {  // ascending taps
          const float w = __ldg(wall + t);
          zr = zr + w * bf[g + t].x;
          zi = zi + w * bf[g + t].y;
        }
        part = part + (zr * zr + zi * zi);
      }
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (lane == 0) out[(size_t)b * n_pix + p] = part;
      __syncwarp();  // bf is rewritten by the next acquisition
    }
  }
}

template <int P>
static cudaError_t launch(const int16_t* rf, const float2* carrier,
                          const float* lpf, const int* idx, const float* frac,
                          const float* apod, const float2* rot,
                          const float* wall, float2* iq, float* out,
                          int batch, int n_l, int n_c, int n_f, int n_s,
                          int n_taps, int decim, int pad_lo, int n_pix,
                          int n_wall, int head, cudaStream_t s) {
  const size_t total = (size_t)batch * n_s * n_c * n_f;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  demod_kernel<P><<<blocks, threads, 0, s>>>(rf, carrier, lpf, iq, batch,
                                             n_l, n_c, n_f, n_s, n_taps,
                                             decim, pad_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((n_pix + kDasWarps - 1) / kDasWarps);
  const dim3 block(kDasWarps * 32);
  if (head == HEAD_BMODE) {
    das_head_kernel<P, HEAD_BMODE><<<grid, block, 0, s>>>(
        idx, frac, apod, rot, iq, wall, out, batch, n_pix, n_c, n_s, n_f,
        n_wall);
  } else {
    const size_t smem = (size_t)kDasWarps * n_f * sizeof(float2);
    das_head_kernel<P, HEAD_POWER><<<grid, block, smem, s>>>(
        idx, frac, apod, rot, iq, wall, out, batch, n_pix, n_c, n_s, n_f,
        n_wall);
  }
  return cudaGetLastError();
}

extern "C" int fused_pipeline_launch(
    const void* rf, const void* carrier, const void* lpf, const void* idx,
    const void* frac, const void* apod, const void* rot, const void* wall,
    void* iq, void* out, int batch, int n_l, int n_c, int n_f, int n_s,
    int n_taps, int decim, int pad_lo, int n_pix, int n_wall, int head,
    int precision, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (head != HEAD_BMODE && head != HEAD_POWER) {
    return (int)cudaErrorInvalidValue;
  }
  const int16_t* x = (const int16_t*)rf;
  const float2* car = (const float2*)carrier;
  const float* h = (const float*)lpf;
  const int* i = (const int*)idx;
  const float* fr = (const float*)frac;
  const float* ap = (const float*)apod;
  const float2* ro = (const float2*)rot;
  const float* w = (const float*)wall;
  float2* q = (float2*)iq;
  float* y = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (precision) {
    case PREC_F32:
      err = launch<PREC_F32>(x, car, h, i, fr, ap, ro, w, q, y, batch, n_l,
                             n_c, n_f, n_s, n_taps, decim, pad_lo, n_pix,
                             n_wall, head, s);
      break;
    case PREC_BF16:
      err = launch<PREC_BF16>(x, car, h, i, fr, ap, ro, w, q, y, batch, n_l,
                              n_c, n_f, n_s, n_taps, decim, pad_lo, n_pix,
                              n_wall, head, s);
      break;
    case PREC_F16:
      err = launch<PREC_F16>(x, car, h, i, fr, ap, ro, w, q, y, batch, n_l,
                             n_c, n_f, n_s, n_taps, decim, pad_lo, n_pix,
                             n_wall, head, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
