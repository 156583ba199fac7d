// RF -> envelope / power-Doppler R0 for Hopper (sm_90a), two launches.
//
// Replaces fused_pipeline_pallas
// (src/repro/kernels/fused_pipeline/kernel.py), which demodulates the
// whole RF block once into VMEM scratch at grid step 0 and lets its
// sequential grid of pixel tiles reuse it. CUDA blocks run in parallel
// and in no order, so that trick does not carry over. Here:
//
//   1. demod_kernel: a block stages a slab of int16 RF rows (the rows its
//      32 output samples read, for 32 (channel, frame) columns) with
//      16-byte loads, mixes each RF sample with the carrier once into
//      shared memory (rounded once, as the plain version rounds it), and
//      runs the decimating SAME FIR from there, taps ascending, writing
//      IQ (B, n_s, n_c, n_f, 2) f32 to a scratch buffer the wrapper
//      allocates: 22 MB at batch 4 and the paper's geometry, which stays
//      in the 50 MB L2.
//   2. das_head_kernel: the tiled delay-and-sum loop of das_common.cuh
//      (IQ windows staged in shared memory, zero-apodization terms
//      skipped) on that IQ, with the head's tile-local half as epilogue:
//      the envelope sqrt(re^2 + im^2) (bmode), or the wall filter along
//      frames (taps ascending) and the frame power sum (power_doppler,
//      one float per pixel), from the beamformed samples in registers
//      (warp shuffles; n_f > 32: a scratch the block writes and reads
//      back). The head's global half (normalize by max, dB, smooth) stays
//      in PyTorch outside.
//
// Bound: f32 operations, those of the DAS loop (2.15 GFLOP at batch 4),
// over 51 MB of RF + delay tables + envelope; under -fmad=false the DAS
// loop's issue rate is the floor (das_beamform.cu). What the design does
// about the rest: the previous demod re-read and re-mixed each RF sample
// for each of the ~8 outputs whose taps cover it, and the previous DAS
// loop re-read IQ rows through L2 for every (pixel, channel,
// acquisition). Two launches remain: the IQ round trip through L2 is
// about 44 MB.

#include "das_common.cuh"

enum Head { HEAD_BMODE = 0, HEAD_POWER = 1 };
// The power head for n_f past kOnePassFrames: a pass of the DAS loop per
// 32 frames into a scratch, then the filter from there. Up to one warp's
// 32 frames the one-pass head keeps every value in registers; it is its
// own kernel because the frame loop slowed the head at n_f 32 too
// (tools/das_kernel_variants.py, "power frame loop").
constexpr int HEAD_POWER_WIDE = 2;
constexpr int kOnePassFrames = das::kFrames;

// Demod tiles: kDemodCols (channel, frame) columns x up to 32 output
// samples per block; thread (column, group) makes samples group + 8 i.
// 42 KB of shared memory at the paper's geometry: five blocks per SM.
constexpr int kDemodCols = 32;
constexpr int kDemodThreads = 256;
constexpr int kDemodGroups = kDemodThreads / kDemodCols;
constexpr int kDemodMaxOut = 4;
constexpr int kDemodTile = kDemodGroups * kDemodMaxOut;
constexpr size_t kDemodSmemTarget = 100 * 1024;

// Mix rows are kDemodLd float2 apart and column cc lives at demod_col(cc):
// the 8-column stores of a half-warp (4 rows x 4 column groups) and the
// 32-column loads of a warp each hit distinct banks.
constexpr int kDemodLd = kDemodCols + 2;
__device__ __forceinline__ int demod_col(int cc) {
  return cc ^ ((cc >> 4) & (kDemodCols / 16 - 1));
}

static size_t demod_smem(int s_tile, int n_taps, int decim) {
  const size_t rows = (size_t)(s_tile - 1) * decim + n_taps;
  return rows * kDemodLd * sizeof(float2) + n_taps * sizeof(float);
}

template <int P>
__global__ void __launch_bounds__(kDemodThreads)
demod_kernel(const int16_t* __restrict__ rf,
             const float2* __restrict__ carrier,
             const float* __restrict__ lpf, float2* __restrict__ iq,
             int n_l, int n_cols, int n_s, int n_taps, int decim, int pad_lo,
             int s_tile, bool vec) {
  extern __shared__ float4 smem[];
  const int rows = (s_tile - 1) * decim + n_taps;
  float2* mix = reinterpret_cast<float2*>(smem);  // [rows][kDemodLd]
  float* taps = reinterpret_cast<float*>(mix + (size_t)rows * kDemodLd);
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kDemodCols;
  const int s0 = blockIdx.y * s_tile;
  const int l0 = s0 * decim - pad_lo;  // RF row of mix row 0
  const int16_t* rf_b = rf + (size_t)blockIdx.z * n_l * n_cols;
  for (int t = tid; t < n_taps; t += kDemodThreads) {
    taps[t] = round_operand<P>(__ldg(lpf + t));
  }
  // 8 columns of one row per thread and step: one 16-byte load
#pragma unroll 4
  for (int u = tid; u < rows * (kDemodCols / 8); u += kDemodThreads) {
    const int r = u / (kDemodCols / 8);
    const int cg = (u % (kDemodCols / 8)) * 8;
    const int l = l0 + r, col = col0 + cg;
    float x[8] = {};
    float2 car = make_float2(0.f, 0.f);  // SAME zero padding outside
    if (l >= 0 && l < n_l) {
      car = __ldg(carrier + l);
      const int16_t* src = rf_b + (size_t)l * n_cols + col;
      if (vec && col + 8 <= n_cols) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(src));
        const int16_t* h = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) x[q] = (float)h[q];
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (col + q < n_cols) x[q] = (float)__ldg(src + q);
        }
      }
    }
    float2* m = mix + (size_t)r * kDemodLd;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      m[demod_col(cg + q)] = make_float2(round_operand<P>(x[q] * car.x),
                                         round_operand<P>(x[q] * car.y));
    }
  }
  __syncthreads();
  const int cc = tid % kDemodCols, grp = tid / kDemodCols;
  const int n_out = s_tile / kDemodGroups;
  const float2* m = mix + (size_t)grp * decim * kDemodLd + demod_col(cc);
  // outputs past n_out (a reduced s_tile) repeat the last one, unstored
  int row[kDemodMaxOut];
  float2 acc[kDemodMaxOut];
#pragma unroll
  for (int i = 0; i < kDemodMaxOut; ++i) {
    row[i] = min(i, n_out - 1) * kDemodGroups * decim * kDemodLd;
    acc[i] = make_float2(0.f, 0.f);
  }
  for (int t = 0; t < n_taps; ++t) {  // ascending taps
    const float h = taps[t];
    const float2* mt = m + t * kDemodLd;
#pragma unroll
    for (int i = 0; i < kDemodMaxOut; ++i) {
      const float2 v = mt[row[i]];
      acc[i].x = acc[i].x + h * v.x;
      acc[i].y = acc[i].y + h * v.y;
    }
  }
  const int col = col0 + cc;
  if (col >= n_cols) return;
#pragma unroll
  for (int i = 0; i < kDemodMaxOut; ++i) {
    const int s = s0 + grp + i * kDemodGroups;
    if (i < n_out && s < n_s) {
      iq[((size_t)blockIdx.z * n_s + s) * n_cols + col] = acc[i];
    }
  }
}

// The wall filter and frame power of one pixel's n_f samples in each of
// N acquisitions, held one frame per lane (n_f <= 32): r0[j] in every lane.
// The acquisitions go together, tap by tap, so that their shuffles overlap.
template <int N>
__device__ __forceinline__ void wall_power_lanes(
    const float2 (&z)[N], const float* __restrict__ wall, int n_wall,
    int n_fp, float (&r0)[N]) {
  const int lane = threadIdx.x & 31;
  float zr[N], zi[N];
#pragma unroll
  for (int j = 0; j < N; ++j) zr[j] = zi[j] = 0.0f;
  for (int t = 0; t < n_wall; ++t) {  // ascending taps
    const float w = __ldg(wall + t);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float x = __shfl_down_sync(0xffffffffu, z[j].x, t);
      const float y = __shfl_down_sync(0xffffffffu, z[j].y, t);
      zr[j] = zr[j] + w * x;
      zi[j] = zi[j] + w * y;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    r0[j] = lane < n_fp ? zr[j] * zr[j] + zi[j] * zi[j] : 0.0f;
  }
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      r0[j] += __shfl_xor_sync(0xffffffffu, r0[j], off);
    }
  }
}

// The same from a pixel's n_f samples in global memory (n_f > 32).
__device__ __forceinline__ float wall_power_rows(
    const float2* z, const float* __restrict__ wall, int n_wall, int n_fp) {
  float part = 0.0f;
  for (int g = threadIdx.x & 31; g < n_fp; g += 32) {
    float zr = 0.0f;
    float zi = 0.0f;
    for (int t = 0; t < n_wall; ++t) {  // ascending taps
      const float w = __ldg(wall + t);
      zr = zr + w * z[g + t].x;
      zi = zi + w * z[g + t].y;
    }
    part = part + (zr * zr + zi * zi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, off);
  }
  return part;
}

template <int P, int BP, int H>
__global__ void __launch_bounds__(das::kThreads, 2)
das_head_kernel(das::Args a, const float* __restrict__ wall,
                float* __restrict__ out, float2* bf, int batch, int n_wall) {
  extern __shared__ float4 smem[];
  constexpr int kPpw = das::Tile<BP>::kPpw, kBb = das::Tile<BP>::kBb;
  const das::Smem s = das::carve(smem, a.n_c);
  const int lane = threadIdx.x & 31;
  const das::Block blk = das::block_of(a.n_sm);
  const int p0 = blk.tile * BP;
  const int b0 = blk.acq * kBb;
  const int nb = min(kBb, batch - b0);
  das::plan_tile<BP>(a, s, p0, nb);
  das::Acc<BP> acc;
  if constexpr (H == HEAD_BMODE) {
    const int f0 = blk.frames * das::kFrames;
    das::accumulate<P, BP>(a, s, p0, b0, nb, f0, acc);
    if (f0 + lane >= a.n_f) return;
#pragma unroll
    for (int pp = 0; pp < kPpw; ++pp) {
      const int p = p0 + das::tile_pixel(pp);
      if (p >= a.n_pix) break;
#pragma unroll
      for (int j = 0; j < kBb; ++j) {
        if (j >= nb) break;
        const float2 z = acc[pp][j];
        out[((size_t)(b0 + j) * a.n_pix + p) * a.n_f + f0 + lane] =
            sqrtf(z.x * z.x + z.y * z.y);
      }
    }
  } else if constexpr (H == HEAD_POWER) {  // n_f <= 32: filter across lanes
    das::accumulate<P, BP>(a, s, p0, b0, nb, 0, acc);
#pragma unroll
    for (int pp = 0; pp < kPpw; ++pp) {
      const int p = p0 + das::tile_pixel(pp);  // warp-uniform
      if (p >= a.n_pix) break;
      float r0[kBb];
      wall_power_lanes(acc[pp], wall, n_wall, a.n_f - n_wall + 1, r0);
#pragma unroll
      for (int j = 0; j < kBb; ++j) {
        if (j < nb && lane == 0) out[(size_t)(b0 + j) * a.n_pix + p] = r0[j];
      }
    }
  } else {  // a pass per 32 frames into bf, then the filter from there
    for (int f0 = 0; f0 < a.n_f; f0 += das::kFrames) {
      das::accumulate<P, BP>(a, s, p0, b0, nb, f0, acc);
      if (f0 + lane >= a.n_f) continue;
#pragma unroll
      for (int pp = 0; pp < kPpw; ++pp) {
        const int p = p0 + das::tile_pixel(pp);
        if (p >= a.n_pix) break;
#pragma unroll
        for (int j = 0; j < kBb; ++j) {
          if (j >= nb) break;
          bf[((size_t)(b0 + j) * a.n_pix + p) * a.n_f + f0 + lane] =
              acc[pp][j];
        }
      }
    }
    __syncthreads();  // the block's bf rows are written
#pragma unroll
    for (int pp = 0; pp < kPpw; ++pp) {
      const int p = p0 + das::tile_pixel(pp);
      if (p >= a.n_pix) break;
#pragma unroll
      for (int j = 0; j < kBb; ++j) {
        if (j >= nb) break;
        const size_t row = (size_t)(b0 + j) * a.n_pix + p;
        const float r0 = wall_power_rows(bf + row * a.n_f, wall, n_wall,
                                         a.n_f - n_wall + 1);
        if (lane == 0) out[row] = r0;
      }
    }
  }
}

struct FusedArgs {
  const int16_t* rf;
  const float2* carrier;
  const float* lpf;
  const float* wall;
  float2* iq;
  float2* bf;
  float* out;
  int batch, n_l, n_taps, decim, pad_lo, n_wall, head;
};

template <int P>
static cudaError_t launch_demod(const FusedArgs& f, const das::Args& a,
                                cudaStream_t s) {
  int s_tile = kDemodTile;
  while (s_tile > kDemodGroups &&
         demod_smem(s_tile, f.n_taps, f.decim) > kDemodSmemTarget) {
    s_tile -= kDemodGroups;
  }
  const size_t smem = demod_smem(s_tile, f.n_taps, f.decim);
  cudaError_t err = cudaFuncSetAttribute(
      demod_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_cols = a.n_c * a.n_f;
  const bool vec = n_cols % 8 == 0 && (uintptr_t)f.rf % 16 == 0;
  const dim3 grid((n_cols + kDemodCols - 1) / kDemodCols,
                  (a.n_s + s_tile - 1) / s_tile, f.batch);
  demod_kernel<P><<<grid, kDemodThreads, smem, s>>>(
      f.rf, f.carrier, f.lpf, f.iq, f.n_l, n_cols, a.n_s, f.n_taps, f.decim,
      f.pad_lo, s_tile, vec);
  return cudaGetLastError();
}

template <int P, int BP, int H>
static cudaError_t launch_head(const FusedArgs& f, const das::Args& a,
                               cudaStream_t s) {
  const size_t smem = das::smem_bytes(a.n_c);
  cudaError_t err = cudaFuncSetAttribute(
      das_head_kernel<P, BP, H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // B-mode: a block per 32 frames; power: one block walks all frames
  const int frame_chunks =
      H == HEAD_BMODE ? (a.n_f + das::kFrames - 1) / das::kFrames : 1;
  das_head_kernel<P, BP, H>
      <<<das::grid<BP>(a.n_pix, f.batch, frame_chunks), das::kThreads, smem,
         s>>>(a, f.wall, f.out, f.bf, f.batch, f.n_wall);
  return cudaGetLastError();
}

template <int P, int BP>
static cudaError_t launch(const FusedArgs& f, const das::Args& a,
                          cudaStream_t s) {
  cudaError_t err = launch_demod<P>(f, a, s);
  if (err != cudaSuccess) return err;
  if (f.head == HEAD_BMODE) return launch_head<P, BP, HEAD_BMODE>(f, a, s);
  return a.n_f <= kOnePassFrames
             ? launch_head<P, BP, HEAD_POWER>(f, a, s)
             : launch_head<P, BP, HEAD_POWER_WIDE>(f, a, s);
}

template <int P>
static cudaError_t launch_bp(const FusedArgs& f, const das::Args& a, int bp,
                             cudaStream_t s) {
  switch (bp) {
    case 64: return launch<P, 64>(f, a, s);
    case 128: return launch<P, 128>(f, a, s);
    case 256: return launch<P, 256>(f, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Floats of the scratch bf (B, n_pix, n_f, 2) that the power head needs
// at n_f frames: 0 where the one-pass head runs.
extern "C" long long fused_power_scratch_floats(int batch, int n_pix,
                                                int n_f) {
  return n_f <= kOnePassFrames ? 0 : 2LL * batch * n_pix * n_f;
}

extern "C" int fused_pipeline_launch(
    const void* rf, const void* carrier, const void* lpf, const void* idx,
    const void* frac, const void* apod, const void* rot, const void* wall,
    void* iq, void* bf, void* out, int batch, int n_l, int n_c, int n_f,
    int n_s, int n_taps, int decim, int pad_lo, int n_pix, int n_wall,
    int head, int bp, int precision, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (head != HEAD_BMODE && head != HEAD_POWER) {
    return (int)cudaErrorInvalidValue;
  }
  const FusedArgs f{(const int16_t*)rf, (const float2*)carrier,
                    (const float*)lpf,  (const float*)wall,
                    (float2*)iq,        (float2*)bf,
                    (float*)out,        batch,
                    n_l,                n_taps,
                    decim,              pad_lo,
                    n_wall,             head};
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const das::Args a{(const int*)idx,    (const float*)frac,
                    (const float*)apod, (const float2*)rot,
                    (const float2*)iq,  n_pix, n_c, n_s, n_f, n_sm};
  cudaStream_t s = (cudaStream_t)stream;
  switch (precision) {
    case PREC_F32: return (int)launch_bp<PREC_F32>(f, a, bp, s);
    case PREC_BF16: return (int)launch_bp<PREC_BF16>(f, a, bp, s);
    case PREC_F16: return (int)launch_bp<PREC_F16>(f, a, bp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
