// Delay-and-sum beamform for Hopper (sm_90a).
//
// Replaces das_beamform_pallas (src/repro/kernels/das_beamform/kernel.py),
// which builds a one-hot (pixels x samples) weight tile per channel in
// VMEM and contracts it with IQ on the TPU's matrix unit. On Hopper the
// gather is a real gather: one warp per pixel, lane = frame, a loop over
// channels (das_common.cuh), and a loop over the acquisitions of the
// batch so a pixel's delay-table row is read from device memory once
// per batch and from L1 for the other acquisitions.
//
// Bound: f32 operations, barely. At batch 4 and the paper's geometry the
// function must move 60 MB (21 MB of delay tables, 4 x 5.5 MB of IQ,
// 4 x 4.2 MB of result: 18 us at 3.35 TB/s) and do 2.15 GFLOP (16 per
// acquisition, pixel, channel and frame: 32 us at 67 TFLOP/s). This
// first design leaves the IQ re-reads (two 256-byte rows per pixel,
// channel and acquisition, about 2 GB of L2 reads) to L2 instead of
// staging a channel's IQ column in shared memory; that is the next step.
//
// Shapes: idx (n_pix, n_c) int32; frac, apod (n_pix, n_c) f32;
// rot (n_pix, n_c, 2) f32; iq (B, n_s, n_c, n_f, 2) f32;
// out (B, n_pix, n_f, 2) f32. All contiguous.

#include "das_common.cuh"

template <int P>
__global__ void __launch_bounds__(kDasWarps * 32)
das_beamform_kernel(const int* __restrict__ idx,
                    const float* __restrict__ frac,
                    const float* __restrict__ apod,
                    const float2* __restrict__ rot,
                    const float2* __restrict__ iq, float2* __restrict__ out,
                    int batch, int n_pix, int n_c, int n_s, int n_f) {
  const int p = blockIdx.x * kDasWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= n_pix) return;  // warp-uniform: the ragged last block
  for (int b = 0; b < batch; ++b) {
    const float2* iq_b = iq + (size_t)b * n_s * n_c * n_f;
    float2* out_p = out + ((size_t)b * n_pix + p) * n_f;
    for (int f = lane; f < n_f; f += 32) {
      out_p[f] = das_pixel_frame<P>(idx, frac, apod, rot, iq_b, p, f, n_c,
                                    n_f);
    }
  }
}

extern "C" int das_beamform_launch(const void* idx, const void* frac,
                                   const void* apod, const void* rot,
                                   const void* iq, void* out, int batch,
                                   int n_pix, int n_c, int n_s, int n_f,
                                   int precision, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_pix + kDasWarps - 1) / kDasWarps);
  const dim3 block(kDasWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const int* i = (const int*)idx;
  const float* fr = (const float*)frac;
  const float* ap = (const float*)apod;
  const float2* ro = (const float2*)rot;
  const float2* x = (const float2*)iq;
  float2* y = (float2*)out;
  switch (precision) {
    case PREC_F32:
      das_beamform_kernel<PREC_F32><<<grid, block, 0, s>>>(
          i, fr, ap, ro, x, y, batch, n_pix, n_c, n_s, n_f);
      break;
    case PREC_BF16:
      das_beamform_kernel<PREC_BF16><<<grid, block, 0, s>>>(
          i, fr, ap, ro, x, y, batch, n_pix, n_c, n_s, n_f);
      break;
    case PREC_F16:
      das_beamform_kernel<PREC_F16><<<grid, block, 0, s>>>(
          i, fr, ap, ro, x, y, batch, n_pix, n_c, n_s, n_f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
