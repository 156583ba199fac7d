// Delay-and-sum beamform for Hopper (sm_90a).
//
// Replaces das_beamform_pallas (src/repro/kernels/das_beamform/kernel.py),
// which builds a one-hot (pixels x samples) weight tile per channel in
// VMEM and contracts it with IQ on the TPU's matrix unit. On Hopper the
// gather is a real gather, run by the tiled loop of das_common.cuh: one
// launch, a thread block per (tile of bp pixels, chunk of acquisitions,
// 32 frames), each channel group's IQ windows and table entries staged in
// shared memory with cp.async in a ring of three buffers, runs of
// zero-apodization pixels skipped.
//
// Bound: f32 operations. At batch 4 and the paper's geometry the function
// must move 60 MB (21 MB of delay tables, 4 x 5.5 MB of IQ, 4 x 4.2 MB of
// result: 18 us at 3.35 TB/s) and do 16 operations per acquisition, pixel,
// channel and frame: 2.15 GFLOP (32 us at 67 TFLOP/s), 1.35 GFLOP over
// the 63 % of (pixel, channel) pairs with non-zero apodization (20 us).
// Under -fmad=false none of the 16 fuses: one f32 instruction each, 40 us
// over the needed terms, and a term also issues two shared-memory loads
// and its addresses. What the design does about it: the previous design
// read two 256-byte IQ rows through L2 for every (pixel, channel,
// acquisition), about 2 GB; here each tile stages its channels' windows
// once (71 MB at bp 64, 16-byte copies), each table entry is read once per
// batch, and the zero terms are skipped in runs of two pixels, which keeps
// the loop over acquisitions free of branches.
//
// Shapes: idx (n_pix, n_c) int32; frac, apod (n_pix, n_c) f32;
// rot (n_pix, n_c, 2) f32; iq (B, n_s, n_c, n_f, 2) f32;
// out (B, n_pix, n_f, 2) f32. All contiguous.

#include "das_common.cuh"

// The pixel tile. 64 measured fastest of the tiles the loop takes (64,
// 128, 256: tools/das_kernel_variants.py builds the others).
constexpr int kBp = 64;

template <int P>
__global__ void __launch_bounds__(das::kThreads, 2)
das_beamform_kernel(das::Args a, float2* __restrict__ out, int batch) {
  constexpr int BP = kBp;
  extern __shared__ float4 smem[];
  const das::Smem s = das::carve(smem, a.n_c);
  const das::Block blk = das::block_of(a.n_sm);
  const int p0 = blk.tile * BP;
  const int b0 = blk.acq * das::Tile<BP>::kBb;
  const int nb = min(das::Tile<BP>::kBb, batch - b0);
  const int f0 = blk.frames * das::kFrames;
  das::plan_tile<BP>(a, s, p0, nb);
  das::Acc<BP> acc;
  das::accumulate<P, BP>(a, s, p0, b0, nb, f0, acc);
  const int lane = threadIdx.x & 31;
  if (f0 + lane >= a.n_f) return;
#pragma unroll
  for (int pp = 0; pp < das::Tile<BP>::kPpw; ++pp) {
    const int p = p0 + das::tile_pixel(pp);
    if (p >= a.n_pix) break;
#pragma unroll
    for (int j = 0; j < das::Tile<BP>::kBb; ++j) {
      if (j >= nb) break;
      out[((size_t)(b0 + j) * a.n_pix + p) * a.n_f + f0 + lane] = acc[pp][j];
    }
  }
}

template <int P>
static cudaError_t launch(const das::Args& a, float2* out, int batch,
                          cudaStream_t s) {
  const size_t smem = das::smem_bytes(a.n_c);
  cudaError_t err = cudaFuncSetAttribute(
      das_beamform_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int frame_chunks = (a.n_f + das::kFrames - 1) / das::kFrames;
  das_beamform_kernel<P>
      <<<das::grid<kBp>(a.n_pix, batch, frame_chunks), das::kThreads, smem,
         s>>>(a, out, batch);
  return cudaGetLastError();
}

// The tile this library is built for, for counts made outside it
// (chip_smoke.py's IQ bytes staged): pixels per tile, acquisitions per
// block, IQ rows per stage buffer.
extern "C" void das_tile_plan(int* bp, int* block_acqs, int* stage_rows) {
  *bp = kBp;
  *block_acqs = das::Tile<kBp>::kBb;
  *stage_rows = das::kStageRows;
}

extern "C" int das_beamform_launch(const void* idx, const void* frac,
                                   const void* apod, const void* rot,
                                   const void* iq, void* out, int batch,
                                   int n_pix, int n_c, int n_s, int n_f,
                                   int precision, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const das::Args a{(const int*)idx,    (const float*)frac,
                    (const float*)apod, (const float2*)rot,
                    (const float2*)iq,  n_pix, n_c, n_s, n_f, n_sm};
  float2* y = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (precision) {
    case PREC_F32: return (int)launch<PREC_F32>(a, y, batch, s);
    case PREC_BF16: return (int)launch<PREC_BF16>(a, y, batch, s);
    case PREC_F16: return (int)launch<PREC_F16>(a, y, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
