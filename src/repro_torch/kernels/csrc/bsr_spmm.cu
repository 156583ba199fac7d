// Block-sparse (BSR) products for Hopper (sm_90a): the sparse variant's
// beamform.
//
// Replaces bsr_spmm_pallas (src/repro/kernels/bsr_spmm/kernel.py). The
// TPU kernel walks a (pixel block, K) grid with K sequential on one core,
// one dense (bp x bs) @ (bs x nf) MXU product per step, accumulated in the
// output tile; the reference's bsr_beamform (ops.py) vmaps it over the
// channels, four real SpMMs each, and sums the channels afterwards.
//
// Two entries share one kernel template:
//   bsr_spmm_launch     — the real primitive with the TPU kernel's
//                         signature, (cols, blocks, x) -> y;
//   bsr_beamform_launch — the complex multi-channel beamform in ONE
//                         launch; the per-channel partial results are
//                         never written (at batch 4 and the paper's
//                         geometry they would be 1.07 GB).
// A thread block owns a tile of up to 64 rows of one pixel block and 32
// output columns (acquisition x frame). Its sums live in registers: each
// thread holds 4 rows x 2 columns. It walks the channels, then the K
// stored blocks, in ascending order; per step it stages the operator
// block and the block's IQ rows in shared memory (rounded to bf16/f16
// there when asked: the operands are rounded, the sums stay f32) and
// takes the product over s in ascending order. Each block loads its own
// `cols` entry: there is no scalar prefetch.
//
// Bound: f32 operations. At batch 4 and the paper's geometry (bp = bs =
// 64, K = 2, n_c = 64, n_pb = 256, n_f = 32) the stored blocks take
// 8 * B * n_c * n_pb * K * bp * bs * n_f = 137 GFLOP, 2.05 ms at
// 67 TFLOP/s, against 1.1 GB of operator, IQ and output, 0.33 ms at
// 3.35 TB/s. The column tiles of one pixel block are neighbours on the
// grid, so an operator block is read from HBM about once and from L2 by
// the other tiles. Sums use explicit fmaf (the build's -fmad=false keeps
// the DAS kernels' products unfused; here one rounding per multiply-add
// stays within the plain version's tolerance at half the instructions).
// Later: tensor cores (wgmma) at bf16/f16, skipping the all-zero padded
// K slots, double-buffered staging.
//
// Shapes (all contiguous):
//   beamform: cols (n_c, n_pb, K) int32; blocks (n_c, n_pb, K, bp, bs)
//             float2; iq (B, n_sb, bs, n_c, n_f) float2;
//             out (B, n_pb * bp, n_f) float2.
//   spmm:     the same with B = n_c = 1 and float values.

#include "das_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;   // rows of a pixel block per thread block
constexpr int kTileCols = 32;   // output columns per thread block
constexpr int kColGroups = kTileCols / 2;           // 2 columns a thread
constexpr int kRowGroups = kThreads / kColGroups;   // 16
constexpr int kRowsPerThread = kTileRows / kRowGroups;  // 4, strided by 16
constexpr size_t kMaxShared = 232448;  // the most a block may use (H100)

template <int P>
__device__ __forceinline__ float rounded(float v) {
  return round_operand<P>(v);
}

template <int P>
__device__ __forceinline__ float2 rounded(float2 v) {
  return make_float2(round_operand<P>(v.x), round_operand<P>(v.y));
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ void mac(float& acc, float a, float x) {
  acc = fmaf(a, x, acc);
}

// acc += a * x, complex
__device__ __forceinline__ void mac(float2& acc, float2 a, float2 x) {
  acc.x = fmaf(a.x, x.x, acc.x);
  acc.x = fmaf(-a.y, x.y, acc.x);
  acc.y = fmaf(a.x, x.y, acc.y);
  acc.y = fmaf(a.y, x.x, acc.y);
}

template <typename V>
size_t shared_bytes(int bs) {
  // operator tile, rows padded by one element against bank conflicts,
  // then the IQ tile
  return ((size_t)kTileRows * (bs + 1) + (size_t)bs * kTileCols) * sizeof(V);
}

// grid: (column tiles, pixel blocks, row tiles of a pixel block)
template <int P, typename V>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const int* __restrict__ cols, const V* __restrict__ blocks,
           const V* __restrict__ x, V* __restrict__ out, int batch, int n_c,
           int n_pb, int K, int bp, int bs, int n_sb, int n_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* blk_s = reinterpret_cast<V*>(smem);         // [kTileRows][bs + 1]
  V* x_s = blk_s + (size_t)kTileRows * (bs + 1);  // [bs][kTileCols]
  const int ld = bs + 1;
  const int n_cols = batch * n_f;
  const int j0 = blockIdx.x * kTileCols;
  const int i = blockIdx.y;
  const int r0 = blockIdx.z * kTileRows;
  const int rows = min(kTileRows, bp - r0);
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;

  V acc[kRowsPerThread][2];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    acc[q][0] = zero<V>();
    acc[q][1] = zero<V>();
  }

  for (int c = 0; c < n_c; ++c) {
    for (int k = 0; k < K; ++k) {
      const size_t slot = ((size_t)c * n_pb + i) * K + k;
      const int sb = cols[slot];
      const V* blk = blocks + (slot * bp + r0) * bs;
      __syncthreads();  // the previous step's reads are done
      for (int e = tid; e < kTileRows * bs; e += kThreads) {
        const int r = e / bs;
        const int s = e - r * bs;
        blk_s[r * ld + s] = r < rows ? rounded<P>(blk[e]) : zero<V>();
      }
      for (int e = tid; e < bs * kTileCols; e += kThreads) {
        const int s = e / kTileCols;
        const int jj = e - s * kTileCols;
        const int j = j0 + jj;
        V v = zero<V>();
        if (j < n_cols) {
          const int b = j / n_f;
          const int f = j - b * n_f;
          v = rounded<P>(
              x[((((size_t)b * n_sb + sb) * bs + s) * n_c + c) * n_f + f]);
        }
        x_s[s * kTileCols + jj] = v;
      }
      __syncthreads();
      for (int s = 0; s < bs; ++s) {
        const V x0 = x_s[s * kTileCols + 2 * cg];
        const V x1 = x_s[s * kTileCols + 2 * cg + 1];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) {
          const V a = blk_s[(rg + kRowGroups * q) * ld + s];
          mac(acc[q][0], a, x0);
          mac(acc[q][1], a, x1);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = rg + kRowGroups * q;
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 2 * cg + h;
      if (j >= n_cols) continue;
      const int b = j / n_f;
      const int f = j - b * n_f;
      out[(((size_t)b * n_pb + i) * bp + r0 + r) * n_f + f] = acc[q][h];
    }
  }
}

template <typename V>
int launch(const void* cols, const void* blocks, const void* x, void* out,
           int batch, int n_c, int n_pb, int K, int bp, int bs, int n_sb,
           int n_f, int precision, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = shared_bytes<V>(bs);
  // The one check of what this kernel takes: the caller raises on it.
  if (smem > kMaxShared || n_pb > 65535 || batch * n_f < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((batch * n_f + kTileCols - 1) / kTileCols, n_pb,
                  (bp + kTileRows - 1) / kTileRows);
  cudaStream_t s = (cudaStream_t)stream;
  const int* c = (const int*)cols;
  const V* a = (const V*)blocks;
  const V* xv = (const V*)x;
  V* y = (V*)out;
  switch (precision) {
#define BSR_CASE(PREC)                                                     \
  case PREC:                                                               \
    err = cudaFuncSetAttribute(bsr_kernel<PREC, V>,                        \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                                 \
    if (err != cudaSuccess) return (int)err;                               \
    bsr_kernel<PREC, V><<<grid, kThreads, smem, s>>>(                      \
        c, a, xv, y, batch, n_c, n_pb, K, bp, bs, n_sb, n_f);              \
    break;
    BSR_CASE(PREC_F32)
    BSR_CASE(PREC_BF16)
    BSR_CASE(PREC_F16)
#undef BSR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bsr_spmm_launch(const void* cols, const void* blocks,
                               const void* x, void* y, int n_pb, int K,
                               int bp, int bs, int n_sb, int nf,
                               int precision, int device, void* stream) {
  return launch<float>(cols, blocks, x, y, 1, 1, n_pb, K, bp, bs, n_sb, nf,
                       precision, device, stream);
}

extern "C" int bsr_beamform_launch(const void* cols, const void* blocks,
                                   const void* iq, void* out, int batch,
                                   int n_c, int n_pb, int K, int bp, int bs,
                                   int n_sb, int n_f, int precision,
                                   int device, void* stream) {
  return launch<float2>(cols, blocks, iq, out, batch, n_c, n_pb, K, bp, bs,
                        n_sb, n_f, precision, device, stream);
}
