// Causal flash attention for Hopper (sm_90a), on the tensor cores.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py). The TPU kernel walks a (head, q tile, k tile) grid with the
// k axis sequential on one core, carrying the online-softmax state (acc,
// m, l) in VMEM scratch from one grid step to the next. On Hopper the
// blocks run in no order, so the k loop moves inside the block: a block
// owns one query tile of one (batch, head) and walks the key tiles from 0
// to the diagonal, the state in registers.
//
// Arithmetic, as the TPU kernel, in f32: scores are the dot over d times
// `scale`; the mask sets rows < cols, and keys past Lk, to -1e30; per
// tile m_new = max(m, rowmax), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l * alpha + rowsum(p), acc = acc * alpha + p @ v; the result is
// acc / max(l, 1e-30). Key tiles wholly above the diagonal are skipped,
// which is exact: there p = 0 and alpha = 1. The first tile holds key 0,
// which no row masks, so m is finite after it. GQA reads KV head
// h / (Hq / Hkv) in place of the reference wrapper's jnp.repeat.
//
// Bound on this card: operations. At the served shape (B 4, L 1024, H 32,
// d 64, causal) the two products are 4 * B * H * d * L(L+1)/2 = 17.2
// GFLOP; as 3xTF32 on the tensor cores (three TF32 products for each f32
// one, 495 TFLOP/s) that is 0.104 ms, against 0.26 ms on the f32 FMA
// units (67 TFLOP/s); q, k, v and out are 134 MB, 0.04 ms at 3.35 TB/s.
//
// Design (the FlashAttention-2 shape):
// - A block owns BR = 16 * WARPS query rows; each warp owns 16 of them.
//   Both products are mma.sync m16n8k8 in 3xTF32 (tf32_mma.cuh), which
//   keeps f32-level error; one TF32 pass would not hold atol 2e-5.
// - Splitting an operand into its TF32 parts costs more instructions than
//   the products it feeds, so Q and each K, V tile are split once per
//   block, as they are stored to shared memory (hi and lo side by side),
//   not once per warp that reads them. The next K, V tile is loaded into
//   registers while the current one is computed, then split and stored.
//   Rows are padded to D + 4 floats, so every fragment load (Q and K by
//   row, V by the permuted column below) hits 32 distinct banks.
// - S = Q K^T lands in the warp's accumulator fragments; the mask, the
//   row max (a quad shuffle) and the exp are done there. Each thread
//   keeps a partial row sum l, reduced across its quad at the end. The
//   tensor cores truncate when they add into an accumulator, so each
//   8-wide step of S starts from zero and is added to the scores in f32,
//   rounded to nearest. Summed in one accumulator, the error against
//   exact attention with q and k of order 4 came out larger than the
//   plain f32 version's (tests/test_torch_gpu.py holds it to no more).
//   O += P V is summed the same way: each 8-key step apart, then added to
//   acc * alpha in f32, as the TPU kernel adds p @ v to it.
// - O += P V takes P straight from the accumulators: a thread holds
//   columns 2t and 2t + 1 of S, and uses them as the A operand's k = t
//   and k = t + 4. The product sums over keys, so the B operand (V) is
//   read with the same permutation (rows 2t and 2t + 1 for b0 and b1):
//   no shuffle and no trip through shared memory.
// - A warp skips the key tiles above all of its rows. Blocks take query
//   tiles heaviest first (the last tile has the most keys), so the
//   causal tail is short.
// - d is padded to D in {64, 128, 256} with zero columns (q and k zeros
//   add nothing to the scores; the extra output columns are not stored).
//
// Layout: q (B, Lq, Hq, d), k and v (B, Lk, Hkv, d), out (B, Lq, Hq, d),
// f32, contiguous, 16-byte aligned; d a multiple of 16, at most 256.
// Grid (B * Hq, Lq / BR), one launch per call.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr size_t kMaxShared = 232448;  // the most a block may use (H100)

template <int D, int WARPS, int BC>
struct Cfg {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kBr = 16 * WARPS;  // query rows per block
  static constexpr int kLd = D + 4;       // row stride of every tile
  // Q (hi, lo) and one K, V tile (hi, lo), TF32 bits
  static constexpr size_t kShared =
      sizeof(float) * (size_t)kLd * (2 * kBr + 4 * BC);
  // float4 per thread for one K (or V) tile
  static constexpr int kStage = BC * D / 4 / kThreads;
  static_assert(BC * D / 4 % kThreads == 0, "uneven staging");
  static_assert(kBr % BC == 0, "Q is staged a key tile at a time");
};

// Rows [t0, t0 + rows) of one head of a (B, L, H, d) tensor, as float4:
// element i of this thread is row e / (D / 4), columns 4 (e % (D / 4))..+3
// with e = threadIdx.x + i * THREADS; rows past `len` and columns past d
// are zero.
template <int D, int THREADS, int N>
__device__ __forceinline__ void load_rows(float4 (&dst)[N],
                                          const float* __restrict__ src,
                                          size_t row_stride, int t0, int len,
                                          int d) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / (D / 4);
    const int c = (e - r * (D / 4)) * 4;
    dst[i] = t0 + r < len && c < d
                 ? __ldg(reinterpret_cast<const float4*>(
                       src + (size_t)(t0 + r) * row_stride + c))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Store what load_rows gave as TF32 (hi, lo) parts into hi[rows][D + 4]
// and lo[rows][D + 4]: each operand is split once per block, not once per
// warp that reads it.
template <int D, int THREADS, int N>
__device__ __forceinline__ void store_split(const float4 (&src)[N],
                                            float* hi, float* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / (D / 4);
    const int c = (e - r * (D / 4)) * 4;
    const tf32::Split x = tf32::split(src[i].x), y = tf32::split(src[i].y),
                      z = tf32::split(src[i].z), w = tf32::split(src[i].w);
    *reinterpret_cast<uint4*>(hi + r * (D + 4) + c) =
        make_uint4(x.hi, y.hi, z.hi, w.hi);
    *reinterpret_cast<uint4*>(lo + r * (D + 4) + c) =
        make_uint4(x.lo, y.lo, z.lo, w.lo);
  }
}

__device__ __forceinline__ uint32_t bits(const float* p) {
  return __float_as_uint(*p);
}

template <int D, int WARPS, int BC>
__global__ void __launch_bounds__(32 * WARPS, D == 64 ? 2 : 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int lq, int lk, int hq, int hkv, int d, int causal,
                       float scale) {
  using C = Cfg<D, WARPS, BC>;
  constexpr int kLd = C::kLd;
  constexpr int kNS = BC / 8;  // score n-tiles per warp
  constexpr int kNO = D / 8;   // output n-tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* qh = smem;                          // [kBr][kLd]  Q, hi
  float* ql = qh + C::kBr * kLd;             // [kBr][kLd]  Q, lo
  float* kh = ql + C::kBr * kLd;             // [BC][kLd]   K, hi
  float* kl = kh + BC * kLd;                 // [BC][kLd]   K, lo
  float* vh = kl + BC * kLd;                 // [BC][kLd]   V, hi
  float* vl = vh + BC * kLd;                 // [BC][kLd]   V, lo

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBr;  // heaviest first
  const int b = blockIdx.x / hq;
  const int h = blockIdx.x - b * hq;
  const int hk = h / (hq / hkv);
  const size_t q_row = (size_t)hq * d;
  const size_t k_row = (size_t)hkv * d;
  const float* qb = q + (size_t)b * lq * q_row + (size_t)h * d;
  const float* kb = k + (size_t)b * lk * k_row + (size_t)hk * d;
  const float* vb = v + (size_t)b * lk * k_row + (size_t)hk * d;

  const int k_end = causal ? min(lk, q0 + C::kBr) : lk;
  const int n_tiles = (k_end + BC - 1) / BC;
  float4 ks[C::kStage], vs[C::kStage];
  load_rows<D, C::kThreads>(ks, kb, k_row, 0, lk, d);
  load_rows<D, C::kThreads>(vs, vb, k_row, 0, lk, d);
#pragma unroll
  for (int r0 = 0; r0 < C::kBr; r0 += BC) {  // Q, a key tile's rows at a time
    float4 qs[C::kStage];
    load_rows<D, C::kThreads>(qs, qb, q_row, q0 + r0, lq, d);
    store_split<D, C::kThreads>(qs, qh + r0 * kLd, ql + r0 * kLd);
  }
  store_split<D, C::kThreads>(ks, kh, kl);
  store_split<D, C::kThreads>(vs, vh, vl);
  __syncthreads();

  const int wrow = q0 + 16 * warp;  // the warp's first query row
  const int row0 = wrow + g, row1 = row0 + 8;
  const float* qwh = qh + (16 * warp + g) * kLd + t;
  const float* qwl = ql + (16 * warp + g) * kLd + t;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // the next tile's loads fly during this one
      load_rows<D, C::kThreads>(ks, kb, k_row, (j + 1) * BC, lk, d);
      load_rows<D, C::kThreads>(vs, vb, k_row, (j + 1) * BC, lk, d);
    }
    const int k0 = j * BC;
    if (!causal || k0 <= wrow + 15) {  // else every key is above the rows
      float s[kNS][4];
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        tf32::FragA a;
        a.v[0] = {bits(qwh + kk), bits(qwl + kk)};
        a.v[1] = {bits(qwh + kk + 8 * kLd), bits(qwl + kk + 8 * kLd)};
        a.v[2] = {bits(qwh + kk + 4), bits(qwl + kk + 4)};
        a.v[3] = {bits(qwh + kk + 8 * kLd + 4), bits(qwl + kk + 8 * kLd + 4)};
#pragma unroll
        for (int n = 0; n < kNS; ++n) {
          const int o = (8 * n + g) * kLd + kk + t;
          tf32::FragB bf;
          bf.v[0] = {bits(kh + o), bits(kl + o)};
          bf.v[1] = {bits(kh + o + 4), bits(kl + o + 4)};
          tf32::mma3_add(s[n], a, bf);
        }
      }

      const bool edge = k0 + BC > lk || (causal && k0 + BC - 1 > wrow);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[n][c] * scale;
          if (edge) {
            const int col = k0 + 8 * n + 2 * t + (c & 1);
            const int row = c < 2 ? row0 : row1;
            if (col >= lk || (causal && row < col)) x = kNegInf;
          }
          s[n][c] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
        s[n][0] = expf(s[n][0] - mn0);
        s[n][1] = expf(s[n][1] - mn0);
        s[n][2] = expf(s[n][2] - mn1);
        s[n][3] = expf(s[n][3] - mn1);
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }

      // O += P V; A's k = t, t + 4 are keys 2t, 2t + 1 of the 8-key step
#pragma unroll
      for (int kk = 0; kk < kNS; ++kk) {
        const tf32::FragA a =
            tf32::frag_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
        const int o = (8 * kk + 2 * t) * kLd + g;
#pragma unroll
        for (int n = 0; n < kNO; ++n) {
          tf32::FragB bf;
          bf.v[0] = {bits(vh + o + 8 * n), bits(vl + o + 8 * n)};
          bf.v[1] = {bits(vh + o + kLd + 8 * n), bits(vl + o + kLd + 8 * n)};
          tf32::mma3_add(acc[n], a, bf);
        }
      }
    }
    if (j + 1 < n_tiles) {
      __syncthreads();  // every warp is done with this tile
      store_split<D, C::kThreads>(ks, kh, kl);
      store_split<D, C::kThreads>(vs, vh, vl);
      __syncthreads();
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float dn0 = fmaxf(l0, 1e-30f), dn1 = fmaxf(l1, 1e-30f);
  float* o0 = out + ((size_t)b * lq + row0) * q_row + (size_t)h * d;
  float* o1 = o0 + 8 * q_row;
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= d) continue;
    if (row0 < lq)
      *reinterpret_cast<float2*>(o0 + col) =
          make_float2(acc[n][0] / dn0, acc[n][1] / dn0);
    if (row1 < lq)
      *reinterpret_cast<float2*>(o1 + col) =
          make_float2(acc[n][2] / dn1, acc[n][3] / dn1);
  }
}

template <int D, int WARPS, int BC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int batch, int lq, int lk, int hq, int hkv,
                   int d, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<D, WARPS, BC>;
  static_assert(C::kShared <= kMaxShared, "tile past shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, WARPS, BC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kShared);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (lq + C::kBr - 1) / C::kBr;
  if (n_qtiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(batch * hq, n_qtiles);
  flash_attention_kernel<D, WARPS, BC><<<grid, C::kThreads, C::kShared,
                                         stream>>>(
      q, k, v, out, lq, lk, hq, hkv, d, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int lq, int lk, int hq, int hkv, int d,
                                      int causal, float scale, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d <= 0 || d % 16 != 0 || d > 256 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || lq == 0) return (int)cudaSuccess;
  const float* qp = (const float*)q;
  const float* kp = (const float*)k;
  const float* vp = (const float*)v;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return (int)launch<64, 8, 32>(qp, kp, vp, o, batch, lq, lk, hq, hkv, d,
                                  causal, scale, s);
  if (d <= 128)
    return (int)launch<128, 8, 32>(qp, kp, vp, o, batch, lq, lk, hq, hkv, d,
                                   causal, scale, s);
  return (int)launch<256, 4, 16>(qp, kp, vp, o, batch, lq, lk, hq, hkv, d,
                                 causal, scale, s);
}
