// Causal flash attention for Hopper (sm_90a).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py). The TPU kernel walks a (head, q tile, k tile) grid with the
// k axis sequential on one core, carrying the online-softmax state (acc,
// m, l) in VMEM scratch from one grid step to the next. On Hopper the
// blocks run in no order, so the k loop moves inside the block: a block
// owns one 64-row query tile of one (batch, head) and walks the 64-key
// tiles from 0 to the diagonal, with the state in registers.
//
// Arithmetic, as the TPU kernel: f32 throughout; scores are the dot over
// d (ascending, fmaf) times `scale`; the mask sets rows < cols, and keys
// past Lk, to -1e30; per tile m_new = max(m, rowmax), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l * alpha + rowsum(p), acc = acc * alpha +
// p @ v (the product summed apart, then added); the result is
// acc / max(l, 1e-30). Key tiles wholly above the diagonal are skipped,
// which is exact: there p = 0 and alpha = 1. The first tile holds key 0,
// which no row masks, so m is finite after it. GQA reads KV head
// h / (Hq / Hkv) in place of the reference wrapper's jnp.repeat.
//
// Layout: q (B, Lq, Hq, d), k and v (B, Lk, Hkv, d), out (B, Lq, Hq, d),
// f32, contiguous; d a multiple of 16, at most 256. Grid (Lq / 64, B*Hq),
// 256 threads. Thread (ti, tj) = (tid / 16, tid % 16) owns query rows
// 4ti..4ti+3 and, for the scores, keys 4tj..4tj+3 of the tile (4 x 4 in
// registers); the 16 threads of a row group are one half-warp, which
// reduces max and sum with shuffles. Q and K are staged transposed (d x
// 64, rows padded by 4) so a thread reads its 4 rows as one float4; P goes
// through shared memory, transposed, for the product with V.
//
// Bound: f32 operations. At the served shape (B 4, L 1024, H 32, d 64)
// the causal products are 4 * B * H * d * L(L+1)/2 = 17.2 GFLOP, 0.26 ms
// at 67 TFLOP/s; q, k, v and out are 134 MB, 0.04 ms at 3.35 TB/s. This
// first kernel runs on the f32 FMA units (SIMT), not the tensor cores;
// each thread loads 2 float4 from shared memory per 16 fmaf.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // query rows per block = keys per tile
constexpr int kLd = kTile + 4;       // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxShared = 232448;  // the most a block may use (H100)

size_t shared_bytes(int d) {
  // Qt (d x kLd), Kt (d x kLd), V (kTile x d), Pt (kTile x kLd)
  return sizeof(float) *
         ((size_t)2 * d * kLd + (size_t)kTile * d + (size_t)kTile * kLd);
}

__device__ __forceinline__ void unpack(float4 a, float* v) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// Stage rows [t0, t0 + kTile) of one head of a (B, L, H, d) tensor,
// transposed into dst[d][kLd] and, when vdst is given, row-major into
// vdst[kTile][d]. Rows past `len` are zero.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      size_t row_stride, int t0, int len,
                                      int d, float* dst, float* vdst,
                                      const float* __restrict__ vsrc) {
  const int d4 = d / 4;
  for (int e = threadIdx.x; e < kTile * d4; e += kThreads) {
    const int r = e / d4;
    const int c = (e - r * d4) * 4;
    const int t = t0 + r;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 b = a;
    if (t < len) {
      a = *reinterpret_cast<const float4*>(src + (size_t)t * row_stride + c);
      if (vsrc != nullptr)
        b = *reinterpret_cast<const float4*>(vsrc + (size_t)t * row_stride +
                                             c);
    }
    dst[(c + 0) * kLd + r] = a.x;
    dst[(c + 1) * kLd + r] = a.y;
    dst[(c + 2) * kLd + r] = a.z;
    dst[(c + 3) * kLd + r] = a.w;
    if (vdst != nullptr) *reinterpret_cast<float4*>(vdst + r * d + c) = b;
  }
}

// NT: 4-column output tiles per thread, ceil(d / 64).
template <int NT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int lq, int lk, int hq, int hkv, int d, int causal,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                     // [d][kLd]     Q tile, transposed
  float* kt = qt + (size_t)d * kLd;     // [d][kLd]     K tile, transposed
  float* vs = kt + (size_t)d * kLd;     // [kTile][d]   V tile
  float* pt = vs + (size_t)kTile * d;   // [kTile][kLd] P tile, transposed

  const int tid = threadIdx.x;
  const int ti = tid >> 4;
  const int tj = tid & 15;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y - b * hq;
  const int hk = h / (hq / hkv);
  const size_t q_row = (size_t)hq * d;
  const size_t k_row = (size_t)hkv * d;
  const float* qb = q + (size_t)b * lq * q_row + (size_t)h * d;
  const float* kb = k + (size_t)b * lk * k_row + (size_t)hk * d;
  const float* vb = v + (size_t)b * lk * k_row + (size_t)hk * d;

  stage(qb, q_row, q0, lq, d, qt, nullptr, nullptr);

  float m[4], l[4], acc[4][NT][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][n][c] = 0.0f;
  }

  const int k_end = causal ? min(lk, q0 + kTile) : lk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  for (int kj = 0; kj < n_tiles; ++kj) {
    const int k0 = kj * kTile;
    __syncthreads();  // Q is staged; the last tile's K, V, P are read
    stage(kb, k_row, k0, lk, d, kt, vs, vb);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float qa[4], kc[4];
      unpack(*reinterpret_cast<const float4*>(qt + c * kLd + 4 * ti), qa);
      unpack(*reinterpret_cast<const float4*>(kt + c * kLd + 4 * tj), kc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[a][cc] = fmaf(qa[a], kc[cc], s[a][cc]);
    }

    float alpha[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + 4 * ti + a;
      float mc = kNegInf;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = k0 + 4 * tj + cc;
        float x = s[a][cc] * scale;
        if (col >= lk || (causal && row < col)) x = kNegInf;
        s[a][cc] = x;
        mc = fmaxf(mc, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[a], mc);
      float ps = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        s[a][cc] = expf(s[a][cc] - m_new);
        ps += s[a][cc];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      alpha[a] = expf(m[a] - m_new);
      l[a] = l[a] * alpha[a] + ps;
      m[a] = m_new;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      *reinterpret_cast<float4*>(pt + (4 * tj + cc) * kLd + 4 * ti) =
          make_float4(s[0][cc], s[1][cc], s[2][cc], s[3][cc]);
    __syncthreads();

    float pv[4][NT][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[a][n][c] = 0.0f;
    for (int j = 0; j < kTile; ++j) {
      float pa[4];
      unpack(*reinterpret_cast<const float4*>(pt + j * kLd + 4 * ti), pa);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c0 = 4 * (tj + 16 * n);
        if (c0 < d) {
          float vv[4];
          unpack(*reinterpret_cast<const float4*>(vs + j * d + c0), vv);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) pv[a][n][c] = fmaf(pa[a], vv[c], pv[a][n][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[a][n][c] = acc[a][n][c] * alpha[a] + pv[a][n][c];
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ti + a;
    if (row >= lq) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    float* o = out + (size_t)b * lq * q_row + (size_t)row * q_row +
               (size_t)h * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c0 = 4 * (tj + 16 * n);
      if (c0 < d)
        *reinterpret_cast<float4*>(o + c0) =
            make_float4(acc[a][n][0] / denom, acc[a][n][1] / denom,
                        acc[a][n][2] / denom, acc[a][n][3] / denom);
    }
  }
}

template <int NT>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int batch, int lq, int lk, int hq, int hkv,
                   int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTile - 1) / kTile, batch * hq);
  flash_attention_kernel<NT><<<grid, kThreads, smem, stream>>>(
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
  if (d <= 0 || d % 16 != 0 || d > 256 || hkv <= 0 || hq % hkv != 0 ||
      batch * hq > 65535 || shared_bytes(d) > kMaxShared)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || lq == 0) return (int)cudaSuccess;
  const float* qp = (const float*)q;
  const float* kp = (const float*)k;
  const float* vp = (const float*)v;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 63) / 64) {
    case 1:
      return (int)launch<1>(qp, kp, vp, o, batch, lq, lk, hq, hkv, d, causal,
                            scale, s);
    case 2:
      return (int)launch<2>(qp, kp, vp, o, batch, lq, lk, hq, hkv, d, causal,
                            scale, s);
    case 3:
      return (int)launch<3>(qp, kp, vp, o, batch, lq, lk, hq, hkv, d, causal,
                            scale, s);
    default:
      return (int)launch<4>(qp, kp, vp, o, batch, lq, lk, hq, hkv, d, causal,
                            scale, s);
  }
}
