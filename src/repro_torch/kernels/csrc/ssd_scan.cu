// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces ssd_scan_pallas (src/repro/kernels/ssd_scan/kernel.py). The TPU
// kernel runs one head per call (the wrapper vmaps batch and heads) over a
// sequential grid of chunks, carrying the (N, P) state in VMEM scratch.
// Here one block owns one (batch, head) and loops over its chunks in
// ascending order inside the block; the state stays in shared memory.
//
// Per chunk of Q steps, as the TPU kernel:
//   la  = inclusive cumsum of log_a over the chunk (one thread, ascending
//         order: XLA's order differs, so the kernel is held to a
//         tolerance, not to bit equality);
//   M   = (C B^T) * exp(min(la_i - la_j, 0)) where i >= j, else 0 (the
//         clamp before the exp);
//   y   = M x + (C * exp(la)) h            (two products, summed apart);
//   h   = exp(la_last) * h + (B * exp(la_last - la))^T x.
// Every product is a 4 x 4 register tile of fmaf over the contracted
// axis in ascending order. Only the lower triangle of M is computed, and
// y's intra-chunk product stops at the diagonal (the rest of M is zero).
// B and C are group-shared: the reference broadcasts them to every head
// first (134 MB per matrix at the served shape), the kernel reads row
// (batch, t) for every head.
// Steps past L, and the padding of Q, N and P up to multiples of 4, are
// zero in shared memory: exactly what the reference's padding adds.
//
// Layout (f32, contiguous): log_a (B, L, H); x (B, L, H, P); b, c
// (B, L, N); y (B, L, H, P). Grid B*H, 256 threads.
// Shared memory: cumsum and the two decay vectors (3 Q), C and B
// transposed (N x (Q+4) each), x (Q x P), M transposed (Q x (Q+4)) and
// the state (N x P): 186 KB at Q = 128, N = P = 64, so one block per SM.
//
// Bound: f32 operations. At the served shape (B 4, L 2048, H 64, P 64,
// N 64, Q 128) the lower-triangular products and the two state products
// take B*H*(L/Q)*(Q(Q+1)(N+P) + 4QNP) = 17.3 GFLOP, 0.26 ms at
// 67 TFLOP/s (25.8 GFLOP counting the full Q x Q products); log_a, x, B,
// C and y are 274 MB, 0.08 ms at 3.35 TB/s. 256 blocks of one per SM fill
// 132 SMs in two uneven waves; splitting P across blocks comes later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxShared = 232448;  // the most a block may use (H100)

struct Dims {
  int qp, np, pp, ldq;  // Q, N, P rounded up to 4; row stride of M^T, B^T, C^T
};

Dims dims_of(int q, int n, int p) {
  Dims d;
  d.qp = (q + 3) / 4 * 4;
  d.np = (n + 3) / 4 * 4;
  d.pp = (p + 3) / 4 * 4;
  d.ldq = d.qp + 4;
  return d;
}

size_t shared_bytes(const Dims& d) {
  return sizeof(float) *
         ((size_t)3 * d.qp + (size_t)2 * d.np * d.ldq + (size_t)d.qp * d.pp +
          (size_t)d.qp * d.ldq + (size_t)d.np * d.pp);
}

__device__ __forceinline__ void unpack(float4 a, float* v) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ y, int L, int H, int P, int N,
                int Q, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  const int qp = dm.qp, np = dm.np, pp = dm.pp, ldq = dm.ldq;
  float* lac = smem;                   // [qp]       cumsum of log_a
  float* ea = lac + qp;                // [qp]       exp(la)
  float* w = ea + qp;                  // [qp]       exp(la_last - la)
  float* ct = w + qp;                  // [np][ldq]  C^T
  float* bt = ct + (size_t)np * ldq;   // [np][ldq]  B^T
  float* xs = bt + (size_t)np * ldq;   // [qp][pp]   x
  float* mt = xs + (size_t)qp * pp;    // [qp][ldq]  M^T: mt[j][i] = M[i][j]
  float* hs = mt + (size_t)qp * ldq;   // [np][pp]   state h

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x - bi * H;
  const int nq4 = qp / 4, nn4 = np / 4, np4 = pp / 4;

  for (int e = tid; e < np * pp; e += kThreads) hs[e] = 0.0f;

  const int n_chunks = (L + Q - 1) / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * Q;
    __syncthreads();  // the last chunk's state update has read B^T and x
    for (int r = tid; r < qp; r += kThreads) {
      const int t = t0 + r;
      lac[r] = (r < Q && t < L) ? log_a[((size_t)bi * L + t) * H + h] : 0.0f;
    }
    for (int e = tid; e < qp * pp; e += kThreads) {
      const int r = e / pp, p = e - r * pp, t = t0 + r;
      xs[e] = (r < Q && t < L && p < P)
                  ? x[(((size_t)bi * L + t) * H + h) * P + p]
                  : 0.0f;
    }
    for (int e = tid; e < qp * np; e += kThreads) {
      const int r = e / np, n = e - r * np, t = t0 + r;
      const bool in = r < Q && t < L && n < N;
      const size_t off = ((size_t)bi * L + t) * N + n;
      bt[n * ldq + r] = in ? bm[off] : 0.0f;
      ct[n * ldq + r] = in ? cm[off] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int r = 0; r < qp; ++r) {
        s += lac[r];
        lac[r] = s;
      }
    }
    __syncthreads();
    const float la_last = lac[qp - 1];
    for (int r = tid; r < qp; r += kThreads) {
      ea[r] = expf(lac[r]);
      w[r] = expf(la_last - lac[r]);
    }

    // M, lower-triangular 4 x 4 tiles
    for (int tile = tid; tile < nq4 * nq4; tile += kThreads) {
      const int ti = tile / nq4, tj = tile - ti * nq4;
      if (tj > ti) continue;
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
      for (int n = 0; n < np; ++n) {
        float c4[4], b4[4];
        unpack(*reinterpret_cast<const float4*>(ct + n * ldq + 4 * ti), c4);
        unpack(*reinterpret_cast<const float4*>(bt + n * ldq + 4 * tj), b4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = fmaf(c4[a], b4[b], s[a][b]);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * tj + b;
        float col[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 4 * ti + a;
          col[a] = i >= j ? s[a][b] * expf(fminf(lac[i] - lac[j], 0.0f))
                          : 0.0f;
        }
        *reinterpret_cast<float4*>(mt + j * ldq + 4 * ti) =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
    __syncthreads();

    // y = M x + (C * exp(la)) h, 4 x 4 tiles of (step, p)
    for (int tile = tid; tile < nq4 * np4; tile += kThreads) {
      const int ti = tile / np4, tp = tile - ti * np4;
      float acc[4][4], acc2[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = acc2[a][b] = 0.0f;
      for (int j = 0; j < 4 * ti + 4; ++j) {  // M[i][j] = 0 for j > i
        float m4[4], x4[4];
        unpack(*reinterpret_cast<const float4*>(mt + j * ldq + 4 * ti), m4);
        unpack(*reinterpret_cast<const float4*>(xs + j * pp + 4 * tp), x4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(m4[a], x4[b], acc[a][b]);
      }
      float e4[4];
      unpack(*reinterpret_cast<const float4*>(ea + 4 * ti), e4);
      for (int n = 0; n < np; ++n) {
        float c4[4], h4[4];
        unpack(*reinterpret_cast<const float4*>(ct + n * ldq + 4 * ti), c4);
        unpack(*reinterpret_cast<const float4*>(hs + n * pp + 4 * tp), h4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ce = c4[a] * e4[a];
#pragma unroll
          for (int b = 0; b < 4; ++b) acc2[a][b] = fmaf(ce, h4[b], acc2[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ti + a, t = t0 + i;
        if (i >= Q || t >= L) continue;
        float* yrow = y + (((size_t)bi * L + t) * H + h) * P;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = 4 * tp + b;
          if (p < P) yrow[p] = acc[a][b] + acc2[a][b];
        }
      }
    }
    __syncthreads();  // every read of h is done

    // h = exp(la_last) h + (B * w)^T x, 4 x 4 tiles of (n, p)
    const float ea_last = expf(la_last);
    for (int tile = tid; tile < nn4 * np4; tile += kThreads) {
      const int tn = tile / np4, tp = tile - tn * np4;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      for (int j = 0; j < qp; ++j) {
        const float wj = w[j];
        float bw[4], x4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bw[a] = bt[(4 * tn + a) * ldq + j] * wj;
        unpack(*reinterpret_cast<const float4*>(xs + j * pp + 4 * tp), x4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(bw[a], x4[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float* hp = hs + (4 * tn + a) * pp + 4 * tp + b;
          *hp = ea_last * *hp + acc[a][b];
        }
    }
  }
}

}  // namespace

extern "C" int ssd_scan_launch(const void* log_a, const void* x,
                               const void* b, const void* c, void* y,
                               int batch, int L, int H, int P, int N,
                               int Q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q <= 0 || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const Dims dm = dims_of(Q, N, P);
  const size_t smem = shared_bytes(dm);
  if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
  if (batch == 0 || H == 0 || L == 0) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<batch * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)x, (const float*)b, (const float*)c,
      (float*)y, L, H, P, N, Q, dm);
  return (int)cudaGetLastError();
}
