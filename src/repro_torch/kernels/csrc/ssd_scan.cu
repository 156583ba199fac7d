// Mamba2 SSD chunked scan for Hopper (sm_90a), chunk-parallel, on the
// tensor cores.
//
// Replaces ssd_scan_pallas (src/repro/kernels/ssd_scan/kernel.py). The TPU
// kernel runs one head per call (the wrapper vmaps batch and heads) over a
// sequential grid of chunks, carrying the (N, P) state in VMEM scratch.
//
// Per chunk of Q steps, as the TPU kernel:
//   la  = inclusive cumsum of log_a over the chunk;
//   M   = (C B^T) * exp(min(la_i - la_j, 0)) where i >= j, else 0;
//   y   = M x + (C * exp(la)) h            (two products, summed apart);
//   h   = exp(la_last) * h + (B * exp(la_last - la))^T x.
// Steps past L are zero, as the reference's padding; the last chunk may
// be ragged.
//
// Bound on this card: bytes. At the served shape (B 4, L 2048, H 64,
// P 64, N 64, Q 128) the work the data needs is B * NC * [Q(Q+1) N +
// H (Q(Q+1) P + 4 Q N P)] = 13.0 GFLOP (C B^T once per (batch, chunk),
// the lower triangles, the two state products), 0.079 ms as 3xTF32 at
// 495 TFLOP/s (0.19 ms on the f32 FMA units); log_a, x, B, C and y are
// 274 MB, 0.082 ms at 3.35 TB/s. The three launches below move about
// 800 MB (y is written, then read and written again; the chunk states
// are written, carried and read), 0.24 ms.
//
// Design: the chunks are independent but for the state h, which is only
// N x P per (batch, head, chunk). So three launches, each over 64-wide
// tiles of P (grid) and of N (loops):
//   (a) ssd_chunk_kernel, parallel over (head group of 8 and P tile,
//       chunk, batch): the cumsum of each head as a warp scan; G = C B^T
//       once for the block's heads (B and C are group-shared), summed over
//       the N tiles; then per head y_diag = M x (M built from G and la as
//       the A operand is loaded, lower triangle only, each warp a row
//       tile's full P tile so that one M element feeds 8 products; at
//       Q = 128 the 72 eight-wide steps of the triangle are split 9 to a
//       warp, the longest row tiles over two warps), written to y, and the
//       chunk's state S_c = (B w)^T x for each N tile and decay
//       exp(la_last), written to scratch. Two groups of 8 warps take
//       alternate heads, so one group's cp.async of x overlaps the other's
//       products; where two x tiles do not fit beside a long chunk and a
//       wide N, group 0 takes every head.
//   (b) ssd_chain_kernel, one thread per (batch, head, n, p), serial over
//       chunks: h_c = exp(la_last_c) h_{c-1} + S_c, over S_c in place.
//   (c) ssd_offdiag_kernel, parallel over (head group and P tile,
//       chunk > 0, batch): y += (C exp(la)) h_{c-1}, an N tile at a time,
//       each tile of C loaded once for the group's heads.
//   One chunk (L <= Q) needs only (a).
// Every product is mma.sync m16n8k8 in 3xTF32 (tf32_mma.cuh): f32-level
// error on the tensor cores. Each sum stays in one accumulator: it runs
// over a chunk or a 64-wide N tile, at most 20 eight-wide steps whatever
// L is (G's N tiles and the off-diagonal's are added in f32, the state is
// carried in f32). Summed step by step in f32 instead, as flash attention
// does over its growing key axis, the scan is slower for an error barely
// smaller (tools/lm_kernel_variants.py times both). Rows of shared tiles
// are padded so that the fragment loads hit distinct banks (C by row:
// ld 68; B, x and h by column: ld 8 mod 32).
//
// Layout (f32, contiguous): log_a (B, L, H); x (B, L, H, P); b, c
// (B, L, N); y (B, L, H, P). The scratch, written and read here only, is
// ssd_scan_scratch_floats() floats: the chunk states (B, NC, H, N tiles,
// P tiles, 64, 64), then their decays (B, NC, H). Limit: shared memory,
// which (a) needs most of: Q (Q + 4) for G, Q (64 N tiles + 8) for B,
// one or two x tiles of Q x 72. Every chunk up to 128 steps that the
// SIMT kernel before this one took fits, at a wider N; chunks past 128
// fit up to 160 steps at N <= 64 and 144 at N <= 128.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kS = 64;  // N and P are taken in tiles of this width
constexpr int kLdC = kS + 4;
constexpr int kLdX = kS + 8;
constexpr int kHG = 8;  // heads per block in (a) and (c)
constexpr int kThreadsA = 512;
constexpr int kThreadsB = 256;
constexpr int kThreadsC = 256;
constexpr int kRed = 4 * 32 * 32;  // one group's partial y, Q = 128
constexpr size_t kMaxShared = 232448;  // the most a block may use (H100)

struct Dims {
  int L, H, P, N, Q;
  int qp;      // Q rounded up to 16
  int nc;      // chunks
  int nt, pt;  // 64-wide tiles of N and of P
  int ldb;     // row stride of B in (a): all N tiles
  int two;     // (a) runs two groups of 8 warps on alternate heads
  int vec_x, vec_bc;  // 16-byte copies of x; of B and C
};

// floats of shared memory of (a) and of (c)
size_t chunk_floats(int qp, int nt, bool two) {
  const size_t groups = two ? 2 : 1;
  return (size_t)qp * (qp + 4) + (size_t)qp * (kS * nt + 8) +
         groups * qp * kLdX + 2 * (size_t)kHG * qp +
         (qp == 128 ? groups * kRed : 0);
}

size_t offdiag_floats(int qp) {
  return (size_t)qp * kLdC + 2 * (size_t)kS * kLdX + (size_t)kHG * qp;
}

Dims dims_of(int L, int H, int P, int N, int Q) {
  Dims d;
  d.L = L;
  d.H = H;
  d.P = P;
  d.N = N;
  d.Q = Q;
  d.qp = (Q + 15) / 16 * 16;
  d.nc = (L + Q - 1) / Q;
  d.nt = (N + kS - 1) / kS;
  d.pt = (P + kS - 1) / kS;
  d.ldb = kS * d.nt + 8;
  d.two = chunk_floats(d.qp, d.nt, true) * sizeof(float) <= kMaxShared;
  d.vec_x = 0;
  d.vec_bc = 0;
  return d;
}

bool fits(const Dims& d) {
  return chunk_floats(d.qp, d.nt, d.two) * sizeof(float) <= kMaxShared &&
         offdiag_floats(d.qp) * sizeof(float) <= kMaxShared;
}

// floats of one (batch, chunk, head)'s state: every (N tile, P tile)
size_t state_floats(const Dims& d) { return (size_t)d.nt * d.pt * kS * kS; }

size_t scratch_floats(int batch, const Dims& d) {
  if (d.nc <= 1) return 0;
  return (size_t)batch * d.nc * d.H * (state_floats(d) + 1);
}

// cp.async `rows` rows of `cols` floats (at `stride` floats apart from
// src) into dst[.][ld] for the first kS columns; the rest of the kS
// columns and rows past `rows` up to `qp` are zero. `vec`: 16-byte copies.
template <int THREADS>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          size_t stride, int qp, int rows,
                                          int cols, bool vec, int tid) {
  if (vec) {
    for (int e = tid; e < qp * (kS / 4); e += THREADS) {
      const int r = e / (kS / 4);
      const int c = (e - r * (kS / 4)) * 4;
      const bool ok = r < rows && c < cols;
      tf32::cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = tid; e < qp * kS; e += THREADS) {
      const int r = e / kS;
      const int c = e - r * kS;
      const bool ok = r < rows && c < cols;
      tf32::cp_async4(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// Inclusive cumsum of la[0, qp) in place, by one warp: each lane sums its
// run of ceil(qp / 32) steps, then the lanes' totals are scanned with
// shuffles. Returns la[qp - 1] to every lane.
__device__ __forceinline__ float warp_cumsum(float* la, int qp) {
  const int lane = threadIdx.x & 31;
  const int run = (qp + 31) / 32;
  const int r0 = run * lane, r1 = min(r0 + run, qp);
  float incl = 0.0f;
  for (int r = r0; r < r1; ++r) {
    incl += la[r];
    la[r] = incl;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  for (int r = r0; r < r1; ++r) la[r] += excl;
  __syncwarp();
  return la[qp - 1];
}

__device__ __forceinline__ void store_pair(float* row, int p, int P,
                                           bool even, float a, float b) {
  if (even && p + 1 < P) {
    *reinterpret_cast<float2*>(row + p) = make_float2(a, b);
  } else {
    if (p < P) row[p] = a;
    if (p + 1 < P) row[p + 1] = b;
  }
}

// gs (+)= C B^T for row tile r (16 rows), its 8-wide column tiles up to
// the diagonal, over one 64-wide tile of N: cs [.][kLdC], bt points at
// the tile's first column of B [.][ldb]. `add`: add to what gs holds.
__device__ __forceinline__ void gram_rows(float* gs, int ldg, const float* cs,
                                          const float* bt, int ldb, int r,
                                          bool add, int g, int t) {
  const int i0 = 16 * r;
  const int ncol = 2 * r + 2;
  for (int nb = 0; nb < ncol; nb += 4) {
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kS; kk += 8) {
      const float* ca = cs + (i0 + g) * kLdC + kk + t;
      const tf32::FragA a =
          tf32::frag_a(ca[0], ca[8 * kLdC], ca[4], ca[8 * kLdC + 4]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (nb + n < ncol) {
          const float* br = bt + (8 * (nb + n) + g) * ldb + kk + t;
          tf32::mma3(acc[n], a, tf32::frag_b(br[0], br[4]));
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (nb + n < ncol) {
        float* gr = gs + (i0 + g) * ldg + 8 * (nb + n) + 2 * t;
        float2 v0 = make_float2(acc[n][0], acc[n][1]);
        float2 v1 = make_float2(acc[n][2], acc[n][3]);
        if (add) {
          const float2 o0 = *reinterpret_cast<float2*>(gr);
          const float2 o1 = *reinterpret_cast<float2*>(gr + 8 * ldg);
          v0 = make_float2(o0.x + v0.x, o0.y + v0.y);
          v1 = make_float2(o1.x + v1.x, o1.y + v1.y);
        }
        *reinterpret_cast<float2*>(gr) = v0;
        *reinterpret_cast<float2*>(gr + 8 * ldg) = v1;
      }
    }
  }
}

// acc = (M x) over the 8-wide steps [kb, ke) of row tile r (16 rows),
// all kS columns of the x tile: M[i][j] = G[i][j] exp(min(la_i - la_j, 0))
// for i >= j, else 0, built as the A operand is loaded.
__device__ __forceinline__ void mx_steps(float (&acc)[8][4], const float* gs,
                                         int ldg, const float* la,
                                         const float* xg, int r, int kb,
                                         int ke, int g, int t) {
  const int i0 = 16 * r + g, i1 = i0 + 8;
  const float la0 = la[i0], la1 = la[i1];
  const float* g0 = gs + i0 * ldg;
  const float* g1 = gs + i1 * ldg;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
#pragma unroll 2
  for (int kk = 8 * kb; kk < 8 * ke; kk += 8) {
    const int j0 = kk + t, j1 = j0 + 4;
    const float lj0 = la[j0], lj1 = la[j1];
    const tf32::FragA a = tf32::frag_a(
        i0 >= j0 ? g0[j0] * expf(fminf(la0 - lj0, 0.0f)) : 0.0f,
        i1 >= j0 ? g1[j0] * expf(fminf(la1 - lj0, 0.0f)) : 0.0f,
        i0 >= j1 ? g0[j1] * expf(fminf(la0 - lj1, 0.0f)) : 0.0f,
        i1 >= j1 ? g1[j1] * expf(fminf(la1 - lj1, 0.0f)) : 0.0f);
    const float* xr = xg + j0 * kLdX + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      tf32::mma3(acc[n], a, tf32::frag_b(xr[8 * n], xr[4 * kLdX + 8 * n]));
  }
}

// Rows 16 r + g and 16 r + g + 8 of a (Q, P) tile (rows `stride` floats
// apart), where below `rows`, from C fragments over the kS columns that
// are below P.
__device__ __forceinline__ void store_rows(float* y, size_t stride,
                                           const float (&acc)[8][4], int r,
                                           int rows, int P, bool even_p,
                                           int g, int t) {
  const int i0 = 16 * r + g, i1 = i0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int p = 8 * n + 2 * t;
    if (i0 < rows)
      store_pair(y + i0 * stride, p, P, even_p, acc[n][0], acc[n][1]);
    if (i1 < rows)
      store_pair(y + i1 * stride, p, P, even_p, acc[n][2], acc[n][3]);
  }
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kThreadsA / 2));
}

// The first float of the state tile (nt, pt) of (batch, chunk, head).
__device__ __forceinline__ size_t state_at(const Dims& d, int bi, int ci,
                                           int h, int nt, int pt) {
  return ((((size_t)bi * d.nc + ci) * d.H + h) * d.nt * d.pt +
          (size_t)nt * d.pt + pt) *
         kS * kS;
}

// (a): grid (ceil(H / kHG) * P tiles, NC, B), kThreadsA threads in two
// groups of 8 warps; with d.two group k takes heads k, k + 2, ..., so one
// group's loads overlap the other's products, else group 0 takes all.
__global__ void __launch_bounds__(kThreadsA, 1)
ssd_chunk_kernel(const float* __restrict__ log_a, const float* __restrict__ x,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 float* __restrict__ y, float* __restrict__ state,
                 float* __restrict__ decay, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int qp = d.qp, ldg = qp + 4;
  const int ngroups = d.two ? 2 : 1;
  float* gs = smem;                          // [qp][qp + 4]   C B^T
  float* bs = gs + qp * ldg;                 // [qp][ldb]      B, all of N
  float* xs = bs + qp * d.ldb;               // [ngroups][qp][kLdX] x
  float* cs = xs + (ngroups - 1) * qp * kLdX;  // [qp][kLdC] C tile, on x
  float* las = xs + ngroups * qp * kLdX;     // [kHG][qp]      cumsum
  float* ws = las + kHG * qp;                // [kHG][qp]      exp(la_last - la)
  float* reds = ws + kHG * qp;               // [ngroups][kRed] partial y

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int group = threadIdx.x / (kThreadsA / 2);
  const int warp = (threadIdx.x >> 5) & 7;   // warp within the group
  const int hgroups = (d.H + kHG - 1) / kHG;
  const int pt = blockIdx.x / hgroups;
  const int h0 = (blockIdx.x - pt * hgroups) * kHG;
  const int hg = min(kHG, d.H - h0);
  const int p0 = kS * pt;
  const int pw = min(kS, d.P - p0);          // this block's columns of P
  const int ci = blockIdx.y;
  const int nc = d.nc;
  const int bi = blockIdx.z;
  const int t0 = ci * d.Q;
  const int rows = min(d.Q, d.L - t0);
  const int nrt = qp / 16;
  const size_t xrow = (size_t)d.H * d.P;
  const float* xb = x + ((size_t)bi * d.L + t0) * xrow + p0;
  const float* bb = bm + ((size_t)bi * d.L + t0) * d.N;
  const float* cb = cm + ((size_t)bi * d.L + t0) * d.N;
  float* xg = xs + group * qp * kLdX;        // this group's x

  for (int nt = 0; nt < d.nt; ++nt)
    load_tile<kThreadsA>(bs + kS * nt, d.ldb, bb + kS * nt, d.N, qp, rows,
                         d.N - kS * nt, d.vec_bc, threadIdx.x);
  load_tile<kThreadsA>(cs, kLdC, cb, d.N, qp, rows, d.N, d.vec_bc,
                       threadIdx.x);
  if (d.two)
    load_tile<kThreadsA>(xs, kLdX, xb + (size_t)h0 * d.P, xrow, qp, rows, pw,
                         d.vec_x, threadIdx.x);
  tf32::cp_async_commit();
  for (int e = threadIdx.x; e < kHG * qp; e += kThreadsA) {
    const int r = e / kHG, hh = e - r * kHG;
    las[hh * qp + r] =
        (r < rows && hh < hg)
            ? log_a[((size_t)bi * d.L + t0 + r) * d.H + h0 + hh]
            : 0.0f;
  }
  tf32::cp_async_wait<0>();
  __syncthreads();

  if (group == 1 && warp < hg) {
    float* la = las + warp * qp;
    const float last = warp_cumsum(la, qp);
    for (int r = lane; r < qp; r += 32)
      ws[warp * qp + r] = expf(last - la[r]);
    if (lane == 0 && pt == 0 && ci + 1 < nc)
      decay[((size_t)bi * nc + ci) * d.H + h0 + warp] = expf(last);
  }

  // G = C B^T by group 0, summed over the N tiles: row tile r by warp
  // r % 8, column tiles to the diagonal
  for (int nt = 0; nt < d.nt; ++nt) {
    if (nt > 0) {
      load_tile<kThreadsA>(cs, kLdC, cb + kS * nt, d.N, qp, rows,
                           d.N - kS * nt, d.vec_bc, threadIdx.x);
      tf32::cp_async_commit();
      tf32::cp_async_wait<0>();
      __syncthreads();
    }
    if (group == 0)
      for (int r = warp; r < nrt; r += 8)
        gram_rows(gs, ldg, cs, bs + kS * nt, d.ldb, r, nt > 0, g, t);
    __syncthreads();  // G is summed, C (on x) is dead; la and w are ready
  }

  const bool even_p = (d.P & 1) == 0;
  const size_t ystride = xrow;
  for (int hh = group < ngroups ? group : hg; hh < hg; hh += ngroups) {
    const int h = h0 + hh;
    if (!(d.two && hh == 0)) {  // else group 0 has head 0's x already
      load_tile<kThreadsA / 2>(xg, kLdX, xb + (size_t)h * d.P, xrow, qp, rows,
                               pw, d.vec_x, threadIdx.x & (kThreadsA / 2 - 1));
      tf32::cp_async_commit();
      tf32::cp_async_wait<0>();
      group_sync(group);
    }
    const float* la = las + hh * qp;

    // y_diag = M x, all 64 columns of the P tile for each row tile a warp
    // takes. At Q = 128 the lower triangle's 72 eight-wide steps are split
    // 9 to a warp: warp 2p takes steps 0..8 of row tile 7 - p; warp 2p + 1
    // the rest of that tile (its partial sum goes to warp 2p through
    // shared memory) and all of row tile p. Else row tile r goes to warp
    // r % 8.
    float* yh = y + ((size_t)bi * d.L + t0) * ystride + (size_t)h * d.P + p0;
    float* red = reds + group * kRed + (warp >> 1) * 1024;
    float yacc[8][4];
    int r_fin = -1;  // the row tile this warp finishes after the barrier
    if (nrt == 8) {
      const int pr = warp >> 1;
      if ((warp & 1) == 0) {
        mx_steps(yacc, gs, ldg, la, xg, 7 - pr, 0, 9, g, t);
        r_fin = 7 - pr;
      } else {
        mx_steps(yacc, gs, ldg, la, xg, 7 - pr, 9, 16 - 2 * pr, g, t);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) red[(4 * n + c) * 32 + lane] = yacc[n][c];
        mx_steps(yacc, gs, ldg, la, xg, pr, 0, 2 * pr + 2, g, t);
        store_rows(yh, ystride, yacc, pr, rows, pw, even_p, g, t);
      }
    } else {
      for (int r = warp; r < nrt; r += 8) {
        mx_steps(yacc, gs, ldg, la, xg, r, 0, 2 * r + 2, g, t);
        store_rows(yh, ystride, yacc, r, rows, pw, even_p, g, t);
      }
    }

    // S_c = (B w)^T x for each N tile: rows 16 (warp % 4).. of the tile,
    // P half warp / 4 (not needed after the last chunk)
    if (ci + 1 < nc) {
      const int half = warp >> 2;
      const float* w = ws + hh * qp;
      for (int nt = 0; nt < d.nt; ++nt) {
        const int n0 = 16 * (warp & 3) + g;
        const float* bt = bs + kS * nt + n0;
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
#pragma unroll 2
        for (int kk = 0; kk < qp; kk += 8) {
          const int j0 = kk + t, j1 = j0 + 4;
          const float* b0 = bt + j0 * d.ldb;
          const float* b1 = bt + j1 * d.ldb;
          const tf32::FragA a = tf32::frag_a(b0[0] * w[j0], b0[8] * w[j0],
                                             b1[0] * w[j1], b1[8] * w[j1]);
          const float* xr = xg + j0 * kLdX + 32 * half + g;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            tf32::mma3(acc[n], a,
                           tf32::frag_b(xr[8 * n], xr[4 * kLdX + 8 * n]));
        }
        float* so = state + state_at(d, bi, ci, h, nt, pt);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int p = 32 * half + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(so + n0 * kS + p) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(so + (n0 + 8) * kS + p) =
              make_float2(acc[n][2], acc[n][3]);
        }
      }
    }
    group_sync(group);  // the group is done with its x; partials are in
    if (r_fin >= 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[n][c] += red[(4 * n + c) * 32 + lane];
      store_rows(yh, ystride, yacc, r_fin, rows, pw, even_p, g, t);
    }
  }
}

// (b): the state pass, one thread per (batch, head, n, p) of every tile,
// chunks in order: h_c = exp(la_last_c) h_{c-1} + S_c, written over S_c.
// Grid (tile / kThreadsB, B * H), `tile` the floats of one state.
__global__ void __launch_bounds__(kThreadsB)
ssd_chain_kernel(float* __restrict__ state, const float* __restrict__ decay,
                 int H, int nc, int tile) {
  const int e = blockIdx.x * kThreadsB + threadIdx.x;
  const int bi = blockIdx.y / H;
  const int h = blockIdx.y - bi * H;
  const size_t step = (size_t)H * tile;
  float* sp = state + ((size_t)bi * nc * H + h) * tile + e;
  const float* dp = decay + (size_t)bi * nc * H + h;
  float hv = 0.0f;
  float next = sp[0];
  for (int c = 0; c + 1 < nc; ++c) {
    const float sc = next;
    if (c + 2 < nc) next = sp[(c + 1) * step];
    hv = dp[(size_t)c * H] * hv + sc;
    sp[c * step] = hv;
  }
}

// (c): y += (C exp(la)) h_{c-1} for chunks 1..NC-1. Grid (ceil(H / kHG) *
// P tiles, NC - 1, B), kThreadsC threads. Over the N tiles, then the
// block's heads: each tile of C is loaded once for the heads, each head's
// tile of h_{c-1} by cp.async while the one before is computed. Row tile
// r goes to warp r % 8, with all 64 columns of the P tile.
__global__ void __launch_bounds__(kThreadsC, 2)
ssd_offdiag_kernel(const float* __restrict__ log_a,
                   const float* __restrict__ cm,
                   const float* __restrict__ state, float* __restrict__ y,
                   Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int qp = d.qp;
  float* cs = smem;                          // [qp][kLdC]     C tile
  float* hs = cs + qp * kLdC;                // [2][kS][kLdX]  h_{c-1} tile
  float* eas = hs + 2 * kS * kLdX;           // [kHG][qp]      exp(la)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int hgroups = (d.H + kHG - 1) / kHG;
  const int pt = blockIdx.x / hgroups;
  const int h0 = (blockIdx.x - pt * hgroups) * kHG;
  const int hg = min(kHG, d.H - h0);
  const int p0 = kS * pt;
  const int pw = min(kS, d.P - p0);
  const int ci = blockIdx.y + 1;
  const int bi = blockIdx.z;
  const int t0 = ci * d.Q;
  const int rows = min(d.Q, d.L - t0);
  const int nrt = qp / 16;
  const bool even_p = (d.P & 1) == 0;
  const float* cb = cm + ((size_t)bi * d.L + t0) * d.N;
  auto h_tile = [&](int k) {  // step k: N tile k / hg, head k % hg
    const int nt = k / hg;
    return state + state_at(d, bi, ci - 1, h0 + k - nt * hg, nt, pt);
  };

  load_tile<kThreadsC>(cs, kLdC, cb, d.N, qp, rows, d.N, d.vec_bc,
                       threadIdx.x);
  load_tile<kThreadsC>(hs, kLdX, h_tile(0), kS, kS, kS, kS, true,
                       threadIdx.x);
  tf32::cp_async_commit();
  for (int e = threadIdx.x; e < kHG * qp; e += kThreadsC) {
    const int r = e / kHG, hh = e - r * kHG;
    eas[hh * qp + r] =
        (r < rows && hh < hg)
            ? log_a[((size_t)bi * d.L + t0 + r) * d.H + h0 + hh]
            : 0.0f;
  }
  __syncthreads();
  if (warp < hg) {
    float* la = eas + warp * qp;
    warp_cumsum(la, qp);
    for (int r = lane; r < qp; r += 32) la[r] = expf(la[r]);
  }

  const int steps = d.nt * hg;
  for (int k = 0; k < steps; ++k) {
    const int nt = k / hg;
    const int hh = k - nt * hg;
    const int h = h0 + hh;
    if (hh == 0 && nt > 0) {  // every warp is done with the last C tile
      load_tile<kThreadsC>(cs, kLdC, cb + kS * nt, d.N, qp, rows,
                           d.N - kS * nt, d.vec_bc, threadIdx.x);
      tf32::cp_async_commit();
    }
    if (k + 1 < steps) {
      load_tile<kThreadsC>(hs + ((k + 1) & 1) * kS * kLdX, kLdX,
                           h_tile(k + 1), kS, kS, kS, kS, true, threadIdx.x);
      tf32::cp_async_commit();
      tf32::cp_async_wait<1>();
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();  // C and h of this step are in; the cumsums are done
    const float* hc = hs + (k & 1) * kS * kLdX;
    for (int r = warp; r < nrt; r += 8) {
      const int i0 = 16 * r + g, i1 = i0 + 8;
      float* y0 = y + (((size_t)bi * d.L + t0 + i0) * d.H + h) * d.P + p0;
      float* y1 = y0 + 8 * (size_t)d.H * d.P;
      float yd[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int p = 8 * n + 2 * t;
        yd[n][0] = i0 < rows && p < pw ? y0[p] : 0.0f;
        yd[n][1] = i0 < rows && p + 1 < pw ? y0[p + 1] : 0.0f;
        yd[n][2] = i1 < rows && p < pw ? y1[p] : 0.0f;
        yd[n][3] = i1 < rows && p + 1 < pw ? y1[p + 1] : 0.0f;
      }
      const float e0 = eas[hh * qp + i0], e1 = eas[hh * qp + i1];
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < kS; kk += 8) {
        const float* ca = cs + i0 * kLdC + kk + t;
        const tf32::FragA a =
            tf32::frag_a(ca[0] * e0, ca[8 * kLdC] * e1, ca[4] * e0,
                         ca[8 * kLdC + 4] * e1);
        const float* hr = hc + (kk + t) * kLdX + g;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          tf32::mma3(acc[n], a,
                         tf32::frag_b(hr[8 * n], hr[4 * kLdX + 8 * n]));
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int p = 8 * n + 2 * t;
        if (i0 < rows)
          store_pair(y0, p, pw, even_p, yd[n][0] + acc[n][0],
                     yd[n][1] + acc[n][1]);
        if (i1 < rows)
          store_pair(y1, p, pw, even_p, yd[n][2] + acc[n][2],
                     yd[n][3] + acc[n][3]);
      }
    }
    __syncthreads();  // every warp is done with this step's h (and C)
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Floats of scratch that ssd_scan_launch needs for these sizes (0 for one
// chunk): the wrapper allocates it, this file alone knows its layout.
extern "C" long long ssd_scan_scratch_floats(int batch, int L, int H, int P,
                                             int N, int Q) {
  if (batch <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0) return 0;
  return (long long)scratch_floats(batch, dims_of(L, H, P, N, Q));
}

// Launches of one call: 1 for a single chunk, else 3.
extern "C" int ssd_scan_launch(const void* log_a, const void* x,
                               const void* b, const void* c, void* y,
                               void* scratch, long long scratch_len,
                               int batch, int L, int H, int P, int N, int Q,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q <= 0 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  Dims d = dims_of(L, H, P, N, Q);
  if (!fits(d)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || H == 0 || L == 0) return (int)cudaSuccess;
  const size_t need = scratch_floats(batch, d);
  if (scratch_len < 0 || (size_t)scratch_len < need ||
      (need > 0 && !aligned16(scratch)))
    return (int)cudaErrorInvalidValue;
  const int hgroups = (H + kHG - 1) / kHG;
  if (d.nc > 65535 || batch > 65535 || (size_t)batch * H > 65535 ||
      (size_t)hgroups * d.pt > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  d.vec_x = P % 4 == 0 && aligned16(x);
  d.vec_bc = N % 4 == 0 && aligned16(b) && aligned16(c);
  const float* la = (const float*)log_a;
  const float* cp = (const float*)c;
  float* st = (float*)scratch;
  float* dc = st + (size_t)batch * d.nc * H * state_floats(d);
  cudaStream_t s = (cudaStream_t)stream;
  const int smem_a = (int)(chunk_floats(d.qp, d.nt, d.two) * sizeof(float));
  err = cudaFuncSetAttribute(ssd_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_a);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<<<dim3(hgroups * d.pt, d.nc, batch), kThreadsA, smem_a,
                     s>>>(la, (const float*)x, (const float*)b, cp, (float*)y,
                          st, dc, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.nc == 1) return (int)err;
  const int tile = (int)state_floats(d);
  ssd_chain_kernel<<<dim3(tile / kThreadsB, batch * H), kThreadsB, 0, s>>>(
      st, dc, H, d.nc, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem_c = (int)(offdiag_floats(d.qp) * sizeof(float));
  err = cudaFuncSetAttribute(ssd_offdiag_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_c);
  if (err != cudaSuccess) return (int)err;
  ssd_offdiag_kernel<<<dim3(hgroups * d.pt, d.nc - 1, batch), kThreadsC,
                       smem_c, s>>>(la, cp, st, (float*)y, d);
  return (int)cudaGetLastError();
}
