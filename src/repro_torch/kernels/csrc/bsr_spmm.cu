// Block-sparse (BSR) products for Hopper (sm_90a): the sparse variant's
// beamform.
//
// Replaces bsr_spmm_pallas (src/repro/kernels/bsr_spmm/kernel.py). The
// TPU kernel walks a (pixel block, K) grid with K sequential on one core,
// one dense (bp x bs) @ (bs x nf) MXU product per step, accumulated in the
// output tile; the reference's bsr_beamform (ops.py) vmaps it over the
// channels, four real SpMMs each, and sums the channels afterwards.
//
// Two entries:
//   bsr_spmm_launch     — the real primitive with the TPU kernel's
//                         signature, (cols, blocks, x) -> y, any columns;
//                         every stored slot is summed. f32 SIMT.
//   bsr_beamform_launch — the complex multi-channel beamform in ONE
//                         launch, on the tensor cores; the per-channel
//                         partial results are never written (at batch 4
//                         and the paper's geometry they would be 1.07 GB).
//
// bsr_beamform computes out[b, p, f] = sum_c sum_k blocks[c, pb, k] .
// iq_b[b, cols[c, pb, k], :, c, f] (complex), each block a dense
// (bp x bs) product: the paper's BSR formulation, nothing of the two taps
// a row holds is used.
//
// Padded slots. It takes the operator in the format delays.bsr_operator
// documents: in each (channel, pixel block) row the occupied slots come
// first, with strictly ascending columns; unused slots are all-zero blocks
// at column 0. So a slot k > 0 whose column is not above slot k - 1's is
// padding, and this kernel neither stages nor multiplies it (exact for
// finite IQ). Slot 0 is always taken: a row with no occupied slot looks
// like a row whose one block sits at column 0. Operators outside this
// format must go through bsr_spmm, which sums every slot.
//
// Bound at batch 4 and the paper's geometry (bp = bs = 64, K = 2,
// n_c = 64, n_pb = 256, n_f = 32; 15,070 of the 32,768 stored blocks
// occupied): 63.2 GFLOP on the occupied blocks; as 3xTF32 on the tensor
// cores (three TF32 products per f32 product, 495 TFLOP/s) 0.383 ms,
// against 0.54 GB of occupied operator, IQ and output, 0.16 ms at
// 3.35 TB/s. At bf16/f16 the products take a sixth of the TF32 time and
// the bytes bound it.
//
// Design of bsr_beamform:
// - The complex product is one real product: with the reduction index
//   k = (sample s, component) and the output row m = (pixel, component),
//   the re row of a pixel is (re, -im) and its im row (im, re), per
//   sample, against the IQ rows (re, im). That is the layout both arrays
//   already have (re/im interleaved), so the operator block and the IQ
//   rows are staged as they lie, and a fragment's rows g and g + 8 are the
//   re and im rows of one pixel: a thread reads one complex value of the
//   block and forms both operands. No product is wasted.
// - An output tile is up to 64 rows of one pixel block x 128 columns
//   (acquisition x frame; one column tile at the paper's geometry). A
//   thread block, 8 warps of 32 pixel rows x 32 columns, takes one tile
//   and one group of its channels. It walks the group's kept slots,
//   channels then K ascending, and bs in chunks of 64 samples; each such
//   unit is staged whole by cp.async into a ring of two stages (the
//   operator block, 64 x 64 complex, and the block's IQ rows, 64 x 128
//   complex; 204-209 KB), so the next unit loads while this one
//   multiplies.
// - Channel groups balance the card. At the paper's geometry a pixel
//   block holds 64 to 116 kept units (chip_smoke.py prints them), so with
//   one block per tile the SMs that draw heavy tiles finish far behind
//   the rest (256 tiles on 132 SMs). Where the tiles of one column
//   tile give fewer than 1024 blocks, the channels are split into up to
//   4 groups (blockIdx.z). The batch does not enter that count, so an
//   acquisition is summed in the same order whatever batch it is served
//   in (a sharded batch equals the whole one bit for bit). Each group
//   writes its sums to a partial tile, and the
//   block that arrives last at a tile (an atomic count of arrivals, reset
//   by that block) adds the groups' partial tiles in ascending order. No
//   sum is atomic, so the output does not depend on which block is last.
// - f32 runs as 3xTF32 mma.sync m16n8k8 (tf32_mma.cuh). The operands land
//   raw in shared memory: a second, split copy of a stage (twice its
//   bytes) would leave no room for the ring. Each value is split into its
//   TF32 parts as a warp loads its fragment, and that split feeds four
//   m16n8 products (three mma each): one split per operand value per
//   warp that reads it (2 warps read each IQ value, 4 each operator value).
//   The lo part is rounded (tf32::split): passed unrounded it ran no
//   faster, and the sparse colour-Doppler image then missed its card-vs-
//   CPU tolerance (tests/test_torch_gpu.py).
// - bf16/f16 run mma.sync m16n8k16 with f32 accumulation, on operands
//   rounded to nearest as round_operand<P> rounds them (cvt.rn while
//   packing a fragment): the plain version's operands, exactly.
// - Summation: the tensor cores truncate as they add into an accumulator,
//   so each unit's product is summed from zero and then added to the f32
//   sums, rounded to nearest (tests/test_torch_gpu.py holds the f32 error
//   against a float64 product to twice the plain version's; in one
//   accumulator it came out about 8x the plain version's). The units run
//   in a fixed order, the groups are added in a fixed order: the output is
//   bit-identical from run to run.
// - Shared tiles are padded so every fragment load hits distinct banks:
//   the operator's rows to 68 complex values, the IQ's to 136 (f32) or
//   132 (bf16/f16) for their two fragment shapes.
// - Ragged shapes: rows past bp, samples past bs and columns past B * n_f
//   are zero-filled by cp.async (16-byte copies where bs, n_f and the
//   pointers allow, else 8-byte ones).
//
// Shapes (all contiguous):
//   beamform: cols (n_c, n_pb, K) int32; blocks (n_c, n_pb, K, bp, bs)
//             float2; iq (B, n_sb, bs, n_c, n_f) float2;
//             out (B, n_pb * bp, n_f) float2.
//   spmm:     cols (n_pb, K) int32; blocks (n_pb, K, bp, bs) float;
//             x (n_sb, bs, nf) float; y (n_pb * bp, nf) float.
//   workspace: partial tiles and arrival counts, sized by
//             bsr_beamform_partials / bsr_beamform_arrivals; the counts
//             are zero before a call and after it.
// Limits: grid axes (n_pb and the 64-row tiles of bp each at most 65535);
// bsr_spmm also a (64 x bs) tile in shared memory. Refused, not
// mis-computed: the entry returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "das_common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr size_t kMaxShared = 232448;  // the most a block may use (H100)
constexpr int kMaxGridYZ = 65535;

// ---------------------------------------------------------------------
// bsr_spmm: real, f32 SIMT. A thread block owns a tile of up to 64 rows
// of one pixel block and 32 output columns; each thread holds 4 rows x 2
// columns in registers. It walks the K stored blocks in order, staging
// the operator block and the block's rows of x in shared memory (rounded
// to bf16/f16 there when asked), and takes the product over s in
// ascending order with explicit fmaf.

constexpr int kThreads = 256;
constexpr int kTileRows = 64;   // rows of a pixel block per thread block
constexpr int kTileCols = 32;   // output columns per thread block
constexpr int kColGroups = kTileCols / 2;           // 2 columns a thread
constexpr int kRowGroups = kThreads / kColGroups;   // 16
constexpr int kRowsPerThread = kTileRows / kRowGroups;  // 4, strided by 16

size_t spmm_shared_bytes(int bs) {
  // operator tile, rows padded by one element against bank conflicts,
  // then the x tile
  return ((size_t)kTileRows * (bs + 1) + (size_t)bs * kTileCols) *
         sizeof(float);
}

// grid: (column tiles, pixel blocks, row tiles of a pixel block)
template <int P>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ cols,
                const float* __restrict__ blocks,
                const float* __restrict__ x, float* __restrict__ out,
                int n_pb, int K, int bp, int bs, int n_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* blk_s = reinterpret_cast<float*>(smem);     // [kTileRows][bs + 1]
  float* x_s = blk_s + (size_t)kTileRows * (bs + 1);  // [bs][kTileCols]
  const int ld = bs + 1;
  const int j0 = blockIdx.x * kTileCols;
  const int i = blockIdx.y;
  const int r0 = blockIdx.z * kTileRows;
  const int rows = min(kTileRows, bp - r0);
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;

  float acc[kRowsPerThread][2] = {};
  for (int k = 0; k < K; ++k) {
    const size_t slot = (size_t)i * K + k;
    const int sb = cols[slot];
    const float* blk = blocks + (slot * bp + r0) * bs;
    __syncthreads();  // the previous step's reads are done
    for (int e = tid; e < kTileRows * bs; e += kThreads) {
      const int r = e / bs;
      const int s = e - r * bs;
      blk_s[r * ld + s] = r < rows ? round_operand<P>(blk[e]) : 0.0f;
    }
    for (int e = tid; e < bs * kTileCols; e += kThreads) {
      const int s = e / kTileCols;
      const int j = j0 + e - s * kTileCols;
      x_s[e] = j < n_f
                   ? round_operand<P>(x[((size_t)sb * bs + s) * n_f + j])
                   : 0.0f;
    }
    __syncthreads();
    for (int s = 0; s < bs; ++s) {
      const float x0 = x_s[s * kTileCols + 2 * cg];
      const float x1 = x_s[s * kTileCols + 2 * cg + 1];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const float a = blk_s[(rg + kRowGroups * q) * ld + s];
        acc[q][0] = fmaf(a, x0, acc[q][0]);
        acc[q][1] = fmaf(a, x1, acc[q][1]);
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
      if (j < n_f) out[((size_t)i * bp + r0 + r) * n_f + j] = acc[q][h];
    }
  }
}

// ---------------------------------------------------------------------
// bsr_beamform: complex, multi-channel, tensor cores.

constexpr int kBfRows = 64;      // pixel rows of a tile
constexpr int kBfCols = 128;     // output columns (acquisition x frame)
constexpr int kWarpsM = 2;       // warps along the pixel rows
constexpr int kWarpsN = 4;       // warps along the columns
constexpr int kBfThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBfRows / 8 / kWarpsM;   // m16 tiles (8 pixels) a warp
constexpr int kNT = kBfCols / 8 / kWarpsN;   // n8 tiles a warp
constexpr int kBfS = 64;         // samples of one staged unit
constexpr int kLdA = kBfS + 4;   // complex row stride of the operator tile
constexpr int kStages = 2;

template <int P>
struct BfCfg {
  // IQ row stride: TF32 fragments read 32-bit words two rows apart, the
  // 16-bit ones 64-bit words one row apart
  static constexpr int kLdX = P == PREC_F32 ? kBfCols + 8 : kBfCols + 4;
  static constexpr int kStage = kBfRows * kLdA + kBfS * kLdX;  // float2
  static constexpr size_t kShared = sizeof(float2) * kStages * kStage;
  static_assert(kShared <= kMaxShared, "ring past shared memory");
};

struct BfArgs {
  const int* cols;
  const float2* blocks;
  const float2* x;
  float2* out;
  float2* partials;     // [parts][tiles][kBfRows][kBfCols] when parts > 1
  unsigned* arrivals;   // [tiles], zero between calls
  int batch, n_c, n_pb, K, bp, bs, n_sb, n_f;
  int parts;            // channel groups, each its own thread block
  int a16, x16;         // 16-byte copies for the operator, the IQ
};

// How a call is cut: (column tiles, pixel blocks, row tiles) output tiles,
// and the channels split into `parts` groups so that the grid holds about
// kTargetBlocks thread blocks (see the header).
constexpr int kTargetBlocks = 1024;
constexpr int kMaxParts = 4;

struct BfGrid {
  int col_tiles, row_tiles, parts;
  // output tiles of one pixel block
  long long tiles() const { return (long long)col_tiles * row_tiles; }
};

BfGrid bf_grid(int batch, int n_c, int n_pb, int bp, int n_f) {
  BfGrid g;
  g.col_tiles = (batch * n_f + kBfCols - 1) / kBfCols;
  g.row_tiles = (bp + kBfRows - 1) / kBfRows;
  // the groups are counted from one column tile, never from the batch:
  // an acquisition's sums then run in the same order in any batch
  const long long base = (long long)g.row_tiles * n_pb;
  long long parts = base > 0 ? (kTargetBlocks + base - 1) / base : 1;
  if (parts > kMaxParts) parts = kMaxParts;
  if (parts > n_c) parts = n_c;
  if (g.row_tiles > 0 && parts > kMaxGridYZ / g.row_tiles)
    parts = kMaxGridYZ / g.row_tiles;
  g.parts = parts < 1 ? 1 : (int)parts;
  return g;
}

// The kept slots of one pixel block, as q = c * K + k in ascending order:
// slot 0 of every channel, and slot k > 0 where its column is above slot
// k - 1's (the padded slots repeat column 0 after the occupied ones).
struct Walk {
  const int* cols;
  int n_pb, K, n_q, i;

  __device__ int col(int q) const {
    const int c = q / K;
    return __ldg(cols + ((size_t)c * n_pb + i) * K + (q - c * K));
  }
  __device__ bool kept(int q) const {
    return q % K == 0 || col(q) > col(q - 1);
  }
  __device__ int next(int q) const {  // the first kept slot >= q, or n_q
    while (q < n_q && !kept(q)) ++q;
    return q;
  }
};

template <int P>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (P == PREC_BF16) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

template <int P>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (P == PREC_BF16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// One staged unit's product into part (warp tile: kMT m16 tiles of 8
// pixels' re and im rows, kNT n8 tiles of columns). a_s [kBfRows][kLdA]
// and x_s [kBfS][kLdX] complex; sv valid samples (the rest are zero).
template <int P>
__device__ __forceinline__ void unit_product(float (&part)[kMT][kNT][4],
                                             const float2* a_s,
                                             const float2* x_s, int sv,
                                             int wm, int wn, int g, int t) {
  constexpr int kLdX = BfCfg<P>::kLdX;
  if constexpr (P == PREC_F32) {
    // m16n8k8: k = t is sample 4kk + t / 2, component t % 2; k = t + 4 is
    // two samples on
    const int ic = t & 1;
    const float* xf = reinterpret_cast<const float*>(x_s);
    for (int kk = 0; kk < (sv + 3) / 4; ++kk) {
      tf32::FragA fa[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float2* ar =
            a_s + ((wm * kMT + mt) * 8 + g) * kLdA + 4 * kk + (t >> 1);
        const float2 v0 = ar[0], v1 = ar[2];
        fa[mt] = tf32::frag_a(ic ? -v0.y : v0.x, ic ? v0.x : v0.y,
                              ic ? -v1.y : v1.x, ic ? v1.x : v1.y);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* xr =
            xf + ((4 * kk + (t >> 1)) * kLdX + (wn * kNT + nt) * 8 + g) * 2 +
            ic;
        const tf32::FragB fb = tf32::frag_b(xr[0], xr[4 * kLdX]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) tf32::mma3(part[mt][nt], fa[mt], fb);
      }
    }
  } else {
    // m16n8k16: k = 2t, 2t + 1 are sample 8kk + t (re, im); k + 8 is four
    // samples on
    for (int kk = 0; kk < (sv + 7) / 8; ++kk) {
      uint32_t fa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float2* ar =
            a_s + ((wm * kMT + mt) * 8 + g) * kLdA + 8 * kk + t;
        const float2 v0 = ar[0], v1 = ar[4];
        fa[mt][0] = pack<P>(v0.x, -v0.y);
        fa[mt][1] = pack<P>(v0.y, v0.x);
        fa[mt][2] = pack<P>(v1.x, -v1.y);
        fa[mt][3] = pack<P>(v1.y, v1.x);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float2* xr =
            x_s + (8 * kk + t) * kLdX + (wn * kNT + nt) * 8 + g;
        const float2 w0 = xr[0], w1 = xr[4 * kLdX];
        const uint32_t b0 = pack<P>(w0.x, w0.y), b1 = pack<P>(w1.x, w1.y);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          mma16<P>(part[mt][nt], fa[mt], b0, b1);
      }
    }
  }
}

// grid: (column tiles, pixel blocks, channel groups x row tiles)
template <int P>
__global__ void __launch_bounds__(kBfThreads, 1)
bsr_beamform_kernel(const BfArgs p) {
  using C = BfCfg<P>;
  extern __shared__ __align__(16) float2 ring[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int n_cols = p.batch * p.n_f;
  const int j0 = blockIdx.x * kBfCols;
  const int i = blockIdx.y;
  const int row_tiles = gridDim.z / p.parts;
  const int part = blockIdx.z / row_tiles;   // channel group
  const int r0 = (blockIdx.z - part * row_tiles) * kBfRows;
  const int rows = min(kBfRows, p.bp - r0);
  const int n_sc = (p.bs + kBfS - 1) / kBfS;
  const int c_end = (part + 1) * p.n_c / p.parts;
  const Walk walk{p.cols, p.n_pb, p.K, c_end * p.K, i};
  const size_t x_row = (size_t)p.n_c * p.n_f;  // one sample's IQ row

  // this thread's IQ column (pair): offset of its acquisition and frame
  const int jj = p.x16 ? 2 * (tid & 63) : (tid & 127);
  const int j = j0 + jj;
  const bool col_ok = j < n_cols;
  const int jb = col_ok ? j / p.n_f : 0;
  const size_t x_col =
      (size_t)jb * p.n_sb * p.bs * x_row + (col_ok ? j - jb * p.n_f : 0);

  auto stage = [&](int q, int sc, int st) {
    float2* a_s = ring + st * C::kStage;
    float2* x_s = a_s + kBfRows * kLdA;
    const int c = q / p.K;
    const size_t slot = ((size_t)c * p.n_pb + i) * p.K + (q - c * p.K);
    const int sb = __ldg(p.cols + slot);
    const int s0 = sc * kBfS;
    const int sv = min(kBfS, p.bs - s0);
    const float2* blk = p.blocks + (slot * p.bp + r0) * p.bs + s0;
    const float2* xb = p.x + x_col + ((size_t)sb * p.bs + s0) * x_row +
                       (size_t)c * p.n_f;
    if (p.a16) {
      const int s = 2 * (tid & 31);
#pragma unroll
      for (int e = 0; e < kBfRows * kBfS / 2 / kBfThreads; ++e) {
        const int r = (tid >> 5) + kBfThreads / 32 * e;
        const bool ok = r < rows && s < sv;
        tf32::cp_async16(a_s + r * kLdA + s,
                         ok ? blk + (size_t)r * p.bs + s : p.blocks, ok);
      }
    } else {
      const int s = tid & 63;
#pragma unroll
      for (int e = 0; e < kBfRows * kBfS / kBfThreads; ++e) {
        const int r = (tid >> 6) + kBfThreads / 64 * e;
        const bool ok = r < rows && s < sv;
        tf32::cp_async8(a_s + r * kLdA + s,
                        ok ? blk + (size_t)r * p.bs + s : p.blocks, ok);
      }
    }
    if (p.x16) {
#pragma unroll
      for (int e = 0; e < kBfS * kBfCols / 2 / kBfThreads; ++e) {
        const int s = (tid >> 6) + kBfThreads / 64 * e;
        const bool ok = col_ok && s < sv;
        tf32::cp_async16(x_s + s * C::kLdX + jj, ok ? xb + s * x_row : p.x,
                         ok);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kBfS * kBfCols / kBfThreads; ++e) {
        const int s = (tid >> 7) + kBfThreads / 128 * e;
        const bool ok = col_ok && s < sv;
        tf32::cp_async8(x_s + s * C::kLdX + jj, ok ? xb + s * x_row : p.x,
                        ok);
      }
    }
  };

  float acc[kMT][kNT][4] = {};
  int lq = walk.next(part * p.n_c / p.parts * p.K), lsc = 0;  // loading
  int q = lq, sc = 0;  // the unit being multiplied
  int st = 0;
  if (lq < walk.n_q) stage(lq, lsc, st);
  tf32::cp_async_commit();
  while (q < walk.n_q) {
    if (lq < walk.n_q) {
      if (++lsc == n_sc) {
        lsc = 0;
        lq = walk.next(lq + 1);
      }
      if (lq < walk.n_q) stage(lq, lsc, st ^ 1);
    }
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();  // this unit's copies have landed
    __syncthreads();
    float part[kMT][kNT][4] = {};
    const float2* a_s = ring + st * C::kStage;
    unit_product<P>(part, a_s, a_s + kBfRows * kLdA,
                    min(kBfS, p.bs - sc * kBfS), wm, wn, g, t);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    __syncthreads();  // every warp is done with this stage
    if (++sc == n_sc) {
      sc = 0;
      q = walk.next(q + 1);
    }
    st ^= 1;
  }
  tf32::cp_async_wait<0>();

  // c0, c1: re of pixel row g, columns 2t, 2t + 1; c2, c3: their im
  if (p.parts == 1) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = (wm * kMT + mt) * 8 + g;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jo = j0 + (wn * kNT + nt) * 8 + 2 * t + h;
          if (jo >= n_cols) continue;
          const int b = jo / p.n_f;
          const int f = jo - b * p.n_f;
          p.out[(((size_t)b * p.n_pb + i) * p.bp + r0 + r) * p.n_f + f] =
              make_float2(acc[mt][nt][h], acc[mt][nt][2 + h]);
        }
      }
    }
    return;
  }

  // Channel groups: each writes its sums to its own partial tile; the
  // block that arrives last adds the groups' tiles in ascending order and
  // writes the output. Only the arrival count is atomic, never a sum, so
  // the result is the same whichever block comes last.
  const size_t tile = ((size_t)blockIdx.y * row_tiles +
                       (blockIdx.z - part * row_tiles)) * gridDim.x +
                      blockIdx.x;
  const size_t n_tiles = (size_t)gridDim.x * gridDim.y * row_tiles;
  constexpr int kTile = kBfRows * kBfCols;
  float2* mine = p.partials + ((size_t)part * n_tiles + tile) * kTile;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int r = (wm * kMT + mt) * 8 + g;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = (wn * kNT + nt) * 8 + 2 * t;
      *reinterpret_cast<float4*>(mine + r * kBfCols + n) =
          make_float4(acc[mt][nt][0], acc[mt][nt][2], acc[mt][nt][1],
                      acc[mt][nt][3]);
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    last = atomicAdd(p.arrivals + tile, 1u) == (unsigned)(p.parts - 1);
    if (last) p.arrivals[tile] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // two output columns (a float4) per thread and step, every group's
  // values in flight at once
  const float4* first =
      reinterpret_cast<const float4*>(p.partials + tile * kTile);
  const size_t group = n_tiles * kTile / 2;  // float4 from group to group
#pragma unroll 4
  for (int e = tid; e < kTile / 2; e += kBfThreads) {
    float4 v[kMaxParts];
#pragma unroll
    for (int h = 0; h < kMaxParts; ++h)
      if (h < p.parts) v[h] = __ldcg(first + h * group + e);
    float4 sum = v[0];
#pragma unroll
    for (int h = 1; h < kMaxParts; ++h) {
      if (h < p.parts) {
        sum.x += v[h].x;
        sum.y += v[h].y;
        sum.z += v[h].z;
        sum.w += v[h].w;
      }
    }
    const int r = 2 * e / kBfCols;
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jo = j0 + 2 * e - r * kBfCols + h;
      if (jo >= n_cols) continue;
      const int b = jo / p.n_f;
      const int f = jo - b * p.n_f;
      p.out[(((size_t)b * p.n_pb + i) * p.bp + r0 + r) * p.n_f + f] =
          h ? make_float2(sum.z, sum.w) : make_float2(sum.x, sum.y);
    }
  }
}

template <int P>
cudaError_t launch_beamform(const BfArgs& a, dim3 grid, cudaStream_t s) {
  using C = BfCfg<P>;
  cudaError_t err = cudaFuncSetAttribute(
      bsr_beamform_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kShared);
  if (err != cudaSuccess) return err;
  bsr_beamform_kernel<P><<<grid, kBfThreads, C::kShared, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" int bsr_spmm_launch(const void* cols, const void* blocks,
                               const void* x, void* y, int n_pb, int K,
                               int bp, int bs, int n_sb, int nf,
                               int precision, int device, void* stream) {
  (void)n_sb;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = spmm_shared_bytes(bs);
  // The one check of what this kernel takes: the caller raises on it.
  const int row_tiles = (bp + kTileRows - 1) / kTileRows;
  if (smem > kMaxShared || n_pb > kMaxGridYZ || row_tiles > kMaxGridYZ ||
      nf < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nf + kTileCols - 1) / kTileCols, n_pb, row_tiles);
  cudaStream_t s = (cudaStream_t)stream;
  const int* c = (const int*)cols;
  const float* a = (const float*)blocks;
  const float* xv = (const float*)x;
  float* out = (float*)y;
  switch (precision) {
#define BSR_CASE(PREC)                                                     \
  case PREC:                                                               \
    err = cudaFuncSetAttribute(bsr_spmm_kernel<PREC>,                      \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                                 \
    if (err != cudaSuccess) return (int)err;                               \
    bsr_spmm_kernel<PREC><<<grid, kThreads, smem, s>>>(c, a, xv, out, n_pb, \
                                                       K, bp, bs, nf);     \
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

// The workspace a call needs: float2 values of partial tiles (0 when the
// channels are not split) and arrival counters (zeroed once, by the
// caller; each call leaves them zero).
extern "C" long long bsr_beamform_partials(int batch, int n_c, int n_pb,
                                           int bp, int n_f) {
  const BfGrid g = bf_grid(batch, n_c, n_pb, bp, n_f);
  return g.parts == 1 ? 0
                      : (long long)g.parts * g.tiles() * n_pb * kBfRows *
                            kBfCols;
}

extern "C" long long bsr_beamform_arrivals(int batch, int n_c, int n_pb,
                                           int bp, int n_f) {
  return bf_grid(batch, n_c, n_pb, bp, n_f).tiles() * n_pb;
}

extern "C" int bsr_beamform_launch(const void* cols, const void* blocks,
                                   const void* iq, void* out, void* partials,
                                   long long n_partials, void* arrivals,
                                   long long n_arrivals, int batch, int n_c,
                                   int n_pb, int K, int bp, int bs, int n_sb,
                                   int n_f, int precision, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // The one check of what this kernel takes: the caller raises on it.
  const BfGrid g = bf_grid(batch, n_c, n_pb, bp, n_f);
  if (n_pb > kMaxGridYZ || g.row_tiles > kMaxGridYZ || batch * n_f < 1 ||
      bs < 1 ||
      n_partials < bsr_beamform_partials(batch, n_c, n_pb, bp, n_f) ||
      n_arrivals < g.tiles() * n_pb) {
    return (int)cudaErrorInvalidValue;
  }
  const BfArgs a{(const int*)cols, (const float2*)blocks,
                 (const float2*)iq, (float2*)out, (float2*)partials,
                 (unsigned*)arrivals,
                 batch, n_c, n_pb, K, bp, bs, n_sb, n_f, g.parts,
                 bs % 2 == 0 && aligned16(blocks),
                 n_f % 2 == 0 && aligned16(iq)};
  const dim3 grid(g.col_tiles, n_pb, g.row_tiles * g.parts);
  cudaStream_t s = (cudaStream_t)stream;
  switch (precision) {
    case PREC_F32:
      return (int)launch_beamform<PREC_F32>(a, grid, s);
    case PREC_BF16:
      return (int)launch_beamform<PREC_BF16>(a, grid, s);
    case PREC_F16:
      return (int)launch_beamform<PREC_F16>(a, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
