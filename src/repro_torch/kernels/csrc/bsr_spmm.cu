// Block-sparse (BSR) products for Hopper (sm_90a): the sparse variant's
// beamform, and the real primitive it is built from.
//
// Replaces bsr_spmm_pallas (src/repro/kernels/bsr_spmm/kernel.py:51). The
// TPU kernel walks a (pixel block, K) grid with K sequential on one core,
// one dense (bp x bs) @ (bs x nf) MXU product per step, accumulated in the
// output tile; the reference's bsr_beamform (ops.py) vmaps it over the
// channels, four real SpMMs each, and sums the channels afterwards.
//
// Two entries:
//   bsr_spmm_launch     — the real primitive with the TPU kernel's
//                         signature, (cols, blocks, x) -> y, any columns;
//                         every stored slot is summed. Tensor cores, wgmma.
//   bsr_beamform_launch — the complex multi-channel beamform in ONE
//                         launch, on the tensor cores (mma.sync); the
//                         per-channel partial results are never written (at
//                         batch 4 and the paper's geometry they would be
//                         1.07 GB).
//
// bsr_spmm computes y[i] = sum_k blocks[i, k] @ x[cols[i, k]] over every
// stored slot, whatever its column (repeated, descending, padding at
// column 0): a non-finite x at a padded slot's column reaches y, as in
// the reference. Bounds (H100: 3.35 TB/s, 495 TFLOP/s TF32), each over
// the stored slots the kernel sums and over the occupied blocks:
//   (a) one channel's real part at the paper's geometry: n_pb 256, K 2,
//       bp = bs = 64, n_sb 6, nf 128 (batch 4 x 32 frames). Stored:
//       8.39 MB of operator, 0.20 MB of x, 8.39 MB of y: 0.0051 ms by
//       bytes; 0.54 GFLOP, as 3xTF32 0.0033 ms.
//   (b) the sparse beamform's real form (each complex block as
//       [[re, -im], [im, re]], columns (channel, sample block); ref.py's
//       real_form): n_pb 256, K 128, bp = bs = 128, x (384, 128, 128).
//       Stored: 2.147 GB of operator, 25.2 MB of x, 16.8 MB of y:
//       0.653 ms by bytes; 137.4 GFLOP, as 3xTF32 0.833 ms (operations).
//       Occupied: 63.2 GFLOP, 0.383 ms.
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/bsr_spmm_compare.py):
// (a) 0.016 ms, (b) 1.39 ms at f32, 1.11 ms at bf16. What holds (b): the
// loads and splits alone take 1.01 ms (the products left out), the 3xTF32
// products need 0.833 ms at the tensor cores' peak; x's rows are as large
// as the operator's block there, so 4.3 GB cross from L2. What holds (a): each block's x rows are
// twice its operator bytes, its units come in two rounds of load latency,
// and the launch itself is a few microseconds of the 16.
// Design of bsr_spmm:
// - wgmma, the product transposed (y^T = x^T blocks^T): TF32 wgmma takes
//   its shared-memory operands K-major only. The operator block is
//   K-major as it lies (samples contiguous), so it is the B operand, read
//   by descriptor from a 128-byte-swizzled tile; x's rows (columns
//   contiguous) are not, so they are the A operand, which wgmma takes from
//   registers in the mma fragment layout (ld.shared, no transpose).
// - A thread block owns one pixel block's rows (N = 64 pixel rows where
//   bp <= 64, else tiles of 128) and all nf output columns up to 128
//   (tiles of 128 beyond that), so every operator block crosses the SMs
//   once per 128 columns (the SIMT kernel it replaced read it once per 32).
//   At N = 64 two blocks share an SM, so (a)'s 256 blocks run in one
//   wave; their multiplying warps then hold one half of a unit's
//   fragments at a time.
// - Warp specialization: warp group 0 fills a ring of 4 (N = 128) or 3
//   (N = 64) stages, each a unit (slot k, chunk of 32 samples): the
//   operator's N x 32 tile and x's 32 x 128 rows at the slot's column,
//   read from cols one unit ahead (the counterpart of the TPU kernel's
//   scalar prefetch). One thread issues them as TMA boxes in the 128-byte
//   swizzle (zeros past bp, bs and nf), where the tensors' row strides
//   allow (bs and nf multiples of 4), else the warp group copies them by
//   cp.async into the same layout. Warp group 0 then splits the landed tile
//   (below) and hands it over by mbarrier; warp groups 1 and 2, 64 output
//   columns each, take their A fragments and issue the unit's wgmma.
//   Loads, splits and products of different units overlap; with the
//   copies, the split and the products in the same warps nothing did
//   (the first version: 2.45 ms at (b), the sum of its loads, split and
//   products measured apart). Having L2 fetch each next slot's rows
//   whole, or giving the operator and x eviction priorities, measured
//   no faster.
//   setmaxnreg moves registers from the loading warps to the
//   multiplying ones, whose sums and fragments take ~190 a thread.
// - f32 is 3xTF32 (tf32::split, hi and lo each rounded to nearest): lo x
//   hi, hi x lo, hi x hi. x's values are split in registers as a thread
//   loads its fragment; the operator tile is split once, hi in place and
//   lo beside it, where the tensor cores read B. Each unit's product is
//   summed from zero (scale-d 0) and then added to the f32 sums, rounded
//   to nearest: the tensor cores truncate as they add, so a long sum is
//   kept out of one accumulator. (Taking hi as the raw f32, which TF32
//   reads truncated, and summing a whole slot in one accumulator ran
//   1.25 ms at (b) against 1.39, with the f32 error against float64 at
//   (a) 9.8x the plain version's against 3.2x: tools/bsr_spmm_compare.py
//   --variant "raw hi, slot sums".)
// - bf16/f16: both operands rounded to P (round_operand, as the plain
//   version rounds them), then ONE TF32 product: a bf16 or f16 value is
//   exact in TF32, so the products are exact, as native 16-bit products
//   would be, and the sums f32. Native 16-bit wgmma would need the
//   operator converted into a second tile layout for half the product
//   time; the f32 operator's bytes bound both shapes at 16 bits (at (b)
//   the single TF32 pass is 0.28 ms against 0.653 ms of bytes).
// - Every stored slot is staged and multiplied, in order; no atomics and
//   no split of the slots across thread blocks: two runs are
//   bit-identical. Rows past bp, samples past bs and columns past nf are
//   staged as zeros and never stored.
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
// like a row whose one block sits at column 0. The wrapper (ops.py)
// checks an operator on the device before its first use and refuses one
// outside this format; such operators go through bsr_spmm, which sums
// every slot.
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
// Limits: bsr_beamform's grid axes (n_pb and the 64-row tiles of bp each
// at most 65535); bsr_spmm's row tiles and 128-column tiles each at most
// 65535, and n_pb, bp, bs, nf at least 1. Refused, not mis-computed: the
// entry returns cudaErrorInvalidValue.

#include <cuda.h>   // CUtensorMap; its encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "das_common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr size_t kMaxShared = 232448;  // the most a block may use (H100)
constexpr int kMaxGridYZ = 65535;

// ---------------------------------------------------------------------
// bsr_spmm: real, every stored slot, on the tensor cores by wgmma.
//
// The product is taken transposed, y[i]^T = sum_k x[cols[i,k]]^T
// blocks[i,k]^T, so that each operand lies as TF32 wgmma wants it: the
// operator block (bp x bs, samples contiguous) is the K-major B operand in
// shared memory, and x's rows (samples x columns, columns contiguous) are
// the A operand, which wgmma takes from registers in any layout. Each
// thread block is one (pixel block, row tile of N = 64 or 128 rows,
// 128-column tile); warp group 0 loads and splits the units (slot k,
// chunk of 32 samples) into a ring, and warp groups 1 and 2 multiply,
// 64 output columns each, their sums in registers.

constexpr int kChunk = 32;       // samples a unit: one 128-byte row of B
constexpr int kColTile = 128;    // output columns of a thread block
constexpr int kGroupCols = 64;   // of a warp group (wgmma's M)
constexpr int kXBox = 32;        // x columns of one 128-byte-swizzled box
constexpr int kXBoxFloats = kChunk * kXBox;   // 4 KB

template <int N>
struct SpCfg {
  // N = 64: two blocks an SM, so that the paper's 256 pixel blocks run in
  // one wave; N = 128: one
  static constexpr int kMinBlocks = N == 128 ? 1 : 2;
  static constexpr int kStages = N == 128 ? 4 : 3;
  // registers a thread: the loading warp group gives up what the
  // multiplying ones take, within the block's share at launch (384
  // threads x 168, or x 80 at two blocks an SM); at N = 64 a unit's
  // k-steps go in 2 groups, one group's fragments held at a time
  static constexpr int kLoadRegs = N == 128 ? 104 : 32;
  static constexpr int kMmaRegs = N == 128 ? 200 : 104;
  static constexpr int kGroups = N == 128 ? 1 : 2;
  static_assert(128 * kLoadRegs + 256 * kMmaRegs <=
                    384 * (kMinBlocks == 1 ? 168 : 80),
                "registers past the block's");
  static constexpr int kBBytes = N * kChunk * 4;      // a B tile, 128B rows
  static constexpr int kXBytes = kChunk * kColTile * 4;
  // [B hi | B lo | x in 4 boxes of 32 columns], each 1024-byte aligned
  // for the 128-byte swizzle
  static constexpr int kStageBytes = 2 * kBBytes + kXBytes;
  // + 3 mbarriers a stage, + alignment slack
  static constexpr size_t kShared =
      (size_t)kStages * kStageBytes + 3 * 8 * kStages + 1024;
  static_assert(kStageBytes % 1024 == 0, "tiles off the swizzle atom");
  static_assert(kShared <= kMaxShared, "ring past shared memory");
};

struct SpArgs {
  const int* cols;
  const float* blocks;
  const float* x;
  float* y;
  int n_pb, K, bp, bs, nf;
  int tma;        // tiles by TMA (else cp.async: 16-byte copies where a16,
  int a16, x16;   // x16, else 4-byte ones)
};

// wgmma m64nNk8, TF32 operands, f32 sums: A (4 registers a thread) from
// registers, B by descriptor; scale_d 0 discards d's old values.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


// Shared-memory matrix descriptor of a K-major B tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused in this mode.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (N == 128) {
    wgmma_tf32_n128(d, a, desc, scale_d);
  } else {
    wgmma_tf32_n64(d, a, desc, scale_d);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The shared-memory writes of this thread (the split) become visible to
// the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep a register live, unmoved, up to this point: wgmma reads its A
// operand and writes its sums asynchronously, until wgmma_wait_all.
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// mbarriers in shared memory (CTA scope).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   saddr(bar))
               : "memory");
}
// One arrival that also expects `bytes` from TMA copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}
// One arrival on bar once every cp.async this thread issued so far has
// landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   saddr(bar))
               : "memory");
}
// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}
// A 3-D box of a tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(saddr(bar))
      : "memory");
}
// Float offset of x's (sample s, column c) in a stage's x tile: boxes of
// 32 columns, each 32 rows of 128 bytes in the 128-byte swizzle (the
// 16-byte chunk c / 4 of row s stored at chunk (c / 4) ^ (s % 8)).
__device__ __forceinline__ int x_at(int s, int c) {
  return (c >> 5) * kXBoxFloats + s * kXBox +
         ((((c & 31) >> 2) ^ (s & 7)) << 2) + (c & 3);
}

// grid: (pixel blocks, row tiles of N, column tiles of 128). Warp group 0
// loads and splits; warp groups 1 (and 2) multiply, 64 columns each.
template <int N, int P>
__global__ void __launch_bounds__(3 * 128, SpCfg<N>::kMinBlocks)
bsr_spmm_kernel(const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_x, const SpArgs p) {
  using C = SpCfg<N>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(1024) unsigned char spmm_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(spmm_raw) + 1023) & ~uintptr_t(1023));
  // per stage: loaded (the copies landed), full (split, ready for the
  // tensor cores), empty (the multiplying warp groups are done with it)
  uint64_t* loaded = reinterpret_cast<uint64_t*>(smem + S * C::kStageBytes);
  uint64_t* full = loaded + S;
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;
  const int n_mma = blockDim.x / 128 - 1;       // multiplying warp groups
  const int i = blockIdx.x;
  const int r0 = blockIdx.y * N;
  const int rows = min(N, p.bp - r0);
  const int j0 = blockIdx.z * kColTile;
  const int tile_cols = kGroupCols * n_mma;
  const int cv = min(tile_cols, p.nf - j0);     // valid columns
  const int n_chunks = (p.bs + kChunk - 1) / kChunk;
  const int n_units = p.K * n_chunks;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(loaded + s, p.tma ? 1 : 128);
      mbar_init(full + s, 128);
      mbar_init(empty + s, 128 * n_mma);
    }
  }
  __syncthreads();

  if (tid < 128) {
    // ---- loads and splits (warp group 0) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kLoadRegs));
    auto col = [&](int u) {
      return u < n_units ? __ldg(p.cols + (size_t)i * p.K + u / n_chunks)
                         : 0;
    };
    // Unit u = (slot k, chunk) into its stage: the operator's N x 32
    // tile, swizzled, and x's 32 rows at the slot's column sb (read one
    // unit ahead). Rows past bp, samples past bs and columns past nf
    // land as zeros.
    auto load = [&](int u, int sb) {
      const int st = u % S;
      const int k = u / n_chunks;
      const int s0 = (u - k * n_chunks) * kChunk;
      const size_t slot = (size_t)i * p.K + k;
      float* b_s = reinterpret_cast<float*>(smem + st * C::kStageBytes);
      float* x_s = reinterpret_cast<float*>(smem + st * C::kStageBytes +
                                            2 * C::kBBytes);
      if (p.tma) {
        if (tid != 0) return;
        const int boxes = (cv + kXBox - 1) / kXBox;
        mbar_expect(loaded + st, C::kBBytes + boxes * kXBoxFloats * 4);
        tma_load(b_s, &map_b, s0, r0, (int)slot, loaded + st);
        for (int q = 0; q < boxes; ++q) {
          tma_load(x_s + q * kXBoxFloats, &map_x, j0 + q * kXBox, s0, sb,
                   loaded + st);
        }
        return;
      }
      const int sv = min(kChunk, p.bs - s0);
      const float* blk = p.blocks + (slot * p.bp + r0) * p.bs + s0;
      const float* xb = p.x + ((size_t)sb * p.bs + s0) * p.nf + j0;
      if (p.a16) {
        for (int e = tid; e < N * kChunk / 4; e += 128) {
          const int r = e >> 3, c = e & 7;
          const bool ok = r < rows && 4 * c < sv;
          tf32::cp_async16(b_s + r * kChunk + ((c ^ (r & 7)) << 2),
                           ok ? blk + (size_t)r * p.bs + 4 * c : p.blocks,
                           ok);
        }
      } else {
        for (int e = tid; e < N * kChunk; e += 128) {
          const int r = e >> 5, s = e & 31;
          const bool ok = r < rows && s < sv;
          tf32::cp_async4(
              b_s + r * kChunk + (((s >> 2) ^ (r & 7)) << 2) + (s & 3),
              ok ? blk + (size_t)r * p.bs + s : p.blocks, ok);
        }
      }
      if (p.x16) {
        const int shift = n_mma == 2 ? 5 : 4;   // 16-byte copies a row
        for (int e = tid; e < kChunk << shift; e += 128) {
          const int s = e >> shift, c = 4 * (e & ((1 << shift) - 1));
          const bool ok = s < sv && c < cv;
          tf32::cp_async16(x_s + x_at(s, c),
                           ok ? xb + (size_t)s * p.nf + c : p.x, ok);
        }
      } else {
        for (int e = tid; e < kChunk * tile_cols; e += 128) {
          const int s = e / tile_cols, c = e % tile_cols;
          const bool ok = s < sv && c < cv;
          tf32::cp_async4(x_s + x_at(s, c),
                          ok ? xb + (size_t)s * p.nf + c : p.x, ok);
        }
      }
      mbar_arrive_on_copies(loaded + st);
    };
    for (int u = 0; u < S - 1 && u < n_units; ++u) load(u, col(u));
    int sb_next = col(S - 1);
    for (int u = 0; u < n_units; ++u) {
      const int st = u % S;
      mbar_wait(loaded + st, (u / S) & 1);
      // The operator tile as the tensor cores read it: at f32 split into
      // TF32 hi parts, in place, and lo parts beside them (tf32::split);
      // at bf16/f16 rounded to P in place (exact in TF32).
      float4* hi = reinterpret_cast<float4*>(smem + st * C::kStageBytes);
      float4* lo = reinterpret_cast<float4*>(smem + st * C::kStageBytes +
                                             C::kBBytes);
#pragma unroll
      for (int q = 0; q < N / 16; ++q) {
        const int e = tid + 128 * q;
        const float4 v = hi[e];
        if constexpr (P == PREC_F32) {
          const tf32::Split a = tf32::split(v.x), b = tf32::split(v.y),
                            c = tf32::split(v.z), d = tf32::split(v.w);
          hi[e] = make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                              __uint_as_float(c.hi), __uint_as_float(d.hi));
          lo[e] = make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                              __uint_as_float(c.lo), __uint_as_float(d.lo));
        } else {
          hi[e] = make_float4(round_operand<P>(v.x), round_operand<P>(v.y),
                              round_operand<P>(v.z), round_operand<P>(v.w));
        }
      }
      fence_proxy_async();   // the tensor cores read what this thread wrote
      mbar_arrive(full + st);
      // then the loads of unit u + S - 1, into the stage of unit u - 1
      const int v = u + S - 1;
      if (v < n_units) {
        if (v >= S && (tid == 0 || !p.tma)) {
          mbar_wait(empty + v % S, (v / S - 1) & 1);
        }
        load(v, sb_next);
        sb_next = col(v + 1);
      }
    }
    return;
  }

  // ---- products (warp groups 1 and 2) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kMmaRegs));
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's output column (a0's row of x^T), within the tile, and
  // where a0 (m, t), a1 (m + 8, t), a2 (m, t + 4), a3 (m + 8, t + 4) of a
  // k-step lie in the x tile
  const int m = (tid / 128 - 1) * kGroupCols + ((tid >> 5) & 3) * 16 + g;
  const int a_off[4] = {x_at(t, m), x_at(t, m + 8), x_at(t + 4, m),
                        x_at(t + 4, m + 8)};
  float acc[N / 2], part[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = part[e] = 0.0f;
  for (int u = 0; u < n_units; ++u) {
    const int st = u % S;
    mbar_wait(full + st, (u / S) & 1);
    const uint32_t b_hi = saddr(smem + st * C::kStageBytes);
    const float* x_s = reinterpret_cast<const float*>(
        smem + st * C::kStageBytes + 2 * C::kBBytes);
    // k-step kk is rows 8 kk.. of the tile: the swizzle of row s depends
    // on s % 8 only, so its offsets are a_off moved by 8 kk rows
    // the unit's product summed from zero (scale-d 0 at its first), the
    // small terms first: lo x hi, hi x lo, hi x hi; its k-steps issued in
    // C::kGroups groups, each group's fragments loaded just before it
    // (N = 64 holds one group's fragments at a time)
    constexpr int kSteps = 4 / C::kGroups;
#pragma unroll
    for (int grp = 0; grp < C::kGroups; ++grp) {
      uint32_t ah[kSteps][4], al[kSteps][4];
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = x_s[a_off[q] + 8 * (grp * kSteps + ks) * kXBox];
          if constexpr (P == PREC_F32) {
            const tf32::Split sp = tf32::split(v);
            ah[ks][q] = sp.hi;
            al[ks][q] = sp.lo;
          } else {
            ah[ks][q] = __float_as_uint(round_operand<P>(v));
          }
        }
      }
#pragma unroll
      for (int e = 0; e < N / 2; ++e) keep(part[e]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int kk = grp * kSteps + ks;
        const int fresh = kk == 0 ? 0 : 1;
        const uint64_t dh = sw128_desc(b_hi + 32 * kk);
        if constexpr (P == PREC_F32) {
          const uint64_t dl = sw128_desc(b_hi + C::kBBytes + 32 * kk);
          wgmma_tf32<N>(part, al[ks], dh, fresh);
          wgmma_tf32<N>(part, ah[ks], dl, 1);
          wgmma_tf32<N>(part, ah[ks], dh, 1);
        } else {
          wgmma_tf32<N>(part, ah[ks], dh, fresh);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          keep(ah[ks][q]);
          if constexpr (P == PREC_F32) keep(al[ks][q]);
        }
#pragma unroll
      for (int e = 0; e < N / 2; ++e) keep(part[e]);
    }
    mbar_arrive(empty + st);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] += part[e];   // into the f32 sums
  }

  // acc[4j + 2h' + h]: column m + 8h', pixel row 8j + 2t + h
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * j + 2 * t + h;
      if (r >= rows) continue;
      float* yr = p.y + ((size_t)i * p.bp + r0 + r) * p.nf + j0;
      if (m < cv) yr[m] = acc[4 * j + h];
      if (m + 8 < cv) yr[m + 8] = acc[4 * j + 2 + h];
    }
  }
}

template <int N, int P>
cudaError_t launch_spmm(const CUtensorMap& map_b, const CUtensorMap& map_x,
                        const SpArgs& a, dim3 grid, int threads,
                        cudaStream_t s) {
  using C = SpCfg<N>;
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_kernel<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kShared);
  if (err != cudaSuccess) return err;
  bsr_spmm_kernel<N, P><<<grid, threads, C::kShared, s>>>(map_b, map_x, a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return (EncodeTiled) nullptr;
    }
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A 3-D f32 tensor (d0 innermost) cut into boxes of (b0, b1, 1) in the
// 128-byte swizzle; what lies outside it is read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, unsigned long long d0,
                unsigned long long d1, unsigned long long d2, unsigned b0,
                unsigned b1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 4, d0 * d1 * 4};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // The one check of what this kernel takes: the caller raises on it.
  const int n = bp <= 64 ? 64 : 128;       // pixel rows of a tile (N)
  const long long row_tiles = ((long long)bp + n - 1) / n;
  const long long col_tiles = ((long long)nf + kColTile - 1) / kColTile;
  if (n_pb < 1 || K < 0 || bp < 1 || bs < 1 || nf < 1 ||
      row_tiles > kMaxGridYZ || col_tiles > kMaxGridYZ) {
    return (int)cudaErrorInvalidValue;
  }
  const int a16 = bs % 4 == 0 && aligned16(blocks);
  const int x16 = nf % 4 == 0 && aligned16(x);
  // The tiles come by TMA where its maps take the tensors (row strides of
  // 16 bytes), else by cp.async; the maps are built here, on the host.
  CUtensorMap map_b, map_x;
  const int tma = a16 && x16 && K > 0 &&
                  tensor_map(&map_b, blocks, bs, bp, (unsigned long long)n_pb * K,
                             kChunk, n) &&
                  tensor_map(&map_x, x, nf, bs, n_sb, kXBox, kChunk);
  const SpArgs a{(const int*)cols, (const float*)blocks, (const float*)x,
                 (float*)y, n_pb, K, bp, bs, nf, tma, a16, x16};
  const dim3 grid(n_pb, (unsigned)row_tiles, (unsigned)col_tiles);
  // a loading warp group, and one multiplying warp group a 64 output
  // columns of the tile
  const int threads =
      (nf < kColTile ? nf : kColTile) > kGroupCols ? 3 * 128 : 2 * 128;
  cudaStream_t s = (cudaStream_t)stream;
  switch (precision * 2 + (n == 128)) {
#define SPMM_CASE(PREC, N)                                          \
  case PREC * 2 + (N == 128):                                       \
    return (int)launch_spmm<N, PREC>(map_b, map_x, a, grid, threads, s);
    SPMM_CASE(PREC_F32, 64)
    SPMM_CASE(PREC_F32, 128)
    SPMM_CASE(PREC_BF16, 64)
    SPMM_CASE(PREC_BF16, 128)
    SPMM_CASE(PREC_F16, 64)
    SPMM_CASE(PREC_F16, 128)
#undef SPMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
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
