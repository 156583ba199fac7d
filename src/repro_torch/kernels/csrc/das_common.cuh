// Delay-and-sum loop shared by das_beamform.cu and fused_pipeline.cu;
// bsr_spmm.cu takes the precision codes and operand rounding from here
// too.
//
// The tiled loop (namespace das). A thread block owns a contiguous run of
// bp pixels of the flat index (a tile; bp in 64 / 128 / 256), a chunk of
// BB acquisitions and 32 frames: lane f is frame f, and each of the 8
// warps owns bp / 8 pixels (tile_pixel). Every thread keeps its
// (pixel, acquisition) sums in registers: bp / 8 x BB = 32 complex values
// (BB = 4, 2, 1 for bp = 64, 128, 256).
//
// - Windows. Before the loop the block reads its tile's idx and apod once
//   and finds, for each channel, the sample rows [lo, hi + 1] that its
//   pixels of non-zero apodization read: a few rows, where a row is one
//   channel's n_f frames of one sample (256 bytes at n_f 32), so a tile
//   stages each IQ row it needs once (chip_smoke.py prints the bytes).
// - Staging. Channels go in groups, in ascending order: as many as fit a
//   stage of kStageRows rows (window x BB per channel) and kTabEntries
//   table entries (bp per channel). A group's IQ rows (16-byte cp.async
//   where rows are 16-byte aligned) and its table entries are copied to
//   shared memory into one of kStages buffers while the block sums the
//   groups before it. A channel whose window x BB exceeds a stage (random
//   delays over all of n_s, say) forms a group alone, and its pixels read
//   IQ straight from global memory: a path of the kernel, same arithmetic.
// - Loop order: groups, channels, pixels, acquisitions. A table entry is
//   read from shared memory once per block, its lerp weights are formed
//   once per (pixel, channel, lane), and each acquisition's two IQ samples
//   are 256-byte rows of shared memory (no bank conflicts).
// - Zero apodization. Warp w owns the runs of kRun pixels w, w + 8, ...
//   (which spreads the pixels of non-zero apodization evenly over the
//   warps); a run whose apod is exactly 0 for a channel is skipped (a
//   warp-uniform branch). For finite IQ and tables a zero term is +-0 and
//   the f32 sum, which starts at +0, does not change. 37 % of the paper's
//   (pixel, channel) pairs are such, and they come in lateral runs, so
//   runs of 2 add few terms to those needed.
// - Reduced precision. bf16 / f16 samples are rounded once, in shared
//   memory, by the thread that staged them, not once per term: the same
//   values, since the rounding of a sample does not depend on the term.
//
// The arithmetic repeats the plain version's expression order (lerp,
// rotate, apodize, add), the build passes -fmad=false, and the channels
// are summed in ascending order in f32 registers, with no atomics: each
// term rounds exactly as in the plain PyTorch version, only the order of
// the channel sum differs from torch's reduction, and two runs are
// bit-equal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"  // cp.async helpers

enum Precision { PREC_F32 = 0, PREC_BF16 = 1, PREC_F16 = 2 };

// Round an f32 operand to the requested precision and back (identity
// at f32): reduced precision casts operands, never the accumulation.
template <int P>
__device__ __forceinline__ float round_operand(float x) {
  if constexpr (P == PREC_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (P == PREC_F16) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

namespace das {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFrames = 32;         // frames per block pass (lane = frame)
constexpr int kStages = 3;          // buffers of the ring of channel groups
constexpr int kStageRows = 88;      // IQ rows of kFrames float2 per buffer
constexpr int kTabEntries = 640;    // (pixel, channel) entries per buffer
constexpr int kRun = 2;             // pixels skipped together (apod all 0)

// bp pixels per tile: kPpw per warp, kBb acquisitions per block, so that
// each thread holds kPpw x kBb = 32 complex sums.
template <int BP>
struct Tile {
  static_assert(BP == 64 || BP == 128 || BP == 256, "bp is 64, 128 or 256");
  static constexpr int kPpw = BP / kWarps;
  static constexpr int kBb = 32 / kPpw;
};

template <int BP>
using Acc = float2[Tile<BP>::kPpw][Tile<BP>::kBb];

// The pixel of the tile whose sums are acc[pp][...] in this thread: warp
// w owns the runs of kRun pixels w, w + 8, w + 16, ..., which spreads the
// pixels of non-zero apodization, and so the work, evenly over the warps.
__device__ __forceinline__ int tile_pixel(int pp) {
  return ((pp / kRun) * kWarps + (int)(threadIdx.x >> 5)) * kRun + pp % kRun;
}

struct Args {
  const int* idx;     // (n_pix, n_c), sample of the lerp's first operand
  const float* frac;  // (n_pix, n_c)
  const float* apod;  // (n_pix, n_c)
  const float2* rot;  // (n_pix, n_c)
  const float2* iq;   // (B, n_s, n_c, n_f)
  int n_pix, n_c, n_s, n_f;
  int n_sm;  // SMs of the device (block_of)
};

// Shared memory, in this order: IQ stage [kStages][kStageRows][kFrames];
// table stage [kStages][kTabEntries] of (rot.x, rot.y, frac, apod), then of idx
// (channel-major: entry (pixel, channel) at channel * bp + pixel, one
// 16-byte and one 4-byte load per entry); per channel lo, len (window
// rows) and off (row of its window in the stage); the groups' first
// channels, then n_c; the group count.
struct Smem {
  float2* iq;
  float4* tab;
  int* idx;
  int* lo;
  int* len;
  int* off;
  int* grp;
  int* n_grp;
};

inline size_t smem_bytes(int n_c) {
  return (size_t)kStages * kStageRows * kFrames * sizeof(float2) +
         (size_t)kStages * kTabEntries * (sizeof(float4) + sizeof(int)) +
         (size_t)(4 * n_c + 2) * sizeof(int);
}

__device__ __forceinline__ Smem carve(void* base, int n_c) {
  Smem s;
  s.iq = reinterpret_cast<float2*>(base);
  s.tab = reinterpret_cast<float4*>(s.iq + kStages * kStageRows * kFrames);
  s.idx = reinterpret_cast<int*>(s.tab + kStages * kTabEntries);
  s.lo = s.idx + kStages * kTabEntries;
  s.len = s.lo + n_c;
  s.off = s.len + n_c;
  s.grp = s.off + n_c;
  s.n_grp = s.grp + n_c + 1;
  return s;
}

// A channel too wide for a stage is summed from global memory.
__device__ __forceinline__ bool direct(const Smem& s, int c, int nb) {
  return s.len[c] * nb > kStageRows;
}

// Windows and channel groups of the tile at p0 for nb acquisitions.
template <int BP>
__device__ void plan_tile(const Args& a, const Smem& s, int p0, int nb) {
  const int tid = threadIdx.x;
  for (int c = tid; c < a.n_c; c += kThreads) {
    s.lo[c] = INT_MAX;
    s.len[c] = -1;  // the window's last first-operand row, until below
  }
  __syncthreads();
  const int n = min(BP, a.n_pix - p0) * a.n_c;
  const size_t base = (size_t)p0 * a.n_c;
#pragma unroll 8
  for (int e = tid; e < n; e += kThreads) {
    if (__ldg(a.apod + base + e) != 0.0f) {
      const int i = __ldg(a.idx + base + e);
      atomicMin(s.lo + e % a.n_c, i);
      atomicMax(s.len + e % a.n_c, i);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int g = 0, rows = 0, count = 0;
    bool alone = false;  // the open group is one direct channel
    for (int c = 0; c < a.n_c; ++c) {
      const int hi = s.len[c];
      const int len = hi < 0 ? 0 : hi - s.lo[c] + 2;
      if (hi < 0) s.lo[c] = 0;
      s.len[c] = len;
      const int r = len * nb;
      const bool wide = r > kStageRows;
      if (count == 0 || wide || alone || count == kTabEntries / BP ||
          rows + r > kStageRows) {
        if (count > 0) ++g;
        s.grp[g] = c;
        rows = count = 0;
        alone = wide;
      }
      s.off[c] = rows;
      rows += wide ? 0 : r;
      ++count;
    }
    s.grp[g + 1] = a.n_c;
    s.n_grp[0] = g + 1;
  }
  __syncthreads();
}

// Rows [0, rows) of group g's IQ stage (0 for a direct group).
__device__ __forceinline__ int group_rows(const Smem& s, int g, int nb) {
  const int first = s.grp[g], last = s.grp[g + 1] - 1;
  return direct(s, first, nb) ? 0 : s.off[last] + s.len[last] * nb;
}

// Calls f(row, c, fr) for each IQ row of group g (of channel c) and its
// frames fr, fr + 1 (16-byte pieces, `wide`) or fr alone that this thread
// copies into the stage, and so rounds.
template <typename F>
__device__ __forceinline__ void own_rows(const Smem& s, int g, int nb,
                                         int nfc, bool wide, F&& f) {
  const int lane = threadIdx.x & 31;
  const int per_row = wide ? 16 : 32;  // lanes per row
  const int fr = (lane % per_row) * (wide ? 2 : 1);
  if (fr >= nfc) return;
  const int rows = group_rows(s, g, nb);
  int c = s.grp[g];
  for (int row = (threadIdx.x / per_row); row < rows;
       row += kThreads / per_row) {
    while (row >= s.off[c] + s.len[c] * nb) ++c;
    f(row, c, fr);
  }
}

// Start the copies of group g's tables and IQ windows into buffer buf.
template <int BP>
__device__ void stage_group(const Args& a, const Smem& s, int g, int buf,
                            int p0, int b0, int nb, int f0, int nfc,
                            bool wide) {
  const int first = s.grp[g], n = s.grp[g + 1] - first;
  for (int e = threadIdx.x; e < BP * n; e += kThreads) {
    const int pl = e / n, cc = e - pl * n;
    const int dst = buf * kTabEntries + cc * BP + pl;
    const bool ok = p0 + pl < a.n_pix;  // past the last pixel: zeros
    const size_t src = ok ? (size_t)(p0 + pl) * a.n_c + first + cc : 0;
    float4* e4 = s.tab + dst;
    tf32::cp_async8(&e4->x, a.rot + src, ok);
    tf32::cp_async4(&e4->z, a.frac + src, ok);
    tf32::cp_async4(&e4->w, a.apod + src, ok);
    tf32::cp_async4(s.idx + dst, a.idx + src, ok);
  }
  float2* stage = s.iq + (size_t)buf * kStageRows * kFrames;
  own_rows(s, g, nb, nfc, wide, [&](int row, int c, int fr) {
    const int j = (row - s.off[c]) / s.len[c];
    const int i = s.lo[c] + row - s.off[c] - j * s.len[c];
    const float2* src =
        a.iq + (((size_t)(b0 + j) * a.n_s + i) * a.n_c + c) * a.n_f + f0 + fr;
    if (wide) {
      tf32::cp_async16(stage + row * kFrames + fr, src, true);
    } else {
      tf32::cp_async8(stage + row * kFrames + fr, src, true);
    }
  });
  tf32::cp_async_commit();
}

// bf16 / f16: round the samples this thread staged, once.
template <int P>
__device__ void round_group(const Smem& s, int g, int buf, int nb, int nfc,
                            bool wide) {
  if constexpr (P != PREC_F32) {
    float2* stage = s.iq + (size_t)buf * kStageRows * kFrames;
    own_rows(s, g, nb, nfc, wide, [&](int row, int, int fr) {
      for (int k = 0; k < (wide ? 2 : 1); ++k) {
        float2& v = stage[row * kFrames + fr + k];
        v.x = round_operand<P>(v.x);
        v.y = round_operand<P>(v.y);
      }
    });
  }
}

// Add channel c (entry cc of its group, in buffer buf) to acc.
// - Pixels go in runs of kRun: a run whose apod is 0 throughout is
//   skipped (warp-uniform); in the others every term is computed, a zero
//   one as +-0, which leaves the sum as it is. A zero-apodization pixel's
//   sample index is clamped into the staged window, which spans only the
//   others' (its samples are finite and multiplied by 0).
// - The acquisitions past nb (a ragged last chunk) repeat acquisition
//   nb - 1, so that the loop over them has no branch; their sums are
//   never stored.
template <int P, int BP, bool kDirect>
__device__ __forceinline__ void channel_terms(const Args& a, const Smem& s,
                                              int c, int cc, int buf, int b0,
                                              int nb, int f0, int fl,
                                              Acc<BP>& acc) {
  constexpr int kPpw = Tile<BP>::kPpw, kBb = Tile<BP>::kBb;
  const int lane = threadIdx.x & 31;
  const int t0 = buf * kTabEntries + cc * BP;
  // staged: sample i of acquisition j is row off - lo + j * len + i;
  // direct: row (b0 + j, i, c) of the IQ in global memory
  using Off = std::conditional_t<kDirect, size_t, int>;
  const float2* base;
  Off step, acq[kBb];  // one sample, one acquisition
  const int lo = s.lo[c], hi = lo + s.len[c] - 2;
  if constexpr (kDirect) {
    step = (size_t)a.n_c * a.n_f;
    base = a.iq + (size_t)b0 * a.n_s * step + (size_t)c * a.n_f + f0 + fl;
#pragma unroll
    for (int j = 0; j < kBb; ++j) acq[j] = min(j, nb - 1) * a.n_s * step;
  } else {
    step = kFrames;
    base = s.iq + (buf * kStageRows + s.off[c] - lo) * kFrames + lane;
#pragma unroll
    for (int j = 0; j < kBb; ++j) acq[j] = min(j, nb - 1) * s.len[c] * step;
  }
#pragma unroll
  for (int r = 0; r < kPpw; r += kRun) {
    float4 e[kRun];  // rot.x, rot.y, frac, apod
    int i0[kRun];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      e[k] = s.tab[t0 + tile_pixel(r + k)];
      i0[k] = s.idx[t0 + tile_pixel(r + k)];
      any = any || e[k].w != 0.0f;
    }
    if (!any) continue;  // warp-uniform
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const float w0 = round_operand<P>(1.0f - e[k].z);
      const float w1 = round_operand<P>(e[k].z);
      const int i = kDirect ? i0[k] : min(max(i0[k], lo), hi);
      const float2* q = base + i * step;
#pragma unroll
      for (int j = 0; j < kBb; ++j) {
        float2 s0, s1;
        if constexpr (kDirect) {
          s0 = __ldg(q + acq[j]);
          s1 = __ldg(q + acq[j] + step);
          s0.x = round_operand<P>(s0.x);
          s0.y = round_operand<P>(s0.y);
          s1.x = round_operand<P>(s1.x);
          s1.y = round_operand<P>(s1.y);
        } else {
          s0 = q[acq[j]];
          s1 = q[acq[j] + step];
        }
        const float vr = s0.x * w0 + s1.x * w1;
        const float vi = s0.y * w0 + s1.y * w1;
        const float re = vr * e[k].x - vi * e[k].y;
        const float im = vr * e[k].y + vi * e[k].x;
        float2& z = acc[r + k][j];
        z.x = z.x + re * e[k].w;
        z.y = z.y + im * e[k].w;
      }
    }
  }
}

// acc[k][j] = sum_c apod * rot * lerp(iq) for pixel p0 + tile_pixel(k),
// acquisition b0 + j (j < nb) and frame f0 + lane, channels ascending.
// plan_tile must have run; ends with __syncthreads, so it can run again.
template <int P, int BP>
__device__ __forceinline__ void accumulate(const Args& a, const Smem& s,
                                           int p0, int b0, int nb, int f0,
                                           Acc<BP>& acc) {
  const int nfc = min(kFrames, a.n_f - f0);
  const int fl = min((int)(threadIdx.x & 31), nfc - 1);
#pragma unroll
  for (int pp = 0; pp < Tile<BP>::kPpw; ++pp) {
#pragma unroll
    for (int j = 0; j < Tile<BP>::kBb; ++j) acc[pp][j] = make_float2(0.f, 0.f);
  }
  // 16-byte copies where rows of frames are 16-byte aligned
  const bool wide = a.n_f % 2 == 0 && ((uintptr_t)a.iq & 15) == 0;
  const int n_grp = s.n_grp[0];
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < n_grp) {
      stage_group<BP>(a, s, g, g, p0, b0, nb, f0, nfc, wide);
    } else {
      tf32::cp_async_commit();
    }
  }
  for (int g = 0; g < n_grp; ++g) {
    const int buf = g % kStages, next = g + kStages - 1;
    if (next < n_grp) {
      stage_group<BP>(a, s, next, next % kStages, p0, b0, nb, f0, nfc, wide);
    } else {
      tf32::cp_async_commit();  // an empty group keeps the count
    }
    tf32::cp_async_wait<kStages - 1>();  // group g's copies have landed
    round_group<P>(s, g, buf, nb, nfc, wide);
    __syncthreads();
    const int first = s.grp[g];
    if (direct(s, first, nb)) {
      channel_terms<P, BP, true>(a, s, first, 0, buf, b0, nb, f0, fl, acc);
    } else {
      for (int c = first; c < s.grp[g + 1]; ++c) {
        channel_terms<P, BP, false>(a, s, c, c - first, buf, b0, nb, f0, fl,
                                    acc);
      }
    }
    __syncthreads();  // buffer buf is restaged next
  }
}

// The (tile, acquisition chunk, frame chunk) of this block. Blocks start
// in index order, the first n_sm one per SM, and block n_sm + k then lands
// beside block k. Work per tile grows steadily with depth (deeper rows
// see more channels of non-zero apodization), so the blocks past n_sm
// take the tiles from the far end backwards, which pairs heavy tiles with
// light ones on an SM. Any order gives the same sums.
struct Block {
  int tile, acq, frames;
};

__device__ __forceinline__ Block block_of(int n_sm) {
  const int n = gridDim.x * gridDim.y * gridDim.z;
  int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (b >= n_sm) b = n - 1 - (b - n_sm);
  return {(int)(b % gridDim.x), (int)((b / gridDim.x) % gridDim.y),
          (int)(b / (gridDim.x * gridDim.y))};
}

// Launch shape of a tile kernel: tiles, acquisition chunks, frame chunks.
template <int BP>
inline dim3 grid(int n_pix, int batch, int frame_chunks) {
  return dim3((n_pix + BP - 1) / BP,
              (batch + Tile<BP>::kBb - 1) / Tile<BP>::kBb, frame_chunks);
}

}  // namespace das
