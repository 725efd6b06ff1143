// The level-set sweep shared by kernels K1 (sweep_global.cu, the global
// grid) and K3 (splat_sweep.cu, per subdomain), and its occupancy masks.
//
//   acc(p) = sum_s sum_o f(q) * v_s(p + o)
//
// with q = sqrt(d2) * (2 / h), f(q) = (2-q)_+^3 - 4 (1-q)_+^3 and
// d2 = |frac_s(p+o) + (o - pad) * cs|^2, over the raster slots s and the
// pruned cell offsets o, given as runs (o0, o1, o2_lo, o2_hi) shifted by
// pad: for fixed (o0, o1) the kept o2 form one contiguous range. The sum is
// scaled by sigma = 8 / h^3 / (4 pi) once per point.
//
// The rasters (C, S, Xp, Yp, Zp) hold each particle's position relative to
// its cell corner and its splat weight; empty slots hold a far sentinel
// fraction (+inf in f32, 1e15 in f64) and weight 0, and add exactly 0.
//
// What bounds it on an H100. The data needs little: the rasters read once
// and some 23 float operations per occupied (point, offset, slot) term.
// The first design gave each point one thread that probed all S * |fan|
// window entries (2 * 232 at hsc = 3) through L1/L2 and branched on each
// weight, so its time followed the probe count, not the occupied terms:
// about 0.7-0.85 G probes per ms whether 1 % or 16 % of the entries were
// full. Measured occupancy (chip_smoke.py phases 2 and 6): on the 2M dam
// break slot 1 is all but empty, slot 0 is 28 % full and occupied terms
// are 16 % of the probes; on the fullest 8M-canyon chunk slot 0 is 5.6 %
// full, slot 1 0.05 %, occupied terms are 3.3 % of the probes, and 36 % of
// the tiles below find no set bit in their window. Once only occupied
// terms are visited, the sweep is bound by instruction issue (timing it
// with its loads replaced by arithmetic changed little): the terms'
// arithmetic, and the bookkeeping of which run each lane walks, which
// diverges within a warp.
//
// Design:
// - Occupancy masks (occupancy_mask_kernel, one warp per four 32-entry
//   row segments, __ballot_sync of v != 0): one bit per raster entry,
//   ceil(Zp / 32) 32-bit words per (chunk, slot, x, y) row, bit b of word
//   w for z = 32 w + b. "Occupied" is exactly v != 0, the test the probing
//   loop made. The pre-pass reads the weight raster once. Kernel K4
//   (pair_sweep.cu) takes the same pre-pass over its fraction raster, with
//   the test v < 1e14.
// - The fan within the support. The wrapper's run table leaves out the
//   cells whose nearest point lies beyond the support radius (by 0.1 %):
//   every particle there is at q >= 2 and adds exactly 0. At support 4r
//   and cube 1.5r that is 160 of the 232 offsets of hsc = 3.
// - Tiles. A block of 256 threads covers kTileX x kTileY (x, y) rows of
//   32 consecutive z; each warp is one row segment, lane = z. The block
//   stages, with cp.async, the mask words of its window (the tile plus
//   2 pad - 1 in x and y, the words the tile's z span plus 2 pad - 1
//   touches, and one more for the funnel) and derives a run table with
//   each run's window row, bit mask, raster offset and length offsets. A
//   slot whose window has no set bit is skipped by the block, one whose
//   part of the window reachable from a warp's row is empty by the warp; a
//   block with no set bit in any slot writes zeros and returns.
// - Walk set bits only. Runs are taken 32 at a time: the warp first marks,
//   in step, the runs that hold a set bit for each lane (all lanes read
//   the same staged row: broadcasts); then each lane walks its own marked
//   runs, funnelling the at most 32 bits of row (x + o0, y + o1) over
//   [z + o2_lo, z + o2_hi) out of two staged words, and loads fx, fy, fz
//   and v only for a set bit, through the read-only cache. The warp thus
//   waits for the lane with the most occupied terms, not for the fullest
//   run, and no lane revisits an empty run. The sum keeps the order slot ->
//   run table order -> ascending o2 of the probing loop, uses no atomics
//   and is deterministic. Runs longer than 32 are split by the wrapper, in
//   order.
// A point's flat raster offset is 64-bit; a run's offset from the point is
// 32-bit (the launch refuses rasters where 2 pad * Yp * Zp reaches 2^31).
// Built without fast math: the IEEE inf arithmetic of empty fractions must
// hold.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace splat {
namespace {

constexpr int kTileX = 2;  // x rows of a tile
constexpr int kTileY = 4;  // y rows of a tile
constexpr int kThreads = kTileX * kTileY * 32;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_max0(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ double dev_max0(double x) { return fmax(x, 0.0); }

// Occupancy masks of n_rows rows of Zp values: words (n_rows, W),
// W = ceil(Zp / 32), bit b of word w set iff fv[row, 32 w + b] is occupied:
// a weight v != 0 (kFractions false: the level-set sweeps' test) or a
// fraction below the empty sentinel, v < 1e14 (kFractions true: the pair
// sweep's test; an occupied fraction lies within one cell). Each warp packs
// kMaskWords consecutive words, their loads issued together.
constexpr int kMaskWords = 4;

template <typename T, bool kFractions>
__device__ __forceinline__ bool occupied(T v) {
  return kFractions ? v < T(1e14) : v != T(0);
}

template <typename T, bool kFractions>
__global__ void __launch_bounds__(256) occupancy_mask_kernel(
    const T* __restrict__ fv, int64_t n_rows, int64_t Zp, int64_t W,
    uint32_t* __restrict__ masks) {
  const int64_t first =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kMaskWords;
  const int lane = threadIdx.x & 31;
  bool occ[kMaskWords];
#pragma unroll
  for (int j = 0; j < kMaskWords; ++j) {
    const int64_t word = first + j;
    const int64_t row = word / W;
    const int64_t z = (word - row * W) * 32 + lane;
    occ[j] = word < n_rows * W && z < Zp && occupied<T, kFractions>(fv[row * Zp + z]);
  }
#pragma unroll
  for (int j = 0; j < kMaskWords; ++j) {
    const uint32_t bits = __ballot_sync(0xffffffffu, occ[j]);
    if (lane == 0 && first + j < n_rows * W) masks[first + j] = bits;
  }
}

template <typename T>
int occupancy_masks(const void* fv, int64_t n_rows, int64_t Zp, int64_t W,
                    int fractions, void* masks, cudaStream_t stream) {
  const int64_t warps = (n_rows * W + kMaskWords - 1) / kMaskWords;
  const int64_t blocks = (warps + 7) / 8;  // 8 warps a block
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (fractions)
    occupancy_mask_kernel<T, true><<<(unsigned)blocks, 256, 0, stream>>>(
        (const T*)fv, n_rows, Zp, W, (uint32_t*)masks);
  else
    occupancy_mask_kernel<T, false><<<(unsigned)blocks, 256, 0, stream>>>(
        (const T*)fv, n_rows, Zp, W, (uint32_t*)masks);
  return (int)cudaGetLastError();
}

// Mask words staged per window row: the tile's 32 z plus 2 pad - 1, and
// one more word for the funnel's upper half.
__host__ __device__ __forceinline__ int window_words(int pad) {
  return ((2 * pad + 30) >> 5) + 2;
}

// A run as the walk reads it: its first staged word relative to the
// lane's own row, (o0 * wy + o1) * nww; o2_lo; the mask of its length; its
// raster offset from the point, (o0 * Yp + o1) * Zp + o2_lo.
struct StagedRun {
  int word, o2_lo;
  uint32_t len_mask;
  int offset;
};

// A run's (o0 - pad, o1 - pad) * cs.
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, y;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) level_set_tiles(
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, const T* __restrict__ fv,
    const uint32_t* __restrict__ masks, const int4* __restrict__ runs,
    int n_runs, int n_slots, int64_t Xp, int64_t Yp, int64_t Zp, int64_t W,
    int64_t PX, int64_t PY, int64_t PZ, int pad, T cs, T two_over_h,
    T sigma, T* __restrict__ out) {
  // shared: run offsets | runs | mask window | slot flags
  extern __shared__ int4 smem[];
  const int nww = window_words(pad);
  const int wx = kTileX + 2 * pad - 1, wy = kTileY + 2 * pad - 1;
  const int slot_words = wx * wy * nww;
  Pair<T>* s_oxy = reinterpret_cast<Pair<T>*>(smem);
  StagedRun* s_runs = reinterpret_cast<StagedRun*>(s_oxy + n_runs);
  uint32_t* s_win = reinterpret_cast<uint32_t*>(s_runs + n_runs);
  int* s_any = reinterpret_cast<int*>(s_win + n_slots * slot_words);

  const int64_t tiles_z = (PZ + 31) >> 5;
  const int64_t tiles_y = (PY + kTileY - 1) / kTileY;
  const int64_t tiles_x = (PX + kTileX - 1) / kTileX;
  int64_t t = blockIdx.x;
  const int64_t z0 = (t % tiles_z) * 32;
  t /= tiles_z;
  const int64_t y0 = (t % tiles_y) * kTileY;
  t /= tiles_y;
  const int64_t x0 = (t % tiles_x) * kTileX;
  const int64_t c = t / tiles_x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int xl = (tid >> 5) / kTileY, yl = (tid >> 5) % kTileY;
  const int64_t x = x0 + xl, y = y0 + yl, z = z0 + lane;

  // stage the window's mask words (zeros off the raster) and the run table
  const int64_t w0 = z0 >> 5;
#pragma unroll 1
  for (int i = tid; i < n_slots * wx * wy; i += kThreads) {  // (slot, row)
    const int s = i / (wx * wy), row = i - s * (wx * wy);
    const int64_t X = x0 + row / wy, Y = y0 + row % wy;
    const int64_t g = (((c * n_slots + s) * Xp + X) * Yp + Y) * W + w0;
#pragma unroll 1
    for (int k = 0; k < nww; ++k) {
      if (X < Xp && Y < Yp && w0 + k < W)
        __pipeline_memcpy_async(s_win + i * nww + k, masks + g + k, 4);
      else
        s_win[i * nww + k] = 0u;
    }
  }
  __pipeline_commit();
#pragma unroll 1
  for (int r = tid; r < n_runs; r += kThreads) {
    const int4 run = runs[r];
    const int len = run.w - run.z;  // 1..32
    s_runs[r] = StagedRun{(run.x * wy + run.y) * nww, run.z,
                          len >= 32 ? ~0u : (1u << len) - 1u,
                          (int)((run.x * Yp + run.y) * Zp + run.z)};
    s_oxy[r] = Pair<T>{T(run.x - pad) * cs, T(run.y - pad) * cs};
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  int any = 0;
#pragma unroll 1
  for (int s = 0; s < n_slots; ++s) {
    uint32_t f = 0u;
    for (int i = tid; i < slot_words; i += kThreads) f |= s_win[s * slot_words + i];
    const int a = __syncthreads_or(f != 0u);
    if (tid == 0) s_any[s] = a;
    any |= a;
  }
  __syncthreads();

  // the slots (below 32) in which this warp's fan reaches a set bit: rows
  // xl .. xl + 2 pad - 1 and yl .. yl + 2 pad - 1 of the window, all words
  const int span = 2 * pad;
  uint32_t walk = 0u;
#pragma unroll 1
  for (int s = 0; any && s < n_slots && s < 32; ++s) {
    if (!s_any[s]) continue;  // block-uniform
    const uint32_t* win = s_win + s * slot_words;
    uint32_t f = 0u;
#pragma unroll 1
    for (int a = 0; a < span; ++a)
      for (int b = lane; b < span; b += 32)
        for (int k = 0; k < nww; ++k) f |= win[((xl + a) * wy + yl + b) * nww + k];
    if (__any_sync(0xffffffffu, f != 0u)) walk |= 1u << s;
  }

  if (x >= PX || y >= PY || z >= PZ) return;  // no barrier or vote follows
  T* dst = out + ((c * PX + x) * PY + y) * PZ + z;
  const int zb = (int)(z0 & 31) + lane;       // the lane's bit in word w0
  const int lane_row = (xl * wy + yl) * nww;  // the lane's own staged row
  T acc = T(0);
#pragma unroll 1
  for (int s = 0; any && s < n_slots; ++s) {
    if (s < 32 ? !(walk >> s & 1u) : !s_any[s]) continue;  // warp-uniform
    const uint32_t* win = s_win + lane_row + s * slot_words;
    const int64_t base = (((c * n_slots + s) * Xp + x) * Yp + y) * Zp + z;
    const T* sx = fx + base;
    const T* sy = fy + base;
    const T* sz = fz + base;
    const T* sv = fv + base;
    // the bits of a run for this lane
    auto run_bits = [&](const StagedRun& run) {
      const int p = zb + run.o2_lo;
      const uint32_t* w = win + run.word + (p >> 5);
      return __funnelshift_r(w[0], w[1], p & 31) & run.len_mask;
    };
#pragma unroll 1
    for (int r0 = 0; r0 < n_runs; r0 += 32) {
      const int rn = min(32, n_runs - r0);
      // in step: the runs that hold a set bit for this lane
      uint32_t marked = 0u;
#pragma unroll 4
      for (int j = 0; j < rn; ++j)
        marked |= (uint32_t)(run_bits(s_runs[r0 + j]) != 0u) << j;
      // then each lane alone: its marked runs and their set bits
      uint32_t bits = 0u;
      int off = 0;  // raster offset of the run's o2_lo from the point
      int oz = 0;   // o2_lo - pad
      T ox = T(0), oy = T(0);
#pragma unroll 1
      while (bits != 0u || marked != 0u) {
        if (bits == 0u) {
          const int r = r0 + __ffs(marked) - 1;
          marked &= marked - 1u;
          const StagedRun run = s_runs[r];
          bits = run_bits(run);
          off = run.offset;
          oz = run.o2_lo - pad;
          const Pair<T> o = s_oxy[r];
          ox = o.x;
          oy = o.y;
        }
        const int k = __ffs(bits) - 1;
        bits &= bits - 1u;
        const int i = off + k;
        const T v = __ldg(sv + i);
        const T dx = __ldg(sx + i) + ox;
        const T dy = __ldg(sy + i) + oy;
        const T dz = __ldg(sz + i) + T(oz + k) * cs;
        const T d2 = dx * dx + dy * dy + dz * dz;
        const T q = dev_sqrt(d2) * two_over_h;
        const T a = dev_max0(T(2) - q);
        const T b = dev_max0(T(1) - q);
        acc += (a * a * a - T(4) * (b * b * b)) * v;
      }
    }
  }
  *dst = acc * sigma;
}

inline double kernel_sigma(double h) {
  return 8.0 / (h * h * h) / (4.0 * 3.14159265358979323846);
}

// Dynamic shared memory of one sweep block (the layout of level_set_tiles).
inline size_t level_set_smem(int n_runs, int n_slots, int pad, size_t t_size) {
  const size_t words = (size_t)(kTileX + 2 * pad - 1) * (kTileY + 2 * pad - 1) *
                       window_words(pad);
  return (size_t)n_runs * (2 * t_size + sizeof(StagedRun)) +
         (size_t)n_slots * (4 * words + sizeof(int));
}

// Launch the sweep over C chunks of (S, Xp, Yp, Zp) rasters with their
// masks (C, S, Xp, Yp, W) into (C, PX, PY, PZ) on `stream`.
template <typename T>
int launch_level_set(const void* fx, const void* fy, const void* fz,
                     const void* fv, const void* masks, const void* runs,
                     int n_runs, int n_slots, int64_t C, int64_t Xp,
                     int64_t Yp, int64_t Zp, int64_t W, int64_t PX,
                     int64_t PY, int64_t PZ, int pad, double cs, double h,
                     void* out, void* stream) {
  const int64_t tiles = C * ((PX + kTileX - 1) / kTileX) *
                        ((PY + kTileY - 1) / kTileY) * ((PZ + 31) / 32);
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffff || 2 * pad * Yp * Zp >= 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = level_set_smem(n_runs, n_slots, pad, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        level_set_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  level_set_tiles<T><<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)fx, (const T*)fy, (const T*)fz, (const T*)fv,
      (const uint32_t*)masks, (const int4*)runs, n_runs, n_slots, Xp, Yp, Zp,
      W, PX, PY, PZ, pad, T(cs), T(2.0 / h), T(kernel_sigma(h)), (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace splat
