// SPH pair sweep over the level-set cell rasters (kernel K4).
//
// Replaces: splashsurf_tpu/ops/splat_pallas.py::pair_sweep_pallas, the
// Pallas TPU kernel behind splashsurf_tpu/ops/global_sweep.py::
// density_weights_from_rasters (the cell-raster densities).
//
// Computes what the reference's portable formulation _pair_sweep_xla
// computes. The rasters (S, Xp, Yp, Zp) are the fraction rasters of the
// dense level set: each particle's position relative to its cell corner,
// the cells padded by pad >= R on every side, empty slots holding a far
// sentinel (+inf in f32, 1e15 in f64). For every query entry (s, cx, cy, cz)
// of the (S, ncx, ncy, ncz) cells:
//   acc[s, c] = 1/(4 pi) * sum over the fan offsets o and the source slots
//               k of (2-q)_+^3 - 4 (1-q)_+^3,
//   q = sqrt(d2) * (2/h),  d = frac_s(c) - (frac_k(c + o) + o * cs),
// self term included. The fan is pair_cell_offsets(R, h/cs): the offsets in
// [-R, R]^3 whose cells can hold a pair within the support, 275 of 343 at
// h/cs = 8/3, given as runs (o0, o1, o2_lo, o2_hi) of at most 2R + 1: for
// fixed (o0, o1) the kept o2 form one contiguous range.
//
// What bounds it on an H100. Measured on the 2M dam break's meta rasters
// (2, 392, 160, 112) (chip_smoke.py phase 9): slot 0 of the query cells is
// 33 % full and slot 1 all but empty (0.0001 %); a third of the 32-cell z
// segments hold a query, 13 on average; of the 550 source entries a cell's
// fan covers, 106 are occupied, and 31 of those lie within the support.
// The first design gave every cell a thread (lane = z) that probed all 550
// entries through L1/L2 and paid the square root and the spline for every
// occupied one: its time (6.6 ms) followed the probes, with most of each
// busy warp idle. Visiting only occupied pairs, the kernel is bound by its
// loads and their bookkeeping: a warp's loads touch many cache lines. Of
// the walks tried, each lane walking all its set bits as one sequence
// (fewest steps, the lanes at unrelated runs) and the warp taking every
// bit of a run that any lane holds (coalesced, but 275 steps per query
// instead of about 106) both ran slower than taking the runs in step with
// each lane walking its own bits; staging the window's fractions in shared
// memory lost more to the staging and to occupancy than it gained.
// Registers (ptxas, phase 1): 36 in f32 (kMinBlocks), 65 in f64, no spills.
//
// Design:
// - Occupancy masks of the source raster (occupancy_mask_kernel in
//   level_set_sum.cuh with the fraction test v < 1e14, the test the probing
//   loop made): one bit per raster entry, 32-bit words along z.
// - Tiles. A block of 256 threads covers kTileX x kTileY (x, y) rows of 32
//   consecutive z cells. It stages, with cp.async, the mask words of its
//   window (the tile plus R on every side; the words its z span plus R
//   touches, and one more for the funnel) and derives a run table with each
//   run's window row, bit position, bit mask, raster offset and length
//   offsets. A source slot whose window holds no set bit is skipped by the
//   whole block (slot 1 of the dam break everywhere).
// - Compacted queries. The tile's occupied (slot, cell) queries are
//   gathered into a list in shared memory (popcounts of the staged query
//   rows, one warp's prefix scan), slot -> x -> y -> z, and the threads
//   take them densely: a warp runs 32 queries wherever the tile has 32.
//   Empty query cells get exactly 0 from a separate coalesced pass; a tile
//   with no query writes its zeros and no more.
// - Walk set bits only. The queries of a warp take the runs in step; each
//   funnels its run's bits out of two staged words (from its own cell's
//   place in the window) and walks them, loading fx, fy, fz only for a set
//   bit (through the read-only cache). Taking the runs in step keeps the
//   lanes' loads on nearby entries; the warp waits, per run, for its
//   busiest lane (at most 2R + 1 bits).
// - Cut before the square root. A pair with d2 > cut2 = h^2 (1 + 1e-4)
//   skips the square root and the spline. It is exact: such a pair has
//   sqrt(d2) >= h (1 + 5e-5) (1 - eps), so q = sqrt(d2) * (2/h) > 2 in the
//   kernel's own rounding (eps = 2^-24 in f32), (2-q)_+ = (1-q)_+ = 0, and
//   the term is +0, which leaves the sum unchanged bit for bit.
// Summation order: per query, source slot -> run (the fan's order) ->
// ascending o2. The plain version and the reference sum fan -> slot, so
// the two agree to rounding, not bit for bit. No atomics: runs are
// reproducible bit for bit. An empty query slot gets 0, where the reference
// leaves NaN (f32) or a meaningless finite sum (f64) that its caller masks.
// A query's flat raster offset is 64-bit; a run's offset from it is 32-bit
// (the launch refuses rasters where (R + 1) Yp Zp reaches 2^31).
// Built without fast math: IEEE sqrt, and the sentinels' arithmetic in the
// mask test.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "level_set_sum.cuh"

namespace {

using splat::dev_max0;
using splat::dev_sqrt;
using splat::Pair;
using splat::StagedRun;

constexpr int kTileX = 4;  // x rows of a tile
constexpr int kTileY = 8;  // y rows of a tile
constexpr int kRows = kTileX * kTileY;
constexpr int kThreads = 256;
constexpr int kMaxSlots = 4;  // query ids (slot, row, z) fit 16 bits
// f32: 6 blocks (1,536 threads) per SM, at most 42 registers, which the
// kernel meets without spilling (left to itself ptxas took more and ran
// slower); f64 keeps the registers it needs
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 1;

// Mask words staged per window row: the tile's 32 z plus R on each side,
// from any bit offset within the first word, and one more for the funnel.
__host__ __device__ __forceinline__ int pair_window_words(int reach) {
  return ((62 + 2 * reach) >> 5) + 2;
}

// Dynamic shared memory of one block: per run its offsets in length units
// and its staged form; per slot the mask window; per (slot, row) its query
// bits and list offset; the slot flags and the query count; the query list.
inline size_t pair_smem(int n_runs, int n_slots, int reach, size_t t_size) {
  const size_t words =
      (size_t)(kTileX + 2 * reach) * (kTileY + 2 * reach) * pair_window_words(reach);
  const size_t rows = (size_t)n_slots * kRows;
  return (size_t)n_runs * (2 * t_size + sizeof(StagedRun)) + n_slots * 4 * words +
         rows * 8 + (n_slots + 1) * 4 + rows * 32 * sizeof(uint16_t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) pair_sweep_tiles(
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, const uint32_t* __restrict__ masks,
    const int4* __restrict__ runs, int n_runs, int n_slots, int reach,
    int64_t Xp, int64_t Yp, int64_t Zp, int64_t W, int64_t ncx, int64_t ncy,
    int64_t ncz, int pad, T cs, T two_over_h, T cut2, T inv4pi,
    T* __restrict__ out) {
  extern __shared__ int4 smem[];
  const int R = reach;
  const int nww = pair_window_words(R);
  const int wx = kTileX + 2 * R, wy = kTileY + 2 * R;
  const int slot_words = wx * wy * nww;
  const int n_rs = n_slots * kRows;  // the tile's (slot, row) pairs
  Pair<T>* s_oxy = reinterpret_cast<Pair<T>*>(smem);
  StagedRun* s_runs = reinterpret_cast<StagedRun*>(s_oxy + n_runs);
  uint32_t* s_win = reinterpret_cast<uint32_t*>(s_runs + n_runs);
  uint32_t* s_bits = s_win + n_slots * slot_words;
  int* s_off = reinterpret_cast<int*>(s_bits + n_rs);
  int* s_any = s_off + n_rs;
  int* s_nq = s_any + n_slots;
  uint16_t* s_q = reinterpret_cast<uint16_t*>(s_nq + 1);

  const int64_t tiles_z = (ncz + 31) >> 5;
  const int64_t tiles_y = (ncy + kTileY - 1) / kTileY;
  int64_t t = blockIdx.x;
  const int64_t z0 = (t % tiles_z) * 32;
  t /= tiles_z;
  const int64_t y0 = (t % tiles_y) * kTileY;
  const int64_t x0 = (t / tiles_y) * kTileX;
  const int tid = threadIdx.x, lane = tid & 31;
  // the window's first raster entry; pad >= R keeps it on the raster
  const int64_t X0 = x0 + pad - R, Y0 = y0 + pad - R, Z0 = z0 + pad - R;
  const int64_t w0 = Z0 >> 5;
  const int zoff = (int)(Z0 & 31);  // bit of raster z Z0 in staged word 0

  // stage the window's mask words (zeros off the raster) and the run table
#pragma unroll 1
  for (int i = tid; i < n_slots * wx * wy; i += kThreads) {  // (slot, row)
    const int s = i / (wx * wy), row = i - s * (wx * wy);
    const int64_t X = X0 + row / wy, Y = Y0 + row % wy;
    const int64_t g = ((s * Xp + X) * Yp + Y) * W + w0;
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
    const int4 run = runs[r];  // (o0, o1, o2_lo, o2_hi), unshifted
    const int len = run.w - run.z;  // 1..2R+1
    s_runs[r] = StagedRun{((run.x + R) * wy + run.y + R) * nww, run.z + R,
                          len >= 32 ? ~0u : (1u << len) - 1u,
                          (int)((run.x * Yp + run.y) * Zp + run.z)};
    // o * cs per axis, formed in the rasters' precision as the plain
    // version forms it
    s_oxy[r] = Pair<T>{T(run.x) * cs, T(run.y) * cs};
  }
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < n_slots; ++s) {
    uint32_t f = 0u;
    for (int i = tid; i < slot_words; i += kThreads) f |= s_win[s * slot_words + i];
    const int a = __syncthreads_or(f != 0u);
    if (tid == 0) s_any[s] = a;
  }

  // the query bits of each (slot, row): window row (xl + R, yl + R), bits
  // from zoff + R on, cut to the cells of the grid
  const int64_t nz = ncz - z0;
  const uint32_t zvalid = nz >= 32 ? ~0u : (1u << nz) - 1u;
  if (tid < n_rs) {
    const int s = tid / kRows, row = tid % kRows;
    const int xl = row / kTileY, yl = row % kTileY;
    uint32_t b = 0u;
    if (x0 + xl < ncx && y0 + yl < ncy) {
      const int p = zoff + R;
      const uint32_t* w =
          s_win + s * slot_words + ((xl + R) * wy + yl + R) * nww + (p >> 5);
      b = __funnelshift_r(w[0], w[1], p & 31) & zvalid;
    }
    s_bits[tid] = b;
  }
  __syncthreads();
  // each (slot, row)'s first place in the query list: one warp's scan
  if (tid < 32) {
    int carry = 0;
#pragma unroll 1
    for (int base = 0; base < n_rs; base += 32) {
      const int i = base + tid;
      const int v = i < n_rs ? __popc(s_bits[i]) : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (tid >= d) incl += u;
      }
      if (i < n_rs) s_off[i] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (tid == 0) *s_nq = carry;
  }
  __syncthreads();
  // the query list (slot -> row -> z), and 0 for every empty query cell
  if (tid < n_rs) {
    uint32_t b = s_bits[tid];
    int o = s_off[tid];
    while (b != 0u) {
      s_q[o++] = (uint16_t)(tid * 32 + __ffs(b) - 1);
      b &= b - 1u;
    }
  }
#pragma unroll 1
  for (int i = tid >> 5; i < n_rs; i += kThreads / 32) {
    const int s = i / kRows, row = i % kRows;
    const int64_t x = x0 + row / kTileY, y = y0 + row % kTileY, z = z0 + lane;
    if (x < ncx && y < ncy && z < ncz && !(s_bits[i] >> lane & 1u))
      out[((s * ncx + x) * ncy + y) * ncz + z] = T(0);
  }
  __syncthreads();
  const int nq = *s_nq;
  const int64_t slot_stride = Xp * Yp * Zp;

#pragma unroll 1
  for (int qi = tid; qi < nq; qi += kThreads) {
    const int id = s_q[qi];
    const int zl = id & 31, rs = id >> 5;
    const int s = rs / kRows, row = rs % kRows;
    const int xl = row / kTileY, yl = row % kTileY;
    const int64_t x = x0 + xl, y = y0 + yl, z = z0 + zl;
    const int64_t cell = ((x + pad) * Yp + (y + pad)) * Zp + (z + pad);
    const T qx = fx[s * slot_stride + cell];
    const T qy = fy[s * slot_stride + cell];
    const T qz = fz[s * slot_stride + cell];
    const int zb = zoff + zl;                   // the query's bit, less R
    const int lane_row = (xl * wy + yl) * nww;  // its row, less (R, R)
    T acc = T(0);
#pragma unroll 1
    for (int k = 0; k < n_slots; ++k) {
      if (!s_any[k]) continue;  // block-uniform
      const uint32_t* win = s_win + k * slot_words + lane_row;
      const T* sx = fx + (k * slot_stride + cell);
      const T* sy = fy + (k * slot_stride + cell);
      const T* sz = fz + (k * slot_stride + cell);
#pragma unroll 1
      for (int r = 0; r < n_runs; ++r) {  // the runs in step: the lanes'
        const StagedRun run = s_runs[r];  // loads fall on nearby entries
        // the run's bits for this query, funnelled out of two staged words
        const int p = zb + run.o2_lo;
        const uint32_t* w = win + run.word + (p >> 5);
        uint32_t bits = __funnelshift_r(w[0], w[1], p & 31) & run.len_mask;
        if (bits == 0u) continue;
        const Pair<T> o = s_oxy[r];
        const int o2 = run.o2_lo - R;
#pragma unroll 1
        while (bits != 0u) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1u;
          const int i = run.offset + b;
          const T dx = qx - (__ldg(sx + i) + o.x);
          const T dy = qy - (__ldg(sy + i) + o.y);
          const T dz = qz - (__ldg(sz + i) + T(o2 + b) * cs);
          const T d2 = dx * dx + dy * dy + dz * dz;
          if (d2 <= cut2) {  // beyond it the term is exactly +0
            const T q = dev_sqrt(d2) * two_over_h;
            const T a = dev_max0(T(2) - q);
            const T c = dev_max0(T(1) - q);
            acc += a * a * a - T(4) * (c * c * c);
          }
        }
      }
    }
    out[((s * ncx + x) * ncy + y) * ncz + z] = acc * inv4pi;
  }
}

template <typename T>
int launch(const void* fx, const void* fy, const void* fz, const void* masks,
           const void* runs, int n_runs, int n_slots, int reach, int64_t Xp,
           int64_t Yp, int64_t Zp, int64_t W, int64_t ncx, int64_t ncy,
           int64_t ncz, int pad, double cs, double two_over_h, double cut2,
           void* out, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots || reach < 0 || reach > pad ||
      2 * reach + 1 > 32)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = ((ncx + kTileX - 1) / kTileX) *
                        ((ncy + kTileY - 1) / kTileY) * ((ncz + 31) / 32);
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffff || (reach + 1) * Yp * Zp >= 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = pair_smem(n_runs, n_slots, reach, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_sweep_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_sweep_tiles<T><<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)fx, (const T*)fy, (const T*)fz, (const uint32_t*)masks,
      (const int4*)runs, n_runs, n_slots, reach, Xp, Yp, Zp, W, ncx, ncy, ncz,
      pad, T(cs), T(two_over_h), T(cut2),
      T(1.0 / (4.0 * 3.14159265358979323846)), (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pair_sweep_f32(const void* fx, const void* fy, const void* fz,
                   const void* masks, const void* runs, int n_runs,
                   int n_slots, int reach, int64_t Xp, int64_t Yp, int64_t Zp,
                   int64_t W, int64_t ncx, int64_t ncy, int64_t ncz, int pad,
                   double cs, double two_over_h, double cut2, void* out,
                   void* stream) {
  return launch<float>(fx, fy, fz, masks, runs, n_runs, n_slots, reach, Xp, Yp,
                       Zp, W, ncx, ncy, ncz, pad, cs, two_over_h, cut2, out,
                       stream);
}

int pair_sweep_f64(const void* fx, const void* fy, const void* fz,
                   const void* masks, const void* runs, int n_runs,
                   int n_slots, int reach, int64_t Xp, int64_t Yp, int64_t Zp,
                   int64_t W, int64_t ncx, int64_t ncy, int64_t ncz, int pad,
                   double cs, double two_over_h, double cut2, void* out,
                   void* stream) {
  return launch<double>(fx, fy, fz, masks, runs, n_runs, n_slots, reach, Xp,
                        Yp, Zp, W, ncx, ncy, ncz, pad, cs, two_over_h, cut2,
                        out, stream);
}

// K4's block geometry, as the launch uses it: out = (tile x, tile y, tile z,
// staged mask words per window row, dynamic shared memory bytes of one
// block).
void pair_sweep_geometry(int n_runs, int n_slots, int reach, int t_size,
                         int64_t* out) {
  out[0] = kTileX;
  out[1] = kTileY;
  out[2] = 32;
  out[3] = pair_window_words(reach);
  out[4] = (int64_t)pair_smem(n_runs, n_slots, reach, (size_t)t_size);
}

}  // extern "C"
