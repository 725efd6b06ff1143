// Slot raster of the dense route (kernel K6).
//
// Replaces no TPU kernel: the reference's raster
// (splashsurf_tpu/ops/global_sweep.py::rasterize_global) is plain XLA, a
// zero-filled table and a scatter-max of (n - index) per slot round. It
// feeds K1 on the dense route (every frame, and again on an overflow
// retry), the slab route (once per slab) and the mono frame, and with the
// slot meta the cell-raster densities (K4), where the plain PyTorch rounds
// took some 60 launches, 300 MB int64 tables and, in round 1, ~13M atomics
// on one drop address.
//
// Input: positions (n, 3) and weights (n,) in T, the grid's origin and cell
// size rounded to T, its cells (ncx, ncy, ncz), S slots, the raster pad and
// the x band of the table: global cells [x0 - pad, x0 + W + pad), Xp = W +
// 2 pad (the whole grid: W = ncx, x0 = 0). Output, bit for bit as the plain
// version (ops/splat_kernels.py slot_raster_plain):
//   per particle its cell c_d = floor((x_d - mn_d) / cs) in T (IEEE
//   division), clamped to [-1, nc_d]; valid iff the cell lies in the grid
//   and the band; its slot rank, the number of valid particles of its cell
//   with a smaller index, or S where that is S or more; overflow = valid
//   and rank S;
//   S fraction rasters per axis and one weight raster, (S, Xp, Yp, Zp): at
//   (rank, c_0 - x0 + pad, c_1 + pad, c_2 + pad) of each placed particle
//   its fractions x_d - g_d(c_d), g_d(c) = mn_d + c cs rounded once (in f32
//   the product and the sum formed in f64, in f64 one fused multiply-add),
//   and its weight; the far sentinel in every other fraction entry and +0
//   in every other weight entry.
//
// What bounds it on an H100. On the benchmark's sheared 13.2M dam frame k
// = 4 (S = 2, rasters (2, 744, 280, 192), 37.2M cells in the band) it must
// write the four rasters (1.28 GB in f32), read the positions and weights
// (212 MB) and keep S claim tables of 4 bytes a cell (300 MB): 1.803 GB,
// 0.538 ms at 3.35 TB/s (chip_smoke.py phase 25). So it is bound by
// memory, and the design writes every raster entry once, coalesced, and
// touches no byte it does not need. It takes 2.46 ms there against the
// plain version's 23.0 ms (NVIDIA H100 80GB HBM3, 700 W): the row pass
// 1.3 ms, its gathers of claimants in random particle order; the claim
// pass 0.8 ms, one random atomic per particle (1.2 ms in all with the
// particles in cell order). A design that wrote per particle into rasters
// filled first took 5.8 ms; four entries a lane in flight in the row pass
// gained nothing.
//
// Design: two memsets and two passes on the caller's stream (three with
// the meta), no read-back.
// 1. Claim. S uint32 tables over the band's cells, set to ~0 by one
//    cudaMemsetAsync (not S int64 fills), and the overflow mask cleared.
//    One thread per valid particle inserts its index with atomicMin into
//    slot 0's table; the larger of the old entry and the inserted index
//    goes on to the next slot, until it lands in an empty entry or leaves
//    slot S - 1, where it is flagged in the overflow mask. Whatever the
//    order of the atomics, table k ends holding the (k+1)-th smallest index
//    of each cell (the plain version's ranks), and the indices that leave
//    the last slot are the rest. A particle off the grid or the band writes
//    nothing, so no address takes more than its cell's particles.
// 2. With the meta only, rank: one thread per particle finds its index
//    among its cell's entries and writes rank, ok and the cells.
// 3. Raster. One warp per raster row (slot, x, y), its lanes along z: each
//    entry is written exactly once and in order, its claimant's position
//    and weight gathered through the table, so no fill pass precedes it.
//
// Built without fast math, and the rounding of every step is explicit (the
// _rn intrinsics), so nvcc contracts nothing the plain version rounds twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kEmpty = 0xffffffffu;

struct Geometry {
  int64_t n;       // particles
  int S;           // slots
  int64_t nc[3];   // the grid's cells
  int64_t Xp, Yp, Zp, pad, x0;
  int64_t ncells;  // entries of one claim table: Xp * ncy * ncz
};

template <typename T>
struct Origin {
  T mn[3];
  T cs;
};

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float floor_of(float a) { return floorf(a); }
__device__ __forceinline__ double floor_of(double a) { return floor(a); }

// mn + c cs rounded once (kernels.grid_coord)
__device__ __forceinline__ float grid_coord(int64_t c, float mn, float cs) {
  return __double2float_rn(__dadd_rn((double)mn, __dmul_rn((double)c, (double)cs)));
}
__device__ __forceinline__ double grid_coord(int64_t c, double mn, double cs) {
  return __fma_rn((double)c, cs, mn);
}

// floor((x - mn) / cs) clamped to [-1, nc]; NaN gives INT64_MIN, as the
// host's conversion of the plain version gives it
template <typename T>
__device__ __forceinline__ int64_t cell_of(T x, T mn, T cs, int64_t nc) {
  const T q = floor_of(div_rn(sub_rn(x, mn), cs));
  if (q != q) return INT64_MIN;
  return q < T(-1) ? -1 : (q > T(nc) ? nc : (int64_t)q);
}

// Particle i's cells, and its flat index in a claim table, or -1 when it
// lies off the grid or the band.
template <typename T>
__device__ __forceinline__ int64_t cell_entry(const T* __restrict__ pos, int64_t i,
                                              const Geometry& g, const Origin<T>& o,
                                              int64_t c[3]) {
  bool valid = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    c[d] = cell_of(__ldg(pos + 3 * i + d), o.mn[d], o.cs, g.nc[d]);
    valid &= c[d] >= 0 && c[d] < g.nc[d];
  }
  if (!valid) return -1;
  const int64_t tx = c[0] - g.x0 + g.pad;
  if (tx < 0 || tx >= g.Xp) return -1;
  return (tx * g.nc[1] + c[1]) * g.nc[2] + c[2];
}

// The overflow mask comes cleared; the index that leaves slot S - 1 (the
// cell's (S+1)-th smallest or later) is an overflowed particle.
template <typename T>
__global__ void __launch_bounds__(kThreads) slot_claim_kernel(
    const T* __restrict__ pos, Geometry g, Origin<T> o, unsigned* __restrict__ tables,
    uint8_t* __restrict__ over) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.n) return;
  int64_t c[3];
  const int64_t e = cell_entry(pos, i, g, o, c);
  if (e < 0) return;
  unsigned v = (unsigned)i;
  for (int k = 0; k < g.S; ++k) {
    const unsigned old = atomicMin(tables + k * g.ncells + e, v);
    if (old == kEmpty) return;  // v took an empty entry
    v = max(old, v);            // the larger index goes on to the next slot
  }
  over[v] = 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) slot_rank_kernel(
    const T* __restrict__ pos, Geometry g, Origin<T> o, const unsigned* __restrict__ tables,
    int64_t* __restrict__ rank, uint8_t* __restrict__ ok, int64_t* __restrict__ cx,
    int64_t* __restrict__ cy, int64_t* __restrict__ cz) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.n) return;
  int64_t c[3];
  const int64_t e = cell_entry(pos, i, g, o, c);
  int r = g.S;
  if (e >= 0) {
    for (int k = 0; k < g.S; ++k) {
      if (__ldg(tables + k * g.ncells + e) == (unsigned)i) {
        r = k;
        break;
      }
    }
  }
  rank[i] = r;
  ok[i] = r < g.S;
  cx[i] = c[0];
  cy[i] = c[1];
  cz[i] = c[2];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) slot_raster_kernel(
    const T* __restrict__ pos, const T* __restrict__ val, Geometry g, Origin<T> o,
    const unsigned* __restrict__ tables, T far, T* __restrict__ fx, T* __restrict__ fy,
    T* __restrict__ fz, T* __restrict__ fv) {
  // one warp per row (k, x, y) of the rasters; the wrapper holds the rows
  // below 2^32
  const unsigned row = (unsigned)(((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const unsigned Yp = (unsigned)g.Yp, Xp = (unsigned)g.Xp;
  if (row >= (unsigned)g.S * Xp * Yp) return;
  const int64_t y = row % Yp, x = (row / Yp) % Xp, k = row / Yp / Xp;
  const int64_t ty = y - g.pad;  // the row's cell in y
  const bool row_cells = ty >= 0 && ty < g.nc[1];
  const int64_t trow = k * g.ncells + (x * g.nc[1] + ty) * g.nc[2] - g.pad;
  const T gx = grid_coord(x + g.x0 - g.pad, o.mn[0], o.cs);
  const T gy = grid_coord(ty, o.mn[1], o.cs);
  const int64_t base = (int64_t)row * g.Zp;
  for (int64_t z = lane; z < g.Zp; z += 32) {
    unsigned idx = kEmpty;
    if (row_cells && z >= g.pad && z < g.pad + g.nc[2]) idx = __ldg(tables + trow + z);
    T a = far, b = far, c = far, w = T(0);
    if (idx != kEmpty) {
      const T* p = pos + 3 * (int64_t)idx;
      a = sub_rn(__ldg(p), gx);
      b = sub_rn(__ldg(p + 1), gy);
      c = sub_rn(__ldg(p + 2), grid_coord(z - g.pad, o.mn[2], o.cs));
      if (fv != nullptr) w = __ldg(val + idx);
    }
    fx[base + z] = a;
    fy[base + z] = b;
    fz[base + z] = c;
    if (fv != nullptr) fv[base + z] = w;
  }
}

template <typename T>
int launch(const void* pos, const void* val, int64_t n, int S, int64_t ncx, int64_t ncy,
           int64_t ncz, int64_t Xp, int64_t Yp, int64_t Zp, int64_t pad, int64_t x0,
           double mn0, double mn1, double mn2, double cs, double far, void* tables, void* fx,
           void* fy, void* fz, void* fv, void* over, void* rank, void* ok, void* cx, void* cy,
           void* cz, void* stream) {
  if (n < 0 || n >= (int64_t)kEmpty || S < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = S * Xp * Yp;
  if (rows >= ((int64_t)1 << 32)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Geometry g{n, S, {ncx, ncy, ncz}, Xp, Yp, Zp, pad, x0, Xp * ncy * ncz};
  const Origin<T> o{{T(mn0), T(mn1), T(mn2)}, T(cs)};
  cudaError_t err = cudaMemsetAsync(tables, 0xff, (size_t)(S * g.ncells) * sizeof(unsigned), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(over, 0, (size_t)n, st);
  if (err != cudaSuccess) return (int)err;
  const T* p = (const T*)pos;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    slot_claim_kernel<T><<<blocks, kThreads, 0, st>>>(p, g, o, (unsigned*)tables,
                                                      (uint8_t*)over);
    if (rank != nullptr) {
      slot_rank_kernel<T><<<blocks, kThreads, 0, st>>>(
          p, g, o, (const unsigned*)tables, (int64_t*)rank, (uint8_t*)ok, (int64_t*)cx,
          (int64_t*)cy, (int64_t*)cz);
    }
  }
  const int64_t raster_blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (raster_blocks > 0) {
    slot_raster_kernel<T><<<(unsigned)raster_blocks, kThreads, 0, st>>>(
        p, (const T*)val, g, o, (const unsigned*)tables, T(far), (T*)fx, (T*)fy, (T*)fz,
        (T*)fv);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int slot_raster_f32(const void* pos, const void* val, int64_t n, int S, int64_t ncx,
                    int64_t ncy, int64_t ncz, int64_t Xp, int64_t Yp, int64_t Zp, int64_t pad,
                    int64_t x0, double mn0, double mn1, double mn2, double cs, double far,
                    void* tables, void* fx, void* fy, void* fz, void* fv, void* over,
                    void* rank, void* ok, void* cx, void* cy, void* cz, void* stream) {
  return launch<float>(pos, val, n, S, ncx, ncy, ncz, Xp, Yp, Zp, pad, x0, mn0, mn1, mn2, cs,
                       far, tables, fx, fy, fz, fv, over, rank, ok, cx, cy, cz, stream);
}

int slot_raster_f64(const void* pos, const void* val, int64_t n, int S, int64_t ncx,
                    int64_t ncy, int64_t ncz, int64_t Xp, int64_t Yp, int64_t Zp, int64_t pad,
                    int64_t x0, double mn0, double mn1, double mn2, double cs, double far,
                    void* tables, void* fx, void* fy, void* fz, void* fv, void* over,
                    void* rank, void* ok, void* cx, void* cy, void* cz, void* stream) {
  return launch<double>(pos, val, n, S, ncx, ncy, ncz, Xp, Yp, Zp, pad, x0, mn0, mn1, mn2, cs,
                        far, tables, fx, fy, fz, fv, over, rank, ok, cx, cy, cz, stream);
}

}  // extern "C"
