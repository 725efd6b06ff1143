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
// h/cs = 8/3, given as runs (o0, o1, o2_lo, o2_hi): for fixed (o0, o1) the
// kept o2 form one contiguous range. The runs follow the fan's order, and
// each thread sums its terms in that order, source slots inside each
// offset, as the reference does.
//
// What bounds it on an H100: loads and wasted probes, as K1. Each cell
// probes S * |fan| source entries (550 at S = 2), about 6.6 KB of fraction
// loads, for about 0.42 * 116 occupied pairs on a dense fluid: the windows
// of neighbouring cells overlap, so the traffic is L1/L2 traffic, and the
// bytes and operations the data needs (the bound) are far below it.
//
// Design: one thread per cell, z fastest, so the threads of a warp read
// consecutive addresses of every window row. The cell's query slots stay
// in registers (at most kMaxSlots), so each source load serves every query
// slot. A cell whose query slots are all empty writes 0 and returns; an
// empty source entry (sentinel >= 1e14; an occupied fraction lies within
// one cell) is skipped. Both skips are exact: an empty entry's term is 0
// against every occupied query. An empty query slot gets 0, where the
// reference leaves NaN (f32) or a meaningless finite sum (f64) that its
// caller masks. Flat offsets are 64-bit: near the 128M-cell dense guard
// S * Xp * Yp * Zp passes 2^31. Shared-memory tiling is left to a later
// change.
//
// Built without fast math (IEEE inf arithmetic on the sentinels).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 4;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_max0(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ double dev_max0(double x) { return fmax(x, 0.0); }

template <typename T>
__global__ void __launch_bounds__(256) pair_sweep_kernel(
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, const int4* __restrict__ runs, int n_runs,
    int n_slots, int64_t Xp, int64_t Yp, int64_t Zp, int64_t ncx,
    int64_t ncy, int64_t ncz, int pad, T cs, T two_over_h, T inv4pi,
    T far_below, T* __restrict__ out) {
  const int64_t n_cells = ncx * ncy * ncz;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_cells) return;
  const int64_t z = idx % ncz;
  const int64_t xy = idx / ncz;
  const int64_t y = xy % ncy;
  const int64_t x = xy / ncy;
  const int64_t slot_stride = Xp * Yp * Zp;
  const int64_t q0 = ((x + pad) * Yp + (y + pad)) * Zp + (z + pad);

  T qx[kMaxSlots], qy[kMaxSlots], qz[kMaxSlots], acc[kMaxSlots];
  bool occ[kMaxSlots];
  bool any = false;
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    occ[s] = false;
    qx[s] = qy[s] = qz[s] = acc[s] = T(0);
    if (s < n_slots) {
      const T fq = fx[s * slot_stride + q0];
      occ[s] = fq < far_below;
      any |= occ[s];
      if (occ[s]) {
        qx[s] = fq;
        qy[s] = fy[s * slot_stride + q0];
        qz[s] = fz[s * slot_stride + q0];
      }
    }
  }

  if (any) {
    for (int r = 0; r < n_runs; ++r) {
      const int4 run = runs[r];  // (o0, o1, o2_lo, o2_hi), unshifted
      const T ox = T(run.x) * cs;
      const T oy = T(run.y) * cs;
      const int64_t row =
          ((x + pad + run.x) * Yp + (y + pad + run.y)) * Zp + (z + pad);
      for (int o2 = run.z; o2 < run.w; ++o2) {
        const T oz = T(o2) * cs;
        for (int k = 0; k < n_slots; ++k) {
          const int64_t src = (int64_t)k * slot_stride + row + o2;
          const T rx = fx[src];
          if (!(rx < far_below)) continue;  // empty source slot
          const T sx = rx + ox;
          const T sy = fy[src] + oy;
          const T sz = fz[src] + oz;
#pragma unroll
          for (int s = 0; s < kMaxSlots; ++s) {
            if (!occ[s]) continue;
            const T dx = qx[s] - sx;
            const T dy = qy[s] - sy;
            const T dz = qz[s] - sz;
            const T d2 = dx * dx + dy * dy + dz * dz;
            const T q = dev_sqrt(d2) * two_over_h;
            const T a = dev_max0(T(2) - q);
            const T b = dev_max0(T(1) - q);
            acc[s] += a * a * a - T(4) * (b * b * b);
          }
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    if (s < n_slots) out[s * n_cells + idx] = occ[s] ? acc[s] * inv4pi : T(0);
  }
}

template <typename T>
int launch(const void* fx, const void* fy, const void* fz, const void* runs,
           int n_runs, int n_slots, int64_t Xp, int64_t Yp, int64_t Zp,
           int64_t ncx, int64_t ncy, int64_t ncz, int pad, double cs,
           double two_over_h, void* out, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  const int64_t n_cells = ncx * ncy * ncz;
  if (n_cells == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_cells + threads - 1) / threads;
  pair_sweep_kernel<T><<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const T*)fx, (const T*)fy, (const T*)fz, (const int4*)runs, n_runs,
      n_slots, Xp, Yp, Zp, ncx, ncy, ncz, pad, T(cs), T(two_over_h),
      T(1.0 / (4.0 * 3.14159265358979323846)), T(1e14), (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pair_sweep_f32(const void* fx, const void* fy, const void* fz,
                   const void* runs, int n_runs, int n_slots, int64_t Xp,
                   int64_t Yp, int64_t Zp, int64_t ncx, int64_t ncy,
                   int64_t ncz, int pad, double cs, double two_over_h,
                   void* out, void* stream) {
  return launch<float>(fx, fy, fz, runs, n_runs, n_slots, Xp, Yp, Zp, ncx,
                       ncy, ncz, pad, cs, two_over_h, out, stream);
}

int pair_sweep_f64(const void* fx, const void* fy, const void* fz,
                   const void* runs, int n_runs, int n_slots, int64_t Xp,
                   int64_t Yp, int64_t Zp, int64_t ncx, int64_t ncy,
                   int64_t ncz, int pad, double cs, double two_over_h,
                   void* out, void* stream) {
  return launch<double>(fx, fy, fz, runs, n_runs, n_slots, Xp, Yp, Zp, ncx,
                        ncy, ncz, pad, cs, two_over_h, out, stream);
}

}  // extern "C"
