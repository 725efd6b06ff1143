// The level-set sum at one grid point, shared by kernels K1
// (sweep_global.cu, the global grid) and K3 (splat_sweep.cu, per subdomain).
//
//   acc(p) = sum_s sum_o f(q) * v_s(p + o)
//
// with q = sqrt(d2) * (2 / h), f(q) = (2-q)_+^3 - 4 (1-q)_+^3 and
// d2 = |frac_s(p+o) + (o - pad) * cs|^2, over the raster slots s and the
// pruned cell offsets o, given as runs (o0, o1, o2_lo, o2_hi) shifted by
// pad: for fixed (o0, o1) the kept o2 form one contiguous range. The caller
// scales by sigma = 8 / h^3 / (4 pi) once.
//
// The rasters (slots, Xp, Yp, Zp) hold each particle's position relative to
// its cell corner and its splat weight; empty slots hold a far sentinel
// fraction (+inf in f32, 1e15 in f64) and weight 0. The weight is read first
// and an empty slot skips its three fraction loads: it would add exactly 0.
// Flat offsets are 64-bit.
//
// Built without fast math: the sentinel relies on IEEE inf arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splat {

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_max0(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ double dev_max0(double x) { return fmax(x, 0.0); }

template <typename T>
__device__ __forceinline__ T level_set_sum(
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, const T* __restrict__ fv,
    const int4* __restrict__ runs, int n_runs, int n_slots,
    int64_t slot_stride, int64_t Yp, int64_t Zp,
    int64_t x, int64_t y, int64_t z, int pad, T cs, T two_over_h) {
  T acc = T(0);
  for (int s = 0; s < n_slots; ++s) {
    const int64_t slot_base = (int64_t)s * slot_stride;
    for (int r = 0; r < n_runs; ++r) {
      const int4 run = runs[r];  // (o0, o1, o2_lo, o2_hi), shifted by pad
      const T ox = T(run.x - pad) * cs;
      const T oy = T(run.y - pad) * cs;
      const int64_t row =
          slot_base + ((x + run.x) * Yp + (y + run.y)) * Zp + z;
      for (int o2 = run.z; o2 < run.w; ++o2) {
        const int64_t i = row + o2;
        const T v = fv[i];
        if (v == T(0)) continue;  // empty slot: contributes exactly 0
        const T dx = fx[i] + ox;
        const T dy = fy[i] + oy;
        const T dz = fz[i] + T(o2 - pad) * cs;
        const T d2 = dx * dx + dy * dy + dz * dz;
        const T q = dev_sqrt(d2) * two_over_h;
        const T a = dev_max0(T(2) - q);
        const T b = dev_max0(T(1) - q);
        acc += (a * a * a - T(4) * (b * b * b)) * v;
      }
    }
  }
  return acc;
}

inline double kernel_sigma(double h) {
  return 8.0 / (h * h * h) / (4.0 * 3.14159265358979323846);
}

}  // namespace splat
