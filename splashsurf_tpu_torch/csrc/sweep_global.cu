// Level-set sweep over the global background grid (kernel K1).
//
// Replaces: splashsurf_tpu/ops/splat_pallas.py::sweep_global_pallas, the
// Pallas TPU kernel behind splashsurf_tpu/ops/global_sweep.py::sweep_global.
//
// Computes, for every grid point p of the (PX, PY, PZ) point grid,
//   phi(p) = sigma * sum_s sum_o f(q) * v_s(p + o)
// with sigma = 8 / h^3 / (4 pi), q = sqrt(d2) * (2 / h), f(q) =
// (2-q)_+^3 - 4 (1-q)_+^3, d2 = |frac_s(p+o) + (o - pad) * cs|^2, over the
// raster slots s and the statically pruned cell offsets o of
// density.gather_cell_offsets(hsc) (shifted by pad = hsc + 1). The rasters
// (S, Xp, Yp, Zp) hold each particle's position relative to its cell corner
// and its splat weight; empty slots hold a far sentinel fraction (+inf in
// f32, 1e15 in f64) and weight 0, so they add exactly 0.
//
// What bounds it on an H100: loads. Every point reads 4 values for each of
// S * |offsets| (2 * 232 at hsc = 3) window entries, about 7 KB per point,
// against ~20 flops per entry; the windows of neighbouring points overlap
// almost entirely, so the traffic is L1/L2 traffic and not HBM traffic.
//
// Design: one thread per output point, z fastest, so the 32 threads of a
// warp read 32 consecutive addresses of every window row (coalesced, and
// the rows of neighbouring warps hit L1). The offset fan is passed as a
// run table (o0, o1, o2_lo, o2_hi): for fixed (o0, o1) the pruned o2 form
// one contiguous run, so the inner loop walks one contiguous row segment
// and any hsc works. The weight is read first and an empty slot (weight 0,
// which contributes exactly 0) skips its three fraction loads: most slot-1
// entries and about half of the slot-0 entries are empty at the usual
// cube size of 0.75 particle spacings. Flat offsets are 64-bit, since at
// the 160M-cell dense gate S * Xp * Yp * Zp comes near 2^31. Shared-memory
// tiling of the raster window is left to a later change.
//
// The sum at each point is splat::level_set_sum (level_set_sum.cuh), shared
// with kernel K3. Built without fast math: the empty-slot sentinel relies on
// IEEE inf arithmetic (sqrt(inf), 2 - inf, max(-inf, 0)).

#include <cuda_runtime.h>
#include <stdint.h>

#include "level_set_sum.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) sweep_global_kernel(
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, const T* __restrict__ fv,
    const int4* __restrict__ runs, int n_runs, int n_slots,
    int64_t Xp, int64_t Yp, int64_t Zp,
    int64_t PX, int64_t PY, int64_t PZ,
    int pad, T cs, T two_over_h, T sigma, T* __restrict__ out) {
  const int64_t n_out = PX * PY * PZ;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int64_t z = idx % PZ;
  const int64_t xy = idx / PZ;
  const int64_t y = xy % PY;
  const int64_t x = xy / PY;
  out[idx] = splat::level_set_sum(fx, fy, fz, fv, runs, n_runs, n_slots,
                                  Xp * Yp * Zp, Yp, Zp, x, y, z, pad, cs,
                                  two_over_h) *
             sigma;
}

template <typename T>
int launch(const void* fx, const void* fy, const void* fz, const void* fv,
           const void* runs, int n_runs, int n_slots,
           int64_t Xp, int64_t Yp, int64_t Zp,
           int64_t PX, int64_t PY, int64_t PZ,
           int pad, double cs, double h, void* out, void* stream) {
  const int64_t n_out = PX * PY * PZ;
  if (n_out == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  const double sigma = splat::kernel_sigma(h);
  sweep_global_kernel<T><<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const T*)fx, (const T*)fy, (const T*)fz, (const T*)fv,
      (const int4*)runs, n_runs, n_slots, Xp, Yp, Zp, PX, PY, PZ, pad,
      T(cs), T(2.0 / h), T(sigma), (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sweep_global_f32(const void* fx, const void* fy, const void* fz,
                     const void* fv, const void* runs, int n_runs,
                     int n_slots, int64_t Xp, int64_t Yp, int64_t Zp,
                     int64_t PX, int64_t PY, int64_t PZ, int pad, double cs,
                     double h, void* out, void* stream) {
  return launch<float>(fx, fy, fz, fv, runs, n_runs, n_slots, Xp, Yp, Zp,
                       PX, PY, PZ, pad, cs, h, out, stream);
}

int sweep_global_f64(const void* fx, const void* fy, const void* fz,
                     const void* fv, const void* runs, int n_runs,
                     int n_slots, int64_t Xp, int64_t Yp, int64_t Zp,
                     int64_t PX, int64_t PY, int64_t PZ, int pad, double cs,
                     double h, void* out, void* stream) {
  return launch<double>(fx, fy, fz, fv, runs, n_runs, n_slots, Xp, Yp, Zp,
                        PX, PY, PZ, pad, cs, h, out, stream);
}

}  // extern "C"
