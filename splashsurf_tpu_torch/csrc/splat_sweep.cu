// Per-subdomain level-set sweep (kernel K3).
//
// Replaces: splashsurf_tpu/ops/splat_pallas.py::splat_sweep_pallas, the
// Pallas TPU kernel behind splashsurf_tpu/subdomains.py::chunk_levelset_raster.
//
// Computes, for each of the C subdomains of a chunk and every point p of
// its (P, P, P) point block (P = n_sub + 1),
//   phi(c, p) = sigma * sum_s sum_o f(q) * v_s(c, p + o),
// the sum of kernel K1 (level_set_sum.cuh) over the chunk's own rasters
// (C, S, Rp, Rp, Rp), Rp = n_sub + 2 m + 2: the subdomain's cells, its
// ghost margin of m = hsc cells, and one empty cell on every side. The
// offsets o are the pruned fan density.gather_cell_offsets(hsc) shifted by
// pad = m + 1, passed as a run table. Output (C, P, P, P) is written
// directly, with no padding or slicing afterwards.
//
// q form: q = sqrt(d2) * (2 / h), scaled by sigma = 8 / h^3 / (4 pi) once
// per point. The plain version (splat_sweep_plain) goes through
// kernels.cubic_kernel, q = (r + r) / h, scaled per term: the two agree to
// rounding, not bit for bit.
//
// What bounds it on an H100: the work this data needs is small (rasters
// read once, about 12 MB per subdomain at n_sub = 64, hsc = 3, and some 24
// float operations per occupied (point, offset, slot) term), but the kernel
// visits all S * |fan| = 464 window entries of every point and reads each
// weight: it is bound by L1/L2 load traffic, as K1 is. A sparse sheet
// leaves most entries empty, which skip their three fraction loads.
//
// Design: K1's, with a chunk index: one thread per output point, z fastest
// (a warp reads consecutive addresses of each window row), the run table
// for the fan, empty slots skipped, 64-bit offsets. Built without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "level_set_sum.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) splat_sweep_kernel(
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, const T* __restrict__ fv,
    const int4* __restrict__ runs, int n_runs, int n_slots, int64_t C,
    int64_t Rp, int64_t P, int pad, T cs, T two_over_h, T sigma,
    T* __restrict__ out) {
  const int64_t per_chunk = P * P * P;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * per_chunk) return;
  const int64_t c = idx / per_chunk;
  const int64_t r = idx - c * per_chunk;
  const int64_t z = r % P;
  const int64_t y = (r / P) % P;
  const int64_t x = r / (P * P);
  const int64_t slot_stride = Rp * Rp * Rp;
  const int64_t base = c * n_slots * slot_stride;
  out[idx] = splat::level_set_sum(fx + base, fy + base, fz + base, fv + base,
                                  runs, n_runs, n_slots, slot_stride, Rp, Rp,
                                  x, y, z, pad, cs, two_over_h) *
             sigma;
}

template <typename T>
int launch(const void* fx, const void* fy, const void* fz, const void* fv,
           const void* runs, int n_runs, int n_slots, int64_t C, int64_t Rp,
           int64_t P, int pad, double cs, double h, void* out, void* stream) {
  const int64_t n_out = C * P * P * P;
  if (n_out == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  splat_sweep_kernel<T><<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)fx, (const T*)fy, (const T*)fz, (const T*)fv,
      (const int4*)runs, n_runs, n_slots, C, Rp, P, pad, T(cs), T(2.0 / h),
      T(splat::kernel_sigma(h)), (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int splat_sweep_f32(const void* fx, const void* fy, const void* fz,
                    const void* fv, const void* runs, int n_runs, int n_slots,
                    int64_t C, int64_t Rp, int64_t P, int pad, double cs,
                    double h, void* out, void* stream) {
  return launch<float>(fx, fy, fz, fv, runs, n_runs, n_slots, C, Rp, P, pad,
                       cs, h, out, stream);
}

int splat_sweep_f64(const void* fx, const void* fy, const void* fz,
                    const void* fv, const void* runs, int n_runs, int n_slots,
                    int64_t C, int64_t Rp, int64_t P, int pad, double cs,
                    double h, void* out, void* stream) {
  return launch<double>(fx, fy, fz, fv, runs, n_runs, n_slots, C, Rp, P, pad,
                        cs, h, out, stream);
}

}  // extern "C"
