// Per-particle SPH density sweep over the bin lattice (kernel K2).
//
// Replaces: splashsurf_tpu/ops/splat_pallas.py::density_sweep_pallas, the
// Pallas TPU kernel behind splashsurf_tpu/neighbors.py::_sweep_dispatch.
//
// Computes what the reference's portable formulation _raster_sweep_xla
// computes, in its layout. Particles sit in 8 slots per bin (bin size = the
// compact support h) as bin-relative fractions, in three rasters
// (8, LX+2, Yp, Zp) padded by one bin on every side; empty slots hold a far
// sentinel (+inf in f32, 1e15 in f64). The (y, z) plane is flattened into
// lanes, and a query sits at lane l = by * Zp + bz of output row (slot, bx).
// For every query slot s and lane l:
//   acc[s, bx, l] = sigma * sum over the 27 neighbour bins o and the
//                   8 source slots k of f(q),
//   q = 2/h * |x_q - (x_k(bin + o) + (o - 1) * bs)|,
//   f(q) = (2-q)_+^3 - 4 (1-q)_+^3,  sigma = 8 / h^3 / (4 pi),
// self term included. The output is (8, LX, W) with W = (Yp - 2) * Zp, the
// width the caller's read-back index (slot*LX + bx)*W + by*Zp + bz expects.
// A neighbour lane past the raster plane reads as empty, as the reference's
// far-filled tail lanes do.
//
// What bounds it on an H100: arithmetic. Each lane evaluates the spline
// 27 * 8 * 8 = 1728 times against 27 * 8 * 3 loads, all of them L1/L2 hits
// on rows its neighbours read too.
//
// Design: one thread per (bx, lane) holds the 8 query slots' fractions and
// sums in registers, so each source load is reused by 8 spline
// evaluations; consecutive threads take consecutive lanes, so every load is
// coalesced. An empty source slot (sentinel >= 1e14; an occupied fraction
// lies within one bin) is skipped: it contributes exactly 0 to every
// occupied query. The only lanes this changes are empty query slots, whose
// value the reference leaves NaN and nobody reads. The grid is one thread
// per output lane of the whole lattice, with no width limit: the TPU kernel
// had to leave lattices wider than 5376 lanes to XLA, this one covers all.
//
// Built without fast math (IEEE inf arithmetic on the sentinels).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_max0(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ double dev_max0(double x) { return fmax(x, 0.0); }

template <typename T>
__global__ void __launch_bounds__(128) density_sweep_kernel(
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, int64_t LX, int64_t Yp, int64_t Zp, T bs,
    T two_over_h, T sigma, T far_below, T* __restrict__ out) {
  const int64_t plane = Yp * Zp;
  const int64_t W = (Yp - 2) * Zp;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= LX * W) return;
  const int64_t l = idx % W;
  const int64_t bx = idx / W;
  const int64_t slot_stride = (LX + 2) * plane;

  T qx[kSlots], qy[kSlots], qz[kSlots], acc[kSlots];
  const int64_t q0 = (bx + 1) * plane + Zp + 1 + l;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    qx[s] = fx[s * slot_stride + q0];
    qy[s] = fy[s * slot_stride + q0];
    qz[s] = fz[s * slot_stride + q0];
    acc[s] = T(0);
  }

  for (int o0 = 0; o0 < 3; ++o0) {
    const T ox = T(o0 - 1) * bs;
    for (int o1 = 0; o1 < 3; ++o1) {
      const T oy = T(o1 - 1) * bs;
      for (int o2 = 0; o2 < 3; ++o2) {
        const int64_t j = l + o1 * Zp + o2;
        if (j >= plane) continue;  // past the plane: an empty lane
        const T oz = T(o2 - 1) * bs;
        const int64_t src0 = (bx + o0) * plane + j;
        for (int k = 0; k < kSlots; ++k) {
          const int64_t src = k * slot_stride + src0;
          const T rx = fx[src];
          if (!(rx < far_below)) continue;  // empty source slot
          const T sx = rx + ox;
          const T sy = fy[src] + oy;
          const T sz = fz[src] + oz;
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
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
  for (int s = 0; s < kSlots; ++s) {
    out[(s * LX + bx) * W + l] = acc[s] * sigma;
  }
}

template <typename T>
int launch(const void* fx, const void* fy, const void* fz, int64_t LX,
           int64_t Yp, int64_t Zp, double bs, double h, void* out,
           void* stream) {
  const int64_t n = LX * (Yp - 2) * Zp;
  if (n == 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  const double sigma = 8.0 / (h * h * h) / (4.0 * 3.14159265358979323846);
  density_sweep_kernel<T><<<(unsigned int)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const T*)fx, (const T*)fy, (const T*)fz, LX, Yp, Zp, T(bs),
      T(2.0 / h), T(sigma), T(1e14), (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int density_sweep_f32(const void* fx, const void* fy, const void* fz,
                      int64_t LX, int64_t Yp, int64_t Zp, double bs, double h,
                      void* out, void* stream) {
  return launch<float>(fx, fy, fz, LX, Yp, Zp, bs, h, out, stream);
}

int density_sweep_f64(const void* fx, const void* fy, const void* fz,
                      int64_t LX, int64_t Yp, int64_t Zp, double bs, double h,
                      void* out, void* stream) {
  return launch<double>(fx, fy, fz, LX, Yp, Zp, bs, h, out, stream);
}

}  // extern "C"
