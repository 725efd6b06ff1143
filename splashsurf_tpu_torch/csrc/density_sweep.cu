// Per-particle SPH density sweep over the bin lattice (kernel K2), and the
// pre-pass of its per-bin slot occupancy.
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
// What bounds it on an H100. Measured on the 2M dam break's lattice
// (8, 146, 56, 40) (chip_smoke.py phase 3): each query slot is 78-81 %
// full, 81 % of the lanes and all but 5.6 % of the warps hold a query, and
// of the 207 occupied (query, source) pairs per particle only 31 (15 %)
// lie within the support. The first design gave each lane all 27 * 8
// source loads, branched on each loaded fraction, and paid the square root
// and the spline for 8 query slots per occupied source: its time (1.0 ms)
// followed those splines. With the spline cut to the support, the kernel
// is bound by instruction issue: the d2 of every occupied pair (8 per
// occupied source) and the splines a warp issues in step. Loads bind when
// a warp's lanes read scattered addresses: a variant in which each lane
// walked its own occupied sources as one sequence (fewer steps, no two
// lanes at the same source) ran slower than the design below. Registers
// (ptxas, phase 1): 57 in f32, 102 in f64, no spills; 8 blocks of 128
// threads per SM in f32.
//
// Design: one thread per (bx, lane) holds the 8 query slots' fractions and
// sums in registers, so each source load serves 8 queries; consecutive
// threads take consecutive lanes.
// - Skips. A warp whose lanes hold no query loads no source; a query slot
//   that no lane of the warp holds is left out of the d2 block (both
//   warp-uniform). An empty query slot ends with 0.
// - Source bytes. The pre-pass (bin_occupancy_kernel) packs, per bin, the
//   byte of its occupied slots (fraction < 1e14, the test the probing loop
//   made). For each neighbour bin the warp takes, in step, the source slots
//   that some lane's byte holds; a lane loads fx, fy, fz only where its own
//   byte has the bit, and the loads of the lanes that do coalesce.
// - Cut before the square root. A (query, source) pair with d2 > cut2 =
//   h^2 (1 + 1e-4) never reaches the spline. It is exact: such a pair has
//   sqrt(d2) >= h (1 + 5e-5) (1 - eps), so q = sqrt(d2) * (2/h) > 2 in the
//   kernel's own rounding, and its term is +0, which leaves a sum
//   unchanged bit for bit. Empty query slots (inf or 1e15) fail the cut
//   too. A warp issues a slot's spline where any of its lanes has a pair
//   under the cut; queueing the pairs to evaluate them densely was slower
//   (the queue's shared-memory traffic cost more than the splines saved).
// Summation order: per query slot, neighbour bin (o0, o1, o2 ascending) ->
// source slot, the order of the reference, though the kernel's form of q
// differs from the plain version's (q = (r + r) / h), so the two agree to
// rounding. No atomics: runs are reproducible bit for bit. Offsets within
// a slot raster are 64-bit, and the grid is one thread per output lane of
// the whole lattice, with no width limit: the TPU kernel had to leave
// lattices wider than 5376 lanes to XLA, this one covers all.
//
// Built without fast math (IEEE sqrt; inf arithmetic on empty query slots).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;
constexpr int kThreads = 128;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_max0(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ double dev_max0(double x) { return fmax(x, 0.0); }

// bytes[bin] bit k set iff fx[k, bin] < 1e14, over the n_bins bins of each
// of the 8 slot rasters
template <typename T>
__global__ void __launch_bounds__(256) bin_occupancy_kernel(
    const T* __restrict__ fx, int64_t n_bins, uint8_t* __restrict__ bytes) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_bins) return;
  T v[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) v[k] = fx[k * n_bins + i];
  uint32_t b = 0u;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) b |= (uint32_t)(v[k] < T(1e14)) << k;
  bytes[i] = (uint8_t)b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) density_sweep_kernel(
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, const uint8_t* __restrict__ bytes, int64_t LX,
    int64_t Yp, int64_t Zp, T bs, T two_over_h, T cut2, T sigma,
    T* __restrict__ out) {
  const int64_t plane = Yp * Zp;
  const int64_t W = (Yp - 2) * Zp;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = idx < LX * W;
  const int64_t l = live ? idx % W : 0;
  const int64_t bx = live ? idx / W : 0;
  const int64_t slot_stride = (LX + 2) * plane;

  T qx[kSlots], qy[kSlots], qz[kSlots], acc[kSlots];
  uint32_t qmask = 0u;
  const int64_t q0 = (bx + 1) * plane + Zp + 1 + l;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    qx[s] = qy[s] = qz[s] = acc[s] = T(0);
    if (live) {
      qx[s] = fx[s * slot_stride + q0];  // an empty slot keeps its sentinel
      if (qx[s] < T(1e14)) {
        qmask |= 1u << s;
        qy[s] = fy[s * slot_stride + q0];
        qz[s] = fz[s * slot_stride + q0];
      }
    }
  }
  // the query slots any lane of the warp holds (warp-uniform from here)
  const uint32_t wmask = __reduce_or_sync(0xffffffffu, qmask);
  if (wmask != 0u) {
#pragma unroll 1
    for (int nb = 0; nb < 27; ++nb) {
      const int o0 = nb / 9, o1 = nb / 3 % 3, o2 = nb % 3;
      const int64_t j = l + o1 * Zp + o2;
      const int64_t src0 = (bx + o0) * plane + j;
      // this lane's occupied source slots; past the plane an empty lane
      const uint32_t b = qmask != 0u && j < plane ? __ldg(bytes + src0) : 0u;
      const T ox = T(o0 - 1) * bs, oy = T(o1 - 1) * bs, oz = T(o2 - 1) * bs;
      uint32_t wb = __reduce_or_sync(0xffffffffu, b);
#pragma unroll 1
      while (wb != 0u) {  // the warp's source slots in step: loads coalesce
        const int k = __ffs(wb) - 1;
        wb &= wb - 1u;
        if (!(b >> k & 1u)) continue;
        const int64_t src = k * slot_stride + src0;
        const T sx = __ldg(fx + src) + ox;
        const T sy = __ldg(fy + src) + oy;
        const T sz = __ldg(fz + src) + oz;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (!(wmask >> s & 1u)) continue;
          const T dx = qx[s] - sx;
          const T dy = qy[s] - sy;
          const T dz = qz[s] - sz;
          const T d2 = dx * dx + dy * dy + dz * dz;
          if (d2 <= cut2) {  // beyond it the term is exactly +0
            const T q = dev_sqrt(d2) * two_over_h;
            const T a = dev_max0(T(2) - q);
            const T c = dev_max0(T(1) - q);
            acc[s] += a * a * a - T(4) * (c * c * c);
          }
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      out[(s * LX + bx) * W + l] = (qmask >> s & 1u) ? acc[s] * sigma : T(0);
  }
}

template <typename T>
int launch_occupancy(const void* fx, int64_t n_bins, void* bytes, void* stream) {
  if (n_bins == 0) return 0;
  const int64_t blocks = (n_bins + 255) / 256;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  bin_occupancy_kernel<T><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)fx, n_bins, (uint8_t*)bytes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* fx, const void* fy, const void* fz, const void* bytes,
           int64_t LX, int64_t Yp, int64_t Zp, double bs, double h,
           double cut2, void* out, void* stream) {
  const int64_t n = LX * (Yp - 2) * Zp;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const double sigma = 8.0 / (h * h * h) / (4.0 * 3.14159265358979323846);
  density_sweep_kernel<T><<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const T*)fx, (const T*)fy, (const T*)fz, (const uint8_t*)bytes, LX, Yp,
      Zp, T(bs), T(2.0 / h), T(cut2), T(sigma), (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bin_occupancy_f32(const void* fx, int64_t n_bins, void* bytes, void* stream) {
  return launch_occupancy<float>(fx, n_bins, bytes, stream);
}

int bin_occupancy_f64(const void* fx, int64_t n_bins, void* bytes, void* stream) {
  return launch_occupancy<double>(fx, n_bins, bytes, stream);
}

int density_sweep_f32(const void* fx, const void* fy, const void* fz,
                      const void* bytes, int64_t LX, int64_t Yp, int64_t Zp,
                      double bs, double h, double cut2, void* out,
                      void* stream) {
  return launch<float>(fx, fy, fz, bytes, LX, Yp, Zp, bs, h, cut2, out, stream);
}

int density_sweep_f64(const void* fx, const void* fy, const void* fz,
                      const void* bytes, int64_t LX, int64_t Yp, int64_t Zp,
                      double bs, double h, double cut2, void* out,
                      void* stream) {
  return launch<double>(fx, fy, fz, bytes, LX, Yp, Zp, bs, h, cut2, out, stream);
}

}  // extern "C"
