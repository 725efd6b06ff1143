// Per-particle SPH density sweep of the binned formulation (kernel K5).
//
// Replaces no TPU kernel: the reference's binned formulation
// (splashsurf_tpu/neighbors.py::compute_particle_densities_binned) is plain
// XLA. It is the port's density path wherever the gate leaves the dense
// rasters of K2 (sparse lattices, and fluids whose bins hold more than 8
// particles in too many places: every moving frame of the 13M dam break),
// where the plain PyTorch loop swept (u_cap, K, K) pair blocks for each of
// the 27 stencil offsets.
//
// Input: the cell list of neighbors.build_cell_list (positions sorted by
// flat bin id), each sorted particle's bin rank among the occupied bins,
// the ascending occupied bin ids (R rows; rows past the occupied bins hold
// a sentinel past the lattice), each rank's first sorted index (R + 1
// entries, n past the occupied bins), and, for lattices up to
// RANK_TABLE_MAX bins, the dense table bin id -> rank (-1 empty); larger
// lattices find a neighbour's rank by binary search over the occupied ids.
// For each sorted particle i of rank r < R and within-bin slot < K:
//   out[i] = sigma * sum over the 27 stencil offsets o (flat bin id
//            b_i + o inside [0, lattice)) and the first min(count, K)
//            particles j of that bin of f(q),
//   q = |x_i - x_j| * 2/h, f(q) = (2-q)_+^3 - 4 (1-q)_+^3,
//   sigma = 8 / h^3 / (4 pi),
// self term included; every other particle gets 0 (the overflow
// correction adds the rank >= K particles of binned8). Summation order:
// offsets in the stencil's order, sources in sorted order within a bin,
// one partial sum per bin: the plain version's order (its form of q is
// (r + r) / h, scaled per term), so the two agree to rounding.
//
// What bounds it on an H100. On the benchmark's sheared 13.2M dam-break
// frame (K = 16, 1.67M occupied bins of 7.94 particles on average) each
// particle has 211.5 candidate sources in its 27 bins and 31.4 within the
// support (chip_smoke.py phase 23): 2.80G distances and 0.42G splines,
// 0.463 ms of float32 work at 9 and 14 operations each; the bytes
// (positions, ranks and tables in, densities out) take 0.1 ms. So it is
// bound by instruction throughput, and the design spends none on what the
// plain version wasted: padded slots (K = 16 against 7.94), the rows past
// the occupied bins, and the spline of a pair beyond the support. Registers
// (ptxas): 30 in f32, 42 in f64, no spills, no shared memory.
//
// Design: one thread per query particle in sorted order. The offset loop is
// warp-uniform; each lane walks the runs of its own 27 neighbour bins, so
// lanes of one bin read the same sources (broadcast) and lanes of the next
// z-bin the next run, within the same cache lines.
// - Against staged sources. A second design gave a block of 128 queries
//   the sources of its 9 (x, y) neighbour columns in shared memory (each
//   column one contiguous sorted range, found by binary search; a block
//   whose columns did not fit read them as here). On the sheared 13.2M
//   frame (NVIDIA H100 80GB HBM3, 700 W) it took 6.188 ms against 5.524 ms
//   here (2M frame: 1.007 against 0.895 ms): the L1 cache already serves
//   the overlapping runs, and staging adds a pass and two barriers. That
//   is 11.9x the bound; the rest is lanes of a warp waiting on the longest
//   run and on the spline any lane needs (a warp evaluates it for all).
// - Cut before the square root, as in K2: a pair with d2 > cut2 = h^2 (1 +
//   1e-4) never reaches the spline. Its term is exactly +0 (sqrt(d2) * 2/h
//   > 2 in the kernel's rounding), so the cut changes no sum.
// - No atomics, no shared state: runs are reproducible bit for bit.
//
// Built without fast math (IEEE sqrt).

#include <cuda_runtime.h>
#include <stdint.h>

#include "level_set_sum.cuh"

namespace {

using splat::dev_max0;
using splat::dev_sqrt;

constexpr int kThreads = 128;

// Rank of the occupied bin t (0 <= t < lattice) among the R rows, or -1.
template <bool kTable>
__device__ __forceinline__ int64_t rank_of(int64_t t, const int64_t* __restrict__ rank_table,
                                           const int64_t* __restrict__ occ, int64_t R) {
  if (kTable) return __ldg(rank_table + t);
  int64_t lo = 0, hi = R;  // lower bound of t in the ascending occupied ids
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(occ + mid) < t) lo = mid + 1;
    else hi = mid;
  }
  return lo < R && __ldg(occ + lo) == t ? lo : -1;
}

struct Lattice {
  int64_t n, R, K, lattice, sx, sy;  // sx = dy * dz, sy = dz
};

template <typename T, bool kTable>
__global__ void __launch_bounds__(kThreads) binned_sweep_kernel(
    const T* __restrict__ px, const T* __restrict__ py, const T* __restrict__ pz,
    const int64_t* __restrict__ bin_rank, const int64_t* __restrict__ occ,
    const int64_t* __restrict__ run_start, const int64_t* __restrict__ rank_table,
    Lattice L, T two_over_h, T cut2, T sigma, T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L.n) return;
  const int64_t r = bin_rank[i];
  if (r >= L.R || i - __ldg(run_start + r) >= L.K) {
    out[i] = T(0);
    return;
  }
  const int64_t b = __ldg(occ + r);
  const T qx = px[i], qy = py[i], qz = pz[i];
  T acc = T(0);
#pragma unroll 1
  for (int o = 0; o < 27; ++o) {
    const int64_t t = b + (o / 9 - 1) * L.sx + (o / 3 % 3 - 1) * L.sy + (o % 3 - 1);
    if (t < 0 || t >= L.lattice) continue;
    const int64_t rn = rank_of<kTable>(t, rank_table, occ, L.R);
    if (rn < 0) continue;
    const int64_t s0 = __ldg(run_start + rn);
    const int64_t s1 = min(__ldg(run_start + rn + 1), s0 + L.K);
    T part = T(0);  // this bin's sum, added once: the plain version's order
#pragma unroll 1
    for (int64_t j = s0; j < s1; ++j) {
      const T dx = qx - __ldg(px + j);
      const T dy = qy - __ldg(py + j);
      const T dz = qz - __ldg(pz + j);
      const T d2 = dx * dx + dy * dy + dz * dz;
      if (d2 <= cut2) {  // beyond it the term is exactly +0
        const T q = dev_sqrt(d2) * two_over_h;
        const T a = dev_max0(T(2) - q);
        const T c = dev_max0(T(1) - q);
        part += a * a * a - T(4) * (c * c * c);
      }
    }
    acc += part;
  }
  out[i] = acc * sigma;
}

template <typename T, bool kTable>
int launch_lookup(const void* px, const void* py, const void* pz, const void* bin_rank,
                  const void* occ, const void* run_start, const void* rank_table, Lattice L,
                  double h, double cut2, void* out, void* stream) {
  const int64_t blocks = (L.n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const double sigma = 8.0 / (h * h * h) / (4.0 * 3.14159265358979323846);
  binned_sweep_kernel<T, kTable><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)px, (const T*)py, (const T*)pz, (const int64_t*)bin_rank,
      (const int64_t*)occ, (const int64_t*)run_start, (const int64_t*)rank_table, L,
      T(2.0 / h), T(cut2), T(sigma), (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* px, const void* py, const void* pz, const void* bin_rank,
           const void* occ, const void* run_start, const void* rank_table, int64_t n,
           int64_t R, int64_t K, int64_t lattice, int64_t dy, int64_t dz, double h,
           double cut2, void* out, void* stream) {
  if (n == 0) return 0;
  if (R <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const Lattice L{n, R, K, lattice, dy * dz, dz};
  return rank_table != nullptr
             ? launch_lookup<T, true>(px, py, pz, bin_rank, occ, run_start, rank_table, L, h,
                                      cut2, out, stream)
             : launch_lookup<T, false>(px, py, pz, bin_rank, occ, run_start, rank_table, L, h,
                                       cut2, out, stream);
}

}  // namespace

extern "C" {

int binned_sweep_f32(const void* px, const void* py, const void* pz, const void* bin_rank,
                     const void* occ, const void* run_start, const void* rank_table,
                     int64_t n, int64_t R, int64_t K, int64_t lattice, int64_t dy,
                     int64_t dz, double h, double cut2, void* out, void* stream) {
  return launch<float>(px, py, pz, bin_rank, occ, run_start, rank_table, n, R, K, lattice,
                       dy, dz, h, cut2, out, stream);
}

int binned_sweep_f64(const void* px, const void* py, const void* pz, const void* bin_rank,
                     const void* occ, const void* run_start, const void* rank_table,
                     int64_t n, int64_t R, int64_t K, int64_t lattice, int64_t dy,
                     int64_t dz, double h, double cut2, void* out, void* stream) {
  return launch<double>(px, py, pz, bin_rank, occ, run_start, rank_table, n, R, K, lattice,
                        dy, dz, h, cut2, out, stream);
}

}  // extern "C"
