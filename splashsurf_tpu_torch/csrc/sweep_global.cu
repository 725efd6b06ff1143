// Level-set sweep over the global background grid (kernel K1), and the
// occupancy-mask pre-pass that K1 and K3 read.
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
// What bounds it on an H100. Measured occupancy of the 2M dam break's
// rasters (2, 392, 160, 112) (chip_smoke.py phase 2): slot 1 is all but
// empty (0.0001 % of its entries: the jittered lattice puts more than one
// particle in a cell almost never) and slot 0 is 28 % full, so of the
// 2 * 232 entries a point's fan covers at hsc = 3 only 16 % hold a
// particle, and 11 % once the fan is cut to the support radius. The bytes
// the data needs (rasters read once, 0.07 ms at HBM rate) and the float
// operations of those terms (0.11 ms) are far below the 4 ms of the first
// design, which probed every entry. Visiting the occupied terms only, the
// sweep is bound by instruction issue: the terms' arithmetic and each
// lane's walk over its runs, which diverges within a warp.
//
// Design: splat::level_set_tiles (level_set_sum.cuh), shared with kernel
// K3. The pre-pass exported here (occupancy_masks_*) packs one bit per
// raster entry; a 256-thread block of 2 x 4 rows of 32 z stages its
// window's mask words in shared memory and skips slot 1 as a whole where
// its window holds nothing (99.4 % of the blocks here); each warp marks in
// step the runs of the fan (cut to the support radius) that hold a set bit
// for each lane, and each lane walks only the set bits of its marked runs,
// in the probing loop's order. Built without fast math: the empty-slot
// sentinel relies on IEEE inf arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "level_set_sum.cuh"

extern "C" {

int occupancy_masks_f32(const void* fv, int64_t n_rows, int64_t Zp, int64_t W,
                        int fractions, void* masks, void* stream) {
  return splat::occupancy_masks<float>(fv, n_rows, Zp, W, fractions, masks,
                                       (cudaStream_t)stream);
}

int occupancy_masks_f64(const void* fv, int64_t n_rows, int64_t Zp, int64_t W,
                        int fractions, void* masks, void* stream) {
  return splat::occupancy_masks<double>(fv, n_rows, Zp, W, fractions, masks,
                                        (cudaStream_t)stream);
}

int sweep_global_f32(const void* fx, const void* fy, const void* fz,
                     const void* fv, const void* masks, const void* runs,
                     int n_runs, int n_slots, int64_t Xp, int64_t Yp,
                     int64_t Zp, int64_t W, int64_t PX, int64_t PY, int64_t PZ,
                     int pad, double cs, double h, void* out, void* stream) {
  return splat::launch_level_set<float>(fx, fy, fz, fv, masks, runs, n_runs,
                                        n_slots, 1, Xp, Yp, Zp, W, PX, PY, PZ,
                                        pad, cs, h, out, stream);
}

int sweep_global_f64(const void* fx, const void* fy, const void* fz,
                     const void* fv, const void* masks, const void* runs,
                     int n_runs, int n_slots, int64_t Xp, int64_t Yp,
                     int64_t Zp, int64_t W, int64_t PX, int64_t PY, int64_t PZ,
                     int pad, double cs, double h, void* out, void* stream) {
  return splat::launch_level_set<double>(fx, fy, fz, fv, masks, runs, n_runs,
                                         n_slots, 1, Xp, Yp, Zp, W, PX, PY, PZ,
                                         pad, cs, h, out, stream);
}

// The level-set sweep's block geometry (K1 and K3), as the launch uses it:
// out = (tile x, tile y, tile z, staged mask words per window row, dynamic
// shared memory bytes of one block).
void sweep_geometry(int n_runs, int n_slots, int pad, int t_size, int64_t* out) {
  out[0] = splat::kTileX;
  out[1] = splat::kTileY;
  out[2] = 32;
  out[3] = splat::window_words(pad);
  out[4] = (int64_t)splat::level_set_smem(n_runs, n_slots, pad, (size_t)t_size);
}

}  // extern "C"
