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
// What bounds it on an H100. The work this data needs is small: rasters
// read once (about 12 MB per subdomain at n_sub = 64, hsc = 3) and some 23
// float operations per occupied (point, offset, slot) term, and a canyon
// sheet is sparse. Measured occupancy of the fullest 8M-canyon chunk
// (47, 2, 72, 72, 72) (chip_smoke.py phase 6): slot 0 is 5.6 % full, slot
// 1 0.05 %; occupied terms are 3.3 % of the 2 * 232 entries a point's fan
// covers, 2.3 % within the support radius; 36 % of the 2 x 4 x 32 tiles find
// no set bit in their window, and 53 % none in slot 1. The first design
// probed every one of those entries per point and took some 39 times its
// bound (by bytes). Visiting occupied terms only, the sweep is bound by
// instruction issue, and within a warp by its busiest lane: the sheet
// crosses the 32 z of a warp unevenly, and P = 65 leaves every third warp
// a single lane.
//
// Design: K1's (splat::level_set_tiles in level_set_sum.cuh) with the chunk
// as the outermost tile index. The masks come from K1's pre-pass over the
// chunk's (C, S, Rp, Rp) rows (occupancy_masks_* in sweep_global.cu). Blocks
// whose window is empty only write zeros; warps whose reach is empty in a
// slot skip it; the rest walk the set bits of the fan cut to the support
// radius. Built without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "level_set_sum.cuh"

extern "C" {

int splat_sweep_f32(const void* fx, const void* fy, const void* fz,
                    const void* fv, const void* masks, const void* runs,
                    int n_runs, int n_slots, int64_t C, int64_t Rp, int64_t W,
                    int64_t P, int pad, double cs, double h, void* out,
                    void* stream) {
  return splat::launch_level_set<float>(fx, fy, fz, fv, masks, runs, n_runs,
                                        n_slots, C, Rp, Rp, Rp, W, P, P, P, pad,
                                        cs, h, out, stream);
}

int splat_sweep_f64(const void* fx, const void* fy, const void* fz,
                    const void* fv, const void* masks, const void* runs,
                    int n_runs, int n_slots, int64_t C, int64_t Rp, int64_t W,
                    int64_t P, int pad, double cs, double h, void* out,
                    void* stream) {
  return splat::launch_level_set<double>(fx, fy, fz, fv, masks, runs, n_runs,
                                         n_slots, C, Rp, Rp, Rp, W, P, P, P,
                                         pad, cs, h, out, stream);
}

}  // extern "C"
