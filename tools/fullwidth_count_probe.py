#!/usr/bin/env python3
"""Where do the card's and the JAX package's f32 vertex counts part on a
full-width dense scene?

    python3 tools/fullwidth_count_probe.py [scene]   # default dam_break_13m_f32

On one card, for a dense scene of ``tests/goldens/torch_fullwidth.json``
(its positions rebuilt from the port's generators): the dense route's
level set in f32 from the densities of kernel K2 and from the plain
densities on the host CPU, each swept by kernel K1 and by K1's plain
version on the card, and the same level set in f64 (K2, K1). For each
the marching-cubes counts (``mc.dense._mc_counts``) beside the JAX
package's counts from the file, and for the grid points whose side of
the iso value differs between two f32 level sets, their values and the
f64 value there. Prints one JSON object last.
"""

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else "dam_break_13m_f32"
    if not torch.cuda.is_available():
        print("fullwidth_count_probe: no CUDA device", file=sys.stderr)
        return 2
    import splashsurf_tpu_torch as pt
    from splashsurf_tpu_torch import bench
    from splashsurf_tpu_torch import neighbors as N
    from splashsurf_tpu_torch.mc.dense import _mc_counts
    from splashsurf_tpu_torch.ops import global_sweep as gs
    from splashsurf_tpu_torch.ops import splat_kernels as sk
    from splashsurf_tpu_torch.reconstruction import _bucket_grid
    from splashsurf_tpu_torch.uniform_grid import kernel_extents

    with open(cs.GOLDEN_FILE) as f:
        g = json.load(f)[name]
    args = g["args"]
    pts_np = bench.jittered(getattr(bench, g["generator"])(**args), bench.RADIUS, g["jitter"])
    sk.load_kernels()
    dev = torch.device("cuda", 0)
    out = {"card": cs.card_identity(), "scene": name, "n": len(pts_np),
           "jax": [g["summary"]["num_vertices"], g["summary"]["num_triangles"]]}
    params = pt.Parameters.new_relative(bench.RADIUS, 4.0, 1.5)
    h, m = params.compact_support_radius, params.particle_rest_mass
    iso = params.iso_surface_threshold

    def level_set(pts, rho, plain_sweep):
        grid = _bucket_grid(pt.grid_for_reconstruction(pts, bench.RADIUS, h, params.cube_size))
        hsc = kernel_extents(h, grid.cell_size).half_supported_cells
        rasters, overflow = gs.rasterize_global(pts, m / rho, grid, 2, hsc)
        saved = gs.sweep_global_cuda
        if plain_sweep:
            gs.sweep_global_cuda = sk.sweep_global_plain
        try:
            ls = gs.sweep_global(rasters, overflow, grid, h, hsc)
        finally:
            gs.sweep_global_cuda = saved
        torch.cuda.synchronize()
        return ls, int(overflow[0].shape[0])

    pts = torch.as_tensor(pts_np, device=dev)
    N.reset_geoslot_hysteresis()
    rho_k2 = N.compute_particle_densities(pts, h, m)
    t0 = time.perf_counter()
    N.reset_geoslot_hysteresis()
    rho_cpu = N.compute_particle_densities(torch.as_tensor(pts_np), h, m).to(dev)
    out["cpu_density_s"] = time.perf_counter() - t0
    out["rho_k2_vs_plain_max_rel"] = float(((rho_k2 - rho_cpu).abs() / rho_cpu).max())
    N.reset_geoslot_hysteresis()
    rho64 = N.compute_particle_densities(pts.double(), h, m)
    ls64, _ = level_set(pts.double(), rho64, False)
    out["f64_counts"] = list(_mc_counts(ls64, iso))
    sets = {}
    for rho_name, rho in (("K2", rho_k2), ("plain", rho_cpu)):
        for sweep_name, plain in (("K1", False), ("plain", True)):
            ls, n_over = level_set(pts, rho, plain)
            key = f"rho {rho_name}, sweep {sweep_name}"
            sets[key] = ls
            out[key] = {"counts": list(_mc_counts(ls, iso)), "overflow": n_over}
    if any(ls.shape != ls64.shape for ls in sets.values()):
        raise AssertionError("the f32 and f64 level sets lie on different grids")
    inside64 = ls64 >= iso
    flips = {}
    keys = list(sets)
    for i, a in enumerate(keys):
        ia = sets[a] >= np.float32(iso)
        flips[f"{a} / f64"] = int((ia != inside64).sum())
        for b in keys[i + 1:]:
            ib = sets[b] >= np.float32(iso)
            where = torch.nonzero((ia != ib).reshape(-1)).flatten()
            rows = []
            for idx in where[:8].tolist():
                rows.append([float(sets[a].reshape(-1)[idx]), float(sets[b].reshape(-1)[idx]),
                             float(ls64.reshape(-1)[idx])])
            flips[f"{a} / {b}"] = {"points": int(where.numel()), "values (a, b, f64)": rows}
    out["points whose side of iso differs"] = flips
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
