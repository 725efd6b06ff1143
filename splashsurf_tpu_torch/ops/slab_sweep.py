"""Dense global reconstruction streamed over x-slabs of the grid (PyTorch
port of ``splashsurf_tpu.ops.slab_sweep``).

Past the dense gate (160M cells, ``reconstruction.global_dense_max_cells``)
a grid that fits at most 64 slabs of at most 48M cells each takes this
route by default: the dense route's raster, sweep (kernel K1) and marching
cubes run slab by slab, so the working set is one slab's, and there is no
pair sort, subdomain batching or stitch.

The mesh equals the dense route's on the same grid, vertex for vertex and
triangle for triangle, through the reference's two invariants:

- **Shared planes have the same bits in both slabs.** Every slab computes
  cells and fractions against the global grid origin
  (``rasterize_global(..., slab_ncx=W, slab_x0=x0)``), and a slab's
  particles are picked by a mask over their global cell x, which keeps
  ascending particle index: slot ranks, and with them the order of every
  sum, are the dense route's.
- **Every point is emitted by one slab.** Slabs run in descending x; each
  slab's far plane W is overwritten with the next slab's plane 0 (the
  plane handoff), and ``mc_point_words`` gives the points at x >= own_px no
  word. The slabs' active points merge, in ascending x, into the dense
  route's active-point list, and ``mc_mesh_from_points`` runs once on it.

The reference's bucket buffers, capacity plans and retries exist for its
static shapes: the port sizes every tensor exactly. By default (the packed
pull) it keeps each slab's (point ids, words, edge parameters) on the
device until the merge. With ``SPLASHSURF_TPU_PULL=encoded`` it does what
the reference always does (its ops/slab_sweep.py:189-194, 366-430): each
slab's active points become the encoded streams of
``gs.encode_points`` (u16 t where ``SPLASHSURF_TPU_PULL_QUANT`` asks),
all slabs' streams come to the host in one copy, and the host merges them
into one ascending point list, each slab's axis-major t regrouped across
slabs, and decodes it once (``native.mc_decode``; numpy in f64). The mesh
is the dense route's encoded mesh, bit for bit. Point ids are int64, so
no grid size limits the merge (the reference's ids are int32).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from splashsurf_tpu_torch import kernels, neighbors
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.ops import global_sweep as gs
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.profiling import StageClock, profile
from splashsurf_tpu_torch.reconstruction import SurfaceReconstruction
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

# Facts about the last slab run, read by tests and chip_smoke.py, never by
# the pipeline (the reference keeps them in ``subdomains.LAST_RUN``):
# "slabbed", "n_slabs", the slab width "slab_w" in cells, "slab_cells"
# (W * ncy * ncz), "rows" (particles rasterized per slab, ascending x) and
# "stage_s", the device-synchronised seconds of each stage.
LAST_RUN: dict = {}


def gs_dense_gate() -> int:
    """Cells per slab of the slab route (``SPLASHSURF_TPU_SLAB_CELLS_BUDGET``,
    default 48M, as the reference's ops/slab_sweep.py:450-460 reads it), read
    at each call."""
    return int(os.environ.get("SPLASHSURF_TPU_SLAB_CELLS_BUDGET", 48_000_000))


def slab_width_cells(grid: UniformGrid, max_cells: int) -> int:
    """Slab width in cells (ops/slab_sweep.py:51 of the reference): one
    slab's cells stay within ``max_cells``; at least 8 cells, at most the
    whole grid."""
    _, ncy, ncz = grid.n_cells
    return int(max(8, min(grid.n_cells[0], max_cells // max(1, ncy * ncz))))


def reconstruct_global_slabbed(
    positions,
    values,
    grid: UniformGrid,
    compact_support_radius: float,
    hsc: int,
    iso: float,
    slots: Optional[int] = None,
    max_cells: Optional[int] = None,
    clock: Optional[StageClock] = None,
    device=None,
):
    """The dense route's mesh, computed slab by slab on the positions'
    device: (vertices (V, 3), triangles (T, 3) int32) as device tensors,
    or, with the encoded pull (``SPLASHSURF_TPU_PULL=encoded``), as host
    tensors decoded from the slabs' streams; equal to
    ``gs.reconstruct_global_dense`` in the same mode at the same ``slots``
    (by default ``SPLASHSURF_TPU_SLAB_SLOTS``, read per call, else 2, the
    dense route's).

    ``max_cells`` bounds one slab's cells (default ``gs_dense_gate()``).
    ``clock`` (a ``StageClock``) takes the stage laps; ``LAST_RUN`` records
    the run. Arrays go to ``device`` (``placement.on_device``)."""
    positions, values = on_device(positions, values, device=device)
    if max_cells is None:
        max_cells = gs_dense_gate()
    if slots is None:
        slots = int(os.environ.get("SPLASHSURF_TPU_SLAB_SLOTS", "2"))
    if clock is None:
        clock = StageClock(positions.device)
    dtype = positions.dtype
    W = slab_width_cells(grid, max_cells)
    ncx, ncy, ncz = grid.n_cells
    n_slabs = -(-ncx // W)
    pad = hsc + 1
    LAST_RUN.clear()
    LAST_RUN.update(slabbed=True, n_slabs=n_slabs, slab_w=W, slab_cells=W * ncy * ncz,
                    rows=[], stage_s=clock.times)
    cs = kernels.rounded(grid.cell_size, dtype)
    cx = gs.cell_of(positions[:, 0], kernels.rounded(grid.min[0], dtype), cs, ncx)
    in_grid = (cx >= 0) & (cx < ncx)

    encoded = os.environ.get("SPLASHSURF_TPU_PULL", "packed") == "encoded"
    quant = encoded and gs.pull_quant(dtype)
    PY, PZ = grid.n_points[1], grid.n_points[2]
    parts, ls_max = [], []
    plane = None
    with profile("slab sweep+mc"):
        for s in reversed(range(n_slabs)):
            x0 = s * W
            with profile("slab ls"):
                sel = torch.nonzero(in_grid & (cx >= x0 - pad) & (cx < x0 + W + pad)).squeeze(1)
                LAST_RUN["rows"].insert(0, int(sel.shape[0]))
                rasters, overflow = gs.rasterize_global(
                    positions[sel], values[sel], grid, slots, hsc, slab_ncx=W, slab_x0=x0
                )
                del sel
                clock.lap("selection and raster")
                ls = gs.sweep_global(
                    rasters, overflow, grid, compact_support_radius, hsc,
                    slab_npx=W + 1, slab_x0=x0,
                )
                del rasters, overflow
                if plane is not None:
                    ls[W] = plane  # the next slab's plane 0, bit for bit
                plane = ls[0].clone()
                ls_max.append(ls.max())
                clock.lap("sweep")
            with profile("slab mc"):
                own_px = W if s < n_slabs - 1 else ncx - x0 + 1
                words = gs.mc_point_words(ls, grid, iso, x0=x0, own_px=own_px)
                if encoded:
                    words = gs.encode_points(*words, ls.numel(), x0 * PY * PZ, quant_t=quant)
                parts.append(words)
                del ls, words
                clock.lap("marching cubes")
    del plane

    parts.reverse()  # ascending x: the merged ids ascend
    if encoded:
        with profile("slab decode"):
            return _decode_slab_streams(parts, W, grid, ls_max, iso, clock)
    with profile("slab decode"):
        points = torch.cat([p[0] for p in parts])
        words = torch.cat([p[1] for p in parts])
        t = torch.cat([p[2] for p in parts], dim=1)
        del parts
        verts, tris = gs.mc_mesh_from_points(points, words, t, grid)
        if tris.shape[0] == 0:
            gs.check_empty_field(0, float(torch.stack(ls_max).max()), float(iso))
    return verts, tris


def _decode_slab_streams(parts, W: int, grid: UniformGrid, ls_max, iso, clock: StageClock):
    """The host mesh of the slabs' encoded streams (ascending x): one copy
    of every slab's (t, packed, counts, totals), then per slab the packed
    words unpacked into global int64 point ids, and each slab's axis-major
    t cut at its per-axis vertex counts and regrouped axis-major across the
    slabs; one decode of the merged list (``gs.decode_encoded``'s choice of
    decoder). Returns (vertices, triangles int32) as host tensors;
    ``LAST_RUN`` gets "pull_bytes", the bytes copied; laps "merge and pull"
    at the end of the copy and "decode" at the end of the host merge and
    decode."""
    PY, PZ = grid.n_points[1], grid.n_points[2]
    flat = [x for p in parts for x in p[:3]]
    totals = torch.stack([torch.stack(p[3:]) for p in parts]).reshape(-1)
    host = gs.PendingPull(None, flat + [totals, torch.stack(ls_max)]).host_parts()
    tot = host[-2].numpy().reshape(-1, 3)
    LAST_RUN["pull_bytes"] = sum(h.numel() * h.element_size() for h in host)
    clock.lap("merge and pull")
    total_v, total_t, total_c = (int(x) for x in tot.sum(0))
    if total_t == 0:
        gs.check_empty_field(0, float(host[-1].max()), float(iso))
    t_ax, pts, wds = [[], [], []], [], []
    for s in range(len(parts)):
        tv, packed, bincl = (h.numpy() for h in host[3 * s : 3 * s + 3])
        p, w = gs.unpack_points(tv, packed, bincl, int(tot[s, 2]), s * W * PY * PZ)
        na = np.cumsum([0] + [int(((w >> (8 + a)) & 1).sum()) for a in range(3)])
        for a in range(3):
            t_ax[a].append(tv[na[a] : na[a + 1]])
        pts.append(p)
        wds.append(w)
    t_all = np.concatenate([seg for a in range(3) for seg in t_ax[a]])
    verts, tris = gs.decode_encoded_points(
        t_all, np.concatenate(pts), np.concatenate(wds), total_v, total_t, total_c, grid
    )
    clock.lap("decode")
    return torch.from_numpy(verts), torch.from_numpy(tris)


def reconstruct_surface_slabbed(
    positions,
    parameters,
    grid: UniformGrid,
    particle_inside_aabb: Optional[np.ndarray] = None,
    n_valid: Optional[int] = None,
    device=None,
):
    """The slab route of ``reconstruct_surface`` on the positions' device:
    densities over all particles, weights m / rho, the slab loop, the mesh
    to the host and, with ``parameters.global_neighborhood_list``, the
    particle neighbour lists. The per-particle densities stay a device
    tensor. ``LAST_RUN["stage_s"]`` holds the stages "densities",
    "selection and raster", "sweep" and "marching cubes" (summed over the
    slabs), "merge and pull", with the encoded pull "decode" (the host
    merge and decode), and, when asked, "neighbour lists". Only the
    first ``n_valid`` rows of ``positions`` are particles, where that is
    given. An array goes to ``device`` (``placement.on_device``)."""
    positions = on_device(positions, device=device)
    if n_valid is not None:
        positions = positions[: int(n_valid)]
    h = parameters.compact_support_radius
    hsc = kernel_extents(h, grid.cell_size).half_supported_cells
    clock = StageClock(positions.device)
    with profile("compute particle densities"):
        rho = neighbors.compute_particle_densities(positions, h, parameters.particle_rest_mass)
        values = kernels.rounded(parameters.particle_rest_mass, rho.dtype) / rho
    clock.lap("densities")
    with profile("slab reconstruction"):
        verts, tris = reconstruct_global_slabbed(
            positions, values, grid, h, hsc, parameters.iso_surface_threshold, clock=clock
        )
        with profile("slab pull"):
            mesh = TriMesh3d(vertices=verts.cpu().numpy(), triangles=tris.cpu().numpy())
    del verts, tris
    clock.lap("merge and pull")
    lists = neighbors.particle_neighbor_lists(positions, parameters)
    if lists is not None:
        clock.lap("neighbour lists")
    return SurfaceReconstruction(
        grid=grid, mesh=mesh, particle_densities=rho, particle_neighbors=lists,
        particle_inside_aabb=particle_inside_aabb,
    )
