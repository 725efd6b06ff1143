"""Global (single dense grid) reconstruction pipeline (PyTorch port of
``splashsurf_tpu.global_pipeline``): densities -> particle weights m / rho
-> level set on the full background grid -> marching cubes
(reconstruction.rs:65-194).

A frame runs on the speculative plans of the frames before it, as the
reference's does (``plans``): the density plan, the background grid
(checked through ``grid_check``), and the dense route's overflow, MC and
pull plans. Their checks come back with the mesh; the outcomes are counted
in ``SPECULATION_STATS`` (``plans.SPECULATION_STATS``) under the
reference's keys.

The cell-raster densities (``_cellrast_frame``) skip the density stage: rho
comes from a pair sweep (kernel K4) over the fraction rasters that the level
set builds anyway. They are off by default, as in the reference, and turned
on by ``SPLASHSURF_TPU_DENSITY_CELLRASTER``, read per call: "1" for CUDA
tensors, "1cpu" for CPU tensors too. As in the reference
(global_pipeline.py:383-389), a frame takes them when the switch is on, the
previous frame of the same (grid, N) left no raster overflow (its overflow
plan is 0) and the MC capacities of its grid are planned; a frame whose own
raster overflows then runs again with the legacy densities.

The single-dispatch warm frame (``_try_warm_frame``, the reference's
``SPLASHSURF_TPU_MONO_FRAME``, read per call, default "0") runs a frame
whose density, MC and pull plans are all in place as one function with no
read of the card (``_warm_frame``): eagerly on the CPU, and on the card as
the replay of one CUDA graph per plan set (``frame_graph``). It comes back
to the host in one copy and is checked there, as the reference checks it;
a miss updates the plan concerned and hands the frame to the per-stage
path, counting nothing in ``SPECULATION_STATS``. As in the reference it is
tried first, before the cell-raster densities, and takes the cell-major
marching cubes only; its pull is the mode of ``ops.global_sweep.pull_mode``
(the reference's mono frame always encodes).
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from splashsurf_tpu_torch import frame_graph, kernels, neighbors, plans
from splashsurf_tpu_torch.mesh import TriMesh3d
from splashsurf_tpu_torch.ops import global_sweep as gs
from splashsurf_tpu_torch.params import Parameters
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.plans import SPECULATION_STATS
from splashsurf_tpu_torch.profiling import profile, redo_span
from splashsurf_tpu_torch.reconstruction import GridPlanMiss, SurfaceReconstruction
from splashsurf_tpu_torch.uniform_grid import UniformGrid, kernel_extents

def compute_densities(positions: torch.Tensor, parameters: Parameters) -> torch.Tensor:
    """Per-particle SPH densities on the positions' device
    (``neighbors.compute_particle_densities``)."""
    return neighbors.compute_particle_densities(
        positions, parameters.compact_support_radius, parameters.particle_rest_mass
    )


def use_cellraster(device: torch.device) -> bool:
    """Whether ``SPLASHSURF_TPU_DENSITY_CELLRASTER`` turns the cell-raster
    densities on for tensors on ``device``."""
    env = os.environ.get("SPLASHSURF_TPU_DENSITY_CELLRASTER", "0")
    return env != "0" and (device.type == "cuda" or env == "1cpu")


def _cellrast_frame(positions: torch.Tensor, parameters: Parameters, grid: UniformGrid,
                    hsc: int, grid_check, defer_pull: bool):
    """The dense frame with cell-raster densities (reference
    global_pipeline.py:219-316): (pull, rho), or None when a particle
    overflowed its cell's raster slots; the overflow plan has then grown,
    and the caller runs the legacy densities. A deferred pull reports an
    overflow as a redo."""
    h = parameters.compact_support_radius
    with profile("cellraster densities"):
        fracs, n_over, meta = gs.rasterize_global(
            positions, None, grid, 2, hsc, 0, with_meta=True
        )
        reach = int(math.ceil(h / grid.cell_size - 1e-9))
        fv, rho = gs.density_weights_from_rasters(
            *fracs, *meta, parameters.particle_rest_mass, h, grid, hsc, reach,
            h / grid.cell_size,
        )
    neighbors.LAST_GATE.clear()
    neighbors.LAST_GATE.update(kind="cellraster", n=positions.shape[0])
    none = positions.new_empty(0)
    with profile("dense level set"):
        ls = gs.sweep_global(fracs + (fv,), (none,) * 4, grid, h, hsc)
    del fracs, fv
    okey = (grid.n_points, positions.shape[0])
    checks = (grid_check,) if grid_check is not None else ()
    labels = ("grid",) * len(checks)
    try:
        out = gs._finish_global_dense(
            ls, grid, parameters.iso_surface_threshold, okey, 0, n_over,
            checks, defer_pull, labels,
        )
    except gs.SpeculationMiss as e:
        plans.note_failed_check(labels, e.flags)  # a grid miss: counted
        raise GridPlanMiss(str(e)) from e
    if out is None:
        # the overflow plan has grown: later frames go legacy until a frame
        # fits it to 0 again
        return None
    return out, rho


def _legacy_frame(positions: torch.Tensor, parameters: Parameters, grid: UniformGrid,
                  hsc: int, grid_check, defer_pull: bool):
    """The dense frame with the density stage (reference
    global_pipeline.py:425-490): (pull, rho). The densities run on their
    plan; a density miss clears it and runs the frame again ("redo
    density"), a grid miss raises GridPlanMiss."""
    h = parameters.compact_support_radius
    for attempt in range(2):
        with redo_span("density", attempt):
            with profile("compute particle densities"):
                rho, check = neighbors.compute_particle_densities(
                    positions, h, parameters.particle_rest_mass, speculate=True
                )
                values = kernels.rounded(parameters.particle_rest_mass, rho.dtype) / rho
            pairs = [("density", check), ("grid", grid_check)]
            labels = tuple(name for name, c in pairs if c is not None)
            checks = tuple(c for _, c in pairs if c is not None)
            try:
                out = gs.reconstruct_global_dense(
                    positions, values, grid, h, hsc, parameters.iso_surface_threshold,
                    deferred_checks=checks, defer_pull=defer_pull, check_labels=labels,
                )
                if not defer_pull:
                    verts, tris = out
                    out = gs.PendingPull(lambda: ("ok", verts, tris), [])
                return out, rho
            except gs.SpeculationMiss as e:
                if plans.note_failed_check(labels, e.flags) == "grid":
                    raise GridPlanMiss(str(e)) from e
    raise RuntimeError(
        "the density plan missed twice in a row; the second frame plans from "
        "scratch, so a plan was not invalidated"
    )


# What the last ``_try_warm_frame`` found, read by tests and chip_smoke.py,
# never by the pipeline: "outcome" is "off" (the switch, or edge-major MC),
# "no plan", "grid", "density", "overflow", "caps", "bucket" (a miss of that
# plan) or "hit".
LAST_WARM: dict = {}


class FrameKey(NamedTuple):
    """What one captured warm frame is fixed to: the reference's static
    arguments of ``_warm_frame`` (global_pipeline.py:43-50 of the
    reference; ``backend`` is the kernels or the plain versions, by the
    device), and what the port passes into its kernels and ops as Python
    numbers."""

    grid: UniformGrid
    bgrid: neighbors.BinGrid
    kind: str
    kslots: int
    u_cap: int
    ocap: int
    ccap: int
    csr: float
    hsc: int
    slots: int
    backend: str
    ofc: int
    vcap: int
    tcap: int
    nv_b: int
    nc_b: int
    has_n_valid: bool
    dtype: str
    n: int
    device: str
    mass: float
    iso: float
    pull: tuple


def mono_frame_on(dtype: torch.dtype) -> bool:
    """Whether ``SPLASHSURF_TPU_MONO_FRAME`` is "1" and the marching cubes
    of ``dtype``'s pull mode are cell-major, as the reference's mono frame
    is: whether a frame tries the single-dispatch warm frame."""
    return os.environ.get("SPLASHSURF_TPU_MONO_FRAME", "0") == "1" and not gs.pull_mode(dtype)[0]


def _warm_frame(positions: torch.Tensor, parameters: Parameters, grid: UniformGrid, hsc: int,
                dplan: dict, ofc: int, caps, pull_plan):
    """The whole warm dense frame on its plans, with no read of the card
    (the reference's ``_warm_frame``, global_pipeline.py:43-108): the
    densities on the density plan ``dplan``, the weights m / rho, the raster
    with an overflow list of ``ofc`` rows, the level set (K1), marching
    cubes at the MC capacities ``caps`` in the mode of ``gs.pull_mode``, and
    its streams cut to the buckets ``pull_plan``.

    Returns ``(buf, rho, layout, mode)``: one uint8 tensor that packs the
    scalars (vertices, triangles and active points, the overflow count, the
    level set's maximum and the density check, as float64) and the cut
    streams (``gs.pack_parts``; ``layout`` takes it apart), the densities,
    and the pull's mode."""
    h = parameters.compact_support_radius
    m = parameters.particle_rest_mass
    rho, dcheck = neighbors._densities_planned(positions, h, m, dplan)
    values = kernels.rounded(m, rho.dtype) / rho
    rasters, overflow, n_over = gs.rasterize_global(positions, values, grid, 2, hsc, ofc)
    ls = gs.sweep_global(rasters, overflow, grid, h, hsc)
    del rasters, overflow
    iso = kernels.rounded(parameters.iso_surface_threshold, ls.dtype)
    streams, totals = gs._dense_mc(ls, grid, iso, caps)
    f64 = lambda x: x.reshape(-1).to(torch.float64)
    scalars = torch.cat([f64(totals), f64(n_over), f64(ls.max()), f64(dcheck)])
    buf, layout = gs.pack_parts([scalars] + streams.parts(*pull_plan))
    return buf, rho, layout, streams.mode


def _try_warm_frame(positions: torch.Tensor, parameters: Parameters, grid: UniformGrid,
                    hsc: int, grid_check, has_n_valid: bool = False):
    """The single-dispatch warm frame, where ``SPLASHSURF_TPU_MONO_FRAME`` is
    "1" and the density, MC and pull plans are all in place (the
    reference's ``_try_warm_frame``, global_pipeline.py:111-234).

    Returns (vertices, triangles, rho) (host tensors, and rho a tensor of
    its own on the positions' device), or None where a plan is missing or
    missed: the caller runs the per-stage frame. The frame reads back once
    and is checked as the reference checks it, in its order: a stale
    speculated grid raises ``GridPlanMiss``; a density miss clears the
    density plan; then ``gs._check_plans``, as the per-stage frame's
    checks: a raster overflow past the plan grows the overflow plan, an MC
    total past its capacity replans the capacities and drops the pull
    plans, a stream past its bucket records the larger buckets.
    ``SPECULATION_STATS`` counts none of them. A miss drops the frame's
    CUDA graph; a hit records the pull plan and fits the overflow plan."""
    LAST_WARM["outcome"] = "off"
    if not mono_frame_on(positions.dtype):
        return None
    _, encoded, quant = gs.pull_mode(positions.dtype)
    LAST_WARM["outcome"] = "no plan"
    n, dtype = positions.shape[0], str(positions.dtype)
    h = float(parameters.compact_support_radius)
    warm = plans.warm_plans(grid.n_points, n, dtype, h, encoded)
    if warm is None:
        return None
    dplan, caps, pull_plan, ofc = warm
    vcap, tcap = caps
    nv_b, n2_b = pull_plan
    dev = positions.device
    fkey = FrameKey(
        grid=grid, bgrid=dplan["grid"], kind=dplan["kind"], kslots=dplan["slots"],
        u_cap=dplan["u_cap"], ocap=dplan["ocap"], ccap=dplan["ccap"], csr=h, hsc=hsc, slots=2,
        backend="cuda" if dev.type == "cuda" else "plain", ofc=ofc, vcap=vcap, tcap=tcap,
        nv_b=nv_b, nc_b=n2_b, has_n_valid=has_n_valid, dtype=dtype, n=n, device=str(dev),
        mass=float(parameters.particle_rest_mass),
        iso=float(parameters.iso_surface_threshold), pull=(encoded, quant),
    )
    slot = (grid, n, dtype, str(dev))
    neighbors.LAST_GATE["kind"] = dplan["kind"]
    frame = functools.partial(
        _warm_frame, parameters=parameters, grid=grid, hsc=hsc, dplan=dplan, ofc=ofc,
        caps=caps, pull_plan=pull_plan,
    )
    with profile("warm frame"):  # one span: a graph's replay cannot be split
        if dev.type == "cuda":
            buf, rho, layout, mode = frame_graph.run(slot, fkey, frame, positions)
            rho = rho.clone()  # the next replay overwrites the graph's own
        else:
            buf, rho, layout, mode = frame(positions)
        checks = [grid_check] if grid_check is not None else []
        host_buf, *host_checks = gs.PendingPull(None, [buf] + checks).host_parts()
    sc, *host = gs.unpack_parts(host_buf, layout)
    missed = plans.note_failed_check(  # sc[5] is the density check
        ("grid",) * len(host_checks) + ("density",),
        [bool(c) for c in host_checks] + [bool(sc[5])], count=False,
    )
    if missed is not None:
        LAST_WARM["outcome"] = missed
        if missed == "grid":
            frame_graph.drop(slot)
            raise GridPlanMiss("speculated background grid is stale")
        return None  # the density plans are cleared: every graph is dropped
    # a miss hands the frame to the per-stage path, which runs on the
    # updated plan (the overflow growth capped at N, as the reference's)
    second = 2 if encoded else 1
    outcome, (total_v, total_t, total_c, _) = gs._check_plans(
        sc, okey=(grid.n_points, n), ocap=ofc, key=(grid.n_points, dtype), caps=caps,
        encoded=encoded, second=second, iso=parameters.iso_surface_threshold,
        pulled=pull_plan, count=False, over_max=plans.pow2(n), drop_both=True,
    )
    LAST_WARM["outcome"] = "hit" if outcome == "ok" else outcome
    if outcome != "ok":
        frame_graph.drop(slot)
        return None
    _, verts, tris = gs._MeshStreams(mode, None, [], second, grid).mesh(
        host, total_v, total_t, total_c
    )
    return verts, tris, rho


def reconstruct_surface_global(
    positions,
    parameters: Parameters,
    grid: UniformGrid,
    particle_inside_aabb: Optional[np.ndarray] = None,
    grid_check=None,
    n_valid: Optional[int] = None,
    defer_pull: bool = False,
    device=None,
) -> SurfaceReconstruction:
    """Reconstruct on one dense grid on the positions' device. The mesh comes
    back to the host (with ``defer_pull``, at ``resolve()``); the
    per-particle densities stay a device tensor; the neighbour lists, when
    ``parameters.global_neighborhood_list`` asks for them, are searched
    after the mesh is dispatched and come back with the result.

    ``grid_check`` is a device bool that says whether a speculated ``grid``
    still holds (``reconstruction._grid_check_device``); it comes back with
    the mesh, and a False one raises ``reconstruction.GridPlanMiss`` (with
    ``defer_pull``, ``resolve()`` runs the frame again). Only the first
    ``n_valid`` rows of ``positions`` are particles, where that is given;
    the densities of the rest are 0. An array goes to ``device``
    (``placement.on_device``)."""
    positions = on_device(positions, device=device)
    full, n = positions, positions.shape[0]
    if n_valid is not None:
        positions = positions[: int(n_valid)]
    hsc = kernel_extents(parameters.compact_support_radius, grid.cell_size).half_supported_cells
    SPECULATION_STATS["frames"] += 1
    pad = lambda rho: torch.cat([rho, rho.new_zeros(n - rho.shape[0])]) if rho.shape[0] < n else rho
    warm = _try_warm_frame(positions, parameters, grid, hsc, grid_check, positions.shape[0] < n)
    if warm is not None:
        # synchronous, as the reference's, even where the pull could wait
        verts, tris, rho = warm
        return SurfaceReconstruction(
            grid=grid, mesh=TriMesh3d(vertices=verts.numpy(), triangles=tris.numpy()),
            particle_densities=pad(rho),
            particle_neighbors=neighbors.particle_neighbor_lists(positions, parameters),
            particle_inside_aabb=particle_inside_aabb,
        )
    defer_pull = defer_pull and not parameters.global_neighborhood_list
    out = None
    if (
        use_cellraster(positions.device)
        and plans.cellraster_ready(grid.n_points, positions.shape[0], str(positions.dtype))
    ):
        out = _cellrast_frame(positions, parameters, grid, hsc, grid_check, defer_pull)
    if out is None:
        out = _legacy_frame(positions, parameters, grid, hsc, grid_check, defer_pull)
    pull, rho = out
    rec = SurfaceReconstruction(
        grid=grid, mesh=None, particle_densities=pad(rho),
        particle_neighbors=neighbors.particle_neighbor_lists(positions, parameters),
        particle_inside_aabb=particle_inside_aabb,
    )
    redo = functools.partial(
        reconstruct_surface_global, full, parameters, grid, particle_inside_aabb,
        n_valid=n_valid,
    )
    rec._pending_mesh = DeferredMesh(rec, pull, lambda code: redo())
    return rec if defer_pull else rec.resolve()


class DeferredMesh:
    """The pending mesh of a dense frame, resolved once
    (``SurfaceReconstruction.resolve``): the ``PendingPull``'s mesh, or,
    where it reports a redo, the mesh of ``redo(code)``, a synchronous run
    of the frame, whose grid and densities then replace the frame's
    (the reference's ``_resolve_mesh``, reconstruction.py:465-490)."""

    def __init__(self, rec: SurfaceReconstruction, pull, redo):
        self.rec, self.pull, self.redo = rec, pull, redo

    def __call__(self) -> TriMesh3d:
        out = self.pull.resolve()
        if out[0] == "ok":
            return TriMesh3d(vertices=out[1].numpy(), triangles=out[2].numpy())
        with profile("redo deferred"):
            again = self.redo(out[0])
        self.rec.grid = again.grid
        self.rec.particle_densities = again.particle_densities
        return again.mesh
