"""The end-to-end reconstruction + post-processing pipeline (PyTorch port of
``splashsurf_tpu.pipeline``).

Mirrors the reference's ``reconstruction_pipeline``
(splashsurf/src/reconstruct.rs:448-541,1022-1586) — the single public recipe
used by the CLI. Stage order (reconstruct.rs:1022-1586):

    reconstruct -> mesh cleanup -> barnacle decimation -> [SPH interpolator]
    -> smoothing weights -> Laplacian smoothing -> normals (+ smoothing)
    -> attribute interpolation -> mesh AABB clamp -> tri->quad
    -> consistency checks

The reconstruction, the SPH interpolation, the normals and the smoothing run
on the reconstruction's device (a tensor's own, else ``device=``, by default
CUDA); the topology edits and the checks run on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from splashsurf_tpu_torch import postprocess
from splashsurf_tpu_torch.aabb import Aabb3d
from splashsurf_tpu_torch.mesh import (
    MeshAttribute,
    MeshWithData,
    TriMesh3d,
    check_mesh_consistency,
    face_normals,
    vertex_normals,
)
from splashsurf_tpu_torch.params import Parameters
from splashsurf_tpu_torch.placement import as_device_tensor
from splashsurf_tpu_torch.profiling import profile
from splashsurf_tpu_torch.reconstruction import SurfaceReconstruction, reconstruct_surface
from splashsurf_tpu_torch.sph_interpolation import SphInterpolator, smooth_step


@dataclasses.dataclass
class PostprocessingParameters:
    """Post-processing switches (reconstruct.rs:459-519 parity)."""

    check_mesh_closed: bool = False
    check_mesh_manifold: bool = False
    check_mesh_orientation: bool = False
    check_mesh_debug: bool = False
    mesh_cleanup: bool = False
    mesh_cleanup_snap_dist: Optional[float] = None
    decimate_barnacles: bool = False
    keep_vertices: bool = False
    compute_normals: bool = False
    sph_normals: bool = False
    normals_smoothing_iters: Optional[int] = None
    interpolate_attributes: Optional[List[str]] = None
    mesh_smoothing_iters: Optional[int] = None
    mesh_smoothing_weights: bool = False
    mesh_smoothing_weights_normalization: float = 13.0
    generate_quads: bool = False
    quad_max_edge_diag_ratio: float = 1.75
    quad_max_normal_angle: float = 10.0
    quad_max_interior_angle: float = 135.0
    output_mesh_smoothing_weights: bool = False
    output_raw_normals: bool = False
    output_raw_mesh: bool = False
    mesh_aabb: Optional[Aabb3d] = None
    mesh_aabb_clamp_vertices: bool = False

    @staticmethod
    def from_reference(p) -> "PostprocessingParameters":
        """Copy any object with these fields (the JAX package's
        ``PostprocessingParameters`` included) field by field; the AABB goes
        across by its corners, so nothing of the source package is
        imported."""
        kw = {f.name: getattr(p, f.name) for f in dataclasses.fields(PostprocessingParameters)}
        if kw["mesh_aabb"] is not None:
            kw["mesh_aabb"] = Aabb3d(kw["mesh_aabb"].min, kw["mesh_aabb"].max)
        if kw["interpolate_attributes"] is not None:
            kw["interpolate_attributes"] = list(kw["interpolate_attributes"])
        return PostprocessingParameters(**kw)


@dataclasses.dataclass
class ReconstructionResult:
    """Output of the pipeline (reconstruct.rs:449-457)."""

    tri_mesh: Optional[MeshWithData] = None
    tri_quad_mesh: Optional[MeshWithData] = None
    raw_reconstruction: Optional[SurfaceReconstruction] = None


def reconstruction_pipeline(
    particle_positions,
    parameters: Parameters,
    postprocessing: Optional[PostprocessingParameters] = None,
    attributes: Optional[Dict[str, np.ndarray]] = None,
    device=None,
) -> ReconstructionResult:
    """Reconstruct and post-process a surface; ``particle_positions`` is an
    (N, 3) tensor, which runs on its own device, or an array, which runs on
    ``device`` (default CUDA; RuntimeError without it). ``attributes`` are
    host arrays, one row per particle. The meshes come back as host numpy
    arrays."""
    postprocessing = postprocessing or PostprocessingParameters()
    attributes = attributes or {}
    positions = as_device_tensor(particle_positions, device, parameters.torch_dtype)
    dev = positions.device
    np_dtype = np.dtype(parameters.dtype)

    with profile("surface reconstruction"):
        reconstruction = reconstruct_surface(positions, parameters)
    mesh = reconstruction.mesh
    grid = reconstruction.grid

    # Particles actually used (after optional AABB filtering).
    if reconstruction.particle_inside_aabb is not None:
        inside = reconstruction.particle_inside_aabb
        filtered_positions = positions[torch.as_tensor(inside, device=dev)]
        attributes = {k: np.asarray(v)[inside] for k, v in attributes.items()}
    else:
        filtered_positions = positions

    raw_mesh = None
    if postprocessing.output_raw_mesh:
        raw_mesh = TriMesh3d(mesh.vertices.copy(), mesh.triangles.copy())

    if postprocessing.mesh_cleanup:
        with profile("mesh cleanup"):
            mesh, _vertex_map = postprocess.marching_cubes_cleanup(
                mesh,
                grid,
                max_rel_snap_distance=postprocessing.mesh_cleanup_snap_dist,
                keep_vertices=postprocessing.keep_vertices,
            )

    if postprocessing.decimate_barnacles:
        with profile("decimate barnacles"):
            mesh, _vertex_map = postprocess.decimation(
                mesh, keep_vertices=postprocessing.keep_vertices
            )

    # SPH interpolator needed for smoothing weights / sph normals / attributes
    need_interpolator = (
        postprocessing.mesh_smoothing_weights
        or postprocessing.sph_normals
        or bool(postprocessing.interpolate_attributes)
    )
    interpolator = None
    if need_interpolator:
        with profile("build SPH interpolator"):
            interpolator = SphInterpolator(
                filtered_positions,
                reconstruction.particle_densities,
                parameters.particle_rest_mass,
                parameters.compact_support_radius,
            )

    point_attributes: List[MeshAttribute] = []

    # Smoothing weights (weighted neighbor count -> smooth-step).
    smoothing_weights = None
    if postprocessing.mesh_smoothing_weights:
        with profile("compute smoothing weights"):
            with profile("weighted neighbor counts"):
                wnn = interpolator.weighted_neighbor_counts()
            with profile("interpolate to vertices"):
                vertex_wnn = interpolator.interpolate_scalar_quantity(
                    wnn, mesh.vertices, first_order_correction=True
                )
            norm = postprocessing.mesh_smoothing_weights_normalization
            x = np.minimum(np.maximum(vertex_wnn, 0.0) / norm, 1.0)
            smoothing_weights = smooth_step(x).astype(mesh.vertices.dtype)
            if postprocessing.output_mesh_smoothing_weights:
                point_attributes.append(MeshAttribute("wnn", vertex_wnn))
                point_attributes.append(MeshAttribute("sw", smoothing_weights))

    # Laplacian smoothing.
    if postprocessing.mesh_smoothing_iters:
        with profile("mesh smoothing"):
            weights = (
                smoothing_weights
                if smoothing_weights is not None
                else np.ones(mesh.num_vertices, dtype=mesh.vertices.dtype)
            )
            mesh.vertices = postprocess.laplacian_smoothing(
                mesh.vertices,
                mesh.triangles,
                postprocessing.mesh_smoothing_iters,
                1.0,
                weights,
                device=dev,
            )

    # Normals.
    if postprocessing.compute_normals:
        with profile("compute normals"):
            if postprocessing.sph_normals:
                with profile("SPH normals"):
                    normals = interpolator.interpolate_normals(mesh.vertices)
            else:
                with profile("area-weighted normals"):
                    normals = vertex_normals(mesh.vertices, mesh.triangles, device=dev)
            if postprocessing.normals_smoothing_iters:
                if postprocessing.output_raw_normals:
                    point_attributes.append(MeshAttribute("raw_normals", normals))
                normals = postprocess.laplacian_smoothing_normals(
                    normals,
                    mesh.triangles,
                    mesh.num_vertices,
                    postprocessing.normals_smoothing_iters,
                    device=dev,
                )
            point_attributes.append(MeshAttribute("normals", normals))

    # Attribute interpolation.
    if postprocessing.interpolate_attributes:
        with profile("interpolate attributes"):
            for name in postprocessing.interpolate_attributes:
                if name not in attributes:
                    raise KeyError(f"attribute {name!r} not found in input attributes")
                data = np.asarray(attributes[name])
                if data.ndim == 2 and data.shape[1] == 3:
                    out = interpolator.interpolate_vector_quantity(
                        data.astype(np_dtype),
                        mesh.vertices,
                        first_order_correction=True,
                    )
                else:
                    out = interpolator.interpolate_scalar_quantity(
                        data.astype(np_dtype),
                        mesh.vertices,
                        first_order_correction=True,
                    )
                point_attributes.append(MeshAttribute(name, out))

    # Mesh AABB clamp/filter (reconstruct.rs:1395-1408 → mesh.rs:333-371):
    # drop cells fully outside the AABB, then clamp survivors if requested.
    if postprocessing.mesh_aabb is not None:
        with profile("mesh AABB clamp"):
            clamped = MeshWithData(
                mesh=mesh, point_attributes=point_attributes
            ).par_clamp_with_aabb(
                postprocessing.mesh_aabb,
                clamp_vertices=postprocessing.mesh_aabb_clamp_vertices,
            )
            mesh = clamped.mesh
            point_attributes = clamped.point_attributes

    # Consistency checks.
    if (
        postprocessing.check_mesh_closed
        or postprocessing.check_mesh_manifold
        or postprocessing.check_mesh_orientation
    ):
        with profile("mesh consistency checks"):
            err = check_mesh_consistency(
                mesh.vertices,
                mesh.triangles,
                check_closedness=postprocessing.check_mesh_closed,
                check_manifoldness=postprocessing.check_mesh_manifold,
                debug=postprocessing.check_mesh_debug,
                grid=grid,
            )
            if err is None and postprocessing.check_mesh_orientation:
                err = _check_orientation(mesh, dev)
            if err is not None:
                raise RuntimeError(f"mesh consistency check failed: {err}")

    result = ReconstructionResult(raw_reconstruction=reconstruction)
    if postprocessing.output_raw_mesh and raw_mesh is not None:
        # Post-processing may have mutated the reconstruction mesh in place;
        # restore the pristine copy taken right after reconstruction.
        result.raw_reconstruction.mesh = raw_mesh

    if postprocessing.generate_quads:
        with profile("tri -> quad conversion"):
            tq = postprocess.convert_tris_to_quads(
                mesh,
                non_squareness_limit=postprocessing.quad_max_edge_diag_ratio,
                normal_angle_limit_rad=np.deg2rad(postprocessing.quad_max_normal_angle),
                max_interior_angle_rad=np.deg2rad(
                    postprocessing.quad_max_interior_angle
                ),
            )
        result.tri_quad_mesh = MeshWithData(mesh=tq, point_attributes=point_attributes)
    else:
        result.tri_mesh = MeshWithData(mesh=mesh, point_attributes=point_attributes)
    return result


def _check_orientation(mesh: TriMesh3d, device=None) -> Optional[str]:
    """Detect inverted triangles: angle between face normal and the mean of
    its vertex normals above 90 deg (reconstruct.rs:1446-1542). The normals
    are computed on ``device`` (default CUDA)."""
    vn = vertex_normals(mesh.vertices, mesh.triangles, device=device)
    fn = face_normals(mesh.vertices, mesh.triangles, device=device)
    tri_vn = vn[np.asarray(mesh.triangles)].mean(axis=1)
    dots = np.einsum("ij,ij->i", fn, tri_vn)
    inverted = int((dots < 0).sum())
    if inverted:
        return f"{inverted} potentially inverted triangles"
    return None
