"""Mesh extraction + reconstruction glue (splashsurf_studio/src/utils.py analog)."""

from __future__ import annotations

import numpy as np

try:
    import bpy  # noqa: F401

    HAS_BPY = True
except Exception:  # pragma: no cover
    HAS_BPY = False


def evaluated_particle_positions(obj, depsgraph) -> np.ndarray:
    """Vertices of the evaluated (modifier-applied) object as float32 (N, 3)."""
    eval_obj = obj.evaluated_get(depsgraph)
    mesh = eval_obj.to_mesh()
    n = len(mesh.vertices)
    out = np.empty(n * 3, dtype=np.float32)
    mesh.vertices.foreach_get("co", out)
    eval_obj.to_mesh_clear()
    return out.reshape(n, 3)


def collect_float_attributes(obj, depsgraph):
    """FLOAT / FLOAT_VECTOR point attributes of the evaluated mesh."""
    eval_obj = obj.evaluated_get(depsgraph)
    mesh = eval_obj.to_mesh()
    attrs = {}
    for attr in mesh.attributes:
        if attr.domain != "POINT":
            continue
        n = len(attr.data)
        if attr.data_type == "FLOAT":
            buf = np.empty(n, dtype=np.float32)
            attr.data.foreach_get("value", buf)
            attrs[attr.name] = buf
        elif attr.data_type == "FLOAT_VECTOR":
            buf = np.empty(n * 3, dtype=np.float32)
            attr.data.foreach_get("vector", buf)
            attrs[attr.name] = buf.reshape(n, 3)
    eval_obj.to_mesh_clear()
    return attrs


def reconstruct_from_props(positions: np.ndarray, props, attributes=None, device=None):
    """Run the reconstruction pipeline with parameters from a property group,
    on ``device`` (default CUDA, RuntimeError without it; "cpu" runs the
    plain versions on the host).

    Returns (vertices (V,3) f32, faces list-of-index-tuples) ready for
    ``bpy`` mesh creation. Usable without Blender for testing.
    """
    from splashsurf_tpu_torch.pipeline import reconstruction_pipeline
    from splashsurf_tpu_torch.studio.properties import parameters_from_props

    params, post = parameters_from_props(props)
    result = reconstruction_pipeline(positions, params, post, attributes or {}, device=device)
    mwd = result.tri_quad_mesh or result.tri_mesh
    mesh = mwd.mesh
    faces = [tuple(t) for t in np.asarray(mesh.triangles)]
    quads = getattr(mesh, "quads", None)
    if quads is not None and len(quads):
        faces.extend(tuple(q) for q in np.asarray(quads))
    return np.asarray(mesh.vertices, dtype=np.float32), faces, mwd.point_attributes


def swap_mesh_into_object(surface_obj, vertices, faces, point_attributes=None):
    """Replace a Blender object's mesh data with the reconstructed surface."""
    import bpy

    new_mesh = bpy.data.meshes.new(surface_obj.name + "_surface")
    new_mesh.from_pydata(vertices.tolist(), [], faces)
    new_mesh.update()
    old = surface_obj.data
    surface_obj.data = new_mesh
    if old and old.users == 0:
        bpy.data.meshes.remove(old)
