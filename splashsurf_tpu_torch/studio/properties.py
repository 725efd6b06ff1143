"""Property groups mirroring the reconstruction parameters
(splashsurf_studio/src/properties.py analog)."""

from __future__ import annotations

try:
    import bpy
    from bpy.props import (
        BoolProperty,
        FloatProperty,
        IntProperty,
        PointerProperty,
        StringProperty,
    )

    HAS_BPY = True
except Exception:  # pragma: no cover
    HAS_BPY = False


# Parameter names/defaults shared with the CLI (single source of truth for
# the CLI round-trip in operators.py).
PARAMETER_DEFS = [
    # (name, type, default, description)
    ("particle_radius", float, 0.025, "Particle radius"),
    ("rest_density", float, 1000.0, "Rest density of the fluid"),
    ("smoothing_length", float, 2.0, "Smoothing length relative to radius"),
    ("cube_size", float, 0.5, "MC cube size relative to radius"),
    ("surface_threshold", float, 0.6, "Iso-surface threshold"),
    ("subdomain_grid", bool, True, "Enable subdomain-grid decomposition"),
    ("subdomain_cubes", int, 64, "MC cells per subdomain axis"),
    ("mesh_cleanup", bool, False, "Marching cubes mesh cleanup"),
    ("decimate_barnacles", bool, False, "Barnacle decimation"),
    ("mesh_smoothing_iters", int, 25, "Laplacian smoothing iterations"),
    ("mesh_smoothing_weights", bool, True, "Feature-preserving smoothing weights"),
    (
        "mesh_smoothing_weights_normalization",
        float,
        13.0,
        "Smoothing weight normalization",
    ),
    ("normals", bool, True, "Compute vertex normals"),
    ("sph_normals", bool, False, "SPH-interpolated normals"),
    ("normals_smoothing_iters", int, 10, "Normal smoothing iterations"),
    ("generate_quads", bool, False, "Merge triangles into quads"),
]


def parameters_from_props(props):
    """Convert a property group (or any attribute bag) to pipeline inputs."""
    import splashsurf_tpu_torch as st
    from splashsurf_tpu_torch.pipeline import PostprocessingParameters
    from splashsurf_tpu_torch.params import GridDecompositionParameters, SpatialDecomposition

    r = props.particle_radius
    params = st.Parameters(
        particle_radius=r,
        rest_density=props.rest_density,
        compact_support_radius=2.0 * props.smoothing_length * r,
        cube_size=props.cube_size * r,
        iso_surface_threshold=props.surface_threshold,
        spatial_decomposition=(
            SpatialDecomposition.UNIFORM_GRID
            if props.subdomain_grid
            else SpatialDecomposition.NONE
        ),
        grid_decomposition=GridDecompositionParameters(props.subdomain_cubes),
    )
    post = PostprocessingParameters(
        mesh_cleanup=props.mesh_cleanup,
        decimate_barnacles=props.decimate_barnacles,
        mesh_smoothing_iters=props.mesh_smoothing_iters or None,
        mesh_smoothing_weights=props.mesh_smoothing_weights,
        mesh_smoothing_weights_normalization=props.mesh_smoothing_weights_normalization,
        compute_normals=props.normals,
        sph_normals=props.sph_normals,
        normals_smoothing_iters=props.normals_smoothing_iters or None,
        generate_quads=props.generate_quads,
    )
    return params, post


class SimpleProps:
    """Plain attribute bag with the default parameters (usable without bpy)."""

    def __init__(self, **overrides):
        for name, _typ, default, _desc in PARAMETER_DEFS:
            setattr(self, name, overrides.get(name, default))


if HAS_BPY:

    from splashsurf_tpu_torch.studio.handlers import (
        property_callback,
        update_on_change_callback,
    )

    def _bpy_prop(typ, default, desc):
        # every reconstruction property re-runs the reconstruction on edit
        # when live updates are enabled (reference properties use
        # update=property_callback throughout)
        if typ is float:
            return FloatProperty(
                default=default, description=desc, update=property_callback
            )
        if typ is int:
            return IntProperty(
                default=default, description=desc, update=property_callback
            )
        return BoolProperty(
            default=default, description=desc, update=property_callback
        )

    annotations = {
        name: _bpy_prop(typ, default, desc)
        for name, typ, default, desc in PARAMETER_DEFS
    }

    SPSF_ReconstructionProperties = type(
        "SPSF_ReconstructionProperties",
        (bpy.types.PropertyGroup,),
        {"__annotations__": dict(annotations)},
    )

    class SPSF_ObjectSettings(bpy.types.PropertyGroup):
        __annotations__ = {
            "enabled": BoolProperty(default=False),
            "surface_object": StringProperty(
                description="Name of the object receiving the surface mesh"
            ),
            "viewport": PointerProperty(type=SPSF_ReconstructionProperties),
            "render": PointerProperty(type=SPSF_ReconstructionProperties),
            "use_render_params_in_viewport": BoolProperty(default=False),
            "update_on_change": BoolProperty(
                default=False,
                description="Re-run the reconstruction whenever a "
                "parameter changes",
                update=update_on_change_callback,
            ),
        }

    _CLASSES = [SPSF_ReconstructionProperties, SPSF_ObjectSettings]

    def register():
        for c in _CLASSES:
            bpy.utils.register_class(c)
        bpy.types.Object.spsf_settings = PointerProperty(type=SPSF_ObjectSettings)

    def unregister():
        del bpy.types.Object.spsf_settings
        for c in reversed(_CLASSES):
            bpy.utils.unregister_class(c)

else:

    def register():
        raise RuntimeError("bpy not available")

    def unregister():
        pass
