"""Operators: enable/disable reconstruction, copy parameter sets, CLI-string
import/export (splashsurf_studio/src/operators.py:9-239 analog)."""

from __future__ import annotations

try:
    import bpy

    HAS_BPY = True
except Exception:  # pragma: no cover
    HAS_BPY = False

from splashsurf_tpu_torch.studio.properties import PARAMETER_DEFS


def props_to_cli_string(props) -> str:
    """Serialize a parameter set as a splashsurf-style CLI argument string."""
    parts = [
        f"-r {props.particle_radius}",
        f"-l {props.smoothing_length}",
        f"-c {props.cube_size}",
        f"-t {props.surface_threshold}",
        f"--rest-density {props.rest_density}",
        f"--subdomain-grid={'on' if props.subdomain_grid else 'off'}",
        f"--subdomain-cubes {props.subdomain_cubes}",
        f"--mesh-cleanup={'on' if props.mesh_cleanup else 'off'}",
        f"--decimate-barnacles={'on' if props.decimate_barnacles else 'off'}",
        f"--mesh-smoothing-weights={'on' if props.mesh_smoothing_weights else 'off'}",
        f"--mesh-smoothing-weights-normalization {props.mesh_smoothing_weights_normalization}",
        f"--normals={'on' if props.normals else 'off'}",
        f"--sph-normals={'on' if props.sph_normals else 'off'}",
        f"--generate-quads={'on' if props.generate_quads else 'off'}",
    ]
    if props.mesh_smoothing_iters:
        parts.append(f"--mesh-smoothing-iters {props.mesh_smoothing_iters}")
    if props.normals_smoothing_iters:
        parts.append(f"--normals-smoothing-iters {props.normals_smoothing_iters}")
    return " ".join(parts)


def cli_string_to_props(cli: str, props) -> None:
    """Apply a splashsurf-style CLI argument string onto a parameter set."""
    from splashsurf_tpu_torch.cli import make_parser

    argv = ["reconstruct", "dummy.vtk"] + cli.split()
    args = make_parser().parse_args(argv)
    props.particle_radius = args.particle_radius
    props.smoothing_length = args.smoothing_length
    props.cube_size = args.cube_size
    props.surface_threshold = args.surface_threshold
    props.rest_density = args.rest_density
    props.subdomain_grid = args.subdomain_grid
    props.subdomain_cubes = args.subdomain_cubes
    props.mesh_cleanup = args.mesh_cleanup
    props.decimate_barnacles = args.decimate_barnacles
    props.mesh_smoothing_iters = args.mesh_smoothing_iters or 0
    props.mesh_smoothing_weights = args.mesh_smoothing_weights
    props.mesh_smoothing_weights_normalization = (
        args.mesh_smoothing_weights_normalization
    )
    props.normals = args.normals
    props.sph_normals = args.sph_normals
    props.normals_smoothing_iters = args.normals_smoothing_iters or 0
    props.generate_quads = args.generate_quads


def copy_props(src, dst) -> None:
    for name, _t, _d, _desc in PARAMETER_DEFS:
        setattr(dst, name, getattr(src, name))


if HAS_BPY:

    class SPSF_OT_enable(bpy.types.Operator):
        bl_idname = "spsf.enable"
        bl_label = "Enable surface reconstruction"

        def execute(self, context):
            obj = context.active_object
            obj.spsf_settings.enabled = True
            if not obj.spsf_settings.surface_object:
                surf = bpy.data.objects.new(
                    obj.name + "_surface", bpy.data.meshes.new(obj.name + "_surface")
                )
                context.collection.objects.link(surf)
                obj.spsf_settings.surface_object = surf.name
            return {"FINISHED"}

    class SPSF_OT_disable(bpy.types.Operator):
        bl_idname = "spsf.disable"
        bl_label = "Disable surface reconstruction"

        def execute(self, context):
            context.active_object.spsf_settings.enabled = False
            return {"FINISHED"}

    class SPSF_OT_update(bpy.types.Operator):
        bl_idname = "spsf.update"
        bl_label = "Reconstruct now"

        def execute(self, context):
            from splashsurf_tpu_torch.studio import updater

            depsgraph = context.evaluated_depsgraph_get()
            updater.clear_cache()
            updater.update_entries(context.scene, depsgraph)
            return {"FINISHED"}

    class SPSF_OT_copy_viewport_to_render(bpy.types.Operator):
        bl_idname = "spsf.copy_viewport_to_render"
        bl_label = "Copy viewport parameters to render parameters"

        def execute(self, context):
            s = context.active_object.spsf_settings
            copy_props(s.viewport, s.render)
            return {"FINISHED"}

    class SPSF_OT_export_cli(bpy.types.Operator):
        bl_idname = "spsf.export_cli"
        bl_label = "Copy parameters as CLI string"

        def execute(self, context):
            s = context.active_object.spsf_settings
            context.window_manager.clipboard = props_to_cli_string(s.viewport)
            return {"FINISHED"}

    class SPSF_OT_import_cli(bpy.types.Operator):
        bl_idname = "spsf.import_cli"
        bl_label = "Paste parameters from CLI string"

        def execute(self, context):
            s = context.active_object.spsf_settings
            try:
                cli_string_to_props(context.window_manager.clipboard, s.viewport)
            except SystemExit:
                self.report({"ERROR"}, "invalid CLI parameter string")
                return {"CANCELLED"}
            return {"FINISHED"}

    _CLASSES = [
        SPSF_OT_enable,
        SPSF_OT_disable,
        SPSF_OT_update,
        SPSF_OT_copy_viewport_to_render,
        SPSF_OT_export_cli,
        SPSF_OT_import_cli,
    ]

    def register():
        for c in _CLASSES:
            bpy.utils.register_class(c)

    def unregister():
        for c in reversed(_CLASSES):
            bpy.utils.unregister_class(c)

else:

    def register():
        raise RuntimeError("bpy not available")

    def unregister():
        pass
