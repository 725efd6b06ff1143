"""UI panels (splashsurf_studio/src/panels.py analog)."""

from __future__ import annotations

try:
    import bpy

    HAS_BPY = True
except Exception:  # pragma: no cover
    HAS_BPY = False

from splashsurf_tpu_torch.studio.properties import PARAMETER_DEFS

if HAS_BPY:

    class SPSF_PT_main(bpy.types.Panel):
        bl_label = "Surface Reconstruction (splashsurf_tpu_torch)"
        bl_space_type = "PROPERTIES"
        bl_region_type = "WINDOW"
        bl_context = "object"

        def draw(self, context):
            obj = context.active_object
            s = obj.spsf_settings
            layout = self.layout
            row = layout.row()
            if s.enabled:
                row.operator("spsf.disable")
            else:
                row.operator("spsf.enable")
            layout.prop_search(s, "surface_object", context.scene, "objects")
            layout.prop(s, "use_render_params_in_viewport")
            layout.operator("spsf.update")
            layout.operator("spsf.copy_viewport_to_render")
            row = layout.row()
            row.operator("spsf.export_cli")
            row.operator("spsf.import_cli")
            for title, props in (("Viewport", s.viewport), ("Render", s.render)):
                box = layout.box()
                box.label(text=f"{title} parameters")
                for name, _t, _d, _desc in PARAMETER_DEFS:
                    box.prop(props, name)

    def register():
        bpy.utils.register_class(SPSF_PT_main)

    def unregister():
        bpy.utils.unregister_class(SPSF_PT_main)

else:

    def register():
        raise RuntimeError("bpy not available")

    def unregister():
        pass
