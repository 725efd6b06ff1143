"""Persistent app handlers (splashsurf_studio/src/handlers.py analog):
frame-change re-reconstruction (ref lines 7-28), render-phase tracking
(toggle_rendering_on/off, ref lines 13-28), and the property-update
re-reconstruction callback (property_callback, ref lines 31-76)."""

from __future__ import annotations

try:
    import bpy
    from bpy.app.handlers import persistent

    HAS_BPY = True
except Exception:  # pragma: no cover
    HAS_BPY = False

    def persistent(f):
        return f


# Render-phase flag: render_init sets it, render_complete/cancel clear it;
# while set, reconstructions use the render property group (the scene-level
# `rendering` flag of the reference's properties.py).
_RENDERING = {"active": False}


def is_rendering() -> bool:
    return _RENDERING["active"]


@persistent
def toggle_rendering_on(scene, depsgraph=None):
    _RENDERING["active"] = True


@persistent
def toggle_rendering_off(scene, depsgraph=None):
    _RENDERING["active"] = False


@persistent
def generate_mesh(scene, depsgraph=None):
    from splashsurf_tpu_torch.studio import updater

    if depsgraph is None:
        depsgraph = bpy.context.evaluated_depsgraph_get()
    updater.update_entries(scene, depsgraph, is_render=is_rendering())


def active_props_group(settings, rendering: bool) -> str:
    """Which property group ("viewport" or "render") drives the NEXT
    reconstruction of an object — pure helper shared with the property
    callback (reference property_callback's use_render_props logic)."""
    use_render = rendering or settings.use_render_params_in_viewport
    return "render" if use_render else "viewport"


def edit_triggers_update(settings, edited_group: str, rendering: bool) -> bool:
    """Does an edit of ``edited_group`` ("viewport"/"render") require an
    immediate re-reconstruction? Only when live updates are on AND the
    edited group is the one the current mode actually uses (reference
    property_callback early-outs, handlers.py:44-48)."""
    if not getattr(settings, "update_on_change", False):
        return False
    if not settings.enabled:
        return False
    return active_props_group(settings, rendering) == edited_group


def property_callback(self, context):
    """Property-group ``update=`` callback: re-run the reconstruction of
    every enabled object whose ACTIVE property group is the edited one."""
    from splashsurf_tpu_torch.studio import updater

    scene = context.scene
    depsgraph = context.evaluated_depsgraph_get()
    rendering = is_rendering()
    for obj in scene.objects:
        settings = getattr(obj, "spsf_settings", None)
        if settings is None:
            continue
        group = active_props_group(settings, rendering)
        active = getattr(settings, group)
        if active.as_pointer() != self.as_pointer():
            continue
        if not edit_triggers_update(settings, group, rendering):
            continue
        # stale cache entry would short-circuit the rebuild
        updater.invalidate(obj.name, scene.frame_current)
        updater.update_reconstruction(
            scene, depsgraph, obj, settings, rendering
        )


def update_on_change_callback(self, context):
    """Run one reconstruction when "Update on Change" is switched ON
    (reference update_callback, handlers.py:79-82)."""
    if getattr(self, "update_on_change", False):
        rendering = is_rendering()
        group = active_props_group(self, rendering)
        property_callback(getattr(self, group), context)


_HANDLER_SLOTS = [
    ("frame_change_post", generate_mesh),
    ("render_init", toggle_rendering_on),
    ("render_complete", toggle_rendering_off),
    ("render_cancel", toggle_rendering_off),
]


def register():
    for slot, fn in _HANDLER_SLOTS:
        handlers = getattr(bpy.app.handlers, slot)
        if fn not in handlers:
            handlers.append(fn)


def unregister():
    for slot, fn in _HANDLER_SLOTS:
        handlers = getattr(bpy.app.handlers, slot)
        if fn in handlers:
            handlers.remove(fn)
