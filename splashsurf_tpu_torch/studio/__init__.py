"""splashsurf_tpu_torch studio — Blender add-on for on-the-fly surface
reconstruction on the GPU (PyTorch port of ``splashsurf_tpu.studio``).

Analog of the reference's ``splashsurf_studio`` add-on
(splashsurf_studio/src/): registers scene/object property groups, operators,
UI panels and a persistent ``frame_change_post`` handler that re-runs
``reconstruction_pipeline`` on the evaluated particle object every frame,
with separate viewport/render parameter sets and a per-frame mesh cache.

Importable without Blender (all bpy use is gated); ``register()`` requires a
Blender Python environment.
"""

bl_info = {
    "name": "splashsurf_tpu_torch studio",
    "author": "splashsurf_tpu_torch",
    "description": "GPU-accelerated fluid surface reconstruction per animation frame",
    "version": (0, 1, 0),
    "blender": (4, 0, 0),
    "category": "Object",
}

try:
    import bpy  # noqa: F401

    HAS_BPY = True
except Exception:  # pragma: no cover - no Blender in CI
    HAS_BPY = False


def register():
    if not HAS_BPY:
        raise RuntimeError("splashsurf_tpu_torch.studio requires Blender's bpy module")
    from splashsurf_tpu_torch.studio import handlers, operators, panels, properties

    properties.register()
    operators.register()
    panels.register()
    handlers.register()


def unregister():
    if not HAS_BPY:
        return
    from splashsurf_tpu_torch.studio import handlers, operators, panels, properties

    handlers.unregister()
    panels.unregister()
    operators.unregister()
    properties.unregister()
