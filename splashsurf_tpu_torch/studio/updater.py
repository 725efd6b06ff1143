"""Per-frame reconstruction runner with a frame cache
(splashsurf_studio/src/updater.py:6-107 analog)."""

from __future__ import annotations

from typing import Dict, Tuple

try:
    import bpy  # noqa: F401

    HAS_BPY = True
except Exception:  # pragma: no cover
    HAS_BPY = False

# (object name, frame, is_render) -> (vertices, faces)
_FRAME_CACHE: Dict[Tuple[str, int, bool], tuple] = {}
_CACHE_LIMIT = 16


def clear_cache():
    _FRAME_CACHE.clear()


def invalidate(obj_name: str, frame: int):
    """Drop cached meshes of one object at one frame (both render modes) —
    a property edit makes them stale (reference property_callback's
    cached-flag reset, handlers.py:60-66)."""
    for is_render in (False, True):
        _FRAME_CACHE.pop((obj_name, frame, is_render), None)


def update_entries(scene, depsgraph, is_render: bool = False):
    for obj in scene.objects:
        settings = getattr(obj, "spsf_settings", None)
        if settings is None or not settings.enabled:
            continue
        update_reconstruction(scene, depsgraph, obj, settings, is_render)


def update_reconstruction(scene, depsgraph, obj, settings, is_render: bool):
    from splashsurf_tpu_torch.studio import utils

    surface_name = settings.surface_object
    surface_obj = scene.objects.get(surface_name) if surface_name else None
    if surface_obj is None:
        return

    key = (obj.name, scene.frame_current, is_render)
    cached = _FRAME_CACHE.get(key)
    if cached is not None:
        utils.swap_mesh_into_object(surface_obj, cached[0], cached[1])
        return

    props = (
        settings.render
        if (is_render or settings.use_render_params_in_viewport)
        else settings.viewport
    )
    positions = utils.evaluated_particle_positions(obj, depsgraph)
    if len(positions) == 0:
        return
    vertices, faces, _attrs = utils.reconstruct_from_props(positions, props)
    utils.swap_mesh_into_object(surface_obj, vertices, faces)

    if len(_FRAME_CACHE) >= _CACHE_LIMIT:
        _FRAME_CACHE.pop(next(iter(_FRAME_CACHE)))
    _FRAME_CACHE[key] = (vertices, faces)
