"""The port's studio add-on (``splashsurf_tpu_torch.studio``), its bpy-free
parts against the JAX package's ``splashsurf_tpu.studio``: the parameters
built from a property group, the CLI string both ways, a reconstruction
from properties on the CPU, the handlers' pure helpers and the frame cache,
and ``register()`` failing without Blender as the reference's does."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import splashsurf_tpu.studio as jstudio
from splashsurf_tpu.studio import operators as jops
from splashsurf_tpu.studio import properties as jprops
from splashsurf_tpu.studio import utils as jutils

import splashsurf_tpu_torch as pt
import splashsurf_tpu_torch.studio as tstudio
from splashsurf_tpu_torch.pipeline import PostprocessingParameters
from splashsurf_tpu_torch.studio import handlers, operators, panels, properties, updater, utils

PROPS = [
    {},
    {"particle_radius": 0.05, "smoothing_length": 2.0, "cube_size": 1.0},
    {"particle_radius": 0.07, "generate_quads": True, "sph_normals": True,
     "subdomain_grid": False, "mesh_smoothing_iters": 0, "normals_smoothing_iters": 0},
    {"mesh_cleanup": True, "decimate_barnacles": True, "mesh_smoothing_weights": False,
     "subdomain_cubes": 32, "surface_threshold": 0.75, "rest_density": 998.0},
]


@pytest.mark.parametrize("overrides", PROPS)
def test_parameters_from_props_match_the_reference(overrides):
    params, post = properties.parameters_from_props(properties.SimpleProps(**overrides))
    ref_params, ref_post = jprops.parameters_from_props(jprops.SimpleProps(**overrides))
    assert isinstance(params, pt.Parameters)
    assert params == pt.Parameters.from_reference(ref_params)
    assert post == PostprocessingParameters.from_reference(ref_post)


def test_parameter_defs_are_the_references():
    assert properties.PARAMETER_DEFS == jprops.PARAMETER_DEFS


@pytest.mark.parametrize("overrides", PROPS)
def test_cli_string_matches_the_reference(overrides):
    cli = operators.props_to_cli_string(properties.SimpleProps(**overrides))
    assert cli == jops.props_to_cli_string(jprops.SimpleProps(**overrides))
    got, want = properties.SimpleProps(), jprops.SimpleProps()
    operators.cli_string_to_props(cli, got)
    jops.cli_string_to_props(cli, want)
    assert vars(got) == vars(want)
    assert vars(got) == vars(properties.SimpleProps(**overrides))


def test_copy_props():
    src = properties.SimpleProps(particle_radius=0.3, generate_quads=True)
    dst = properties.SimpleProps()
    operators.copy_props(src, dst)
    assert vars(dst) == vars(src)


def test_reconstruct_from_props_matches_the_reference():
    pts = np.random.default_rng(3).uniform(0, 0.3, (500, 3)).astype(np.float32)
    kw = dict(particle_radius=0.02, cube_size=1.0, mesh_smoothing_iters=5, normals=True)
    verts, faces, attrs = utils.reconstruct_from_props(
        pts, properties.SimpleProps(**kw), device="cpu"
    )
    rverts, rfaces, rattrs = jutils.reconstruct_from_props(pts, jprops.SimpleProps(**kw))
    assert verts.dtype == np.float32 and len(verts) == len(rverts) > 100
    assert len(faces) == len(rfaces) and all(len(f) == 3 for f in faces)
    d, _ = cKDTree(rverts).query(verts)
    assert d.max() < 1e-4
    assert [a.name for a in attrs] == [a.name for a in rattrs]
    assert any(a.name == "normals" for a in attrs)


def test_reconstruct_from_props_defaults_to_the_card(monkeypatch):
    """Without ``device`` the positions go to CUDA: where there is none,
    RuntimeError, never a quiet run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        utils.reconstruct_from_props(pts, properties.SimpleProps())


def test_studio_requires_bpy():
    assert tstudio.HAS_BPY is jstudio.HAS_BPY is False
    for mod in (tstudio, jstudio):
        with pytest.raises(RuntimeError, match="bpy"):
            mod.register()
    for mod in (properties, operators, panels):
        with pytest.raises(RuntimeError, match="bpy"):
            mod.register()
    tstudio.unregister()  # a no-op without Blender, as the reference's
    assert tstudio.bl_info["category"] == jstudio.bl_info["category"]
    assert tstudio.bl_info["blender"] == jstudio.bl_info["blender"]


def test_render_phase_toggle():
    assert handlers.is_rendering() is False
    handlers.toggle_rendering_on(None)
    assert handlers.is_rendering() is True
    handlers.toggle_rendering_off(None)
    assert handlers.is_rendering() is False


def test_active_props_group():
    s = SimpleNamespace(use_render_params_in_viewport=False)
    assert handlers.active_props_group(s, rendering=False) == "viewport"
    assert handlers.active_props_group(s, rendering=True) == "render"
    s.use_render_params_in_viewport = True
    assert handlers.active_props_group(s, rendering=False) == "render"


def test_edit_triggers_update():
    s = SimpleNamespace(use_render_params_in_viewport=False, update_on_change=True, enabled=True)
    assert handlers.edit_triggers_update(s, "viewport", rendering=False)
    assert not handlers.edit_triggers_update(s, "render", rendering=False)
    assert handlers.edit_triggers_update(s, "render", rendering=True)
    s.update_on_change = False
    assert not handlers.edit_triggers_update(s, "viewport", rendering=False)
    s.update_on_change = True
    s.enabled = False
    assert not handlers.edit_triggers_update(s, "viewport", rendering=False)


def test_cache_invalidate():
    updater.clear_cache()
    updater._FRAME_CACHE[("obj", 3, False)] = ("v", "f")
    updater._FRAME_CACHE[("obj", 3, True)] = ("v", "f")
    updater._FRAME_CACHE[("obj", 4, False)] = ("v", "f")
    updater.invalidate("obj", 3)
    assert ("obj", 3, False) not in updater._FRAME_CACHE
    assert ("obj", 3, True) not in updater._FRAME_CACHE
    assert ("obj", 4, False) in updater._FRAME_CACHE
    updater.clear_cache()
