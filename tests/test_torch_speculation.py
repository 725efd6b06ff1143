"""The speculative frame plans of the port against the JAX package's.

One scripted sequence of six frames of a small seeded dam break (3,072
particles: the block and an 8-particle droplet beside its top corner,
which leaves room in the bounding box for frame 6) goes through both
packages, frame by frame and through ``reconstruct_sequence``. The JAX
side takes ``jnp`` arrays, so that its grid plan applies, with
``SPLASHSURF_TPU_PREWARM=0``; the port takes CPU tensors. Every frame
keeps N, and every frame but 3 keeps its grid. The frames:

1. cold: every plan is made (geoslot densities);
2. jittered by 1e-6: every plan hits;
3. shifted by one particle spacing, past a grid cell: a grid miss, then a
   cold redo of the grid (the geoslot lattice keeps its phase and holds);
4. frame 3 with one particle moved into another's octant: a density miss
   (the redo plans the raster densities);
5. frame 3 with three particles of one bin in one grid cell: raster
   overflow past the overflow plan of 0, rasterized again;
6. frame 3 with spikes on its top and side faces: more surface than the
   MC capacities (caps retry).

For every frame the two packages give the same ``SPECULATION_STATS``
deltas, the same mesh (float64: equal triangle lists, vertices within
1e-12, the bar of ``test_torch_reconstruct.py``; float32: equal counts,
vertices within 1e-4) and the same densities (rtol 2e-5, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import splashsurf_tpu as st
from splashsurf_tpu import global_pipeline as jgp
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import reconstruction as jr
from splashsurf_tpu.ops import global_sweep as jgs

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import global_pipeline as tgp
from splashsurf_tpu_torch import neighbors as tn
from splashsurf_tpu_torch import plans
from splashsurf_tpu_torch import reconstruction as tr
from torch_gate import clear_port_plans, reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

R = 0.011
S = 2 * R  # the particle spacing, also the geoslot octant
H = 4 * R
RHO_TOL = dict(rtol=2e-5, atol=1e-5)
# frame 4: particle I moves into J's octant; frame 5: K and L onto M, in M's bin
I, J = 1019, 259
K, L, M = 1380, 1388, 1476
# the outcome each frame is built for, besides its frame count
INTENT = [{}, {}, {"grid_miss": 1}, {"density_miss": 1}, {"overflow_retry": 1},
          {"caps_retry": 1}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear_jax_plans():
    jn.clear_density_plan()
    jr.clear_grid_plan()
    jr._PENDING_NOSPEC.clear()
    for plan in (jgs._OVER_PLAN, jgs._MC_CAPS, jgs._PULL_PLAN, jgs._PULL_PLAN_ENC):
        plan.clear()
    jn.reset_geoslot_hysteresis()


@pytest.fixture(autouse=True)
def _jax_plans(monkeypatch):
    monkeypatch.setenv("SPLASHSURF_TPU_PREWARM", "0")
    _clear_jax_plans()
    yield
    _clear_jax_plans()


def _scene() -> np.ndarray:
    block = bench.make_dam_break(3200, R, seed=4)  # 32 x 12 x 8 particles
    lo, hi = block.min(0), block.max(0)
    cube = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"), -1).reshape(-1, 3) * S
    drop = np.float32([hi[0] + 3.5 * S, hi[1] + 3.5 * S, (lo[2] + hi[2]) / 2]) + cube
    return np.concatenate([block[:-8], drop]).astype(np.float32)


def _spikes(f: np.ndarray) -> np.ndarray:
    """Every other particle of the block's top and +x faces (a checkerboard)
    moved out by 3 spacings: isolated blobs, each with its own surface."""
    f = f.copy()
    for axis, (a, b) in ((1, (0, 2)), (0, (1, 2))):
        c = f[:-8, axis]
        face = np.nonzero(c > c.max() - 0.5 * S)[0]
        parity = (np.round(f[face, a] / S) + np.round(f[face, b] / S)).astype(int) % 2
        f[face[parity == 0], axis] += np.float32(3 * S)
    return f


def _script() -> list:
    f1 = _scene()
    f3 = f1 + np.float32([S, 0, 0])
    f4 = f3.copy()
    f4[I] = f4[J] + np.float32(0.1 * S)
    f5 = f3.copy()
    f5[K] = f5[L] = f5[M]
    return [f1, f1 + np.float32(1e-6), f3, f4, f5, _spikes(f3)]


def _delta(stats, before) -> dict:
    return {k: stats[k] - before[k] for k in stats if stats[k] != before[k]}


def _params(dtype):
    jp = st.Parameters.new_relative(R, 4.0, 1.5).try_convert(dtype)
    return jp, pt.Parameters.from_reference(jp)


def _same_mesh(rec, ref, dtype, label):
    v, t = rec.mesh.vertices, rec.mesh.triangles
    rv, rt = np.asarray(ref.mesh.vertices), np.asarray(ref.mesh.triangles)
    assert v.shape == rv.shape and t.shape == rt.shape, label
    assert t.shape[0] > 1000, label
    if dtype == "float64":
        np.testing.assert_array_equal(t, rt, err_msg=label)
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-12, err_msg=label)
    else:
        assert np.abs(v - rv).max() < 1e-4, label


def _same_densities(rec, ref, label):
    np.testing.assert_allclose(
        rec.particle_densities.numpy(), np.asarray(ref.particle_densities),
        **RHO_TOL, err_msg=label,
    )


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_frame_by_frame_matches_the_reference(dtype):
    jp, tp = _params(dtype)
    for k, f in enumerate(_script()):
        label = f"frame {k + 1}"
        before = dict(jgp.SPECULATION_STATS)
        ref = st.reconstruct_surface(jnp.asarray(f.astype(dtype)), jp)
        jdelta = _delta(jgp.SPECULATION_STATS, before)
        before = dict(tgp.SPECULATION_STATS)
        rec = pt.reconstruct_surface(torch.as_tensor(f.astype(dtype)), tp)
        tdelta = _delta(tgp.SPECULATION_STATS, before)
        assert tdelta == jdelta, label
        assert {k2: v for k2, v in tdelta.items() if k2 != "frames"} == INTENT[k], label
        _same_mesh(rec, ref, dtype, label)
        _same_densities(rec, ref, label)
        assert pt.check_mesh_consistency(rec.mesh.vertices, rec.mesh.triangles) is None


def test_sequence_matches_the_reference():
    """``reconstruct_sequence`` over the script: each frame is dispatched
    before the one before it resolves, so a frame whose plans missed runs
    again when it resolves, in order. After every yielded frame the two
    packages' counts agree, and so do their meshes and densities."""
    jp, tp = _params("float32")
    frames = _script()
    jseq = st.reconstruct_sequence([jnp.asarray(f) for f in frames], jp)
    tseq = pt.reconstruct_sequence([torch.as_tensor(f) for f in frames], tp)
    jstart, tstart = dict(jgp.SPECULATION_STATS), dict(tgp.SPECULATION_STATS)
    n = 0
    for k, (ref, rec) in enumerate(zip(jseq, tseq)):
        label = f"frame {k + 1}"
        assert rec.mesh is not None and rec._pending_mesh is None, label
        tdelta = _delta(tgp.SPECULATION_STATS, tstart)
        assert tdelta == _delta(jgp.SPECULATION_STATS, jstart), label
        _same_mesh(rec, ref, "float32", label)
        _same_densities(rec, ref, label)
        n += 1
    assert n == 6
    # the misses of the script, some found when a deferred frame resolved
    assert tdelta["frames"] > 6 and all(tdelta.get(k, 0) >= 1 for k in (
        "grid_miss", "density_miss", "overflow_retry", "caps_retry"))
    print("sequence counts", tdelta)


def test_cleared_plans_make_the_next_frame_cold(monkeypatch):
    """After ``clear_grid_plan`` and ``clear_density_plan`` a frame plans
    again in both packages: no grid check is made, and the densities come
    with no check."""
    jp, tp = _params("float32")
    f = _scene()
    calls = {"jax": 0, "port": 0}

    def spy(fn, name):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jr, "_grid_check_device", spy(jr._grid_check_device, "jax"))
    monkeypatch.setattr(tr, "_grid_check_device", spy(tr._grid_check_device, "port"))
    for _ in range(2):
        st.reconstruct_surface(jnp.asarray(f), jp)
        pt.reconstruct_surface(torch.as_tensor(f), tp)
    assert calls == {"jax": 1, "port": 1}  # the second frame ran on the grid plan
    jr.clear_grid_plan()
    tr.clear_grid_plan()
    jn.clear_density_plan()
    tn.clear_density_plan()
    assert not plans.GRID_PLAN and not plans.DENSITY_PLAN
    st.reconstruct_surface(jnp.asarray(f), jp)
    pt.reconstruct_surface(torch.as_tensor(f), tp)
    assert calls == {"jax": 1, "port": 1}  # cold: no check
    jn.clear_density_plan()
    tn.clear_density_plan()
    _, jcheck = jn.compute_particle_densities(f, H, tp.particle_rest_mass, speculate=True)
    _, tcheck = tn.compute_particle_densities(
        torch.as_tensor(f), H, tp.particle_rest_mass, speculate=True
    )
    assert jcheck is None and tcheck is None


def test_density_checks_match_the_reference():
    """``compute_particle_densities(speculate=True)``: the planning call has
    no check; then a jittered frame (hit), the octant collision of frame 4
    and a frame moved out of the lattice give the same checks in both
    packages, and the hit the same densities."""
    f = _scene()
    m = 0.37
    calls = [
        ("jittered", f + np.float32(1e-6), True),
        ("octant collision", _script()[3] - np.float32([S, 0, 0]), False),
        ("out of the lattice", f + np.float32(10 * H), False),
    ]
    jrho, jcheck = jn.compute_particle_densities(f, H, m, speculate=True)
    trho, tcheck = tn.compute_particle_densities(torch.as_tensor(f), H, m, speculate=True)
    assert jcheck is None and tcheck is None
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **RHO_TOL)
    for label, g, want in calls:
        jrho, jcheck = jn.compute_particle_densities(g, H, m, speculate=True)
        trho, tcheck = tn.compute_particle_densities(torch.as_tensor(g), H, m, speculate=True)
        assert bool(tcheck) == bool(jcheck) == want, label
        if want:
            np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **RHO_TOL)
    # n_valid: the rows past it are not particles
    jrho, jcheck = jn.compute_particle_densities(f, H, m, speculate=True, n_valid=3000)
    trho, tcheck = tn.compute_particle_densities(
        torch.as_tensor(f), H, m, speculate=True, n_valid=3000
    )
    assert jcheck is None and tcheck is None
    np.testing.assert_allclose(trho.numpy()[:3000], np.asarray(jrho)[:3000], **RHO_TOL)
    assert not trho[3000:].any()
