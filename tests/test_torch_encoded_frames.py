"""The frame plans with the encoded pull (``SPLASHSURF_TPU_PULL=encoded``,
read per call by both packages): a three-frame script of a small seeded
dam break through the port and the JAX package, frame by frame and
through ``reconstruct_sequence``.

1. cold: every plan is made, the encoded pull plan (``_PULL_PLAN_ENC``,
   buckets of vertices and active points) among them;
2. jittered by 1e-6: every plan hits, the frame copies its streams once
   and decodes them on the host;
3. spikes on the block's top and side faces: more surface than the MC
   capacities (caps retry), which drops the encoded pull plan.

For every frame both packages move ``SPECULATION_STATS`` alike and give the
same triangle list, vertices within 1e-4 (f32) / 1e-9 (f64).
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
from splashsurf_tpu_torch import plans
from splashsurf_tpu_torch.ops import global_sweep as tgs
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)

R = 0.011
S = 2 * R
INTENT = [{}, {}, {"caps_retry": 1}]


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
def _encoded(monkeypatch):
    monkeypatch.setenv("SPLASHSURF_TPU_PREWARM", "0")
    monkeypatch.setenv("SPLASHSURF_TPU_PULL", "encoded")
    monkeypatch.delenv("SPLASHSURF_TPU_PULL_QUANT", raising=False)
    monkeypatch.delenv("SPLASHSURF_TPU_MC", raising=False)
    _clear_jax_plans()
    yield
    _clear_jax_plans()


def _script() -> list:
    """A dam-break block with an 8-particle droplet beside its top corner
    (room in the bounding box for frame 3's spikes), the block jittered,
    then every other particle of its top and +x faces moved out by 3
    spacings: isolated blobs, each with its own surface."""
    block = bench.make_dam_break(3200, R, seed=4)
    lo, hi = block.min(0), block.max(0)
    cube = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"), -1).reshape(-1, 3) * S
    drop = np.float32([hi[0] + 3.5 * S, hi[1] + 3.5 * S, (lo[2] + hi[2]) / 2]) + cube
    f1 = np.concatenate([block[:-8], drop]).astype(np.float32)
    f3 = f1.copy()
    for axis, (a, b) in ((1, (0, 2)), (0, (1, 2))):
        c = f3[:-8, axis]
        face = np.nonzero(c > c.max() - 0.5 * S)[0]
        parity = (np.round(f3[face, a] / S) + np.round(f3[face, b] / S)).astype(int) % 2
        f3[face[parity == 0], axis] += np.float32(3 * S)
    return [f1, f1 + np.float32(1e-6), f3]


def _delta(stats, before) -> dict:
    return {k: stats[k] - before[k] for k in stats if stats[k] != before[k]}


def _params(dtype):
    jp = st.Parameters.new_relative(R, 4.0, 1.5).try_convert(dtype)
    return jp, pt.Parameters.from_reference(jp)


def _same_mesh(rec, ref, dtype, label):
    v, t = rec.mesh.vertices, rec.mesh.triangles
    rv, rt = np.asarray(ref.mesh.vertices), np.asarray(ref.mesh.triangles)
    assert t.shape == rt.shape and t.shape[0] > 1000, label
    np.testing.assert_array_equal(t, rt, err_msg=label)
    np.testing.assert_allclose(v, rv, rtol=0, atol=1e-9 if dtype == "float64" else 1e-4,
                               err_msg=label)
    assert pt.check_mesh_consistency(v, t) is None, label


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
        assert tgs.LAST_PULL["mode"] == "encoded", label
        key = (rec.grid.n_points, f"torch.{dtype}")
        assert (key in plans.PULL_PLAN_ENC) and (key not in plans.PULL_PLAN), label
        _same_mesh(rec, ref, dtype, label)


def test_a_warm_frame_defers_its_encoded_pull():
    """On every plan, the frame's pull is not read until ``resolve()``;
    there the streams are decoded, once."""
    _, tp = _params("float32")
    f1, f2, _ = _script()
    pt.reconstruct_surface(torch.as_tensor(f1), tp)
    rec = pt.reconstruct_surface(torch.as_tensor(f2), tp, _defer_pull=True)
    assert rec.mesh is None and rec._pending_mesh is not None
    tgs.LAST_PULL.clear()
    rec.resolve()
    assert tgs.LAST_PULL["mode"] == "encoded" and tgs.LAST_PULL["bytes"] > 0
    cold = pt.reconstruct_surface(torch.as_tensor(f2), tp)
    np.testing.assert_array_equal(rec.mesh.triangles, cold.mesh.triangles)


def test_sequence_matches_the_reference():
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
        n += 1
    assert n == 3 and tdelta.get("caps_retry", 0) >= 1
