"""Scripted frames of the single-dispatch warm frame
(``SPLASHSURF_TPU_MONO_FRAME=1``) through the JAX package and the port, and
what the tests compare of them.

``dam_script`` is a nine-frame script on the seeded dam break of
``test_torch_speculation`` (3,072 particles, no count padding). Every frame
keeps N; each is built for one outcome of ``_try_warm_frame``, the same in
both packages:

1. cold: no plan yet, the per-stage frame makes them (a miss);
2. the same frame again: every plan holds (a hit);
3. jittered by 1e-6: a hit;
4. one particle moved into another's octant: the geoslot density check
   fails, the density plan is cleared and the per-stage frame plans the
   raster densities;
5. three particles of one bin in one grid cell: raster overflow past the
   overflow plan of 0, which grows;
6. spikes on the block's top and side faces: more surface than the MC
   capacities, which are planned again, and the pull plans dropped;
7. frame 1 again: a hit on the new capacities, with smaller buckets;
8. the spikes again: within the capacities but past frame 7's buckets (a
   transfer-bucket miss, which records larger buckets);
9. frame 1 shifted by two grid cells: the speculated grid is stale
   (``GridPlanMiss``), and the frame on the cold grid hits.

No miss of the mono frame is counted in ``SPECULATION_STATS``: every frame
moves ``frames`` by one, and frame 9 by two (it runs twice).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import splashsurf_tpu as st
from splashsurf_tpu import global_pipeline as jgp
from splashsurf_tpu import neighbors as jn
from splashsurf_tpu import reconstruction as jr
from splashsurf_tpu.ops import global_sweep as jgs

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import global_pipeline as tgp
from splashsurf_tpu_torch import plans as tplans
from test_torch_speculation import I, J, K, L, M, R, S, _scene, _spikes

RHO_TOL = dict(rtol=2e-5, atol=1e-5)
PLANS = ("_OVER_PLAN", "_MC_CAPS", "_PULL_PLAN", "_PULL_PLAN_ENC")
# the switches of a scripted frame, in both packages (None: unset, the
# reference's default: the encoded pull, u16 t, cell-major MC)
SWITCHES = {
    "SPLASHSURF_TPU_MONO_FRAME": "1", "SPLASHSURF_TPU_PREWARM": "0",
    "SPLASHSURF_TPU_PULL": None, "SPLASHSURF_TPU_PULL_QUANT": None, "SPLASHSURF_TPU_MC": None,
    "SPLASHSURF_TPU_DENSITY_CELLRASTER": None,
}


def dam_script() -> list:
    """(label, positions, the mono frame's outcomes) per frame: True a hit,
    False a miss, "GridPlanMiss" a stale grid; and the port's
    ``LAST_WARM["outcome"]`` after each try."""
    f1 = _scene()
    f4 = f1.copy()
    f4[I] = f4[J] + np.float32(0.1 * S)
    f5 = f1.copy()
    f5[K] = f5[L] = f5[M]
    spikes = _spikes(f1)
    return [
        ("cold", f1, [False], ["no plan"]),
        ("warm", f1, [True], ["hit"]),
        ("jittered", f1 + np.float32(1e-6), [True], ["hit"]),
        ("density miss", f4, [False], ["density"]),
        ("overflow miss", f5, [False], ["overflow"]),
        ("caps miss", spikes, [False], ["caps"]),
        ("warm on the new capacities", f1, [True], ["hit"]),
        ("transfer-bucket miss", spikes, [False], ["bucket"]),
        ("grid miss", f1 + np.float32([2 * 1.5 * R, 0, 0]), ["GridPlanMiss", True],
         ["grid", "hit"]),
    ]


def jittered_cube(seed: int = 7, r: float = 0.025, side: int = 14) -> np.ndarray:
    """A cube of side^3 particles at spacing 2r, each moved by up to 0.1 r:
    2,744 by default, which the JAX package pads to 3,072 (``n_valid``)."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return (g * 2 * r + rng.uniform(-0.1, 0.1, g.shape) * r).astype(np.float32)


def set_switches(mp, **extra) -> None:
    for k, v in {**SWITCHES, **extra}.items():
        if v is None:
            mp.delenv(k, raising=False)
        else:
            mp.setenv(k, v)


def clear_jax_plans() -> None:
    jn.clear_density_plan()
    jr.clear_grid_plan()
    jr._PENDING_NOSPEC.clear()
    for name in PLANS:
        getattr(jgs, name).clear()
    jn.reset_geoslot_hysteresis()


def spy(mp, module, log: list, reasons: list = None) -> None:
    """Record each outcome of ``module._try_warm_frame`` in ``log``, and the
    port's ``LAST_WARM["outcome"]`` in ``reasons``."""
    fn = module._try_warm_frame

    def wrapped(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except Exception as e:
            log.append(type(e).__name__)
            raise
        finally:
            if reasons is not None:
                reasons.append(module.LAST_WARM["outcome"])
        log.append(out is not None)
        return out

    mp.setattr(module, "_try_warm_frame", wrapped)


def plans(owner) -> dict:
    """The dense route's plans of the JAX package (``jgs``) or the port
    (``tplans``, whose names drop the leading underscore), under the JAX
    names, each key without its N (the JAX package pads N) and with the
    dtype's bare name."""
    norm = lambda k: tuple(str(x).removeprefix("torch.") if isinstance(x, (str, torch.dtype))
                           else x for x in k if not isinstance(x, int))
    table = lambda name: getattr(owner, name if owner is jgs else name.lstrip("_"))
    return {name: {norm(k): v for k, v in table(name).items()} for name in PLANS}


def _delta(stats, before) -> dict:
    return {k: stats[k] - before[k] for k in stats if stats[k] != before[k]}


def run_frames(package: str, frames, dtype: str, mp, params) -> list:
    """Each frame of ``frames`` through one package (JAX arrays or CPU
    tensors, so that the grid plan applies): its mono-frame outcomes,
    ``SPECULATION_STATS`` delta, plans after it, mesh and densities."""
    jax_side = package == "jax"
    mod, owner = (jgp, jgs) if jax_side else (tgp, tplans)
    log: list = []
    reasons = None if jax_side else []
    spy(mp, mod, log, reasons)
    out = []
    for f in frames:
        log.clear()
        if reasons is not None:
            reasons.clear()
        before = dict(mod.SPECULATION_STATS)
        if jax_side:
            rec = st.reconstruct_surface(jnp.asarray(f.astype(dtype)), params)
        else:
            rec = pt.reconstruct_surface(torch.as_tensor(f.astype(dtype)), params)
        rho = rec.particle_densities
        out.append(dict(
            hits=list(log), reasons=reasons and list(reasons),
            delta=_delta(mod.SPECULATION_STATS, before), plans=plans(owner),
            vertices=np.asarray(rec.mesh.vertices), triangles=np.asarray(rec.mesh.triangles),
            rho=np.asarray(rho) if jax_side else rho.numpy(),
        ))
    return out


def reference_run(frames, dtype: str, params) -> list:
    """``run_frames`` through the JAX package with its plans cleared around
    it (for a module-scoped fixture)."""
    with pytest.MonkeyPatch.context() as mp:
        set_switches(mp)
        clear_jax_plans()
        try:
            return run_frames("jax", frames, dtype, mp, params)
        finally:
            clear_jax_plans()


def params(dtype: str, r: float = R):
    jp = st.Parameters.new_relative(r, 4.0, 1.5).try_convert(dtype)
    return jp, pt.Parameters.from_reference(jp)


def same_frame(got: dict, ref: dict, dtype: str, label: str, pull_plans: bool = True) -> None:
    """The same outcomes, counts, plans (the pull plans only where both
    pulls are encoded), densities (rtol 2e-5, atol 1e-5) and mesh: equal
    triangle lists, vertices within 1e-12 (f64) or 1e-4 (f32)."""
    assert got["hits"] == ref["hits"], label
    assert got["delta"] == ref["delta"], label
    names = PLANS if pull_plans else ("_OVER_PLAN", "_MC_CAPS")
    assert {n: got["plans"][n] for n in names} == {n: ref["plans"][n] for n in names}, label
    n = got["rho"].shape[0]
    np.testing.assert_allclose(got["rho"], ref["rho"][:n], **RHO_TOL, err_msg=label)
    assert got["triangles"].shape[0] > 1000, label
    np.testing.assert_array_equal(got["triangles"], ref["triangles"], err_msg=label)
    np.testing.assert_allclose(got["vertices"], ref["vertices"], rtol=0,
                               atol=1e-12 if dtype == "float64" else 1e-4, err_msg=label)
    assert pt.check_mesh_consistency(got["vertices"], got["triangles"]) is None, label
