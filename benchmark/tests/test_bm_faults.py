"""The check sees a broken timed path: each run drives the whole harness
on the CPU (only its look for a card skipped), with the program broken
underneath, and ``correct`` must come out false; the sound program and
the control (the reference in bfloat16 in the program's place) on the
same runs bracket it. The cells have no exchange between chips (one card
each), so that fault has no test."""

import numpy as np
import pytest

from bm_small import program, small_run
from reference import control
from reference.surface import Params

CELLS = ["dam_break_13m.host_flow", "canyon_13m.host_flow", "dam_break_13m.device_flow"]


def stale(params):
    """A step that returns its state unchanged: every frame gets the
    answer of the first frame it saw."""
    solve, first = program(params), []

    def run(frame):
        if not first:
            first.append(solve(frame))
        return first[0]
    return run


def half(params):
    """Half of the frame left out: the program sees every other particle."""
    solve = program(params)
    return lambda frame: solve(frame[::2])


def altered(params):
    """An answer altered where it is produced: one vertex moved by half a
    cell."""
    solve = program(params)

    def run(frame):
        rec = solve(frame)
        v = np.array(rec.mesh.vertices, copy=True)
        v[len(v) // 2, 0] += 0.5 * params.cube_size
        return control.Answer(control.Mesh(v, rec.mesh.triangles), rec.particle_densities)
    return run


def bfloat16_control(params):
    p = Params(params.particle_radius, params.compact_support_radius, params.cube_size,
               params.iso_surface_threshold, params.rest_density)
    return lambda frame: control.reconstruct(frame, p, "cpu", elems=1 << 18,
                                             slab_points=1 << 16)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    out = small_run(cell, program)
    res = out["result"]
    assert res["correct"], out["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert set(res["check"]) and all(c["value"] <= c["limit"] for c in res["check"].values())


@pytest.mark.parametrize("fault", [stale, half, altered, bfloat16_control])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault):
    res = small_run(cell, fault, seconds=1.5)["result"]
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["check"].values())
