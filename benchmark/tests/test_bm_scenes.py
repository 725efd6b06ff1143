"""Frames repeat from the seed, with the motion amplitudes of the
configurations, and the scenes have the documented particle counts."""

import math

import pytest
import torch

from harness import runner, scenes


def cfg(name, n):
    c = runner.load_json(runner.HERE / "configs" / f"{name}.json")
    return {**c, "n_particles_target": n}


TRAFFIC = {"cycle_frames": 16}


@pytest.mark.parametrize("name", ["dam_break_13m", "canyon_13m"])
def test_frames_repeat_from_the_seed(name):
    a = scenes.frames(cfg(name, 20000), TRAFFIC, 2**31 + 7, "cpu")
    b = scenes.frames(cfg(name, 20000), TRAFFIC, 2**31 + 7, "cpu")
    c = scenes.frames(cfg(name, 20000), TRAFFIC, 2**31 + 8, "cpu")
    assert len(a) == 16
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.float32
    # another seed orders the same particles otherwise: the same work
    assert all(torch.equal(torch.unique(x, dim=0), torch.unique(z, dim=0))
               for x, z in zip(a, c))


def test_dam_break_slosh_amplitude():
    c = cfg("dam_break_13m", 20000)
    fr = scenes.frames(c, TRAFFIC, 11, "cpu")
    spacing = 2 * c["particle_radius"]
    d = fr[4] - fr[0]  # sin(2 pi 4 / 16) = 1
    assert torch.allclose(d[:, 1:], torch.zeros_like(d[:, 1:]))
    assert float(d[:, 0].max()) == pytest.approx(8 * spacing, rel=1e-5)
    assert float(d[:, 0].min()) == pytest.approx(0.0, abs=1e-6)
    d12 = fr[12] - fr[0]
    assert float(d12[:, 0].min()) == pytest.approx(-8 * spacing, rel=1e-5)


def test_canyon_wave_amplitude_and_period():
    c = cfg("canyon_13m", 30000)
    base = scenes.base_positions(c, 5, "cpu").double().float()
    spacing = 2 * c["particle_radius"]
    for k in (0, 3, 9):
        d = scenes.displacement(base, c["motion"], spacing, k, 16)
        assert torch.allclose(d[:, [0, 2]], torch.zeros_like(d[:, [0, 2]]))
        assert float(d[:, 1].abs().max()) == pytest.approx(2 * spacing, rel=1e-3)
    # the phase travels: frame 16 is frame 0, frame 4 moves the wave a quarter
    x = base[:, 0].double()
    d4 = scenes.displacement(base, c["motion"], spacing, 4, 16)[:, 1].double()
    want = 2 * spacing * torch.sin(2 * math.pi * (x / 4.0 - 0.25))
    assert torch.allclose(d4, want, atol=1e-7)
    assert torch.equal(scenes.displacement(base, c["motion"], spacing, 16, 16),
                       scenes.displacement(base, c["motion"], spacing, 0, 16))


def test_documented_counts():
    # the lattices round the documented 13,353,401 particles
    base = (13_353_401 / 48) ** (1 / 3)
    assert int(8 * base) * int(3 * base) * int(2 * base) == 13_232_700
    base = (13_353_401 / 32) ** 0.5
    assert int(4 * base) * int(base) * 8 == 13_328_280
