"""On a card: each cell through the harness at a small size, the program
on CUDA, judged by the reference on the card. Skips without a card."""

import time

import pytest
import torch

from bm_small import spec
from harness import runner

CELLS = ["dam_break_13m.host_flow", "canyon_13m.host_flow", "dam_break_13m.device_flow"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import splashsurf_tpu_torch as pt

    config = cell.split(".")[0]
    small = {"n_particles_target": 200_000}
    cfg = {**runner.load_json(runner.HERE / "configs" / f"{config}.json"), **small}
    params = runner.program_params(pt, cfg)
    out = runner.run(spec(), cell, 2**31 + 3, 2.0, True, torch.device("cuda", 0),
                     lambda frame: pt.reconstruct_surface(frame, params), time.perf_counter(),
                     log=lambda msg: None, config_overrides=small)
    res = out["result"]
    assert res["correct"], out["check"]
    assert res["device"]["busy_s"] > 0
    assert "throughput" not in res["metrics"]  # a traced run reports the per-layer metrics
