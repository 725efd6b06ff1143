"""The port's subdomain route, resident and streamed, against its dense
route at f64 on synthetic scenes, a dam break and a canyon from ``bench``:
equal counts, vertices within 1e-9. The port's form of the JAX package's
``tests/test_accuracy.py`` cross-path check, which reads recorded data."""

import numpy as np
import pytest
import torch

import bench
import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import subdomains as ts
from torch_gate import reset_port_geoslot_hysteresis  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv(ts.STREAM_BUDGET_ENV, raising=False)


def _forced(radius):
    return pt.Parameters.new_relative(
        radius, 4.0, 1.5,
        grid_decomposition=pt.GridDecompositionParameters(16, auto_disable=False),
    ).try_convert("float64")


R = 0.011

CROSS = {
    "dam break": lambda: (bench.make_dam_break(3000, R, seed=1), R),
    "canyon": lambda: (bench.make_canyon(3000, 0.05, seed=2), 0.05),
}


@pytest.mark.parametrize("scene", sorted(CROSS))
def test_subdomain_modes_match_the_dense_route_f64(scene, monkeypatch):
    """The subdomain route, resident and streamed, against the dense route
    at f64: equal counts, vertices within 1e-9 (sorted, since the routes
    order them differently)."""
    pts, radius = CROSS[scene]()
    pts = pts.astype(np.float64)
    dense = pt.reconstruct_surface(
        pts, pt.Parameters.new_relative(radius, 4.0, 1.5).try_convert("float64"), device="cpu"
    )
    assert dense.subdomain_grid is None and dense.mesh.num_triangles > 1000
    vd = dense.mesh.vertices[np.lexsort(dense.mesh.vertices.T)]
    for stream in ("0", "1"):
        monkeypatch.setenv(ts.STREAM_ENV, stream)
        rec = pt.reconstruct_surface(pts, _forced(radius), device="cpu")
        assert rec.subdomain_grid is not None and ts.LAST_RUN["streamed"] == (stream == "1")
        assert (rec.mesh.num_vertices, rec.mesh.num_triangles) == (
            dense.mesh.num_vertices, dense.mesh.num_triangles
        )
        vs = rec.mesh.vertices[np.lexsort(rec.mesh.vertices.T)]
        np.testing.assert_allclose(vs, vd, rtol=0, atol=1e-9)
