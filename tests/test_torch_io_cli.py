"""The port's file IO and CLI against the JAX package's: every format written
by one package reads back equal in the other, both ways; both parsers read
the same argv to the same values; ``run_splashsurf`` on the CPU writes the
same mesh as the JAX CLI; ``convert``; a two-frame ``{}`` sequence; the
progress bar and the profile tree; without CUDA the CLI logs the error and
exits 1."""

import io as _io
import logging
import os

import numpy as np
import pytest
import torch

import bench
from splashsurf_tpu import io as jio
from splashsurf_tpu.cli import make_parser as j_make_parser
from splashsurf_tpu.cli import run_splashsurf as j_run
from splashsurf_tpu.mesh import MixedTriQuadMesh3d as JMixed
from splashsurf_tpu.mesh import TriMesh3d as JTriMesh3d

import splashsurf_tpu_torch as pt
from splashsurf_tpu_torch import io as tio
from splashsurf_tpu_torch import profiling, progress
from splashsurf_tpu_torch.cli import make_parser as t_make_parser
from splashsurf_tpu_torch.cli import run_splashsurf as t_run
from torch_meshes import icosphere

PACKAGES = {"torch": (tio, pt.TriMesh3d, pt.MixedTriQuadMesh3d), "jax": (jio, JTriMesh3d, JMixed)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def particles():
    g = np.random.default_rng(11)
    pos = g.uniform(-1, 1, (300, 3)).astype(np.float32)
    return pos, {"velocity": g.standard_normal((300, 3)).astype(np.float32),
                 "density": g.uniform(900, 1100, 300).astype(np.float32)}


@pytest.mark.parametrize("ext", ["vtk", "bgeo", "xyz", "json"])
@pytest.mark.parametrize("writer, reader", [("torch", "jax"), ("jax", "torch")])
def test_particles_round_trip(tmp_path, particles, ext, writer, reader):
    pos, attrs = particles
    path = str(tmp_path / f"p.{ext}")
    with_attrs = ext in ("vtk", "bgeo")
    PACKAGES[writer][0].write_particles(path, pos, attrs if with_attrs else None)
    got, got_attrs = PACKAGES[reader][0].particles_with_attributes_from_file(path)
    np.testing.assert_array_equal(got, pos)
    if with_attrs:
        assert sorted(got_attrs) == sorted(attrs)
        for k, v in attrs.items():
            np.testing.assert_array_equal(np.asarray(got_attrs[k]).reshape(v.shape), v)


@pytest.mark.parametrize("ext", ["vtk", "vtu", "obj", "ply"])
@pytest.mark.parametrize("writer, reader", [("torch", "jax"), ("jax", "torch")])
def test_meshes_round_trip(tmp_path, ext, writer, reader):
    mesh = icosphere(2, np.float32)
    io_w, tri_w, _ = PACKAGES[writer]
    path = str(tmp_path / f"m.{ext}")
    normals = mesh.vertices / np.linalg.norm(mesh.vertices, axis=1, keepdims=True)
    io_w.write_mesh(path, tri_w(mesh.vertices, mesh.triangles), {"normals": normals})
    got = PACKAGES[reader][0].mesh_from_file(path)
    np.testing.assert_array_equal(np.asarray(got.vertices), mesh.vertices)
    np.testing.assert_array_equal(np.asarray(got.triangles), mesh.triangles)


def test_tri_quad_meshes_write_alike(tmp_path):
    mesh = icosphere(1, np.float32)
    quads = np.array([[0, 1, 2, 3]], np.int32)
    for name, (io_mod, _, mixed) in PACKAGES.items():
        io_mod.write_mesh(str(tmp_path / f"{name}.vtk"), mixed(mesh.vertices, mesh.triangles, quads))
    a, b = ((tmp_path / f"{n}.vtk").read_bytes() for n in ("torch", "jax"))
    assert a.replace(b"splashsurf_tpu_torch", b"splashsurf_tpu") == b


ARGV = [
    ["reconstruct", "in.vtk", "-r", "0.011", "-l", "2.0", "-c", "1.5", "-t", "0.6",
     "--mesh-cleanup=on", "--decimate-barnacles=on", "--mesh-smoothing-iters=25",
     "--mesh-smoothing-weights=on", "--normals=on", "--sph-normals=on",
     "--normals-smoothing-iters=10", "-a", "velocity", "--check-mesh=on", "-o", "out.vtk"],
    ["-q", "reconstruct", "f_{}.bgeo", "-r", "0.02", "-l", "2", "-c", "0.75", "-d", "on",
     "--subdomain-grid=off", "--mesh-aabb-min", "0", "0", "0", "--mesh-aabb-max", "1", "1", "1",
     "--generate-quads=on", "-s", "3", "-e", "9", "--mt-files=on", "-n", "2", "-v"],
    ["convert", "--particles", "a.vtk", "-o", "b.xyz", "--overwrite",
     "--domain-min", "0", "0", "0", "--domain-max", "1", "1", "1"],
]


@pytest.mark.parametrize("argv", ARGV)
def test_parsers_agree(argv):
    assert vars(t_make_parser().parse_args(argv)) == vars(j_make_parser().parse_args(argv))


@pytest.fixture(scope="module")
def fluid(tmp_path_factory):
    d = tmp_path_factory.mktemp("fluid")
    pts = bench.make_dam_break(3000, 0.011, seed=1)
    vel = np.random.default_rng(0).standard_normal(pts.shape).astype(np.float32)
    tio.write_particles(str(d / "fluid.vtk"), pts, {"velocity": vel})
    return d


CLI = ["-r", "0.011", "-l", "2.0", "-c", "1.5", "-t", "0.6", "--mesh-smoothing-iters=25",
       "--mesh-smoothing-weights=on", "--normals=on", "--sph-normals=on",
       "--normals-smoothing-iters=10", "-a", "velocity", "--check-mesh=on"]


def test_cli_writes_the_reference_mesh(fluid):
    src = str(fluid / "fluid.vtk")
    args = ["-q", "reconstruct", src, "-d", "on", *CLI]
    assert j_run(args + ["-o", str(fluid / "jax.vtk")]) == 0
    assert t_run(args + ["-o", str(fluid / "torch.vtk")], device="cpu") == 0
    a = jio.mesh_from_file(str(fluid / "jax.vtk"))
    b = tio.mesh_from_file(str(fluid / "torch.vtk"))
    assert b.num_triangles > 1000
    np.testing.assert_array_equal(b.triangles, a.triangles)
    np.testing.assert_allclose(b.vertices, a.vertices, rtol=0, atol=1e-9)
    assert pt.check_mesh_consistency(b.vertices, b.triangles) is None
    _, want, *_ = tio.vtk._read_legacy(str(fluid / "jax.vtk"))
    _, got, *_ = tio.vtk._read_legacy(str(fluid / "torch.vtk"))
    assert sorted(got) == sorted(want) == ["normals", "velocity"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-9, err_msg=name)


def test_cli_runs_on_the_card_by_default(fluid, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = t_run(["reconstruct", str(fluid / "fluid.vtk"), *CLI, "-o", str(fluid / "x.vtk")])
    assert rc == 1 and not (fluid / "x.vtk").exists()
    assert "CUDA" in capsys.readouterr().err
    # logging is configured once, however often the CLI runs in a process
    logger = logging.getLogger("splashsurf_tpu_torch")
    assert len([h for h in logger.handlers if isinstance(h, progress.ProgressAwareStreamHandler)]) == 1


def test_convert(fluid, tmp_path):
    src = str(fluid / "fluid.vtk")
    out = str(tmp_path / "part.bgeo")
    argv = ["-q", "convert", "--particles", src, "-o", out,
            "--domain-min", "0", "0", "0", "--domain-max", "0.3", "0.3", "0.3"]
    assert t_run(argv) == 0
    assert t_run(argv) == 1  # exists, no --overwrite
    assert t_run(argv + ["--overwrite"]) == 0
    pos, attrs = jio.particles_with_attributes_from_file(src)
    keep = np.all((pos >= 0) & (pos <= 0.3), axis=1)
    got, got_attrs = jio.particles_with_attributes_from_file(out)
    np.testing.assert_array_equal(got, pos[keep])
    np.testing.assert_array_equal(got_attrs["velocity"], attrs["velocity"][keep])
    mesh = icosphere(1, np.float32)
    tio.write_mesh(str(tmp_path / "m.obj"), mesh)
    assert t_run(["-q", "convert", "--mesh", str(tmp_path / "m.obj"), "-o", str(tmp_path / "m.ply")]) == 0
    back = jio.mesh_from_file(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(back.triangles, mesh.triangles)


def test_two_frame_sequence(fluid, tmp_path):
    pts, attrs = tio.particles_with_attributes_from_file(str(fluid / "fluid.vtk"))
    for k in (1, 2):
        tio.write_particles(str(tmp_path / f"frame_{k}.vtk"), pts + 0.01 * k, attrs)
    single = str(tmp_path / "single.vtk")
    args = ["-q", "reconstruct", *CLI]
    profiling.reset()
    assert t_run(args[:2] + [str(tmp_path / "frame_{}.vtk")] + args[2:], device="cpu") == 0
    assert "surface reconstruction" in profiling.write_to_string()
    assert t_run(args[:2] + [str(tmp_path / "frame_2.vtk"), "-o", single] + args[2:], device="cpu") == 0
    outs = sorted(os.listdir(tmp_path))
    assert "frame_surface_1.vtk" in outs and "frame_surface_2.vtk" in outs
    a = tio.mesh_from_file(str(tmp_path / "frame_surface_2.vtk"))
    b = tio.mesh_from_file(single)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    np.testing.assert_array_equal(a.vertices, b.vertices)


class _Tty(_io.StringIO):
    def isatty(self):
        return True


def test_progress_bar():
    out = _Tty()
    pb = progress.ProgressBar(4, stream=out, width=8)
    pb.inc()
    pb.inc(2)
    line = out.getvalue().split("\r")[-1]
    assert "3/4" in line and "(75%)" in line and "remaining" in line
    pb.finish()
    assert out.getvalue().endswith("\n") and "4/4" in out.getvalue().split("\r")[-1]
    quiet = _io.StringIO()
    pb = progress.ProgressBar(2, stream=quiet)
    pb.inc()
    pb.finish()
    assert quiet.getvalue() == ""  # headless: nothing rendered
    bar_out, log_out = _Tty(), _io.StringIO()
    progress.set_progress_bar(progress.ProgressBar(2, stream=bar_out))
    try:
        h = progress.ProgressAwareStreamHandler(log_out)
        h.emit(logging.LogRecord("t", logging.INFO, __file__, 1, "hello %d", (7,), None))
        assert "hello 7" in log_out.getvalue()
        assert bar_out.getvalue().endswith("[--:--:--]\x1b[K")  # redrawn after the record
    finally:
        progress.set_progress_bar(None)


def test_profile_tree_and_device_trace(tmp_path):
    profiling.reset()
    with profiling.profile("outer"):
        with profiling.profile("inner", block_on=[torch.ones(2)]):
            pass
    tree = profiling.write_to_string().splitlines()
    assert tree[0].startswith("outer: 100.00%") and tree[1].startswith("  inner:")
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    profiling.reset()
