"""The port's benchmark entry point, ``splashsurf_tpu_torch.bench``, against
the JAX package's ``bench.py``: the same scenes bit for bit, the same JSON
line in every mode, a summary of the mesh (``mesh_summary``) whose totals
are those of ``tests/test_dataset_matrix.py``, no import of ``jax``, and the
port's summaries within ``BARS`` of the JAX package's on small scenes.

``tests/goldens/torch_fullwidth.json`` holds the JAX package's summaries of
the meshes that the port's benchmark summarises at full width (the 2M dam
break in f32 and f64, frame 0 of ``--frames``, the 8M canyon), for
``chip_smoke.py`` to hold the card's meshes to. It is written on the CPU by
this file:

    JAX_PLATFORMS=cpu python tests/test_torch_bench.py             # every scene
    JAX_PLATFORMS=cpu python tests/test_torch_bench.py dam_break_2m_f32
    JAX_PLATFORMS=cpu python tests/test_torch_bench.py --port-cpu  # the port's CPU
        # path on the stored scenes, each summary against the file's

Here pytest holds only that each stored scene's positions are the ones the
port's generators make now (their sha256), so a changed generator fails
loudly; no full-width run goes into pytest.
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

# run as a script, the repo's root and this directory must be importable
TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
for path in (TESTS, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import bench as jbench  # noqa: E402
import splashsurf_tpu as st  # noqa: E402
import splashsurf_tpu_torch as pt  # noqa: E402
from splashsurf_tpu_torch import bench as tbench  # noqa: E402
from torch_gate import reset_port_geoslot_hysteresis  # noqa: E402,F401 (autouse)

GOLDEN_FILE = os.path.join(TESTS, "goldens", "torch_fullwidth.json")

# The full-width scenes: the port benchmark's arguments whose summary the
# entry holds, and the bar it is held to (tbench.BARS).
SCENES = {
    "dam_break_2m_f32": (["--repeats", "3"], "float32"),
    "dam_break_2m_f64": (["--repeats", "1", "--dtype", "float64"], "float64"),
    "frames_2m_frame0": (["--frames", "6"], "float32"),
    "canyon_8m_f32": (["--sparse", "--repeats", "3"], "float32_canyon"),
    "dam_break_13m_f32": (["--n", "13353401", "--repeats", "3"], "float32"),
    "dam_break_13m_f64": (["--n", "13353401", "--repeats", "1", "--dtype", "float64"],
                          "float64"),
}


def scene_of(argv):
    """(generator, its arguments, jitter k, dtype) of the positions that the
    port's ``bench.main(argv)`` summarises: the last timed frame, or frame 0
    of ``--frames``."""
    args = tbench.parse_args(argv)
    if args.sparse:
        n = 8_000_000 if args.n == 2_000_000 else args.n
        gen = ("make_canyon", dict(n_target=n, radius=tbench.RADIUS, seed=0, layers=args.layers))
    else:
        gen = ("make_dam_break", dict(n_target=args.n, radius=tbench.RADIUS, seed=0))
    k = tbench.SEQUENCE_JITTER0 if args.frames else args.repeats
    return gen, k, args.dtype


def positions_of(gen, k, module=tbench):
    name, kwargs = gen
    return tbench.jittered(getattr(module, name)(**kwargs), tbench.RADIUS, k)


def sha256(pts: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pts, np.float32).tobytes()).hexdigest()


def jax_params(dtype):
    return st.Parameters.new_relative(tbench.RADIUS, 4.0, 1.5, dtype=dtype)


@contextlib.contextmanager
def jax_route():
    """Within it, the route the JAX package's ``reconstruct_surface``
    enters, appended to the yielded list: "dense", "slab" or "subdomain"."""
    from splashsurf_tpu import global_pipeline, subdomains
    from splashsurf_tpu.ops import slab_sweep

    taken = []
    spies = [(global_pipeline, "reconstruct_surface_global", "dense"),
             (slab_sweep, "reconstruct_surface_slabbed", "slab"),
             (subdomains, "reconstruct_surface_subdomain_grid", "subdomain")]
    saved = [getattr(m, name) for m, name, _ in spies]

    def spy(fn, route):
        def entered(*args, **kwargs):
            taken.append(route)
            return fn(*args, **kwargs)
        return entered

    for (m, name, route), fn in zip(spies, saved):
        setattr(m, name, spy(fn, route))
    try:
        yield taken
    finally:
        for (m, name, _), fn in zip(spies, saved):
            setattr(m, name, fn)


def jax_summary(pts: np.ndarray, dtype: str):
    """(mesh summary, route) of the JAX package's mesh of ``pts``."""
    with jax_route() as taken:
        rec = st.reconstruct_surface(pts.astype(dtype), jax_params(dtype))
    return tbench.mesh_summary(rec.mesh), taken[0]


def port_cpu_summary(pts: np.ndarray, dtype: str):
    """(mesh summary, route) of the port's CPU mesh of ``pts``."""
    params = pt.Parameters.new_relative(tbench.RADIUS, 4.0, 1.5, dtype=dtype)
    x = torch.as_tensor(pts).to(params.torch_dtype)
    route = tbench.frame_route(x, params)[0]
    return tbench.mesh_summary(pt.reconstruct_surface(x, params).mesh), route


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    thread pool per worker would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_goldens() -> dict:
    with open(GOLDEN_FILE) as f:
        return json.load(f)


# --- the scenes ---------------------------------------------------------------


@pytest.mark.parametrize("n, seed", [(3_000, 0), (20_000, 5), (77_777, 11)])
def test_dam_break_bit_equal_to_bench_py(n, seed):
    a = tbench.make_dam_break(n, 0.011, seed)
    b = jbench.make_dam_break(n, 0.011, seed)
    assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n, seed, layers", [(5_000, 0, 8), (30_000, 2, 2), (64_000, 7, 5)])
def test_canyon_bit_equal_to_bench_py(n, seed, layers):
    a = tbench.make_canyon(n, 0.011, seed, layers)
    b = jbench.make_canyon(n, 0.011, seed, layers)
    assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


# --- mesh_summary ---------------------------------------------------------------


def test_summary_totals_equal_the_dataset_matrix_summary():
    from test_dataset_matrix import mesh_summary

    pts = tbench.make_dam_break(3_000, 0.011)
    mesh = pt.reconstruct_surface(pts, pt.Parameters.new_relative(0.011, 4.0, 1.5),
                                  device="cpu").mesh
    got, want = tbench.mesh_summary(mesh), mesh_summary(mesh)
    assert {k: got[k] for k in want} == want
    # the blocks' deposits sum to the totals
    assert sum(got["block_vertices"]) == pytest.approx(got["num_vertices"], rel=1e-12)
    assert sum(got["block_area"]) == pytest.approx(got["area"], rel=1e-12)
    assert len(got["block_area"]) == got["blocks"] ** 3 == 64


def test_summary_blocks_locate_a_fault_that_the_totals_hide():
    """A cube with one corner dented in, and its mirror image: the counts,
    area, volume and box agree, the blocks do not, and the bars see it."""
    v, t = _unit_cube()
    v[7] = (0.8, 0.8, 0.8)  # the corner (1, 1, 1), dented
    mirrored = v.copy()
    mirrored[:, 0] = 1.0 - mirrored[:, 0]
    a = tbench.mesh_summary(pt.TriMesh3d(v, t))
    b = tbench.mesh_summary(pt.TriMesh3d(mirrored, t[:, ::-1].copy()))
    for key in ("num_vertices", "num_triangles", "bbox_min", "bbox_max"):
        assert a[key] == b[key], key
    assert a["area"] == pytest.approx(b["area"], rel=1e-14)
    assert a["volume"] == pytest.approx(b["volume"], rel=1e-14)
    assert tbench.summary_gaps(a, a, tbench.BARS["float64"]) == []
    gaps = tbench.summary_gaps(b, a, tbench.BARS["float32"])
    assert gaps and all(g.startswith("block_") for g in gaps), gaps


def _unit_cube():
    """A closed unit cube, 8 vertices and 12 triangles, outward."""
    v = np.array([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    t = np.array([q for a, b, c, d in quads for q in ((a, b, c), (a, c, d))], np.int32)
    return v, t


def test_summary_blocks_are_continuous_in_the_vertices():
    """A vertex on a block face moved by d moves the block sums by about d:
    no whole weight flips between blocks."""
    v, t = _unit_cube()
    v = np.vstack([v, [[0.5, 0.5, 0.0]]])  # a vertex on the x = 0.5 block face
    t = np.vstack([t, [[8, 0, 4]]]).astype(np.int32)
    a = tbench.mesh_summary(pt.TriMesh3d(v, t))
    v2 = v.copy()
    v2[8, 0] += 1e-9
    b = tbench.mesh_summary(pt.TriMesh3d(v2, t))
    assert np.abs(np.subtract(a["block_vertices"], b["block_vertices"])).max() < 1e-7


def test_bars_are_the_stated_ones():
    assert tbench.BARS == {
        "float64": {"counts": 0.0, "total": 1e-9, "bbox": 1e-9, "block": 1e-8},
        "float32": {"counts": 0.0, "total": 1e-5, "bbox": 1e-4, "block": 1e-4},
        "float32_canyon": {"counts": 1e-4, "total": 1e-5, "bbox": 1e-4, "block": 1e-4},
    }


# --- the entry point ------------------------------------------------------------


def _run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tbench.main(argv)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0]), out


def test_frame_mode_prints_bench_py_line():
    line, out = _run_main(["--device", "cpu", "--n", "20000", "--repeats", "1"])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "end_to_end_reconstruction_throughput"
    mpps = out["n"] / min(out["times"]) / 1e6  # the best of the repeats, as bench.py
    assert line["unit"] == "Mparticles/s" and line["value"] == round(mpps, 3)
    assert line["vs_baseline"] == round(mpps / jbench.BASELINE_MPPS, 3)
    assert out["route"] == "dense" and out["line"] == line
    assert out["summary"]["num_triangles"] > 0


@pytest.mark.parametrize("stage, unit", [("density", "Mparticles/s"), ("aabb", "Mparticles/s"),
                                         ("normals", "Mtris/s"), ("mc", "Mcells/s")])
def test_stage_prints_bench_py_line(stage, unit):
    line, out = _run_main(["--device", "cpu", "--n", "20000", "--repeats", "1", "--stage", stage])
    assert line == {"metric": f"stage_{stage}", "value": line["value"], "unit": unit,
                    "vs_baseline": 0.0}
    assert line["value"] >= 0 and min(out["times"]) > 0


def test_sequence_and_sparse_metric_names(monkeypatch):
    """--frames and --sparse (on a small canyon) keep bench.py's metric names."""
    line, out = _run_main(["--device", "cpu", "--n", "6000", "--repeats", "1", "--frames", "2"])
    assert line["metric"] == "sequence_frames_per_second" and line["unit"] == "frames/s"
    line, out = _run_main(["--device", "cpu", "--n", "6000", "--repeats", "1", "--sparse"])
    assert line["metric"] == "sparse_subdomain_reconstruction_throughput"
    assert out["route"] in ("dense", "slab", "subdomain")


def test_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--n", "1000", "--repeats", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--n", "1000", "--stage", "aabb"])


def test_imports_no_jax():
    """With ``jax`` unimportable, the module imports and ``--help`` runs."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['splashsurf_tpu'] = None; "
            "sys.modules['bench'] = None; import runpy; sys.argv = ['bench', '--help']; "
            "runpy.run_module('splashsurf_tpu_torch.bench', run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--device" in r.stdout and "--sparse" in r.stdout


# --- the full-width references ---------------------------------------------------


def test_goldens_hold_the_full_width_scenes():
    goldens = load_goldens()
    for name in ("dam_break_2m_f32", "dam_break_2m_f64", "frames_2m_frame0", "canyon_8m_f32"):
        assert name in goldens, name
    for name, g in goldens.items():
        assert SCENES[name][0] == g["argv"] and SCENES[name][1] == g["bar"], name
        assert g["bar"] in tbench.BARS


@pytest.mark.parametrize("name", list(SCENES))
def test_golden_positions_are_the_generators(name):
    """Each stored scene's sha256 is that of the positions the port's
    generators make now for its arguments: a changed generator goes stale
    loudly."""
    goldens = load_goldens()
    if name not in goldens:
        pytest.skip(f"{name} is not in the golden file (ROADMAP lists it as waiting)")
    g = goldens[name]
    gen, k, dtype = scene_of(g["argv"])
    assert [gen[0], gen[1], k, dtype] == [g["generator"], g["args"], g["jitter"], g["dtype"]]
    pts = positions_of(gen, k)
    assert len(pts) == g["n"] and sha256(pts) == g["sha256"]


@pytest.mark.parametrize("gen, dtype, bar", [
    (("make_dam_break", dict(n_target=50_000, radius=0.011, seed=0)), "float32", "float32"),
    (("make_dam_break", dict(n_target=50_000, radius=0.011, seed=0)), "float64", "float64"),
    # a canyon sheet of 20K particles: the plain level set's cost on the CPU
    # grows with the grid, and the 100K sheet's grid (4.3M cells) takes ~65 s
    (("make_canyon", dict(n_target=20_000, radius=0.011, seed=0, layers=8)), "float32",
     "float32_canyon"),
])
def test_port_summary_within_the_bars_of_the_jax_package(gen, dtype, bar):
    pts = positions_of(gen, 3)
    want, jroute = jax_summary(pts, dtype)
    got, route = port_cpu_summary(pts, dtype)
    assert route == jroute
    assert tbench.summary_gaps(got, want, tbench.BARS[bar]) == []


# --- the golden file's writer ----------------------------------------------------


def write_goldens(names):
    """Reconstruct each named scene with the JAX package (on the CPU, one
    device: the route a one-card run takes) and merge its entry into the
    golden file."""
    goldens = load_goldens() if os.path.exists(GOLDEN_FILE) else {}
    for name in names:
        argv, bar = SCENES[name]
        gen, k, dtype = scene_of(argv)
        pts = positions_of(gen, k, module=jbench)  # the JAX package's own generators
        print(f"{name}: {len(pts)} particles, {dtype} ...", flush=True)
        t0 = time.perf_counter()
        summary, route = jax_summary(pts, dtype)
        print(f"  {route} route, {summary['num_vertices']} vertices, "
              f"{summary['num_triangles']} triangles ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        goldens[name] = {
            "argv": argv, "bar": bar, "generator": gen[0], "args": gen[1], "jitter": k,
            "n": len(pts), "sha256": sha256(pts), "dtype": dtype,
            "parameters": {"particle_radius": tbench.RADIUS, "relative_support": 4.0,
                           "relative_cube": 1.5, "iso_surface_threshold": 0.6},
            "route": route, "summary": summary,
        }
        os.makedirs(os.path.dirname(GOLDEN_FILE), exist_ok=True)
        with open(GOLDEN_FILE, "w") as f:
            json.dump(goldens, f, indent=1, sort_keys=True)
    print(f"wrote {GOLDEN_FILE}")


def compare_port_cpu(names):
    """The port's CPU path on each stored scene, its summary against the
    file's: prints the route, the seconds and each total's difference."""
    goldens = load_goldens()
    for name in names:
        if name not in goldens:
            continue
        g = goldens[name]
        gen, k, dtype = scene_of(g["argv"])
        pts = positions_of(gen, k)
        t0 = time.perf_counter()
        got, route = port_cpu_summary(pts, dtype)
        want = g["summary"]
        diffs = {key: got[key] - want[key] for key in
                 ("num_vertices", "num_triangles", "area", "volume")}
        box = max(float(np.abs(np.subtract(got[key], want[key])).max())
                  for key in ("bbox_min", "bbox_max"))
        blocks = {key: float((np.abs(np.subtract(got[key], want[key]))
                              / np.maximum(np.abs(want[key]), np.abs(want[key]).mean())).max())
                  for key in ("block_area", "block_vertices")}
        gaps = tbench.summary_gaps(got, want, tbench.BARS[g["bar"]])
        print(json.dumps({"scene": name, "route": route, "jax_route": g["route"],
                          "seconds": time.perf_counter() - t0, "differences": diffs,
                          "bbox_max_abs": box, "block_max_rel": blocks,
                          "within_bars": not gaps, "gaps": gaps}), flush=True)


if __name__ == "__main__":
    wanted = [a for a in sys.argv[1:] if not a.startswith("--")] or list(SCENES)
    if "--port-cpu" in sys.argv:
        compare_port_cpu(wanted)
    else:
        write_goldens(wanted)
