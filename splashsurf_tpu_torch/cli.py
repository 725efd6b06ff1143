"""Command line interface: ``reconstruct`` and ``convert`` subcommands
(PyTorch port of ``splashsurf_tpu.cli``).

Mirrors the reference CLI's flag surface (splashsurf/src/cli.rs:22-81,
reconstruct.rs:39-380, convert.rs:15-141), including the relative parameter
convention (support radius = 2 * smoothing-length * particle-radius, cube
size = cube-size-factor * particle-radius; reconstruct.rs:628-629) and
on/off switches spelled ``--flag=on|off``.

``reconstruct`` runs on the card: without CUDA it logs the error and exits
1 (``run_splashsurf(argv, device="cpu")`` runs it on the CPU, as the tests
do). ``convert`` runs on the host only.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

logger = logging.getLogger("splashsurf_tpu_torch")


def _switch(default: str):
    def parse(v: str) -> bool:
        lv = v.lower()
        if lv in ("on", "true", "1", "yes"):
            return True
        if lv in ("off", "false", "0", "no"):
            return False
        raise argparse.ArgumentTypeError(f"expected on/off, got {v!r}")

    return dict(type=parse, default=parse(default), metavar="on|off")


def _build_reconstruct_parser(sub):
    p = sub.add_parser(
        "reconstruct", help="Reconstruct a surface mesh from SPH particle data"
    )
    # IO
    p.add_argument("input_file_or_sequence", help="input file or {} sequence pattern")
    p.add_argument("-o", "--output-file", default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("-s", "--start-index", type=int, default=None)
    p.add_argument("-e", "--end-index", type=int, default=None)
    # basic params
    p.add_argument("-r", "--particle-radius", type=float, required=True)
    p.add_argument("--rest-density", type=float, default=1000.0)
    p.add_argument(
        "-l",
        "--smoothing-length",
        type=float,
        required=True,
        help="smoothing length relative to radius; support = 2*l*r",
    )
    p.add_argument(
        "-c", "--cube-size", type=float, required=True,
        help="MC cube edge length relative to the particle radius",
    )
    p.add_argument("-t", "--surface-threshold", type=float, default=0.6)
    p.add_argument("-d", "--double-precision", **_switch("off"))
    p.add_argument("--particle-aabb-min", type=float, nargs=3, default=None)
    p.add_argument("--particle-aabb-max", type=float, nargs=3, default=None)
    # advanced. --mt-particles/--simd are accepted for reference CLI parity
    # but have no effect on the card (its kernels are data-parallel by
    # construction); default None detects explicit use so the runner can
    # warn.
    p.add_argument("--mt-files", **_switch("off"))
    p.add_argument(
        "--mt-particles", **{**_switch("on"), "default": None}
    )
    p.add_argument("-n", "--num-threads", type=int, default=None)
    p.add_argument("--simd", **{**_switch("on"), "default": None})
    # decomposition
    p.add_argument("--subdomain-grid", **_switch("on"))
    p.add_argument("--subdomain-grid-auto-disable", **_switch("on"))
    p.add_argument("--subdomain-cubes", type=int, default=64)
    # interpolation & normals
    p.add_argument("--normals", **_switch("off"))
    p.add_argument("--sph-normals", **_switch("off"))
    p.add_argument("--normals-smoothing-iters", type=int, default=None)
    p.add_argument("--output-raw-normals", **_switch("off"))
    p.add_argument(
        "-a",
        "--interpolate_attribute",
        action="append",
        default=None,
        metavar="ATTRIBUTE_NAME",
    )
    # postprocessing
    p.add_argument("--mesh-cleanup", **_switch("off"))
    p.add_argument("--mesh-cleanup-snap-dist", type=float, default=None)
    p.add_argument("--decimate-barnacles", **_switch("off"))
    p.add_argument("--keep-verts", **_switch("off"))
    p.add_argument("--mesh-smoothing-iters", type=int, default=None)
    p.add_argument("--mesh-smoothing-weights", **_switch("off"))
    p.add_argument(
        "--mesh-smoothing-weights-normalization", type=float, default=13.0
    )
    p.add_argument("--output-smoothing-weights", **_switch("off"))
    p.add_argument("--generate-quads", **_switch("off"))
    p.add_argument("--quad-max-edge-diag-ratio", type=float, default=1.75)
    p.add_argument("--quad-max-normal-angle", type=float, default=10.0)
    p.add_argument("--quad-max-interior-angle", type=float, default=135.0)
    p.add_argument("--mesh-aabb-min", type=float, nargs=3, default=None)
    p.add_argument("--mesh-aabb-max", type=float, nargs=3, default=None)
    p.add_argument("--mesh-aabb-clamp-verts", **_switch("off"))
    p.add_argument("--output-raw-mesh", **_switch("off"))
    p.add_argument("--check-mesh", **_switch("off"))
    p.add_argument("--check-mesh-closed", **_switch("off"))
    p.add_argument("--check-mesh-manifold", **_switch("off"))
    p.add_argument("--check-mesh-orientation", **_switch("off"))
    p.add_argument("--check-mesh-debug", **_switch("off"))
    return p


def _build_convert_parser(sub):
    p = sub.add_parser(
        "convert", help="Convert particle or mesh files between formats"
    )
    p.add_argument("--particles", default=None, help="input particle file")
    p.add_argument("--mesh", default=None, help="input mesh file")
    p.add_argument("-o", "--output-file", required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--domain-min", type=float, nargs=3, default=None)
    p.add_argument("--domain-max", type=float, nargs=3, default=None)
    return p


def make_parser() -> argparse.ArgumentParser:
    # -q/-v accepted both before and after the subcommand (like the
    # reference's global clap flags).
    verbosity = argparse.ArgumentParser(add_help=False)
    verbosity.add_argument("-q", "--quiet", action="store_true")
    verbosity.add_argument("-v", "--verbose", action="count", default=0)
    parser = argparse.ArgumentParser(
        prog="splashsurf_tpu_torch",
        description="GPU surface reconstruction for SPH particle data (PyTorch + CUDA)",
        parents=[verbosity],
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for p in (_build_reconstruct_parser(sub), _build_convert_parser(sub)):
        for act in verbosity._actions:
            p._add_action(act)
    return parser


VERBOSE_TRACE = 5  # below DEBUG: -vv, like the reference's Trace level


def initialize_logging(quiet: bool, verbose: int):
    """Verbosity mapping like the reference (logging.rs:76-138):
    default Info, -v Debug, -vv Trace, -q Warn.

    The package logger gets one handler, added at the first call; later
    calls (the CLI run again in one process) only set the level and point
    the handler at the current stderr."""
    from splashsurf_tpu_torch.progress import ProgressAwareStreamHandler

    level = logging.INFO
    if quiet:
        level = logging.WARNING
    elif verbose == 1:
        level = logging.DEBUG
    elif verbose >= 2:
        logging.addLevelName(VERBOSE_TRACE, "TRACE")
        level = VERBOSE_TRACE
    handler = next(
        (h for h in logger.handlers if isinstance(h, ProgressAwareStreamHandler)), None
    )
    if handler is None:
        # log records suspend the sequence progress bar so the two never
        # interleave on the terminal (logging.rs:44-56 semantics)
        handler = ProgressAwareStreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s.%(msecs)03d][%(levelname)s] %(message)s", datefmt="%H:%M:%S"
        ))
        logger.addHandler(handler)
        logger.propagate = False
    handler.stream = sys.stderr  # not setStream: it flushes the old stream
    logger.setLevel(level)


def run_splashsurf(argv: Optional[List[str]] = None, device=None) -> int:
    """Run the CLI on ``argv``; ``device`` goes to the pipeline (None: the
    card). Returns the exit code."""
    args = make_parser().parse_args(argv)
    initialize_logging(args.quiet, args.verbose)
    for flag in ("mt_particles", "simd"):
        if getattr(args, flag, None) is not None:
            logger.warning(
                "--%s has no effect on the GPU: its kernels are data-parallel "
                "by construction",
                flag.replace("_", "-"),
            )
    t0 = time.perf_counter()
    try:
        if args.command == "reconstruct":
            rc = reconstruct_subcommand(args, device)
        else:
            rc = convert_subcommand(args)
    except Exception as e:
        logger.error("%s", e)
        return 1
    from splashsurf_tpu_torch import profiling

    logger.info("Timings:\n%s", profiling.write_to_string())
    # Peak-memory report (reference: counting allocator, allocator.rs:5-82 +
    # cli.rs:133-139 — here the card's memory is the scarce resource).
    if args.command == "reconstruct" and torch.cuda.is_initialized():
        free, total = torch.cuda.mem_get_info()
        logger.info(
            "Device memory: peak %.1f MB allocated, %.1f MB in use "
            "(%.1f MB free of %.1f MB)",
            torch.cuda.max_memory_allocated() / 1e6,
            torch.cuda.memory_allocated() / 1e6,
            free / 1e6,
            total / 1e6,
        )
    logger.info("Done in %.2fs.", time.perf_counter() - t0)
    return rc


def _postprocessing_from_args(args):
    from splashsurf_tpu_torch.aabb import Aabb3d
    from splashsurf_tpu_torch.pipeline import PostprocessingParameters

    mesh_aabb = None
    if args.mesh_aabb_min is not None and args.mesh_aabb_max is not None:
        mesh_aabb = Aabb3d(tuple(args.mesh_aabb_min), tuple(args.mesh_aabb_max))
    check_all = args.check_mesh
    return PostprocessingParameters(
        check_mesh_closed=check_all or args.check_mesh_closed,
        check_mesh_manifold=check_all or args.check_mesh_manifold,
        check_mesh_orientation=args.check_mesh_orientation,
        check_mesh_debug=args.check_mesh_debug,
        mesh_cleanup=args.mesh_cleanup,
        mesh_cleanup_snap_dist=args.mesh_cleanup_snap_dist,
        decimate_barnacles=args.decimate_barnacles,
        keep_vertices=args.keep_verts,
        compute_normals=args.normals,
        sph_normals=args.sph_normals,
        normals_smoothing_iters=args.normals_smoothing_iters,
        interpolate_attributes=args.interpolate_attribute,
        mesh_smoothing_iters=args.mesh_smoothing_iters,
        mesh_smoothing_weights=args.mesh_smoothing_weights,
        mesh_smoothing_weights_normalization=args.mesh_smoothing_weights_normalization,
        generate_quads=args.generate_quads,
        quad_max_edge_diag_ratio=args.quad_max_edge_diag_ratio,
        quad_max_normal_angle=args.quad_max_normal_angle,
        quad_max_interior_angle=args.quad_max_interior_angle,
        output_mesh_smoothing_weights=args.output_smoothing_weights,
        output_raw_normals=args.output_raw_normals,
        output_raw_mesh=args.output_raw_mesh,
        mesh_aabb=mesh_aabb,
        mesh_aabb_clamp_vertices=args.mesh_aabb_clamp_verts,
    )


def _parameters_from_args(args):
    from splashsurf_tpu_torch.aabb import Aabb3d
    from splashsurf_tpu_torch.params import (
        GridDecompositionParameters,
        Parameters,
        SpatialDecomposition,
    )

    particle_aabb = None
    if args.particle_aabb_min is not None and args.particle_aabb_max is not None:
        particle_aabb = Aabb3d(
            tuple(args.particle_aabb_min), tuple(args.particle_aabb_max)
        )
    # support radius = 2 * smoothing_length * particle_radius (reconstruct.rs:628)
    return Parameters(
        particle_radius=args.particle_radius,
        rest_density=args.rest_density,
        compact_support_radius=2.0 * args.smoothing_length * args.particle_radius,
        cube_size=args.cube_size * args.particle_radius,
        iso_surface_threshold=args.surface_threshold,
        particle_aabb=particle_aabb,
        spatial_decomposition=(
            SpatialDecomposition.UNIFORM_GRID
            if args.subdomain_grid
            else SpatialDecomposition.NONE
        ),
        grid_decomposition=GridDecompositionParameters(
            subdomain_num_cubes_per_dim=args.subdomain_cubes,
            auto_disable=args.subdomain_grid_auto_disable,
        ),
        dtype="float64" if args.double_precision else "float32",
    )


def reconstruct_subcommand(args, device=None) -> int:
    from splashsurf_tpu_torch import io as st_io
    from splashsurf_tpu_torch.pipeline import reconstruction_pipeline
    from splashsurf_tpu_torch.profiling import profile
    from splashsurf_tpu_torch.sequence import (
        collect_sequence,
        default_output_name,
        is_sequence,
    )

    parameters = _parameters_from_args(args)
    postprocessing = _postprocessing_from_args(args)

    inp = args.input_file_or_sequence

    def _resolve_out(name: str) -> str:
        # reference semantics: a relative -o lands inside --output-dir; an
        # absolute -o wins over --output-dir (reconstruct.rs output handling)
        if args.output_dir and not os.path.isabs(name):
            return os.path.join(args.output_dir, name)
        return name

    if is_sequence(inp):
        out_pattern = (
            _resolve_out(args.output_file)
            if args.output_file
            else default_output_name(inp, args.output_dir)
        )
        jobs = collect_sequence(
            inp, out_pattern, args.start_index, args.end_index
        )
        if not jobs:
            logger.error("no input files match the sequence pattern %r", inp)
            return 1
        logger.info("Found %d input files for sequence %r", len(jobs), inp)
    else:
        out = (
            _resolve_out(args.output_file)
            if args.output_file
            else default_output_name(inp, args.output_dir)
        )
        from splashsurf_tpu_torch.sequence import SequencePaths

        jobs = [SequencePaths(input_file=inp, output_file=out)]

    def run_job(job):
        logger.info("Reconstructing %s -> %s", job.input_file, job.output_file)
        with profile("read particles"):
            positions, attributes = st_io.particles_with_attributes_from_file(
                job.input_file, dtype=np.dtype(parameters.dtype)
            )
        logger.info("Loaded %d particles", len(positions))
        result = reconstruction_pipeline(
            positions, parameters, postprocessing, attributes, device=device
        )
        mesh_with_data = result.tri_quad_mesh or result.tri_mesh
        os.makedirs(os.path.dirname(job.output_file) or ".", exist_ok=True)
        with profile("write mesh"):
            st_io.write_mesh(job.output_file, mesh_with_data)
        m = mesh_with_data.mesh
        n_cells = len(m.triangles) + (
            len(m.quads) if hasattr(m, "quads") else 0
        )
        logger.info(
            "Wrote surface mesh: %d vertices, %d cells", len(m.vertices), n_cells
        )

    # Sequence progress bar (reconstruct.rs:394-404): only for multi-file
    # runs; renders on stderr TTYs, suspended around log records.
    from splashsurf_tpu_torch import progress as prog

    pb = None
    if len(jobs) > 1 and not args.quiet:
        pb = prog.ProgressBar(len(jobs))
        prog.set_progress_bar(pb)

    def run_job_counted(job):
        run_job(job)
        bar = prog.get_progress_bar()
        if bar is not None:
            bar.inc()

    try:
        if args.mt_files and len(jobs) > 1:
            # Parallel over files (reconstruct.rs:405-432): IO/host post-proc
            # of different frames overlaps; device work serializes on the card.
            from concurrent.futures import ThreadPoolExecutor

            workers = args.num_threads or min(4, len(jobs))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(run_job_counted, jobs))
        else:
            for job in jobs:
                run_job_counted(job)
    finally:
        if pb is not None:
            pb.finish()
            prog.set_progress_bar(None)
    return 0


def convert_subcommand(args) -> int:
    from splashsurf_tpu_torch import io as st_io
    from splashsurf_tpu_torch.aabb import Aabb3d

    if (args.particles is None) == (args.mesh is None):
        raise ValueError("specify exactly one of --particles or --mesh")
    if os.path.exists(args.output_file) and not args.overwrite:
        raise FileExistsError(
            f"output file {args.output_file} exists (use --overwrite)"
        )
    if args.particles:
        positions, attributes = st_io.particles_with_attributes_from_file(
            args.particles
        )
        if args.domain_min is not None and args.domain_max is not None:
            aabb = Aabb3d(tuple(args.domain_min), tuple(args.domain_max))
            mask = aabb.contains_points(torch.as_tensor(positions)).numpy()
            positions = positions[mask]
            attributes = {k: v[mask] for k, v in attributes.items()}
        st_io.write_particles(args.output_file, positions, attributes)
        logger.info("Wrote %d particles to %s", len(positions), args.output_file)
    else:
        mesh = st_io.mesh_from_file(args.mesh)
        st_io.write_mesh(args.output_file, mesh)
        logger.info(
            "Wrote mesh (%d vertices, %d triangles) to %s",
            mesh.num_vertices,
            mesh.num_triangles,
            args.output_file,
        )
    return 0


def main():
    sys.exit(run_splashsurf())


if __name__ == "__main__":
    main()
