"""Several devices in one process (PyTorch port of
``splashsurf_tpu.parallel.mesh``).

The reference is single-controller: one process shards its arrays over
``jax.devices()``. The port keeps that design. The process holds a list of
devices (``devices``, ``set_devices``); ``make_mesh`` takes an ordered slice
of it with the axis "sub". A per-shard value is a Python list with one
tensor per mesh device, and the collectives below are plain functions over
such lists, each an explicit copy to the receiving device. A list may name
one device several times: those are virtual shards, as the reference's
tests get 8 CPU devices from XLA's host device count flag. D shards then run
one after another on that device, and the routing, the exchange of faces
and the stitch run there too.

Received buffers are always fresh allocations (``torch.cat``), never the
sender's tensor: on virtual shards ``x.to(device)`` returns ``x`` itself,
and a receiver that wrote into it would write into the sender's buffer.
The only tensors shards share are read-only inputs (positions, values).

The subdomain batch is the parallel axis. Each shard splats its rows (its
x-slab of subdomains) with kernel K3, the halo exchanges raw boundary faces
(``sharded_halo_overwrite``), and marching cubes runs per shard in
ascending subdomain id (``sharded_levelset_step``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from splashsurf_tpu_torch import kernels
from splashsurf_tpu_torch import subdomains as S
from splashsurf_tpu_torch.params import Parameters
from splashsurf_tpu_torch.profiling import StageClock

# ---------------------------------------------------------------------------
# the process's device list
# ---------------------------------------------------------------------------

_INSTALLED: Optional[Tuple[torch.device, ...]] = None


def _default_devices(kind: str) -> List[torch.device]:
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no device list for device type {kind!r}")


def devices(kind: str = "cuda") -> List[torch.device]:
    """The process's devices of type ``kind``: the list ``set_devices``
    installed, else every visible CUDA device for "cuda" and one CPU for
    "cpu". An installed list of another type raises ValueError: a
    computation is never moved to another kind of device than its input's."""
    if _INSTALLED is not None:
        if _INSTALLED[0].type != kind:
            raise ValueError(
                f"the installed device list is {_INSTALLED[0].type}, not {kind}"
            )
        return list(_INSTALLED)
    return _default_devices(kind)


def set_devices(devs: Optional[Sequence] = None) -> None:
    """Install ``devs`` (devices or names, all of one type; a device may
    repeat, each repetition one virtual shard) as the process's device
    list; ``None`` restores the default."""
    global _INSTALLED
    if devs is None:
        _INSTALLED = None
        return
    devs = tuple(torch.device(d) for d in devs)
    if not devs:
        raise ValueError("an empty device list")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"devices of several types: {devs}")
    if devs[0].type == "cuda" and any(d.index is None for d in devs):
        raise ValueError("name each CUDA device with its index, e.g. 'cuda:0'")
    _INSTALLED = devs


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An ordered list of devices with one axis: shard d runs on
    ``devices[d]``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "sub"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "sub", device="cuda") -> DeviceMesh:
    """The mesh over the first ``n_devices`` (all by default) of the
    process's devices of ``device``'s type; RuntimeError if there are none."""
    devs = devices(torch.device(device).type)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise RuntimeError(f"no {torch.device(device).type} device")
    return DeviceMesh(tuple(devs), axis_name)


# ---------------------------------------------------------------------------
# collectives over per-shard lists
# ---------------------------------------------------------------------------


def all_gather(parts: Sequence[torch.Tensor], mesh: DeviceMesh, dim: int = 0) -> List[torch.Tensor]:
    """Every shard receives the concatenation of all shards' ``parts`` along
    ``dim``, in device order. Shards on one device share one received copy
    (read-only)."""
    got = {}
    for dev in mesh.devices:
        if dev not in got:
            got[dev] = torch.cat([p.to(dev) for p in parts], dim=dim)
    return [got[dev] for dev in mesh.devices]


def all_to_all(buckets: Sequence[Sequence[torch.Tensor]], mesh: DeviceMesh) -> List[torch.Tensor]:
    """``buckets[src][dst]`` goes to shard ``dst``: shard ``dst`` receives
    the concatenation of ``buckets[src][dst]`` over ``src`` in device order,
    a fresh tensor on its device."""
    return [
        torch.cat([buckets[src][dst].to(dev) for src in range(mesh.size)])
        for dst, dev in enumerate(mesh.devices)
    ]


def _reduce(values, mesh: DeviceMesh, op) -> List[torch.Tensor]:
    got = {}
    for dev in mesh.devices:
        if dev not in got:
            got[dev] = functools.reduce(op, [v.to(dev) for v in values])
    return [got[dev] for dev in mesh.devices]


def psum(values: Sequence[torch.Tensor], mesh: DeviceMesh) -> List[torch.Tensor]:
    """The sum of the shards' scalars (or equal-shaped tensors) in device
    order, on every shard (shards on one device share it, read-only)."""
    return _reduce(values, mesh, torch.add)


def pmax(values: Sequence[torch.Tensor], mesh: DeviceMesh) -> List[torch.Tensor]:
    """The largest of the shards' scalars, on every shard."""
    return _reduce(values, mesh, torch.maximum)


def blocks(n: int, D: int) -> List[Tuple[int, int]]:
    """Shard d's block [lo, hi) of n rows: ceil(n / D) rows each, the last
    ones shorter or empty."""
    per = -(-n // D)
    return [(min(n, d * per), min(n, (d + 1) * per)) for d in range(D)]


# ---------------------------------------------------------------------------
# the sharded splat -> halo -> marching cubes step
# ---------------------------------------------------------------------------


def sharded_halo_overwrite(mesh: DeviceMesh, ls, own_flat, nb_idx, nb_flat, chunk: Optional[int] = None):
    """The canonical halo across shards, in place on each shard's level sets
    ``ls[d]`` (B_d, P, P, P); ``own_flat[d]`` (B_d,) are the shard's flat
    subdomain ids and ``nb_idx[d]`` / ``nb_flat[d]`` (26, B_d) its columns of
    the global neighbour tables (``subdomains._neighbor_tables``), whose
    batch indices address the rows of all shards in device order.

    Each shard writes the raw faces of its rows into its block of a (6, B,
    P^2) shell table, the table is all-gathered, and each shard takes its
    halo from it (``subdomains.halo_from_shells``), ``chunk`` rows at a time.
    Every shard has written its faces before any shard reads, so one pass
    gives the final halo: the value of the smallest-id holder of each
    shared point, as the single-device pass leaves it."""
    shells = all_gather([S.extract_faces(x) for x in ls], mesh, dim=1)
    for d in range(mesh.size):
        B = ls[d].shape[0]
        step = B if chunk is None else max(1, chunk)
        for b0 in range(0, B, step):
            b1 = min(b0 + step, B)
            S.halo_from_shells(
                ls[d][b0:b1], own_flat[d][b0:b1], nb_idx[d][:, b0:b1], nb_flat[d][:, b0:b1],
                shells[d],
            )
    return ls


# split axis of each argument of the step; None: replicated on every shard
STEP_LAYOUT = dict(positions=None, values=None, shards=0)


def _levelset_mc_step(
    mesh: DeviceMesh, positions, values, shards, sd, compact_support_radius, iso,
    chunk_bytes: int = S.CHUNK_BYTES, clock: Optional[StageClock] = None,
    encode: Optional[bool] = None,
):
    """Splat, halo and marching cubes over the subdomain batch, sharded.

    ``positions`` and ``values`` are replicated (read on every shard);
    ``shards[d]`` is shard d's decomposition: its occupied subdomains
    ("occ_ids", "starts", "counts", host arrays, ids ascending and the
    shards' ids ascending in device order) and their pairs ("pids", "cells",
    "ranks", tensors on the shard's device, in ``decompose`` order). Each
    shard splats its rows in ``subdomains.splat_plan`` chunks (kernel K3 on
    its device), the halo runs across shards, and each shard runs marching
    cubes over its rows in ascending id. With ``clock``, the stages
    "splat", "halo" and "marching cubes" are lapped on it.

    With ``encode`` (a bool: whether t is quantized to u16), marching
    cubes is the encoded one: each shard's chunks give their per-row
    counts and owned-point packs (``subdomains._encode_chunk``), decoded
    on the host by ``subdomains._mc_encoded_mesh`` into the single-device
    mesh (the reference's ``sharded_mc_counts_encoded`` and
    ``sharded_scan_mc_encode``).

    Returns per shard a dict: "vertices", "keys", "triangles" (lists of its
    marching-cubes chunks' patches), "ls_max" (its largest level-set value,
    where it has no triangle), or with ``encode`` "enc", the record of its
    encoded chunks; and "B",
    "n_pairs", "splat_chunks" and "stage_s" (its splat and marching-cubes
    seconds, its device synchronised where
    ``subdomains.enable_profile_sync(True)`` asks). Concatenated in device order, the
    patches are in the single-device order."""
    dtype = positions.dtype
    itemsize = torch.finfo(dtype).bits // 8
    h, hsc, P = compact_support_radius, sd.margin_cells, sd.points_per_dim
    occ_ids = np.concatenate([s["occ_ids"] for s in shards])
    ns = sd.num_subdomains
    sub_ijk_np = np.stack(
        [occ_ids // (ns[1] * ns[2]), (occ_ids // ns[2]) % ns[1], occ_ids % ns[2]], axis=1
    )
    nb_idx_np, nb_flat_np = S._neighbor_tables(occ_ids, sub_ijk_np, sd)
    offs = np.cumsum([0] + [len(s["occ_ids"]) for s in shards])

    out, ls, own, nb_idx, nb_flat, sub_ijk = [], [], [], [], [], []
    for d, (dev, s) in enumerate(zip(mesh.devices, shards)):
        c = StageClock(dev, sync=S._PROFILE_SYNC)
        rows = slice(int(offs[d]), int(offs[d + 1]))
        sub_ijk.append(torch.as_tensor(sub_ijk_np[rows], device=dev))
        own.append(torch.as_tensor(occ_ids[rows], device=dev))
        nb_idx.append(torch.as_tensor(nb_idx_np[:, rows], device=dev))
        nb_flat.append(torch.as_tensor(nb_flat_np[:, rows], device=dev))
        pos, val = positions.to(dev), values.to(dev)
        starts = torch.as_tensor(s["starts"], device=dev)
        counts = torch.as_tensor(s["counts"], device=dev)
        plan = S.splat_plan(s["counts"], sd, itemsize, chunk_bytes)
        ls_d = torch.empty((len(s["occ_ids"]), P, P, P), dtype=dtype, device=dev)
        for rows_np in plan:
            ls_d[torch.as_tensor(rows_np, device=dev)] = S.splat_rows(
                pos, val, s["pids"], s["cells"], s["ranks"], starts, counts, s["counts"],
                sub_ijk[d], rows_np, sd, h, hsc,
            )
        c.lap("splat")
        ls.append(ls_d)
        out.append(dict(
            B=len(s["occ_ids"]), n_pairs=int(s["pids"].shape[0]), splat_chunks=len(plan),
            stage_s=c.times, vertices=[], keys=[], triangles=[],
        ))
    if clock is not None:
        clock.lap("splat")

    sharded_halo_overwrite(mesh, ls, own, nb_idx, nb_flat, chunk=max(1, chunk_bytes // (8 * P**3)))
    if clock is not None:
        clock.lap("halo")

    mc_rows = max(1, chunk_bytes // (S.MC_POINT_BYTES * P**3))
    for d, dev in enumerate(mesh.devices):
        c = StageClock(dev, sync=S._PROFILE_SYNC)
        if encode is not None:
            out[d]["enc"] = S.encode_record()
        for b0 in range(0, ls[d].shape[0], mc_rows):
            chunk = ls[d][b0 : b0 + mc_rows]
            if encode is not None:
                rows = np.arange(offs[d] + b0, offs[d] + b0 + chunk.shape[0])
                S._encode_chunk(chunk, rows, sd, iso, encode, out[d]["enc"])
                continue
            v, k, t = S.chunk_mc(chunk, sub_ijk[d][b0 : b0 + mc_rows], sd, iso)
            out[d]["vertices"].append(v)
            out[d]["keys"].append(k)
            out[d]["triangles"].append(t)
        if encode is None and not any(t.shape[0] for t in out[d]["triangles"]):
            out[d]["ls_max"] = float(ls[d].max()) if ls[d].numel() else -np.inf
        ls[d] = None
        c.lap("marching cubes")
        out[d]["stage_s"].update(c.times)
    if clock is not None:
        clock.lap("marching cubes")
    return out


def sharded_levelset_step(mesh: DeviceMesh, axis_name: str = "sub"):
    """Return (step_fn, layout): the splat + halo + marching-cubes step over
    ``mesh`` (``_levelset_mc_step`` with the mesh bound) and the split axis
    of each of its array arguments (None: replicated on every shard; 0: one
    entry per shard, the subdomain batch split into x-slabs)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis {mesh.axis_name!r}, not {axis_name!r}")
    return functools.partial(_levelset_mc_step, mesh), dict(STEP_LAYOUT)


def sharded_reconstruction_demo(
    n_devices: int, parameters: Optional[Parameters] = None, device="cuda"
) -> dict:
    """Build a small lattice cloud, shard it over an ``n_devices`` mesh of
    ``device``'s type, run the sharded densities, the sharded decomposition
    and ONE splat + halo + marching-cubes step, and return the counts:
    devices, occupied subdomains, vertices and triangles (before the
    stitch merges shared edges), as the reference's demo reports them."""
    from splashsurf_tpu_torch.params import GridDecompositionParameters
    from splashsurf_tpu_torch.parallel.decompose import decompose_sharded
    from splashsurf_tpu_torch.parallel.density import compute_particle_densities_sharded
    from splashsurf_tpu_torch.reconstruction import grid_for_reconstruction

    if parameters is None:
        parameters = Parameters.new_relative(0.025, 4.0, 1.0)
    parameters = dataclasses.replace(
        parameters, grid_decomposition=GridDecompositionParameters(8, auto_disable=False)
    )
    mesh = make_mesh(n_devices, device=device)

    rng = np.random.default_rng(0)
    side = 12
    coords = (np.arange(side) + 0.5) * 2 * parameters.particle_radius
    X, Y, Z = np.meshgrid(coords, coords, coords, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    pts += rng.uniform(-0.2, 0.2, pts.shape).astype(np.float32) * parameters.particle_radius
    positions = torch.as_tensor(pts, device=mesh.devices[0])

    grid = grid_for_reconstruction(
        positions, parameters.particle_radius, parameters.compact_support_radius,
        parameters.cube_size,
    )
    sd = S.initialize_parameters(parameters, grid)
    h = parameters.compact_support_radius
    rho = compute_particle_densities_sharded(positions, h, parameters.particle_rest_mass, mesh=mesh)
    values = kernels.rounded(parameters.particle_rest_mass, positions.dtype) / rho
    dec = decompose_sharded(positions, sd, mesh)
    out = _levelset_mc_step(
        mesh, positions, values, dec["shards"], sd, h, parameters.iso_surface_threshold
    )
    total_t = sum(t.shape[0] for o in out for t in o["triangles"])
    assert total_t > 0, "sharded demo produced no triangles"
    return {
        "devices": mesh.size,
        "subdomains": sum(o["B"] for o in out),
        "vertices": sum(v.shape[0] for o in out for v in o["vertices"]),
        "triangles": total_t,
    }
