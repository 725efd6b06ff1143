"""Sharded subdomain decomposition (PyTorch port of
``splashsurf_tpu.parallel.decompose``): the ghost-pair expansion and its
sort, over a device mesh.

Each shard expands its block of particle rows into (subdomain, particle)
pairs with ``subdomains.expand_pairs``, the single-device arithmetic, and
sends each pair to the shard that owns its target's x-slab of subdomains
(``slab_w = ceil(ns[0] / D)`` columns of subdomains, the last shard taking
any remainder). Each shard then sorts its pairs by the total key (target,
raster cell, particle id) with ``subdomains.sort_pairs``, ranks them in
their raster cells and cuts its occupied-subdomain segments. The received
pairs come in device order, each source's pairs particle-major, so their
particle ids ascend, and every subdomain's pair segment equals the
single-device segment element for element.

Slabs of x are contiguous ranges of flat subdomain ids, so the shards'
occupied subdomains, concatenated in device order, are the single-device
list in ascending id.

The reference sizes its routing with fixed capacities for the TPU: uniform
send buckets (``Lsend``), a segment-table capacity (``b_cap``), an overflow
guard, and ``_decorrelate``, a re-shard that keeps x-sorted inputs from
filling one bucket. Eager PyTorch sends exactly sized buckets, so none of
them has a counterpart here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from splashsurf_tpu_torch.parallel.mesh import DeviceMesh, all_to_all, blocks
from splashsurf_tpu_torch.placement import on_device
from splashsurf_tpu_torch.subdomains import (
    SubdomainGridParams,
    expand_pairs,
    occupied_segments,
    sort_pairs,
)


def _owner_of(target: torch.Tensor, sd: SubdomainGridParams, D: int, slab_w: int):
    """The shard owning each pair's target: its x-slab of subdomains."""
    ns = sd.num_subdomains
    return torch.clamp(target // (ns[1] * ns[2]) // slab_w, max=D - 1)


def decompose_sharded(
    positions, sd: SubdomainGridParams, mesh: DeviceMesh,
    n_valid: Optional[int] = None, device=None,
) -> dict:
    """The decomposition of ``subdomains.decompose``, sharded over ``mesh``.
    Rows past ``n_valid`` make no pair.

    Returns a dict: "shards", one per mesh device, each with its pairs'
    "pids", "cells" and "ranks" (int64 tensors on its device, in
    ``decompose`` order) and its occupied subdomains "occ_ids", "starts",
    "counts" (host arrays, ascending ids, starts into its pair arrays);
    "n_pairs" (the total), "D" and "slab_w". An array goes to ``device``
    (``placement.on_device``) before it is cut into the shards' blocks."""
    positions = on_device(positions, device=device)
    D = mesh.size
    n = positions.shape[0]
    nv = n if n_valid is None else min(int(n_valid), n)
    slab_w = -(-sd.num_subdomains[0] // D)

    fields = ([], [], [])  # per source: its buckets of targets, cells, pids
    for (lo, hi), dev in zip(blocks(n, D), mesh.devices):
        block = positions[lo:hi].to(dev)
        valid = torch.arange(lo, hi, device=dev) < nv if nv < hi else None
        pid, target, cell = expand_pairs(block, sd, valid)
        pid = pid + lo
        owner = _owner_of(target, sd, D, slab_w)
        sel = [owner == dst for dst in range(D)]
        for f, x in zip(fields, (target, cell, pid)):
            f.append([x[m] for m in sel])
    target, cell, pid = (all_to_all(f, mesh) for f in fields)
    del fields

    shards = []
    for d in range(D):
        t, p, c, r = sort_pairs(target[d], cell[d], pid[d], sd)
        ids, starts, counts = occupied_segments(t)
        shards.append(dict(pids=p, cells=c, ranks=r, occ_ids=ids, starts=starts, counts=counts))
    return dict(
        shards=shards, n_pairs=sum(int(s["pids"].shape[0]) for s in shards), D=D, slab_w=slab_w,
    )


def split_decomposition(single: dict, sd: SubdomainGridParams, mesh: DeviceMesh) -> list:
    """The shards of ``decompose_sharded`` cut from a single-device
    decomposition ``single`` (its "pids", "cells", "ranks" and occupied
    "occ_ids", "starts", "counts"): each shard's slab is a contiguous run of
    occupied subdomains and of sorted pairs. Its pair arrays go to its
    device; where that is their own, they stay views (read only)."""
    D = mesh.size
    ns = sd.num_subdomains
    slab_w = -(-ns[0] // D)
    ids, starts, counts = single["occ_ids"], single["starts"], single["counts"]
    owner = np.minimum(ids // (ns[1] * ns[2]) // slab_w, D - 1)
    shards = []
    for d, dev in enumerate(mesh.devices):
        rows = np.nonzero(owner == d)[0]
        p0 = int(starts[rows[0]]) if len(rows) else 0
        p1 = int(starts[rows[-1]] + counts[rows[-1]]) if len(rows) else 0
        shards.append(dict(
            {k: single[k][p0:p1].to(dev) for k in ("pids", "cells", "ranks")},
            occ_ids=ids[rows], starts=starts[rows] - p0, counts=counts[rows],
        ))
    return shards
