"""The speculative frame plans: what a frame reuses from the frames before
it, how each plan is sized, and what a failed check does to it.

A frame of the dense route runs on plans that earlier frames of the same
key left, so that it reads nothing back from the card before its mesh copy
(the reference's plans: reconstruction.py:53-76, neighbors.py:1091-1100
and ops/global_sweep.py:937-970 of the reference). The checks that the
plans still hold come back with that copy; a failed one is a miss, which
updates the plan concerned and runs the frame again. The plans are
process-global, as the reference's are:

- ``GRID_PLAN``: per (N, dtype, particle radius, support radius, cube
  size) of a tensor input, the last dense frame's (bucketed grid,
  unbucketed cell counts). A key whose cold grid equals the grid that
  missed (its extent straddles an alignment boundary) would miss on every
  frame, and stops speculating (``GRID_NOSPEC``, through
  ``PENDING_NOSPEC``, the grid that missed);
- ``GRID_MOVED``: per key whose grid moved within its last
  ``GRID_STILL_FRAMES`` frames, the frames its grid has held since. Such a
  key reads its grid before the frame instead of speculating on its plan
  (``reads_grid``), and ``GRID_CHECK_STATS`` counts those frames;
- ``WARMED``: the grid keys whose planning frame ran its discarded warm
  frame (``SPLASHSURF_TPU_PREWARM``): once per key, not again after a miss
  re-plans it;
- ``DENSITY_PLAN``: per ``density_key``, the densities' lattice,
  formulation and capacities (``neighbors.compute_particle_densities``);
- ``MC_CAPS``: per (grid points, dtype), the marching cubes' vertex and
  triangle capacities;
- ``PULL_PLAN`` and ``PULL_PLAN_ENC``: per (grid points, dtype), the
  (vertex, triangle) buckets of the packed mesh copy and the (vertex,
  active point) buckets of the encoded one, kept apart, as the reference
  keeps them, so that the two never read each other's plan;
- ``OVER_PLAN``: per (grid points, N), the raster overflow capacity, fitted
  to the previous frame's count (usually 0, which skips the overflow
  splat).

``SPECULATION_STATS`` counts the outcomes under the reference's keys
(its global_pipeline.py:26-32; ``global_pipeline.SPECULATION_STATS`` is
this dict). Each warm frame's CUDA graph was captured on a density plan, so
clearing the density plans drops every graph (``frame_graph``).
"""

from __future__ import annotations

from typing import Optional

from splashsurf_tpu_torch import frame_graph

SPECULATION_STATS = {
    "frames": 0,
    "density_miss": 0,
    "grid_miss": 0,
    "caps_retry": 0,
    "overflow_retry": 0,
}

# The tensor frames that held a grid plan but read their grid first
# ("read"), and of those the frames whose grid had moved ("moved": a grid
# miss avoided). Apart from SPECULATION_STATS, whose keys are the
# reference's.
GRID_CHECK_STATS = {"read": 0, "moved": 0}

# A grid miss throws the whole frame away (~30-40 ms at 13.2M particles on
# an H100), while reading the grid first costs an aminmax over the positions
# and one sync (~1 ms): speculating pays only where grids move less often
# than about once in 40 frames. A key speculates again once its grid held
# on each of its last GRID_STILL_FRAMES frames.
GRID_STILL_FRAMES = 8

GRID_PLAN: dict = {}
GRID_NOSPEC: set = set()
GRID_MOVED: dict = {}
PENDING_NOSPEC: dict = {}
WARMED: set = set()
DENSITY_PLAN: dict = {}
MC_CAPS: dict = {}
PULL_PLAN: dict = {}
PULL_PLAN_ENC: dict = {}
OVER_PLAN: dict = {}


def pow2(n: int, lo: int = 1024) -> int:
    """The power of two at least ``n``, and at least ``lo``."""
    return max(lo, 1 << (max(int(n), 1) - 1).bit_length())


def bucket16(n: int, lo: int = 1024) -> int:
    """Round up to 16 steps per power of two (<= 6% of padding)."""
    n = max(int(n), lo)
    p = 1 << max((n - 1).bit_length() - 4, 0)
    return -(-n // p) * p


def clear() -> None:
    """Forget every plan and every warmed key, drop every warm frame's
    graph and zero the counts."""
    for table in (GRID_PLAN, GRID_NOSPEC, GRID_MOVED, PENDING_NOSPEC, WARMED, DENSITY_PLAN,
                  MC_CAPS, PULL_PLAN, PULL_PLAN_ENC, OVER_PLAN):
        table.clear()
    frame_graph.drop()
    for stats in (SPECULATION_STATS, GRID_CHECK_STATS):
        for k in stats:
            stats[k] = 0


def clear_grid() -> None:
    """Forget the grid plans, the keys' moves and the warmed keys, and drop
    the warm frames' graphs."""
    GRID_PLAN.clear()
    GRID_NOSPEC.clear()
    GRID_MOVED.clear()
    WARMED.clear()
    frame_graph.drop()


def clear_density() -> None:
    """Forget the density plans, and drop the warm frames' graphs (each was
    captured on one)."""
    DENSITY_PLAN.clear()
    frame_graph.drop()


def density_key(n: int, dtype: str, compact_support_radius: float, capacity=None):
    """The key of a density plan: N, dtype, support and explicit capacity."""
    return (n, dtype, float(compact_support_radius), None if capacity is None else int(capacity))


# ---------------------------------------------------------------------------
# the background grid
# ---------------------------------------------------------------------------


def grid_plan(gkey):
    """The (grid, unbucketed cell counts) that a frame of ``gkey`` speculates
    on, or None: no key (the input is not a tensor), no plan, or a key that
    stopped speculating."""
    if gkey is None or gkey in GRID_NOSPEC:
        return None
    return GRID_PLAN.get(gkey)


def reads_grid(gkey) -> bool:
    """Whether a frame of ``gkey`` that holds a grid plan reads its grid
    first instead of speculating on the plan: the key's grid moved within
    its last ``GRID_STILL_FRAMES`` frames."""
    return gkey in GRID_MOVED


def _note_moved(gkey, moved: bool) -> None:
    if moved:
        GRID_MOVED[gkey] = 0
    elif gkey in GRID_MOVED:
        GRID_MOVED[gkey] += 1
        if GRID_MOVED[gkey] >= GRID_STILL_FRAMES:
            del GRID_MOVED[gkey]


def note_grid_miss(gkey) -> None:
    """Drop the grid plan that missed and remember it: if the cold grid
    equals it, the key stops speculating. The key's grid moved."""
    _note_moved(gkey, True)
    missed = GRID_PLAN.pop(gkey, None)
    if missed is not None:
        PENDING_NOSPEC[gkey] = missed


def note_grid(gkey, plan, speculated: bool, read_over=None) -> bool:
    """Record the (grid, unbucketed cell counts) that a dense frame of
    ``gkey`` ran on; ``speculated``: it ran on the key's plan;
    ``read_over``: the key's plan, where the frame read its grid first
    instead (``reads_grid``), which says whether the grid held or moved. A
    cold grid equal to the one that just missed stops the key speculating
    instead. Returns whether the frame planned the key from a grid of its
    own for the first time (a planning frame, which prewarms)."""
    if read_over is not None:
        moved = plan != read_over
        GRID_CHECK_STATS["read"] += 1
        GRID_CHECK_STATS["moved"] += moved
        _note_moved(gkey, moved)
    if PENDING_NOSPEC.pop(gkey, None) == plan:
        GRID_NOSPEC.add(gkey)
        return False
    GRID_PLAN[gkey] = plan
    return not speculated and read_over is None and gkey not in WARMED


# ---------------------------------------------------------------------------
# the checks a frame's mesh copy brings back
# ---------------------------------------------------------------------------


def note_failed_check(labels, flags, count: bool = True) -> Optional[str]:
    """Which plan a frame's deferred checks say missed: ``flags`` holds
    the value of each check, ``labels`` its plan ("grid" or "density").
    None where every check held. A failed grid check wins: "grid", counted
    in ``grid_miss``. Otherwise "density", counted in ``density_miss``; the
    density plans are cleared, which drops every graph. ``count=False``
    (the single-dispatch warm frame) counts nothing."""
    failed = {label for label, ok in zip(labels, flags) if not ok}
    if not failed:
        return None
    if "grid" in failed:
        SPECULATION_STATS["grid_miss"] += count
        return "grid"
    SPECULATION_STATS["density_miss"] += count
    clear_density()
    return "density"


# ---------------------------------------------------------------------------
# the dense route: overflow, MC and pull plans
# ---------------------------------------------------------------------------


def default_overflow_capacity(n: int) -> int:
    """The raster overflow capacity of N particles with no plan: N / 64
    rounded up to a power of two, at least 4096."""
    return pow2(n // 64, lo=4096)


def overflow_capacity(okey, n: int) -> int:
    """The raster overflow capacity of a frame of ``okey`` (grid points, N):
    its plan, else the default."""
    ocap = OVER_PLAN.get(okey)
    return default_overflow_capacity(n) if ocap is None else ocap


def pull_plans(encoded: bool) -> dict:
    """The pull plans of the encoded pull, or of the packed one."""
    return PULL_PLAN_ENC if encoded else PULL_PLAN


def mc_caps(total_v: int, total_t: int) -> tuple:
    """The MC (vertex, triangle) capacities for a frame's totals, with a
    quarter to spare."""
    return bucket16(total_v * 5 // 4), bucket16(total_t * 5 // 4)


def plan_mc_caps(key, total_v: int, total_t: int) -> tuple:
    """Plan the MC capacities of ``key`` (grid points, dtype) from a frame's
    totals; returns them."""
    MC_CAPS[key] = caps = mc_caps(total_v, total_t)
    return caps


def note_overflow_plan(okey, total_over: int) -> None:
    """Fit the next frame's overflow capacity to this frame's true count."""
    OVER_PLAN[okey] = 0 if total_over == 0 else pow2(total_over * 2, lo=1024)


def check_dense(totals, *, okey, ocap, key, caps, encoded, pulled=None, count=True,
                over_max=None, drop_both=False) -> str:
    """The plan checks of a dense frame on its ``totals`` (vertices,
    triangles, active points, the second bucket's stream and the raster
    overflow count), in the reference's order. A miss re-plans here and
    nowhere else:

    - "overflow": the overflow count is past the capacity ``ocap``; the
      overflow plan grows to twice the count, a power of two (at most
      ``over_max``);
    - "caps": an MC total is past the capacities ``caps``; they are planned
      anew from the totals and the pull plan of the frame's pull
      (``encoded``) is dropped (both pull plans with ``drop_both``);
    - otherwise the frame's buckets go into its pull plans and the overflow
      plan is fitted to the count; "bucket" where a stream outgrew the
      buckets ``pulled`` (None: nothing was pulled), else "ok".

    ``count``: count the overflow and caps retries in ``SPECULATION_STATS``
    (the single-dispatch frame counts nothing)."""
    total_v, total_t, total_c, n2, total_over = totals
    vcap, tcap = caps
    if total_over > ocap:
        grown = pow2(total_over * 2, lo=4096)
        OVER_PLAN[okey] = grown if over_max is None else min(grown, over_max)
        SPECULATION_STATS["overflow_retry"] += count
        return "overflow"
    if total_v > vcap or total_t > tcap or total_c > tcap:  # the points' list has tcap
        SPECULATION_STATS["caps_retry"] += count
        plan_mc_caps(key, total_v, total_t)
        for dropped in (PULL_PLAN, PULL_PLAN_ENC) if drop_both else (pull_plans(encoded),):
            dropped.pop(key, None)
        return "caps"
    pull_plans(encoded)[key] = (min(vcap, bucket16(total_v)), min(tcap, bucket16(n2)))
    note_overflow_plan(okey, total_over)
    if pulled is None or total_v > pulled[0] or n2 > pulled[1]:
        return "bucket"
    return "ok"


def cellraster_ready(n_points, n: int, dtype: str) -> bool:
    """Whether a frame may take the cell-raster densities (reference
    global_pipeline.py:383-389): the previous frame of its (grid, N) left no
    raster overflow (its overflow plan is 0) and the MC capacities of its
    grid are planned."""
    return OVER_PLAN.get((n_points, n)) == 0 and (n_points, dtype) in MC_CAPS


def warm_plans(n_points, n: int, dtype: str, compact_support_radius: float, encoded: bool):
    """What a single-dispatch warm frame runs on: (density plan, MC
    capacities, pull plan, overflow capacity), or None where a plan is
    missing or its buckets exceed the capacities. An encoded pull plan
    starts from the packed one, as in the reference: active points <=
    triangles, so the triangle bucket is a safe start."""
    dplan = DENSITY_PLAN.get(density_key(n, dtype, compact_support_radius))
    key = (n_points, dtype)
    caps = MC_CAPS.get(key)
    pull = pull_plans(encoded).get(key) or PULL_PLAN.get(key)
    if dplan is None or caps is None or pull is None:
        return None
    if pull[0] > caps[0] or pull[1] > caps[1]:
        return None
    return dplan, caps, pull, overflow_capacity((n_points, n), n)
