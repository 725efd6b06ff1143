"""k1_roofline_pct (%, device trace): the level-set sweep (kernel K1,
``csrc/sweep_global.cu`` with its occupancy-mask pre-pass) against its
roofline bound.

Work, counted from each frame's positions (``harness.work.point_pairs``):
23 float32 operations per (grid point, particle) pair within the compact
support; bytes: each particle's position and weight read once (16 B) and
every grid point that a particle reaches written once (4 B). The bound of
the frames completed in the traced window, over the summed device time of
the kernels named below there.

K3 (the subdomain route's ``csrc/splat_sweep.cu``) launches the same
``level_set_tiles``, and K4 (``csrc/pair_sweep.cu``) the same mask
pre-pass, so their time cannot be told from K1's by name: the metric
reads nothing where a window frame took a route other than the dense or
slab one, where the program's routes are unknown, or where the trace
holds K4's ``pair_sweep_tiles``."""

import sys

from harness.roofline import bound_s, share_pct
from harness.work import point_pairs
from reference.surface import Params

KERNELS = ("level_set_tiles", "occupancy_mask_kernel")
SHARING = ("pair_sweep_tiles",)  # K4, whose pre-pass is K1's
K1_ROUTES = ("dense", "slab")
OPS_PER_PAIR = 23
BYTES_PER_PARTICLE = 16
BYTES_PER_POINT = 4


def after_window(run):
    if run.trace is None:
        return
    p = Params.from_config(run.config)
    bound = {}
    for k in sorted(set(run.frame_ids)):
        pairs, points = point_pairs(run.positions(k), p)
        bound[k] = bound_s(BYTES_PER_PARTICLE * run.n[k] + BYTES_PER_POINT * points,
                           OPS_PER_PAIR * pairs)
    run.state["k1_bound_s"] = sum(bound[k] for k in run.frame_ids)


def read(run):
    if run.trace is None:
        return None
    routes = set((run.routes or {}).values())
    shared = sorted({o.name for o in run.trace.device if any(s in o.name for s in SHARING)})
    if not routes or not routes <= set(K1_ROUTES) or shared:
        print(f"# k1_roofline_pct: not read (routes {sorted(routes)}, kernels that share "
              f"K1's names {shared})", file=sys.stderr)
        return None
    seconds = run.trace.seconds(lambda name: any(k in name for k in KERNELS))
    print(f"# k1_roofline_pct: bound {run.state['k1_bound_s']!r} s, K1 {seconds!r} s",
          file=sys.stderr)
    return share_pct(run.state["k1_bound_s"], seconds)
