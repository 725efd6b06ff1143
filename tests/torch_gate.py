"""The port's process-global density state, as the reference's is: the
geoslot hysteresis and the speculative frame plans (``plans``: the density
plan, the grid plan, the dense route's overflow, MC and pull plans, packed
and encoded, the keys warmed by ``SPLASHSURF_TPU_PREWARM`` and the mono
frame's graphs) with their ``SPECULATION_STATS``. Port test files share worker
processes, so a port test module that reaches a density gate or the dense
route imports this autouse fixture: each of its tests starts and ends with
no recorded octant collision, no plan and zero counts, whatever test ran
before it in the same worker."""

import pytest

from splashsurf_tpu_torch import neighbors, plans


def clear_port_plans():
    """Forget every speculative plan of the port, the warmed keys and the
    warm frames' graphs, and zero its counts."""
    plans.clear()


@pytest.fixture(autouse=True)
def reset_port_geoslot_hysteresis():
    neighbors.reset_geoslot_hysteresis()
    clear_port_plans()
    yield
    neighbors.reset_geoslot_hysteresis()
    clear_port_plans()
