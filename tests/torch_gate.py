"""The port's geoslot hysteresis is process-global, as the reference's is,
and port test files share worker processes. A port test module that reaches
a density gate imports this autouse fixture, so that each of its tests
starts and ends with the port's count of consecutive octant collisions at
0, whatever test ran before it in the same worker."""

import pytest

from splashsurf_tpu_torch import neighbors


@pytest.fixture(autouse=True)
def reset_port_geoslot_hysteresis():
    neighbors.reset_geoslot_hysteresis()
    yield
    neighbors.reset_geoslot_hysteresis()
