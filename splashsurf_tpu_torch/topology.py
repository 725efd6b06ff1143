"""Axis/direction topology helpers (the port's copy of
``splashsurf_tpu.topology``; splashsurf_lib/src/topology.rs:8-401 parity):
tiny host value types for grid-neighbourhood arithmetic, numpy only."""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np


class Axis(enum.IntEnum):
    X = 0
    Y = 1
    Z = 2

    def orthogonal_axes(self) -> Tuple["Axis", "Axis"]:
        return tuple(Axis(d) for d in range(3) if d != self)  # type: ignore


class Direction(enum.IntEnum):
    NEGATIVE = 0
    POSITIVE = 1

    @property
    def sign(self) -> int:
        return 1 if self == Direction.POSITIVE else -1

    def opposite(self) -> "Direction":
        return Direction(1 - self)


@dataclasses.dataclass(frozen=True)
class DirectedAxis:
    """An axis with a direction: one of the 6 face neighbors."""

    axis: Axis
    direction: Direction

    @property
    def offset(self) -> np.ndarray:
        o = np.zeros(3, dtype=np.int64)
        o[self.axis] = self.direction.sign
        return o

    def opposite(self) -> "DirectedAxis":
        return DirectedAxis(self.axis, self.direction.opposite())

    @staticmethod
    def all() -> Tuple["DirectedAxis", ...]:
        return tuple(
            DirectedAxis(Axis(a), Direction(d)) for a in range(3) for d in (0, 1)
        )


def checked_apply_step(ijk, directed_axis: DirectedAxis, dims) -> np.ndarray | None:
    """Step a grid index along a directed axis; None if it leaves [0, dims)."""
    out = np.asarray(ijk, dtype=np.int64) + directed_axis.offset
    if np.all((out >= 0) & (out < np.asarray(dims))):
        return out
    return None
