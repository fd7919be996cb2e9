"""Unit-safe angle newtypes (host-side scalars; port of
``crucible_tpu/utils/angles.py``)."""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Degrees:
    value: float

    def to_radians(self) -> "Radians":
        return Radians(math.radians(self.value))

    def get_angle(self) -> float:
        return self.value


@dataclass(frozen=True)
class Radians:
    value: float

    def to_degrees(self) -> Degrees:
        return Degrees(math.degrees(self.value))

    def get_angle(self) -> float:
        return self.value
