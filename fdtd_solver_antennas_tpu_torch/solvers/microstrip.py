"""Microstrip feed helpers.

The part of ``fdtd_solver_antennas_tpu/solvers/microstrip.py`` that the
multi-antenna solver needs: the feed direction and the Wheeler width
synthesis. The microstrip-fed patch solver itself needs MSL ports, which
the port does not have yet.
"""

from __future__ import annotations

import math
from enum import Enum


class FeedDirection(str, Enum):
    """Microstrip feed direction."""

    POS_X = "+X"
    NEG_X = "-X"
    POS_Y = "+Y"
    NEG_Y = "-Y"


def calculate_microstrip_width(
    freq_hz: float, eps_r: float, h_m: float, z0: float = 50.0
) -> float:
    """Microstrip width for a target Z0 via Wheeler's synthesis equations."""
    if z0 < 44.0:
        A = (z0 / 60.0) * math.sqrt((eps_r + 1.0) / 2.0) + (
            (eps_r - 1.0) / (eps_r + 1.0)
        ) * (0.23 + 0.11 / eps_r)
        w_h = 8.0 * math.exp(A) / (math.exp(2.0 * A) - 2.0)
    else:
        B = 377.0 * math.pi / (2.0 * z0 * math.sqrt(eps_r))
        w_h = (2.0 / math.pi) * (
            B
            - 1.0
            - math.log(2.0 * B - 1.0)
            + ((eps_r - 1.0) / (2.0 * eps_r))
            * (math.log(B - 1.0) + 0.39 - 0.61 / eps_r)
        )
    return w_h * h_m
