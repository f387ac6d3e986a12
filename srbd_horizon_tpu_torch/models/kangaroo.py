"""Kangaroo biped constants: the port's own copy of `RobotConstants` and
`kangaroo_line_feet` (srbd_horizon_tpu/models/kangaroo.py). The numbers
are those the JAX package records from its vendored stand-in URDF
(40 kg, line feet, CoM 0.88 m above the left sole)."""

from __future__ import annotations

import dataclasses

import numpy as np

KANGAROO_FOOT_FRAMES = (
    "left_foot_upper",
    "left_foot_lower",
    "right_foot_upper",
    "right_foot_lower",
)


@dataclasses.dataclass(frozen=True)
class RobotConstants:
    """Reduced-model constants the problem construction reads."""

    mass: float
    inertia: np.ndarray            # (3,3) centroidal rotational inertia [kg m^2]
    com: np.ndarray                # (3,) nominal CoM in world frame [m]
    foot_positions: np.ndarray     # (nc, 3) nominal contact positions [m]
    foot_frames: tuple

    @property
    def nc(self) -> int:
        return self.foot_positions.shape[0]


def kangaroo_line_feet() -> RobotConstants:
    """nc=4 line-feet configuration. Contact order:
    0 left_foot_upper, 1 left_foot_lower, 2 right_foot_upper,
    3 right_foot_lower."""
    half_foot = 0.08       # fore/aft half-length of the line foot [m]
    stance_width = 0.18    # lateral distance between sole centers [m]
    return RobotConstants(
        mass=40.0,
        inertia=np.diag([2.11556, 1.82968, 0.62288]),
        com=np.array([0.0, -stance_width / 2.0, 0.88]),
        foot_positions=np.array(
            [
                [half_foot, 0.0, 0.0],
                [-half_foot, 0.0, 0.0],
                [half_foot, -stance_width, 0.0],
                [-half_foot, -stance_width, 0.0],
            ]
        ),
        foot_frames=KANGAROO_FOOT_FRAMES,
    )
