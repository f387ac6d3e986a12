"""Kangaroo biped constants: the port's own copy of `RobotConstants`,
`kangaroo_line_feet`, `kangaroo_from_urdf` and `point_feet`
(srbd_horizon_tpu/models/kangaroo.py). The numbers are those the JAX
package records from its vendored stand-in URDF (40 kg, line feet, CoM
0.88 m above the left sole); `kangaroo_from_urdf` extracts them from the
port's copy of that asset (`assets/kangaroo_like.urdf`)."""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

KANGAROO_URDF = str(
    pathlib.Path(__file__).resolve().parents[1] / "assets" / "kangaroo_like.urdf"
)
# the stand-in's nominal configuration: 6 pitch joints (hip/knee/ankle × 2)
# at zero
KANGAROO_JOINT_INIT = (0.0,) * 6
KANGAROO_FOOT_FRAMES = (
    "left_foot_upper",
    "left_foot_lower",
    "right_foot_upper",
    "right_foot_lower",
)
KANGAROO_WORLD_FRAME = "left_sole_link"


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


def kangaroo_from_urdf(urdf_path: str = KANGAROO_URDF) -> RobotConstants:
    """RobotConstants extracted from the URDF asset at the nominal
    configuration, the left sole the world frame; `kangaroo_line_feet()`
    holds the same numbers, recorded."""
    from srbd_horizon_tpu_torch.models.urdf import load_robot_constants

    return load_robot_constants(
        urdf_path,
        joints=list(KANGAROO_JOINT_INIT),
        foot_frames=list(KANGAROO_FOOT_FRAMES),
        world_frame=KANGAROO_WORLD_FRAME,
    )


def point_feet(number_of_legs: int = 2) -> RobotConstants:
    """contact_model=1: one contact a foot, the feet 0.18 m apart along −y,
    the Kangaroo's mass and inertia, the CoM 0.88 m over the feet's
    centre. With two legs, the point-feet biped
    (`SRBDConfig(contact_model=1, number_of_legs=2)`: nc=2, nx=25, nu=12)."""
    stance_width = 0.18
    feet = []
    frames = []
    for leg in range(number_of_legs):
        y = -stance_width * leg
        feet.append([0.0, y, 0.0])
        frames.append(f"sole_{leg}")
    feet_arr = np.asarray(feet, dtype=np.float64)
    return RobotConstants(
        mass=40.0,
        inertia=np.diag([2.11556, 1.82968, 0.62288]),
        com=np.array([0.0, feet_arr[:, 1].mean(), 0.88]),
        foot_positions=feet_arr,
        foot_frames=tuple(frames),
    )
