"""Quadruped constants: the port's own copy of the JAX package's
srbd_horizon_tpu/models/quadruped.py — a point-feet quadruped
(`contact_model=1, number_of_legs=4`) on the same SRBD problem, solver
and MPC loop as the Kangaroo biped, walking a diagonal-pair trot
(`trot_group_mask` with `WalkingPatternGenerator.build(...,
group_mask=)`).

The numbers are those the JAX package records from its vendored stand-in
URDF (32 kg, a 0.60 m × 0.34 m stance rectangle, feet on the world plane,
the CoM over the support polygon's centre); `quadruped_from_urdf`
extracts them from the port's copy of that asset
(`assets/quadruped_like.urdf`).
"""

from __future__ import annotations

import pathlib

import numpy as np

from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants

QUADRUPED_URDF = str(
    pathlib.Path(__file__).resolve().parents[1]
    / "assets" / "quadruped_like.urdf"
)

# nominal configuration: 8 pitch joints (hip/knee × 4 legs) at zero
QUADRUPED_JOINT_INIT = (0.0,) * 8
# the order of the feet fixes the order of the contact variables
QUADRUPED_FOOT_FRAMES = ("lf_foot", "rf_foot", "lh_foot", "rh_foot")
QUADRUPED_WORLD_FRAME = "lf_foot"


def quadruped_point_feet() -> RobotConstants:
    """nc=4 point-feet quadruped (contact_model=1, number_of_legs=4).
    Contact order: 0 lf, 1 rf, 2 lh, 3 rh."""
    return RobotConstants(
        mass=32.0,
        inertia=np.diag([1.192933875, 2.431733875, 2.2092]),
        com=np.array([-0.30, -0.17, 0.4010625]),
        foot_positions=np.array(
            [
                [0.0, 0.0, 0.0],
                [0.0, -0.34, 0.0],
                [-0.60, 0.0, 0.0],
                [-0.60, -0.34, 0.0],
            ]
        ),
        foot_frames=QUADRUPED_FOOT_FRAMES,
    )


def quadruped_from_urdf(urdf_path: str = QUADRUPED_URDF) -> RobotConstants:
    """RobotConstants extracted from the URDF asset at the nominal
    configuration, the lf foot the world frame; `quadruped_point_feet()`
    holds the same numbers, recorded."""
    from srbd_horizon_tpu_torch.models.urdf import load_robot_constants

    return load_robot_constants(
        urdf_path,
        joints=list(QUADRUPED_JOINT_INIT),
        foot_frames=list(QUADRUPED_FOOT_FRAMES),
        world_frame=QUADRUPED_WORLD_FRAME,
    )


def trot_group_mask() -> tuple:
    """Diagonal-pair trot over (lf, rf, lh, rh): lf and rh swing with the
    first half-cycle (the WPG's A-cycle), rf and lh with the second."""
    return (True, False, False, True)
