"""The line-feet quadruped for the port's tests, in torch and with no JAX:
the JAX package's `tests/test_configs.py::TestLineFeetQuadruped` robot
(contact_model=2 on four legs: two contact points a foot, nc=8), the same
numbers built from the port's `quadruped_point_feet()` as the port's
`RobotConstants`, and the 8-entry trot mask. `_torch_parity` pairs the
robot with the JAX one; the layout and shape tests, which import no JAX,
take it from here."""

import dataclasses

import numpy as np

from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants
from srbd_horizon_tpu_torch.models.quadruped import (quadruped_point_feet,
                                                     trot_group_mask)

# SRBDConfig fields of the topology
LINE_FEET_TOPOLOGY = dict(contact_model=2, number_of_legs=4)
# the two contacts of a foot lie this far either side of the point foot,
# along x
HALF_LENGTH = 0.05


def line_feet_quadruped() -> RobotConstants:
    """The point-feet quadruped with each foot's point replaced by two, at
    ±HALF_LENGTH along x (c0 and c1 lf's front and back, c2 and c3 rf's,
    c4 and c5 lh's, c6 and c7 rh's); mass, inertia and CoM unchanged."""
    q = quadruped_point_feet()
    pts = []
    for p in np.asarray(q.foot_positions):
        pts.append(p + np.array([HALF_LENGTH, 0.0, 0.0]))
        pts.append(p - np.array([HALF_LENGTH, 0.0, 0.0]))
    return dataclasses.replace(q, foot_positions=np.asarray(pts),
                               foot_frames=tuple(f"c{i}" for i in range(8)))


def line_feet_trot_mask() -> tuple:
    """The diagonal-pair trot over the eight contacts: each foot's two
    points take their leg's entry of `trot_group_mask()` (lf and rh swing
    with the first half-cycle): (T, T, F, F, F, F, T, T)."""
    return tuple(g for g in trot_group_mask() for _ in range(2))
