"""The square-feet biped for the port's tests, in torch and with no JAX:
the JAX package's `tests/test_configs.py::_four_contact_feet()` robot
(contact_model=4: four contact points a foot, nc=8), the same numbers
built as the port's `RobotConstants`. `_torch_parity` pairs it with the
JAX robot; the layout and shape tests, which import no JAX, take it from
here."""

import numpy as np

from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants

# SRBDConfig fields of the topology
SQUARE_TOPOLOGY = dict(contact_model=4, number_of_legs=2)


def square_feet() -> RobotConstants:
    """Four points a foot at (±0.08, ±0.03) about each leg's y (0, −0.18);
    mass 40 kg, inertia diag(2.1, 1.8, 0.62), CoM (0, −0.09, 0.88)."""
    pts = []
    for leg_y in (0.0, -0.18):
        for dx, dy in ((0.08, 0.03), (0.08, -0.03), (-0.08, 0.03),
                       (-0.08, -0.03)):
            pts.append([dx, leg_y + dy, 0.0])
    return RobotConstants(
        mass=40.0,
        inertia=np.diag([2.1, 1.8, 0.62]),
        com=np.array([0.0, -0.09, 0.88]),
        foot_positions=np.asarray(pts),
        foot_frames=tuple(f"c{i}" for i in range(8)),
    )
