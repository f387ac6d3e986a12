"""Linear Inverted Pendulum model (the port of
srbd_horizon_tpu/models/lip.py).

    η² = g / h,    r̈ = η² (r − z) − (0, 0, g)

with z the ZMP; as in the reference, the η² term acts on all three axes.
`lip_dynamics_residual` is the constraint the hybrid isrbd problem puts on
its late nodes: the CoM accelerates like a LIP whose pivot is the contact
centroid on the ground plane. Every function broadcasts over leading
batch axes.
"""

from __future__ import annotations

import torch

GRAVITY = 9.81
LIP_HEIGHT = 0.88
ETA2 = GRAVITY / LIP_HEIGHT


def lip_rddot(r, z, eta2=ETA2):
    """CoM acceleration of the LIP."""
    a = eta2 * (r - z)
    return torch.cat([a[..., :2], a[..., 2:] - GRAVITY], dim=-1)


def split_lip_state(state, nc):
    """[r(3), c_0..c_{nc-1}(3 each), rdot(3), cdot_0..cdot_{nc-1}(3)]."""
    lead = state.shape[:-1]
    return dict(
        r=state[..., 0:3],
        c=state[..., 3 : 3 + 3 * nc].reshape(*lead, nc, 3),
        rdot=state[..., 3 + 3 * nc : 6 + 3 * nc],
        cdot=state[..., 6 + 3 * nc : 6 + 6 * nc].reshape(*lead, nc, 3),
    )


def split_lip_input(inputs, nc):
    """[z(3), cddot_0(3), ..., cddot_{nc-1}(3)]."""
    lead = inputs.shape[:-1]
    return dict(
        z=inputs[..., 0:3],
        cddot=inputs[..., 3 : 3 + 3 * nc].reshape(*lead, nc, 3),
    )


def lip_xdot(state, inputs, constants=None, eta2=ETA2):
    """Continuous-time LIP state derivative: the double integrator over
    [r, c] with the LIP acceleration in the CoM rows."""
    del constants
    nc = (state.shape[-1] - 6) // 6
    s = split_lip_state(state, nc)
    i = split_lip_input(inputs, nc)
    lead = state.shape[:-1]
    rddot = lip_rddot(s["r"], i["z"], eta2)
    return torch.cat(
        [s["rdot"], s["cdot"].reshape(*lead, 3 * nc), rddot,
         i["cddot"].reshape(*lead, 3 * nc)], dim=-1)


def lip_dynamics_residual(m, forces, r, rddot, contacts, eta2=ETA2):
    """m (r̈ − [η² (r − zmp) − g]) with zmp = [mean(contacts)_xy, 0]: the
    pivot's xy is the contact centroid and its z the ground plane, so a
    constant CoM height is consistent with the z row through swing.
    `forces` is kept for the signature only (the Newton equation on the
    earlier nodes covers them)."""
    del forces
    zmp_xy = torch.mean(contacts[..., :, :2], dim=-2)
    zmp = torch.cat([zmp_xy, torch.zeros_like(zmp_xy[..., :1])], dim=-1)
    return m * (rddot - lip_rddot(r, zmp, eta2))
