"""Single Rigid Body Dynamics (the port of srbd_horizon_tpu/models/srbd.py).

    m (r̈ - g) - Σᵢ fᵢ = 0
    I ω̇ + ω × I ω - Σᵢ (cᵢ - r) × fᵢ = 0

with g = (0, 0, -9.81); forces are in kN (force_scaling = 1000) and the
mass and inertia are scaled to match. Every function broadcasts over
leading batch axes; contacts are an (..., nc, 3) axis.
"""

from __future__ import annotations

import torch

from srbd_horizon_tpu_torch.math.quat import (
    cross,
    quat_derivative_world,
    quat_to_rot,
    solve3x3,
)

GRAVITY = 9.81


def _plus_gravity(a: torch.Tensor, sign: float) -> torch.Tensor:
    """a + sign·g with g = (0, 0, -GRAVITY), without building g on the
    device (a host-to-device copy would stall the stream each call)."""
    return torch.cat([a[..., :2], a[..., 2:] - sign * GRAVITY], dim=-1)


def f_srbd(m, inertia_world, forces, r, contacts, w):
    """Forward SRBD: (rddot, wdot) from forces (..., nc, 3), CoM r (..., 3),
    contacts (..., nc, 3), angular velocity w (..., 3) and the world
    inertia (..., 3, 3)."""
    f_tot = torch.sum(forces, dim=-2)
    rddot = _plus_gravity(f_tot / m, 1.0)
    torque = torch.sum(cross(contacts - r[..., None, :], forces), dim=-2)
    Iw = (inertia_world @ w[..., None])[..., 0]
    wdot = solve3x3(inertia_world, torque - cross(w, Iw))
    return rddot, wdot


def srbd_residual(m, inertia_world, forces, r, rddot, contacts, w, wdot):
    """Newton–Euler residual (6,): zero when (rddot, wdot) are consistent
    with the applied forces."""
    lin = m * _plus_gravity(rddot, -1.0) - torch.sum(forces, dim=-2)
    Iw = (inertia_world @ w[..., None])[..., 0]
    ang = (
        (inertia_world @ wdot[..., None])[..., 0]
        + cross(w, Iw)
        - torch.sum(cross(contacts - r[..., None, :], forces), dim=-2)
    )
    return torch.cat([lin, ang], dim=-1)


def world_inertia(inertia_body, o):
    """R(o) I R(o)ᵀ — centroidal inertia rotated to world."""
    R = quat_to_rot(o)
    return R @ inertia_body @ R.transpose(-1, -2)


def split_srbd_state(state, nc):
    """Named view of an SRBD state vector (batched along leading axes):
    [r(3), o(4 xyzw), c(3nc), rdot(3), w(3), cdot(3nc)]."""
    lead = state.shape[:-1]
    return dict(
        r=state[..., 0:3],
        o=state[..., 3:7],
        c=state[..., 7 : 7 + 3 * nc].reshape(*lead, nc, 3),
        rdot=state[..., 7 + 3 * nc : 10 + 3 * nc],
        w=state[..., 10 + 3 * nc : 13 + 3 * nc],
        cdot=state[..., 13 + 3 * nc : 13 + 6 * nc].reshape(*lead, nc, 3),
    )


def split_srbd_input(inputs, nc):
    """[cddot_0(3), f_0(3), ..., cddot_{nc-1}(3), f_{nc-1}(3)]."""
    ui = inputs.reshape(*inputs.shape[:-1], nc, 6)
    return dict(cddot=ui[..., 0:3], f=ui[..., 3:6])


def srbd_xdot(state, inputs, constants):
    """Continuous-time SRBD state derivative: the double integrator with
    fSRBD accelerations in the base rows. `constants` holds 'm_scaled'
    (float) and 'inertia_scaled' ((3,3) tensor). This is the function the
    CUDA rollout kernel fuses."""
    nc = (state.shape[-1] - 13) // 6
    s = split_srbd_state(state, nc)
    i = split_srbd_input(inputs, nc)
    lead = state.shape[:-1]
    I_world = world_inertia(constants["inertia_scaled"], s["o"])
    rddot, wdot = f_srbd(constants["m_scaled"], I_world, i["f"], s["r"],
                         s["c"], s["w"])
    odot = quat_derivative_world(s["o"], s["w"])
    return torch.cat(
        [s["rdot"], odot, s["cdot"].reshape(*lead, 3 * nc), rddot, wdot,
         i["cddot"].reshape(*lead, 3 * nc)],
        dim=-1,
    )
