"""SRBD walking OCP — the port of srbd_horizon_tpu/problems/srbd.py
(`build_srbd_problem`, without the closed-form `stage_jacobians`).

For the Kangaroo line feet (nc=4): nx=37, nu=24, 57 residual rows, 16
equality rows, 15 terminal rows. Every callable broadcasts over leading
batch axes and is traceable by `torch.func`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from srbd_horizon_tpu_torch.config import SRBDConfig, resolve_device
from srbd_horizon_tpu_torch.math.quat import quat_inverse, quat_product
from srbd_horizon_tpu_torch.models import srbd as srbd_model
from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants
from srbd_horizon_tpu_torch.ocp import integrators
from srbd_horizon_tpu_torch.ocp.layout import VarLayout
from srbd_horizon_tpu_torch.ocp.spec import OCP, node_mask


@dataclasses.dataclass(frozen=True)
class SRBDProblem:
    """Built problem and the handles the examples read."""

    ocp: OCP
    initial_state: torch.Tensor
    static_input: torch.Tensor
    com: torch.Tensor
    initial_foot_position: torch.Tensor
    inertia: torch.Tensor
    mass: float
    force_scaling: float
    nc: int
    contact_model: int


def _layouts(nc: int):
    state_entries = [("r", 3), ("o", 4)]
    state_entries += [(f"c{i}", 3) for i in range(nc)]
    state_entries += [("rdot", 3), ("w", 3)]
    state_entries += [(f"cdot{i}", 3) for i in range(nc)]
    input_entries = []
    for i in range(nc):
        input_entries += [(f"cddot{i}", 3), (f"f{i}", 3)]
    return VarLayout(state_entries), VarLayout(input_entries)


def build_srbd_problem(
    cfg: SRBDConfig, robot: RobotConstants, dtype=None,
    integrator: str = "EULER", device="cuda",
) -> SRBDProblem:
    """Build the SRBD OCP on `device` (default "cuda"; raises when CUDA is
    absent unless another device is given)."""
    dev = resolve_device(device)
    if integrator.upper() != "EULER":
        raise NotImplementedError(
            f"integrator={integrator!r}: the DDP path uses EULER only"
        )
    dtype = dtype or cfg.dtype
    ns, nc, cm = cfg.ns, cfg.nc, cfg.contact_model
    n_legs = cfg.number_of_legs
    fs = cfg.force_scaling
    state_layout, input_layout = _layouts(nc)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    com = t(robot.com)
    feet0 = t(robot.foot_positions)
    inertia = t(robot.inertia)
    m = float(robot.mass)
    constants = dict(
        m_scaled=m / fs,
        inertia_scaled=inertia / fs,
        com=com,
        feet0=feet0,
        m=m,
        inertia=inertia,
        force_scaling=fs,
    )

    d1 = feet0[cm, :2] - feet0[0, :2]
    d2 = feet0[nc - 1, :2] - feet0[cm - 1, :2]
    com_z = com[2]

    sq = lambda g: float(np.sqrt(g))
    w_r = sq(cfg.r_tracking_gain)
    w_rdot = sq(cfg.rdot_tracking_gain)
    w_w = sq(cfg.w_tracking_gain)
    w_rel = sq(cfg.rel_position_gain)
    w_qddot = sq(cfg.min_qddot_gain)
    w_minf = fs * sq(cfg.min_f_gain)
    w_fswitch = fs * sq(cfg.force_switch_weight)

    def split(x, u):
        return (
            srbd_model.split_srbd_state(x, nc),
            srbd_model.split_srbd_input(u, nc),
        )

    def _accels(s, i):
        I_world = srbd_model.world_inertia(constants["inertia_scaled"], s["o"])
        return srbd_model.f_srbd(
            constants["m_scaled"], I_world, i["f"], s["r"], s["c"], s["w"]
        )

    def _rel_rows(c, w):
        return [
            w * (-c[..., 0, 1] + c[..., cm, 1] - d1[1])[..., None],
            w * (-c[..., 0, 0] + c[..., cm, 0] - d1[0])[..., None],
            w * (-c[..., cm - 1, 1] + c[..., nc - 1, 1] - d2[1])[..., None],
            w * (-c[..., cm - 1, 0] + c[..., nc - 1, 0] - d2[0])[..., None],
        ]

    def stage_residual(x, u, p):
        s, i = split(x, u)
        lead = x.shape[:-1]
        mt = p["mask_track"][..., 0:1]
        otg = p["orientation_tracking_gain"][..., 0:1]
        qerr = quat_product(s["o"], p["oref"])
        rddot, wdot = _accels(s, i)
        qddot = torch.cat([rddot, wdot, i["cddot"].reshape(*lead, 3 * nc)], dim=-1)
        res = [
            mt * w_r * (s["r"][..., 2:3] - com_z),
            mt * otg * qerr[..., :3],
            mt * otg * (qerr[..., 3:4] - 1.0),
            mt * w_rdot * (s["rdot"] - p["rdot_ref"]),
            mt * w_w * (s["w"] - p["w_ref"]),
            *_rel_rows(s["c"], mt * w_rel),
            w_qddot * qddot,
            (w_minf * i["f"]).reshape(*lead, 3 * nc),
            (w_fswitch * (1.0 - p["cdot_switch"])[..., :, None] * i["f"]).reshape(
                *lead, 3 * nc
            ),
        ]
        return torch.cat(res, dim=-1)

    def terminal_residual(x, p):
        s = srbd_model.split_srbd_state(x, nc)
        otg = p["orientation_tracking_gain"][..., 0:1]
        qerr = quat_product(s["o"], p["oref"])
        res = [
            w_r * (s["r"][..., 2:3] - com_z),
            otg * qerr[..., :3],
            otg * (qerr[..., 3:4] - 1.0),
            w_rdot * (s["rdot"] - p["rdot_ref"]),
            w_w * (s["w"] - p["w_ref"]),
            *_rel_rows(s["c"], w_rel),
        ]
        return torch.cat(res, dim=-1)

    def stage_eq(x, u, p):
        """relative_vel, cz_tracking, cdotxy_tracking — state-only."""
        del u
        s = srbd_model.split_srbd_state(x, nc)
        lead = x.shape[:-1]
        res = []
        for leg in range(n_legs):
            base = leg * cm
            for i in range(1, cm):
                res.append(s["cdot"][..., base, :2] - s["cdot"][..., base + i, :2])
        res.append(s["c"][..., :, 2] - p["c_ref"])
        res.append(
            (p["cdot_switch"][..., :, None] * s["cdot"][..., :, :2]).reshape(
                *lead, 2 * nc
            )
        )
        return torch.cat(res, dim=-1)

    def terminal_eq(x, p):
        return stage_eq(x, None, p)

    xdot = lambda x, u, p: srbd_model.srbd_xdot(x, u, constants)
    step = integrators.euler(xdot)

    i_rdot = 7 + 3 * nc
    i_w = 10 + 3 * nc
    nx_ = 13 + 6 * nc

    unit_quat = t([0.0, 0.0, 0.0, 1.0])
    params: Dict[str, torch.Tensor] = {
        "rdot_ref": torch.zeros((ns + 1, 3), dtype=dtype, device=dev),
        "w_ref": torch.zeros((ns + 1, 3), dtype=dtype, device=dev),
        "orientation_tracking_gain": torch.full(
            (ns + 1, 1), 1e1, dtype=dtype, device=dev
        ),
        "oref": quat_inverse(unit_quat).expand(ns + 1, 4).clone(),
        "c_ref": feet0[:, 2].expand(ns + 1, nc).clone(),
        "cdot_switch": torch.ones((ns + 1, nc), dtype=dtype, device=dev),
        "mask_track": node_mask(ns, 1, ns + 1, dtype, dev)[:, None],
    }

    ocp = OCP(
        ns=ns,
        dt=cfg.dt,
        state_layout=state_layout,
        input_layout=input_layout,
        step=step,
        xdot=xdot,
        stage_residual=stage_residual,
        terminal_residual=terminal_residual,
        stage_eq=stage_eq,
        terminal_eq=terminal_eq,
        # stacked rows [residual(21+9nc); eq(2·legs·(cm−1)+3nc)]:
        #   x-rows: rz/o/rdot/w/rel (0:15), wdot (18:21), all eq rows
        #   u-rows: rddot/wdot/cddot/min_f/fswitch (15:21+9nc)
        residual_x_rows=tuple(
            list(range(15)) + [18, 19, 20]
            + list(range(21 + 9 * nc,
                         21 + 9 * nc + 2 * n_legs * (cm - 1) + 3 * nc))
        ),
        residual_u_rows=tuple(range(15, 21 + 9 * nc)),
        # Euler A−I live rows: r, o, c (integrated velocities) and w;
        # B live rows: rdot, w, cdot
        dynamics_x_rows=tuple(list(range(0, i_rdot)) + list(range(i_w, i_w + 3))),
        dynamics_u_rows=tuple(range(i_rdot, nx_)),
        params=params,
        constants=constants,
    )

    x0 = torch.cat(
        [com, unit_quat, feet0.reshape(-1),
         torch.zeros(6 + 3 * nc, dtype=dtype, device=dev)]
    )
    per_contact = t([0.0, 0.0, 0.0, 0.0, 0.0, m * 9.81 / fs / nc])
    u0 = per_contact.repeat(nc)

    return SRBDProblem(
        ocp=ocp,
        initial_state=x0,
        static_input=u0,
        com=com,
        initial_foot_position=feet0,
        inertia=inertia,
        mass=m,
        force_scaling=fs,
        nc=nc,
        contact_model=cm,
    )
