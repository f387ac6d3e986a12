"""SRBD walking OCP — the port of srbd_horizon_tpu/problems/srbd.py
(`build_srbd_problem`). Its closed-form `stage_jacobians` is the
linearization kernel K4 (`kernels/linearize.py`).

For the Kangaroo line feet (nc=4): nx=37, nu=24, 57 residual rows, 16
equality rows, 15 terminal rows; for the point-feet biped (nc=2,
`models/kangaroo.py::point_feet`): nx=25, nu=12, 39 and 6. Every callable
broadcasts over leading batch axes. The residual stacks are methods of
`SRBDTerms`, which also carries the constants the kernels K3 and K4 read
and the name of the step (`integrator=`: "EULER", "RK2" or "RK4", as the
JAX package's `build_srbd_problem` takes them), which picks the kernels'
step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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


@dataclasses.dataclass(frozen=True)
class SRBDTerms:
    """The SRBD stage, equality and terminal residuals and the constants
    they read (the residual weights are √gain, as in the reference). The
    OCP's residual callables are these methods; the CUDA kernels K3 and K4
    evaluate the same rows from `kernel_scalars`."""

    family = "srbd"      # the kernels solvers/msddp.py takes for this problem

    nc: int
    contact_model: int
    number_of_legs: int
    m_scaled: float
    inertia_scaled: torch.Tensor     # (3, 3)
    w_r: float
    w_rdot: float
    w_w: float
    w_rel: float
    w_qddot: float
    w_minf: float
    w_fswitch: float
    com_z: float
    d1: Tuple[float, float]
    d2: Tuple[float, float]
    step: str = "EULER"              # the OCP's integrator (ocp/integrators.py)
    _cache: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def n_rho(self) -> int:
        """Rows of the stacked stage residual [residual; eq]."""
        cm = self.contact_model
        return 21 + 9 * self.nc + 2 * self.number_of_legs * (cm - 1) + 3 * self.nc

    def _accels(self, s, i):
        I_world = srbd_model.world_inertia(self.inertia_scaled, s["o"])
        return srbd_model.f_srbd(self.m_scaled, I_world, i["f"], s["r"],
                                 s["c"], s["w"])

    def _rel_rows(self, c, w):
        cm, nc, d1, d2 = self.contact_model, self.nc, self.d1, self.d2
        return [
            w * (-c[..., 0, 1] + c[..., cm, 1] - d1[1])[..., None],
            w * (-c[..., 0, 0] + c[..., cm, 0] - d1[0])[..., None],
            w * (-c[..., cm - 1, 1] + c[..., nc - 1, 1] - d2[1])[..., None],
            w * (-c[..., cm - 1, 0] + c[..., nc - 1, 0] - d2[0])[..., None],
        ]

    def stage_residual(self, x, u, p):
        nc = self.nc
        s = srbd_model.split_srbd_state(x, nc)
        i = srbd_model.split_srbd_input(u, nc)
        lead = x.shape[:-1]
        mt = p["mask_track"][..., 0:1]
        otg = p["orientation_tracking_gain"][..., 0:1]
        qerr = quat_product(s["o"], p["oref"])
        rddot, wdot = self._accels(s, i)
        qddot = torch.cat([rddot, wdot, i["cddot"].reshape(*lead, 3 * nc)], dim=-1)
        res = [
            mt * self.w_r * (s["r"][..., 2:3] - self.com_z),
            mt * otg * qerr[..., :3],
            mt * otg * (qerr[..., 3:4] - 1.0),
            mt * self.w_rdot * (s["rdot"] - p["rdot_ref"]),
            mt * self.w_w * (s["w"] - p["w_ref"]),
            *self._rel_rows(s["c"], mt * self.w_rel),
            self.w_qddot * qddot,
            (self.w_minf * i["f"]).reshape(*lead, 3 * nc),
            (self.w_fswitch * (1.0 - p["cdot_switch"])[..., :, None]
             * i["f"]).reshape(*lead, 3 * nc),
        ]
        return torch.cat(res, dim=-1)

    def terminal_residual(self, x, p):
        s = srbd_model.split_srbd_state(x, self.nc)
        otg = p["orientation_tracking_gain"][..., 0:1]
        qerr = quat_product(s["o"], p["oref"])
        res = [
            self.w_r * (s["r"][..., 2:3] - self.com_z),
            otg * qerr[..., :3],
            otg * (qerr[..., 3:4] - 1.0),
            self.w_rdot * (s["rdot"] - p["rdot_ref"]),
            self.w_w * (s["w"] - p["w_ref"]),
            *self._rel_rows(s["c"], self.w_rel),
        ]
        return torch.cat(res, dim=-1)

    def stage_eq(self, x, u, p):
        """relative_vel, cz_tracking, cdotxy_tracking — state-only."""
        del u
        nc, cm = self.nc, self.contact_model
        s = srbd_model.split_srbd_state(x, nc)
        lead = x.shape[:-1]
        res = []
        for leg in range(self.number_of_legs):
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

    def terminal_eq(self, x, p):
        return self.stage_eq(x, None, p)

    def family_args(self, wc: float) -> Tuple[float, ...]:
        """What this family's cost functions and kernels take besides the
        common arguments: √w_c, the root of the penalty on the equality
        stack."""
        return (wc,)

    def stage_rho(self, x, u, p, wc: float):
        """Stacked stage residual [residual; √w_c · eq] (wc = √w_c)."""
        return torch.cat([self.stage_residual(x, u, p),
                          wc * self.stage_eq(x, u, p)], dim=-1)

    def total_cost(self, X, U, params, wc: float):
        """Σ_n ‖ρ_n‖² + ‖ρ_N‖² over leading batch axes of X (…, ns+1, nx);
        params leaves are (…, ns+1, dim)."""
        ns = U.shape[-2]
        p_stage = {k: v[..., :ns, :] for k, v in params.items()}
        rho = self.stage_rho(X[..., :ns, :], U, p_stage, wc)
        rt = self.terminal_residual(X[..., ns, :],
                                    {k: v[..., ns, :] for k, v in params.items()})
        return torch.sum(rho * rho, dim=(-1, -2)) + torch.sum(rt * rt, dim=-1)

    def kernel_scalars(self, dt: float, wc: float) -> Tuple[float, ...]:
        """The 24 host scalars of csrc/srbd_common.cuh (`srbd::Consts`):
        dt, m_scaled, the scaled inertia, the weights, √w_c, com_z, d1, d2."""
        key = (float(dt), float(wc))
        if key not in self._cache:
            inertia = [float(v) for v in self.inertia_scaled.reshape(-1).tolist()]
            self._cache[key] = (
                float(dt), float(self.m_scaled), *inertia,
                self.w_r, self.w_rdot, self.w_w, self.w_rel, self.w_qddot,
                self.w_minf, self.w_fswitch, float(wc), self.com_z,
                self.d1[0], self.d1[1], self.d2[0], self.d2[1],
            )
        return self._cache[key]


def linearized_friction_cone_rows(mu: float) -> np.ndarray:
    """Row matrix A with A f ≤ 0 inside the linearized cone (5 faces: the
    ±x, ±y pyramid and unilaterality)."""
    mu_lin = mu / np.sqrt(2.0)
    return np.array(
        [
            [1.0, 0.0, -mu_lin],
            [-1.0, 0.0, -mu_lin],
            [0.0, 1.0, -mu_lin],
            [0.0, -1.0, -mu_lin],
            [0.0, 0.0, -1.0],
        ]
    )


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
    absent unless another device is given), its step `integrator`: "EULER"
    (the reference's DDP path), "RK2" or "RK4"."""
    dev = resolve_device(device)
    step_name = integrator.upper()
    if step_name not in integrators.BY_NAME:
        raise ValueError(f"integrator={integrator!r}: one of "
                         f"{tuple(integrators.BY_NAME)}")
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
    inertia_scaled = inertia / fs
    d1 = feet0[cm, :2] - feet0[0, :2]
    d2 = feet0[nc - 1, :2] - feet0[cm - 1, :2]
    sq = lambda g: float(np.sqrt(g))
    terms = SRBDTerms(
        nc=nc, contact_model=cm, number_of_legs=n_legs,
        m_scaled=m / fs, inertia_scaled=inertia_scaled,
        w_r=sq(cfg.r_tracking_gain),
        w_rdot=sq(cfg.rdot_tracking_gain),
        w_w=sq(cfg.w_tracking_gain),
        w_rel=sq(cfg.rel_position_gain),
        w_qddot=sq(cfg.min_qddot_gain),
        w_minf=fs * sq(cfg.min_f_gain),
        w_fswitch=fs * sq(cfg.force_switch_weight),
        com_z=float(com[2]),
        d1=(float(d1[0]), float(d1[1])),
        d2=(float(d2[0]), float(d2[1])),
        step=step_name,
    )
    constants = dict(
        m_scaled=m / fs,
        inertia_scaled=inertia_scaled,
        com=com,
        feet0=feet0,
        m=m,
        inertia=inertia,
        force_scaling=fs,
        terms=terms,
    )

    xdot = lambda x, u, p: srbd_model.srbd_xdot(x, u, constants)
    step = integrators.BY_NAME[step_name](xdot)

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
        stage_residual=terms.stage_residual,
        terminal_residual=terms.terminal_residual,
        stage_eq=terms.stage_eq,
        terminal_eq=terms.terminal_eq,
        # stacked rows [residual(21+9nc); eq(2·legs·(cm−1)+3nc)]:
        #   x-rows: rz/o/rdot/w/rel (0:15), wdot (18:21), all eq rows
        #   u-rows: rddot/wdot/cddot/min_f/fswitch (15:21+9nc)
        residual_x_rows=tuple(
            list(range(15)) + [18, 19, 20]
            + list(range(21 + 9 * nc,
                         21 + 9 * nc + 2 * n_legs * (cm - 1) + 3 * nc))
        ),
        residual_u_rows=tuple(range(15, 21 + 9 * nc)),
        # A−I live rows: r, o, c (integrated velocities) and w, under
        # every step (ṙ and ċ depend on u alone, so the RK stages feed no
        # x into those rows); B live rows: rdot, w, cdot under Euler, every
        # row under RK2 and RK4, whose later stages carry u into r, o and c
        # through ∂ẋ/∂x
        dynamics_x_rows=tuple(list(range(0, i_rdot)) + list(range(i_w, i_w + 3))),
        dynamics_u_rows=(tuple(range(i_rdot, nx_)) if step_name == "EULER"
                         else tuple(range(nx_))),
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
