"""ISRBD full-NLP walking OCP — the port of
srbd_horizon_tpu/problems/isrbd.py (`build_isrbd_problem`).

Differences from the SRBD-DDP problem (problems/srbd.py):
  - accelerations are inputs (u = [rddot, wdot, (cddot_i, f_i)…]) and the
    dynamics is a pure double integrator with a floating base, stepped by
    RK2; physics enters as equality constraints: the SRBD Newton–Euler
    rows on the early nodes, the LIP rows on the late nodes, and the
    LIP-zone rows (fixed CoM height, zero angular velocity);
  - friction cones are active inequality rows, forces and contact
    velocities are boxed;
  - forces are raw newtons and m, I enter unscaled;
  - the hybrid model schedule is 0/1 parameter masks over the nodes
    (mask_srbd / mask_lip / mask_lipzone).

For the Kangaroo line feet (nc=4): nx=37, nu=30, 45 residual rows, 21
equality rows, 20 cone rows, 15 terminal residual rows and 12 terminal
equality rows. Every callable broadcasts over leading batch axes. The
stacks are methods of `ISRBDTerms`, which also carries the constants the
kernels K5 and K6 read (through the AL solver's inner terms,
solvers/alddp.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from srbd_horizon_tpu_torch.config import SRBDConfig, resolve_device
from srbd_horizon_tpu_torch.math.quat import quat_derivative_world
from srbd_horizon_tpu_torch.models import lip as lip_model
from srbd_horizon_tpu_torch.models import srbd as srbd_model
from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants
from srbd_horizon_tpu_torch.ocp import integrators
from srbd_horizon_tpu_torch.ocp.layout import VarLayout
from srbd_horizon_tpu_torch.ocp.spec import OCP, node_mask, unbounded
from srbd_horizon_tpu_torch.problems.srbd import linearized_friction_cone_rows


@dataclasses.dataclass(frozen=True)
class ISRBDProblem:
    ocp: OCP
    initial_state: torch.Tensor
    static_input: torch.Tensor
    com: torch.Tensor
    initial_foot_position: torch.Tensor
    inertia: torch.Tensor
    mass: float
    nc: int
    contact_model: int


def _layouts(nc: int):
    state_entries = [("r", 3), ("o", 4)]
    state_entries += [(f"c{i}", 3) for i in range(nc)]
    state_entries += [("rdot", 3), ("w", 3)]
    state_entries += [(f"cdot{i}", 3) for i in range(nc)]
    # input order: rddot, wdot, then (cddot_i, f_i) per contact
    input_entries = [("rddot", 3), ("wdot", 3)]
    for i in range(nc):
        input_entries += [(f"cddot{i}", 3), (f"f{i}", 3)]
    return VarLayout(state_entries), VarLayout(input_entries)


@dataclasses.dataclass(frozen=True)
class ISRBDTerms:
    """The isrbd residual, equality and inequality stacks, the double
    integrator, and the constants they read (residual weights are √gain).
    The OCP's callables are these methods; the CUDA kernels K5 and K6
    evaluate the same rows from `kernel_scalars`."""

    nc: int
    contact_model: int
    number_of_legs: int
    m: float
    inertia: torch.Tensor            # (3, 3), body frame, unscaled
    eta2: float
    w_rz: float
    w_rdot: float
    w_w: float
    w_rel: float
    w_qddot: float
    w_minf: float
    com_z: float
    d1: Tuple[float, float]
    d2: Tuple[float, float]
    fpi: Tuple[int, int, int, int]   # foot-pair contact indices
    A_fc: torch.Tensor               # (5, 3) friction-cone faces
    _cache: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def n_relvel(self) -> int:
        return self.number_of_legs * (self.contact_model - 1) * 2

    @property
    def n_res(self) -> int:
        return 21 + 6 * self.nc

    @property
    def n_eq(self) -> int:
        return self.n_relvel + self.nc + 13

    @property
    def n_eq_T(self) -> int:
        return self.n_relvel + self.nc + 4

    def split(self, x, u):
        nc = self.nc
        s = srbd_model.split_srbd_state(x, nc)
        rest = u[..., 6:].reshape(*u.shape[:-1], nc, 6)
        i = dict(rddot=u[..., 0:3], wdot=u[..., 3:6],
                 cddot=rest[..., 0:3], f=rest[..., 3:6])
        return s, i

    def _rel_rows(self, c):
        f0, f1, f2, f3 = self.fpi
        w, d1, d2 = self.w_rel, self.d1, self.d2
        return [
            w * (-c[..., f0, 1] + c[..., f2, 1] - d1[1])[..., None],
            w * (-c[..., f0, 0] + c[..., f2, 0] - d1[0])[..., None],
            w * (-c[..., f1, 1] + c[..., f3, 1] - d2[1])[..., None],
            w * (-c[..., f1, 0] + c[..., f3, 0] - d2[0])[..., None],
        ]

    @staticmethod
    def _o_err(o):
        """o − (0, 0, 0, 1)."""
        return torch.cat([o[..., :3], o[..., 3:] - 1.0], dim=-1)

    def stage_residual(self, x, u, p):
        s, i = self.split(x, u)
        lead = x.shape[:-1]
        mt = p["mask_track"][..., 0:1]
        Wo = p["Wo"][..., 0:1]
        qddot = torch.cat([i["rddot"], i["wdot"],
                           i["cddot"].reshape(*lead, 3 * self.nc)], dim=-1)
        res = [
            mt * self.w_rz * (s["r"][..., 2:3] - self.com_z),
            mt * Wo * self._o_err(s["o"]),
            mt * self.w_rdot * (s["rdot"] - p["rdot_ref"]),
            mt * self.w_w * (s["w"] - p["w_ref"]),
            self.w_qddot * qddot,
            *self._rel_rows(s["c"]),
            (self.w_minf * i["f"]).reshape(*lead, 3 * self.nc),
        ]
        return torch.cat(res, dim=-1)

    def terminal_residual(self, x, p):
        s = srbd_model.split_srbd_state(x, self.nc)
        Wo = p["Wo"][..., 0:1]
        res = [
            self.w_rz * (s["r"][..., 2:3] - self.com_z),
            Wo * self._o_err(s["o"]),
            self.w_rdot * (s["rdot"] - p["rdot_ref"]),
            self.w_w * (s["w"] - p["w_ref"]),
            *self._rel_rows(s["c"]),
        ]
        return torch.cat(res, dim=-1)

    def _relvel_rows(self, cdot):
        cm = self.contact_model
        res = []
        for leg in range(self.number_of_legs):
            base = leg * cm
            for k in range(1, cm):
                res.append(cdot[..., base, :2] - cdot[..., base + k, :2])
        return res

    def stage_eq(self, x, u, p):
        """rel-vel pairs, cz, Newton–Euler (6), LIP (3), LIP-zone (4)."""
        s, i = self.split(x, u)
        res = self._relvel_rows(s["cdot"])
        res.append(s["c"][..., :, 2] - p["c_ref"])
        I_world = srbd_model.world_inertia(self.inertia, s["o"])
        srbd_res = srbd_model.srbd_residual(
            self.m, I_world, i["f"], s["r"], i["rddot"], s["c"], s["w"],
            i["wdot"])
        res.append(p["mask_srbd"][..., 0:1] * srbd_res)
        lip_res = lip_model.lip_dynamics_residual(
            self.m, i["f"], s["r"], i["rddot"], s["c"], eta2=self.eta2)
        res.append(p["mask_lip"][..., 0:1] * lip_res)
        mz = p["mask_lipzone"][..., 0:1]
        res.append(mz * (s["r"][..., 2:3] - self.com_z))
        res.append(mz * s["w"])
        return torch.cat(res, dim=-1)

    def terminal_eq(self, x, p):
        s = srbd_model.split_srbd_state(x, self.nc)
        res = self._relvel_rows(s["cdot"])
        res.append(s["c"][..., :, 2] - p["c_ref"])
        mz = p["mask_lipzone"][..., 0:1]
        res.append(mz * (s["r"][..., 2:3] - self.com_z))
        res.append(mz * s["w"])
        return torch.cat(res, dim=-1)

    def stage_ineq(self, x, u, p):
        """Friction cones A_fc f_i ≤ 0, five rows per contact."""
        del p
        _, i = self.split(x, u)
        g = i["f"] @ self.A_fc.transpose(-1, -2)
        return g.reshape(*u.shape[:-1], 5 * self.nc)

    def xdot(self, x, u, p=None):
        """Double integrator with floating base and input accelerations."""
        del p
        s, i = self.split(x, u)
        lead = x.shape[:-1]
        odot = quat_derivative_world(s["o"], s["w"])
        return torch.cat(
            [s["rdot"], odot, s["cdot"].reshape(*lead, 3 * self.nc),
             i["rddot"], i["wdot"], i["cddot"].reshape(*lead, 3 * self.nc)],
            dim=-1)

    def kernel_scalars(self, dt: float) -> Tuple[float, ...]:
        """The host scalars of csrc/isrbd_common.cuh (`isrbd::Consts`): dt,
        m, the inertia, η², the weights, com_z, d1, d2, the cone faces, the
        foot-pair indices."""
        key = float(dt)
        if key not in self._cache:
            inertia = [float(v) for v in self.inertia.reshape(-1).tolist()]
            cone = [float(v) for v in self.A_fc.reshape(-1).tolist()]
            self._cache[key] = (
                float(dt), float(self.m), *inertia, float(self.eta2),
                self.w_rz, self.w_rdot, self.w_w, self.w_rel, self.w_qddot,
                self.w_minf, self.com_z, self.d1[0], self.d1[1], self.d2[0],
                self.d2[1], *cone, *(float(i) for i in self.fpi),
            )
        return self._cache[key]


def build_isrbd_problem(
    cfg: SRBDConfig,
    robot: RobotConstants,
    dtype=None,
    srbd_nodes: int = 10,
    lipzone_start: int = 5,
    cz_rho_weight: float = 400.0,
    device="cuda",
) -> ISRBDProblem:
    """Build the isrbd OCP on `device` (default "cuda"; raises when CUDA is
    absent unless another device is given)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    ns, nc, cm = cfg.ns, cfg.nc, cfg.contact_model
    state_layout, input_layout = _layouts(nc)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    com = t(robot.com)
    feet0 = t(robot.foot_positions)
    inertia = t(robot.inertia)
    m = float(robot.mass)

    # The hybrid stack couples the LIP pendulum height to the LIP-zone
    # CoM-height pin (r_z = com_z): with the ZMP pivot on the ground plane,
    # consistency needs η² = g / com_z, i.e. cfg.lip_height ≈ the robot's
    # CoM height. A mismatch makes the z rows structurally inconsistent by
    # η²·|com_z − lip_height| m/s².
    if abs(cfg.lip_height - float(com[2])) > 0.05:
        raise ValueError(
            f"cfg.lip_height={cfg.lip_height} inconsistent with the "
            f"robot's CoM height {float(com[2]):.3f}: the LIP-zone "
            f"constraints need SRBDConfig(lip_height=<CoM height>)"
        )

    # foot-pair indices
    fpi = []
    for leg in range(cfg.number_of_legs):
        if cm == 1:
            fpi.append(leg)
        else:
            fpi.append(leg * cm)
            fpi.append(leg * cm + cm - 1)
    d1 = feet0[fpi[2], :2] - feet0[fpi[0], :2]
    d2 = feet0[fpi[3], :2] - feet0[fpi[1], :2]

    sq = lambda g: float(np.sqrt(g))
    terms = ISRBDTerms(
        nc=nc, contact_model=cm, number_of_legs=cfg.number_of_legs,
        m=m, inertia=inertia, eta2=cfg.eta2,
        w_rz=sq(cfg.rz_tracking_gain_isrbd),
        w_rdot=sq(cfg.rdot_tracking_gain),
        w_w=sq(cfg.w_tracking_gain),
        w_rel=1e2,
        w_qddot=sq(cfg.min_qddot_gain),
        w_minf=sq(cfg.min_f_gain),
        com_z=float(com[2]),
        d1=(float(d1[0]), float(d1[1])),
        d2=(float(d2[0]), float(d2[1])),
        fpi=tuple(fpi[:4]),
        A_fc=t(linearized_friction_cone_rows(cfg.friction_cone_coefficient)),
    )

    # Equality-row scaling: the NE and LIP rows are in newtons and
    # newton-meters (O(m·g)) while every other row is meters, m/s or rad/s
    # (O(1)); 1/(m·g) on the force rows puts the stack in comparable
    # units, so the AL solver converges at float32-safe penalties.
    # Row order: rel-vel pairs, cz, NE (6), LIP (3), lipzone (4).
    n_relvel = terms.n_relvel
    eq_scale = np.ones(terms.n_eq)
    eq_scale[n_relvel + nc : n_relvel + nc + 9] = 1.0 / (m * 9.81)
    # Per-row AL penalty stiffness: the state-only geometric rows take
    # w=100 (relvel, lipzone) and `cz_rho_weight` (cz); the input-touching
    # NE/LIP rows keep w=9 (their penalty lands in Quu).
    eq_rho_w = np.ones(terms.n_eq)
    eq_rho_w[:n_relvel] = 100.0
    eq_rho_w[n_relvel : n_relvel + nc] = cz_rho_weight
    eq_rho_w[n_relvel + nc : n_relvel + nc + 9] = 9.0
    eq_rho_w[n_relvel + nc + 9 :] = 100.0
    eq_rho_w_T = np.ones(terms.n_eq_T)
    eq_rho_w_T[:n_relvel] = 100.0
    eq_rho_w_T[n_relvel : n_relvel + nc] = cz_rho_weight
    eq_rho_w_T[n_relvel + nc :] = 100.0

    ineq_ub = torch.zeros(nc * 5, dtype=dtype, device=dev)
    ineq_lb = torch.full((nc * 5,), -float("inf"), dtype=dtype, device=dev)

    # variable boxes: forces within ±max_contact_force, contact velocities
    # within ±max_contact_velocity
    u_lb, u_ub = unbounded(ns, input_layout.total, dtype, dev)
    for i in range(nc):
        sl = input_layout.slices[f"f{i}"]
        u_lb[:, sl] = -cfg.max_contact_force
        u_ub[:, sl] = cfg.max_contact_force
    x_lb, x_ub = unbounded(ns + 1, state_layout.total, dtype, dev)
    for i in range(nc):
        sl = state_layout.slices[f"cdot{i}"]
        x_lb[:, sl] = -cfg.max_contact_velocity
        x_ub[:, sl] = cfg.max_contact_velocity

    step = integrators.rk2(terms.xdot)

    params: Dict[str, torch.Tensor] = {
        "rdot_ref": torch.zeros((ns + 1, 3), dtype=dtype, device=dev),
        "w_ref": torch.zeros((ns + 1, 3), dtype=dtype, device=dev),
        "Wo": torch.zeros((ns + 1, 1), dtype=dtype, device=dev),
        "c_ref": feet0[:, 2].expand(ns + 1, nc).clone(),
        "cdot_switch": torch.ones((ns + 1, nc), dtype=dtype, device=dev),
        "mask_track": node_mask(ns, 1, ns + 1, dtype, dev)[:, None],
        "mask_srbd": node_mask(ns, 0, srbd_nodes, dtype, dev)[:, None],
        "mask_lip": node_mask(ns, srbd_nodes, ns, dtype, dev)[:, None],
        "mask_lipzone": node_mask(ns, lipzone_start, ns + 1, dtype, dev)[:, None],
    }

    # Stacked-row sparsity over [stage_residual; stage_eq]; "xu" rows
    # touch both.
    n_qddot = 6 + 3 * nc
    segments = [
        (1, "x"), (4, "x"), (3, "x"), (3, "x"),   # rz, o, rdot, w
        (n_qddot, "u"), (4, "x"), (3 * nc, "u"),  # qddot, rel, min_f
        (n_relvel, "x"), (nc, "x"),               # rel-vel pairs, cz
        (6, "xu"), (3, "xu"), (4, "x"),           # NE, LIP, lipzone
    ]
    res_x_rows, res_u_rows = [], []
    off = 0
    for size, dep in segments:
        if "x" in dep:
            res_x_rows.extend(range(off, off + size))
        if "u" in dep:
            res_u_rows.extend(range(off, off + size))
        off += size

    # RK2 double integrator: the velocity rows of A − I are zero, every
    # row of B is live (positions get the dt²/2 half-step term), and only
    # the acceleration inputs are live B columns (forces never enter the
    # dynamics).
    n_pos = 7 + 3 * nc
    ocp = OCP(
        ns=ns,
        dt=cfg.dt,
        state_layout=state_layout,
        input_layout=input_layout,
        step=step,
        xdot=terms.xdot,
        stage_residual=terms.stage_residual,
        terminal_residual=terms.terminal_residual,
        stage_eq=terms.stage_eq,
        terminal_eq=terms.terminal_eq,
        stage_ineq=terms.stage_ineq,
        eq_scale=t(eq_scale),
        eq_rho_weight=t(eq_rho_w),
        eq_rho_weight_T=t(eq_rho_w_T),
        ineq_lb=ineq_lb,
        ineq_ub=ineq_ub,
        residual_x_rows=tuple(res_x_rows),
        residual_u_rows=tuple(res_u_rows),
        dynamics_x_rows=tuple(range(n_pos)),
        dynamics_u_rows=tuple(range(state_layout.total)),
        dynamics_u_cols=tuple(
            list(range(6))
            + [6 + 6 * i + j for i in range(nc) for j in range(3)]
        ),
        ineq_x_rows=(),
        ineq_u_rows=tuple(range(nc * 5)),
        x_lb=x_lb,
        x_ub=x_ub,
        u_lb=u_lb,
        u_ub=u_ub,
        params=params,
        constants=dict(com=com, feet0=feet0, m=m, inertia=inertia,
                       isrbd_terms=terms),
    )

    x0 = torch.cat([
        com, t([0.0, 0.0, 0.0, 1.0]), feet0.reshape(-1),
        torch.zeros(6 + 3 * nc, dtype=dtype, device=dev),
    ])
    per_contact = t([0.0, 0.0, 0.0, 0.0, 0.0, m * 9.81 / nc])
    u0 = torch.cat([torch.zeros(6, dtype=dtype, device=dev),
                    per_contact.repeat(nc)])

    return ISRBDProblem(
        ocp=ocp,
        initial_state=x0,
        static_input=u0,
        com=com,
        initial_foot_position=feet0,
        inertia=inertia,
        mass=m,
        nc=nc,
        contact_model=cm,
    )
