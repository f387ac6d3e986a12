"""LIP walking OCP — the port of srbd_horizon_tpu/problems/lip.py
(`build_lip_problem`). Its linearization, trial and evaluation kernels are
K10 (`kernels/lip_linearize.py`), K11 and `lip_evaluate`
(`kernels/lip_rollout.py`).

For the Kangaroo line feet (nc=4): nx = 6 + 6nc = 30, nu = 3 + 3nc = 15,
28 residual rows, 16 equality rows, 10 terminal rows; the point-feet biped
(nc=2) has nx 18, nu 9, 22 + 6 rows, the point-feet quadruped (nc=4, four
legs) nx 30, nu 15, 28 + 12 rows. The step is the integrator
`build_lip_problem` is given (EULER, RK2 or RK4, `ocp/integrators.py`).
Every callable broadcasts over leading batch axes. The residual stacks are
methods of `LIPTerms`, which also carries the constants the kernels read
and the step's name.

Layouts (the reference's order):
    x = [r(3), c_0..c_{nc-1}(3 each), ṙ(3), ċ_0..ċ_{nc-1}(3 each)]
    u = [z(3), c̈_0..c̈_{nc-1}(3 each)]
    ρ = [rz, rxy(2), ṙ(3), zmp(3), rel(4), r̈(3), c̈(3nc)
         | relvel(2·legs·(cm−1)), cz(nc), ċxy(2nc)]
The tracking rows rz, rxy, ṙ and rel are scaled by `mask_track` (0 at node
0); zmp and r̈, c̈ are not. r̈ = η²(r − z) − g e_z on all three axes (the
reference's quirk, models/lip.py). The terminal residual is
[rz, rxy, ṙ, rel] with the mask 1; `terminal_eq` is defined but no solver
reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from srbd_horizon_tpu_torch.config import SRBDConfig, resolve_device
from srbd_horizon_tpu_torch.models import lip as lip_model
from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants
from srbd_horizon_tpu_torch.ocp import integrators
from srbd_horizon_tpu_torch.ocp.layout import VarLayout
from srbd_horizon_tpu_torch.ocp.spec import OCP, node_mask

N_TRACK_X = 16      # stage rows rz … r̈ (0:16): the rows before c̈
N_TERMINAL = 10     # rz, rxy, ṙ, rel


@dataclasses.dataclass(frozen=True)
class LIPProblem:
    """Built problem and the handles the examples read."""

    ocp: OCP
    initial_state: torch.Tensor
    static_input: torch.Tensor
    com: torch.Tensor
    initial_foot_position: torch.Tensor  # (nc, 3)
    nc: int
    contact_model: int


@dataclasses.dataclass(frozen=True)
class LIPTerms:
    """The LIP stage, equality and terminal residuals and the constants
    they read (the residual weights are √gain, as in the reference). The
    OCP's residual callables are these methods; the CUDA kernels K10, K11
    and lip_evaluate evaluate the same rows from `kernel_scalars`."""

    family = "lip"       # the kernels solvers/msddp.py takes for this problem

    nc: int
    contact_model: int
    number_of_legs: int
    eta2: float
    w_r: float
    w_rdot: float
    w_zmp: float
    w_rel: float
    w_qddot: float
    com_z: float
    d1: Tuple[float, float]
    d2: Tuple[float, float]
    step: str = "EULER"  # the OCP's integrator, which picks the kernels' instance
    _cache: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def n_res(self) -> int:
        """Rows of the stage residual."""
        return N_TRACK_X + 3 * self.nc

    @property
    def n_eq(self) -> int:
        return 2 * self.number_of_legs * (self.contact_model - 1) + 3 * self.nc

    @property
    def n_rho(self) -> int:
        """Rows of the stacked stage residual [residual; eq]."""
        return self.n_res + self.n_eq

    def _split(self, x):
        return lip_model.split_lip_state(x, self.nc)

    def _rel_rows(self, c, w):
        cm, nc, d1, d2 = self.contact_model, self.nc, self.d1, self.d2
        return [
            w * (-c[..., 0, 1] + c[..., cm, 1] - d1[1])[..., None],
            w * (-c[..., 0, 0] + c[..., cm, 0] - d1[0])[..., None],
            w * (-c[..., cm - 1, 1] + c[..., nc - 1, 1] - d2[1])[..., None],
            w * (-c[..., cm - 1, 0] + c[..., nc - 1, 0] - d2[0])[..., None],
        ]

    def _tracking(self, s, p, mt):
        """rz, rxy, ṙ (the first six rows of both residuals)."""
        centroid = torch.mean(s["c"], dim=-2)
        return [
            mt * self.w_r * (s["r"][..., 2:3] - self.com_z),
            mt * self.w_r * (s["r"][..., :2] - centroid[..., :2]),
            mt * self.w_rdot * (s["rdot"] - p["rdot_ref"]),
        ], centroid

    def stage_residual(self, x, u, p):
        nc = self.nc
        s = self._split(x)
        i = lip_model.split_lip_input(u, nc)
        lead = x.shape[:-1]
        mt = p["mask_track"][..., 0:1]
        track, centroid = self._tracking(s, p, mt)
        rddot = lip_model.lip_rddot(s["r"], i["z"], self.eta2)
        qddot = torch.cat([rddot, i["cddot"].reshape(*lead, 3 * nc)], dim=-1)
        return torch.cat([
            *track,
            self.w_zmp * (i["z"] - centroid),
            *self._rel_rows(s["c"], mt * self.w_rel),
            self.w_qddot * qddot,
        ], dim=-1)

    def terminal_residual(self, x, p):
        s = self._split(x)
        track, _ = self._tracking(s, p, 1.0)
        return torch.cat([*track, *self._rel_rows(s["c"], self.w_rel)], dim=-1)

    def stage_eq(self, x, u, p):
        """relative_vel, cz_tracking, cdotxy_tracking — state-only."""
        del u
        nc, cm = self.nc, self.contact_model
        s = self._split(x)
        lead = x.shape[:-1]
        res = []
        for leg in range(self.number_of_legs):
            base = leg * cm
            for i in range(1, cm):
                res.append(s["cdot"][..., base, :2] - s["cdot"][..., base + i, :2])
        res.append(s["c"][..., :, 2] - p["c_ref"])
        res.append(
            (p["cdot_switch"][..., :, None] * s["cdot"][..., :, :2]).reshape(
                *lead, 2 * nc))
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

    def xdot(self, x, u):
        return lip_model.lip_xdot(x, u, eta2=self.eta2)

    def kernel_scalars(self, dt: float, wc: float) -> Tuple[float, ...]:
        """The 13 host scalars of csrc/lip_common.cuh (`lip::Consts`):
        dt, η², the weights, √w_c, com_z, d1, d2."""
        key = (float(dt), float(wc))
        if key not in self._cache:
            self._cache[key] = (
                float(dt), float(self.eta2), self.w_r, self.w_rdot,
                self.w_zmp, self.w_rel, self.w_qddot, float(wc), self.com_z,
                self.d1[0], self.d1[1], self.d2[0], self.d2[1],
            )
        return self._cache[key]


def row_sets(nc: int, n_res: int, n_rho: int, step: str = "EULER"):
    """The declared Jacobian sparsity of the LIP OCP (the JAX problem
    declares none; the port's blocksparse sweep needs it), for nc contacts
    under the step `step`: (residual_x_rows, residual_u_rows,
    dynamics_x_rows, dynamics_u_rows). Under RK2 and RK4 the stages carry
    u into r and c through ṙ and ċ (dt² terms), so every row of B is live;
    A − I keeps Euler's rows (the ċ rows read only c̈, an input)."""
    i_rdot, i_cdot, nx = 3 + 3 * nc, 6 + 3 * nc, 6 + 6 * nc
    return (
        # rz … r̈ read r, c or ṙ; every equality row reads ċ or c
        tuple(range(N_TRACK_X)) + tuple(range(n_res, n_rho)),
        # zmp and r̈ read z; c̈ is the input
        (6, 7, 8) + tuple(range(13, n_res)),
        # A − I: r ← ṙ, c ← ċ, ṙ ← r (η²)
        tuple(range(i_cdot)),
        # B: ṙ ← z, ċ ← c̈; under RK also r ← z, c ← c̈
        tuple(range(i_rdot if step == "EULER" else 0, nx)),
    )


def _layouts(nc: int):
    state_entries = [("r", 3)]
    state_entries += [(f"c{i}", 3) for i in range(nc)]
    state_entries += [("rdot", 3)]
    state_entries += [(f"cdot{i}", 3) for i in range(nc)]
    input_entries = [("z", 3)] + [(f"cddot{i}", 3) for i in range(nc)]
    return VarLayout(state_entries), VarLayout(input_entries)


def build_lip_problem(cfg: SRBDConfig, robot: RobotConstants, dtype=None,
                      integrator: str = "EULER", device="cuda") -> LIPProblem:
    """Build the LIP OCP under the step `integrator` ("EULER", "RK2" or
    "RK4", as the JAX package's `build_lip_problem` takes it) on `device` (default "cuda"; raises
    when CUDA is absent unless another device is given)."""
    dev = resolve_device(device)
    step_name = integrator.upper()
    if step_name not in integrators.BY_NAME:
        raise ValueError(f"integrator={integrator!r}: one of "
                         f"{tuple(integrators.BY_NAME)}")
    dtype = dtype or cfg.dtype
    ns, nc, cm = cfg.ns, cfg.nc, cfg.contact_model
    state_layout, input_layout = _layouts(nc)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    com = t(robot.com)
    feet0 = t(robot.foot_positions)
    d1 = feet0[cm, :2] - feet0[0, :2]
    d2 = feet0[nc - 1, :2] - feet0[cm - 1, :2]
    sq = lambda g: float(np.sqrt(g))
    terms = LIPTerms(
        nc=nc, contact_model=cm, number_of_legs=cfg.number_of_legs,
        eta2=cfg.eta2,
        w_r=sq(cfg.r_tracking_gain),
        w_rdot=sq(cfg.rdot_tracking_gain),
        w_zmp=sq(cfg.zmp_tracking_gain),
        w_rel=sq(cfg.rel_position_gain),
        w_qddot=sq(cfg.min_qddot_gain),
        com_z=float(com[2]),
        d1=(float(d1[0]), float(d1[1])),
        d2=(float(d2[0]), float(d2[1])),
        step=step_name,
    )

    xdot = lambda x, u, p: terms.xdot(x, u)
    step = integrators.BY_NAME[step_name](xdot)

    params: Dict[str, torch.Tensor] = {
        "rdot_ref": torch.zeros((ns + 1, 3), dtype=dtype, device=dev),
        "c_ref": feet0[:, 2].expand(ns + 1, nc).clone(),
        "cdot_switch": torch.ones((ns + 1, nc), dtype=dtype, device=dev),
        "mask_track": node_mask(ns, 1, ns + 1, dtype, dev)[:, None],
    }
    gx, gu, rx, ru = row_sets(nc, terms.n_res, terms.n_rho, step_name)

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
        residual_x_rows=gx,
        residual_u_rows=gu,
        dynamics_x_rows=rx,
        dynamics_u_rows=ru,
        params=params,
        constants=dict(com=com, feet0=feet0, eta2=cfg.eta2,
                       m=float(robot.mass), terms=terms),
    )

    # the reference's initial state: com, feet, zero velocities
    x0 = torch.cat([com, feet0.reshape(-1),
                    torch.zeros(3 + 3 * nc, dtype=dtype, device=dev)])
    # its static input: the ZMP under the CoM, zero accelerations
    u0 = torch.cat([com[:2], torch.zeros(1 + 3 * nc, dtype=dtype, device=dev)])

    return LIPProblem(
        ocp=ocp,
        initial_state=x0,
        static_input=u0,
        com=com,
        initial_foot_position=feet0,
        nc=nc,
        contact_model=cm,
    )
