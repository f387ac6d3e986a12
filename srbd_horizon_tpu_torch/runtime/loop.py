"""Closed-loop MPC harness — the port of srbd_horizon_tpu/runtime/loop.py:
the fleet tick (`tick_batch`, `run_batch`) and the single-robot tick
(`tick`, `run`) with its schedules (`standing_schedule`,
`walking_schedule`), on the SRBD problem (`build_srbd_loop`; the point-feet
quadruped's trot, `build_quadruped_loop`) or the LIP (`build_lip_loop`).

One tick, for every member of a fleet at once (`tick_batch`,
`MSDDP.solve_batch`) or for one robot (`tick`, `MSDDP.solve`):
  1. receding-horizon shift of the teleop reference parameters and the
     terminal rdot_ref write;
  2. WPG contact-plan advance;
  3. the batched MS-DDP solve (optionally warm-started from the previous
     plan shifted one node forward);
  4. one self-simulation step of the problem's integrator with u*₀ (and,
     on the SRBD, quaternion renormalization);
  5. telemetry: the SRBD Newton–Euler residual of the applied step
     (zeros on the LIP).

A fleet's tensors are batch-first: x (B, nx), params leaves
(B, ns+1, dim); one robot's have no leading axis: x (nx,), params leaves
(ns+1, dim). `run` and `run_batch` loop over a schedule with a leading
T axis on the host and stack the outputs on a leading T axis, as the JAX
package's `lax.scan` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig, resolve_device
from srbd_horizon_tpu_torch.math.quat import quat_normalize
from srbd_horizon_tpu_torch.models import srbd as srbd_model
from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants, kangaroo_line_feet
from srbd_horizon_tpu_torch.models.quadruped import (
    quadruped_point_feet,
    trot_group_mask,
)
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
from srbd_horizon_tpu_torch.solvers.msddp import DDPSolution, MSDDP
from srbd_horizon_tpu_torch.wpg import (
    WPGState,
    WalkingPatternGenerator,
    shift_reference_params,
)


class TickInput(NamedTuple):
    """Per-tick command for every member."""

    action: torch.Tensor      # (B,) or () int: 0 stance / 1 step / 2 jump
    rdot_ref: torch.Tensor    # (B, 3) or (3,) terminal CoM velocity reference
    w_ref: torch.Tensor       # (B, 3) or (3,) terminal angular velocity reference


class TickOutput(NamedTuple):
    """Telemetry published per tick."""

    x: torch.Tensor
    u0: torch.Tensor
    cost: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    defect_norm: torch.Tensor
    srbd_residual: torch.Tensor  # (B, 6) Newton–Euler residual


class LoopCarry(NamedTuple):
    x: torch.Tensor
    sol: DDPSolution
    params: Dict[str, torch.Tensor]
    wpg_state: WPGState


@dataclasses.dataclass
class MPCLoop:
    """Closed-loop MPC over one problem (LIP or SRBD). `srbd_constants`
    (the SRBD OCP's constants) turns on the quaternion renormalization of
    the self-simulated state and the Newton–Euler telemetry; without it
    (the LIP) the telemetry is zeros."""

    solver: MSDDP
    wpg: WalkingPatternGenerator
    srbd_constants: Optional[dict] = None
    # roll the previous plan one node forward before each solve
    shift_warmstart: bool = False

    @property
    def ocp(self):
        return self.solver.ocp

    def init(self, x0: torch.Tensor, params=None) -> LoopCarry:
        """Cold-start carry for a fleet x0 (B, nx); `params` leaves may be
        (ns+1, dim) (shared, copied per member) or (B, ns+1, dim). For one
        robot, x0 (nx,): the single-robot carry, params (ns+1, dim)."""
        if x0.dim() == 1:
            return LoopCarry(
                x=x0, sol=self.solver.init(x0),
                params=dict(params if params is not None else self.ocp.params),
                wpg_state=self.wpg.init_state(),
            )
        Bsz = x0.shape[0]
        base = params if params is not None else self.ocp.params
        fleet = {
            k: (v.expand((Bsz,) + tuple(v.shape)) if v.dim() == 2 else v).clone()
            for k, v in base.items()
        }
        return LoopCarry(
            x=x0,
            sol=self.solver.init(x0),
            params=fleet,
            wpg_state=self.wpg.init_state((Bsz,)),
        )

    def _srbd_telemetry(self, x_next, u0, sol: DDPSolution):
        """Plug the solver's node-0 plan and the applied input back into
        Newton–Euler."""
        if self.srbd_constants is None:
            return torch.zeros(x_next.shape[:-1] + (6,), dtype=x_next.dtype,
                               device=x_next.device)
        c = self.srbd_constants
        nc = c["feet0"].shape[0]
        s_next = srbd_model.split_srbd_state(x_next, nc)
        i0 = srbd_model.split_srbd_input(u0, nc)
        I_world = srbd_model.world_inertia(c["inertia_scaled"], s_next["o"])
        s0 = srbd_model.split_srbd_state(sol.X[..., 0, :], nc)
        rddot0, wdot0 = srbd_model.f_srbd(
            c["m_scaled"], I_world, i0["f"], s0["r"], s0["c"], s_next["w"],
        )
        return srbd_model.srbd_residual(
            c["m_scaled"], I_world, i0["f"], s0["r"], rddot0, s0["c"],
            s0["w"], wdot0,
        )

    def _pre_solve(self, params, wpg_state, inp: TickInput):
        """Reference shift + teleop terminal write + WPG advance."""
        params = shift_reference_params(
            params, ("rdot_ref", "w_ref", "oref", "orientation_tracking_gain"),
        )
        rd = params["rdot_ref"]
        params["rdot_ref"] = torch.cat(
            [rd[..., :-1, :], inp.rdot_ref.to(rd.dtype)[..., None, :]], dim=-2)
        return self.wpg.advance(params, wpg_state, inp.action)

    def _post_solve(self, x, sol: DDPSolution, params):
        """Self-simulation + telemetry."""
        ocp = self.ocp
        u0 = sol.U[..., 0, :]
        x_next = ocp.step(x, u0, ocp.params_at(params, 0), ocp.dt)
        if self.srbd_constants is not None:
            x_next = torch.cat(
                [x_next[..., :3], quat_normalize(x_next[..., 3:7]),
                 x_next[..., 7:]],
                dim=-1,
            )
        out = TickOutput(
            x=x_next,
            u0=u0,
            cost=sol.cost,
            iterations=sol.iterations,
            converged=sol.converged,
            defect_norm=sol.defect_norm,
            srbd_residual=self._srbd_telemetry(x_next, u0, sol),
        )
        return x_next, out

    def _shift_sol(self, sol: DDPSolution) -> DDPSolution:
        """Roll the previous plan one node forward (terminal repeated)."""
        X = torch.cat([sol.X[..., 1:, :], sol.X[..., -1:, :]], dim=-2)
        U = torch.cat([sol.U[..., 1:, :], sol.U[..., -1:, :]], dim=-2)
        return sol._replace(X=X, U=U)

    def _tick(self, solve, carry: LoopCarry, inp: TickInput):
        params, wpg_state = self._pre_solve(carry.params, carry.wpg_state, inp)
        sol0 = self._shift_sol(carry.sol) if self.shift_warmstart else carry.sol
        sol = solve(sol0, carry.x, params)
        x_next, out = self._post_solve(carry.x, sol, params)
        return LoopCarry(x=x_next, sol=sol, params=params, wpg_state=wpg_state), out

    def tick(self, carry: LoopCarry, inp: TickInput) -> Tuple[LoopCarry, TickOutput]:
        """One closed-loop tick for one robot (`MSDDP.solve`), on the
        single-robot carry and an unbatched `TickInput`."""
        return self._tick(self.solver.solve, carry, inp)

    def tick_batch(self, carry: LoopCarry, inp: TickInput) -> Tuple[LoopCarry, TickOutput]:
        """One closed-loop tick for the whole fleet — the production path."""
        return self._tick(self.solver.solve_batch, carry, inp)

    def run(self, carry: LoopCarry, schedule: TickInput) -> Tuple[LoopCarry, TickOutput]:
        """`tick` over a schedule with a leading T axis: the final carry and
        the T outputs stacked on a leading axis."""
        return _scan(self.tick, carry, schedule)

    def run_batch(self, carry: LoopCarry, schedule: TickInput) -> Tuple[LoopCarry, TickOutput]:
        """`tick_batch` over a (T, B, …) schedule, stacked like `run`."""
        return _scan(self.tick_batch, carry, schedule)


def _scan(tick, carry, schedule: TickInput):
    """`lax.scan` of `tick` on the host: one call a schedule entry."""
    outs = []
    for t in range(schedule.action.shape[0]):
        carry, out = tick(carry, TickInput(*(a[t] for a in schedule)))
        outs.append(out)
    return carry, TickOutput(*(torch.stack(v) for v in zip(*outs)))


def standing_schedule(T: int, dtype=torch.float32, device="cuda") -> TickInput:
    """T ticks of stance with zero references (`standing_schedule`)."""
    dev = resolve_device(device)
    return TickInput(
        action=torch.zeros(T, dtype=torch.int32, device=dev),
        rdot_ref=torch.zeros((T, 3), dtype=dtype, device=dev),
        w_ref=torch.zeros((T, 3), dtype=dtype, device=dev),
    )


def walking_schedule(T: int, vx: float = 0.3, vy: float = 0.0,
                     start: int = 10, dtype=torch.float32,
                     device="cuda") -> TickInput:
    """Stand for `start` ticks, then walk with terminal CoM velocity
    (vx, vy, 0) — the JAX package's `walking_schedule`, the keyboard
    teleop pattern of its examples."""
    dev = resolve_device(device)
    walking = torch.arange(T, device=dev) >= start
    ref = torch.tensor([vx, vy, 0.0], dtype=dtype, device=dev)
    return TickInput(
        action=walking.to(torch.int32),
        rdot_ref=torch.where(walking[:, None], ref[None],
                             torch.zeros_like(ref)[None]),
        w_ref=torch.zeros((T, 3), dtype=dtype, device=dev),
    )


def build_srbd_loop(cfg: Optional[SRBDConfig] = None,
                    opts: Optional[DDPOptions] = None,
                    robot: Optional[RobotConstants] = None,
                    shift_warmstart: bool = True,
                    dtype=None,
                    device="cuda",
                    group_mask=None,
                    integrator: str = "EULER"):
    """The fleet MPC loop on the SRBD problem (the Kangaroo biped on line
    feet by default; `SRBDConfig(contact_model=1, number_of_legs=2)` with
    `robot=point_feet()` is the point-feet biped), its step `integrator`
    ("EULER", "RK2" or "RK4"), built on `device` (default "cuda"; raises
    when CUDA is absent unless another device is given). The WPG takes the
    contact topology of `cfg` and, when given, `group_mask` (the contacts
    that follow the first half-cycle). Returns (loop, problem)."""
    dev = resolve_device(device)
    cfg = cfg or SRBDConfig()
    dtype = dtype or cfg.dtype
    prob = build_srbd_problem(cfg, robot or kangaroo_line_feet(), dtype=dtype,
                              integrator=integrator, device=dev)
    solver = MSDDP(prob.ocp, opts or DDPOptions(max_iters=5))
    wpg = WalkingPatternGenerator.build(
        c_init_z=0.0, nodes=cfg.ns, contact_model=cfg.contact_model,
        number_of_legs=cfg.number_of_legs, dtype=dtype, group_mask=group_mask,
        device=dev)
    loop = MPCLoop(solver=solver, wpg=wpg, srbd_constants=prob.ocp.constants,
                   shift_warmstart=shift_warmstart)
    return loop, prob


def build_quadruped_loop(cfg: Optional[SRBDConfig] = None,
                         opts: Optional[DDPOptions] = None,
                         shift_warmstart: bool = False,
                         dtype=None,
                         device="cuda",
                         integrator: str = "EULER"):
    """The MPC loop on the point-feet quadruped, in the configuration of
    the JAX package's quadruped example: `SRBDConfig(contact_model=1,
    number_of_legs=4)`, `max_iters=5`, `alpha_converge_threshold=1e-12`,
    `beta=1e-3`, the diagonal-pair trot WPG at the feet's height, the
    Newton–Euler telemetry on. One robot: `tick` / `run` on x0 (nx,); a
    fleet: `tick_batch` on x0 (B, nx), usually with
    `shift_warmstart=True`. `opts` may set any execution mode
    (`riccati_mode="associative"`, `forward_pass="linear"`: K12 and K13 at
    the quadruped's shape under each step) and either gain solve.
    `integrator` is the problem's step ("EULER", "RK2" or "RK4"). Built on
    `device` (default "cuda"; raises when CUDA is absent unless another
    device is given). Returns (loop, problem)."""
    dev = resolve_device(device)
    cfg = cfg or SRBDConfig(contact_model=1, number_of_legs=4)
    dtype = dtype or cfg.dtype
    prob = build_srbd_problem(cfg, quadruped_point_feet(), dtype=dtype,
                              integrator=integrator, device=dev)
    solver = MSDDP(prob.ocp, opts or DDPOptions(
        max_iters=5, alpha_converge_threshold=1e-12, beta=1e-3))
    wpg = WalkingPatternGenerator.build(
        c_init_z=float(prob.initial_foot_position[0, 2]), nodes=cfg.ns,
        contact_model=cfg.contact_model, number_of_legs=cfg.number_of_legs,
        dtype=dtype, group_mask=trot_group_mask(), device=dev)
    loop = MPCLoop(solver=solver, wpg=wpg, srbd_constants=prob.ocp.constants,
                   shift_warmstart=shift_warmstart)
    return loop, prob


def build_lip_loop(cfg: Optional[SRBDConfig] = None,
                   opts: Optional[DDPOptions] = None,
                   robot: Optional[RobotConstants] = None,
                   shift_warmstart: bool = False,
                   dtype=None,
                   device="cuda",
                   group_mask=None,
                   integrator: str = "EULER"):
    """The MPC loop on the LIP biped (Kangaroo line feet by default;
    `SRBDConfig(contact_model=1, number_of_legs=2)` with
    `robot=point_feet()` is the point-feet biped; `contact_model=1,
    number_of_legs=4` with `quadruped_point_feet()` and the trot's
    `group_mask` the quadruped), its step `integrator` ("EULER", "RK2" or
    "RK4"; the self-simulation steps by it too), in the configuration of
    the JAX package's dlip example: `max_iters=100`,
    `alpha_converge_threshold=1e-12`, `beta=1e-3`, the WPG at the feet's
    height, no SRBD telemetry and no warm-start shift. `opts` may set any
    execution mode (`riccati_mode="associative"`, `forward_pass="linear"`:
    K12 and K13 at every topology and step) and either gain solve. The WPG
    takes the contact topology of `cfg` and, when given, `group_mask` (the
    contacts that follow the first half-cycle). Built on `device` (default "cuda";
    raises when CUDA is absent unless another device is given). Returns
    (loop, problem)."""
    dev = resolve_device(device)
    cfg = cfg or SRBDConfig()
    dtype = dtype or cfg.dtype
    prob = build_lip_problem(cfg, robot or kangaroo_line_feet(), dtype=dtype,
                             integrator=integrator, device=dev)
    solver = MSDDP(prob.ocp, opts or DDPOptions(
        max_iters=100, alpha_converge_threshold=1e-12, beta=1e-3))
    wpg = WalkingPatternGenerator.build(
        c_init_z=float(prob.initial_foot_position[0, 2]), nodes=cfg.ns,
        contact_model=cfg.contact_model, number_of_legs=cfg.number_of_legs,
        dtype=dtype, group_mask=group_mask, device=dev)
    loop = MPCLoop(solver=solver, wpg=wpg, shift_warmstart=shift_warmstart)
    return loop, prob


def walk_command(Bsz: int, vx: float = 0.2, dtype=torch.float32,
                 device="cuda") -> TickInput:
    """The constant walk command of the fleet bench: action STEP and a
    terminal CoM velocity (vx, 0, 0) for every member."""
    dev = resolve_device(device)
    rdot = torch.zeros((Bsz, 3), dtype=dtype, device=dev)
    rdot[:, 0] = vx
    return TickInput(
        action=torch.ones(Bsz, dtype=torch.int32, device=dev),
        rdot_ref=rdot,
        w_ref=torch.zeros((Bsz, 3), dtype=dtype, device=dev),
    )
