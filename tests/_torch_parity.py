"""Shared setup for the PyTorch-port parity tests (not collected).

The same SRBD problem is built in both packages in float64 on the CPU,
and every random input is drawn from a numpy seed and handed to both, so
each test compares the JAX function with its port on identical data.
Arrays cross between the frameworks as numpy only.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet as j_feet
from srbd_horizon_tpu.problems.srbd import build_srbd_problem as j_build
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP

from srbd_horizon_tpu_torch.config import DDPOptions as TDDPOptions
from srbd_horizon_tpu_torch.config import SRBDConfig as TSRBDConfig
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet as t_feet
from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem as t_build
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP as TMSDDP

CPU = "cpu"
F64 = torch.float64

# The JAX reference these tests hold the port to is compiled from the same
# HLO without LLVM's optimization passes (XLA's backend optimization level
# 0): its XLA compiles take 20-30% less time, and every comparison holds
# at its tolerance as at the default level. Only a top-level jit takes
# compiler options; a jit nested in one takes none.
REFERENCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}


def jit(fun, **kw):
    """`jax.jit` for the JAX reference (`REFERENCE_COMPILER_OPTIONS`)."""
    return jax.jit(fun, compiler_options=REFERENCE_COMPILER_OPTIONS, **kw)

# the option set the fleet bench and the batched-solver tests run
SOLVER_OPTS = dict(max_iters=8, alpha_converge_threshold=1e-12, beta=1e-3)


def np_of(a):
    """Torch tensor or JAX array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def problems():
    """(jax SRBDProblem, torch SRBDProblem), both float64 on the CPU."""
    jp = j_build(JSRBDConfig(dtype=jnp.float64), j_feet())
    tp = t_build(TSRBDConfig(dtype=F64), t_feet(), device=CPU)
    return jp, tp


def solvers(jp, tp, **overrides):
    opts = dict(SOLVER_OPTS, **overrides)
    return JMSDDP(jp.ocp, JDDPOptions(**opts)), TMSDDP(tp.ocp, TDDPOptions(**opts))


def perturbed_states(x_nominal, B, seed, scale=0.01):
    """(B, nx) numpy states around the nominal one."""
    rng = np.random.RandomState(seed)
    x = np.asarray(x_nominal, np.float64)
    return x[None] + scale * rng.randn(B, x.shape[0])


def random_xup(ocp_params, nx, nu, seed, lead=()):
    """Numpy (x, u, p) around the walking regime: a non-unit quaternion,
    random contacts and velocities, random parameter rows with binary
    switches."""
    rng = np.random.RandomState(seed)
    x = np.concatenate(
        [
            rng.uniform(-0.5, 0.5, lead + (3,)) + [0, 0, 0.9],
            np.broadcast_to([0.1, -0.2, 0.05, 0.97], lead + (4,))
            + 0.01 * rng.randn(*lead, 4),
            rng.uniform(-0.3, 0.3, lead + (nx - 7,)),
        ],
        axis=-1,
    )
    u = 0.3 * rng.randn(*lead, nu)
    p = {}
    for k, v in ocp_params.items():
        row = np.asarray(np_of(v))[3]
        p[k] = row + 0.1 * np.abs(rng.randn(*lead, *row.shape))
    p["cdot_switch"] = np.round(np.clip(p["cdot_switch"], 0, 1))
    return x, u, p


def fleet_params(ocp_params, B):
    """(B, ns+1, dim) numpy params: the template copied per member."""
    return {k: np.broadcast_to(np_of(v)[None], (B,) + tuple(v.shape)).copy()
            for k, v in ocp_params.items()}


def to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: torch.tensor(np.asarray(v), dtype=F64) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=F64)


def trajectories(jp, B, seed):
    """A numpy linearization point near the walking regime: X (B,ns+1,nx)
    around the initial state, U (B,ns,nu) around the static input."""
    rng = np.random.RandomState(seed)
    ns = jp.ocp.ns
    x0 = np.asarray(jp.initial_state)
    u0 = np.asarray(jp.static_input)
    X = x0[None, None] + 0.02 * rng.randn(B, ns + 1, x0.shape[0])
    U = u0[None, None] + 0.05 * rng.randn(B, ns, u0.shape[0])
    return X, U


def max_rel_err(got, want):
    """max |got − want| / max |want| (norm-wise relative error)."""
    got, want = np_of(got), np_of(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    return float(np.max(np.abs(got - want))) / scale


# ---------------- the constrained (isrbd / AL-DDP) path ----------------

from srbd_horizon_tpu.problems.isrbd import build_isrbd_problem as j_build_isrbd
from srbd_horizon_tpu.solvers.alddp import ALDDP as JALDDP
from srbd_horizon_tpu.solvers.alddp import ALOptions as JALOptions
from srbd_horizon_tpu.solvers.alddp import ALState as JALState
from srbd_horizon_tpu.solvers.msddp import DDPSolution as JDDPSolution

from srbd_horizon_tpu_torch.convert import al_state_from_numpy
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem as t_build_isrbd
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP as TALDDP
from srbd_horizon_tpu_torch.solvers.alddp import ALOptions as TALOptions

AL_DDP_OPTS = dict(alpha_converge_threshold=1e-12, beta=1e-3)


def isrbd_problems(ns=20, **kw):
    """(jax ISRBDProblem, torch ISRBDProblem), float64 on the CPU, on a
    horizon of ns nodes of 0.05 s (the hybrid schedule is cut with it)."""
    if ns != 20:
        kw.setdefault("srbd_nodes", ns // 2)
        kw.setdefault("lipzone_start", ns // 4)
    shape = dict(ns=ns, T=0.05 * ns)
    jp = j_build_isrbd(JSRBDConfig(dtype=jnp.float64, **shape), j_feet(), **kw)
    tp = t_build_isrbd(TSRBDConfig(dtype=F64, **shape), t_feet(), device=CPU,
                       **kw)
    return jp, tp


def al_solvers(jp, tp, max_iters=3, ddp=None, **al):
    """(jax ALDDP, torch ALDDP) with the serving schedule's options; `ddp`
    adds DDP options (an execution mode) to both."""
    al = dict(dict(outer_iters=2, rho0=1e3, rho_max=1e5, tol=1e-5), **al)
    ddp = dict(max_iters=max_iters, **AL_DDP_OPTS, **(ddp or {}))
    return (JALDDP(jp.ocp, JDDPOptions(**ddp), JALOptions(**al)),
            TALDDP(tp.ocp, TDDPOptions(**ddp), TALOptions(**al)))


def random_al_state(ocp, B, seed, n_eq, n_eq_T, n_in):
    """A numpy ALState (nested dict, fleet axis leading) around the walking
    regime: forces with large horizontal parts (active cones), random
    multipliers, per-member penalties."""
    rng = np.random.RandomState(seed)
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    X = np.zeros((B, ns + 1, nx))
    X[..., 0:3] = [0.0, 0.0, 0.88] + 0.05 * rng.randn(B, ns + 1, 3)
    X[..., 3:7] = [0.1, -0.2, 0.05, 0.97] + 0.02 * rng.randn(B, ns + 1, 4)
    X[..., 7:] = rng.uniform(-0.3, 0.3, (B, ns + 1, nx - 7))
    U = 0.5 * rng.randn(B, ns, nu)
    for k in range((nu - 6) // 6):
        U[..., 9 + 6 * k:12 + 6 * k] = ([0.0, 0.0, 98.0]
                                        + [60.0, 60.0, 5.0] * rng.randn(B, ns, 3))
    pos = lambda *s: np.abs(rng.randn(*s))
    mu_ub = 5.0 * pos(B, ns, n_in)
    # member 0's first contact carries exactly no force and no cone
    # multiplier on the late nodes: its cone rows sit exactly on the kink
    U[0, ns // 2:, 9:12] = 0.0
    mu_ub[0, ns // 2:, 0:5] = 0.0
    return dict(
        sol=dict(X=X, U=U, cost=np.zeros(B), converged=np.zeros(B, bool),
                 iterations=np.zeros(B, np.int32), defect_norm=np.zeros(B)),
        lam_eq=rng.randn(B, ns, n_eq), lam_eq_T=rng.randn(B, n_eq_T),
        mu_ub=mu_ub, mu_lb=pos(B, ns, n_in),
        mu_x_ub=pos(B, ns + 1, nx), mu_x_lb=pos(B, ns + 1, nx),
        mu_u_ub=pos(B, ns, nu), mu_u_lb=pos(B, ns, nu),
        rho=10.0 ** rng.uniform(3, 5, B), viol=np.full(B, 0.1),
    )


def tight_box_params(jp, B, seed):
    """Numpy fleet params with box overrides that keep the static finite
    pattern (contact velocities, forces) but sit inside the random data,
    so some box rows are active on either side, and random 0/1 masks."""
    rng = np.random.RandomState(seed)
    ocp = jp.ocp
    p = fleet_params(ocp.params, B)
    ns = ocp.ns
    for k in ("mask_track", "mask_srbd", "mask_lip", "mask_lipzone"):
        p[k] = rng.randint(0, 2, p[k].shape).astype(np.float64)
    p["Wo"] = np.abs(rng.randn(*p["Wo"].shape))
    p["rdot_ref"] = 0.1 * rng.randn(*p["rdot_ref"].shape)
    p["c_ref"] = 0.05 * np.abs(rng.randn(*p["c_ref"].shape))
    for name, width, lo, hi in (("x", 0.1, None, None), ("u", None, 60.0, 130.0)):
        lb = np.broadcast_to(np_of(getattr(ocp, f"{name}_lb")),
                             (B,) + getattr(ocp, f"{name}_lb").shape).copy()
        ub = np.broadcast_to(np_of(getattr(ocp, f"{name}_ub")),
                             (B,) + getattr(ocp, f"{name}_ub").shape).copy()
        fin = np.isfinite(ub)
        if name == "x":
            lb[fin], ub[fin] = -width, width
        else:
            lb[fin], ub[fin] = lo, hi
        p[f"{name}_lb"], p[f"{name}_ub"] = lb, ub
    return p


def jax_al_state(st):
    """Numpy ALState dict -> the JAX package's ALState (float64)."""
    f = lambda a: jnp.asarray(a)
    return JALState(sol=JDDPSolution(**{k: f(v) for k, v in st["sol"].items()}),
                    **{k: f(v) for k, v in st.items() if k != "sol"})


def torch_al_state(st):
    return al_state_from_numpy(st, device=CPU, dtype=F64)


def al_state_numpy(st):
    """A JAX or torch ALState -> the numpy nested dict."""
    out = {k: np_of(getattr(st, k)) for k in st._fields if k != "sol"}
    out["sol"] = {k: np_of(getattr(st.sol, k)) for k in st.sol._fields}
    return out


# ---------------- the point-feet quadruped (trot) ----------------

from srbd_horizon_tpu.models.quadruped import quadruped_point_feet as j_quad
from srbd_horizon_tpu.models.quadruped import trot_group_mask as j_trot
from srbd_horizon_tpu.runtime.loop import MPCLoop as JMPCLoop
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG

from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet as t_quad
from srbd_horizon_tpu_torch.runtime.loop import build_quadruped_loop

QUAD_TOPOLOGY = dict(contact_model=1, number_of_legs=4)
# the JAX package's quadruped example's options
QUAD_OPTS = dict(max_iters=5, alpha_converge_threshold=1e-12, beta=1e-3)


def quadruped_problems():
    """(jax SRBDProblem, torch SRBDProblem) of the point-feet quadruped,
    float64 on the CPU."""
    jp = j_build(JSRBDConfig(dtype=jnp.float64, **QUAD_TOPOLOGY), j_quad())
    tp = t_build(TSRBDConfig(dtype=F64, **QUAD_TOPOLOGY), t_quad(), device=CPU)
    return jp, tp


def quadruped_loops(shift=False, **overrides):
    """(jax problem, jax MPCLoop, torch MPCLoop, torch problem) in the
    quadruped example's configuration (the trot WPG at the feet's height,
    the Newton–Euler telemetry on), float64 on the CPU; `overrides` change
    the options in both."""
    opts = dict(QUAD_OPTS, **overrides)
    jp = j_build(JSRBDConfig(dtype=jnp.float64, **QUAD_TOPOLOGY), j_quad())
    js = JMSDDP(jp.ocp, JDDPOptions(**opts))
    wpg = JWPG.build(c_init_z=float(jp.initial_foot_position[0, 2]),
                     nodes=jp.ocp.ns, dtype=jnp.float64, group_mask=j_trot(),
                     **QUAD_TOPOLOGY)
    jloop = JMPCLoop(solver=js, wpg=wpg, srbd_constants=jp.ocp.constants,
                     shift_warmstart=shift)
    tloop, tp = build_quadruped_loop(
        TSRBDConfig(dtype=F64, **QUAD_TOPOLOGY), TDDPOptions(**opts),
        shift_warmstart=shift, device=CPU)
    return jp, jloop, tloop, tp


# ---------------- the constrained quadruped trot (isrbd on point feet) ------

from srbd_horizon_tpu.solvers.options import al_serving_options as j_al_serving
from srbd_horizon_tpu_torch.models.quadruped import trot_group_mask as t_trot
from srbd_horizon_tpu_torch.solvers.options import al_serving_options as t_al_serving
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

# the trot's command (tests/test_quadruped.py's TestConstrainedTrot)
QUAD_VX = 0.15


def quadruped_isrbd_problems(ns=20):
    """(jax ISRBDProblem, torch ISRBDProblem) of the point-feet quadruped as
    the JAX package's constrained example builds it (the LIP height at the
    robot's CoM), float64 on the CPU; another `ns` cuts the horizon of
    0.05 s nodes and the hybrid schedule with it, as `isrbd_problems`."""
    jr, tr = j_quad(), t_quad()
    kw = {} if ns == 20 else dict(srbd_nodes=ns // 2, lipzone_start=ns // 4)
    shape = dict(ns=ns, T=0.05 * ns, **QUAD_TOPOLOGY)
    jp = j_build_isrbd(JSRBDConfig(dtype=jnp.float64, lip_height=float(jr.com[2]),
                                   **shape), jr, **kw)
    tp = t_build_isrbd(TSRBDConfig(dtype=F64, lip_height=float(tr.com[2]),
                                   **shape), tr, device=CPU, **kw)
    return jp, tp


def quadruped_al_solvers(jp, tp, max_iters):
    """(jax ALDDP, torch ALDDP) with `al_serving_options(max_iters)`, the
    example's options (15 offline, 1 online)."""
    jd, ja = j_al_serving(max_iters)
    td, ta = t_al_serving(max_iters)
    return JALDDP(jp.ocp, ddp_opts=jd, al_opts=ja), TALDDP(tp.ocp, td, ta)


def quadruped_trot_wpgs(ns):
    """(jax, torch) trot WPGs of the constrained example (c_init_z 0)."""
    return (JWPG.build(0.0, ns, dtype=jnp.float64, group_mask=j_trot(),
                       **QUAD_TOPOLOGY),
            TWPG.build(0.0, ns, dtype=F64, device=CPU, group_mask=t_trot(),
                       **QUAD_TOPOLOGY))


def torch_constrained_trot(prob, offline, online, wpg, ticks, vx=QUAD_VX):
    """The constrained example's single-robot sequence in the port: the
    offline `ALDDP.solve` from the static input tiled, then `ticks` ticks of
    the WPG advance (walking from tick 0), rdot_ref[1:] = (vx, 0, 0),
    x0 = the plan's node 1 and solve_online(solve_online(shift_warmstart)).
    Returns the states after the offline solve and after each tick."""
    ocp = prob.ocp
    dtype, dev = prob.initial_state.dtype, prob.initial_state.device
    x0 = prob.initial_state
    U0 = prob.static_input[None].expand(ocp.ns, -1).contiguous()
    st = offline.solve(offline.init(x0, U0), x0, ocp.params)
    states = [st]
    params, ws = dict(ocp.params), wpg.init_state()
    ref = torch.tensor([vx, 0.0, 0.0], dtype=dtype, device=dev)
    walk = torch.tensor(1, dtype=torch.int32, device=dev)
    for _ in range(ticks):
        params, ws = wpg.advance(params, ws, walk)
        params["rdot_ref"] = torch.cat(
            [params["rdot_ref"][:1], ref.expand(ocp.ns, 3)], dim=0)
        x0 = st.sol.X[1]
        st = online.solve_online(
            online.solve_online(online.shift_warmstart(st), x0, params), x0,
            params)
        states.append(st)
    return states


# ---------------- the execution modes on the AL solver ----------------

# the three non-default (riccati_mode, forward_pass) combinations
MODES = [("associative", "nonlinear"), ("sequential", "linear"),
         ("associative", "linear")]
MODE_IDS = ["associative-nonlinear", "sequential-linear", "associative-linear"]
AL_STATE_FIELDS = ("lam_eq", "lam_eq_T", "mu_ub", "mu_lb", "mu_x_ub",
                   "mu_x_lb", "mu_u_ub", "mu_u_lb", "rho", "viol")


def modes(riccati, forward):
    return dict(riccati_mode=riccati, forward_pass=forward)


def al_agree(got, want, where, tol=1e-9):
    """Two ALStates: iterations and flags equal; plans, cost, multipliers,
    ρ and the violation to `tol` (norm-wise relative)."""
    g, w = al_state_numpy(got), al_state_numpy(want)
    for k in ("iterations", "converged"):
        np.testing.assert_array_equal(g["sol"][k], w["sol"][k],
                                      err_msg=f"{where}: {k}")
    errs = {k: max_rel_err(g[k], w[k]) for k in AL_STATE_FIELDS}
    errs.update({k: max_rel_err(g["sol"][k], w["sol"][k])
                 for k in ("X", "U", "cost")})
    assert max(errs.values()) < tol, (where, errs)
    return errs


class ModesSpy:
    """Counts a port MSDDP's K12 sweeps, K1 (Tassa) sweeps and K13 trials,
    and the iterations its solves report (a batched solve sweeps while any
    member iterates: its largest count)."""

    def __init__(self, solver):
        self.k12 = self.k1 = self.k13 = self.iterations = 0
        assoc, seq, trial = (solver._backward_associative, solver._backward,
                             solver._trial)
        solve, solve_batch = solver.solve, solver.solve_batch

        def spy_assoc(*a):
            self.k12 += 1
            return assoc(*a)

        def spy_seq(*a):
            self.k1 += 1
            return seq(*a)

        def spy_trial(*a):
            self.k13 += len(a) > 12 and a[12] is not None
            return trial(*a)

        def spy_solve(*a):
            sol = solve(*a)
            self.iterations += int(sol.iterations)
            return sol

        def spy_solve_batch(*a):
            sol = solve_batch(*a)
            self.iterations += int(sol.iterations.max())
            return sol

        solver._backward_associative = spy_assoc
        solver._backward = spy_seq
        solver._trial = spy_trial
        solver.solve, solver.solve_batch = spy_solve, spy_solve_batch

    def check(self, mode):
        """One K12 sweep an iteration under the associative sweep (K1
        none), one K1 sweep an iteration under the sequential one, and
        linear trials only under the linear pass."""
        assert self.iterations > 2
        if mode[0] == "associative":
            assert (self.k12, self.k1) == (self.iterations, 0)
        else:
            assert (self.k12, self.k1) == (0, self.iterations)
        assert (self.k13 > 0) == (mode[1] == "linear")


def al_solve_then_online(al, init, x0, U0, params, online_params):
    """`solve` from the cold state, then the warm start shifted and two
    `solve_online`s at the plan's node 1 (either package)."""
    st = al.solve(init(x0, U0), x0, params)
    x1 = st.sol.X[1]
    st1 = al.solve_online(al.shift_warmstart(st), x1, online_params)
    return st, st1, al.solve_online(st1, x1, online_params)


def run_al_modes(jp, tp, mode, jax_side=True, vx=0.2):
    """Under `mode`, JAX's (unless `jax_side` is false) and the port's
    `al_solve_then_online` (`al_solvers`: 2 outers × 3 inner iterations
    from ρ₀ 1e3, the static input tiled; online rdot_ref (vx, 0, 0) on
    nodes 1..ns), and the port's `ModesSpy` on its inner solver."""
    js, ts = al_solvers(jp, tp, ddp=modes(*mode))
    want = None
    if jax_side:
        U0 = jnp.tile(jp.static_input[None], (jp.ocp.ns, 1))
        jon = dict(jp.ocp.params)
        jon["rdot_ref"] = jon["rdot_ref"].at[1:].set(jnp.array([vx, 0.0, 0.0]))
        want = jit(lambda x0, p, q: al_solve_then_online(
            js, lambda x, u: js.init(x, U0=u), x0, U0, p, q))(
                jp.initial_state, jp.ocp.params, jon)
    spy = ModesSpy(ts.inner)
    ton = dict(tp.ocp.params)
    r = ton["rdot_ref"]
    ton["rdot_ref"] = torch.cat(
        [r[:1], torch.tensor([vx, 0.0, 0.0], dtype=F64).expand(r.shape[0] - 1, 3)])
    tU0 = tp.static_input[None].expand(tp.ocp.ns, -1).contiguous()
    got = al_solve_then_online(ts, ts.init, tp.initial_state, tU0,
                               tp.ocp.params, ton)
    return want, got, spy


# ---------------- every SRBD topology and step ----------------

from srbd_horizon_tpu.models.kangaroo import point_feet as j_point_feet
from srbd_horizon_tpu.runtime.loop import TickInput as JTickInput
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking

from _line_feet_quadruped import (HALF_LENGTH, LINE_FEET_TOPOLOGY,
                                   line_feet_trot_mask)
from _line_feet_quadruped import line_feet_quadruped as t_line_feet_quadruped
from _square_feet import SQUARE_TOPOLOGY
from _square_feet import square_feet as t_square_feet
from test_configs import _four_contact_feet as j_square_feet

from srbd_horizon_tpu_torch.convert import tick_input_from_numpy
from srbd_horizon_tpu_torch.models.kangaroo import point_feet as t_point_feet
from srbd_horizon_tpu_torch.runtime.loop import build_srbd_loop
from srbd_horizon_tpu_torch.runtime.loop import walking_schedule as t_walking



def j_line_feet_quadruped():
    """JAX's line-feet quadruped as `TestLineFeetQuadruped` builds it: the
    JAX package's `quadruped_point_feet()` with two contacts HALF_LENGTH
    either side of each foot along x, frames c0…c7."""
    q = j_quad()
    pts = []
    for p in np.asarray(q.foot_positions):
        pts.append(p + np.array([HALF_LENGTH, 0.0, 0.0]))
        pts.append(p - np.array([HALF_LENGTH, 0.0, 0.0]))
    return dataclasses.replace(q, foot_positions=np.asarray(pts),
                               foot_frames=tuple(f"c{i}" for i in range(8)))


# the contact topologies JAX's build_srbd_problem takes: (SRBDConfig
# fields, jax robot, torch robot, the WPG's group mask — the contacts that
# follow the first half-cycle, one entry a contact — or None for the
# biped split); the square-feet biped's robot is the JAX package's test
# data (TestNc8's `_four_contact_feet`), its torch copy
# `_square_feet.square_feet`; the line-feet quadruped's is
# TestLineFeetQuadruped's, built here and in `_line_feet_quadruped`, with
# the trot's 8-entry mask
TOPOLOGIES = {
    "kangaroo": (dict(), j_feet, t_feet, None),
    "quadruped": (QUAD_TOPOLOGY, j_quad, t_quad, t_trot()),
    "point_feet": (dict(contact_model=1, number_of_legs=2), j_point_feet,
                   t_point_feet, None),
    "square_feet": (SQUARE_TOPOLOGY, j_square_feet, t_square_feet, None),
    "line_feet_quadruped": (LINE_FEET_TOPOLOGY, j_line_feet_quadruped,
                            t_line_feet_quadruped, line_feet_trot_mask()),
}


def srbd_problems(topology="kangaroo", integrator="EULER", ns=20):
    """(jax SRBDProblem, torch SRBDProblem) of one topology under one step,
    float64 on the CPU, on a horizon of ns nodes of 0.05 s."""
    kw, jr, tr, _ = TOPOLOGIES[topology]
    shape = dict(ns=ns, T=0.05 * ns, **kw)
    jp = j_build(JSRBDConfig(dtype=jnp.float64, **shape), jr(),
                 integrator=integrator)
    tp = t_build(TSRBDConfig(dtype=F64, **shape), tr(), integrator=integrator,
                 device=CPU)
    return jp, tp


def srbd_loops(topology="kangaroo", integrator="EULER", ns=20, shift=False,
               **overrides):
    """(jax problem, jax MPCLoop, torch MPCLoop, torch problem) of one
    topology under one step as `build_srbd_loop` builds it (the WPG at the
    feet's height, the trot grouping on the quadruped, the Newton–Euler
    telemetry on), float64 on the CPU; `overrides` are options of both
    solvers (SOLVER_OPTS by default)."""
    kw, jr, tr, mask = TOPOLOGIES[topology]
    opts = dict(SOLVER_OPTS, **overrides)
    jp, _ = srbd_problems(topology, integrator, ns)
    cfg = TSRBDConfig(dtype=F64, ns=ns, T=0.05 * ns, **kw)
    js = JMSDDP(jp.ocp, JDDPOptions(**opts))
    wpg = JWPG.build(c_init_z=float(jp.initial_foot_position[0, 2]),
                     nodes=ns, dtype=jnp.float64,
                     group_mask=mask, contact_model=cfg.contact_model,
                     number_of_legs=cfg.number_of_legs)
    jloop = JMPCLoop(solver=js, wpg=wpg, srbd_constants=jp.ocp.constants,
                     shift_warmstart=shift)
    tloop, tp = build_srbd_loop(cfg, TDDPOptions(**opts), robot=tr(),
                                shift_warmstart=shift, device=CPU,
                                group_mask=mask, integrator=integrator)
    return jp, jloop, tloop, tp


def agree(got, want, where, fields, tol=1e-9):
    """Two solutions or tick outputs: iterations and convergence equal,
    `fields` to `tol` (norm-wise relative)."""
    for k in ("iterations", "converged"):
        np.testing.assert_array_equal(np_of(getattr(got, k)),
                                      np_of(getattr(want, k)),
                                      err_msg=f"{where}: {k}")
    errs = {f: max_rel_err(getattr(got, f), getattr(want, f)) for f in fields}
    assert max(errs.values()) < tol, (where, errs)
    return errs


def solve_results(topology, integrator, ns=8, B=4, seed=0,
                  jax_solve_batch=False, vmap_solve=True, **overrides):
    """One topology under one step at ns nodes, float64 on the CPU, from
    pushed starts (0.02·N(0,1)) with a commanded terminal velocity: the
    port's `solve` (member 0) and `solve_batch` beside JAX's `solve` and
    (with `vmap_solve`) `vmap(solve)`, and, asked, JAX's `solve_batch`;
    both packages with max_iters=20 and `overrides` (an execution mode, a
    gain solve), and a `ModesSpy` on the port's solver ("spy"). JAX's
    `vmap(solve)` batches the jitted `solve`, whose trace it reuses (the
    same program: XLA inlines the call). Under a mode JAX's `solve_batch`
    is its `vmap(solve)` (msddp.py:1214), so that one result serves both
    keys."""
    jp, tp = srbd_problems(topology, integrator, ns)
    js, ts = solvers(jp, tp, **dict(dict(max_iters=20), **overrides))
    x0 = perturbed_states(jp.initial_state, B, seed=seed, scale=0.02)
    params = fleet_params(jp.ocp.params, B)
    params["rdot_ref"][:, -1] = [0.2, 0.0, 0.0]
    jx0, jpar = to_jax(x0), to_jax(params)
    j0 = jax.vmap(js.init)(jx0)
    one = lambda t: {k: v[0] for k, v in t.items()}
    moded = (js.opts.riccati_mode, js.opts.forward_pass) != ("sequential",
                                                             "nonlinear")
    jsolve = jax.jit(js.solve)
    out = dict(jax_solve=jit(jsolve)(js.init(jx0[0]), jx0[0], one(jpar)))
    if vmap_solve or moded:
        out["jax_vmap_solve"] = jit(jax.vmap(jsolve))(j0, jx0, jpar)
    if moded:
        out["jax_solve_batch"] = out["jax_vmap_solve"]
    elif jax_solve_batch:
        out["jax_solve_batch"] = jit(js.solve_batch)(j0, jx0, jpar)
    tx0, tpar = to_torch(x0), to_torch(params)
    out["spy"] = ModesSpy(ts)
    out["solve"] = ts.solve(ts.init(tx0[0]), tx0[0], one(tpar))
    out["solve_batch"] = ts.solve_batch(ts.init(tx0), tx0, tpar)
    return out


def run_results(topology, integrator, ns=8, T=8, start=2, vx=0.3):
    """`MPCLoop.run` of the port's loop beside JAX's over T ticks of
    `walking_schedule(vx, start)`, one robot from the nominal state,
    float64 on the CPU, the dsrbd example's options: ((torch carry, torch
    outputs), (jax carry, jax outputs))."""
    jp, jloop, tloop, tp = srbd_loops(
        topology, integrator, ns, max_iters=100,
        alpha_converge_threshold=1e-12, beta=1e-3)
    x0 = np.array(jp.initial_state)
    jc, jo = jit(jloop.run)(jloop.init(jnp.asarray(x0)),
                            j_walking(T, vx=vx, start=start,
                                      dtype=jnp.float64))
    tc, to = tloop.run(tloop.init(torch.as_tensor(x0)),
                       t_walking(T, vx=vx, start=start, dtype=F64,
                                 device=CPU))
    return (tc, to), (jc, jo)



def jax_trial_fn(js):
    """JAX's line-search trial as a traceable function of (x0, X, U,
    params, ks, Ks, d, dV1, dV2, alphas): for every α the rollout
    (`_rollout`), `total_cost` and the Armijo test of msddp.py:843-853.
    It returns (Xn, Un, cost, merit, ok) and the merit0 and D it tested
    against."""
    opts = js.opts

    def trials(x0, X, U, params, ks, Ks, d, dV1, dV2, alphas):
        nu_w = jnp.asarray(opts.defect_weight, jnp.float64)
        D = jnp.sum(d * d, axis=(1, 2))

        def one(a, merit0):
            Xn, Un = jax.vmap(
                lambda x0_, X_, U_, k_, K_, d_, p_: js._rollout(
                    x0_, X_, U_, k_, K_, d_, p_, a))(x0, X, U, ks, Ks, d,
                                                     params)
            new_cost = jax.vmap(js.total_cost)(Xn, Un, params)
            new_merit = new_cost + nu_w * (1.0 - a) ** 2 * D
            expected = -(a * dV1 + a**2 * dV2) + (2.0 * a - a**2) * nu_w * D
            ok = (((merit0 - new_merit)
                   >= opts.beta * jnp.maximum(expected, 1e-16))
                  & jnp.isfinite(new_merit)
                  & (a >= opts.alpha_converge_threshold))
            return Xn, Un, new_cost, new_merit, ok

        # merit0 in the same trace: JAX's op-by-op dispatch of `total_cost`
        # would compile each of its primitives on its own
        merit0 = jax.vmap(js.total_cost)(X, U, params) + nu_w * D
        return jax.vmap(one, in_axes=(0, None))(alphas, merit0), merit0, D

    return trials


def jax_trial(js, x0, X, U, params, ks, Ks, d, dV1, dV2, alphas):
    """JAX's line-search trial (`jax_trial_fn`) for every α of `alphas`, on
    numpy inputs. Returns (Xn, Un, cost, merit, ok) and the merit0 and D
    it tested against."""
    x0, X, U, params = to_jax((x0, X, U, params))
    ks, Ks, d, dV1, dV2 = (jnp.asarray(np_of(v)) for v in (ks, Ks, d, dV1, dV2))
    return jit(jax_trial_fn(js))(x0, X, U, params, ks, Ks, d, dV1, dV2,
                                 jnp.asarray(alphas))


def jax_evaluate_fn(js):
    """JAX's `vmap(total_cost)` and the largest |·| of `vmap(_true_defects)`
    of each plan, as a traceable function of (X, U, params)."""
    def run(X_, U_, p_):
        cost = jax.vmap(js.total_cost)(X_, U_, p_)
        defects = jax.vmap(js._true_defects)(X_, U_, p_)
        return cost, jnp.max(jnp.abs(defects), axis=(1, 2))

    return run


def jax_evaluate(js, X, U, params):
    """`jax_evaluate_fn` on numpy inputs."""
    return jit(jax_evaluate_fn(js))(*to_jax((X, U, params)))


# ---------------- the execution modes' kernels at every SRBD shape ----------

from srbd_horizon_tpu_torch.kernels import linear_trial as t_k13
from srbd_horizon_tpu_torch.kernels import riccati as t_k1
from srbd_horizon_tpu_torch.kernels import riccati_associative as t_k12

SWEEP_ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
SWEEP_MU = 1e-6
TRIAL_ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])


def jax_linear_trials(js, x0, X, U, ks, Ks, lin, params, D, dV1, dV2):
    """`_parallel_line_search`'s trial under forward_pass="linear"
    (msddp.py:1507-1531), vmapped over the step sizes, from the JAX
    solver's own methods (`_forward_linear`, `_true_defects`,
    `total_cost`, the Armijo test): a jitted function of (alphas, merit0)."""
    opts = js.opts
    nu = jnp.asarray(opts.defect_weight, X.dtype)

    def trial(a, merit0):
        Xn, Un = js._forward_linear(x0, X, U, ks, Ks, lin, params, a)
        dn = js._true_defects(Xn, Un, params)
        D_new = jnp.sum(dn * dn)
        new_cost = js.total_cost(Xn, Un, params)
        new_merit = new_cost + nu * D_new
        expected = -(a * dV1 + a**2 * dV2) + (2.0 * a - a**2) * nu * D
        ok = (
            ((merit0 - new_merit) >= opts.beta * jnp.maximum(expected, 1e-16))
            & jnp.isfinite(new_merit)
            & (a >= opts.alpha_converge_threshold)
        )
        return Xn, Un, new_cost, new_merit, ok

    return jit(jax.vmap(trial, in_axes=(0, None)))


def jax_dense_lin(lin, rows, nr, nu):
    """JAX's dense linearization (`MSDDP._linearize_impl`'s keys, one
    member, numpy) holding the port's sliced one `lin` (batch of 1):
    A = I + Sx on the rows rx, B = Bs on the rows ru and the inputs uc, the
    residual Jacobians' rows gx / gu, zeros elsewhere — the exact zeros
    JAX's own jacfwd holds off the declared rows."""
    Sx, Bs, Jxp, Jup, rho, d, Jt, rt = (np_of(lin[k][0]) for k in SWEEP_ORDER)
    ns, _, nx = Sx.shape
    A = np.broadcast_to(np.eye(nx), (ns, nx, nx)).copy()
    A[:, list(rows.rx)] += Sx
    B = np.zeros((ns, nx, nu))
    r, c = np.ix_(rows.ru, rows.uc)
    B[:, r, c] = Bs
    Jx = np.zeros((ns, nr, nx))
    Jx[:, list(rows.gx)] = Jxp
    Ju = np.zeros((ns, nr, nu))
    Ju[:, list(rows.gu)] = Jup
    return to_jax(dict(A=A, B=B, Jx=Jx, Ju=Ju, rho=rho, rt=rt, Jt=Jt, d=d))


def modes_kernel_results(topology, integrator, parts=("k12", "k1", "k13"),
                         ns=8, seed=41):
    """The execution modes' kernels at one SRBD topology under one step, at
    a drawn iterate (X ± 0.05·N around the initial state, U ± 0.1·N around
    the static input, ns nodes, float64, CPU), the port's sliced
    linearization of it handed to both packages (JAX's dense form:
    `jax_dense_lin`; the K4 twin is held to JAX's jacfwd in
    tests/test_torch_srbd_integrators.py), each JAX function of `parts`
    compiled once: "k12", JAX's `_backward_associative` with each gain
    solve beside K12's twin; "k1", JAX's `_backward` with Cholesky gains
    beside K1's Tassa-Cholesky twin; "k13", JAX's linear trial
    (`jax_linear_trials`, 4 step sizes, on the gains of K12's block-Schur
    twin, from the iterate's merit and from one between the merits of
    α = 1/2 and 1/4) beside K13's twin."""
    jp, tp = srbd_problems(topology, integrator, ns)
    rng = np.random.RandomState(seed)
    nx, nu = jp.ocp.nx, jp.ocp.nu
    X = np.asarray(jp.initial_state)[None] + 0.05 * rng.randn(ns + 1, nx)
    U = np.asarray(jp.static_input)[None] + 0.1 * rng.randn(ns, nu)
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    x0 = X[0] + 0.01 * rng.randn(nx)
    pair = {sv: solvers(jp, tp, quu_solver=sv) for sv in ("schur", "cholesky")}
    js, ts = pair["schur"]
    jX, jU, jpar = to_jax((X, U, params))
    p1 = {k: v[None] for k, v in to_torch(params).items()}
    lin = ts._linearize_sliced(to_torch(X)[None], to_torch(U)[None], p1)
    jlin = jax_dense_lin(lin, ts.rows, lin["rho"].shape[-1], nu)
    args = tuple(lin[k] for k in SWEEP_ORDER)
    out = dict(jp=jp, tp=tp, ts=ts, jlin=jlin, lin=lin,
               k1_shape=t_k1.kernel_shape(nx, nu, lin["Jt"].shape[1], ts.rows))
    twins = {sv: t_k12.riccati_associative_plain(*args, SWEEP_MU, ts.rows, sv)
             for sv in pair}
    if "k12" in parts:
        for sv, (jsv, _) in pair.items():
            want = jit(jsv._backward_associative)(jlin,
                                                  jnp.asarray(SWEEP_MU))
            out["k12", sv] = (tuple(w[None] for w in want), twins[sv])
    if "k1" in parts:
        jc, tc = pair["cholesky"]
        want = jit(jc._backward)(jlin, jnp.asarray(SWEEP_MU))
        out["k1_cholesky"] = (tuple(w[None] for w in want),
                              tc._backward(lin, SWEEP_MU))
    if "k13" in parts:
        ks, Ks, dV1, dV2 = (np_of(t[0]) for t in twins["schur"])
        D = jnp.sum(jlin["d"] * jlin["d"])
        merit0 = (jit(js.total_cost)(jX, jU, jpar)
                  + js.opts.defect_weight * D)
        jtrial = jax_linear_trials(js, to_jax(x0), jX, jU, *to_jax(
            (ks, Ks)), jlin, jpar, D, *to_jax((dV1, dV2)))
        jres = jtrial(jnp.asarray(TRIAL_ALPHAS), merit0)
        merit_mid = 0.5 * (jres[3][1] + jres[3][2])
        t1 = lambda a: to_torch(np_of(a))[None]
        trial_args = lambda m0: (
            t1(x0), t1(X), t1(U), t1(ks), t1(Ks), lin["Sx"], lin["Bs"],
            lin["d"], to_torch(TRIAL_ALPHAS), p1, t1(m0), t1(D), t1(dV1),
            t1(dV2), ts.terms, ts.rows, ts.ocp.dt, ts._wc(F64),
            ts.opts.defect_weight, ts.opts.beta,
            ts.opts.alpha_converge_threshold)
        out["k13_args"] = trial_args(merit0)
        out["k13", "iterate"] = (jres,
                                 t_k13.linear_trial_plain(*out["k13_args"]))
        out["k13", "mid"] = (jtrial(jnp.asarray(TRIAL_ALPHAS), merit_mid),
                             t_k13.linear_trial_plain(*trial_args(merit_mid)))
    return out


def modes_dispatch(topology, integrator):
    """At one SRBD topology under one step (ns=8, CPU): `MSDDP` builds under
    every non-default mode with each gain solve; returns K13's family
    index and K12's instance indices by gain solve."""
    _, tp = srbd_problems(topology, integrator, ns=8)
    ocp = tp.ocp
    for mode in MODES:
        for sv in ("schur", "cholesky"):
            TMSDDP(ocp, TDDPOptions(quu_solver=sv, **modes(*mode)))
    s = TMSDDP(ocp, TDDPOptions())
    fam = t_k13.family_index(s.terms, ocp.nx, ocp.nu, s.rows)
    shape = t_k13.FAMILIES[fam][2]
    return fam, {sv: t_k12.shape_instance(shape, sv)
                 for sv in ("schur", "cholesky")}


def check_k12(res, quu_solver):
    """K12's twin against JAX's `_backward_associative`: ks, Ks, ΔV₁, ΔV₂
    entry by entry to 1e-9 of max(1, |JAX|), and norm-wise to 1e-9."""
    want, got = res["k12", quu_solver]
    for name, g, w in zip(("ks", "Ks", "dV1", "dV2"), got, want):
        g, w = np_of(g), np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.max(np.abs(g - w) / np.maximum(1.0, np.abs(w))))
        assert err <= 1e-9, (name, err)
        assert max_rel_err(g, w) <= 1e-9, name


def check_k1_cholesky(res):
    """K1's Tassa-Cholesky twin against JAX's `_backward` with
    quu_solver="cholesky", to 1e-10 (tests/test_torch_riccati_tassa.py)."""
    want, got = res["k1_cholesky"]
    for name, g, w in zip(("ks", "Ks", "dV1", "dV2"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert max_rel_err(g, w) < 1e-10, name


def check_k13(res, merit0):
    """K13's twin against JAX's linear trial at one merit0 ("iterate" or
    "mid"): plans, cost and merit to 1e-9, the flags equal."""
    want, got = res["k13", merit0]
    for name, g, w in zip(("Xn", "Un", "cost", "merit"), got, want):
        g, w = np_of(g)[:, 0], np.asarray(w)
        assert g.shape == w.shape, name
        assert max_rel_err(g, w) < 1e-9, (name, max_rel_err(g, w))
    np.testing.assert_array_equal(np_of(got[4])[:, 0], np.asarray(want[4]))


def check_mode_solves(s, mode):
    """`solve_results` under a mode: the port's `solve` against JAX's and
    its `solve_batch` against JAX's `solve_batch` (`vmap(solve)`):
    iterations and convergence equal, X, U and cost to 1e-9, the final
    defect to 1e-12; the solver's K12/K1/K13 calls as `ModesSpy.check`
    expects under a mode (under the default ones `solve_batch` runs the
    collapsed sweep, which the spy does not count)."""
    agree(s["solve"], s["jax_solve"], "solve", ("X", "U", "cost"))
    assert abs(float(s["solve"].defect_norm)
               - float(s["jax_solve"].defect_norm)) < 1e-12
    agree(s["solve_batch"], s["jax_solve_batch"], "solve_batch",
          ("X", "U", "cost"))
    np.testing.assert_allclose(np_of(s["solve_batch"].defect_norm),
                               np_of(s["jax_solve_batch"].defect_norm),
                               rtol=0, atol=1e-12)
    if mode != ("sequential", "nonlinear"):
        s["spy"].check(mode)


def check_dense_dynamics(res):
    """The twins' dense A = I + Sx on rx and B = Bs on (ru, uc)
    (`riccati_associative.dense_dynamics`, which K12's and K13's twins
    build) equal to the scatter JAX's functions were handed, and B live in
    rows Euler's step leaves dead (the rows the JAX builder declares under
    every step, F10): under RK every row of B comes from the sliced
    linearization."""
    lin, rows = res["lin"], res["ts"].rows
    A, Bd = t_k12.dense_dynamics(lin["Sx"], lin["Bs"], rows,
                                 res["tp"].ocp.nu)
    np.testing.assert_array_equal(np_of(A[0]), np.asarray(res["jlin"]["A"]))
    np.testing.assert_array_equal(np_of(Bd[0]), np.asarray(res["jlin"]["B"]))
    dead = sorted(set(range(A.shape[-1]))
                  - {int(r) for r in res["jp"].ocp.dynamics_u_rows})
    assert dead and float(Bd[0][:, dead].abs().max()) > 1e-6


def euler_defects_miss(res, monkeypatch):
    """K13's twin with an Euler step in its true defects: its merits' gap
    to JAX's (relative), and its defect term's (merit − cost). Under RK
    both are far above the 1e-9 `check_k13` holds the twin to."""
    jres = res["k13", "iterate"][0]
    euler = lambda terms, dt: (lambda x, u, f=t_k13.family_xdot(terms):
                               x + dt * f(x, u))
    monkeypatch.setattr(t_k13, "family_step", euler)
    got = t_k13.linear_trial_plain(*res["k13_args"])
    merit, cost = np_of(got[3])[:, 0], np_of(got[2])[:, 0]
    want_merit, want_cost = np.asarray(jres[3]), np.asarray(jres[2])
    return (max_rel_err(merit, want_merit),
            max_rel_err(merit - cost, want_merit - want_cost))


def six_contact_srbd(integrator="EULER"):
    """The port's SRBD problem no K12/K13 kernel is compiled for: two legs
    of three contacts each (contact_model=3, nc=6: nx=49, nu=36), ns=4,
    under `integrator`, float64 on the CPU."""
    from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants

    line = t_feet()
    w = line.foot_positions[2, 1]
    feet = np.array([[0.08, 0.0, 0.0], [0.0, 0.0, 0.0], [-0.08, 0.0, 0.0],
                     [0.08, w, 0.0], [0.0, w, 0.0], [-0.08, w, 0.0]])
    robot = RobotConstants(mass=line.mass, inertia=line.inertia, com=line.com,
                           foot_positions=feet,
                           foot_frames=tuple(f"f{i}" for i in range(6)))
    return t_build(TSRBDConfig(dtype=F64, ns=4, contact_model=3), robot,
                   integrator=integrator, device=CPU)


# ---------------- the LIP at every topology and step ----------------

from srbd_horizon_tpu.problems.lip import build_lip_problem as j_build_lip

from srbd_horizon_tpu_torch.kernels import lip_linearize as t_k10
from srbd_horizon_tpu_torch.kernels import lip_rollout as t_k11
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem as t_build_lip
from srbd_horizon_tpu_torch.runtime.loop import build_lip_loop

LIP_NAN_MEMBER = 1
# F8 (ROADMAP Queue 3): the LIP's closed loop holds u0 and the plans to the
# merit's rounding floor, x and the cost to 1e-9
LIP_FLOOR_TOL = 1e-6


def lip_problems(topology="kangaroo", integrator="EULER", ns=20):
    """(jax LIPProblem, torch LIPProblem) of one topology (`TOPOLOGIES`)
    under one step, float64 on the CPU, on a horizon of ns nodes of
    0.05 s."""
    kw, jr, tr, _ = TOPOLOGIES[topology]
    shape = dict(ns=ns, T=0.05 * ns, **kw)
    jp = j_build_lip(JSRBDConfig(dtype=jnp.float64, **shape), jr(),
                     integrator=integrator)
    tp = t_build_lip(TSRBDConfig(dtype=F64, **shape), tr(),
                     integrator=integrator, device=CPU)
    return jp, tp


def lip_members(nc, lead, seed):
    """Numpy (x, u, p) of random LIP members: states around the nominal
    CoM height, random contacts and velocities, random references and 0/1
    switches and tracking masks."""
    rng = np.random.RandomState(seed)
    nx, nu = 6 + 6 * nc, 3 + 3 * nc
    x = rng.uniform(-0.3, 0.3, lead + (nx,))
    x[..., 2] += 0.88
    u = 0.3 * rng.randn(*lead, nu)
    p = dict(rdot_ref=0.3 * rng.randn(*lead, 3),
             c_ref=0.05 * np.abs(rng.randn(*lead, nc)),
             cdot_switch=rng.randint(0, 2, lead + (nc,)).astype(np.float64),
             mask_track=rng.randint(0, 2, lead + (1,)).astype(np.float64))
    return x, u, p


def lip_results(topology, integrator, ns=8, B=4, ticks=3):
    """One LIP topology under one step at ns nodes, float64 on the CPU: the
    port's node functions, K10, K11 (four α and one, a NaN start in member
    LIP_NAN_MEMBER) and lip_evaluate twins (a NaN in that member's plan;
    plain and pinned), `solve` (member 0) and `solve_batch` from pushed
    starts (0.02·N(0,1), a commanded terminal velocity, max_iters=20), and
    `tick_batch` of `build_lip_loop` (warm start shifted, mixed actions,
    the trot WPG on the quadruped) for `ticks` ticks with SOLVER_OPTS and
    with max_iters=1 (the exact Gauss–Newton step alone), beside the JAX
    package's: its node functions, dense `_linearize_impl`, trial (on the
    port's gains), `total_cost` and `_true_defects`, `solve`,
    `vmap(solve)` and `vmap(tick)`, all in one JAX compile."""
    jp, tp = lip_problems(topology, integrator, ns)
    js, ts = solvers(jp, tp, max_iters=20)
    nc = tp.nc
    dt, wc = tp.ocp.dt, ts._wc(F64)
    x, u, p = lip_members(nc, (16,), seed=1)
    # a plan near the walk, random references, switches and masks
    X, U = trajectories(jp, B, seed=31)
    params = fleet_params(jp.ocp.params, B)
    params.update(lip_members(nc, (B, ns + 1), seed=32)[2])
    lin = t_k10.lip_linearize_plain(to_torch(X), to_torch(U),
                                    to_torch(params), ts.terms, ts.rows, dt,
                                    wc)
    ks, Ks, dV1, dV2 = t_k1.riccati_backward_plain(
        *(lin[k] for k in SWEEP_ORDER), SWEEP_MU, ts.rows)
    x0 = perturbed_states(jp.initial_state, B, seed=33)
    x0[LIP_NAN_MEMBER] = np.nan
    Xe = X.copy()
    Xe[LIP_NAN_MEMBER, 5, 4] = np.nan
    Xp = Xe.copy()
    Xp[:, 0] = perturbed_states(jp.initial_state, B, seed=34)
    # the solves
    sx0 = perturbed_states(jp.initial_state, B, seed=0, scale=0.02)
    sparams = fleet_params(jp.ocp.params, B)
    sparams["rdot_ref"][:, -1] = [0.2, 0.0, 0.0]
    # the loops: the solver's options, and the exact step alone
    kw, jr, tr, mask = TOPOLOGIES[topology]
    loop_opts = dict(options=SOLVER_OPTS,
                     exact_step=dict(SOLVER_OPTS, max_iters=1))
    jloops = {k: JMPCLoop(
        solver=JMSDDP(jp.ocp, JDDPOptions(**o)),
        wpg=JWPG.build(c_init_z=float(jp.initial_foot_position[0, 2]),
                       nodes=ns, dtype=jnp.float64,
                       group_mask=mask, **kw),
        shift_warmstart=True) for k, o in loop_opts.items()}
    tloops = {k: build_lip_loop(
        TSRBDConfig(dtype=F64, ns=ns, T=0.05 * ns, **kw),
        TDDPOptions(**o), robot=tr(), shift_warmstart=True,
        device=CPU, group_mask=mask,
        integrator=integrator)[0] for k, o in loop_opts.items()}
    lx0 = perturbed_states(jp.initial_state, B, seed=7)
    actions = np.array([0, 1, 1, 1], np.int32)[:B]
    rdot = np.tile([0.2, 0.0, 0.0], (B, 1))
    jinp = JTickInput(action=jnp.asarray(actions), rdot_ref=jnp.asarray(rdot),
                      w_ref=jnp.zeros((B, 3)))

    trials, evaluate = jax_trial_fn(js), jax_evaluate_fn(js)
    jsolve = jax.jit(js.solve)
    one = lambda t: {k: v[0] for k, v in t.items()}

    def run(x, u, p, X, U, params, ks, Ks, dV1, dV2, x0, Xe, Xp, sx0, sparams,
            lx0, alphas):
        out = dict(
            step=jax.vmap(lambda a, b, c: jp.ocp.step(a, b, c, dt))(x, u, p),
            rho=jax.vmap(js._stage_rho)(x, u, p),
            rt=jax.vmap(jp.ocp.terminal_residual)(x, p),
            dense=jax.vmap(lambda a, b, c: js._linearize_impl(
                a, b, c, sliced=False))(X, U, params))
        out["trial"] = trials(x0, X, U, params, ks, Ks, out["dense"]["d"],
                              dV1, dV2, alphas)
        out["evaluate"] = evaluate(Xe, U, params)
        out["evaluate_pinned"] = evaluate(Xp, U, params)
        out["solve"] = jsolve(js.init(sx0[0]), sx0[0], one(sparams))
        out["vmap_solve"] = jax.vmap(jsolve)(jax.vmap(js.init)(sx0), sx0,
                                             sparams)
        for k, jloop in jloops.items():
            tick = jax.vmap(jloop.tick)
            out[f"ticks_{k}"] = jax.lax.scan(
                lambda c, _: tick(c, jinp), jax.vmap(jloop.init)(lx0), None,
                length=ticks)
        return out

    j = jit(run)(*to_jax((x, u, p, X, U, params)),
                 *(jnp.asarray(np_of(v)) for v in (ks, Ks, dV1, dV2)),
                 *to_jax((x0, Xe, Xp, sx0, sparams, lx0, TRIAL_ALPHAS)))
    t = lambda a: to_torch(np_of(a))
    trial_args = (t(x0), to_torch(X), to_torch(U), ks, Ks, lin["d"])
    merit0, D = t(j["trial"][1]), t(j["trial"][2])
    opts = ts.opts
    port = dict(
        step=tp.ocp.step(to_torch(x), to_torch(u), to_torch(p), dt),
        rho=ts._stage_rho(to_torch(x), to_torch(u), to_torch(p)),
        rt=tp.ocp.terminal_residual(to_torch(x), to_torch(p)),
        lin=lin,
        trial={nA: t_k11.lip_trial_plain(
            *trial_args, to_torch(TRIAL_ALPHAS[:nA]), to_torch(params),
            merit0, D, dV1, dV2, ts.terms, dt, wc, opts.defect_weight,
            opts.beta, opts.alpha_converge_threshold) for nA in (1, 4)},
        evaluate=t_k11.lip_evaluate_plain(to_torch(Xe), to_torch(U),
                                          to_torch(params), ts.terms, dt, wc),
        evaluate_pinned=t_k11.lip_evaluate_plain(
            to_torch(Xe), to_torch(U), to_torch(params), ts.terms, dt, wc,
            to_torch(Xp[:, 0])))
    tx0, tpar = to_torch(sx0), to_torch(sparams)
    port["solve"] = ts.solve(ts.init(tx0[0]), tx0[0], one(tpar))
    port["solve_batch"] = ts.solve_batch(ts.init(tx0), tx0, tpar)
    tinp = tick_input_from_numpy(actions, rdot, np.zeros((B, 3)), device=CPU,
                                 dtype=F64)
    for k, tloop in tloops.items():
        tc, outs = tloop.init(torch.as_tensor(lx0)), []
        for _ in range(ticks):
            tc, to = tloop.tick_batch(tc, tinp)
            outs.append(to)
        port[f"ticks_{k}"] = (tc, outs)
    return dict(jp=jp, tp=tp, js=js, ts=ts, jax=j, port=port, X=X, U=U,
                params=params, Xp=Xp)



def check_lip_nodes(r, tol=1e-12):
    """The build (sizes, layouts, x0, u0, params) equal, and the step, ρ
    and the terminal residual at 16 random members to `tol`."""
    jp, tp = r["jp"], r["tp"]
    jo, to = jp.ocp, tp.ocp
    assert (to.ns, to.nx, to.nu, to.dt) == (jo.ns, jo.nx, jo.nu, jo.dt)
    assert to.state_layout.names == jo.state_layout.names
    np.testing.assert_array_equal(np_of(tp.initial_state),
                                  np.asarray(jp.initial_state))
    np.testing.assert_array_equal(np_of(tp.static_input),
                                  np.asarray(jp.static_input))
    for k, v in jo.params.items():
        np.testing.assert_array_equal(np_of(to.params[k]), np.asarray(v))
    for key in ("step", "rho", "rt"):
        got, want = r["port"][key], r["jax"][key]
        assert tuple(got.shape) == want.shape, key
        assert max_rel_err(got, want) < tol, key


def check_lip_rows(r, seed=3):
    """The declared rows are exact at a member with mask and switches 1:
    every nonzero of ∂ρ/∂x, ∂ρ/∂u, A − I and B (`torch.func.jacfwd` of the
    port's ρ and step) lies in them and every declared row has one; every
    input drives the step; under RK2 and RK4 B's rows are all nx rows, A −
    I's Euler's."""
    tp, ts = r["tp"], r["ts"]
    ocp, rows = tp.ocp, ts.rows
    x, u, p = lip_members(tp.nc, (), seed)
    p["cdot_switch"][:] = 1.0
    p["mask_track"][:] = 1.0
    x, u, p = to_torch(x), to_torch(u), to_torch(p)
    jac = torch.func.jacfwd
    rho = lambda a, b: ts._stage_rho(a, b, p)
    step = lambda a, b: ocp.step(a, b, p, ocp.dt)
    eye = torch.eye(ocp.nx, dtype=F64)
    for J, live in ((jac(rho, 0)(x, u), rows.gx), (jac(rho, 1)(x, u), rows.gu),
                    (jac(step, 0)(x, u) - eye, rows.rx),
                    (jac(step, 1)(x, u), rows.ru)):
        dead = [i for i in range(J.shape[0]) if i not in live]
        assert bool((J[dead] == 0).all())
        assert bool((J[list(live)] != 0).any(dim=1).all())
    assert rows.rx == tuple(range(6 + 3 * tp.nc))
    euler = ts.terms.step == "EULER"
    assert rows.ru == tuple(range(3 + 3 * tp.nc if euler else 0, ocp.nx))
    assert len(rows.uc) == ocp.nu


def check_lip_linearize(r, key, tol=1e-12):
    """K10's twin against JAX's dense jacfwd linearization, sliced by the
    port's rows: Sx = (A − I)[rx], Bs = B[ru], Jxp = Jx[gx], Jup = Ju[gu],
    ρ, the step's defects, the terminal residual and its Jacobian."""
    rows, jd, nx = r["ts"].rows, r["jax"]["dense"], r["tp"].ocp.nx
    want = {"Sx": (np.asarray(jd["A"]) - np.eye(nx))[:, :, list(rows.rx)],
            "Bs": np.asarray(jd["B"])[:, :, list(rows.ru)],
            "Jxp": np.asarray(jd["Jx"])[:, :, list(rows.gx)],
            "Jup": np.asarray(jd["Ju"])[:, :, list(rows.gu)]}.get(key)
    want = np.asarray(jd[key]) if want is None else want
    got = r["port"]["lin"][key]
    assert tuple(got.shape) == want.shape
    assert max_rel_err(got, want) < tol


def check_lip_trial(r, nA, tol=1e-12):
    """K11's twin against JAX's trial at the first nA step sizes: Xn, Un,
    cost and merit to `tol` (the NaN member NaN in both), the flags equal,
    the NaN member rejected."""
    got, want = r["port"]["trial"][nA], r["jax"]["trial"][0]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(np_of(g), np.asarray(w)[:nA], rtol=tol,
                                   atol=tol)
    np.testing.assert_array_equal(np_of(got[4]), np.asarray(want[4])[:nA])
    assert not bool(got[4][:, LIP_NAN_MEMBER].any())


def check_lip_evaluate(r, pinned, tol=1e-12):
    """lip_evaluate's twin against JAX's `total_cost` and the largest |·| of
    `_true_defects` to `tol` of max(1, |JAX's|), the NaN member NaN; pinned,
    the plan with node 0 replaced, exactly."""
    key = "evaluate_pinned" if pinned else "evaluate"
    got, want = r["port"][key], r["jax"][key]
    for g, w in zip(got[:2], want):
        g, w = np_of(g), np.asarray(w)
        assert np.isnan(g[LIP_NAN_MEMBER]) and np.isnan(w[LIP_NAN_MEMBER])
        ok = ~np.isnan(w)
        assert np.all(np.abs(g[ok] - w[ok]) <= tol * np.maximum(1.0,
                                                               np.abs(w[ok])))
    if pinned:
        np.testing.assert_array_equal(np_of(got[2]), r["Xp"])


def check_lip_solves(r, tol=1e-9):
    """`solve` against JAX's `solve`, `solve_batch` against its
    `vmap(solve)`: iterations and convergence equal, the cost to `tol`, the
    defects closed; the single solve's plans to `tol`, the batched plans to
    the merit's rounding floor (LIP_FLOOR_TOL, F8: a second iteration's
    accept at the floor can flip with the order of sums)."""
    p, j = r["port"], r["jax"]
    agree(p["solve"], j["solve"], "solve", ("X", "U", "cost"), tol)
    agree(p["solve_batch"], j["vmap_solve"], "solve_batch", ("cost",), tol)
    agree(p["solve_batch"], j["vmap_solve"], "solve_batch", ("X", "U"),
          LIP_FLOOR_TOL)
    assert int(p["solve"].iterations) > 1
    assert float(p["solve_batch"].defect_norm.max()) < 1e-6


def check_lip_ticks(r, exact, tol=1e-9):
    """`tick_batch` of `build_lip_loop` against JAX's `vmap(tick)`, tick by
    tick: iterations and convergence equal. With the exact step alone
    (`exact`, max_iters=1: no floor step) the cost, x, u0 and the final
    plans to `tol`. With the solver's options by F8's floor rule: the first
    tick's cost to `tol` (both start from the same state), and the cost,
    x, u0 and the final plans to LIP_FLOOR_TOL (the floor steps move u0,
    the self-simulation carries them into x and the next ticks' starts)."""
    key = "ticks_exact_step" if exact else "ticks_options"
    (jc, jo), (tc, outs) = r["jax"][key], r["port"][key]
    floor = tol if exact else LIP_FLOOR_TOL
    for i, to in enumerate(outs):
        want = types.SimpleNamespace(**{f: np.asarray(getattr(jo, f))[i]
                                        for f in jo._fields})
        agree(to, want, f"tick {i}", ("cost",), tol if i == 0 else floor)
        agree(to, want, f"tick {i}", ("x", "u0"), floor)
    for f in ("X", "U"):
        assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < floor, f


# ---------------- the execution modes at every LIP topology and step --------

LINEAR = ("associative", "linear")


def lip_modes_results(topology, integrator, quu_solver, parts=("k12", "k13"),
                      single=None, ns=8, B=4, ticks=3, seed=41):
    """The execution modes at one LIP topology under one step, float64 on
    the CPU, beside the JAX package, in one JAX compile:

      - the kernels at a drawn iterate (X ± 0.05·N around the initial state,
        U ± 0.1·N around the static input, random references, switches and
        tracking masks), the port's sliced linearization handed to both
        (`jax_dense_lin`): with "k12" in `parts` JAX's
        `_backward_associative` with each gain solve beside K12's twin;
        with "k13" JAX's linear trial (`jax_linear_trials`' body, 4 step
        sizes, the gains of K12's block-Schur twin) from the iterate's
        merit and from one between the merits of α = 1/2 and 1/4 beside
        K13's twin, and K11's twin (the rollout trial) at the same gains
        and step sizes;
      - `solve` (member 0) and `solve_batch` (B members) from pushed starts
        (0.02·N(0,1), a commanded terminal velocity, max_iters=20) beside
        JAX's `solve` and `vmap(solve)`, and `tick_batch` of
        `build_lip_loop` (warm start shifted, mixed actions, the trot WPG
        on the quadruped) for `ticks` ticks with SOLVER_OPTS and with
        max_iters=1 beside JAX's `vmap(tick)`, under associative/linear
        with `quu_solver`; given `single` (a mode of MODES), the solves
        and the max_iters=1 ticks under that mode too; a `ModesSpy` on
        each port solver.

    The solves and ticks land under "port" / "jax" as `lip_results` lays
    them out (`check_lip_solves`, `check_lip_ticks`), with the single
    mode's under "port_single" / "jax_single"."""
    jp, tp = lip_problems(topology, integrator, ns)
    nc = tp.nc
    nx, nu = jp.ocp.nx, jp.ocp.nu
    rng = np.random.RandomState(seed)
    X = np.asarray(jp.initial_state)[None] + 0.05 * rng.randn(ns + 1, nx)
    U = np.asarray(jp.static_input)[None] + 0.1 * rng.randn(ns, nu)
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    params.update(lip_members(nc, (ns + 1,), seed + 1)[2])
    x0 = X[0] + 0.01 * rng.randn(nx)
    pair = {sv: solvers(jp, tp, quu_solver=sv) for sv in ("schur", "cholesky")}
    js, ts = pair["schur"]
    p1 = {k: v[None] for k, v in to_torch(params).items()}
    lin = ts._linearize_sliced(to_torch(X)[None], to_torch(U)[None], p1)
    jlin = jax_dense_lin(lin, ts.rows, lin["rho"].shape[-1], nu)
    args = tuple(lin[k] for k in SWEEP_ORDER)
    twins = {sv: t_k12.riccati_associative_plain(*args, SWEEP_MU, ts.rows, sv)
             for sv in pair}
    ks, Ks, dV1, dV2 = (np_of(t[0]) for t in twins["schur"])

    # the solves and the loops, under associative/linear and the single mode
    sx0 = perturbed_states(jp.initial_state, B, seed=0, scale=0.02)
    sparams = fleet_params(jp.ocp.params, B)
    sparams["rdot_ref"][:, -1] = [0.2, 0.0, 0.0]
    kw, jr, tr, mask = TOPOLOGIES[topology]
    lx0 = perturbed_states(jp.initial_state, B, seed=7)
    actions = np.array([0, 1, 1, 1], np.int32)[:B]
    rdot = np.tile([0.2, 0.0, 0.0], (B, 1))
    jinp = JTickInput(action=jnp.asarray(actions), rdot_ref=jnp.asarray(rdot),
                      w_ref=jnp.zeros((B, 3)))
    runs = {"": dict(modes(*LINEAR), quu_solver=quu_solver)}
    if single is not None:
        runs["_single"] = modes(*single)
    loop_opts = dict(options=SOLVER_OPTS,
                     exact_step=dict(SOLVER_OPTS, max_iters=1))
    jsolvers, jloops, tloops = {}, {}, {}
    run_loops = {"": tuple(loop_opts), "_single": ("exact_step",)}
    for r, mo in runs.items():
        jsolvers[r], _ = solvers(jp, tp, **dict(dict(max_iters=20), **mo))
        for k in run_loops[r]:
            o = loop_opts[k]
            jloops[r, k] = JMPCLoop(
                solver=JMSDDP(jp.ocp, JDDPOptions(**o, **mo)),
                wpg=JWPG.build(c_init_z=float(jp.initial_foot_position[0, 2]),
                               nodes=ns, dtype=jnp.float64,
                               group_mask=mask, **kw),
                shift_warmstart=True)
            tloops[r, k] = build_lip_loop(
                TSRBDConfig(dtype=F64, ns=ns, T=0.05 * ns, **kw),
                TDDPOptions(**o, **mo), robot=tr(), shift_warmstart=True,
                device=CPU, group_mask=mask,
                integrator=integrator)[0]
    one = lambda t: {k: v[0] for k, v in t.items()}
    opts = js.opts
    nu_w = opts.defect_weight

    def run(jlin, jx0, jX, jU, jpar, ks, Ks, dV1, dV2, alphas, sx0, sparams,
            lx0):
        out = {}
        if "k12" in parts:
            for sv, (jsv, _) in pair.items():
                out["k12_" + sv] = jsv._backward_associative(jlin, SWEEP_MU)
        if "k13" in parts:
            D = jnp.sum(jlin["d"] * jlin["d"])

            def trial(a, merit0):
                Xn, Un = js._forward_linear(jx0, jX, jU, ks, Ks, jlin, jpar, a)
                dn = js._true_defects(Xn, Un, jpar)
                new_cost = js.total_cost(Xn, Un, jpar)
                new_merit = new_cost + nu_w * jnp.sum(dn * dn)
                expected = (-(a * dV1 + a**2 * dV2)
                            + (2.0 * a - a**2) * nu_w * D)
                ok = (((merit0 - new_merit)
                       >= opts.beta * jnp.maximum(expected, 1e-16))
                      & jnp.isfinite(new_merit)
                      & (a >= opts.alpha_converge_threshold))
                return Xn, Un, new_cost, new_merit, ok

            trials = jax.vmap(trial, in_axes=(0, None))
            merit0 = js.total_cost(jX, jU, jpar) + nu_w * D
            out["merit0"], out["D"] = merit0, D
            out["k13_iterate"] = trials(alphas, merit0)
            mid = 0.5 * (out["k13_iterate"][3][1]
                         + out["k13_iterate"][3][2])
            out["merit_mid"] = mid
            out["k13_mid"] = trials(alphas, mid)
        for r, jsr in jsolvers.items():
            solve = jax.jit(jsr.solve)
            out["solve" + r] = solve(jsr.init(sx0[0]), sx0[0], one(sparams))
            out["vmap_solve" + r] = jax.vmap(solve)(jax.vmap(jsr.init)(sx0),
                                                     sx0, sparams)
            for k in run_loops[r]:
                tick = jax.vmap(jloops[r, k].tick)
                out[f"ticks_{k}{r}"] = jax.lax.scan(
                    lambda c, _: tick(c, jinp),
                    jax.vmap(jloops[r, k].init)(lx0), None, length=ticks)
        return out

    j = jit(run)(jlin, *to_jax((x0, X, U, params)),
                 *(jnp.asarray(v) for v in (ks, Ks, dV1, dV2)),
                 *to_jax((TRIAL_ALPHAS, sx0, sparams, lx0)))
    res = dict(jp=jp, tp=tp, ts=ts, lin=lin, twins=twins,
               k1_shape=t_k1.kernel_shape(nx, nu, lin["Jt"].shape[1],
                                          ts.rows))
    if "k12" in parts:
        for sv in pair:
            res["k12", sv] = (tuple(w[None] for w in j["k12_" + sv]),
                              twins[sv])
    if "k13" in parts:
        t1 = lambda a: to_torch(np_of(a))[None]
        D = t1(j["D"])

        def k13_args(m0):
            return (t1(x0), t1(X), t1(U), t1(ks), t1(Ks), lin["Sx"],
                    lin["Bs"], lin["d"], to_torch(TRIAL_ALPHAS), p1, t1(m0), D,
                    t1(dV1), t1(dV2), ts.terms, ts.rows, ts.ocp.dt,
                    ts._wc(F64), nu_w, opts.beta,
                    opts.alpha_converge_threshold)

        res["k13_args"] = k13_args(j["merit0"])
        for m0, key in ((j["merit0"], "iterate"), (j["merit_mid"], "mid")):
            res["k13", key] = (j["k13_" + key],
                               t_k13.linear_trial_plain(*k13_args(m0)))
        res["k11"] = t_k11.lip_trial_plain(
            t1(x0), t1(X), t1(U), t1(ks), t1(Ks), lin["d"],
            to_torch(TRIAL_ALPHAS), p1, t1(j["merit0"]), D, t1(dV1), t1(dV2),
            ts.terms, ts.ocp.dt, ts._wc(F64), nu_w, opts.beta,
            opts.alpha_converge_threshold)
    tx0, tpar = to_torch(sx0), to_torch(sparams)
    tinp = tick_input_from_numpy(actions, rdot, np.zeros((B, 3)), device=CPU,
                                 dtype=F64)
    for r, mo in runs.items():
        _, tsr = solvers(jp, tp, **dict(dict(max_iters=20), **mo))
        port = dict(spy=ModesSpy(tsr))
        port["solve"] = tsr.solve(tsr.init(tx0[0]), tx0[0], one(tpar))
        port["solve_batch"] = tsr.solve_batch(tsr.init(tx0), tx0, tpar)
        for k in run_loops[r]:
            tloop = tloops[r, k]
            port[f"spy_{k}"] = ModesSpy(tloop.solver)
            tc, outs = tloop.init(torch.as_tensor(lx0)), []
            for _ in range(ticks):
                tc, to = tloop.tick_batch(tc, tinp)
                outs.append(to)
            port[f"ticks_{k}"] = (tc, outs)
        res["port" + r] = port
        res["jax" + r] = dict(
            solve=j["solve" + r], vmap_solve=j["vmap_solve" + r],
            **{f"ticks_{k}": j[f"ticks_{k}{r}"] for k in run_loops[r]})
        res["mode" + r] = (mo["riccati_mode"], mo["forward_pass"])
    return res


def check_k13_is_k11(res, tol=1e-9):
    """The LIP's step is affine in (x, u), so the linear pass and the
    rollout (which leaves (1 − α)·d open) make the same plans: K13's twin
    against K11's twin at the same gains, step sizes and merit0 — plans,
    costs and merits to `tol` relative (K13's merit measures the defects
    the plan leaves, K11's takes (1 − α)²D), the flags equal. Returns the
    figures."""
    got, want = res["k13", "iterate"][1], res["k11"]
    errs = {name: max_rel_err(g, w) for name, g, w in
            zip(("Xn", "Un", "cost", "merit"), got, want)}
    assert max(errs.values()) < tol, errs
    np.testing.assert_array_equal(np_of(got[4]), np_of(want[4]))
    return errs


def check_lip_mode_runs(res, part, single=False):
    """The solves or the ticks of `lip_modes_results` under its mode (or
    under the single mode) against JAX: `part` "solves" by
    `check_lip_solves`, "exact_step" or "options" by `check_lip_ticks`;
    the port's K12 / K1 / K13 calls as `ModesSpy.check` expects under the
    mode, on the solves or on the loop."""
    r = "_single" if single else ""
    view = dict(port=res["port" + r], jax=res["jax" + r])
    if part == "solves":
        check_lip_solves(view)
        spy = "spy"
    else:
        check_lip_ticks(view, part == "exact_step")
        spy = "spy_" + part
    view["port"][spy].check(res["mode" + r])


def lip_modes_dispatch(topology, integrator):
    """At one LIP topology under one step (ns=8, CPU): `MSDDP` builds under
    every non-default mode with each gain solve; returns K13's family
    index and K12's instance indices by gain solve."""
    _, tp = lip_problems(topology, integrator, ns=8)
    ocp = tp.ocp
    for mode in MODES:
        for sv in ("schur", "cholesky"):
            TMSDDP(ocp, TDDPOptions(quu_solver=sv, **modes(*mode)))
    s = TMSDDP(ocp, TDDPOptions())
    fam = t_k13.family_index(s.terms, ocp.nx, ocp.nu, s.rows)
    shape = t_k13.FAMILIES[fam][2]
    return fam, {sv: t_k12.shape_instance(shape, sv)
                 for sv in ("schur", "cholesky")}


# ------------- the eight-contact robots (square feet, line-feet quadruped) -------------

from srbd_horizon_tpu_torch.kernels import linearize as t_k4
from srbd_horizon_tpu_torch.kernels import riccati as t_k1
from srbd_horizon_tpu_torch.kernels import rollout as t_k3

SRBD_ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
SRBD_NAN_MEMBER = 1
SRBD_ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])
# JAX's TestNc8 bar (tests/test_configs.py): defects below 1e-6 and each
# contact's F_z within 0.05 of m·g / (fs·8)
NC8_DEFECT, NC8_FZ_TOL = 1e-6, 0.05


def srbd_case(topology, step, ns=8, B=4, mu=1e-6, ticks=3, kernels=True,
              jax_solve_batch=False):
    """One (topology, step) of the SRBD problem at ns nodes, float64 on the
    CPU, beside the JAX package's, all of JAX's side in one compile:

      - with `kernels`, the node functions (step, stage residual, equality
        rows, terminal residual) at six drawn points, and at a point near
        the walk (plans around the nominal state, random references, 0/1
        switches and tracking masks) JAX's dense linearization, its trial
        at the four SRBD_ALPHAS on the port's collapsed sweep of its K4
        twin's linearization (member SRBD_NAN_MEMBER from a NaN state), its
        `total_cost` and `_true_defects` of a plan with a NaN (plain and
        with node 0 pinned to the pushed starts);
      - `solve` (member 0) and `vmap(solve)` from pushed starts (0.02·N(0,1),
        a commanded terminal velocity, max_iters=20), as `solve_results`
        computes them, and, with `jax_solve_batch`, JAX's `solve_batch`;
      - `ticks` ticks of `vmap(tick)` of `srbd_loops` (warm start shifted,
        mixed actions, pushed starts 0.01·N(0,1)), scanned, with each
        tick's plans.

    The port's side: with `kernels` its K4 twin and sweep there; `solve`,
    `solve_batch` and `tick_batch` on the same inputs ("port")."""
    jp, tp = srbd_problems(topology, step, ns)
    js, ts = solvers(jp, tp)
    dt = tp.ocp.dt
    case = dict(topology=topology, step=step, jp=jp, tp=tp, js=js, ts=ts)
    kargs = ()
    if kernels:
        X, U = trajectories(jp, B, seed=31)
        params = fleet_params(jp.ocp.params, B)
        rng = np.random.RandomState(32)
        params["rdot_ref"] = 0.3 * rng.randn(*params["rdot_ref"].shape)
        params["cdot_switch"] = (rng.randint(0, 2, params["cdot_switch"].shape)
                                 * 1.0)
        params["mask_track"] = (rng.randint(0, 2, params["mask_track"].shape)
                                * 1.0)
        tlin = t_k4.srbd_linearize_plain(to_torch(X), to_torch(U),
                                         to_torch(params), ts.terms, ts.rows,
                                         dt, ts._wc(torch.float64))
        sweep = t_k1.riccati_backward_plain(*(tlin[k] for k in SRBD_ORDER),
                                            mu, ts.rows)
        x0 = perturbed_states(jp.initial_state, B, seed=33)
        nodes = random_xup(jp.ocp.params, tp.ocp.nx, tp.ocp.nu, 34, lead=(6,))
        tx0 = np.array(x0)
        tx0[SRBD_NAN_MEMBER] = np.nan
        Xe = np.array(X)
        Xe[SRBD_NAN_MEMBER, 5, 4] = np.nan
        Xp = Xe.copy()
        Xp[:, 0] = x0
        case.update(X=X, U=U, params=params, tlin=tlin, sweep=sweep, x0=x0,
                    nodes=nodes, trial_x0=tx0, Xe=Xe, Xp=Xp)
        kargs = (*to_jax(nodes), *to_jax((X, U, params)),
                 *(jnp.asarray(np_of(v)) for v in sweep),
                 *to_jax((tx0, Xe, Xp, SRBD_ALPHAS)))
    # the solves (solve_results' inputs) and the ticks
    js20, ts20 = solvers(jp, tp, max_iters=20)
    sx0 = perturbed_states(jp.initial_state, B, seed=0, scale=0.02)
    sparams = fleet_params(jp.ocp.params, B)
    sparams["rdot_ref"][:, -1] = [0.2, 0.0, 0.0]
    _, jloop, tloop, _ = srbd_loops(topology, step, ns, shift=True)
    lx0 = perturbed_states(jp.initial_state, B, seed=7)
    actions = np.array([0, 1, 1, 1], np.int32)[:B]
    rdot = np.tile([0.2, 0.0, 0.0], (B, 1))
    jinp = JTickInput(action=jnp.asarray(actions), rdot_ref=jnp.asarray(rdot),
                      w_ref=jnp.zeros((B, 3)))

    trials, evaluate = jax_trial_fn(js), jax_evaluate_fn(js)
    jsolve = jax.jit(js20.solve)
    jtick = jax.vmap(jloop.tick)
    one = lambda t: {k: v[0] for k, v in t.items()}

    def kernel_refs(nx_, nu_, np_, X_, U_, p_, ks, Ks, dV1, dV2, tx0_, Xe_,
                    Xp_, alphas):
        out = dict(
            step=jax.vmap(lambda a, b, c: jp.ocp.step(a, b, c, dt))(nx_, nu_,
                                                                    np_),
            stage_residual=jax.vmap(jp.ocp.stage_residual)(nx_, nu_, np_),
            stage_eq=jax.vmap(jp.ocp.stage_eq)(nx_, nu_, np_),
            terminal=jax.vmap(jp.ocp.terminal_residual)(nx_, np_),
            dense=jax.vmap(lambda x, u, p: js._linearize_impl(
                x, u, p, sliced=False))(X_, U_, p_))
        out["trial"] = trials(tx0_, X_, U_, p_, ks, Ks, out["dense"]["d"],
                              dV1, dV2, alphas)
        out["evaluate"] = evaluate(Xe_, U_, p_)
        out["evaluate_pinned"] = evaluate(Xp_, U_, p_)
        return out

    def run(sx0_, sp_, lx0_, *kargs_):
        out = kernel_refs(*kargs_) if kargs_ else {}
        j0 = jax.vmap(js20.init)(sx0_)
        out["solve"] = jsolve(js20.init(sx0_[0]), sx0_[0], one(sp_))
        out["vmap_solve"] = jax.vmap(jsolve)(j0, sx0_, sp_)
        if jax_solve_batch:
            out["solve_batch"] = js20.solve_batch(j0, sx0_, sp_)

        def tick(c, _):
            c, o = jtick(c, jinp)
            return c, (o, c.sol.X, c.sol.U)

        out["ticks"] = jax.lax.scan(tick, jax.vmap(jloop.init)(lx0_), None,
                                    length=ticks)[1]
        return out

    j = jit(run)(*to_jax((sx0, sparams, lx0)), *kargs)
    stx0, stp = to_torch(sx0), to_torch(sparams)
    port = dict(solve=ts20.solve(ts20.init(stx0[0]), stx0[0], one(stp)),
                solve_batch=ts20.solve_batch(ts20.init(stx0), stx0, stp))
    tinp = tick_input_from_numpy(actions, rdot, np.zeros((B, 3)), device=CPU,
                                 dtype=F64)
    tc, port["ticks"] = tloop.init(torch.as_tensor(lx0)), []
    for _ in range(ticks):
        tc, to = tloop.tick_batch(tc, tinp)
        port["ticks"].append((to, tc.sol.X, tc.sol.U))
    case.update(jax=j, port=port, jdense=j.get("dense"))
    return case


def check_srbd_node_functions(case, tol=1e-12):
    """The port's step, stage residual, equality rows and terminal residual
    against JAX's at the case's drawn points (the step to 1e-13)."""
    tp, j = case["tp"], case["jax"]
    tx, tu, tpar = (to_torch(v) for v in case["nodes"])
    dt = tp.ocp.dt
    assert max_rel_err(tp.ocp.step(tx, tu, tpar, dt), j["step"]) < 1e-13
    for fn in ("stage_residual", "stage_eq"):
        got = getattr(tp.ocp, fn)(tx, tu, tpar)
        assert max_rel_err(got, j[fn]) < tol, fn
    assert max_rel_err(tp.ocp.terminal_residual(tx, tpar), j["terminal"]) < tol
    assert tp.ocp.constants["terms"].step == case["step"]


def check_srbd_declared_rows(case, seed):
    """The declared rows are exact at drawn points with the tracking mask 1
    and every switch 0, then 1: A − I, B and ∂ρ/∂x, ∂ρ/∂u of the solver's
    stacked residual (`torch.func.jacfwd` of the port's step and ρ) are
    zero off dynamics_x_rows, dynamics_u_rows, residual_x_rows and
    residual_u_rows at both points, and every declared row is live at one
    (a switch turns a force's switch rows on and a foot's velocity rows
    off). Under RK every row of B is declared (the JAX package declares
    Euler's: ROADMAP F10); under Euler the declarations are JAX's."""
    jp, tp, ts = case["jp"], case["tp"], case["ts"]
    ocp = tp.ocp
    nx, nu = ocp.nx, ocp.nu
    x, u, p0 = random_xup({k: np_of(v) for k, v in ocp.params.items()}, nx,
                          nu, seed)
    x, u = to_torch(x), to_torch(u)
    jac = torch.func.jacfwd
    eye = torch.eye(nx, dtype=F64)
    mats = []
    for switch in (0.0, 1.0):
        p = dict(p0)
        p["cdot_switch"] = np.full_like(p0["cdot_switch"], switch)
        p["mask_track"] = np.ones_like(p0["mask_track"])
        p = to_torch(p)
        rho = lambda a, b: ts._stage_rho(a, b, p)
        step = lambda a, b: ocp.step(a, b, p, ocp.dt)
        mats.append((jac(step, 0)(x, u) - eye, jac(step, 1)(x, u),
                     jac(rho, 0)(x, u), jac(rho, 1)(x, u)))
    for i, rows in enumerate((ocp.dynamics_x_rows, ocp.dynamics_u_rows,
                              ocp.residual_x_rows, ocp.residual_u_rows)):
        rows = sorted(int(r) for r in rows)
        n = mats[0][i].shape[0]
        dead = sorted(set(range(n)) - set(rows))
        live = torch.zeros(len(rows), dtype=torch.bool)
        for m in mats:
            assert bool((m[i][dead] == 0).all()), i
            live |= (m[i][rows] != 0).any(dim=1)
        assert bool(live.all()), (i, [r for r, ok in zip(rows, live) if not ok])
    if case["step"] == "EULER":
        for name in ("dynamics_x_rows", "dynamics_u_rows", "residual_x_rows",
                     "residual_u_rows"):
            assert (tuple(int(r) for r in getattr(ocp, name))
                    == tuple(int(r) for r in getattr(jp.ocp, name))), name
    else:
        assert tuple(ocp.dynamics_u_rows) == tuple(range(nx))


def check_srbd_linearize(case, key, tol=1e-12):
    """The K4 twin's block `key` against JAX's dense Jacobians (A − I and B
    of its step, the residual Jacobians) on the declared rows, its residuals
    and defects."""
    rows, jd, nx = case["ts"].rows, case["jdense"], case["tp"].ocp.nx
    want = {"Sx": (np.asarray(jd["A"]) - np.eye(nx))[:, :, list(rows.rx)],
            "Bs": np.asarray(jd["B"])[:, :, list(rows.ru)],
            "Jxp": np.asarray(jd["Jx"])[:, :, list(rows.gx)],
            "Jup": np.asarray(jd["Ju"])[:, :, list(rows.gu)]}.get(key)
    want = np.asarray(jd[key]) if want is None else want
    got = case["tlin"][key]
    assert tuple(got.shape) == want.shape
    assert max_rel_err(got, want) < tol


def check_srbd_trial(case, nA, tol=1e-12):
    """The K3 twin against JAX's trial on the case's plan, gains and
    defects at the first nA of SRBD_ALPHAS; member SRBD_NAN_MEMBER starts
    from a NaN state and is rejected."""
    js, ts = case["js"], case["ts"]
    opts = js.opts
    ks, Ks, dV1, dV2 = case["sweep"]
    want, merit0, D = case["jax"]["trial"]
    t = lambda a: to_torch(np_of(a))
    got = t_k3.srbd_trial_plain(
        t(case["trial_x0"]), to_torch(case["X"]), to_torch(case["U"]), ks,
        Ks, t(case["jdense"]["d"]), to_torch(SRBD_ALPHAS[:nA]),
        to_torch(case["params"]), t(merit0), t(D), dV1, dV2, ts.terms,
        ts.ocp.dt, ts._wc(torch.float64), opts.defect_weight, opts.beta,
        opts.alpha_converge_threshold)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:nA], rtol=tol,
                                   atol=tol)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4])[:nA])
    assert not bool(got[4][:, SRBD_NAN_MEMBER].any())


def check_srbd_evaluate(case, pin, tol=1e-12):
    """The srbd_evaluate twin against JAX's `vmap(total_cost)` and the
    largest |·| of `vmap(_true_defects)`, a NaN in one member's plan;
    with `pin` node 0 pinned to x0 and the pinned plan returned."""
    ts = case["ts"]
    x0 = case["x0"] if pin else None
    want = case["jax"]["evaluate_pinned" if pin else "evaluate"]
    got = t_k3.srbd_evaluate_plain(
        to_torch(case["Xe"]), to_torch(case["U"]), to_torch(case["params"]),
        ts.terms, case["tp"].ocp.dt, ts._wc(torch.float64),
        None if x0 is None else to_torch(x0))
    for g, w in zip(got[:2], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)
        assert np.isnan(g.numpy()[SRBD_NAN_MEMBER])
    if pin:
        np.testing.assert_array_equal(got[2].numpy(), case["Xp"])


def check_srbd_solves(case, batched):
    """`solve` against JAX's `solve` (or, `batched`, `solve_batch` against
    its `vmap(solve)`): iterations and convergence equal, the plans and
    the cost to 1e-9; the single solve iterates more than once, the
    batched one closes its defects."""
    p, j = case["port"], case["jax"]
    if batched:
        agree(p["solve_batch"], j["vmap_solve"], f"{case['step']} solve_batch",
              ("X", "U", "cost"))
        assert float(p["solve_batch"].defect_norm.max()) < 1e-6
    else:
        agree(p["solve"], j["solve"], f"{case['step']} solve",
              ("X", "U", "cost"))
        assert int(p["solve"].iterations) > 1


def check_srbd_ticks(case):
    """Each `tick_batch` tick against JAX's `vmap(tick)`: iterations and
    convergence equal, x, u0 and the cost to 1e-9, and the carried plans to
    1e-9."""
    jo, jX, jU = case["jax"]["ticks"]
    for i, (to, tX, tU) in enumerate(case["port"]["ticks"]):
        want = types.SimpleNamespace(**{f: np.asarray(getattr(jo, f))[i]
                                        for f in jo._fields})
        agree(to, want, f"{case['step']} tick {i}", ("x", "u0", "cost"))
        assert max_rel_err(tX, np.asarray(jX)[i]) < 1e-9
        assert max_rel_err(tU, np.asarray(jU)[i]) < 1e-9


def check_srbd_dispatch(case, k4_shape, k1_shape, library):
    """K4's, K3's and srbd_evaluate's check name the instance `k4_shape`,
    K1's its shape `k1_shape` with all three forms, built in the kernel
    library `library`."""
    ts, ocp = case["ts"], case["tp"].ocp
    for name in ("srbd_linearize", "srbd_trial", "srbd_evaluate"):
        assert t_k4.check_kernel_shape(name, ts.terms, ocp.nx, ocp.nu,
                                       ts.rows) == k4_shape
    assert t_k4.KERNEL_SHAPES[k4_shape]["step"] == case["step"]
    assert t_k1.kernel_shape(ocp.nx, ocp.nu, t_k4.N_TRACK, ts.rows) == k1_shape
    for form, solver in (("collapsed", "schur"), ("tassa", "schur"),
                         ("tassa", "cholesky")):
        inst = t_k1.kernel_instance(k1_shape, form, solver)
        assert t_k1.KERNEL_INSTANCES[inst] == (k1_shape, form, solver)
        assert t_k1.library_name(inst) == library


def check_nc8_bar(prob, sol):
    """JAX's `TestNc8::test_srbd_nc8_solve` bar on a standing solve: the
    defect norm below NC8_DEFECT and each contact's F_z within NC8_FZ_TOL
    of m·g / (fs·8)."""
    assert float(sol.defect_norm) < NC8_DEFECT
    fz = np_of(sol.U)[:, 5::6]
    want = prob.mass * 9.81 / prob.force_scaling / 8
    assert fz.shape[-1] == 8
    np.testing.assert_allclose(fz, want, atol=NC8_FZ_TOL)


# JAX's TestLineFeetQuadruped bar (tests/test_configs.py): a standing solve
# from the nominal state with max_iters=20, alpha_converge_threshold=1e-12
# and beta=1e-3 converges, its defects below 1e-6 and Σ F_z (each contact's
# mean over the nodes) within 1% of m·g / fs
LINE_FEET_OPTS = dict(max_iters=20, alpha_converge_threshold=1e-12, beta=1e-3)
LINE_FEET_DEFECT, LINE_FEET_FZ_RTOL = 1e-6, 0.01


def check_line_feet_bar(prob, sol):
    """JAX's `TestLineFeetQuadruped::test_srbd_cm2_legs4_solve` bar on a
    standing solve: converged, the defect norm below LINE_FEET_DEFECT and
    the sum over the eight contacts of each one's mean F_z within
    LINE_FEET_FZ_RTOL of m·g / fs."""
    assert bool(sol.converged)
    assert float(sol.defect_norm) < LINE_FEET_DEFECT
    fz = np_of(sol.U)[:, 5::6]
    assert fz.shape[-1] == 8
    np.testing.assert_allclose(fz.mean(axis=0).sum(),
                               prob.mass * 9.81 / prob.force_scaling,
                               rtol=LINE_FEET_FZ_RTOL)
