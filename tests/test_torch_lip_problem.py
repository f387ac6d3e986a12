"""PyTorch port, the LIP problem (`problems/lip.py`) against the JAX
package's `build_lip_problem`, float64 on the CPU:

  - the build: sizes, layouts, x0, u0 and the params, equal;
  - the stage residual, equalities and ρ, the terminal residual, the Euler
    step and `total_cost` on random members to 1e-12 relative;
  - the declared row sets (which the JAX problem does not declare, and
    the port's blocksparse sweep needs) against the Jacobians of the
    plain ρ and step by `torch.autograd.functional.jacobian`: every
    nonzero lies in them, and every declared row has a nonzero;
  - the point-feet problem (nc = 2) builds, evaluates and solves on the
    CPU as the JAX package's does;
  - the compiled instances of K10, K11 and lip_evaluate (the topology
    structs and `with_shape` of csrc/lip_common.cuh) held against the
    wrappers' table and the problem, the wrappers refusing other sizes off
    the CPU (meta tensors stand in for CUDA ones) before any launch, and
    every instance's sizes passing the shape check and stopping at the
    device check.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _line_feet_quadruped import LINE_FEET_TOPOLOGY, line_feet_quadruped
from _square_feet import SQUARE_TOPOLOGY, square_feet
from _torch_parity import jit, max_rel_err, np_of, to_jax, to_torch
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet as j_feet
from srbd_horizon_tpu.models.kangaroo import point_feet as j_point_feet
from srbd_horizon_tpu.problems.lip import build_lip_problem as j_build
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
from srbd_horizon_tpu_torch.kernels.riccati import RiccatiRows
from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet as t_feet
from srbd_horizon_tpu_torch.models.kangaroo import point_feet as t_point_feet
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem as t_build
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

F64 = torch.float64
HEADER = Path(k10.__file__).resolve().parents[1] / "csrc" / "lip_common.cuh"


def _robot_of(jrobot):
    """The port's RobotConstants with the numbers of a JAX one."""
    return RobotConstants(mass=jrobot.mass, inertia=np.asarray(jrobot.inertia),
                          com=np.asarray(jrobot.com),
                          foot_positions=np.asarray(jrobot.foot_positions),
                          foot_frames=tuple(jrobot.foot_frames))


def _pair(**cfg):
    jp = j_build(JSRBDConfig(dtype=jnp.float64, **cfg),
                 j_feet() if "contact_model" not in cfg else j_point_feet())
    robot = t_feet() if "contact_model" not in cfg else _robot_of(j_point_feet())
    tp = t_build(SRBDConfig(dtype=F64, **cfg), robot, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def lip():
    return _pair()


def random_members(nc, B, seed):
    """Numpy (x, u, p) of B random LIP members: states around the nominal
    CoM, random contacts and velocities, random references and 0/1
    switches and tracking masks."""
    rng = np.random.RandomState(seed)
    nx, nu = 6 + 6 * nc, 3 + 3 * nc
    x = rng.uniform(-0.3, 0.3, (B, nx))
    x[:, 2] += 0.88
    u = 0.3 * rng.randn(B, nu)
    p = dict(rdot_ref=0.3 * rng.randn(B, 3),
             c_ref=0.05 * np.abs(rng.randn(B, nc)),
             cdot_switch=rng.randint(0, 2, (B, nc)).astype(np.float64),
             mask_track=rng.randint(0, 2, (B, 1)).astype(np.float64))
    return x, u, p


def random_plans(ocp_params, nc, B, ns, seed):
    """Numpy (X, U, params) of B random LIP plans."""
    x, u, p = random_members(nc, B * (ns + 1), seed)
    X = x.reshape(B, ns + 1, -1)
    U = u[: B * ns].reshape(B, ns, -1)
    params = {k: v.reshape(B, ns + 1, -1) for k, v in p.items()}
    assert set(params) == set(ocp_params)
    return X, U, params


def test_build_matches_jax(lip):
    jp, tp = lip
    jo, to = jp.ocp, tp.ocp
    assert (to.ns, to.nx, to.nu, to.dt) == (jo.ns, jo.nx, jo.nu, jo.dt)
    assert (to.nx, to.nu) == (30, 15)
    assert to.state_layout.names == jo.state_layout.names
    assert to.input_layout.names == jo.input_layout.names
    np.testing.assert_array_equal(np_of(tp.initial_state), np.asarray(jp.initial_state))
    np.testing.assert_array_equal(np_of(tp.static_input), np.asarray(jp.static_input))
    assert set(to.params) == set(jo.params)
    for k, v in jo.params.items():
        np.testing.assert_array_equal(np_of(to.params[k]), np.asarray(v))
    terms = to.constants["terms"]
    assert terms.family == "lip"
    assert (terms.n_res, terms.n_eq, terms.n_rho) == (28, 16, 44)
    assert (tp.nc, tp.contact_model) == (jp.nc, jp.contact_model)


@pytest.mark.parametrize("fn", ["stage_residual", "stage_eq", "stage_rho",
                                "terminal_residual", "step"])
def test_node_functions_match_jax(lip, fn):
    jp, tp = lip
    js = JMSDDP(jp.ocp, JDDPOptions())
    ts = MSDDP(tp.ocp, DDPOptions())
    x, u, p = random_members(4, 16, seed=1)
    jx, ju, jpar = to_jax((x, u, p))
    tx, tu, tpar = to_torch(x), to_torch(u), to_torch(p)
    if fn == "terminal_residual":
        want = jax.vmap(jp.ocp.terminal_residual)(jx, jpar)
        got = tp.ocp.terminal_residual(tx, tpar)
    elif fn == "step":
        want = jax.vmap(lambda a, b, c: jp.ocp.step(a, b, c, jp.ocp.dt))(jx, ju, jpar)
        got = tp.ocp.step(tx, tu, tpar, tp.ocp.dt)
    elif fn == "stage_rho":
        want = jax.vmap(js._stage_rho)(jx, ju, jpar)
        got = ts._stage_rho(tx, tu, tpar)
    else:
        want = jax.vmap(getattr(jp.ocp, fn))(jx, ju, jpar)
        got = getattr(tp.ocp, fn)(tx, tu, tpar)
    assert tuple(got.shape) == want.shape
    assert max_rel_err(got, want) < 1e-12


def test_total_cost_matches_jax(lip):
    jp, tp = lip
    js = JMSDDP(jp.ocp, JDDPOptions())
    ts = MSDDP(tp.ocp, DDPOptions())
    X, U, params = random_plans(jp.ocp.params, 4, 3, jp.ocp.ns, seed=2)
    want = jax.vmap(js.total_cost)(*to_jax((X, U, params)))
    got = ts.total_cost(to_torch(X), to_torch(U), to_torch(params))
    assert max_rel_err(got, want) < 1e-12


def _jacobians(tp, x, u, p):
    """∂ρ/∂x, ∂ρ/∂u, ∂step/∂x, ∂step/∂u of one member by autograd."""
    ts = MSDDP(tp.ocp, DDPOptions())
    rho = lambda a, b: ts._stage_rho(a, b, p)
    step = lambda a, b: tp.ocp.step(a, b, p, tp.ocp.dt)
    jr = torch.autograd.functional.jacobian(rho, (x, u))
    jf = torch.autograd.functional.jacobian(step, (x, u))
    return jr[0], jr[1], jf[0] - torch.eye(x.shape[0], dtype=F64), jf[1]


@pytest.mark.parametrize("switches", ["ones", "random"])
def test_declared_rows_hold_every_nonzero(lip, switches):
    """Rows outside the declared sets are exactly zero in every Jacobian
    (A − I for the step); with the mask and the switches at 1 every
    declared row has a nonzero, so the sets are exact: |rx| 18, |ru| 15,
    |gx| 32, |gu| 18, 6 rows in both, all 15 input columns live."""
    _, tp = lip
    ocp = tp.ocp
    rows = RiccatiRows.from_ocp(ocp)
    x, u, p = random_members(4, 1, seed=3)
    if switches == "ones":
        p["cdot_switch"][:] = 1.0
        p["mask_track"][:] = 1.0
    Jrx, Jru, Ax, Bu = _jacobians(tp, to_torch(x[0]), to_torch(u[0]),
                                  {k: to_torch(v[0]) for k, v in p.items()})
    for J, live in ((Jrx, rows.gx), (Jru, rows.gu), (Ax, rows.rx), (Bu, rows.ru)):
        dead = [r for r in range(J.shape[0]) if r not in live]
        assert bool((J[dead] == 0).all())
        if switches == "ones":
            assert bool((J[list(live)] != 0).any(dim=1).all())
    assert bool((Bu[list(rows.ru)] != 0).any(dim=0).all())       # every u column
    assert (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
            len(rows.bx), len(rows.uc)) == (18, 15, 32, 18, 6, 15)
    assert rows.rx == tuple(range(18)) and rows.ru == tuple(range(15, 30))


def test_point_feet_builds_evaluates_and_solves_as_jax():
    """contact_model 1 (nc = 2, nx 18, nu 9): its kernels are the
    `point_feet` instance; a 30-iteration solve from the initial state on
    the CPU (the twins) closes the defects as the JAX package's does
    (tests/test_configs.py), with its iterations and plan."""
    jp, tp = _pair(contact_model=1, number_of_legs=2)
    assert (tp.ocp.nx, tp.ocp.nu, tp.nc) == (18, 9, 2)
    np.testing.assert_array_equal(np_of(tp.initial_state), np.asarray(jp.initial_state))
    js = JMSDDP(jp.ocp, JDDPOptions(max_iters=30))
    ts = MSDDP(tp.ocp, DDPOptions(max_iters=30))
    X, U, params = random_plans(jp.ocp.params, 2, 2, jp.ocp.ns, seed=4)
    want = jax.vmap(js.total_cost)(*to_jax((X, U, params)))
    got = ts.total_cost(to_torch(X), to_torch(U), to_torch(params))
    assert max_rel_err(got, want) < 1e-12
    assert k10.check_kernel_shape("lip_linearize", ts.terms, tp.ocp.nx,
                                  tp.ocp.nu, ts.rows) == "point_feet"
    jsol = jit(js.solve)(js.init(jp.initial_state), jp.initial_state,
                         jp.ocp.params)
    tsol = ts.solve(ts.init(tp.initial_state), tp.initial_state, tp.ocp.params)
    assert int(tsol.iterations) == int(jsol.iterations)
    assert float(tsol.defect_norm) < 1e-6
    assert max_rel_err(tsol.X, jsol.X) < 1e-9


def test_zmp_tracking_gain_is_carried():
    """`zmp_tracking_gain` came back with the LIP problem, which reads it:
    the zmp rows scale with its root, as in the JAX package."""
    jp = j_build(JSRBDConfig(dtype=jnp.float64, zmp_tracking_gain=4.0), j_feet())
    tp = t_build(SRBDConfig(dtype=F64, zmp_tracking_gain=4.0), t_feet(),
                 device="cpu")
    assert tp.ocp.constants["terms"].w_zmp == 2.0
    x, u, p = random_members(4, 4, seed=5)
    want = jax.vmap(jp.ocp.stage_residual)(*to_jax((x, u, p)))
    got = tp.ocp.stage_residual(to_torch(x), to_torch(u), to_torch(p))
    assert max_rel_err(got, want) < 1e-12


# ---------------- the compiled sizes of K10, K11 and lip_evaluate ----------------

def test_shape_struct_matches_the_wrappers_table():
    """The topology structs of csrc/lip_common.cuh are `TOPOLOGIES`, in
    order; its `with_shape` switch is `KERNEL_SHAPES`, in order (the first
    three topologies under Euler, then each under RK2 and RK4, n_ru = nx,
    then the square-feet biped and the line-feet quadruped, each under the
    three steps); its
    step tags' ids are `STEPS` (rigid_common.cuh's, shared with the SRBD
    kernels)."""
    src = HEADER.read_text()
    found = re.findall(r"struct (\w+)Shape \{\s*static constexpr int "
                       r"([^;]*);", src)
    names = {"Kangaroo": "kangaroo", "Quad": "quadruped",
             "PointFeet": "point_feet", "SquareFeet": "square_feet",
             "LineFeetQuad": "line_feet_quadruped"}
    assert [names[n] for n, _ in found] == list(k10.TOPOLOGIES)
    for n, body in found:
        parsed = {k.strip(): int(v) for k, v in
                  (kv.split("=") for kv in body.split(","))}
        assert parsed == k10.TOPOLOGIES[names[n]]
    with_shape = src[src.index("inline int with_shape("):]
    cases = re.findall(r"case (\d+): return fn\((?:Stepped<)?(\w+)Shape"
                       r"(?:, (\w+)>)?", with_shape[:with_shape.index("default")])
    assert [int(i) for i, _, _ in cases] == list(range(len(k10.KERNEL_SHAPES)))
    assert [names[t] + ("_" + st.lower() if st else "")
            for _, t, st in cases] == list(k10.KERNEL_SHAPES)
    for name, want in k10.KERNEL_SHAPES.items():
        topology, _, rk = name.partition("_rk")
        topo = dict(k10.TOPOLOGIES[topology])
        if rk:
            topo["n_ru"] = topo["nx"]
        assert want == dict(topo, step="RK" + rk if rk else "EULER")
    tags = (HEADER.parent / "rigid_common.cuh").read_text()
    ids = re.findall(r"struct (Euler|Rk2|Rk4) \{\s*static constexpr int "
                     r"id = (\d+)", tags)
    assert [(n.upper(), int(i)) for n, i in ids] == [
        (st, i) for i, st in enumerate(k10.STEPS)]


def test_lip_problem_has_the_compiled_sizes(lip):
    _, tp = lip
    ts = MSDDP(tp.ocp, DDPOptions())
    sizes = k10.kernel_sizes(ts.terms, tp.ocp.nx, tp.ocp.nu, ts.rows)
    assert sizes == k10.KERNEL_SHAPES["kangaroo"]
    lin = k10.lip_linearize_plain(
        tp.initial_state[None, None].expand(1, tp.ocp.ns + 1, -1).contiguous(),
        tp.static_input[None, None].expand(1, tp.ocp.ns, -1).contiguous(),
        {k: v[None] for k, v in tp.ocp.params.items()}, ts.terms, ts.rows,
        tp.ocp.dt, ts._wc(F64))
    assert lin["rt"].shape[-1] == lin["Jt"].shape[-2] == 10
    assert lin["rho"].shape[-1] == k10.KERNEL_SHAPES["kangaroo"]["n_rho"]


def _meta_args(tp, ts, nc, B=2):
    """Arguments of K10, K11 and lip_evaluate on meta tensors of a LIP
    layout with nc contacts (the problem's own terms, with nc replaced)."""
    ns = tp.ocp.ns
    nx, nu = 6 + 6 * nc, 3 + 3 * nc
    terms = dataclasses.replace(ts.terms, nc=nc)
    e = lambda *shape: torch.empty(shape, dtype=F64, device="meta")
    params = {k: e(B, ns + 1, v.shape[-1] if k not in ("c_ref", "cdot_switch")
                   else nc)
              for k, v in tp.ocp.params.items()}
    X, U = e(B, ns + 1, nx), e(B, ns, nu)
    dt, wc = tp.ocp.dt, ts._wc(F64)
    lin = (X, U, params, terms, ts.rows, dt, wc)
    trial = (e(B, nx), X, U, e(B, ns, nu), e(B, ns, nu, nx), e(B, ns, nx),
             e(1), params, e(B), e(B), e(B), e(B), terms, dt, wc, 1e-3, 0.1,
             1e-12)
    ev = (X, U, params, terms, dt, wc)
    return {"lip_linearize": (k10.lip_linearize, lin),
            "lip_trial": (k11.lip_trial, trial),
            "lip_evaluate": (k11.lip_evaluate, ev)}


@pytest.mark.parametrize("name", ["lip_linearize", "lip_trial", "lip_evaluate"])
def test_wrappers_refuse_other_sizes_off_the_cpu(lip, name):
    _, tp = lip
    ts = MSDDP(tp.ocp, DDPOptions())
    fn, args = _meta_args(tp, ts, nc=3)[name]
    launches = fn.launches
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        fn(*args)
    # the compiled sizes pass the shape check and stop at the device check
    fn, args = _meta_args(tp, ts, nc=4)[name]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        fn(*args)
    assert fn.launches == launches


# ---------------- every (topology, step) instance ----------------

LIP_TOPOLOGIES = {
    "kangaroo": (dict(), t_feet),
    "quadruped": (dict(contact_model=1, number_of_legs=4), quadruped_point_feet),
    "point_feet": (dict(contact_model=1, number_of_legs=2), t_point_feet),
    "square_feet": (SQUARE_TOPOLOGY, square_feet),
    "line_feet_quadruped": (LINE_FEET_TOPOLOGY, line_feet_quadruped),
}


def _instance_solver(shape, **opts):
    """The port's problem and solver of the instance `shape` on the CPU."""
    topology, _, rk = shape.partition("_rk")
    kw, robot = LIP_TOPOLOGIES[topology]
    tp = t_build(SRBDConfig(dtype=F64, **kw), robot(),
                 integrator="RK" + rk if rk else "EULER", device="cpu")
    return tp, MSDDP(tp.ocp, DDPOptions(**opts))


@pytest.mark.parametrize("shape", list(k10.KERNEL_SHAPES))
@pytest.mark.parametrize("name", ["lip_linearize", "lip_trial", "lip_evaluate"])
def test_each_instance_passes_the_shape_check(shape, name):
    """Each instance's own problem passes the wrappers' shape check off the
    CPU (meta tensors) and stops at the device check, launching nothing;
    its sizes name that instance, and its step's row counts no other."""
    tp, ts = _instance_solver(shape)
    ocp, B, ns = tp.ocp, 2, tp.ocp.ns
    nx, nu = ocp.nx, ocp.nu
    assert k10.check_kernel_shape(name, ts.terms, nx, nu, ts.rows) == shape
    e = lambda *sh: torch.empty(sh, dtype=F64, device="meta")
    params = {k: e(B, ns + 1, v.shape[-1]) for k, v in ocp.params.items()}
    X, U = e(B, ns + 1, nx), e(B, ns, nu)
    dt, wc = ocp.dt, ts._wc(F64)
    fn, args = {
        "lip_linearize": (k10.lip_linearize,
                          (X, U, params, ts.terms, ts.rows, dt, wc)),
        "lip_trial": (k11.lip_trial,
                      (e(B, nx), X, U, e(B, ns, nu), e(B, ns, nu, nx),
                       e(B, ns, nx), e(1), params, e(B), e(B), e(B), e(B),
                       ts.terms, dt, wc, 1e-3, 0.1, 1e-12)),
        "lip_evaluate": (k11.lip_evaluate, (X, U, params, ts.terms, dt, wc)),
    }[name]
    launches = (fn.launches, dict(fn.shape_launches))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        fn(*args)
    assert (fn.launches, fn.shape_launches) == launches
    other = "EULER" if ts.terms.step != "EULER" else "RK2"
    swapped = dataclasses.replace(ts.terms, step=other)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k10.check_kernel_shape(name, swapped, nx, nu, ts.rows)
