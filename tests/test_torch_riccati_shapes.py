"""PyTorch port, K1's compile-time instantiations, on the CPU.

K1 (`csrc/riccati_backward.cu`) is compiled for twenty-two sets of sizes,
the SRBD OCP, the AL inner OCP of the isrbd problem, the LIP OCP, the SRBD
OCP of the point-feet quadruped, the AL inner OCP of its isrbd problem,
the SRBD OCP of the point-feet biped, the SRBD OCP of each of the three
topologies under RK2 / RK4 (every row of B live), the LIP OCP of the
Kangaroo under RK and of the point-feet quadruped and biped under Euler
and under RK, the square-feet biped's SRBD and LIP OCPs under Euler and
under RK (csrc/riccati_backward_square_feet.cu) and the line-feet
quadruped's (csrc/riccati_backward_line_feet.cu); its wrapper picks one
with `kernel_shape` for CUDA tensors and refuses any other sizes with a
ValueError that names them. These tests hold that choice against
`RiccatiRows.from_ocp` of the twenty-two problems, hold `KERNEL_SHAPES` and `KERNEL_INSTANCES` against the shape
structs and the instantiation switch of the CUDA sources, and check that a
CPU tensor of any sizes still takes the plain twin, as does K2's
standalone wrapper.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _line_feet_quadruped import LINE_FEET_TOPOLOGY, line_feet_quadruped
from _square_feet import SQUARE_TOPOLOGY, square_feet
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels.riccati import RiccatiRows
from srbd_horizon_tpu_torch.math.linalg import lm_spd_inverse
from srbd_horizon_tpu_torch.models.kangaroo import (
    RobotConstants,
    kangaroo_line_feet,
    point_feet,
)
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.runtime.loop import build_lip_loop, build_srbd_loop
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP

torch.set_num_threads(1)

SHAPES_SOURCE = (Path(k1.__file__).resolve().parents[1] / "csrc"
                 / "riccati_common.cuh")


def _srbd_sizes(cfg=None, robot=None, integrator="EULER"):
    """(nx, nu, nt, rows) of the SRBD OCP (`build_srbd_problem`, as the
    fleet loop builds it; the Kangaroo's under Euler by default), nt read
    off its linearization."""
    loop, prob = build_srbd_loop(cfg or SRBDConfig(dtype=torch.float64),
                                 DDPOptions(max_iters=1), robot=robot,
                                 device="cpu", integrator=integrator)
    ocp, s = prob.ocp, loop.solver
    X = prob.initial_state[None, None].expand(1, ocp.ns + 1, -1).contiguous()
    U = prob.static_input[None, None].expand(1, ocp.ns, -1).contiguous()
    params = {k: v[None] for k, v in ocp.params.items()}
    lin = k4.srbd_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt,
                                  s._wc(torch.float64))
    rows = RiccatiRows.from_ocp(ocp)
    assert rows == s.rows
    return ocp.nx, ocp.nu, lin["Jt"].shape[1], rows


def _isrbd_sizes(quadruped=False):
    """(nx, nu, nt, rows) of the isrbd problem's AL inner OCP (the
    Kangaroo's serving configuration, or the constrained quadruped
    example's)."""
    if quadruped:
        robot = quadruped_point_feet()
        prob = build_isrbd_problem(
            SRBDConfig(dtype=torch.float64, contact_model=1, number_of_legs=4,
                       lip_height=float(robot.com[2])), robot, device="cpu")
    else:
        prob = build_isrbd_problem(SRBDConfig(dtype=torch.float64),
                                   kangaroo_line_feet(), cz_rho_weight=3200.0,
                                   device="cpu")
    al = ALDDP(prob.ocp, DDPOptions(max_iters=1))
    ocp = al.ocp
    X = prob.initial_state[None, None].expand(1, ocp.ns + 1, -1).contiguous()
    U = prob.static_input[None, None].expand(1, ocp.ns, -1).contiguous()
    params = {k: v[None] for k, v in ocp.params.items()}
    st = al.init(X[:, 0])
    pin = al._params_with_multipliers(params, st)
    lin = k5.isrbd_linearize_plain(X, U, pin, al.terms, al.inner.rows, ocp.dt)
    rows = RiccatiRows.from_ocp(al.inner.ocp)
    assert rows == al.inner.rows
    return ocp.nx, ocp.nu, lin["Jt"].shape[1], rows


def _lip_sizes(cfg=None, robot=None, integrator="EULER"):
    """(nx, nu, nt, rows) of the LIP OCP (`build_lip_problem`, as
    `build_lip_loop` builds it; the Kangaroo's under Euler by default), nt
    read off its linearization."""
    loop, prob = build_lip_loop(cfg or SRBDConfig(dtype=torch.float64),
                                DDPOptions(max_iters=1), robot=robot,
                                device="cpu", integrator=integrator)
    ocp, s = prob.ocp, loop.solver
    X = prob.initial_state[None, None].expand(1, ocp.ns + 1, -1).contiguous()
    U = prob.static_input[None, None].expand(1, ocp.ns, -1).contiguous()
    params = {k: v[None] for k, v in ocp.params.items()}
    lin = k10.lip_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt,
                                  s._wc(torch.float64))
    rows = RiccatiRows.from_ocp(ocp)
    assert rows == s.rows
    return ocp.nx, ocp.nu, lin["Jt"].shape[1], rows


@pytest.fixture(scope="module")
def sizes():
    quad = SRBDConfig(contact_model=1, number_of_legs=4, dtype=torch.float64)
    pf = SRBDConfig(contact_model=1, number_of_legs=2, dtype=torch.float64)
    sq = SRBDConfig(dtype=torch.float64, **SQUARE_TOPOLOGY)
    lf = SRBDConfig(dtype=torch.float64, **LINE_FEET_TOPOLOGY)
    return {"srbd": _srbd_sizes(), "isrbd_al": _isrbd_sizes(),
            "lip": _lip_sizes(),
            "quadruped": _srbd_sizes(quad, quadruped_point_feet()),
            "isrbd_al_quadruped": _isrbd_sizes(quadruped=True),
            "point_feet": _srbd_sizes(pf, point_feet()),
            "srbd_rk": _srbd_sizes(integrator="RK2"),
            "quadruped_rk": _srbd_sizes(quad, quadruped_point_feet(), "RK4"),
            "point_feet_rk": _srbd_sizes(pf, point_feet(), "RK2"),
            "lip_rk": _lip_sizes(integrator="RK4"),
            "lip_quadruped": _lip_sizes(quad, quadruped_point_feet()),
            "lip_quadruped_rk": _lip_sizes(quad, quadruped_point_feet(),
                                           "RK2"),
            "lip_point_feet": _lip_sizes(pf, point_feet()),
            "lip_point_feet_rk": _lip_sizes(pf, point_feet(), "RK4"),
            "square_feet": _srbd_sizes(sq, square_feet()),
            "square_feet_rk": _srbd_sizes(sq, square_feet(), "RK4"),
            "lip_square_feet": _lip_sizes(sq, square_feet()),
            "lip_square_feet_rk": _lip_sizes(sq, square_feet(), "RK2"),
            "line_feet_quadruped": _srbd_sizes(lf, line_feet_quadruped()),
            "line_feet_quadruped_rk": _srbd_sizes(lf, line_feet_quadruped(),
                                                  "RK2"),
            "lip_line_feet_quadruped": _lip_sizes(lf, line_feet_quadruped()),
            "lip_line_feet_quadruped_rk": _lip_sizes(
                lf, line_feet_quadruped(), "RK4")}


SHAPES = ["srbd", "isrbd_al", "lip", "quadruped", "isrbd_al_quadruped",
          "point_feet", "srbd_rk", "quadruped_rk", "point_feet_rk", "lip_rk",
          "lip_quadruped", "lip_quadruped_rk", "lip_point_feet",
          "lip_point_feet_rk", "square_feet", "square_feet_rk",
          "lip_square_feet", "lip_square_feet_rk", "line_feet_quadruped",
          "line_feet_quadruped_rk", "lip_line_feet_quadruped",
          "lip_line_feet_quadruped_rk"]


@pytest.mark.parametrize("name", SHAPES)
def test_kernel_shape_of_each_problem(sizes, name):
    nx, nu, nt, rows = sizes[name]
    assert k1.kernel_shape(nx, nu, nt, rows) == name
    assert k1.kernel_sizes(nx, nu, nt, rows) == k1.KERNEL_SHAPES[name]


def _drop_last(rows, field):
    return RiccatiRows(**{f: getattr(rows, f) for f in
                          ("rx", "ru", "gx", "gu", "bx", "bu", "uc")
                          if f != field},
                       **{field: getattr(rows, field)[:-1]})


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("change", ["nx", "nu", "nt", "rx", "ru", "gx", "gu",
                                    "both", "uc"])
def test_kernel_shape_refuses_other_sizes(sizes, name, change):
    nx, nu, nt, rows = sizes[name]
    if change in ("nx", "nu", "nt"):
        nx, nu, nt = (v - (change == c) for v, c in
                      ((nx, "nx"), (nu, "nu"), (nt, "nt")))
    elif change == "both":
        rows = _drop_last(_drop_last(rows, "bx"), "bu")
    else:
        rows = _drop_last(rows, change)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k1.kernel_shape(nx, nu, nt, rows)


def test_kernel_shapes_match_the_cuda_source():
    """KERNEL_SHAPES, in order, is the sources' SrbdShape, IsrbdAlShape,
    LipShape, QuadShape, QuadAlShape, PointFeetShape, SrbdRkShape,
    QuadRkShape, PointFeetRkShape, LipRkShape, LipQuadShape,
    LipQuadRkShape, LipPointFeetShape, LipPointFeetRkShape, SquareFeetShape,
    SquareFeetRkShape, LipSquareFeetShape, LipSquareFeetRkShape,
    LineFeetQuadShape, LineFeetQuadRkShape, LipLineFeetQuadShape,
    LipLineFeetQuadRkShape (csrc/riccati_common.cuh, one definition for K1
    and K12)."""
    src = SHAPES_SOURCE.read_text()
    structs = re.findall(r"struct (\w+Shape) \{[^}]*?static constexpr int "
                         r"([^;]*);", src)
    assert [s for s, _ in structs] == ["SrbdShape", "IsrbdAlShape", "LipShape",
                                       "QuadShape", "QuadAlShape",
                                       "PointFeetShape", "SrbdRkShape",
                                       "QuadRkShape", "PointFeetRkShape",
                                       "LipRkShape", "LipQuadShape",
                                       "LipQuadRkShape", "LipPointFeetShape",
                                       "LipPointFeetRkShape", "SquareFeetShape",
                                       "SquareFeetRkShape",
                                       "LipSquareFeetShape",
                                       "LipSquareFeetRkShape",
                                       "LineFeetQuadShape",
                                       "LineFeetQuadRkShape",
                                       "LipLineFeetQuadShape",
                                       "LipLineFeetQuadRkShape"]
    parsed = []
    for _, body in structs:
        parsed.append({k.strip(): int(v) for k, v in
                       (kv.split("=") for kv in body.split(","))})
    assert parsed == list(k1.KERNEL_SHAPES.values())


def test_lip_on_point_feet_is_refused():
    """The LIP on point feet (nc 2: nx 18, nu 9) off its instantiation's
    sizes is refused, its sizes named: its own sizes (the point-feet
    biped's robot numbers) pick `lip_point_feet`, and with one residual row
    fewer they pick none."""
    cfg = SRBDConfig(contact_model=1, number_of_legs=2, dtype=torch.float64)
    robot = RobotConstants(
        mass=40.0, inertia=np.diag([2.11556, 1.82968, 0.62288]),
        com=np.array([0.0, -0.09, 0.88]),
        foot_positions=np.array([[0.0, 0.0, 0.0], [0.0, -0.18, 0.0]]),
        foot_frames=("sole_0", "sole_1"))
    nx, nu, nt, rows = _lip_sizes(cfg, robot)
    assert (nx, nu, nt) == (18, 9, 10)
    assert k1.kernel_shape(nx, nu, nt, rows) == "lip_point_feet"
    with pytest.raises(ValueError, match=r"no kernel for the sizes .*'nx': 18"):
        k1.kernel_shape(nx, nu, nt, _drop_last(rows, "gx"))


def test_lip_instantiations():
    """The LIP is compiled for the collapsed sweep (`solve_batch`) and the
    Tassa sweep with either gain solve (`MSDDP.solve`); the collapsed form
    ignores the gain solve, as at every shape, so (lip, collapsed,
    cholesky) runs the collapsed block-Schur instantiation."""
    collapsed = k1.kernel_instance("lip", "collapsed", "schur")
    assert k1.KERNEL_INSTANCES[collapsed] == ("lip", "collapsed", "schur")
    assert k1.kernel_instance("lip", "collapsed", "cholesky") == collapsed
    for solver in ("schur", "cholesky"):
        i = k1.kernel_instance("lip", "tassa", solver)
        assert k1.KERNEL_INSTANCES[i] == ("lip", "tassa", solver)
    with pytest.raises(ValueError, match="no kernel for"):
        k1.kernel_instance("isrbd_al", "tassa", "schur")


def test_quadruped_instantiations():
    """The quadruped is compiled for the collapsed sweep (`solve_batch`) and
    the Tassa sweep with either gain solve (`MSDDP.solve`: DDPOptions'
    default block-Schur solver, or quu_solver="cholesky", appended as
    instance 22)."""
    for form in ("collapsed", "tassa"):
        i = k1.kernel_instance("quadruped", form, "schur")
        assert k1.KERNEL_INSTANCES[i] == ("quadruped", form, "schur")
    assert (k1.kernel_instance("quadruped", "collapsed", "cholesky")
            == k1.kernel_instance("quadruped", "collapsed", "schur"))
    assert k1.kernel_instance("quadruped", "tassa", "cholesky") == 22
    # its AL inner OCP: the collapsed sweep (`ALDDP.solve_batch`) and the
    # Tassa sweep with Cholesky gains (`ALDDP.solve` / `solve_online`, whose
    # inner solver carries quu_solver="cholesky"); no block-Schur Tassa
    for key in (("isrbd_al_quadruped", "collapsed", "schur"),
                ("isrbd_al_quadruped", "tassa", "cholesky")):
        assert k1.KERNEL_INSTANCES[k1.kernel_instance(*key)] == key
    assert k1.KERNEL_INSTANCES.index(
        ("isrbd_al_quadruped", "collapsed", "schur")) == 10
    assert k1.KERNEL_INSTANCES.index(
        ("isrbd_al_quadruped", "tassa", "cholesky")) == 11
    with pytest.raises(ValueError, match="no kernel for"):
        k1.kernel_instance("isrbd_al_quadruped", "tassa", "schur")


def test_point_feet_and_rk_instantiations():
    """The point-feet biped and the three RK shapes — RK2 and RK4 share
    each — have the collapsed sweep and the Tassa sweep with either gain
    solve (the Cholesky ones at `quadruped_rk` and `point_feet_rk`
    appended as 23 and 24; the source's `with_instance` order is held by
    test_torch_riccati_tassa.py)."""
    want = {("point_feet", "collapsed", "schur"): 12,
            ("point_feet", "tassa", "schur"): 13,
            ("point_feet", "tassa", "cholesky"): 14,
            ("srbd_rk", "collapsed", "schur"): 15,
            ("srbd_rk", "tassa", "schur"): 16,
            ("srbd_rk", "tassa", "cholesky"): 17,
            ("quadruped_rk", "collapsed", "schur"): 18,
            ("quadruped_rk", "tassa", "schur"): 19,
            ("point_feet_rk", "collapsed", "schur"): 20,
            ("point_feet_rk", "tassa", "schur"): 21}
    for key, i in want.items():
        assert k1.kernel_instance(*key) == i
    for shape, i in (("quadruped_rk", 23), ("point_feet_rk", 24)):
        assert k1.kernel_instance(shape, "tassa", "cholesky") == i


def test_lip_family_instantiations():
    """The LIP at the Kangaroo under RK and at the point-feet quadruped and
    biped under Euler and under RK — RK2 and RK4 share each shape — has the
    collapsed sweep and the Tassa sweep with either gain solve, appended as
    25-39 in that order (the source's `with_instance` order is held by
    test_torch_riccati_tassa.py)."""
    shapes = ("lip_rk", "lip_quadruped", "lip_quadruped_rk",
              "lip_point_feet", "lip_point_feet_rk")
    forms = (("collapsed", "schur"), ("tassa", "schur"),
             ("tassa", "cholesky"))
    i = 25
    for shape in shapes:
        for form, solver in forms:
            assert k1.kernel_instance(shape, form, solver) == i
            assert k1.KERNEL_INSTANCES[i] == (shape, form, solver)
            i += 1
    assert i == 40


def test_square_feet_instantiations():
    """The square-feet biped's SRBD and LIP shapes, each under Euler and
    under RK (RK2 and RK4 share a shape), have the collapsed sweep and the
    Tassa sweep with either gain solve, appended as 40-51 in that order,
    and are built into a library of their own
    (csrc/riccati_backward_square_feet.cu); the rest stay in
    riccati_backward's (the source's `with_instance` order is held by
    test_torch_riccati_tassa.py)."""
    forms = (("collapsed", "schur"), ("tassa", "schur"),
             ("tassa", "cholesky"))
    i = 40
    for shape in ("square_feet", "square_feet_rk", "lip_square_feet",
                  "lip_square_feet_rk"):
        assert shape in k1.SQUARE_FEET_SHAPES
        for form, solver in forms:
            assert k1.kernel_instance(shape, form, solver) == i
            assert k1.KERNEL_INSTANCES[i] == (shape, form, solver)
            assert k1.library_name(i) == "riccati_backward_square_feet"
            i += 1
    assert i == 52
    assert {k1.library_name(j) for j in range(40)} == {"riccati_backward"}


def test_line_feet_quadruped_instantiations():
    """The line-feet quadruped's SRBD and LIP shapes, each under Euler and
    under RK, have the three forms each, appended as 52-63 in that order,
    and are built into a third library (csrc/riccati_backward_line_feet.cu).
    Their sizes are the square feet's but for n_gx, so `kernel_shape`
    tells the two apart by the rows of G alone."""
    forms = (("collapsed", "schur"), ("tassa", "schur"),
             ("tassa", "cholesky"))
    i = 52
    for shape, square in zip(k1.LINE_FEET_SHAPES, k1.SQUARE_FEET_SHAPES):
        assert shape == square.replace("square_feet", "line_feet_quadruped")
        z, w = k1.KERNEL_SHAPES[shape], k1.KERNEL_SHAPES[square]
        assert {k for k in z if z[k] != w[k]} == {"n_gx"}
        assert w["n_gx"] - z["n_gx"] == 4
        for form, solver in forms:
            assert k1.kernel_instance(shape, form, solver) == i
            assert k1.KERNEL_INSTANCES[i] == (shape, form, solver)
            assert k1.library_name(i) == "riccati_backward_line_feet"
            i += 1
    assert len(k1.KERNEL_INSTANCES) == i == 64
    assert {k1.library_name(j) for j in range(40, 52)} == {
        "riccati_backward_square_feet"}


def test_wrapper_takes_plain_path_for_any_sizes_on_cpu():
    """No instantiation is needed for CPU tensors: sizes of no compiled
    shape go to the plain twin."""
    g = np.random.RandomState(3)
    Bsz, ns, nx, nu, nt = 2, 3, 6, 4, 5
    rows = RiccatiRows(rx=(0, 2, 3), ru=(1, 4), gx=(0, 1, 2, 5), gu=(2, 3, 4),
                       bx=(2,), bu=(0,), uc=(0, 1, 3))
    t = lambda *shape: torch.as_tensor(g.randn(*shape))
    args = (0.1 * t(Bsz, ns, 3, nx), 0.1 * t(Bsz, ns, 2, 3), t(Bsz, ns, 4, nx),
            t(Bsz, ns, 3, nu), t(Bsz, ns, 6), 0.01 * t(Bsz, ns, nx),
            t(Bsz, nt, nx), t(Bsz, nt), 1e-3, rows)
    with pytest.raises(ValueError):
        k1.kernel_shape(nx, nu, nt, rows)
    got = k1.riccati_backward(*args)
    want = k1.riccati_backward_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [24, 30, 7, 15, 12, 9])
def test_spd_inverse_takes_plain_path_on_cpu(n):
    g = np.random.RandomState(n)
    J = torch.as_tensor(g.randn(5, n + 3, n))
    A = 2.0 * J.transpose(-1, -2) @ J + 1e-6 * torch.eye(n, dtype=torch.float64)
    launches = k1.spd_inverse.launches
    got = k1.spd_inverse(A)
    assert torch.equal(got, lm_spd_inverse(A))
    assert k1.spd_inverse.launches == launches
    eye = torch.eye(n, dtype=torch.float64).expand(5, n, n)
    assert float((got @ A - eye).abs().max()) < 1e-8
