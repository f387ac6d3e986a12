"""PyTorch port, the compile-time sizes of the isrbd kernels, on the CPU.

K5 (the linearization, csrc/isrbd_linearize.cu), K6 (the trial) and
isrbd_evaluate (csrc/isrbd_rollout.cu), and K7/K8 (csrc/isrbd_al.cu), are
compiled for two sets of sizes, `isrbd::KangarooAlShape` and
`isrbd::QuadAlShape` in csrc/isrbd_common.cuh. These tests hold those
structs against `kernels/isrbd_linearize.py::KERNEL_SHAPES`, against what
`build_isrbd_problem` gives at the serving configuration and on the
point-feet quadruped, and against K1's isrbd instantiations, and check
that the wrappers refuse other sizes (a change of any one size, the
eight-contact quadruped) with a ValueError that names them before any
device work (meta tensors stand in for CUDA ones), while CPU tensors of
other sizes take the plain twins.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
from srbd_horizon_tpu_torch.kernels import isrbd_rollout as k6
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels.riccati import RiccatiRows
from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants, kangaroo_line_feet
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP

torch.set_num_threads(1)

HEADER = Path(k5.__file__).resolve().parents[1] / "csrc" / "isrbd_common.cuh"
NAMES = ("isrbd_linearize", "isrbd_trial", "isrbd_evaluate")


def _solver(robot, cfg, cz_rho_weight=3200.0):
    prob = build_isrbd_problem(cfg, robot, cz_rho_weight=cz_rho_weight,
                               device="cpu")
    return prob, ALDDP(prob.ocp, DDPOptions(max_iters=1))


@pytest.fixture(scope="module")
def serving():
    """The serving configuration's AL inner problem."""
    prob, al = _solver(kangaroo_line_feet(), SRBDConfig(dtype=torch.float64))
    return dict(prob=prob, al=al, ocp=prob.ocp, terms=al.terms, rows=al.inner.rows)


def test_shape_struct_matches_the_wrappers_table():
    """KERNEL_SHAPES, in order, is the header's KangarooAlShape,
    QuadAlShape."""
    src = HEADER.read_text()
    found = re.findall(r"struct (\w+Shape) \{\s*static constexpr int ([^;]*);",
                       src)
    assert [name for name, _ in found] == ["KangarooAlShape", "QuadAlShape"]
    parsed = [{k.strip(): int(v) for k, v in
               (kv.split("=") for kv in body.split(","))} for _, body in found]
    assert parsed == list(k5.KERNEL_SHAPES.values())
    assert list(k5.KERNEL_SHAPES) == ["kangaroo", "quadruped"]


def test_serving_problem_has_the_compiled_sizes(serving):
    ocp, terms, rows = serving["ocp"], serving["terms"], serving["rows"]
    assert RiccatiRows.from_ocp(serving["al"].inner.ocp) == rows
    sizes = k5.kernel_sizes(terms, ocp.nx, ocp.nu, rows)
    assert sizes == k5.KERNEL_SHAPES["kangaroo"]
    # the packed parameter row is the widths of PARAM_KEYS, and the row
    # counts are those K1's isrbd instantiation is compiled for
    assert len(k5.PARAM_KEYS) == len(terms.param_dims())
    k1_shape = k1.KERNEL_SHAPES["isrbd_al"]
    assert {k: sizes[k] for k in k1_shape if k in sizes} == {
        k: v for k, v in k1_shape.items() if k in sizes}
    assert k1_shape["nt"] == sizes["n_term"]
    for name in NAMES:
        assert k5.check_kernel_shape(
            name, terms, ocp.nx, ocp.nu,
            rows if name == "isrbd_linearize" else None) == "kangaroo"


@pytest.fixture(scope="module")
def quadruped():
    """The AL inner problem of the constrained quadruped example."""
    robot = quadruped_point_feet()
    cfg = SRBDConfig(dtype=torch.float64, contact_model=1, number_of_legs=4,
                     lip_height=float(robot.com[2]))
    prob, al = _solver(robot, cfg, cz_rho_weight=None)
    return dict(prob=prob, al=al, ocp=prob.ocp, terms=al.terms,
                rows=al.inner.rows)


def test_quadruped_problem_has_the_compiled_sizes(quadruped):
    """The quadruped's AL inner problem has QuadAlShape's sizes (236 stage
    rows, 97 terminal rows, 17 + 8 equality rows, no rel-vel rows), and K1
    sweeps it at its `isrbd_al_quadruped` shape."""
    ocp, terms, rows = quadruped["ocp"], quadruped["terms"], quadruped["rows"]
    assert RiccatiRows.from_ocp(quadruped["al"].inner.ocp) == rows
    sizes = k5.kernel_sizes(terms, ocp.nx, ocp.nu, rows)
    assert sizes == k5.KERNEL_SHAPES["quadruped"]
    assert terms.outer.n_relvel == 0
    for name in NAMES:
        assert k5.check_kernel_shape(
            name, terms, ocp.nx, ocp.nu,
            rows if name == "isrbd_linearize" else None) == "quadruped"
    assert k5.shape_index("quadruped") == 1 and k5.shape_index("kangaroo") == 0
    k1_shape = k1.KERNEL_SHAPES["isrbd_al_quadruped"]
    assert {k: sizes[k] for k in k1_shape if k in sizes} == {
        k: v for k, v in k1_shape.items() if k in sizes}
    assert k1_shape["nt"] == sizes["n_term"]
    assert k1.kernel_shape(ocp.nx, ocp.nu, terms.n_term, rows) == "isrbd_al_quadruped"


def test_quadruped_wrappers_pass_the_shape_check_off_the_cpu(quadruped):
    """At the quadruped's sizes K5, K6 and isrbd_evaluate pass the shape
    check on meta tensors and stop at the device check."""
    c = quadruped
    for name, (fn, args) in _meta_args(
            dict(terms=c["terms"], ocp=c["ocp"], rows=c["rows"])).items():
        launches = fn.launches
        with pytest.raises(ValueError, match="runs on cpu or cuda"):
            fn(*args)
        assert fn.launches == launches, name


def _drop_last(rows, field):
    kw = {f: getattr(rows, f) for f in ("rx", "ru", "gx", "gu", "bx", "bu", "uc")}
    kw[field] = kw[field][:-1]
    return RiccatiRows(**kw)


def _changed(serving, change):
    """(terms, nx, nu, rows) of the serving problem with one size changed."""
    terms, rows = serving["terms"], serving["rows"]
    nx, nu = serving["ocp"].nx, serving["ocp"].nu
    if change == "nx":
        nx -= 1
    elif change == "nu":
        nu -= 1
    elif change in ("nc", "contact_model", "number_of_legs"):
        outer = terms.outer
        terms = dataclasses.replace(
            terms, outer=dataclasses.replace(outer, **{change: getattr(outer, change) - 1}))
    elif change in ("n_eq", "n_eq_T", "n_ineq"):
        terms = dataclasses.replace(terms, **{change: getattr(terms, change) - 1})
    else:
        rows = _drop_last(rows, change)
    return terms, nx, nu, rows


@pytest.mark.parametrize("change", [
    "nx", "nu", "nc", "contact_model", "number_of_legs", "n_eq", "n_eq_T",
    "n_ineq", "rx", "ru", "gx", "gu", "bx", "uc"])
def test_check_kernel_shape_refuses_other_sizes(serving, change):
    terms, nx, nu, rows = _changed(serving, change)
    with pytest.raises(ValueError, match="no kernel for the sizes") as info:
        k5.check_kernel_shape("isrbd_linearize", terms, nx, nu, rows)
    assert "isrbd_common.cuh" in str(info.value)


def _meta_args(serving, change=None, B=2):
    """Arguments of K5, K6 and isrbd_evaluate on meta tensors of the serving
    problem, with one size changed (None: the compiled sizes)."""
    terms, nx, nu, rows = (_changed(serving, change) if change else
                           (serving["terms"], serving["ocp"].nx,
                            serving["ocp"].nu, serving["rows"]))
    ns, dt = serving["ocp"].ns, serving["ocp"].dt
    if change == "nc":
        nx, nu = 13 + 6 * terms.outer.nc, 6 + 6 * terms.outer.nc
    e = lambda *shape: torch.empty(shape, dtype=torch.float64, device="meta")
    params = {k: e(B, ns + 1, dim)
              for k, dim in zip(k5.PARAM_KEYS, terms.param_dims())}
    X, U = e(B, ns + 1, nx), e(B, ns, nu)
    lin = (X, U, params, terms, rows, dt)
    trial = (e(B, nx), X, U, e(B, ns, nu), e(B, ns, nu, nx), e(B, ns, nx),
             e(1), params, e(B), e(B), e(B), e(B), terms, dt, 1e-3, 0.1, 1e-12)
    ev = (X, U, params, terms, dt)
    return {"isrbd_linearize": (k5.isrbd_linearize, lin),
            "isrbd_trial": (k6.isrbd_trial, trial),
            "isrbd_evaluate": (k6.isrbd_evaluate, ev)}


@pytest.mark.parametrize("name,change", [
    ("isrbd_linearize", "nc"), ("isrbd_linearize", "n_eq"),
    ("isrbd_linearize", "gu"), ("isrbd_trial", "nc"), ("isrbd_trial", "n_eq"),
    ("isrbd_evaluate", "nc"), ("isrbd_evaluate", "n_eq_T")])
def test_wrappers_refuse_other_sizes_off_the_cpu(serving, name, change):
    fn, args = _meta_args(serving, change)[name]
    launches = fn.launches
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        fn(*args)
    # the compiled sizes pass the shape check and stop at the device check
    fn, args = _meta_args(serving)[name]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        fn(*args)
    assert fn.launches == launches


@pytest.fixture(scope="module")
def eight_contacts():
    """The line-feet quadruped, contact_model=2 on four legs (nc=8, nx=61,
    nu=54), as tests/test_configs.py builds it in JAX: two contacts 5 cm
    either side of each point foot."""
    q = quadruped_point_feet()
    feet = []
    for p in np.asarray(q.foot_positions):
        feet += [p + [0.05, 0.0, 0.0], p - [0.05, 0.0, 0.0]]
    robot = dataclasses.replace(q, foot_positions=np.asarray(feet),
                                foot_frames=tuple(f"c{i}" for i in range(8)))
    cfg = SRBDConfig(dtype=torch.float64, contact_model=2, number_of_legs=4,
                     lip_height=float(q.com[2]), ns=4)
    prob, al = _solver(robot, cfg, cz_rho_weight=None)
    return dict(terms=al.terms, ocp=prob.ocp, rows=al.inner.rows)


@pytest.mark.parametrize("name", NAMES)
def test_eight_contact_quadruped_is_refused_off_the_cpu(eight_contacts, name):
    c = eight_contacts
    assert (c["ocp"].nx, c["ocp"].nu, c["terms"].outer.nc) == (61, 54, 8)
    fn, args = _meta_args(c)[name]
    launches = fn.launches
    with pytest.raises(ValueError, match=r"no kernel for the sizes .*'nc': 8"):
        fn(*args)
    assert fn.launches == launches


@pytest.fixture(scope="module")
def six_contacts():
    """An isrbd problem of other sizes: two legs of three contacts each
    (nc=6, nx=49, nu=42), a short horizon, on the CPU in float64."""
    line = kangaroo_line_feet()
    w = line.foot_positions[2, 1]
    feet = np.array([[0.08, 0.0, 0.0], [0.0, 0.0, 0.0], [-0.08, 0.0, 0.0],
                     [0.08, w, 0.0], [0.0, w, 0.0], [-0.08, w, 0.0]])
    robot = RobotConstants(mass=line.mass, inertia=line.inertia, com=line.com,
                           foot_positions=feet, foot_frames=tuple(f"f{i}" for i in range(6)))
    prob, al = _solver(robot, SRBDConfig(dtype=torch.float64, ns=4, contact_model=3))
    ocp = prob.ocp
    B, ns, nx, nu = 2, ocp.ns, ocp.nx, ocp.nu
    g = np.random.RandomState(3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    X = prob.initial_state[None, None] + t(0.01 * g.randn(B, ns + 1, nx))
    U = prob.static_input[None, None] + t(0.1 * g.randn(B, ns, nu))
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    pin = {k: v.contiguous() for k, v in
           al._params_with_multipliers(params, al.init(X[:, 0])).items()}
    return dict(al=al, ocp=ocp, X=X, U=U, pin=pin, g=g, t=t)


@pytest.mark.parametrize("name", NAMES)
def test_wrappers_take_plain_twins_at_other_sizes_on_cpu(six_contacts, name):
    """CPU tensors of sizes no kernel is compiled for go to the twins."""
    c = six_contacts
    al, ocp, X, U, pin = c["al"], c["ocp"], c["X"], c["U"], c["pin"]
    terms, rows, dt = al.terms, al.inner.rows, ocp.dt
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k5.check_kernel_shape(name, terms, ocp.nx, ocp.nu,
                              rows if name == "isrbd_linearize" else None)
    if name == "isrbd_linearize":
        pairs = [(k5.isrbd_linearize, k5.isrbd_linearize_plain,
                  (X, U, pin, terms, rows, dt))]
    elif name == "isrbd_evaluate":
        pairs = [(k6.isrbd_evaluate, k6.isrbd_evaluate_plain, (X, U, pin, terms, dt))]
    else:
        B, ns, nx, nu = X.shape[0], ocp.ns, ocp.nx, ocp.nu
        g, t = c["g"], c["t"]
        args = (X[:, 0] + t(0.001 * g.randn(B, nx)), X, U, t(0.01 * g.randn(B, ns, nu)),
                t(0.01 * g.randn(B, ns, nu, nx)), t(0.001 * g.randn(B, ns, nx)),
                t([1.0, 0.5]), pin, t(g.rand(B) + 1e3), t(g.rand(B)), t(-g.rand(B)),
                t(g.rand(B)), terms, dt, 1e-3, 0.1, 1e-12)
        pairs = [(k6.isrbd_trial, k6.isrbd_trial_plain, args)]
    for fn, plain, args in pairs:
        launches = fn.launches
        got, want = fn(*args), plain(*args)
        items = got.items() if isinstance(got, dict) else enumerate(got)
        for key, value in items:
            assert torch.equal(value, want[key]), key
        assert fn.launches == launches
