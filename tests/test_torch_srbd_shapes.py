"""PyTorch port, the compile-time sizes of the SRBD kernels, on the CPU.

K3 (the trial), srbd_evaluate (csrc/srbd_rollout.cu) and K4 (the
linearization, csrc/srbd_linearize.cu) are compiled for five topologies,
`srbd::KangarooShape`, `srbd::QuadShape`, `srbd::PointFeetShape`,
`srbd::SquareFeetShape` and `srbd::LineFeetQuadShape` in
csrc/srbd_common.cuh, each under the Euler, RK2 and RK4 steps. These tests
hold those structs and the instance order against
`kernels/linearize.py::TOPOLOGIES` and `KERNEL_SHAPES` and against what
`build_srbd_problem` gives for the Kangaroo, the point-feet quadruped, the
point-feet biped, the square-feet biped and the line-feet quadruped, and check that the wrappers refuse other sizes (a
problem with three contacts, a one-legged biped on line feet) with a
ValueError that names them before any device work (meta tensors stand in
for CUDA ones), while CPU tensors take the plain twins.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from _line_feet_quadruped import LINE_FEET_TOPOLOGY, line_feet_quadruped
from _square_feet import SQUARE_TOPOLOGY, square_feet
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.kernels.riccati import RiccatiRows
from srbd_horizon_tpu_torch.models.kangaroo import point_feet
from srbd_horizon_tpu_torch.runtime.loop import build_quadruped_loop, build_srbd_loop

torch.set_num_threads(1)

HEADER = Path(k4.__file__).resolve().parents[1] / "csrc" / "srbd_common.cuh"
STEP_TAGS = HEADER.with_name("rigid_common.cuh")


@pytest.fixture(scope="module")
def srbd():
    loop, prob = build_srbd_loop(SRBDConfig(dtype=torch.float64),
                                 DDPOptions(max_iters=1), device="cpu")
    s = loop.solver
    return dict(ocp=prob.ocp, terms=s.terms, rows=s.rows, wc=s._wc(torch.float64),
                prob=prob)


def test_shape_struct_matches_the_wrappers_table():
    """TOPOLOGIES, in order, is the header's KangarooShape, QuadShape,
    PointFeetShape, SquareFeetShape, LineFeetQuadShape; KERNEL_SHAPES is
    the first three under the Euler step, then each under RK2 and RK4 with
    every row of B live (the header's `Stepped`), then the square feet and
    the line-feet quadruped, each under the three steps, in the order of
    the header's `with_shape`; STEPS is its step tags' order."""
    src = HEADER.read_text()
    found = re.findall(r"struct (\w+Shape) \{\s*static constexpr int ([^;]*);",
                       src)
    assert [name for name, _ in found] == ["KangarooShape", "QuadShape",
                                           "PointFeetShape", "SquareFeetShape",
                                           "LineFeetQuadShape"]
    parsed = [{k.strip(): int(v) for k, v in
               (kv.split("=") for kv in body.split(","))} for _, body in found]
    assert parsed == list(k4.TOPOLOGIES.values())
    assert list(k4.TOPOLOGIES) == ["kangaroo", "quadruped", "point_feet",
                                   "square_feet", "line_feet_quadruped"]
    with_shape = src[src.index("inline int with_shape("):]
    cases = re.findall(r"case (\d+): return fn\((?:Stepped<)?(\w+)Shape"
                       r"(?:, (\w+)>)?", with_shape[:with_shape.index("default")])
    names = {"Kangaroo": "kangaroo", "Quad": "quadruped",
             "PointFeet": "point_feet", "SquareFeet": "square_feet",
             "LineFeetQuad": "line_feet_quadruped"}
    assert [int(i) for i, _, _ in cases] == list(range(len(k4.KERNEL_SHAPES)))
    order = [names[topo] + ("_" + step.lower() if step else "")
             for _, topo, step in cases]
    assert order == list(k4.KERNEL_SHAPES)
    for name, want in k4.KERNEL_SHAPES.items():
        topology, _, step = name.partition("_rk")
        topo = dict(k4.TOPOLOGIES[topology if step else name])
        if step:
            topo["n_ru"] = topo["nx"]
        assert want == dict(topo, step="RK" + step if step else "EULER")
    ids = re.findall(r"struct (Euler|Rk2|Rk4) \{\s*static constexpr int "
                     r"id = (\d+)", STEP_TAGS.read_text())
    assert [(n.upper(), int(i)) for n, i in ids] == [
        (st, i) for i, st in enumerate(k4.STEPS)]


@pytest.fixture(scope="module")
def quad():
    loop, prob = build_quadruped_loop(
        SRBDConfig(contact_model=1, number_of_legs=4, dtype=torch.float64),
        DDPOptions(max_iters=1), device="cpu")
    s = loop.solver
    return dict(ocp=prob.ocp, terms=s.terms, rows=s.rows,
                wc=s._wc(torch.float64), prob=prob)


@pytest.fixture(scope="module")
def point_feet_biped():
    loop, prob = build_srbd_loop(
        SRBDConfig(contact_model=1, number_of_legs=2, dtype=torch.float64),
        DDPOptions(max_iters=1), robot=point_feet(), device="cpu")
    s = loop.solver
    return dict(ocp=prob.ocp, terms=s.terms, rows=s.rows,
                wc=s._wc(torch.float64), prob=prob)


@pytest.fixture(scope="module")
def square_feet_biped():
    loop, prob = build_srbd_loop(
        SRBDConfig(dtype=torch.float64, **SQUARE_TOPOLOGY),
        DDPOptions(max_iters=1), robot=square_feet(), device="cpu")
    s = loop.solver
    return dict(ocp=prob.ocp, terms=s.terms, rows=s.rows,
                wc=s._wc(torch.float64), prob=prob)


@pytest.fixture(scope="module")
def line_feet_quad():
    loop, prob = build_srbd_loop(
        SRBDConfig(dtype=torch.float64, **LINE_FEET_TOPOLOGY),
        DDPOptions(max_iters=1), robot=line_feet_quadruped(), device="cpu")
    s = loop.solver
    return dict(ocp=prob.ocp, terms=s.terms, rows=s.rows,
                wc=s._wc(torch.float64), prob=prob)


@pytest.mark.parametrize("shape", ["kangaroo", "quadruped", "point_feet",
                                   "square_feet", "line_feet_quadruped"])
def test_srbd_problem_has_the_compiled_sizes(srbd, quad, point_feet_biped,
                                             square_feet_biped, line_feet_quad,
                                             shape):
    case = {"kangaroo": srbd, "quadruped": quad,
            "point_feet": point_feet_biped,
            "square_feet": square_feet_biped,
            "line_feet_quadruped": line_feet_quad}[shape]
    ocp = case["ocp"]
    assert RiccatiRows.from_ocp(ocp) == case["rows"]
    sizes = k4.kernel_sizes(case["terms"], ocp.nx, ocp.nu, case["rows"])
    assert sizes == k4.KERNEL_SHAPES[shape]
    assert k4.check_kernel_shape("srbd_linearize", case["terms"], ocp.nx,
                                 ocp.nu, case["rows"]) == shape
    assert k4.shape_index(shape) == list(k4.KERNEL_SHAPES).index(shape)


def _drop_last(rows, field):
    kw = {f: getattr(rows, f) for f in ("rx", "ru", "gx", "gu", "bx", "bu", "uc")}
    kw[field] = kw[field][:-1]
    return RiccatiRows(**kw)


@pytest.mark.parametrize("change", ["nx", "nu", "nc", "contact_model",
                                    "number_of_legs", "rx", "ru", "gx", "gu"])
def test_check_kernel_shape_refuses_other_sizes(srbd, change):
    terms, rows = srbd["terms"], srbd["rows"]
    nx, nu = srbd["ocp"].nx, srbd["ocp"].nu
    if change == "nx":
        nx -= 1
    elif change == "nu":
        nu -= 1
    elif change in ("nc", "contact_model", "number_of_legs"):
        terms = dataclasses.replace(terms, **{change: getattr(terms, change) - 1})
    else:
        rows = _drop_last(rows, change)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k4.check_kernel_shape("srbd_linearize", terms, nx, nu, rows)


def _meta_args(srbd, nc, B=2, **topology):
    """Arguments of K4, K3 and srbd_evaluate on meta tensors of an SRBD
    layout with nc contacts (the problem's own terms, with nc and the
    `topology` fields replaced)."""
    ns = srbd["ocp"].ns
    nx, nu = 13 + 6 * nc, 6 * nc
    terms = dataclasses.replace(srbd["terms"], nc=nc, **topology)
    e = lambda *shape: torch.empty(shape, dtype=torch.float64, device="meta")
    params = {k: e(B, ns + 1, v.shape[-1])
              for k, v in srbd["ocp"].params.items()}
    X, U = e(B, ns + 1, nx), e(B, ns, nu)
    dt, wc = srbd["ocp"].dt, srbd["wc"]
    lin = (X, U, params, terms, srbd["rows"], dt, wc)
    al = e(1)
    trial = (e(B, nx), X, U, e(B, ns, nu), e(B, ns, nu, nx), e(B, ns, nx), al,
             params, e(B), e(B), e(B), e(B), terms, dt, wc, 1e-3, 0.1, 1e-12)
    ev = (X, U, params, terms, dt, wc)
    return {"srbd_linearize": (k4.srbd_linearize, lin),
            "srbd_trial": (k3.srbd_trial, trial),
            "srbd_evaluate": (k3.srbd_evaluate, ev)}


@pytest.mark.parametrize("name", ["srbd_linearize", "srbd_trial",
                                  "srbd_evaluate"])
def test_wrappers_refuse_other_sizes_off_the_cpu(srbd, quad, point_feet_biped,
                                                 name):
    fn, args = _meta_args(srbd, nc=3)[name]
    launches = fn.launches
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        fn(*args)
    # the biped on point feet with the Kangaroo's two points a foot (nc 2,
    # cm 2, one leg) has no kernel either
    fn, args = _meta_args(srbd, nc=2, number_of_legs=1)[name]
    with pytest.raises(ValueError, match=r"no kernel for the sizes .*'nx': 25"):
        fn(*args)
    # the compiled sizes pass the shape check and stop at the device check
    for case, nc in ((srbd, 4), (quad, 4), (point_feet_biped, 2)):
        fn, args = _meta_args(case, nc=nc)[name]
        with pytest.raises(ValueError, match="runs on cpu or cuda"):
            fn(*args)
    assert fn.launches == launches


def test_wrappers_take_plain_twins_at_any_size_on_cpu(srbd):
    """CPU tensors of sizes no kernel is compiled for go to the twins."""
    prob = srbd["prob"]
    ocp, terms = srbd["ocp"], srbd["terms"]
    ns = 3
    X = prob.initial_state[None, None].expand(2, ns + 1, -1).contiguous()
    U = prob.static_input[None, None].expand(2, ns, -1).contiguous()
    params = {k: v[None, : ns + 1].expand(2, -1, -1).contiguous()
              for k, v in ocp.params.items()}
    got = k3.srbd_evaluate(X, U, params, terms, ocp.dt, srbd["wc"])
    want = k3.srbd_evaluate_plain(X, U, params, terms, ocp.dt, srbd["wc"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
