"""PyTorch port, the JAX package's two other execution modes —
`riccati_mode="associative"` (K12) and `forward_pass="linear"` (K13) — run
through the normal entry points in float64 on the CPU (the kernels' plain
twins), against the JAX package with the same options:

- `MSDDP.solve` under the three non-default combinations on a pushed
  Kangaroo start: iterations equal, X, U and cost to 1e-9;
- the LIP's `TestModeEquivalence` (tests/test_parallel_riccati.py)
  mirrored: every combination within 5e-5 of sequential/nonlinear with
  its defects closed, and each against JAX's solve to 1e-6 (the LIP runs
  its last iterations on the merit's rounding floor, F8);
- (`solve_batch` and `MPCLoop.tick_batch` under the modes:
  tests/test_torch_modes_fleet.py);
- the sequential line search ignores `forward_pass`, as in JAX;
- `MPCLoop.tick`/`run` pass the options through;
- the modes are refused (NotImplementedError) where K12/K13 have no
  instantiation: a six-contact isrbd problem through `ALDDP`, the AL inner
  OCP with the block-Schur gain solve under the associative sweep; and
  `family_index` / `kernel_instance` raise ValueError at sizes no kernel
  has. (The quadruped, both AL inner OCPs, the point-feet biped and every
  SRBD topology under RK2/RK4 run the modes:
  tests/test_torch_modes_quadruped.py, test_torch_modes_alddp.py,
  test_torch_modes_quadruped_al.py, test_torch_modes_point_feet.py,
  test_torch_modes_{kangaroo,quadruped,point_feet}_rk.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    isrbd_problems,
    jit,
    max_rel_err,
    np_of,
    perturbed_states,
    problems,
    solvers,
    to_jax,
    to_torch,
)
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet as j_feet
from srbd_horizon_tpu.problems.lip import build_lip_problem as j_build_lip
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import linear_trial as k13
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.models.kangaroo import RobotConstants, kangaroo_line_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.runtime.loop import MPCLoop as TLoop
from srbd_horizon_tpu_torch.runtime.loop import TickInput, walking_schedule
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP, ALOptions
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

torch.set_num_threads(1)

MODES = [("associative", "nonlinear"), ("sequential", "linear"),
         ("associative", "linear")]
MODE_IDS = ["associative-nonlinear", "sequential-linear", "associative-linear"]
LIP_OPTS = dict(max_iters=60, alpha_converge_threshold=1e-12, beta=1e-3)
FLEET_MODE = dict(riccati_mode="associative", forward_pass="linear")


def _modes(riccati, forward):
    return dict(riccati_mode=riccati, forward_pass=forward)


@pytest.fixture(scope="module")
def srbd():
    jp, tp = problems()
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    params["rdot_ref"] = params["rdot_ref"].copy()
    params["rdot_ref"][-1] = [0.3, 0.0, 0.0]
    x0 = perturbed_states(jp.initial_state, 1, seed=7, scale=0.01)[0]
    return jp, tp, params, x0


@pytest.fixture(scope="module")
def srbd_solves(srbd):
    """Per combination: JAX's solve and the port's from the pushed start,
    with the port's kernel wrappers' call counts."""
    jp, tp, params, x0 = srbd
    out = {}
    for mode in MODES:
        js, ts = solvers(jp, tp, max_iters=20, **_modes(*mode))
        jsol = jit(js.solve)(js.init(to_jax(x0)), to_jax(x0), to_jax(params))
        calls = {"k12": 0, "k13": 0}
        backward, trial = ts._backward_associative, ts._trial

        def spy_backward(*a):
            calls["k12"] += 1
            return backward(*a)

        def spy_trial(*a):
            calls["k13"] += len(a) > 12 and a[12] is not None
            return trial(*a)

        ts._backward_associative, ts._trial = spy_backward, spy_trial
        tsol = ts.solve(ts.init(to_torch(x0)), to_torch(x0), to_torch(params))
        out[mode] = dict(jax=jsol, torch=tsol, calls=calls)
    return out


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_solve_matches_jax(srbd_solves, mode):
    r = srbd_solves[mode]
    jsol, tsol = r["jax"], r["torch"]
    assert int(tsol.iterations) == int(jsol.iterations) > 1
    assert bool(tsol.converged) == bool(jsol.converged)
    for f in ("X", "U", "cost"):
        assert max_rel_err(getattr(tsol, f), getattr(jsol, f)) < 1e-9, f
    assert abs(float(tsol.defect_norm) - float(jsol.defect_norm)) < 1e-12
    iters = int(tsol.iterations)
    # K12 once an iteration under the associative sweep; K13 once a chunk
    # (one chunk an iteration here) under the linear pass
    assert r["calls"]["k12"] == (iters if mode[0] == "associative" else 0)
    assert r["calls"]["k13"] == (iters if mode[1] == "linear" else 0)


@pytest.fixture(scope="module")
def lip():
    jp = j_build_lip(JSRBDConfig(dtype=jnp.float64), j_feet())
    tp = build_lip_problem(SRBDConfig(dtype=torch.float64), kangaroo_line_feet(),
                           device="cpu")
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    params["rdot_ref"] = params["rdot_ref"].copy()
    params["rdot_ref"][-1] = [0.2, 0.1, 0.0]
    x0 = np.asarray(jp.initial_state)
    out = {}
    for mode in [("sequential", "nonlinear")] + MODES:
        ts = MSDDP(tp.ocp, DDPOptions(**LIP_OPTS, **_modes(*mode)))
        tsol = ts.solve(ts.init(to_torch(x0)), to_torch(x0), to_torch(params))
        jsol = None
        if mode != ("sequential", "nonlinear"):
            js = JMSDDP(jp.ocp, JDDPOptions(**LIP_OPTS, **_modes(*mode)))
            jsol = jit(js.solve)(js.init(to_jax(x0)), to_jax(x0),
                                 to_jax(params))
        out[mode] = (jsol, tsol)
    return out


def test_lip_all_modes_reach_same_solution(lip):
    """tests/test_parallel_riccati.py::TestModeEquivalence on the port."""
    ref = lip["sequential", "nonlinear"][1]
    for mode in MODES:
        sol = lip[mode][1]
        np.testing.assert_allclose(np_of(sol.X), np_of(ref.X), atol=5e-5,
                                   err_msg=str(mode))
        assert float(sol.defect_norm) < 1e-6, mode


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_lip_modes_match_jax(lip, mode):
    jsol, tsol = lip[mode]
    assert int(tsol.iterations) == int(jsol.iterations)
    assert bool(tsol.converged) == bool(jsol.converged)
    assert max_rel_err(tsol.cost, jsol.cost) < 1e-9
    for f in ("X", "U"):
        assert max_rel_err(getattr(tsol, f), getattr(jsol, f)) < 1e-6, f


def test_sequential_line_search_ignores_linear_forward_pass(srbd):
    """The sequential backtracking always rolls out, as JAX's `ls_body`
    (msddp.py:1629-1661) does: with forward_pass="linear" the solve is the
    nonlinear one, bit for bit, and K13 never launches."""
    jp, tp, params, x0 = srbd
    _, ts_lin = solvers(jp, tp, max_iters=20, line_search_mode="sequential",
                        riccati_mode="associative", forward_pass="linear")
    _, ts_non = solvers(jp, tp, max_iters=20, line_search_mode="sequential",
                        riccati_mode="associative")
    args = (to_torch(x0), to_torch(params))
    linear_calls = []
    trial = ts_lin._trial
    ts_lin._trial = lambda *a: linear_calls.append(a[12:]) or trial(*a)
    a = ts_lin.solve(ts_lin.init(args[0]), *args)
    b = ts_non.solve(ts_non.init(args[0]), *args)
    for f in ("X", "U", "cost", "iterations", "converged"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert linear_calls and all(not lin or lin[0] is None
                                for lin in linear_calls)
    assert int(a.iterations) > 1 and bool(a.converged)


def test_tick_and_run_pass_the_modes_through(srbd):
    """`MPCLoop.tick` and `run` on a solver under associative/linear: `run`
    over 3 ticks equals 3 `tick`s, and each solve went through the
    associative sweep and the linear trial."""
    _, tp, _, _ = srbd
    ts = MSDDP(tp.ocp, DDPOptions(max_iters=5, **FLEET_MODE))
    loop = TLoop(solver=ts, wpg=TWPG.build(0.0, tp.ocp.ns, dtype=torch.float64,
                                           device="cpu"),
                 srbd_constants=tp.ocp.constants)
    sched = walking_schedule(3, vx=0.3, start=1, dtype=torch.float64,
                             device="cpu")
    calls = {"k12": 0}
    backward = ts._backward_associative

    def spy(*a):
        calls["k12"] += 1
        return backward(*a)

    ts._backward_associative = spy
    c = loop.init(tp.initial_state)
    outs = []
    for i in range(3):
        c, o = loop.tick(c, TickInput(*(a[i] for a in sched)))
        outs.append(o)
    assert calls["k12"] == sum(int(o.iterations) for o in outs) > 0
    c2, o2 = loop.run(loop.init(tp.initial_state), sched)
    np.testing.assert_array_equal(np_of(o2.x[-1]), np_of(outs[-1].x))
    np.testing.assert_array_equal(np_of(c2.sol.U), np_of(c.sol.U))
    assert float(outs[-1].defect_norm) < 1e-6


@pytest.fixture(scope="module")
def six_contacts():
    """An isrbd problem no kernel is compiled for: two legs of three
    contacts each (nc=6, nx=49, nu=42), ns=4."""
    line = kangaroo_line_feet()
    w = line.foot_positions[2, 1]
    feet = np.array([[0.08, 0.0, 0.0], [0.0, 0.0, 0.0], [-0.08, 0.0, 0.0],
                     [0.08, w, 0.0], [0.0, w, 0.0], [-0.08, w, 0.0]])
    robot = RobotConstants(mass=line.mass, inertia=line.inertia, com=line.com,
                           foot_positions=feet,
                           foot_frames=tuple(f"f{i}" for i in range(6)))
    return build_isrbd_problem(SRBDConfig(dtype=torch.float64, ns=4,
                                          contact_model=3), robot,
                               device="cpu")


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_modes_refused_on_a_shape_without_kernels(six_contacts, mode):
    """`ALDDP` hands its `ddp_opts` to the inner solver (as JAX's
    alddp.py:331 does): on a problem no K12/K13 instantiation has, the
    solver refuses the modes on every device, naming the ROADMAP, and takes
    the defaults."""
    opts = DDPOptions(**_modes(*mode))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ALDDP(six_contacts.ocp, opts, ALOptions())
    ALDDP(six_contacts.ocp, DDPOptions(), ALOptions())


def test_associative_sweep_refused_without_its_gain_solve():
    """At the AL inner shape K12 has the Cholesky gain solve only (the AL
    solver always takes it): an MSDDP on that OCP under the associative
    sweep with the block-Schur solve is refused; the linear pass alone,
    whose sweep is K1's, and the Cholesky sweep are not."""
    _, tip = isrbd_problems(ns=8)
    inner = ALDDP(tip.ocp, DDPOptions(), ALOptions()).inner.ocp
    with pytest.raises(NotImplementedError, match="quu_solver='schur'"):
        MSDDP(inner, DDPOptions(riccati_mode="associative"))
    MSDDP(inner, DDPOptions(riccati_mode="associative", quu_solver="cholesky"))
    MSDDP(inner, DDPOptions(forward_pass="linear"))


@pytest.mark.parametrize("change", ["gx", "ru", "uc"])
def test_kernel_lookups_refuse_sizes_without_a_kernel(srbd, change):
    """`family_index` (K13) and `kernel_instance` (K12) raise ValueError,
    naming what was compiled, for row sets of a size no kernel has."""
    _, tp, _, _ = srbd
    ts = MSDDP(tp.ocp, DDPOptions())
    ocp, rows = tp.ocp, ts.rows
    assert k13.family_index(ts.terms, ocp.nx, ocp.nu, rows) == 0
    kw = {f: getattr(rows, f) for f in ("rx", "ru", "gx", "gu", "bx", "bu",
                                         "uc")}
    kw[change] = kw[change][:-1]
    other = k1.RiccatiRows(**kw)
    with pytest.raises(ValueError, match="linear_trial has no kernel"):
        k13.family_index(ts.terms, ocp.nx, ocp.nu, other)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k12.kernel_instance(ocp.nx, ocp.nu, 15, other, "schur")
    with pytest.raises(ValueError, match="riccati_associative has no kernel"):
        k12.shape_instance("isrbd_al", "schur")


def test_wrappers_name_their_kernels():
    """K12 and K13 name the JAX functions they replace and their sources;
    K12 is built for K1's six SRBD and six LIP shapes with both gain solves
    and for the two AL shapes with Cholesky (26 instantiations); K13 for a
    family at each of those fourteen shapes, two at each SRBD and LIP RK
    shape (RK2 and RK4 share K1's shape, not K13's step; 20 families),
    each family named once in `FAMILY_NAMES`."""
    assert k12.REPLACES == "srbd_horizon_tpu/solvers/msddp.py:1250"
    assert k13.REPLACES == "srbd_horizon_tpu/solvers/msddp.py:1454"
    al = {"isrbd_al", "isrbd_al_quadruped"}
    lip_rest = {"lip_rk", "lip_quadruped", "lip_quadruped_rk",
                "lip_point_feet", "lip_point_feet_rk"}
    # K1's eight-contact shapes (the square-feet biped, contact_model=4,
    # and the line-feet quadruped, contact_model=2 on four legs) have no
    # K12 or K13 yet
    square = set(k1.SQUARE_FEET_SHAPES)
    line = set(k1.LINE_FEET_SHAPES)
    assert len(k1.KERNEL_SHAPES) == 22 and lip_rest <= set(k1.KERNEL_SHAPES)
    assert len(square) == 4 and square <= set(k1.KERNEL_SHAPES)
    assert len(line) == 4 and line <= set(k1.KERNEL_SHAPES)
    modes = set(k1.KERNEL_SHAPES) - square - line
    assert {s for s, _ in k12.KERNEL_INSTANCES} == modes
    assert set(k12.KERNEL_INSTANCES) == {
        (s, q) for s in modes - al for q in k1.QUU_SOLVERS
    } | {(s, "cholesky") for s in al}
    assert len(k12.KERNEL_INSTANCES) == 26
    assert {f[2] for f in k13.FAMILIES} == modes
    rk = [f[2] for f in k13.FAMILIES if f[2].endswith("_rk")]
    assert sorted(rk) == sorted(2 * ["srbd_rk", "quadruped_rk",
                                     "point_feet_rk", "lip_rk",
                                     "lip_quadruped_rk", "lip_point_feet_rk"])
    assert len(set(k13.FAMILY_NAMES)) == len(k13.FAMILIES) == 20
    assert k13.SOURCE.endswith("linear_trial.cu") and k3.SOURCE != k13.SOURCE
