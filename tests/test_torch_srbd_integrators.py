"""PyTorch port, the SRBD problem under RK2 and RK4 at each of the three
contact topologies (the Kangaroo's line feet, the point-feet quadruped,
the point-feet biped), against the JAX package on the CPU in float64:

  - `ocp.step` against JAX's to 1e-13;
  - the row declaration: at drawn points B is nonzero only in
    `dynamics_u_rows` (every state row under RK) and A − I only in
    `dynamics_x_rows` (Euler's: r, o, c, ω), by `torch.func.jacfwd` of the
    port's step;
  - the K4 twin's Sx and Bs against JAX's dense `jacfwd` of its step and
    its residual blocks against JAX's dense residual Jacobians (the port's
    rows sliced out), to 1e-12;
  - the K3 twin (1 and 4 step sizes, a NaN member) and the srbd_evaluate
    twin (without and with the pin) against JAX's `_rollout`,
    `total_cost`, Armijo test and `_true_defects`, to 1e-12;
  - the dispatch: K4's, K3's and srbd_evaluate's shape check and K1's
    `kernel_shape` / `kernel_instance` pick the RK instance and never the
    Euler one, K13's `family_index` finds the step's own family and
    `MSDDP` builds the two other execution modes there (the SRBD problem
    at contact_model=3 is refused them, naming ROADMAP.md).

The solves and ticks under these steps are in
`test_torch_srbd_integrators_<topology>.py`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    fleet_params, jax_evaluate, jax_trial, jit, max_rel_err, np_of,
    perturbed_states, random_xup, six_contact_srbd, solvers, srbd_problems,
    to_jax, to_torch, trajectories,
)
from srbd_horizon_tpu_torch.config import DDPOptions
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.kernels.linear_trial import FAMILIES, family_index
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

CASES = [(t, s) for t in ("kangaroo", "quadruped", "point_feet")
         for s in ("RK2", "RK4")]
IDS = [f"{t}-{s}" for t, s in CASES]
ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
TOL = 1e-12
MU = 1e-6
B = 4
NAN_MEMBER = 1
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])
# the Euler-shape names of K4's table and K1's, by topology
EULER_K4 = {"kangaroo": "kangaroo", "quadruped": "quadruped",
            "point_feet": "point_feet"}
K1_RK = {"kangaroo": "srbd_rk", "quadruped": "quadruped_rk",
         "point_feet": "point_feet_rk"}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """One (topology, step): both problems, solvers, a point near the
    walk (plans around the nominal state, random references and 0/1
    switches), JAX's dense and sliced linearizations and its collapsed
    sweep of the port's linearization, and the K4 twin's."""
    topology, step = request.param
    jp, tp = srbd_problems(topology, step)
    js, ts = solvers(jp, tp)
    X, U = trajectories(jp, B, seed=31)
    params = fleet_params(jp.ocp.params, B)
    rng = np.random.RandomState(32)
    params["rdot_ref"] = 0.3 * rng.randn(*params["rdot_ref"].shape)
    params["cdot_switch"] = rng.randint(0, 2, params["cdot_switch"].shape) * 1.0
    params["mask_track"] = rng.randint(0, 2, params["mask_track"].shape) * 1.0
    jdense = jit(jax.vmap(
        lambda x, u, p: js._linearize_impl(x, u, p, sliced=False)))(
            *to_jax((X, U, params)))
    tlin = k4.srbd_linearize_plain(to_torch(X), to_torch(U), to_torch(params),
                                   ts.terms, ts.rows, tp.ocp.dt,
                                   ts._wc(torch.float64))
    # the sweep JAX's lane-major backward runs on the port's (complete) rows
    sweep = k1.riccati_backward_plain(*(tlin[k] for k in ORDER), MU, ts.rows)
    x0 = perturbed_states(jp.initial_state, B, seed=33)
    return dict(topology=topology, step=step, jp=jp, tp=tp, js=js, ts=ts,
                X=X, U=U, params=params, jdense=jdense, tlin=tlin,
                sweep=sweep, x0=x0)


def test_step_matches_jax(case):
    jp, tp = case["jp"], case["tp"]
    nx, nu = tp.ocp.nx, tp.ocp.nu
    x, u, p = random_xup(jp.ocp.params, nx, nu, seed=34, lead=(6,))
    dt = jp.ocp.dt
    want = jit(jax.vmap(lambda a, b, c: jp.ocp.step(a, b, c, dt)))(
        *to_jax((x, u, p)))
    got = tp.ocp.step(to_torch(x), to_torch(u), to_torch(p), dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13)
    assert tp.ocp.constants["terms"].step == case["step"]


@pytest.mark.parametrize("seed", [35, 36])
def test_declared_dynamics_rows(case, seed):
    """B is nonzero only in dynamics_u_rows — every row: the RK stages carry
    u into r, o and c — and A − I only in dynamics_x_rows, Euler's."""
    tp = case["tp"]
    ocp = tp.ocp
    nx, nu = ocp.nx, ocp.nu
    assert tuple(ocp.dynamics_u_rows) == tuple(range(nx))
    assert tuple(ocp.dynamics_x_rows) == tuple(case["jp"].ocp.dynamics_x_rows)
    x, u, p = (to_torch(a) for a in random_xup(
        {k: np_of(v) for k, v in ocp.params.items()}, nx, nu, seed))
    jac = torch.func.jacfwd
    A = jac(lambda x_: ocp.step(x_, u, p, ocp.dt))(x).numpy() - np.eye(nx)
    Bm = jac(lambda u_: ocp.step(x, u_, p, ocp.dt))(u).numpy()
    dead_x = sorted(set(range(nx)) - set(ocp.dynamics_x_rows))
    assert dead_x and np.all(A[dead_x] == 0.0)
    # the rows Euler leaves dead are live: Euler's declaration would drop them
    euler_u = set(case["jp"].ocp.dynamics_u_rows)
    assert np.abs(Bm[sorted(set(range(nx)) - euler_u)]).max() > 1e-3


@pytest.mark.parametrize("key", ["Sx", "Bs"])
def test_linearize_dynamics_match_jax_dense(case, key):
    """Sx = (A − I)[rx], Bs = B[ru], A and B JAX's dense jacfwd of its step."""
    ts, nx = case["ts"], case["tp"].ocp.nx
    A = np.asarray(case["jdense"]["A"])
    Bm = np.asarray(case["jdense"]["B"])
    want = ((A - np.eye(nx))[:, :, list(ts.rows.rx)] if key == "Sx"
            else Bm[:, :, list(ts.rows.ru)])
    got = case["tlin"][key]
    assert tuple(got.shape) == want.shape
    assert max_rel_err(got, want) < TOL


@pytest.mark.parametrize("key", ["Jxp", "Jup", "rho", "d", "Jt", "rt"])
def test_linearize_residuals_match_jax(case, key):
    """The residual blocks on the declared rows gx / gu of JAX's dense
    Jacobians, the residuals and the defects under the step."""
    rows, jd = case["ts"].rows, case["jdense"]
    want = {"Jxp": np.asarray(jd["Jx"])[:, :, list(rows.gx)],
            "Jup": np.asarray(jd["Ju"])[:, :, list(rows.gu)]}.get(key)
    want = np.asarray(jd[key]) if want is None else want
    got = case["tlin"][key]
    assert tuple(got.shape) == want.shape
    assert max_rel_err(got, want) < TOL


@pytest.mark.parametrize("nA", [1, 4])
def test_trial_twin_matches_jax(case, nA):
    """The K3 twin against JAX's trial (`jax_trial`) on the case's plan,
    gains and defects; member 1 starts from a NaN state and is
    rejected."""
    js, ts = case["js"], case["ts"]
    opts = js.opts
    ks, Ks, dV1, dV2 = case["sweep"]
    d = case["jdense"]["d"]
    x0 = np.array(case["x0"])
    x0[NAN_MEMBER] = np.nan
    want, merit0, D = jax_trial(js, x0, case["X"], case["U"], case["params"],
                                ks, Ks, d, dV1, dV2, ALPHAS[:nA])
    t = lambda a: to_torch(np_of(a))
    got = k3.srbd_trial_plain(
        t(x0), to_torch(case["X"]), to_torch(case["U"]), t(ks), t(Ks), t(d),
        to_torch(ALPHAS[:nA]), to_torch(case["params"]), t(merit0), t(D),
        t(dV1), t(dV2), ts.terms, ts.ocp.dt, ts._wc(torch.float64),
        opts.defect_weight, opts.beta, opts.alpha_converge_threshold)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert not bool(got[4][:, NAN_MEMBER].any())


@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
def test_evaluate_twin_matches_jax(case, pin):
    js, ts = case["js"], case["ts"]
    X = np.array(case["X"])
    X[NAN_MEMBER, 5, 4] = np.nan
    x0 = case["x0"] if pin else None
    Xj = X.copy()
    if pin:
        Xj[:, 0] = x0

    want = jax_evaluate(js, Xj, case["U"], case["params"])
    got = k3.srbd_evaluate_plain(
        to_torch(X), to_torch(case["U"]), to_torch(case["params"]), ts.terms,
        case["tp"].ocp.dt, ts._wc(torch.float64),
        None if x0 is None else to_torch(x0))
    for g, w in zip(got[:2], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
        assert np.isnan(g.numpy()[NAN_MEMBER])
    if pin:
        np.testing.assert_array_equal(got[2].numpy(), Xj)


def test_kernel_shapes_pick_the_rk_instance(case):
    """K4/K3/srbd_evaluate's check and K1's shape and instances pick the RK
    instance; the same problem with its step named Euler has other row
    counts and picks (or is refused by) the Euler one, never this."""
    ts, ocp = case["ts"], case["tp"].ocp
    topology, step = case["topology"], case["step"]
    want = f"{EULER_K4[topology]}_{step.lower()}"
    assert k4.check_kernel_shape("srbd_linearize", ts.terms, ocp.nx, ocp.nu,
                                 ts.rows) == want
    assert k4.check_kernel_shape("srbd_trial", ts.terms, ocp.nx, ocp.nu) == want
    assert k4.shape_index(want) == list(k4.KERNEL_SHAPES).index(want)
    # the RK terms at Euler's row counts, and Euler's terms at the RK rows,
    # match no instance
    euler_terms = dataclasses.replace(ts.terms, step="EULER")
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k4.check_kernel_shape("srbd_linearize", euler_terms, ocp.nx, ocp.nu,
                              ts.rows)
    assert k4.check_kernel_shape("srbd_evaluate", euler_terms, ocp.nx,
                                 ocp.nu) == EULER_K4[topology]
    nt = case["tlin"]["Jt"].shape[1]
    shape = k1.kernel_shape(ocp.nx, ocp.nu, nt, ts.rows)
    assert shape == K1_RK[topology]
    for form in ("collapsed", "tassa"):
        inst = k1.kernel_instance(shape, form, "schur")
        assert k1.KERNEL_INSTANCES[inst][0] == shape
    if topology == "kangaroo":
        assert k1.KERNEL_INSTANCES[k1.kernel_instance(
            shape, "tassa", "cholesky")] == (shape, "tassa", "cholesky")


@pytest.mark.parametrize("mode", [("associative", "nonlinear"),
                                  ("sequential", "linear"),
                                  ("associative", "linear")],
                         ids=["associative", "linear", "both"])
def test_modes_are_refused(case, mode):
    """K12 and K13 now have a kernel at the RK shapes: `family_index` finds
    the (topology, step) family — RK2 and RK4 each their own, on K1's
    shared RK shape — and `MSDDP` builds the modes; they are refused, on
    every device and naming ROADMAP.md, only where no kernel is compiled:
    the SRBD problem at contact_model=3 under the same step."""
    ts, ocp = case["ts"], case["tp"].ocp
    fam = family_index(ts.terms, ocp.nx, ocp.nu, ts.rows)
    name = f"{case['topology']}_{case['step'].lower()}"
    assert FAMILIES[fam] == ("srbd", name, K1_RK[case["topology"]], name)
    opts = DDPOptions(max_iters=2, riccati_mode=mode[0], forward_pass=mode[1])
    MSDDP(ocp, opts)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        MSDDP(six_contact_srbd(case["step"]).ocp, opts)
    MSDDP(ocp, DDPOptions(max_iters=2))            # the default modes build
