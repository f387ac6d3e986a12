"""PyTorch port, the plain twins of the SRBD kernels at the point-feet
quadruped's sizes (`srbd::QuadShape`: n_rho 69, 30 residual rows touching
x), against the JAX package on the CPU in float64:

  - K4's twin `srbd_linearize_plain` against JAX's sliced linearization
    (`MSDDP._linearize(..., sliced=True)`, jacfwd over the declared rows)
    at plans around the nominal state and at random points with non-unit
    quaternions and switched contacts, to 1e-12;
  - K3's twin `srbd_trial_plain` (rollout, cost, Armijo test) for 1 and 4
    step sizes against JAX's `_rollout`, `total_cost` and the trial's test
    (msddp.py:843-853), to 1e-12, a member from a NaN state rejected;
  - srbd_evaluate's twin against `jax.vmap(total_cost)` and the max |·| of
    `jax.vmap(_true_defects)`, without and with the node-0 pin, to 1e-12,
    a member with a NaN plan NaN in both;
  - K1's twins against JAX's sweeps: the collapsed form against
    `_backward_lanemajor` on the sliced linearization, the Tassa form with
    the block-Schur gains against `_backward` on the dense one, to 1e-9;
  - the wrappers take the twins for CPU tensors, and the quadruped's sizes
    pass the CUDA shape checks of K4, K3, srbd_evaluate and K1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    fleet_params,
    jit,
    max_rel_err,
    np_of,
    perturbed_states,
    quadruped_problems,
    random_xup,
    solvers,
    to_jax,
    to_torch,
    trajectories,
)
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import rollout as k3

torch.set_num_threads(1)

ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
OUTS = ("ks", "Ks", "dV1", "dV2")
TOL = 1e-12
MU = 1e-6
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])
B = 4
NAN_MEMBER = 1


@pytest.fixture(scope="module")
def case():
    """A quadruped point near the trot: plans around the nominal state,
    random references and 0/1 switches; JAX's sliced linearization and
    collapsed sweep of it."""
    jp, tp = quadruped_problems()
    js, ts = solvers(jp, tp)
    X, U = trajectories(jp, B, seed=13)
    params = fleet_params(jp.ocp.params, B)
    rng = np.random.RandomState(14)
    params["rdot_ref"] = 0.3 * rng.randn(*params["rdot_ref"].shape)
    params["c_ref"] = 0.05 * np.abs(rng.randn(*params["c_ref"].shape))
    params["cdot_switch"] = rng.randint(0, 2, params["cdot_switch"].shape) * 1.0
    params["mask_track"] = rng.randint(0, 2, params["mask_track"].shape) * 1.0
    jlin = jit(jax.vmap(
        lambda x, u, p: js._linearize(x, u, p, sliced=True)
    ))(*to_jax((X, U, params)))
    jback = jit(js._backward_lanemajor)(jlin, jnp.asarray(MU))
    tlin = k4.srbd_linearize_plain(to_torch(X), to_torch(U), to_torch(params),
                                   ts.terms, ts.rows, tp.ocp.dt,
                                   ts._wc(torch.float64))
    x0 = perturbed_states(jp.initial_state, B, seed=15)
    return dict(jp=jp, tp=tp, js=js, ts=ts, X=X, U=U, params=params,
                jlin=jlin, jback=jback, tlin=tlin, x0=x0)


@pytest.mark.parametrize("key", ORDER)
def test_linearize_twin_matches_jax(case, key):
    got, want = case["tlin"][key], case["jlin"][key]
    assert tuple(got.shape) == tuple(want.shape)
    assert max_rel_err(got, want) < TOL


def test_linearize_shapes(case):
    """The quadruped's stacks: 22 live rows of A−I, 18 of B, 30 / 42
    residual rows touching x / u, 69 stacked residual rows."""
    got = case["tlin"]
    assert tuple(got["Sx"].shape[2:]) == (22, 37)
    assert tuple(got["Bs"].shape[2:]) == (18, 24)
    assert tuple(got["Jxp"].shape[2:]) == (30, 37)
    assert tuple(got["Jup"].shape[2:]) == (42, 24)
    assert got["rho"].shape[-1] == 69
    assert tuple(got["Jt"].shape[1:]) == (15, 37)


@pytest.mark.parametrize("key", ORDER)
def test_linearize_twin_matches_jacfwd_at_random_points(case, key):
    """Non-unit quaternions (quat_to_rot is not normalized) and random
    contact switches."""
    jp, tp, js, ts = case["jp"], case["tp"], case["js"], case["ts"]
    ns = jp.ocp.ns
    x, u, p = random_xup(jp.ocp.params, 37, 24, seed=16, lead=(3, ns + 1))
    U = np.ascontiguousarray(u[:, :ns])
    x[..., 3:7] *= 1.1
    want = jit(jax.vmap(
        lambda x_, u_, p_: js._linearize(x_, u_, p_, sliced=True)
    ))(*to_jax((x, U, p)))
    got = k4.srbd_linearize_plain(to_torch(x), to_torch(U), to_torch(p),
                                  ts.terms, ts.rows, tp.ocp.dt,
                                  ts._wc(torch.float64))
    assert max_rel_err(got[key], want[key]) < TOL


@pytest.fixture(scope="module")
def trials(case):
    """The trial for 1 and 4 step sizes in both packages on the case's plan,
    gains and defects; member 1 starts from a NaN state."""
    js, ts = case["js"], case["ts"]
    opts = js.opts
    ks, Ks, dV1, dV2 = case["jback"]
    d = case["jlin"]["d"]
    X, U, params = (to_jax(case[k]) for k in ("X", "U", "params"))
    x0 = np.array(case["x0"])
    x0[NAN_MEMBER] = np.nan
    x0 = to_jax(x0)
    nu_w = jnp.asarray(opts.defect_weight, jnp.float64)
    D = jnp.sum(d * d, axis=(1, 2))
    merit0 = jit(jax.vmap(js.total_cost))(X, U, params) + nu_w * D

    def one(a):     # msddp.py:843-853
        Xn, Un = jax.vmap(
            lambda x0_, X_, U_, k_, K_, d_, p_: js._rollout(
                x0_, X_, U_, k_, K_, d_, p_, a)
        )(x0, X, U, ks, Ks, d, params)
        new_cost = jax.vmap(js.total_cost)(Xn, Un, params)
        new_merit = new_cost + nu_w * (1.0 - a) ** 2 * D
        expected = -(a * dV1 + a**2 * dV2) + (2.0 * a - a**2) * nu_w * D
        ok = (((merit0 - new_merit) >= opts.beta * jnp.maximum(expected, 1e-16))
              & jnp.isfinite(new_merit) & (a >= opts.alpha_converge_threshold))
        return Xn, Un, new_cost, new_merit, ok

    t = lambda a: to_torch(np_of(a))
    out = {}
    for nA in (1, 4):
        want = jit(jax.vmap(one))(jnp.asarray(ALPHAS[:nA]))
        args = (t(x0), to_torch(case["X"]), to_torch(case["U"]), t(ks), t(Ks),
                t(d), to_torch(ALPHAS[:nA]), to_torch(case["params"]),
                t(merit0), t(D), t(dV1), t(dV2), ts.terms, ts.ocp.dt,
                ts._wc(torch.float64), opts.defect_weight, opts.beta,
                opts.alpha_converge_threshold)
        out[nA] = (args, want)
    return out


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("out", range(5), ids=["Xn", "Un", "cost", "merit", "ok"])
def test_trial_twin_matches_jax(trials, nA, out):
    args, want = trials[nA]
    got = k3.srbd_trial_plain(*args)[out]
    assert tuple(got.shape) == tuple(want[out].shape)
    if out == 4:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[out]))
        assert not bool(got[:, NAN_MEMBER].any())
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want[out]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
def test_evaluate_twin_matches_jax(case, pin):
    js, ts = case["js"], case["ts"]
    X = np.array(case["X"])
    X[NAN_MEMBER, 7, 4] = np.nan
    if pin:                      # the solve's pin: X[:, 0] = x0 (msddp.py:1221)
        x0 = case["x0"]
        Xj = X.copy()
        Xj[:, 0] = x0
    else:
        x0, Xj = None, X

    def jax_evaluate(X_, U_, p_):
        cost = jax.vmap(js.total_cost)(X_, U_, p_)
        defects = jax.vmap(js._true_defects)(X_, U_, p_)
        return cost, jnp.max(jnp.abs(defects), axis=(1, 2))

    want = jit(jax_evaluate)(*to_jax((Xj, case["U"], case["params"])))
    got = k3.srbd_evaluate_plain(
        to_torch(X), to_torch(case["U"]), to_torch(case["params"]), ts.terms,
        case["tp"].ocp.dt, ts._wc(torch.float64),
        None if x0 is None else to_torch(x0))
    for g, w in zip(got[:2], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
        assert np.isnan(g.numpy()[NAN_MEMBER])
    if pin:
        np.testing.assert_array_equal(got[2].numpy(), Xj)


@pytest.mark.parametrize("out", OUTS)
def test_collapsed_sweep_twin_matches_jax(case, out):
    got = k1.riccati_backward_plain(*(case["tlin"][k] for k in ORDER), MU,
                                    case["ts"].rows)
    i = OUTS.index(out)
    assert max_rel_err(got[i], case["jback"][i]) < 1e-9


def test_tassa_sweep_twin_matches_jax(case):
    """`MSDDP.solve`'s sweep: JAX's unbatched `_backward` (block-Schur
    gains, DDPOptions' default) on its dense linearization of member 0."""
    js, ts = case["js"], case["ts"]
    jm = dataclasses.replace(js, opts=dataclasses.replace(js.opts,
                                                         quu_solver="schur"))
    X, U = case["X"][0], case["U"][0]
    p = {k: v[0] for k, v in case["params"].items()}
    jlin = jit(jm._linearize)(jnp.asarray(X), jnp.asarray(U), to_jax(p))
    want = jit(jm._backward)(jlin, jnp.asarray(MU))
    tlin = {k: v[:1] for k, v in case["tlin"].items()}
    got = k1.riccati_backward_plain(*(tlin[k] for k in ORDER), MU, ts.rows,
                                    form="tassa", quu_solver="schur")
    for name, g, w in zip(OUTS, got, want):
        assert max_rel_err(g[0], w) < 1e-9, name


def test_wrappers_take_the_twins_on_cpu(case, trials):
    """CPU tensors of the quadruped go to the twins and launch nothing."""
    ts, tp = case["ts"], case["tp"]
    counts = (k4.srbd_linearize.launches, k3.srbd_trial.launches,
              k3.srbd_evaluate.launches, k1.riccati_backward.launches)
    args = (to_torch(case["X"]), to_torch(case["U"]), to_torch(case["params"]),
            ts.terms, ts.rows, tp.ocp.dt, ts._wc(torch.float64))
    got, want = k4.srbd_linearize(*args), k4.srbd_linearize_plain(*args)
    assert all(torch.equal(got[k], want[k]) for k in ORDER)
    targs, _ = trials[4]
    for g, w in zip(k3.srbd_trial(*targs), k3.srbd_trial_plain(*targs)):
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    eargs = args[:4] + args[5:]
    for g, w in zip(k3.srbd_evaluate(*eargs), k3.srbd_evaluate_plain(*eargs)):
        assert torch.equal(g, w)
    largs = tuple(case["tlin"][k] for k in ORDER) + (MU, ts.rows)
    for g, w in zip(k1.riccati_backward(*largs, form="tassa"),
                    k1.riccati_backward_plain(*largs, form="tassa")):
        assert torch.equal(g, w)
    assert counts == (k4.srbd_linearize.launches, k3.srbd_trial.launches,
                      k3.srbd_evaluate.launches, k1.riccati_backward.launches)


def test_quadruped_sizes_have_kernels(case):
    """The shape checks the CUDA wrappers run: K4, K3 and srbd_evaluate
    take the quadruped as `QuadShape`, K1 as its `quadruped` shape with the
    collapsed and the Tassa (block-Schur) instantiations."""
    ts, tp = case["ts"], case["tp"]
    ocp = tp.ocp
    assert k4.check_kernel_shape("srbd_linearize", ts.terms, ocp.nx, ocp.nu,
                                 ts.rows) == "quadruped"
    lin = case["tlin"]
    shape = k1.kernel_shape(ocp.nx, ocp.nu, lin["Jt"].shape[1], ts.rows)
    assert shape == "quadruped"
    assert k1.KERNEL_SHAPES[shape]["n_gx"] == 30
    for form in ("collapsed", "tassa"):
        k1.kernel_instance(shape, form, ts.opts.quu_solver)
