"""PyTorch port, the plain twins of the CUDA kernels against the JAX
package, on the CPU in float64:

  - K1 `riccati_backward_plain` (and the wrapper, which takes the plain
    path for CPU tensors) against JAX `MSDDP._backward_lanemajor` on the
    same sliced linearization: ks, Ks, dV1, dV2 to 1e-9 relative;
  - K3 `srbd_rollout_plain` for 4 step sizes against
    `jax.vmap(MSDDP._rollout)`, to 1e-12, and the whole fused trial
    `srbd_trial_plain` (rollout, cost, Armijo test) against the JAX
    package's trial (msddp.py:843-853) for 1 and 4 step sizes, to 1e-12,
    with a member whose merit is not finite.
"""

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
    problems,
    solvers,
    to_jax,
    to_torch,
    trajectories,
)
from srbd_horizon_tpu_torch.kernels.riccati import (
    RiccatiRows,
    riccati_backward,
    riccati_backward_plain,
)
from srbd_horizon_tpu_torch.kernels.rollout import (
    srbd_rollout_plain,
    srbd_trial,
    srbd_trial_plain,
)

torch.set_num_threads(1)

ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
MU = 1e-6
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])


@pytest.fixture(scope="module")
def case():
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    B = 4
    X, U = trajectories(jp, B, seed=11)
    params = fleet_params(jp.ocp.params, B)
    jlin = jit(jax.vmap(
        lambda x, u, p: js._linearize(x, u, p, sliced=True)
    ))(*to_jax((X, U, params)))
    jback = jit(js._backward_lanemajor)(jlin, jnp.asarray(MU))
    tlin = {k: to_torch(np_of(v)) for k, v in jlin.items()}
    x0 = perturbed_states(jp.initial_state, B, seed=12)
    return dict(jp=jp, tp=tp, js=js, ts=ts, X=X, U=U, params=params,
                jlin=jlin, tlin=tlin, jback=jback, x0=x0)


@pytest.mark.parametrize("out", ["ks", "Ks", "dV1", "dV2"])
def test_riccati_plain_matches_jax(case, out):
    got = riccati_backward_plain(*(case["tlin"][k] for k in ORDER), MU,
                                 case["ts"].rows)
    i = ("ks", "Ks", "dV1", "dV2").index(out)
    assert max_rel_err(got[i], case["jback"][i]) < 1e-9


def test_riccati_wrapper_takes_plain_path_on_cpu(case):
    before = riccati_backward.launches
    args = tuple(case["tlin"][k] for k in ORDER) + (MU, case["ts"].rows)
    got = riccati_backward(*args)
    want = riccati_backward_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert riccati_backward.launches == before   # no kernel launch on CPU


def test_riccati_rows_from_ocp(case):
    rows = RiccatiRows.from_ocp(case["tp"].ocp)
    assert rows.rx == tuple(range(0, 19)) + (22, 23, 24)
    assert rows.ru == tuple(range(19, 37))
    assert rows.gx == tuple(range(15)) + (18, 19, 20) + tuple(range(57, 73))
    assert rows.gu == tuple(range(15, 57))
    assert [rows.gx[i] for i in rows.bx] == [18, 19, 20]
    assert [rows.gu[i] for i in rows.bu] == [18, 19, 20]
    assert rows.packed("cpu").dtype == torch.int32
    assert rows.uc == tuple(range(24))       # every SRBD input drives B
    assert rows.packed("cpu").numel() == 22 + 18 + 34 + 42 + 6 + 24


@pytest.fixture(scope="module")
def rollouts(case):
    js = case["js"]
    ks, Ks = case["jback"][0], case["jback"][1]
    X, U, params, x0 = (to_jax(case[k]) for k in ("X", "U", "params", "x0"))
    d = case["jlin"]["d"]

    def one_alpha(a):
        return jax.vmap(
            lambda x0_, X_, U_, k_, K_, d_, p_: js._rollout(
                x0_, X_, U_, k_, K_, d_, p_, a)
        )(x0, X, U, ks, Ks, d, params)

    want = jit(jax.vmap(one_alpha))(jnp.asarray(ALPHAS))
    c = case["tp"].ocp.constants
    args = (to_torch(case["x0"]), to_torch(case["X"]), to_torch(case["U"]),
            to_torch(np_of(ks)), to_torch(np_of(Ks)), case["tlin"]["d"],
            to_torch(ALPHAS), case["tp"].ocp.dt, c["m_scaled"],
            c["inertia_scaled"])
    return args, want


@pytest.mark.parametrize("out", [0, 1], ids=["Xn", "Un"])
def test_rollout_plain_matches_jax(rollouts, out):
    args, want = rollouts
    got = srbd_rollout_plain(*args)
    assert tuple(got[out].shape) == tuple(want[out].shape)
    np.testing.assert_allclose(got[out].numpy(), np.asarray(want[out]),
                               rtol=1e-12, atol=1e-12)


def test_rollout_wrapper_takes_plain_path_on_cpu(trials):
    """The K3 wrapper, `srbd_trial`, takes its plain twin for CPU tensors
    and launches nothing."""
    args, _ = trials[4]
    before = srbd_trial.launches
    for g, w in zip(srbd_trial(*args), srbd_trial_plain(*args)):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    assert srbd_trial.launches == before


def test_rollout_alpha_zero_recovers_iterate(rollouts):
    """α = 0 with zero feedback gain on a consistent plan retraces it:
    x̂ₙ₊₁ = x̂ₙ + dt ẋ − dₙ = Xₙ₊₁ when x̂ₙ = Xₙ."""
    args, _ = rollouts
    x0, X, U, ks, Ks, d = args[:6]
    zero = torch.zeros(1, dtype=torch.float64)
    Xn, Un = srbd_rollout_plain(X[:, 0].clone(), X, U, ks, Ks, d, zero,
                                *args[7:])
    np.testing.assert_allclose(Xn[0].numpy(), X.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Un[0].numpy(), U.numpy(), rtol=0, atol=1e-12)


def test_riccati_f32_inputs_cost_little_in_f64_arithmetic(case):
    """K1 computes in float64 on chip for float32 tensors as well. Rounding
    the sweep's inputs to float32 and carrying them in float64 must stay
    within 1e-5 relative of the float64 sweep — the ~1e-2 that a float32
    sweep loses (chip_smoke's float32 check) is float32 arithmetic."""
    args = tuple(case["tlin"][k] for k in ORDER)
    ref = riccati_backward_plain(*args, MU, case["ts"].rows)
    rounded = tuple(a.float().double() for a in args)
    got = riccati_backward_plain(*rounded, float(np.float32(MU)), case["ts"].rows)
    for g, r in zip(got, ref):
        assert max_rel_err(g, r) < 1e-5


@pytest.fixture(scope="module")
def trials(case):
    """The trial for 1 and 4 step sizes, in both packages, on the case's
    plan, gains and defects. Member 1 starts from a NaN state (NaN cost
    and merit); member 2 has D = −inf, so its merit is −inf for α < 1 and
    only the finiteness test rejects it."""
    js, ts = case["js"], case["ts"]
    opts = js.opts
    ks, Ks, dV1, dV2 = case["jback"]
    d = case["jlin"]["d"]
    X, U, params = (to_jax(case[k]) for k in ("X", "U", "params"))
    x0 = np.array(case["x0"])
    x0[1] = np.nan
    x0 = to_jax(x0)
    nu_w = jnp.asarray(opts.defect_weight, jnp.float64)
    D = jnp.sum(d * d, axis=(1, 2)).at[2].set(-jnp.inf)
    cost0 = jit(jax.vmap(js.total_cost))(X, U, params)
    merit0 = (cost0 + nu_w * D).at[2].set(cost0[2])

    def one(a):     # msddp.py:843-853
        Xn, Un = jax.vmap(
            lambda x0_, X_, U_, k_, K_, d_, p_: js._rollout(
                x0_, X_, U_, k_, K_, d_, p_, a)
        )(x0, X, U, ks, Ks, d, params)
        new_cost = jax.vmap(js.total_cost)(Xn, Un, params)
        new_merit = new_cost + nu_w * (1.0 - a) ** 2 * D
        expected = -(a * dV1 + a**2 * dV2) + (2.0 * a - a**2) * nu_w * D
        ok = (
            ((merit0 - new_merit) >= opts.beta * jnp.maximum(expected, 1e-16))
            & jnp.isfinite(new_merit)
            & (a >= opts.alpha_converge_threshold)
        )
        return Xn, Un, new_cost, new_merit, ok

    t = lambda a: to_torch(np_of(a))
    out = {}
    for nA in (1, 4):
        want = jit(jax.vmap(one))(jnp.asarray(ALPHAS[:nA]))
        args = (t(x0), to_torch(case["X"]), to_torch(case["U"]), t(ks), t(Ks),
                case["tlin"]["d"], to_torch(ALPHAS[:nA]), to_torch(case["params"]),
                t(merit0), t(D), t(dV1), t(dV2), ts.terms, ts.ocp.dt,
                ts._wc(torch.float64), opts.defect_weight, opts.beta,
                opts.alpha_converge_threshold)
        out[nA] = (args, want)
    return out


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("out", range(5), ids=["Xn", "Un", "cost", "merit", "ok"])
def test_trial_plain_matches_jax(trials, nA, out):
    args, want = trials[nA]
    got = srbd_trial_plain(*args)[out]
    assert tuple(got.shape) == tuple(want[out].shape)
    if out == 4:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[out]))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want[out]),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nA", [1, 4])
def test_trial_rejects_non_finite_merit(trials, nA):
    args, _ = trials[nA]
    _, _, cost, merit, ok = srbd_trial_plain(*args)
    assert bool(torch.isnan(cost[:, 1]).all()) and not bool(ok[:, 1].any())
    assert not bool(ok[:, 2].any())
    assert bool(torch.isfinite(merit[:, [0, 3]]).all())
    if nA == 4:     # α < 1: merit −inf passes the decrease test alone
        assert bool(torch.isneginf(merit[1:, 2]).all())
