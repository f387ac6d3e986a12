"""PyTorch port, the plain twins of the isrbd kernels against the JAX
package's AL inner solver, on the CPU in float64, at a linearization
point with a non-unit quaternion, random 0/1 node masks, and active and
inactive cone and box rows:

  - K5 `isrbd_linearize_plain` against JAX `_inner._linearize_sliced`
    (jacfwd of the inner OCP): rtol 1e-9, atol 1e-11;
  - K1 `riccati_backward_plain` with the live B columns `uc` against JAX
    `_backward_lanemajor` on that linearization: 1e-9 relative;
  - K6 `isrbd_trial_plain` (rollout, cost, Armijo test) against JAX
    `_rollout` + `total_cost` and the trial's flag (msddp.py:843-853) for
    1 and 4 step sizes, to 1e-11 relative, with a member whose merit is
    NaN and one whose merit is −inf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    al_solvers,
    isrbd_problems,
    jax_al_state,
    jit,
    max_rel_err,
    np_of,
    random_al_state,
    tight_box_params,
    to_jax,
    to_torch,
    torch_al_state,
)
from srbd_horizon_tpu_torch.kernels.isrbd_linearize import (
    isrbd_linearize,
    isrbd_linearize_plain,
)
from srbd_horizon_tpu_torch.kernels.isrbd_rollout import (
    isrbd_rollout_plain,
    isrbd_trial,
    isrbd_trial_plain,
)
from srbd_horizon_tpu_torch.kernels.riccati import (
    riccati_backward,
    riccati_backward_plain,
)

torch.set_num_threads(1)

ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
MU = 1e-6
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])
B = 4


@pytest.fixture(scope="module")
def case():
    jp, tp = isrbd_problems()
    js, ts = al_solvers(jp, tp)
    st = random_al_state(jp.ocp, B, 21, *ts._sizes)
    params = tight_box_params(jp, B, 22)
    jpin = jax.vmap(js._params_with_multipliers)(to_jax(params),
                                                 jax_al_state(st))
    tpin = ts._params_with_multipliers(to_torch(params), torch_al_state(st))
    X, U = st["sol"]["X"], st["sol"]["U"]
    jin = js._inner
    jlin = jit(jax.vmap(jin._linearize_sliced))(
        jnp.asarray(X), jnp.asarray(U), jpin)
    jback = jit(jin._backward_lanemajor)(jlin, jnp.asarray(MU))
    tlin = isrbd_linearize_plain(to_torch(X), to_torch(U), tpin, ts.terms,
                                 ts.inner.rows, tp.ocp.dt)
    rng = np.random.RandomState(23)
    x0 = X[:, 0] + 0.01 * rng.randn(B, X.shape[-1])
    return dict(jp=jp, tp=tp, js=js, ts=ts, X=X, U=U, jpin=jpin, tpin=tpin,
                jlin=jlin, tlin=tlin, jback=jback, x0=x0)


@pytest.mark.parametrize("out", ORDER)
def test_linearize_plain_matches_jax(case, out):
    got, want = np_of(case["tlin"][out]), np.asarray(case["jlin"][out])
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11 * max(scale, 1.0))


def test_linearization_point_is_not_degenerate(case):
    """The point exercises what the closed form has to get right: active
    and inactive one-sided rows, and live quaternion blocks."""
    rho = np_of(case["tlin"]["rho"])
    cones, xbox, ubox = rho[..., 66:86], rho[..., 106:180], rho[..., 180:240]
    for rows in (cones, xbox, ubox):
        assert (rows > 0).any() and (rows == 0).any()
    assert (rho[..., 86:106] == 0).all()          # cones have no lower bound
    # a zero force under a zero multiplier sits exactly on the kink of
    # max(0, ·), where the slope is ½ as jax.jacfwd takes it
    gu = case["ts"].inner.rows.gu
    tie = np_of(case["tlin"]["Jup"])[0, -1, gu.index(66), 9]
    assert tie == 0.5 * np.sqrt(case["tpin"]["al_rho"][0, 0, 0].item())
    Jup = np_of(case["tlin"]["Jup"])
    assert np.abs(Jup).max() > 1.0
    Sx = np_of(case["tlin"]["Sx"])
    assert np.abs(Sx[..., 3:7, 3:7]).max() > 0


def test_linearize_wrapper_takes_plain_path_on_cpu(case):
    ts = case["ts"]
    before = isrbd_linearize.launches
    got = isrbd_linearize(to_torch(case["X"]), to_torch(case["U"]),
                          case["tpin"], ts.terms, ts.inner.rows,
                          case["tp"].ocp.dt)
    for k in ORDER:
        assert torch.equal(got[k], case["tlin"][k])
    assert isrbd_linearize.launches == before


@pytest.mark.parametrize("out", ["ks", "Ks", "dV1", "dV2"])
def test_riccati_plain_with_live_columns_matches_jax(case, out):
    """K1's twin on the JAX linearization (Bs has 18 of 30 columns)."""
    tlin = {k: to_torch(np_of(v)) for k, v in case["jlin"].items()}
    rows = case["ts"].inner.rows
    assert tlin["Bs"].shape[-1] == len(rows.uc) == 18
    got = riccati_backward_plain(*(tlin[k] for k in ORDER), MU, rows)
    i = ("ks", "Ks", "dV1", "dV2").index(out)
    assert max_rel_err(got[i], case["jback"][i]) < 1e-9


def test_riccati_live_columns_equal_dense_columns(case):
    """Scattering the live columns of Bs into a dense (|ru|, nu) B with
    zero dead columns, and sweeping with every column declared live, gives
    the same gains: the column set only skips structural zeros (to 1e-9:
    the wider products sum in another order, and Quu⁻¹ amplifies that)."""
    import dataclasses
    rows = case["ts"].inner.rows
    lin = case["tlin"]
    nu = lin["Jup"].shape[-1]
    dense = lin["Bs"].new_zeros(lin["Bs"].shape[:-1] + (nu,))
    dense[..., list(rows.uc)] = lin["Bs"]
    all_cols = dataclasses.replace(rows, uc=tuple(range(nu)))
    want = riccati_backward_plain(*(lin[k] if k != "Bs" else dense
                                    for k in ORDER), MU, all_cols)
    got = riccati_backward(*(lin[k] for k in ORDER), MU, rows)
    for g, w in zip(got, want):
        assert max_rel_err(g, w) < 1e-9


@pytest.fixture(scope="module")
def trials(case):
    """The trial for 1 and 4 step sizes in both packages on the case's
    plan, gains and defects. Member 1 starts from a NaN state; member 2
    has D = −inf, so its merit is −inf for α < 1 and only the finiteness
    test rejects it."""
    jin, ts = case["js"]._inner, case["ts"]
    opts = jin.opts
    ks, Ks, dV1, dV2 = case["jback"]
    d = case["jlin"]["d"]
    X, U, params = jnp.asarray(case["X"]), jnp.asarray(case["U"]), case["jpin"]
    x0 = np.array(case["x0"])
    x0[1] = np.nan
    x0 = jnp.asarray(x0)
    nu_w = jnp.asarray(opts.defect_weight, jnp.float64)
    D = jnp.sum(d * d, axis=(1, 2)).at[2].set(-jnp.inf)
    cost0 = jit(jax.vmap(jin.total_cost))(X, U, params)
    merit0 = (cost0 + nu_w * D).at[2].set(cost0[2])

    def one(a):     # msddp.py:843-853
        Xn, Un = jax.vmap(
            lambda x0_, X_, U_, k_, K_, d_, p_: jin._rollout(
                x0_, X_, U_, k_, K_, d_, p_, a)
        )(x0, X, U, ks, Ks, d, params)
        new_cost = jax.vmap(jin.total_cost)(Xn, Un, params)
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
                t(d), to_torch(ALPHAS[:nA]), case["tpin"], t(merit0), t(D),
                t(dV1), t(dV2), ts.terms, ts.ocp.dt,
                opts.defect_weight, opts.beta, opts.alpha_converge_threshold)
        out[nA] = (args, want)
    return out


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("out", range(5), ids=["Xn", "Un", "cost", "merit", "ok"])
def test_trial_plain_matches_jax(trials, nA, out):
    args, want = trials[nA]
    got = isrbd_trial_plain(*args)[out]
    assert tuple(got.shape) == tuple(want[out].shape)
    if out == 4:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[out]))
    else:
        w = np.asarray(want[out])
        scale = np.nanmax(np.abs(np.where(np.isfinite(w), w, 0.0)))
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-11,
                                   atol=1e-11 * scale)


@pytest.mark.parametrize("nA", [1, 4])
def test_trial_rejects_non_finite_merit(trials, nA):
    args, _ = trials[nA]
    _, _, cost, merit, ok = isrbd_trial_plain(*args)
    assert bool(torch.isnan(cost[:, 1]).all()) and not bool(ok[:, 1].any())
    assert not bool(ok[:, 2].any())
    assert bool(torch.isfinite(merit[:, [0, 3]]).all())
    if nA == 4:     # α < 1: merit −inf passes the decrease test alone
        assert bool(torch.isneginf(merit[1:, 2]).all())


def test_trial_wrapper_takes_plain_path_on_cpu(trials):
    args, _ = trials[4]
    before = isrbd_trial.launches
    for g, w in zip(isrbd_trial(*args), isrbd_trial_plain(*args)):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    assert isrbd_trial.launches == before


def test_rollout_alpha_zero_recovers_iterate(case):
    """α = 0 with the plan's own defects retraces the plan:
    x̂ₙ₊₁ = rk2(x̂ₙ, uₙ) − dₙ = Xₙ₊₁ when x̂ₙ = Xₙ."""
    X, U = to_torch(case["X"]), to_torch(case["U"])
    ks, Ks = (to_torch(np_of(a)) for a in case["jback"][:2])
    zero = torch.zeros(1, dtype=torch.float64)
    Xn, Un = isrbd_rollout_plain(X[:, 0].clone(), X, U, ks, Ks,
                                 case["tlin"]["d"], zero, case["tp"].ocp.dt,
                                 case["ts"].terms.outer.xdot)
    np.testing.assert_allclose(Xn[0].numpy(), X.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Un[0].numpy(), U.numpy(), rtol=0, atol=1e-12)
