"""PyTorch port, K13's plain twin (`linear_trial_plain`, the trial of the
linearized forward pass under `forward_pass="linear"`) in float64 on the
CPU, against the JAX package's trial closure of `_parallel_line_search`
(msddp.py:1507-1531) composed of its own methods — `_forward_linear`,
`_true_defects`, `total_cost` and the Armijo test — at 4 step sizes on the
same drawn iterate, x0, gains and merit, for each of K13's families: the
Kangaroo SRBD problem, the LIP, the point-feet quadruped's SRBD problem
and the AL inner problem of both robots' isrbd problems (member 0 of a
drawn AL state, its multipliers and penalty in the parameters): plans,
costs and merits to 1e-9 relative (read: ≤ 1e-13), the flags equal. On
the AL inner problem the true defects take the OCP's RK2 step, as JAX's
`_true_defects` takes `ocp.step`: the twin with an Euler step there
misses JAX's merits by far more than 1e-9. The twin's affine scan is
JAX's tree; the kernel's node-order recursion is held to the twin on the
card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    al_solvers,
    isrbd_problems,
    jax_al_state,
    jax_linear_trials,
    jit,
    max_rel_err,
    np_of,
    problems,
    quadruped_isrbd_problems,
    quadruped_problems,
    random_al_state,
    solvers,
    tight_box_params,
    to_jax,
    to_torch,
    torch_al_state,
)
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet as j_feet
from srbd_horizon_tpu.problems.lip import build_lip_problem as j_build_lip
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import linear_trial as k13
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])
FAMILIES = ["srbd", "lip", "quadruped", "isrbd_al", "isrbd_al_quadruped"]
AL_SHAPES = ("isrbd_al", "isrbd_al_quadruped")
OPTS = dict(alpha_converge_threshold=1e-12, beta=1e-3)


def _pair(family):
    """(jax solver, torch solver, X, U, params) of a drawn point on the
    family's problem (numpy X (ns+1, nx), U (ns, nu), params leaves
    (ns+1, dim); the AL shapes' params carry member 0's multipliers)."""
    rng = np.random.RandomState(5)
    if family in AL_SHAPES:
        jp, tp = (isrbd_problems() if family == "isrbd_al"
                  else quadruped_isrbd_problems())
        js, ts = al_solvers(jp, tp)
        st = random_al_state(jp.ocp, 1, 21, *ts._sizes)
        p = tight_box_params(jp, 1, 22)
        jpin = jax.vmap(js._params_with_multipliers)(to_jax(p),
                                                     jax_al_state(st))
        params = {k: np.asarray(v)[0] for k, v in jpin.items()}
        return js._inner, ts.inner, st["sol"]["X"][0], st["sol"]["U"][0], params
    if family in ("srbd", "quadruped"):
        jp, tp = problems() if family == "srbd" else quadruped_problems()
        js, ts = solvers(jp, tp)
    else:
        jp = j_build_lip(JSRBDConfig(dtype=jnp.float64), j_feet())
        tp = build_lip_problem(SRBDConfig(dtype=torch.float64),
                               kangaroo_line_feet(), device="cpu")
        js, ts = (JMSDDP(jp.ocp, JDDPOptions(**OPTS)),
                  MSDDP(tp.ocp, DDPOptions(**OPTS)))
    ns, nx, nu = jp.ocp.ns, jp.ocp.nx, jp.ocp.nu
    X = np.asarray(jp.initial_state)[None] + 0.05 * rng.randn(ns + 1, nx)
    U = np.asarray(jp.static_input)[None] + 0.1 * rng.randn(ns, nu)
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    return js, ts, X, U, params


@pytest.fixture(scope="module", params=FAMILIES)
def trials(request):
    js, ts, X, U, params = _pair(request.param)
    rng = np.random.RandomState(6)
    x0 = X[0] + 0.01 * rng.randn(X.shape[-1])
    jlin = jit(js._linearize)(to_jax(X), to_jax(U), to_jax(params))
    ks, Ks, dV1, dV2 = jit(js._backward)(jlin, jnp.asarray(1e-6))
    D = jnp.sum(jlin["d"] * jlin["d"])
    merit0 = js.total_cost(to_jax(X), to_jax(U), to_jax(params)) + 1e5 * D
    jtrial = jax_linear_trials(js, to_jax(x0), to_jax(X), to_jax(U), ks, Ks,
                               jlin, to_jax(params), D, dV1, dV2)
    jres = jtrial(jnp.asarray(ALPHAS), merit0)
    # a second merit0 between the merits of α = 1/2 and 1/4: the larger
    # steps pass the Armijo test, the smaller fail it
    merit_mid = 0.5 * (jres[3][1] + jres[3][2])
    p1 = {k: v[None] for k, v in to_torch(params).items()}
    lin = ts._linearize_sliced(to_torch(X)[None], to_torch(U)[None], p1)
    t1 = lambda a: to_torch(np.asarray(a))[None]
    args = lambda m0: (
        t1(x0), t1(X), t1(U), t1(ks), t1(Ks), lin["Sx"], lin["Bs"],
        lin["d"], to_torch(ALPHAS), p1, t1(m0), t1(D), t1(dV1), t1(dV2),
        ts.terms, ts.rows, ts.ocp.dt, ts._wc(torch.float64),
        ts.opts.defect_weight, ts.opts.beta, ts.opts.alpha_converge_threshold)
    out = {"family": request.param, "args": args(merit0)}
    for key, m0 in (("iterate", merit0), ("mid", merit_mid)):
        tres = k13.linear_trial(*args(m0))
        out[key] = (jres if key == "iterate"
                    else jtrial(jnp.asarray(ALPHAS), m0), tres)
    return out


@pytest.mark.parametrize("merit0", ["iterate", "mid"])
def test_twin_matches_jax_trial(trials, merit0):
    jres, tres = trials[merit0]
    for name, got, want in zip(("Xn", "Un", "cost", "merit"), tres, jres):
        got = np_of(got)[:, 0]
        want = np.asarray(want)
        assert got.shape == want.shape, name
        assert max_rel_err(got, want) < 1e-9, (name, max_rel_err(got, want))
    np.testing.assert_array_equal(np_of(tres[4])[:, 0], np.asarray(jres[4]))


def test_trial_flags_take_both_values(trials):
    """From the mid merit some steps pass the Armijo test and some fail it,
    so the flags' comparison above holds the rule both ways: on the SRBD,
    LIP and quadruped iterates every step passes from the iterate's merit
    and the two larger pass from the mid one; on the AL inner problem's
    drawn state, far from feasible, the merit grows with α, and from the
    mid merit the smaller steps pass."""
    mid = np.asarray(trials["mid"][0][4])
    assert mid.any() and not mid.all()
    if trials["family"] not in AL_SHAPES:
        np.testing.assert_array_equal(np.asarray(trials["iterate"][0][4]),
                                      [True] * 4)
        np.testing.assert_array_equal(mid, [True, True, False, False])
    else:
        assert not mid[0] and mid[2]


def test_isrbd_defects_take_the_rk2_step(trials, monkeypatch):
    """The true defects are `ocp.step`'s: on the AL inner problem the RK2
    step, whose twin matches JAX (above); the same twin with an Euler step
    there misses JAX's defect term ν·D̂ (merit − cost) by more than 1e-3
    relative, and so JAX's merits by more than the 1e-9 the comparison
    holds. On the Euler families the two twins are one."""
    jres = trials["iterate"][0]
    euler = lambda terms, dt: (lambda x, u, f=k13.family_xdot(terms):
                               x + dt * f(x, u))
    monkeypatch.setattr(k13, "family_step", euler)
    got = k13.linear_trial_plain(*trials["args"])
    merit, cost = np_of(got[3])[:, 0], np_of(got[2])[:, 0]
    err = max_rel_err(merit, np.asarray(jres[3]))
    if trials["family"] in AL_SHAPES:
        assert err > 1e-9, err
        assert max_rel_err(merit - cost,
                           np.asarray(jres[3]) - np.asarray(jres[2])) > 1e-3
    else:
        assert err < 1e-9, err


def test_linear_trial_refuses_other_problems():
    """The kernel is compiled for K1's five shapes: a problem of other row
    counts gets ValueError from the family check (the solver turns it into
    its NotImplementedError); the two SRBD shapes have a family each."""
    import dataclasses

    from srbd_horizon_tpu_torch.config import SRBDConfig as TCfg
    from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem

    qp = build_srbd_problem(TCfg(dtype=torch.float64, contact_model=1,
                                 number_of_legs=4), quadruped_point_feet(),
                            device="cpu")
    qs = MSDDP(qp.ocp, DDPOptions())
    assert k13.family_index(qs.terms, qp.ocp.nx, qp.ocp.nu, qs.rows) == 2
    fewer = dataclasses.replace(qs.rows, gx=qs.rows.gx[:-1])
    with pytest.raises(ValueError):
        k13.family_index(qs.terms, qp.ocp.nx, qp.ocp.nu, fewer)
    _, ts, *_ = _pair("srbd")
    assert k13.family_index(ts.terms, 37, 24, ts.rows) == 0
