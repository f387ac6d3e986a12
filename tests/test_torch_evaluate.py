"""PyTorch port, the evaluation entries on the CPU in float64.

`srbd_evaluate` (kernels/rollout.py) and `isrbd_evaluate`
(kernels/isrbd_rollout.py) give, per member, the cost Σₙ‖ρₙ‖² + ‖ρ_N‖² of a
plan and its largest |step(Xₙ, Uₙ) − Xₙ₊₁|. Their plain twins, which the
wrappers take for CPU tensors, are held against the JAX package's
`jax.vmap(total_cost)` and the `max(abs)` of `jax.vmap(_true_defects)`
(srbd_horizon_tpu/solvers/msddp.py:1222, :1240) on the SRBD problem and on
the AL inner OCP of the isrbd problem, to 1e-12, with a member whose plan
holds a NaN (its cost and defect are NaN). `MSDDP.solve_batch` takes its
starting cost and its final defect norm from `MSDDP._evaluate`, twice a
call, and never from the plain `total_cost` or `_true_defects`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    al_solvers,
    fleet_params,
    isrbd_problems,
    jax_al_state,
    jit,
    np_of,
    problems,
    random_al_state,
    solvers,
    tight_box_params,
    to_jax,
    to_torch,
    torch_al_state,
    trajectories,
)
from srbd_horizon_tpu_torch.kernels import isrbd_rollout as k6
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

B = 4
NAN_MEMBER = 1


def _jax_evaluate(js, X, U, params):
    cost = jax.vmap(js.total_cost)(X, U, params)
    defects = jax.vmap(js._true_defects)(X, U, params)
    return cost, jnp.max(jnp.abs(defects), axis=(1, 2))


@pytest.fixture(scope="module")
def srbd_case():
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    X, U = trajectories(jp, B, seed=31)
    X[NAN_MEMBER, 7, 4] = np.nan
    params = fleet_params(jp.ocp.params, B)
    want = jit(lambda *a: _jax_evaluate(js, *a))(*to_jax((X, U, params)))
    args = (to_torch(X), to_torch(U), to_torch(params), ts.terms, tp.ocp.dt,
            ts._wc(torch.float64))
    return dict(ts=ts, args=args, want=want)


@pytest.fixture(scope="module")
def isrbd_case():
    jp, tp = isrbd_problems()
    js, ts = al_solvers(jp, tp)
    st = random_al_state(jp.ocp, B, 32, *ts._sizes)
    params = tight_box_params(jp, B, 33)
    jpin = jax.vmap(js._params_with_multipliers)(to_jax(params),
                                                 jax_al_state(st))
    tpin = ts._params_with_multipliers(to_torch(params), torch_al_state(st))
    X, U = np.array(st["sol"]["X"]), np.array(st["sol"]["U"])
    U[NAN_MEMBER, 3, 0] = np.nan          # r̈ₓ: the RK2 step reads it
    jin = js._inner
    want = jit(lambda *a: _jax_evaluate(jin, *a))(
        jnp.asarray(X), jnp.asarray(U), jpin)
    args = (to_torch(X), to_torch(U), tpin, ts.terms, tp.ocp.dt)
    return dict(ts=ts, args=args, want=want)


CASES = {"srbd": (k3.srbd_evaluate_plain, k3.srbd_evaluate),
         "isrbd_al": (k6.isrbd_evaluate_plain, k6.isrbd_evaluate)}


@pytest.fixture(params=sorted(CASES))
def case(request, srbd_case, isrbd_case):
    c = srbd_case if request.param == "srbd" else isrbd_case
    return (request.param,) + CASES[request.param] + (c,)


@pytest.mark.parametrize("out", [0, 1], ids=["cost", "defect_max"])
def test_evaluate_plain_matches_jax(case, out):
    _, plain, _, c = case
    got = plain(*c["args"])[out]
    want = np.asarray(c["want"][out])
    assert tuple(got.shape) == (B,)
    np.testing.assert_allclose(np_of(got), want, rtol=1e-12, atol=1e-12)
    assert np.isnan(np_of(got)[NAN_MEMBER]) and np.isnan(want[NAN_MEMBER])
    fin = [b for b in range(B) if b != NAN_MEMBER]
    assert np.isfinite(np_of(got)[fin]).all()


def test_evaluate_wrapper_takes_plain_path_on_cpu(case):
    _, plain, wrapper, c = case
    launches = wrapper.launches
    for g, w in zip(wrapper(*c["args"]), plain(*c["args"])):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    assert wrapper.launches == launches


def test_solver_evaluate_is_the_plain_cost_and_defects_on_cpu(case):
    """On CPU tensors `MSDDP._evaluate` computes what the solve computed
    before it had the entry: `total_cost` and the max |_true_defects|."""
    name, _, _, c = case
    solver = c["ts"] if name == "srbd" else c["ts"].inner
    X, U, params = c["args"][:3]
    cost, dmax = solver._evaluate(X, U, params)
    want_cost = solver.total_cost(X, U, params)
    want_dmax = torch.amax(torch.abs(solver._true_defects(X, U, params)),
                           dim=(1, 2))
    for g, w in ((cost, want_cost), (dmax, want_dmax)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


def _spied_solve(monkeypatch, solver, x0, params, calls):
    """One `solve_batch` with `_evaluate`, the trial and the terms' plain
    `total_cost` counted, and the solver's own plain `total_cost` and
    `_true_defects` made to fail."""
    def refuse(*a, **k):
        raise AssertionError("solve_batch called a plain cost or defect")

    monkeypatch.setattr(MSDDP, "total_cost", refuse)
    monkeypatch.setattr(MSDDP, "_true_defects", refuse)
    evaluate, trial = solver._evaluate, solver._trial
    terms_cls = type(solver.terms)
    total_cost = terms_cls.total_cost

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(solver, "_evaluate", counted("evaluate", evaluate))
    monkeypatch.setattr(solver, "_trial", counted("trial", trial))
    monkeypatch.setattr(terms_cls, "total_cost",
                        counted("terms_total_cost", total_cost))
    return solver.solve_batch(solver.init(x0), x0, params)


@pytest.mark.parametrize("family", ["srbd", "isrbd_al"])
def test_solve_batch_evaluates_twice(monkeypatch, srbd_case, isrbd_case,
                                     family):
    c = srbd_case if family == "srbd" else isrbd_case
    solver = c["ts"] if family == "srbd" else c["ts"].inner
    X, _, params = c["args"][:3]
    keep = torch.tensor([b for b in range(B) if b != NAN_MEMBER])
    params = {k: v.index_select(0, keep) for k, v in params.items()}
    x0 = X[keep, 0].clone()
    calls = {"evaluate": 0, "trial": 0, "terms_total_cost": 0}
    sol = _spied_solve(monkeypatch, solver, x0, params, calls)
    assert calls["evaluate"] == 2
    assert calls["trial"] > 0
    # on the CPU every twin calls the terms' cost once: the two evaluations
    # and the trials account for every call
    assert calls["terms_total_cost"] == calls["evaluate"] + calls["trial"]
    assert bool(torch.isfinite(sol.cost).all())
    assert bool(torch.isfinite(sol.defect_norm).all())
