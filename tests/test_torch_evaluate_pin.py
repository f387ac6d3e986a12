"""PyTorch port, the evaluation entries' node-0 pin, on the CPU in float64.

Given x0 (B, nx), `srbd_evaluate` (kernels/rollout.py) and `isrbd_evaluate`
(kernels/isrbd_rollout.py) evaluate each plan with node 0 pinned to x0 and
return the pinned plan as a third output: what the JAX package's solve
computes as `X_pinned = sols.X.at[:, 0].set(x0)` and
`jax.vmap(total_cost)(X_pinned, …)` (srbd_horizon_tpu/solvers/msddp.py:
1221-1222). Their plain twins, which the wrappers take for CPU tensors, are
held against that on the SRBD problem and on the AL inner OCP of the isrbd
problem: the pinned plan exactly, the cost and the largest defect to 1e-12;
a NaN in one member's x0 makes that member's cost NaN and no other's;
without x0 the outputs are the two of before, bit for bit. `solve_batch`
takes its pinned plan from the cost0 evaluation: X[:, 0] = x0 on return,
and the solve is bit for bit the one that pinned a clone itself.
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

torch.set_num_threads(1)

B = 4
NAN_MEMBER = 2


def _jax_pinned(js, X, U, params, x0):
    Xp = X.at[:, 0].set(x0)
    cost = jax.vmap(js.total_cost)(Xp, U, params)
    defects = jax.vmap(js._true_defects)(Xp, U, params)
    return Xp, cost, jnp.max(jnp.abs(defects), axis=(1, 2))


@pytest.fixture(scope="module")
def srbd_case():
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    X, U = trajectories(jp, B, seed=41)
    x0 = X[:, 0] + 0.01 * np.random.RandomState(42).randn(B, X.shape[-1])
    params = fleet_params(jp.ocp.params, B)
    want = jit(lambda *a: _jax_pinned(js, *a))(*to_jax((X, U, params, x0)))
    return dict(ts=ts, solver=ts, X=to_torch(X), U=to_torch(U),
                params=to_torch(params), x0=to_torch(x0),
                rest=(ts.terms, tp.ocp.dt, ts._wc(torch.float64)), want=want)


@pytest.fixture(scope="module")
def isrbd_case():
    jp, tp = isrbd_problems()
    js, ts = al_solvers(jp, tp)
    st = random_al_state(jp.ocp, B, 43, *ts._sizes)
    params = tight_box_params(jp, B, 44)
    jpin = jax.vmap(js._params_with_multipliers)(to_jax(params),
                                                 jax_al_state(st))
    tpin = ts._params_with_multipliers(to_torch(params), torch_al_state(st))
    X, U = np.array(st["sol"]["X"]), np.array(st["sol"]["U"])
    x0 = X[:, 0] + 0.01 * np.random.RandomState(45).randn(B, X.shape[-1])
    want = jit(lambda *a: _jax_pinned(js._inner, *a))(
        jnp.asarray(X), jnp.asarray(U), jpin, jnp.asarray(x0))
    return dict(ts=ts, solver=ts.inner, X=to_torch(X), U=to_torch(U),
                params=tpin, x0=to_torch(x0), rest=(ts.terms, tp.ocp.dt),
                want=want)


CASES = {"srbd": (k3.srbd_evaluate_plain, k3.srbd_evaluate),
         "isrbd_al": (k6.isrbd_evaluate_plain, k6.isrbd_evaluate)}


@pytest.fixture(params=sorted(CASES))
def case(request, srbd_case, isrbd_case):
    c = srbd_case if request.param == "srbd" else isrbd_case
    return CASES[request.param] + (c,)


def _call(fn, c, X=None, x0="given"):
    x0 = c["x0"] if isinstance(x0, str) else x0
    return fn(c["X"] if X is None else X, c["U"], c["params"], *c["rest"],
              x0=x0)


def test_pinned_plan_is_jax_pin_exactly(case):
    plain, _, c = case
    out = _call(plain, c)
    assert len(out) == 3
    want = np.asarray(c["want"][0])
    assert out[2].shape == c["X"].shape and out[2].dtype == torch.float64
    assert np.array_equal(np_of(out[2]), want)
    assert np.array_equal(np_of(out[2][:, 0]), np_of(c["x0"]))


@pytest.mark.parametrize("out", [1, 2], ids=["cost", "defect_max"])
def test_pinned_cost_and_defect_match_jax(case, out):
    plain, _, c = case
    got = np_of(_call(plain, c)[out - 1])
    want = np.asarray(c["want"][out])
    assert got.shape == (B,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_nan_in_one_x0_leaves_others_finite(case):
    plain, _, c = case
    x0 = c["x0"].clone()
    x0[NAN_MEMBER, 3] = float("nan")
    cost, dmax, Xp = _call(plain, c, x0=x0)
    others = [b for b in range(B) if b != NAN_MEMBER]
    assert bool(torch.isnan(cost[NAN_MEMBER]))
    assert bool(torch.isfinite(cost[others]).all())
    assert bool(torch.isfinite(dmax[others]).all())
    assert bool(torch.isnan(Xp[NAN_MEMBER, 0, 3]))


def test_without_x0_outputs_are_unchanged(case):
    """No x0: the two outputs of before, bit for bit — the terms' cost and
    the largest |step − next node| of the plan as given — and the plan
    itself untouched by a pinned call."""
    plain, _, c = case
    X = c["X"].clone()
    _call(plain, c, X=X)
    assert torch.equal(X, c["X"])
    out = _call(plain, c, x0=None)
    assert len(out) == 2
    solver = c["solver"]
    want_cost = solver.total_cost(c["X"], c["U"], c["params"])
    want_dmax = torch.amax(torch.abs(solver._true_defects(
        c["X"], c["U"], c["params"])), dim=(1, 2))
    assert torch.equal(out[0], want_cost)
    assert torch.equal(out[1], want_dmax)


def test_wrapper_takes_pinning_twin_on_cpu(case):
    plain, wrapper, c = case
    launches = wrapper.launches
    for g, w in zip(_call(wrapper, c), _call(plain, c)):
        assert torch.equal(g, w)
    assert wrapper.launches == launches


def _clone_pinned(solver):
    """`solver._evaluate` as the solve pinned before the evaluation took
    the pin over: a clone with node 0 set to x0, then the two outputs."""
    evaluate = solver._evaluate

    def old(X, U, params, x0=None):
        if x0 is None:
            return evaluate(X, U, params)
        X = X.clone()
        X[:, 0] = x0
        cost, dmax = evaluate(X, U, params)
        return cost, dmax, X

    return old


@pytest.mark.parametrize("family", ["srbd", "isrbd_al"])
def test_solve_batch_pins_node0_as_before(monkeypatch, srbd_case, isrbd_case,
                                          family):
    c = srbd_case if family == "srbd" else isrbd_case
    solver = c["solver"]
    x0, params = c["x0"], c["params"]
    # a warm start whose node 0 is not x0: the gap is the node-0 defect
    sols = solver.init(c["X"][:, 0].clone())
    sols = sols._replace(X=c["X"].clone(), U=c["U"].clone())
    before = sols.X.clone()
    got = solver.solve_batch(sols, x0, params)
    assert torch.equal(sols.X, before)
    assert torch.equal(got.X[:, 0], x0)
    monkeypatch.setattr(solver, "_evaluate", _clone_pinned(solver))
    want = solver.solve_batch(sols, x0, params)
    for name in ("X", "U", "cost", "converged", "iterations", "defect_norm"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_strided_x0_pins_as_contiguous(case):
    """x0 may be a node of a plan (the serving tick passes X[:, 1]): a view
    whose rows lie ns+1 nodes apart pins exactly as its contiguous copy."""
    plain, wrapper, c = case
    Xs = c["X"].clone()
    Xs[:, 1] = c["x0"]
    x0 = Xs[:, 1]
    assert not x0.is_contiguous()
    for g, w in zip(_call(wrapper, c, x0=x0), _call(plain, c, x0=x0.clone())):
        assert torch.equal(g, w)
