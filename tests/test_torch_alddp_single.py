"""PyTorch port, the single-robot AL solve: `ALDDP.solve` (the isrbd
example's offline solve) and `solve_online` (its per-tick solve, after
`shift_warmstart`) against the JAX package's, on the isrbd problem at
ns=8 in float64 on the CPU. The inner solves run the Cholesky gain solve
in both packages (the JAX package forces it, alddp.py:324-331); the
port's run K1's Tassa form with it. Iterations and convergence
are equal; the plan, the multipliers, ρ and the violation agree to 1e-9
relative (read: ≤ 5.1e-13). At ρ = 1e8, where the block-Schur solve is
predicted to emit NaNs, the Cholesky inner solve stays finite in both
packages and they agree to 1e-7 (read: ≤ 2.5e-10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    al_solvers,
    isrbd_problems,
    jit,
    max_rel_err,
    np_of,
    perturbed_states,
    to_jax,
    to_torch,
)
from srbd_horizon_tpu_torch.convert import al_state_from_numpy
from srbd_horizon_tpu_torch.solvers.alddp import ALState

torch.set_num_threads(1)

NS = 8
FIELDS = ("lam_eq", "lam_eq_T", "mu_ub", "mu_lb", "mu_x_ub", "mu_x_lb",
          "mu_u_ub", "mu_u_lb", "rho", "viol")


def _state_err(tst, jst):
    """Largest relative error over the plan, cost and every multiplier."""
    errs = {f: max_rel_err(getattr(tst.sol, f), getattr(jst.sol, f))
            for f in ("X", "U", "cost")}
    for f in FIELDS:
        want = np.asarray(getattr(jst, f))
        if np.abs(want).max() > 0:
            errs[f] = max_rel_err(getattr(tst, f), want)
        else:
            assert not bool(getattr(tst, f).abs().max()), f
    return errs


def _same_decisions(tst, jst):
    assert int(tst.sol.iterations) == int(jst.sol.iterations)
    assert bool(tst.sol.converged) == bool(jst.sol.converged)


def _run(max_iters, **al):
    """Offline solve, then shift and two online solves from moved x0s, in
    both packages; the JAX state and the port's after each step."""
    jp, tp = isrbd_problems(ns=NS)
    jal, tal = al_solvers(jp, tp, max_iters=max_iters, **al)
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    x0 = perturbed_states(jp.initial_state, 1, seed=13)[0]
    U0 = np.tile(np.asarray(jp.static_input)[None], (NS, 1))
    jst = jit(jal.solve)(jal.init(jnp.asarray(x0), jnp.asarray(U0)),
                         jnp.asarray(x0), to_jax(params))
    tst = tal.solve(tal.init(to_torch(x0), to_torch(U0)), to_torch(x0),
                    to_torch(params))
    steps = [("solve", jst, tst)]
    jonline, jshift = jit(jal.solve_online), jit(jal.shift_warmstart)
    for k in range(2):
        x0 = x0 + perturbed_states(np.zeros_like(x0), 1, seed=14 + k,
                                   scale=0.002)[0]
        jst = jonline(jshift(jst), jnp.asarray(x0), to_jax(params))
        tst = tal.solve_online(tal.shift_warmstart(tst), to_torch(x0),
                               to_torch(params))
        steps.append((f"online {k}", jst, tst))
    return dict(jal=jal, tal=tal, steps=steps)


@pytest.fixture(scope="module")
def serving():
    return _run(max_iters=15, outer_iters=3)


def test_solve_and_solve_online_match_jax(serving):
    for name, jst, tst in serving["steps"]:
        _same_decisions(tst, jst)
        errs = _state_err(tst, jst)
        assert max(errs.values()) < 1e-9, (name, errs)
        assert bool(torch.isfinite(tst.sol.X).all()), name


def test_the_solve_works(serving):
    """The offline solve iterates and lowers the violation; ρ is 0-d."""
    _, jst, tst = serving["steps"][0]
    assert int(tst.sol.iterations) > 1
    assert tst.rho.dim() == 0 and tst.viol.dim() == 0
    assert float(tst.viol) < 0.1


def test_init_and_shift_warmstart_are_unbatched_as_in_jax(serving):
    jal, tal = serving["jal"], serving["tal"]
    _, jst, tst = serving["steps"][0]
    x0 = np.asarray(jst.sol.X[0])
    ji, ti = jal.init(jnp.asarray(x0)), tal.init(to_torch(x0))
    for f in FIELDS:
        assert tuple(getattr(ti, f).shape) == getattr(ji, f).shape, f
        np.testing.assert_array_equal(np_of(getattr(ti, f)),
                                      np.asarray(getattr(ji, f)))
    assert tuple(ti.sol.X.shape) == ji.sol.X.shape
    js, ts = jal.shift_warmstart(jst), tal.shift_warmstart(tst)
    np.testing.assert_array_equal(np_of(ts.lam_eq),
                                  np_of(tst.lam_eq)[np.r_[1:NS, NS - 1]])
    np.testing.assert_array_equal(np_of(ts.sol.X),
                                  np_of(tst.sol.X)[np.r_[1:NS + 1, NS]])
    for f in ("lam_eq", "mu_ub", "mu_x_lb", "mu_u_ub"):
        assert max_rel_err(getattr(ts, f), getattr(js, f)) < 1e-9, f
    assert ts.rho.dim() == 0


def test_solution_dict_matches_jax(serving):
    _, jst, tst = serving["steps"][-1]
    jd, td = serving["jal"].solution_dict(jst), serving["tal"].solution_dict(tst)
    assert set(jd) == set(td)
    for k in ("x_opt", "u_opt", "r", "f0"):
        assert max_rel_err(td[k], jd[k]) < 1e-9, k


def test_unbatched_state_crosses_from_jax(serving):
    """An unbatched JAX ALState crosses as numpy and both packages take the
    same online solve from it."""
    jal, tal = serving["jal"], serving["tal"]
    _, jst, _ = serving["steps"][1]
    st = {f: np.asarray(getattr(jst, f)) for f in ALState._fields if f != "sol"}
    st["sol"] = {f: np.asarray(v) for f, v in jst.sol._asdict().items()}
    tst = al_state_from_numpy(st, device="cpu", dtype=torch.float64)
    assert tst.rho.dim() == 0 and tst.sol.converged.dtype == torch.bool
    x0 = np.asarray(jst.sol.X[1])
    params = {k: np.asarray(v) for k, v in jal.ocp.params.items()}
    jn = jit(jal.solve_online)(jst, jnp.asarray(x0), to_jax(params))
    tn = tal.solve_online(tst, to_torch(x0), to_torch(params))
    _same_decisions(tn, jn)
    assert max(_state_err(tn, jn).values()) < 1e-9


def test_inner_solve_is_cholesky_at_rho_1e8():
    """ρ = 1e8 from the first outer (the conditioning `alddp.py:324-330`
    names): the Cholesky inner solves stay finite in both packages, and
    the port follows JAX."""
    run = _run(max_iters=6, outer_iters=2, rho0=1e8, rho_max=1e8)
    assert run["tal"].inner.opts.quu_solver == "cholesky"
    for name, jst, tst in run["steps"]:
        assert np.isfinite(np.asarray(jst.sol.X)).all(), name
        assert bool(torch.isfinite(tst.sol.X).all()), name
        assert float(tst.rho) == 1e8
        _same_decisions(tst, jst)
        errs = _state_err(tst, jst)
        assert max(errs.values()) < 1e-7, (name, errs)
