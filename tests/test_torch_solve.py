"""PyTorch port, solver: `MSDDP.solve_batch` against the JAX package's
`solve_batch` in float64 on the CPU, following the setup of
tests/test_batched_solver.py. Iteration counts and convergence flags
must be equal; X, U and cost agree to rtol 1e-7 / atol 1e-9."""

import dataclasses

import jax
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
)
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.solvers import msddp as port_msddp
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)


def _solve_both(B, x0, max_iters=8, **opts):
    jp, tp = problems()
    js, ts = solvers(jp, tp, max_iters=max_iters, **opts)
    params = fleet_params(jp.ocp.params, B)
    jsol = jit(js.solve_batch)(jax.vmap(js.init)(to_jax(x0)),
                               to_jax(x0), to_jax(params))
    tsol = ts.solve_batch(ts.init(to_torch(x0)), to_torch(x0),
                          to_torch(params))
    return jsol, tsol, ts


def _assert_match(jsol, tsol):
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations))
    np.testing.assert_array_equal(tsol.converged.numpy(),
                                  np.asarray(jsol.converged))
    for f in ("X", "U", "cost"):
        np.testing.assert_allclose(np_of(getattr(tsol, f)),
                                   np.asarray(getattr(jsol, f)),
                                   rtol=1e-7, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(tsol.defect_norm.numpy(),
                               np.asarray(jsol.defect_norm), atol=1e-9)


@pytest.fixture(scope="module")
def cold_b5():
    jp, _ = problems()
    x0 = perturbed_states(jp.initial_state, 5, seed=7)
    return _solve_both(5, x0)


def test_solve_batch_matches_jax(cold_b5):
    jsol, tsol, _ = cold_b5
    _assert_match(jsol, tsol)
    assert bool(tsol.converged.all())
    assert int(tsol.iterations.max()) > 1


def test_solve_batch_counts_host_syncs(cold_b5):
    """One read per loop test plus one per iteration for the fan gate."""
    jsol, tsol, ts = cold_b5
    n_iters = int(tsol.iterations.max())
    assert ts.host_syncs >= 2 * n_iters + 1


def test_solve_batch_iteration_budget():
    """max_iters=2 stops every member at 2 iterations unconverged, in both."""
    jp, _ = problems()
    x0 = perturbed_states(jp.initial_state, 3, seed=8, scale=0.05)
    jsol, tsol, _ = _solve_both(3, x0, max_iters=2)
    _assert_match(jsol, tsol)
    assert int(tsol.iterations.max()) == 2


def test_active_compaction_matches_jax():
    """B=64 with the 32-lane compaction level: half the fleet starts near
    the nominal state (converges early), half is pushed harder; once the
    active members fit in 32 lanes the iteration runs on just them.
    (Members started within ~1e-4 of the nominal state finish on the
    merit's rounding floor, where the last accept decision can flip
    between the two packages; these pushes stay clear of it.)"""
    jp, _ = problems()
    B = 64
    near = perturbed_states(jp.initial_state, B // 2, seed=9, scale=0.01)
    far = perturbed_states(jp.initial_state, B // 2, seed=10, scale=0.03)
    x0 = np.concatenate([near, far])
    jp_, tp = problems()
    js, ts = solvers(jp_, tp, max_iters=8, active_compact_levels=1)
    assert ts.compaction_levels(B) == [32]
    lanes_seen = []
    full_iteration = ts._iteration_batch

    def spy(state, x0_, params_, lanes=None):
        lanes_seen.append(lanes)
        return full_iteration(state, x0_, params_, lanes=lanes)

    ts._iteration_batch = spy
    params = fleet_params(jp.ocp.params, B)
    jsol = jit(js.solve_batch)(jax.vmap(js.init)(to_jax(x0)),
                               to_jax(x0), to_jax(params))
    tsol = ts.solve_batch(ts.init(to_torch(x0)), to_torch(x0),
                          to_torch(params))
    assert 32 in lanes_seen, lanes_seen        # the compacted level ran
    _assert_match(jsol, tsol)


@pytest.mark.parametrize("compact", [2, 64], ids=["compacted_fan", "full_fan"])
def test_backtracking_fan_matches_jax(compact):
    """A hard push (0.2 around the nominal state) makes members reject
    the full step, so the deepening fan runs: on just the rejecting
    members when they fit in `line_search_compact`, else on the whole
    batch. Decisions must be equal; the plans agree norm-wise to 1e-7
    (backtracking from a hard push amplifies rounding)."""
    jp, tp = problems()
    js, ts = solvers(jp, tp, max_iters=8, line_search_compact=compact)
    fan_sizes = []
    run_fan = ts._run_fan

    def spy(alphas, data):
        fan_sizes.append(int(data[1].shape[0]))
        return run_fan(alphas, data)

    ts._run_fan = spy
    B = 5
    x0 = perturbed_states(jp.initial_state, B, seed=8, scale=0.2)
    params = fleet_params(jp.ocp.params, B)
    jsol = jit(js.solve_batch)(jax.vmap(js.init)(to_jax(x0)),
                               to_jax(x0), to_jax(params))
    tsol = ts.solve_batch(ts.init(to_torch(x0)), to_torch(x0),
                          to_torch(params))
    assert fan_sizes and all(n == (1 if compact == 2 else B) for n in fan_sizes)
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations))
    np.testing.assert_array_equal(tsol.converged.numpy(),
                                  np.asarray(jsol.converged))
    for f in ("X", "U", "cost"):
        assert max_rel_err(getattr(tsol, f), getattr(jsol, f)) < 1e-7, f


@pytest.mark.parametrize("field,value,exc", [
    ("riccati_mode", "parallel", ValueError),
    ("forward_pass", "affine", ValueError),
    ("analytic_jacobians", True, NotImplementedError),
    ("backward_pair_nodes", True, ValueError),
    ("linearize_fused_backward", True, ValueError),
    ("linearize_lane_out", True, ValueError),
    ("rollout_lane_major", True, ValueError),
    ("gram_row_pruning", True, ValueError),
    ("linearize_precision", "bf16", ValueError),
    ("linearize_ad", "mixed", ValueError),
    ("backward_contract", "split", ValueError),
    ("backward_contract", "combined", ValueError),
])
def test_unported_options_raise(field, value, exc):
    _, tp = problems()
    opts = dataclasses.replace(DDPOptions(), **{field: value})
    with pytest.raises(exc):
        MSDDP(tp.ocp, opts)


@pytest.mark.parametrize("cls,field,value", [
    (DDPOptions, "backward_unroll", 2),
    (DDPOptions, "rollout_unroll", 2),
    (SRBDConfig, "hz", 50.0),
])
def test_unread_options_are_refused(cls, field, value):
    """A JAX field that nothing in the port reads is not carried, so
    setting it fails instead of being ignored."""
    with pytest.raises(TypeError):
        cls(**{field: value})


@pytest.mark.parametrize("solver", ["schur", "cholesky"])
def test_quu_solver_is_carried_and_honoured(solver, monkeypatch):
    """`quu_solver` is read: `solve` hands it to K1's Tassa sweep (the
    results against JAX are in tests/test_torch_single_solve.py), and
    `solve_batch` keeps the collapsed sweep, which ignores it, as the JAX
    package's `solve_batch` does."""
    jp, tp = problems()
    opts = dataclasses.replace(DDPOptions(max_iters=1), quu_solver=solver)
    assert DDPOptions().quu_solver == "schur" and opts.quu_solver == solver
    ts = MSDDP(tp.ocp, opts)
    seen = []
    sweep = port_msddp.riccati_backward

    def spy(*a, **kw):
        seen.append((kw.get("form", "collapsed"), kw.get("quu_solver", "schur")))
        return sweep(*a, **kw)

    monkeypatch.setattr(port_msddp, "riccati_backward", spy)
    x0 = to_torch(perturbed_states(jp.initial_state, 1, seed=4)[0])
    params = to_torch(fleet_params(jp.ocp.params, 1))
    ts.solve(ts.init(x0), x0, {k: v[0] for k, v in params.items()})
    ts.solve_batch(ts.init(x0[None]), x0[None], params)
    assert seen == [("tassa", solver), ("collapsed", "schur")]


@pytest.mark.parametrize("field,value", [
    ("quu_solver", "lu"), ("line_search_mode", "armijo")])
def test_unknown_solver_or_line_search_mode_raises(field, value):
    _, tp = problems()
    with pytest.raises(ValueError):
        MSDDP(tp.ocp, dataclasses.replace(DDPOptions(), **{field: value}))
