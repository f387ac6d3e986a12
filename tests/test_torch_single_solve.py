"""PyTorch port, the single-robot solve: `MSDDP.solve` against the JAX
package's unbatched `solve` in float64 on the CPU, from a cold start and
from a warm start with a moved x0, in both line-search modes and with both
gain solves of the Tassa sweep. Iterations and convergence flags must be
equal; X, U and cost agree to 1e-9 relative (read: ≤ 1.9e-15). Also the
x0 gap of a warm start as a defect (the port's twin of
tests/test_msddp.py::test_x0_gap_is_a_defect), the host reads a solve
makes and `solution_dict` (`quu_solver` reaching K1's Tassa form is
tests/test_torch_solve.py::test_quu_solver_is_carried_and_honoured)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    jit,
    max_rel_err,
    np_of,
    perturbed_states,
    problems,
    solvers,
    to_jax,
    to_torch,
)

torch.set_num_threads(1)

MODES = ["parallel", "sequential"]
SOLVERS = ["schur", "cholesky"]


@pytest.fixture(scope="module")
def base():
    jp, tp = problems()
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    params["rdot_ref"] = params["rdot_ref"].copy()
    params["rdot_ref"][-1] = [0.3, 0.0, 0.0]
    return jp, tp, params


@pytest.fixture(scope="module")
def runs(base):
    """Per (mode, solver): a cold solve from a pushed x0, then a warm solve
    from its plan with x0 moved again, in both packages."""
    jp, tp, params = base
    out = {}
    x_cold = perturbed_states(jp.initial_state, 1, seed=7, scale=0.05)[0]
    x_warm = x_cold + perturbed_states(np.zeros_like(x_cold), 1, seed=8,
                                       scale=0.02)[0]
    for mode in MODES:
        for solver in SOLVERS:
            js, ts = solvers(jp, tp, max_iters=20, line_search_mode=mode,
                             quu_solver=solver)
            jsolve = jit(js.solve)
            jc = jsolve(js.init(to_jax(x_cold)), to_jax(x_cold), to_jax(params))
            jw = jsolve(jc, to_jax(x_warm), to_jax(params))
            syncs0 = ts.host_syncs
            tc = ts.solve(ts.init(to_torch(x_cold)), to_torch(x_cold),
                          to_torch(params))
            syncs = ts.host_syncs - syncs0
            tw = ts.solve(tc, to_torch(x_warm), to_torch(params))
            out[mode, solver] = dict(cold=(jc, tc), warm=(jw, tw), syncs=syncs,
                                     ts=ts, x_warm=x_warm)
    return out


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("mode", MODES)
def test_solve_matches_jax(runs, mode, solver, start):
    jsol, tsol = runs[mode, solver][start]
    assert int(tsol.iterations) == int(jsol.iterations) > 1
    assert bool(tsol.converged) == bool(jsol.converged)
    assert tsol.X.shape == jsol.X.shape and tsol.U.shape == jsol.U.shape
    for f in ("X", "U", "cost"):
        assert max_rel_err(getattr(tsol, f), getattr(jsol, f)) < 1e-9, f
    assert abs(float(tsol.defect_norm) - float(jsol.defect_norm)) < 1e-12
    assert tsol.iterations.dtype == torch.int32
    assert tsol.converged.dtype == torch.bool and tsol.cost.dim() == 0


def test_warm_solve_pins_node0(runs):
    """The warm plan's node 0 is the new x0, bit for bit."""
    for r in runs.values():
        np.testing.assert_array_equal(np_of(r["warm"][1].X[0]), r["x_warm"])


@pytest.mark.parametrize("mode", MODES)
def test_solve_reads_the_host_twice_an_iteration(runs, mode):
    """Parallel: one read a line-search chunk (one chunk an iteration here)
    and one of the convergence flag; sequential: one a step and the flag."""
    r = runs[mode, "schur"]
    iters = int(r["cold"][1].iterations)
    assert 2 * iters - 1 <= r["syncs"] <= 2 * iters + 4


def test_x0_gap_is_a_defect(base):
    """An equilibrium warm start whose X disagrees with the commanded x0 is
    not returned as converged: node 0 is pinned to x0, the gap is the
    node-0 shooting defect, and the solve pays for the offset — as the
    JAX package's solve does on the same problem."""
    jp, tp, _ = base
    js, ts = solvers(jp, tp, max_iters=100)
    x0 = np.asarray(jp.initial_state)
    U0 = np.tile(np.asarray(jp.static_input)[None], (jp.ocp.ns, 1))
    x0_pert = x0.copy()
    x0_pert[0] += 0.05
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    jout = jit(js.solve)(js.init(to_jax(x0), to_jax(U0)), to_jax(x0_pert),
                         to_jax(params))
    tout = ts.solve(ts.init(to_torch(x0), to_torch(U0)), to_torch(x0_pert),
                    to_torch(params))
    np.testing.assert_array_equal(np_of(tout.X[0]), x0_pert)
    assert float(tout.defect_norm) < 1e-8
    still = ts.solve(ts.init(to_torch(x0), to_torch(U0)), to_torch(x0),
                     to_torch(params))
    # (the SRBD equilibrium itself costs ~7.6e3 under the tracking terms)
    assert float(tout.cost) > 1.2 * float(still.cost)
    assert int(tout.iterations) == int(jout.iterations)
    assert max_rel_err(tout.X, jout.X) < 1e-9
    assert abs(float(tout.cost) - float(jout.cost)) < 1e-9 * float(jout.cost)


def test_solution_dict_matches_jax(runs, base):
    jp, tp, _ = base
    js, ts = solvers(jp, tp)
    jsol, tsol = runs["parallel", "schur"]["cold"]
    jd, td = js.solution_dict(jsol), ts.solution_dict(tsol)
    assert set(td) == set(jd)
    for k in jd:
        assert td[k].shape == jd[k].shape, k
        assert max_rel_err(td[k], jd[k]) < 1e-9 if np.abs(np.asarray(jd[k])).max() > 0 \
            else not bool(td[k].abs().max())
