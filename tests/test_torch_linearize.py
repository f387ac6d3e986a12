"""PyTorch port, linearization: `MSDDP._linearize_sliced` (torch.func
jacfwd under vmap, over the declared row slices) against the JAX
package's sliced linearization on the same numpy trajectories, in
float64 to 1e-10; the solver's cost, defects and cold start to 1e-12."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    fleet_params,
    max_rel_err,
    np_of,
    problems,
    solvers,
    to_jax,
    to_torch,
    trajectories,
)

torch.set_num_threads(1)

KEYS = ("Sx", "Bs", "Jxp", "Jup", "rho", "rt", "Jt", "d")


@pytest.fixture(scope="module")
def linearized():
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    B = 4
    X, U = trajectories(jp, B, seed=3)
    params = fleet_params(jp.ocp.params, B)
    want = jax.jit(jax.vmap(
        lambda x, u, p: js._linearize(x, u, p, sliced=True)
    ))(*to_jax((X, U, params)))
    got = ts._linearize_sliced(to_torch(X), to_torch(U), to_torch(params))
    return got, want


@pytest.mark.parametrize("key", KEYS)
def test_linearize_sliced_matches_jax(linearized, key):
    got, want = linearized
    assert tuple(got[key].shape) == tuple(want[key].shape)
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               rtol=1e-10, atol=1e-10)
    assert max_rel_err(got[key], want[key]) < 1e-10


def test_linearize_sliced_shapes(linearized):
    """SRBD's sliced stacks: 22 live rows of A−I, 18 of B, 34/42 residual
    rows touching x/u, 73 stacked residual rows, 15 terminal rows."""
    got, _ = linearized
    assert tuple(got["Sx"].shape[2:]) == (22, 37)
    assert tuple(got["Bs"].shape[2:]) == (18, 24)
    assert tuple(got["Jxp"].shape[2:]) == (34, 37)
    assert tuple(got["Jup"].shape[2:]) == (42, 24)
    assert got["rho"].shape[-1] == 73
    assert tuple(got["Jt"].shape[1:]) == (15, 37)
    assert all(got[k].is_contiguous() for k in KEYS)


@pytest.fixture(scope="module")
def point():
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    B = 3
    X, U = trajectories(jp, B, seed=5)
    params = fleet_params(jp.ocp.params, B)
    return js, ts, X, U, params


@pytest.mark.parametrize("fn", ["total_cost", "_true_defects"])
def test_cost_and_defects_match_jax(point, fn):
    js, ts, X, U, params = point
    want = jax.jit(jax.vmap(getattr(js, fn)))(*to_jax((X, U, params)))
    got = getattr(ts, fn)(to_torch(X), to_torch(U), to_torch(params))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_init_matches_jax(point):
    js, ts, X, _, _ = point
    x0 = X[:, 0]
    want = jax.vmap(js.init)(to_jax(x0))
    got = ts.init(to_torch(x0))
    for f in ("X", "U", "cost", "converged", "iterations", "defect_norm"):
        np.testing.assert_array_equal(np_of(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
