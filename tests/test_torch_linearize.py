"""PyTorch port, linearization: `MSDDP._linearize_sliced` (the closed-form
K4, `kernels/linearize.py`, whose plain twin runs on the CPU) against the
JAX package's sliced linearization (`jax.jacfwd` over the declared row
slices) on the same numpy trajectories, in float64 to 1e-10; the plain
K4 against JAX's jacfwd at random points with non-unit quaternions and
switched contacts, to rtol 1e-9 / atol 1e-11; the solver's cost, defects
and cold start to 1e-12."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    fleet_params,
    jit,
    max_rel_err,
    np_of,
    problems,
    random_xup,
    solvers,
    to_jax,
    to_torch,
    trajectories,
)
from srbd_horizon_tpu_torch.kernels.linearize import (
    srbd_linearize,
    srbd_linearize_plain,
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
    want = jit(jax.vmap(
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
def random_points():
    """B=3 members at random points around the walking regime: non-unit
    quaternions, random contacts, forces and velocities, random parameter
    rows with rounded (0/1) cdot_switch rows."""
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    B, ns = 3, jp.ocp.ns
    x, u, p = random_xup(jp.ocp.params, jp.ocp.nx, jp.ocp.nu, seed=21,
                         lead=(B, ns + 1))
    U = np.ascontiguousarray(u[:, :ns])
    x[..., 3:7] *= 1.1      # ‖o‖ ≈ 1.1: quat_to_rot is not normalized
    rng = np.random.RandomState(22)
    p["cdot_switch"] = np.round(rng.uniform(0, 1, p["cdot_switch"].shape))
    assert np.all(np.abs(np.linalg.norm(x[..., 3:7], axis=-1) - 1.0) > 0.05)
    assert set(np.unique(p["cdot_switch"])) == {0.0, 1.0}
    want = jit(jax.vmap(
        lambda x_, u_, p_: js._linearize(x_, u_, p_, sliced=True)
    ))(*to_jax((x, U, p)))
    args = (to_torch(x), to_torch(U), to_torch(p), ts.terms, ts.rows,
            tp.ocp.dt, ts._wc(torch.float64))
    return args, want


@pytest.mark.parametrize("key", KEYS)
def test_closed_form_matches_jacfwd(random_points, key):
    args, want = random_points
    got = srbd_linearize_plain(*args)
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               rtol=1e-9, atol=1e-11)


def test_linearize_wrapper_takes_plain_path_on_cpu(random_points):
    args, _ = random_points
    before = srbd_linearize.launches
    got, want = srbd_linearize(*args), srbd_linearize_plain(*args)
    for k in KEYS:
        assert torch.equal(got[k], want[k])
    assert srbd_linearize.launches == before   # no kernel launch on CPU


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
    want = jit(jax.vmap(getattr(js, fn)))(*to_jax((X, U, params)))
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
