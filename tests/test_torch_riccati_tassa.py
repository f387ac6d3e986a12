"""PyTorch port, K1's Tassa form (the single-robot sweep of `MSDDP.solve`)
and the Cholesky twins, on the CPU in float64.

  - `riccati_backward_plain(form="tassa")` against the JAX package's
    unbatched `MSDDP._backward` (msddp.py:365-417) on its dense
    linearization of the same point, for both gain solves (`quu_solver`
    "schur" and "cholesky") and both problems (the SRBD OCP and the isrbd
    AL inner OCP): ks, Ks, dV1, dV2 to 1e-10 relative (read: ≤ 6e-12);
  - `spd_inverse`, `spd_solve` against the JAX package's to 1e-12;
  - `cho_factor`/`cho_solve` on a matrix that is not positive definite:
    NaN where JAX's `cho_factor`/`cho_solve` read NaN, nothing raised; a
    sweep whose Quu is indefinite gives NaN gains in both packages;
  - the table of K1's compiled (shape, form, solver) instantiations
    against the CUDA source, and the refusal of any other.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from _torch_parity import (
    al_solvers,
    fleet_params,
    isrbd_problems,
    jax_al_state,
    jit,
    max_rel_err,
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
from srbd_horizon_tpu.math.linalg import spd_inverse as j_spd_inverse
from srbd_horizon_tpu.math.linalg import spd_solve as j_spd_solve
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels.isrbd_linearize import isrbd_linearize_plain
from srbd_horizon_tpu_torch.kernels.linearize import srbd_linearize_plain
from srbd_horizon_tpu_torch.math.linalg import (
    cho_factor,
    cho_solve,
    spd_inverse,
    spd_solve,
)

torch.set_num_threads(1)

ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
OUTS = ("ks", "Ks", "dV1", "dV2")
MU = 1e-6
SOURCE = Path(k1.__file__).resolve().parents[1] / "csrc" / "riccati_backward.cu"


def _srbd_point():
    """(JAX MSDDP, port lin (B=1), X, U, params) at a drawn SRBD point."""
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    X, U = trajectories(jp, 1, seed=3)
    params = fleet_params(jp.ocp.params, 1)
    tlin = srbd_linearize_plain(to_torch(X), to_torch(U), to_torch(params),
                                ts.terms, ts.rows, tp.ocp.dt,
                                ts._wc(torch.float64))
    jpar = {k: v[0] for k, v in params.items()}
    return js, tlin, ts.rows, (X[0], U[0], jpar)


def _isrbd_point():
    """The same at a drawn point of the isrbd AL inner OCP (ns=8), with
    active cones and boxes and random multipliers."""
    jp, tp = isrbd_problems(ns=8)
    jal, tal = al_solvers(jp, tp)
    st = random_al_state(jp.ocp, 1, 31, *tal._sizes)
    params = tight_box_params(jp, 1, 32)
    jpin = jax.vmap(jal._params_with_multipliers)(to_jax(params),
                                                  jax_al_state(st))
    tpin = tal._params_with_multipliers(to_torch(params), torch_al_state(st))
    X, U = st["sol"]["X"], st["sol"]["U"]
    tlin = isrbd_linearize_plain(to_torch(X), to_torch(U), tpin, tal.terms,
                                 tal.inner.rows, tp.ocp.dt)
    jpar = {k: v[0] for k, v in jpin.items()}
    return jal._inner, tlin, tal.inner.rows, (X[0], U[0], jpar)


@pytest.fixture(scope="module")
def points():
    return {"srbd": _srbd_point(), "isrbd_al": _isrbd_point()}


def _jax_backward(jm, point, solver, mu=MU):
    """JAX `_backward` with `quu_solver=solver` on the dense linearization
    (`_linearize`) of the point."""
    jm = dataclasses.replace(jm, opts=dataclasses.replace(jm.opts,
                                                         quu_solver=solver))
    X, U, p = point
    lin = jit(jm._linearize)(jnp.asarray(X), jnp.asarray(U), to_jax(p))
    return jit(jm._backward)(lin, jnp.asarray(mu))


def _tassa(tlin, rows, solver, mu=MU, fn=k1.riccati_backward_plain):
    return fn(*(tlin[k] for k in ORDER), mu, rows, form="tassa",
              quu_solver=solver)


@pytest.mark.parametrize("solver", ["schur", "cholesky"])
@pytest.mark.parametrize("shape", ["srbd", "isrbd_al"])
def test_tassa_twin_matches_jax_backward(points, shape, solver):
    jm, tlin, rows, point = points[shape]
    want = _jax_backward(jm, point, solver)
    got = _tassa(tlin, rows, solver)
    for name, g, w in zip(OUTS, got, want):
        assert g.shape[1:] == w.shape
        assert bool(torch.isfinite(g).all())
        assert max_rel_err(g[0], w) < 1e-10, name


def test_tassa_differs_from_collapsed_only_in_rounding(points):
    """Both forms solve the same Riccati recursion (Quu k = −Qu makes the
    Tassa terms collapse): at the SRBD point they agree to ~3e-11."""
    _, tlin, rows, _ = points["srbd"]
    tassa = _tassa(tlin, rows, "schur")
    collapsed = k1.riccati_backward_plain(*(tlin[k] for k in ORDER), MU, rows)
    for t, c in zip(tassa, collapsed):
        assert 0.0 < max_rel_err(t, c) < 1e-9


@pytest.mark.parametrize("solver", ["schur", "cholesky"])
def test_tassa_wrapper_takes_plain_path_on_cpu(points, solver):
    _, tlin, rows, _ = points["isrbd_al"]
    before = k1.riccati_backward.launches
    got = _tassa(tlin, rows, solver, fn=k1.riccati_backward)
    want = _tassa(tlin, rows, solver)
    assert k1.riccati_backward.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_collapsed_form_ignores_quu_solver(points):
    _, tlin, rows, _ = points["srbd"]
    args = tuple(tlin[k] for k in ORDER) + (MU, rows)
    plain = k1.riccati_backward_plain(*args)
    chol = k1.riccati_backward_plain(*args, form="collapsed",
                                     quu_solver="cholesky")
    for a, b in zip(plain, chol):
        assert torch.equal(a, b)


def test_spd_inverse_and_solve_match_jax():
    g = np.random.RandomState(5)
    J = g.randn(6, 33, 30)
    A = 2.0 * np.swapaxes(J, -1, -2) @ J + 1e-6 * np.eye(30)
    b = g.randn(6, 30, 38)
    assert max_rel_err(spd_inverse(to_torch(A)), j_spd_inverse(jnp.asarray(A))) < 1e-12
    assert max_rel_err(spd_solve(to_torch(A), to_torch(b)),
                       j_spd_solve(jnp.asarray(A), jnp.asarray(b))) < 1e-12
    L = cho_factor(to_torch(A))
    assert max_rel_err(L @ L.transpose(-1, -2), A) < 1e-14
    assert max_rel_err(cho_solve(L, to_torch(b)),
                       jsl.cho_solve(jsl.cho_factor(jnp.asarray(A)),
                                     jnp.asarray(b))) < 1e-10


def test_cho_factor_of_an_indefinite_matrix_is_nan_as_in_jax():
    """[[1, 2], [2, 1]] has no Cholesky factor: JAX's `cho_factor` (upper)
    reads NaN on and above the diagonal and its `cho_solve` NaN; the
    port's lower factor is NaN on and below it, its solve NaN, and
    nothing raises (torch.linalg.cholesky would)."""
    A = np.array([[1.0, 2.0], [2.0, 1.0]])
    jc, lower = jsl.cho_factor(jnp.asarray(A))
    assert not lower
    jfac = np.asarray(jc)
    L = np_of(cho_factor(to_torch(A)))
    np.testing.assert_array_equal(np.isnan(L), np.isnan(jfac.T))
    assert np.isnan(L[np.tril_indices(2)]).all() and (L[0, 1] == 0.0)
    jx = np.asarray(jsl.cho_solve((jc, lower), jnp.eye(2)))
    x = np_of(cho_solve(cho_factor(to_torch(A)), torch.eye(2, dtype=torch.float64)))
    assert np.isnan(jx).all() and np.isnan(x).all()
    # a batch keeps its positive definite members
    both = to_torch(np.stack([A, np.eye(2)]))
    Lb = cho_factor(both)
    assert bool(torch.isnan(Lb[0]).any()) and torch.equal(Lb[1], torch.eye(2, dtype=torch.float64))


@pytest.mark.parametrize("shape", ["srbd", "isrbd_al"])
def test_indefinite_quu_gives_nan_gains_in_both(points, shape):
    """μ = −1e12 makes every node's Quu indefinite: JAX's Cholesky sweep and
    the port's give NaN gains and NaN ΔV, and neither raises."""
    jm, tlin, rows, point = points[shape]
    want = _jax_backward(jm, point, "cholesky", mu=-1e12)
    got = _tassa(tlin, rows, "cholesky", mu=-1e12)
    for g, w in zip(got, want):
        assert np.isnan(np.asarray(w)).all() and bool(torch.isnan(g).all())


def test_kernel_instances_resolve_and_others_are_refused():
    for i, (shape, form, solver) in enumerate(k1.KERNEL_INSTANCES):
        assert k1.kernel_instance(shape, form, solver) == i
    # the collapsed form ignores the gain solve
    assert k1.kernel_instance("srbd", "collapsed", "cholesky") == 0
    assert k1.kernel_instance("isrbd_al", "collapsed", "cholesky") == 1
    with pytest.raises(ValueError, match="no kernel for"):
        k1.kernel_instance("isrbd_al", "tassa", "schur")
    with pytest.raises(ValueError):
        k1.kernel_instance("srbd", "riccati", "schur")
    with pytest.raises(ValueError):
        k1.kernel_instance("srbd", "tassa", "lu")
    with pytest.raises(ValueError):
        k1.riccati_backward_plain(*(torch.zeros(1, 1, 1, 1),) * 8, MU,
                                  k1.RiccatiRows((), (), (), (), (), (), ()),
                                  form="tassa", quu_solver="lu")


def test_kernel_instances_match_the_cuda_source():
    """KERNEL_INSTANCES, in order, is the source's `with_instance` switch
    (the square-feet biped's cases, 40-51, are the ones
    csrc/riccati_backward_square_feet.cu compiles; the line-feet
    quadruped's, 52-63, csrc/riccati_backward_line_feet.cu's)."""
    src = SOURCE.read_text()
    cases = re.findall(r"case (\d+): return fn\(Inst<(\w+)Shape, Form::k(\w+), "
                       r"Solve::k(\w+)>\{\}\);", src)
    names = {"Srbd": "srbd", "IsrbdAl": "isrbd_al", "Lip": "lip",
             "Quad": "quadruped", "QuadAl": "isrbd_al_quadruped",
             "PointFeet": "point_feet", "SrbdRk": "srbd_rk",
             "QuadRk": "quadruped_rk", "PointFeetRk": "point_feet_rk",
             "LipRk": "lip_rk", "LipQuad": "lip_quadruped",
             "LipQuadRk": "lip_quadruped_rk",
             "LipPointFeet": "lip_point_feet",
             "LipPointFeetRk": "lip_point_feet_rk",
             "SquareFeet": "square_feet", "SquareFeetRk": "square_feet_rk",
             "LipSquareFeet": "lip_square_feet",
             "LipSquareFeetRk": "lip_square_feet_rk",
             "LineFeetQuad": "line_feet_quadruped",
             "LineFeetQuadRk": "line_feet_quadruped_rk",
             "LipLineFeetQuad": "lip_line_feet_quadruped",
             "LipLineFeetQuadRk": "lip_line_feet_quadruped_rk"}
    parsed = [(names[s], f.lower(), g.lower()) for _, s, f, g in cases]
    assert [int(i) for i, *_ in cases] == list(range(len(cases)))
    assert tuple(parsed) == k1.KERNEL_INSTANCES
