"""PyTorch port, problem: the SRBD step, residual, equality and terminal
stacks against the JAX package's on the same numpy (x, u, p), in float64
to 1e-12, and the declared Jacobian row sets checked for completeness
against `torch.func.jacfwd`."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import np_of, problems, random_xup, solvers, to_jax, to_torch
from srbd_horizon_tpu_torch.models import srbd as tsrbd
from srbd_horizon_tpu.models import srbd as jsrbd

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture(scope="module")
def probs():
    return problems()


def test_layout_and_sizes(probs):
    jp, tp = probs
    assert (tp.ocp.nx, tp.ocp.nu, tp.ocp.ns) == (37, 24, 20)
    assert (jp.ocp.nx, jp.ocp.nu) == (tp.ocp.nx, tp.ocp.nu)
    for field in ("residual_x_rows", "residual_u_rows", "dynamics_x_rows",
                  "dynamics_u_rows"):
        assert tuple(getattr(tp.ocp, field)) == tuple(getattr(jp.ocp, field))
    np.testing.assert_array_equal(np_of(tp.initial_state), np_of(jp.initial_state))
    np.testing.assert_array_equal(np_of(tp.static_input), np_of(jp.static_input))
    for k, v in jp.ocp.params.items():
        np.testing.assert_array_equal(np_of(tp.ocp.params[k]), np_of(v), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["step", "stage_residual", "stage_eq",
                                "terminal_residual", "terminal_eq", "xdot"])
def test_stacks_match_jax(probs, fn, seed):
    """Batched over a leading axis on the torch side, vmapped on the JAX
    side."""
    jp, tp = probs
    x, u, p = random_xup(jp.ocp.params, 37, 24, seed, lead=(5,))
    dt = jp.ocp.dt
    jf, tf = getattr(jp.ocp, fn), getattr(tp.ocp, fn)
    if fn == "step":
        want = jax.vmap(lambda a, b, c: jf(a, b, c, dt))(*to_jax((x, u, p)))
        got = tf(to_torch(x), to_torch(u), to_torch(p), dt)
    elif fn.startswith("terminal"):
        want = jax.vmap(jf)(*to_jax((x, p)))
        got = tf(to_torch(x), to_torch(p))
    else:
        want = jax.vmap(jf)(*to_jax((x, u, p)))
        got = tf(to_torch(x), to_torch(u), to_torch(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_srbd_residual_and_accels_match_jax():
    rng = np.random.RandomState(4)
    B, nc = 4, 4
    forces = rng.randn(B, nc, 3)
    r, w, wdot, rddot = rng.randn(B, 3), rng.randn(B, 3), rng.randn(B, 3), rng.randn(B, 3)
    contacts = rng.randn(B, nc, 3)
    o = rng.randn(B, 4)
    Ib = np.diag([2.1, 1.8, 0.6]) / 1000.0
    jI = jax.vmap(lambda q: jsrbd.world_inertia(Ib, q))(o)
    tI = tsrbd.world_inertia(to_torch(Ib), to_torch(o))
    np.testing.assert_allclose(tI.numpy(), np.asarray(jI), rtol=TOL, atol=TOL)
    want = jax.vmap(lambda *a: jsrbd.f_srbd(0.04, *a))(jI, forces, r, contacts, w)
    got = tsrbd.f_srbd(0.04, tI, *(to_torch(a) for a in (forces, r, contacts, w)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=TOL, atol=TOL)
    want = jax.vmap(lambda *a: jsrbd.srbd_residual(0.04, *a))(
        jI, forces, r, rddot, contacts, w, wdot)
    got = tsrbd.srbd_residual(0.04, tI, *(to_torch(a) for a in (
        forces, r, rddot, contacts, w, wdot)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_declared_rows_complete(probs, seed):
    """Rows outside residual_x/u_rows have zero Jacobian w.r.t. x/u, and
    rows outside dynamics_x/u_rows have (A − I) = 0 / B = 0 — what the
    blocksparse Riccati kernel relies on."""
    _, tp = probs
    _, ts = solvers(*probs)
    ocp = tp.ocp
    x, u, p = random_xup(
        {k: np_of(v) for k, v in ocp.params.items()}, ocp.nx, ocp.nu, seed)
    x, u, p = to_torch(x), to_torch(u), to_torch(p)
    jac = torch.func.jacfwd
    Jx = jac(lambda x_: ts._stage_rho(x_, u, p))(x).numpy()
    Ju = jac(lambda u_: ts._stage_rho(x, u_, p))(u).numpy()
    A = jac(lambda x_: ocp.step(x_, u, p, ocp.dt))(x).numpy() - np.eye(ocp.nx)
    Bm = jac(lambda u_: ocp.step(x, u_, p, ocp.dt))(u).numpy()
    for J, rows in ((Jx, ocp.residual_x_rows), (Ju, ocp.residual_u_rows),
                    (A, ocp.dynamics_x_rows), (Bm, ocp.dynamics_u_rows)):
        dead = sorted(set(range(J.shape[0])) - set(rows))
        assert dead, "the declaration should prune something"
        assert np.all(J[dead] == 0.0)
