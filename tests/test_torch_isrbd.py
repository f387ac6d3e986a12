"""PyTorch port, the isrbd problem and the AL inner problem against the
JAX package in float64 on the CPU: every callable of the OCP at random
points (rtol 1e-12), its bounds, scales, row sets and start point, the
rk2 step, the LIP model, and the AL inner stacks at random (x, u, λ, μ, ρ)
with active and infinite bounds, with the composed row sets and the sizes
240/101/60/103/9 pinned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu.models import lip as jlip
from srbd_horizon_tpu_torch.config import SRBDConfig
from srbd_horizon_tpu_torch.models import lip as tlip
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP

from _torch_parity import (
    F64, al_solvers, isrbd_problems, jax_al_state, np_of, random_al_state,
    random_xup, tight_box_params, to_jax, to_torch, torch_al_state,
)

torch.set_num_threads(1)
RTOL = 1e-12


@pytest.fixture(scope="module")
def case():
    jp, tp = isrbd_problems()
    js, ts = al_solvers(jp, tp)
    return dict(jp=jp, tp=tp, js=js, ts=ts)


def _close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fn", ["stage_residual", "stage_eq", "stage_ineq",
                                "step", "xdot"])
def test_stage_callables_match_jax(case, fn):
    jocp, tocp = case["jp"].ocp, case["tp"].ocp
    x, u, p = random_xup(jocp.params, jocp.nx, jocp.nu, seed=3, lead=(5,))
    for k in ("mask_track", "mask_srbd", "mask_lip", "mask_lipzone"):
        p[k] = np.round(np.clip(p[k], 0, 1))
    u[:, 9:12] += [10.0, -20.0, 90.0]
    extra = (jocp.dt,) if fn == "step" else ()
    want = jax.vmap(lambda x_, u_, p_: getattr(jocp, fn)(x_, u_, p_, *extra))(
        *to_jax((x, u, p)))
    got = getattr(tocp, fn)(to_torch(x), to_torch(u), to_torch(p), *extra)
    _close(got, want)


@pytest.mark.parametrize("fn", ["terminal_residual", "terminal_eq"])
def test_terminal_callables_match_jax(case, fn):
    jocp, tocp = case["jp"].ocp, case["tp"].ocp
    x, _, p = random_xup(jocp.params, jocp.nx, jocp.nu, seed=4, lead=(5,))
    want = jax.vmap(getattr(jocp, fn))(*to_jax((x, p)))
    _close(getattr(tocp, fn)(to_torch(x), to_torch(p)), want)


@pytest.mark.parametrize("name", [
    "eq_scale", "eq_rho_weight", "eq_rho_weight_T", "ineq_lb", "ineq_ub",
    "x_lb", "x_ub", "u_lb", "u_ub"])
def test_bounds_and_scales_match_jax(case, name):
    want = np.asarray(getattr(case["jp"].ocp, name))
    got = np_of(getattr(case["tp"].ocp, name))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    _close(np.nan_to_num(got, posinf=0, neginf=0),
           np.nan_to_num(want, posinf=0, neginf=0))
    assert case["tp"].ocp.eq_scale_T is None and case["jp"].ocp.eq_scale_T is None


@pytest.mark.parametrize("name", [
    "residual_x_rows", "residual_u_rows", "dynamics_x_rows",
    "dynamics_u_rows", "dynamics_u_cols", "ineq_x_rows", "ineq_u_rows"])
def test_row_sets_match_jax(case, name):
    want = tuple(int(r) for r in getattr(case["jp"].ocp, name))
    assert tuple(getattr(case["tp"].ocp, name)) == want


def test_start_point_and_params_match_jax(case):
    jp, tp = case["jp"], case["tp"]
    _close(tp.initial_state, jp.initial_state)
    _close(tp.static_input, jp.static_input)
    assert set(tp.ocp.params) == set(jp.ocp.params)
    for k, v in jp.ocp.params.items():
        np.testing.assert_array_equal(np_of(tp.ocp.params[k]), np.asarray(v))
    assert (tp.ocp.nx, tp.ocp.nu, tp.ocp.ns) == (37, 30, 20)
    assert tp.ocp.state_layout.names == jp.ocp.state_layout.names
    assert tp.ocp.input_layout.names == jp.ocp.input_layout.names


def test_lip_height_guard():
    with pytest.raises(ValueError, match="lip_height"):
        build_isrbd_problem(SRBDConfig(dtype=F64, lip_height=0.4),
                            kangaroo_line_feet(), device="cpu")


def test_cz_rho_weight_reaches_the_cz_rows(case):
    _, tp = isrbd_problems(cz_rho_weight=3200.0)
    w = np_of(tp.ocp.eq_rho_weight)
    np.testing.assert_array_equal(w[4:8], 3200.0)
    np.testing.assert_array_equal(np_of(tp.ocp.eq_rho_weight_T)[4:8], 3200.0)
    np.testing.assert_array_equal(np_of(case["tp"].ocp.eq_rho_weight)[4:8], 400.0)


def test_lip_model_matches_jax():
    rng = np.random.RandomState(2)
    nc = 4
    x = rng.randn(6, 6 + 6 * nc)
    u = rng.randn(6, 3 + 3 * nc)
    want = jax.vmap(jlip.lip_xdot)(jnp.asarray(x), jnp.asarray(u))
    _close(tlip.lip_xdot(to_torch(x), to_torch(u)), want)
    r, rdd, c = rng.randn(6, 3), rng.randn(6, 3), rng.randn(6, nc, 3)
    want = jax.vmap(lambda r_, a_, c_: jlip.lip_dynamics_residual(
        39.0, None, r_, a_, c_, eta2=11.0))(*to_jax((r, rdd, c)))
    _close(tlip.lip_dynamics_residual(39.0, None, to_torch(r), to_torch(rdd),
                                      to_torch(c), eta2=11.0), want)
    _close(tlip.lip_rddot(to_torch(r), to_torch(rdd)),
           jax.vmap(jlip.lip_rddot)(jnp.asarray(r), jnp.asarray(rdd)))
    s = tlip.split_lip_state(to_torch(x), nc)
    js = jlip.split_lip_state(jnp.asarray(x), nc)
    for k in js:
        _close(s[k], js[k])
    i = tlip.split_lip_input(to_torch(u), nc)
    for k, v in jlip.split_lip_input(jnp.asarray(u), nc).items():
        _close(i[k], v)


# ---------------- the AL inner problem ----------------

def test_inner_sizes_and_row_sets_match_jax(case):
    js, ts = case["js"], case["ts"]
    jin, tin = js._inner.ocp, ts.inner.ocp
    assert tuple(tin.residual_x_rows) == tuple(jin.residual_x_rows)
    assert tuple(tin.residual_u_rows) == tuple(jin.residual_u_rows)
    rows = ts.inner.rows
    assert (ts.terms.n_rho, ts.terms.n_term) == (240, 101)
    assert (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu),
            len(rows.bx), len(rows.uc)) == (19, 37, 60, 103, 9, 18)
    assert rows.uc == tuple(sorted(int(c) for c in jin.dynamics_u_cols))
    assert ts._sizes == tuple(int(n) for n in js._probe_sizes())


@pytest.fixture(scope="module")
def inner_point(case):
    """Inner params from a random ALState and tight boxes, built by each
    package's own `_params_with_multipliers`."""
    js, ts, jp = case["js"], case["ts"], case["jp"]
    B = 3
    st = random_al_state(jp.ocp, B, 7, *ts._sizes)
    params = tight_box_params(jp, B, 8)
    jst = jax_al_state(st)
    jpin = jax.vmap(js._params_with_multipliers)(to_jax(params), jst)
    tpin = ts._params_with_multipliers(to_torch(params), torch_al_state(st))
    return dict(st=st, params=params, jpin=jpin, tpin=tpin, B=B)


def test_params_with_multipliers_match_jax(inner_point):
    jpin, tpin = inner_point["jpin"], inner_point["tpin"]
    assert set(tpin) == set(jpin)
    for k, v in jpin.items():
        got, want = np_of(tpin[k]), np.asarray(v)
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_inner_stacks_match_jax(case, inner_point):
    js, ts = case["js"], case["ts"]
    st, jpin, tpin = inner_point["st"], inner_point["jpin"], inner_point["tpin"]
    ns = case["jp"].ocp.ns
    X, U = st["sol"]["X"], st["sol"]["U"]
    jin = js._inner.ocp
    want = jax.vmap(jax.vmap(jin.stage_residual))(
        jnp.asarray(X[:, :ns]), jnp.asarray(U),
        {k: v[:, :ns] for k, v in jpin.items()})
    got = ts.terms.stage_residual(to_torch(X[:, :ns]), to_torch(U),
                                  {k: v[:, :ns] for k, v in tpin.items()})
    assert got.shape[-1] == 240
    _close(got, want, atol=1e-9)
    # some one-sided rows are active, some are not
    act = np_of(got)[..., 66:] > 0
    assert 0.05 < act.mean() < 0.9
    want = jax.vmap(jin.terminal_residual)(
        jnp.asarray(X[:, ns]), {k: v[:, ns] for k, v in jpin.items()})
    got = ts.terms.terminal_residual(to_torch(X[:, ns]),
                                     {k: v[:, ns] for k, v in tpin.items()})
    assert got.shape[-1] == 101
    _close(got, want, atol=1e-9)
    # the inner problem carries no equality stack of its own
    assert ts.inner.ocp.stage_eq(to_torch(X[:, 0]), None, None).shape == (3, 0)
    want = jax.vmap(js._inner.total_cost)(jnp.asarray(X), jnp.asarray(U), jpin)
    _close(ts.inner.total_cost(to_torch(X), to_torch(U), tpin), want)


def test_alddp_refuses_other_problems():
    from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
    prob = build_srbd_problem(SRBDConfig(dtype=F64), kangaroo_line_feet(),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="isrbd"):
        ALDDP(prob.ocp)
