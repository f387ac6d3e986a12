"""PyTorch port, the constrained (isrbd) problem on the point-feet quadruped
against the JAX package, in float64 on the CPU.

The problem is built as the JAX package's constrained example builds it
(`build_isrbd_problem(SRBDConfig(contact_model=1, number_of_legs=4,
lip_height=com_z), quadruped_point_feet())`). These tests hold:

  - its AL inner sizes against the table the kernels are compiled for
    (`isrbd_linearize.KERNEL_SHAPES["quadruped"]`: 236 stage rows, 97
    terminal rows, 17 + 8 equality rows, a 349-value parameter row; K1's
    56 rows touching x) and against JAX's;
  - the stage and terminal callables (residual, equality and inequality
    rows, the RK2 step) at seeded random (x, u, p) to 1e-12, and the
    builder's refusal of a LIP height that is not the robot's CoM height;
  - the plain twins of K5, K1, K6, isrbd_evaluate, K7 and K8a-c on the AL
    inner problem at B=4 against JAX's functions: K5 to 1e-9 (rtol, atol
    1e-11 of the largest entry), K1 to 1e-8 (two float64 sweeps that sum
    in different orders part by ~2e-9 under this point's Quu), K6 and
    isrbd_evaluate to 1e-11, K7 to 1e-12 of max(1, |JAX|), K8 bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu.solvers.alddp import FullPhasePrior as JFullPrior
from srbd_horizon_tpu.solvers.alddp import PhasePrior as JTailPrior
from srbd_horizon_tpu_torch.config import SRBDConfig
from srbd_horizon_tpu_torch.convert import phase_prior_from_numpy
from srbd_horizon_tpu_torch.kernels import isrbd_al as k78
from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
from srbd_horizon_tpu_torch.kernels import isrbd_rollout as k6
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels.riccati import RiccatiRows
from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem

from _torch_parity import (
    F64, QUAD_TOPOLOGY, al_state_numpy, fleet_params, jax_al_state, jit,
    max_rel_err, np_of, quadruped_al_solvers, quadruped_isrbd_problems,
    random_al_state, random_xup, tight_box_params, to_jax, to_torch,
    torch_al_state,
)

torch.set_num_threads(1)

B = 4
P = 20
NAN_MEMBER = 2
MU = 1e-6
ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])


@pytest.fixture(scope="module")
def case():
    jp, tp = quadruped_isrbd_problems()
    js, ts = quadruped_al_solvers(jp, tp, max_iters=1)
    st = random_al_state(jp.ocp, B, 51, *ts._sizes)
    nan_st = copy.deepcopy(st)
    nan_st["sol"]["U"][NAN_MEMBER, 3, 0] = np.nan      # r̈ₓ at node 3
    return dict(jp=jp, tp=tp, js=js, ts=ts, st=st, nan_st=nan_st,
                boxes=tight_box_params(jp, B, 52),
                static=fleet_params(jp.ocp.params, B))


def _close(got, want, rtol=1e-12, atol=1e-13):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol)


def _al_close(got, want, tol=1e-12):
    """Each entry within tol·max(1, |want|); NaNs where JAX has them."""
    g, w = np_of(got), np.asarray(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    err = np.abs(g[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))
    assert err.size == 0 or float(err.max()) <= tol, float(err.max())


# ---------------- the problem ----------------

def test_inner_sizes_are_the_compiled_quadruped_shape(case):
    """The sizes of the quadruped's AL inner problem, in both packages, are
    `KERNEL_SHAPES["quadruped"]` (csrc/isrbd_common.cuh's QuadAlShape) and
    K1's `isrbd_al_quadruped` shape."""
    js, ts, ocp = case["js"], case["ts"], case["tp"].ocp
    rows = ts.inner.rows
    assert RiccatiRows.from_ocp(ts.inner.ocp) == rows
    sizes = k5.kernel_sizes(ts.terms, ocp.nx, ocp.nu, rows)
    assert sizes == k5.KERNEL_SHAPES["quadruped"]
    assert sizes["n_rho"] - sizes["n_term"] == 236 - 97
    assert ts._sizes == tuple(int(n) for n in js._probe_sizes()) == (17, 8, 20)
    jin = js._inner.ocp
    assert tuple(rows.gx) == tuple(int(r) for r in jin.residual_x_rows)
    assert tuple(rows.gu) == tuple(int(r) for r in jin.residual_u_rows)
    assert rows.uc == tuple(sorted(int(c) for c in jin.dynamics_u_cols))
    assert k5.check_kernel_shape("isrbd_linearize", ts.terms, ocp.nx, ocp.nu,
                                 rows) == "quadruped"
    k1_sizes = k1.kernel_sizes(ocp.nx, ocp.nu, ts.terms.n_term, rows)
    assert k1_sizes == k1.KERNEL_SHAPES["isrbd_al_quadruped"]
    assert k1.kernel_shape(ocp.nx, ocp.nu, ts.terms.n_term,
                           rows) == "isrbd_al_quadruped"


def test_foot_pairs_match_jax(case):
    """The foot-pair rows take the cm-generic pairs; at cm=1 the indices
    are (0, 1, 2, 3), and the four rows JAX's stage residual carries there
    (rows 29-32: y and x of pairs 0-2 and 1-3) are those pairs' offsets
    from the feet's start, weighted by w_rel."""
    to = case["ts"].terms.outer
    assert tuple(to.fpi) == (0, 1, 2, 3)
    jocp = case["jp"].ocp
    x, u, p = random_xup(jocp.params, jocp.nx, jocp.nu, seed=59, lead=(3,))
    rows = np.asarray(jax.vmap(jocp.stage_residual)(*to_jax((x, u, p))))[:, 29:33]
    c = x[:, 7:19].reshape(3, 4, 3)
    (d1x, d1y), (d2x, d2y) = to.d1, to.d2
    want = to.w_rel * np.stack([c[:, 2, 1] - c[:, 0, 1] - d1y,
                                c[:, 2, 0] - c[:, 0, 0] - d1x,
                                c[:, 3, 1] - c[:, 1, 1] - d2y,
                                c[:, 3, 0] - c[:, 1, 0] - d2x], axis=-1)
    np.testing.assert_allclose(rows, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", ["stage_residual", "stage_eq", "stage_ineq",
                                "step", "xdot"])
def test_stage_callables_match_jax(case, fn):
    jocp, tocp = case["jp"].ocp, case["tp"].ocp
    x, u, p = random_xup(jocp.params, jocp.nx, jocp.nu, seed=53, lead=(5,))
    for k in ("mask_track", "mask_srbd", "mask_lip", "mask_lipzone"):
        p[k] = np.round(np.clip(p[k], 0, 1))
    u[:, 9:12] += [10.0, -20.0, 90.0]
    extra = (jocp.dt,) if fn == "step" else ()
    want = jax.vmap(lambda x_, u_, p_: getattr(jocp, fn)(x_, u_, p_, *extra))(
        *to_jax((x, u, p)))
    got = getattr(tocp, fn)(to_torch(x), to_torch(u), to_torch(p), *extra)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("fn", ["terminal_residual", "terminal_eq"])
def test_terminal_callables_match_jax(case, fn):
    jocp, tocp = case["jp"].ocp, case["tp"].ocp
    x, _, p = random_xup(jocp.params, jocp.nx, jocp.nu, seed=54, lead=(5,))
    want = jax.vmap(getattr(jocp, fn))(*to_jax((x, p)))
    got = getattr(tocp, fn)(to_torch(x), to_torch(p))
    assert got.shape == want.shape
    _close(got, want)


def test_inner_stacks_match_jax(case):
    """The AL inner stage (236 rows) and terminal (97 rows) stacks at a
    random AL state with tight boxes, some one-sided rows active."""
    js, ts, jp = case["js"], case["ts"], case["jp"]
    st, params = case["st"], case["boxes"]
    ns = jp.ocp.ns
    jpin = jax.vmap(js._params_with_multipliers)(to_jax(params), jax_al_state(st))
    tpin = ts._params_with_multipliers(to_torch(params), torch_al_state(st))
    X, U = st["sol"]["X"], st["sol"]["U"]
    jin = js._inner.ocp
    want = jax.vmap(jax.vmap(jin.stage_residual))(
        jnp.asarray(X[:, :ns]), jnp.asarray(U), {k: v[:, :ns] for k, v in jpin.items()})
    got = ts.terms.stage_residual(to_torch(X[:, :ns]), to_torch(U),
                                  {k: v[:, :ns] for k, v in tpin.items()})
    assert got.shape[-1] == 236
    _close(got, want, atol=1e-9)
    act = np_of(got)[..., 62:] > 0
    assert 0.05 < act.mean() < 0.9
    want = jax.vmap(jin.terminal_residual)(
        jnp.asarray(X[:, ns]), {k: v[:, ns] for k, v in jpin.items()})
    got = ts.terms.terminal_residual(to_torch(X[:, ns]),
                                     {k: v[:, ns] for k, v in tpin.items()})
    assert got.shape[-1] == 97
    _close(got, want, atol=1e-9)


def test_lip_height_mismatch_is_refused():
    """The hybrid stack's LIP height must be the robot's CoM height; the
    biped default is refused, as tests/test_quadruped.py checks in JAX."""
    with pytest.raises(ValueError, match="lip_height"):
        build_isrbd_problem(SRBDConfig(dtype=F64, **QUAD_TOPOLOGY),
                            quadruped_point_feet(), device="cpu")


# ---------------- the kernels' plain twins ----------------

@pytest.fixture(scope="module")
def lin(case):
    """K5's twin and JAX's `_linearize_sliced` on the inner problem at the
    random AL state, and JAX's backward sweep on JAX's linearization."""
    js, ts, tp = case["js"], case["ts"], case["tp"]
    st, params = case["st"], case["boxes"]
    jpin = jax.vmap(js._params_with_multipliers)(to_jax(params), jax_al_state(st))
    tpin = ts._params_with_multipliers(to_torch(params), torch_al_state(st))
    X, U = st["sol"]["X"], st["sol"]["U"]
    jin = js._inner
    jlin = jit(jax.vmap(jin._linearize_sliced))(jnp.asarray(X), jnp.asarray(U), jpin)
    jback = jit(jin._backward_lanemajor)(jlin, jnp.asarray(MU))
    tlin = k5.isrbd_linearize_plain(to_torch(X), to_torch(U), tpin, ts.terms,
                                    ts.inner.rows, tp.ocp.dt)
    return dict(jpin=jpin, tpin=tpin, jlin=jlin, tlin=tlin, jback=jback)


@pytest.mark.parametrize("out", ORDER)
def test_k5_plain_matches_jax(lin, out):
    got, want = np_of(lin["tlin"][out]), np.asarray(lin["jlin"][out])
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11 * max(scale, 1.0))


def test_k1_plain_matches_jax(case, lin):
    tl = {k: to_torch(np_of(v)) for k, v in lin["jlin"].items()}
    got = k1.riccati_backward_plain(*(tl[k] for k in ORDER), MU, case["ts"].inner.rows)
    for g, w in zip(got, lin["jback"]):
        assert max_rel_err(g, w) < 1e-8


@pytest.mark.parametrize("nA", [1, 4])
def test_k6_plain_matches_jax(case, lin, nA):
    """The trial (rollout, cost, merit, Armijo flag) for 1 and 4 step sizes;
    member 1 starts from a NaN state and is rejected."""
    js, ts = case["js"], case["ts"]
    jin = js._inner
    opts = jin.opts
    ks, Ks, dV1, dV2 = lin["jback"]
    d = lin["jlin"]["d"]
    X, U = jnp.asarray(case["st"]["sol"]["X"]), jnp.asarray(case["st"]["sol"]["U"])
    params = lin["jpin"]
    x0 = np.array(case["st"]["sol"]["X"][:, 0]) + 0.01 * np.random.RandomState(55).randn(
        B, X.shape[-1])
    x0[1] = np.nan
    x0 = jnp.asarray(x0)
    nu_w = jnp.asarray(opts.defect_weight, jnp.float64)
    D = jnp.sum(d * d, axis=(1, 2))
    merit0 = jit(jax.vmap(jin.total_cost))(X, U, params) + nu_w * D

    def one(a):     # msddp.py:843-853
        Xn, Un = jax.vmap(lambda x0_, X_, U_, k_, K_, d_, p_: jin._rollout(
            x0_, X_, U_, k_, K_, d_, p_, a))(x0, X, U, ks, Ks, d, params)
        cost = jax.vmap(jin.total_cost)(Xn, Un, params)
        merit = cost + nu_w * (1.0 - a) ** 2 * D
        expected = -(a * dV1 + a**2 * dV2) + (2.0 * a - a**2) * nu_w * D
        ok = (((merit0 - merit) >= opts.beta * jnp.maximum(expected, 1e-16))
              & jnp.isfinite(merit) & (a >= opts.alpha_converge_threshold))
        return Xn, Un, cost, merit, ok

    want = jit(jax.vmap(one))(jnp.asarray(ALPHAS[:nA]))
    t = lambda a: to_torch(np_of(a))
    got = k6.isrbd_trial_plain(
        t(x0), t(X), t(U), t(ks), t(Ks), t(d), to_torch(ALPHAS[:nA]),
        lin["tpin"], t(merit0), t(D), t(dV1), t(dV2), ts.terms,
        case["tp"].ocp.dt, opts.defect_weight, opts.beta,
        opts.alpha_converge_threshold)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert not got[4][:, 1].any()
    for g, w in zip(got[:4], want[:4]):
        gn, wn = np_of(g), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(gn), np.isnan(wn))
        fin = np.isfinite(wn)
        assert max_rel_err(gn[fin], wn[fin]) < 1e-11


def test_isrbd_evaluate_plain_matches_jax(case, lin):
    """The plan's cost and largest |defect| (JAX: vmap of total_cost and
    _true_defects), member NAN_MEMBER with a NaN r̈ₓ, with and without the
    node-0 pin."""
    js, ts = case["js"], case["ts"]
    jin = js._inner
    X, U = np.array(case["st"]["sol"]["X"]), np.array(case["nan_st"]["sol"]["U"])
    x0 = X[:, 0] + 0.01 * np.random.RandomState(56).randn(B, X.shape[-1])
    for pin in (None, x0):
        Xj = X if pin is None else np.concatenate([pin[:, None], X[:, 1:]], axis=1)
        cost = jax.vmap(jin.total_cost)(jnp.asarray(Xj), jnp.asarray(U), lin["jpin"])
        defects = jax.vmap(jin._true_defects)(jnp.asarray(Xj), jnp.asarray(U), lin["jpin"])
        want = (cost, jnp.max(jnp.abs(defects), axis=(1, 2)))
        got = k6.isrbd_evaluate_plain(
            to_torch(X), to_torch(U), lin["tpin"], ts.terms, case["tp"].ocp.dt,
            x0=None if pin is None else to_torch(pin))
        for g, w in zip(got[:2], want):
            np.testing.assert_allclose(np_of(g), np.asarray(w), rtol=1e-11, atol=1e-12)
            assert np.isnan(np_of(g)[NAN_MEMBER])
        if pin is not None:
            np.testing.assert_array_equal(np_of(got[2]), Xj)


def _jax_constraints(js, st, params):
    return jax.vmap(js._constraints)(jnp.asarray(st["sol"]["X"]),
                                     jnp.asarray(st["sol"]["U"]), to_jax(params))


@pytest.mark.parametrize("mode", ["eval", "online", "offline"])
@pytest.mark.parametrize("which", ["st", "nan_st"])
def test_k7_plain_matches_jax(case, mode, which):
    """K7's twin: h, hT, g and viol (eval), the online equality update, and
    the offline update of the eight multipliers with the penalty schedule
    on a later outer (viol_prev on either side of the contraction test)."""
    js, ts, params = case["js"], case["ts"], case["boxes"]
    st = copy.deepcopy(case[which])
    st["viol"] = np.array([1e-9, 5.0, 0.3, 1e5])
    jst = jax_al_state(st)
    X, U = jnp.asarray(st["sol"]["X"]), jnp.asarray(st["sol"]["U"])
    h, hT, g, viol = _jax_constraints(js, st, params)
    if mode == "eval":
        want = (h, hT, g, viol)
    elif mode == "online":
        r2 = jst.rho[:, None]
        w = js._w_eq if js._w_eq is not None else 1.0
        w_T = js._w_eq_T if js._w_eq_T is not None else 1.0
        want = (jst.lam_eq + r2[..., None] * w * h, jst.lam_eq_T + r2 * w_T * hT, viol)
    else:
        o = js.al_opts
        mults = js._updated_multipliers(jst, X, U, h, hT, g, to_jax(params), jst.rho)
        grow = (viol > o.viol_decrease * jst.viol) & (viol > o.tol)
        rho = jnp.where(grow, jnp.minimum(jst.rho * o.rho_growth, o.rho_max), jst.rho)
        want = tuple(mults) + (rho, viol)
    kw = {} if mode == "eval" else dict(st=torch_al_state(st), offline=mode == "offline")
    got = k78.isrbd_al_constraints(ts, to_torch(st["sol"]["X"]),
                                   to_torch(st["sol"]["U"]), to_torch(params), **kw)
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        _al_close(gt, wt)
    if which == "nan_st":
        assert np.isnan(np_of(got[-1])[NAN_MEMBER])


def _priors(ts, seed, ns):
    rng = np.random.RandomState(seed)
    n_eq, n_eq_T, _ = ts._sizes
    full = dict(lam_eq=rng.randn(B, P, ns, n_eq), lam_eq_T=rng.randn(B, P, n_eq_T),
                seen=rng.rand(B, P) < 0.5)
    tail = dict(lam_tail=rng.randn(B, P, n_eq), lam_T=rng.randn(B, P, n_eq_T),
                seen_tail=rng.rand(B, P) < 0.5, seen_T=rng.rand(B, P) < 0.5)
    return dict(full=full, tail=tail), np.array([0, 7, 19, 3], np.int32)


def _pair(kind, fields):
    jcls = JFullPrior if kind == "full" else JTailPrior
    return (jcls(**{k: jnp.asarray(v) for k, v in fields.items()}),
            phase_prior_from_numpy(fields, device="cpu", dtype=F64))


@pytest.mark.parametrize("kind", ["none", "tail", "full"])
def test_k8a_plain_matches_jax_bit_for_bit(case, kind):
    js, ts = case["js"], case["ts"]
    priors, phase = _priors(ts, 57, case["jp"].ocp.ns)
    st = case["nan_st"]
    jst = jax.vmap(js.shift_warmstart)(jax_al_state(st))
    tst = torch_al_state(st)
    if kind == "none":
        got = k78.isrbd_al_shift_plain(ts, tst)
    else:
        jprior, tprior = _pair(kind, priors[kind])
        seed = js._seed_full_prior if kind == "full" else js._seed_from_prior
        jst = jax.vmap(seed)(jst, jprior, jnp.asarray(phase))
        got = k78.isrbd_al_shift_plain(ts, tst, tprior, torch.as_tensor(phase))
    want, got = al_state_numpy(jst), al_state_numpy(got)
    for k in k78.MULTIPLIERS + ("rho", "viol"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("X", "U"):
        np.testing.assert_array_equal(got["sol"][k], want["sol"][k])


@pytest.mark.parametrize("bounds", ["static", "boxes"])
def test_k8b_plain_matches_jax_bit_for_bit(case, bounds):
    js, ts = case["js"], case["ts"]
    params = dict(case[bounds])
    st = case["nan_st"]
    want = jax.vmap(js._params_with_multipliers)(to_jax(params), jax_al_state(st))
    got = k78.isrbd_al_params_plain(ts, to_torch(params), torch_al_state(st))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np_of(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("ema", [0.5, 1.0])
@pytest.mark.parametrize("kind", ["tail", "full"])
def test_k8c_plain_matches_jax(case, kind, ema):
    js, ts = case["js"], case["ts"]
    priors, phase = _priors(ts, 58, case["jp"].ocp.ns)
    jprior, tprior = _pair(kind, priors[kind])
    upd = js._update_full_prior if kind == "full" else js._update_prior
    jst, tst = jax_al_state(case["st"]), torch_al_state(case["st"])
    want = jax.vmap(upd, in_axes=(0, 0, 0, None))(jprior, jst, jnp.asarray(phase), ema)
    got = k78.isrbd_al_prior_update_plain(ts, tprior, tst, torch.as_tensor(phase), ema)
    for k in priors[kind]:
        g, w = np_of(getattr(got, k)), np.asarray(getattr(want, k))
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            _al_close(g, w)
