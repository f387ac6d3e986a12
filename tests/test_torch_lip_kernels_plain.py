"""PyTorch port, the plain twins of the LIP kernels against the JAX package,
on the CPU in float64 at ns = 20, B = 3 (random plans, references, 0/1
switches and 0/1 tracking masks on every node):

  - K10 `lip_linearize_plain` against the JAX package's dense
    `MSDDP._linearize` (the JAX LIP problem declares no rows, so JAX forms
    A, B, Jx and Ju whole): Sx, Bs, Jxp and Jup against A − I, B, Jx and Ju
    sliced by the declared rows, ρ, d, rt and Jt, to 1e-12 relative, and
    every dense row outside the declared sets exactly zero;
  - K1's twin at the LIP rows, collapsed against JAX's dense
    `_backward_lanemajor` and Tassa (block-Schur and Cholesky gain solve)
    against JAX's `_backward`, on the same linearization, to 1e-9
    relative;
  - K11's twin, the whole fused trial `lip_trial_plain` (rollout, cost,
    Armijo test), against `_rollout`, `total_cost` and the
    Armijo test of the JAX package's line search for 1 and 4 step sizes,
    to 1e-12, with a member whose merit is not finite and one whose D is
    −inf;
  - `lip_evaluate_plain` against `jax.vmap(total_cost)`, the largest |·|
    of `jax.vmap(_true_defects)` and the pin X.at[:, 0].set(x0), with a
    member whose plan holds a NaN, to 1e-12;
  - each wrapper taking its plain twin for CPU tensors, launching nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jit, max_rel_err, np_of, to_jax, to_torch
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet as j_feet
from srbd_horizon_tpu.problems.lip import build_lip_problem as j_build
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet as t_feet
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem as t_build
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

F64 = torch.float64
B = 3
MU = 1e-6
ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
OUTS = ("ks", "Ks", "dV1", "dV2")
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])
OPTS = dict(alpha_converge_threshold=1e-12, beta=1e-3)


def _plans(jp, seed):
    """Numpy X, U near the initial state and static input, x0, and fleet
    params with random references, switches and masks."""
    rng = np.random.RandomState(seed)
    ns, nc = jp.ocp.ns, jp.nc
    x0 = np.asarray(jp.initial_state)
    u0 = np.asarray(jp.static_input)
    X = x0[None, None] + 0.03 * rng.randn(B, ns + 1, x0.shape[0])
    U = u0[None, None] + 0.1 * rng.randn(B, ns, u0.shape[0])
    p = dict(
        rdot_ref=0.3 * rng.randn(B, ns + 1, 3),
        c_ref=0.05 * np.abs(rng.randn(B, ns + 1, nc)),
        cdot_switch=rng.randint(0, 2, (B, ns + 1, nc)).astype(np.float64),
        mask_track=rng.randint(0, 2, (B, ns + 1, 1)).astype(np.float64),
    )
    xs = X[:, 0] + 0.01 * rng.randn(B, x0.shape[0])
    return X, U, p, xs


@pytest.fixture(scope="module")
def case():
    jp = j_build(JSRBDConfig(dtype=jnp.float64), j_feet())
    tp = t_build(SRBDConfig(dtype=F64), t_feet(), device="cpu")
    js = JMSDDP(jp.ocp, JDDPOptions(**OPTS))
    ts = MSDDP(tp.ocp, DDPOptions(**OPTS))
    X, U, params, x0 = _plans(jp, seed=21)
    jlin = jit(jax.vmap(js._linearize))(*to_jax((X, U, params)))
    tlin = k10.lip_linearize_plain(to_torch(X), to_torch(U), to_torch(params),
                                   ts.terms, ts.rows, tp.ocp.dt, ts._wc(F64))
    return dict(jp=jp, tp=tp, js=js, ts=ts, X=X, U=U, params=params, x0=x0,
                jlin=jlin, tlin=tlin)


def _dense(case, name):
    """The JAX dense block a port block slices, and the row set."""
    rows, jl = case["ts"].rows, case["jlin"]
    nx = case["jp"].ocp.nx
    return {"Sx": (np.asarray(jl["A"]) - np.eye(nx), rows.rx),
            "Bs": (np.asarray(jl["B"]), rows.ru),
            "Jxp": (np.asarray(jl["Jx"]), rows.gx),
            "Jup": (np.asarray(jl["Ju"]), rows.gu)}[name]


@pytest.mark.parametrize("out", ORDER)
def test_linearize_twin_matches_jax_dense(case, out):
    got = case["tlin"][out]
    if out in ("Sx", "Bs", "Jxp", "Jup"):
        dense, rows = _dense(case, out)
        want = dense[..., list(rows), :]
    else:
        want = np.asarray(case["jlin"][out])
    assert tuple(got.shape) == want.shape
    assert max_rel_err(got, want) < 1e-12


@pytest.mark.parametrize("out", ["Sx", "Bs", "Jxp", "Jup"])
def test_dense_rows_outside_the_declared_sets_are_zero(case, out):
    dense, rows = _dense(case, out)
    dead = [r for r in range(dense.shape[-2]) if r not in rows]
    assert np.all(dense[..., dead, :] == 0.0)


def test_linearize_wrapper_takes_plain_path_on_cpu(case):
    ts, tp = case["ts"], case["tp"]
    before = k10.lip_linearize.launches
    args = (to_torch(case["X"]), to_torch(case["U"]), to_torch(case["params"]),
            ts.terms, ts.rows, tp.ocp.dt, ts._wc(F64))
    got = k10.lip_linearize(*args)
    for k in ORDER:
        assert torch.equal(got[k], case["tlin"][k])
    assert k10.lip_linearize.launches == before


# ---------------- K1 at the LIP rows ----------------

@pytest.fixture(scope="module")
def sweeps(case):
    """JAX's dense sweeps on the JAX linearization: the batched collapsed
    `_backward_lanemajor`, and the unbatched Tassa `_backward` member by
    member with each gain solve."""
    js, jlin = case["js"], case["jlin"]
    out = {"collapsed": jit(js._backward_lanemajor)(jlin, jnp.asarray(MU))}
    for solver in ("schur", "cholesky"):
        jm = dataclasses.replace(js, opts=dataclasses.replace(js.opts,
                                                              quu_solver=solver))
        back = jit(jm._backward)
        per = [back({k: v[b] for k, v in jlin.items()}, jnp.asarray(MU))
               for b in range(B)]
        out[solver] = tuple(np.stack([np.asarray(p[i]) for p in per])
                            for i in range(4))
    return out


@pytest.mark.parametrize("form,solver", [("collapsed", "schur"),
                                         ("tassa", "schur"),
                                         ("tassa", "cholesky")])
def test_riccati_twin_matches_jax_dense_sweep(case, sweeps, form, solver):
    got = k1.riccati_backward_plain(*(case["tlin"][k] for k in ORDER), MU,
                                    case["ts"].rows, form=form,
                                    quu_solver=solver)
    want = sweeps["collapsed" if form == "collapsed" else solver]
    for name, g, w in zip(OUTS, got, want):
        assert tuple(g.shape) == np.shape(w), name
        assert bool(torch.isfinite(g).all())
        assert max_rel_err(g, w) < 1e-9, name


def test_riccati_wrapper_takes_plain_path_on_cpu(case):
    args = tuple(case["tlin"][k] for k in ORDER) + (MU, case["ts"].rows)
    before = k1.riccati_backward.launches
    for form, solver in (("collapsed", "schur"), ("tassa", "cholesky")):
        got = k1.riccati_backward(*args, form=form, quu_solver=solver)
        want = k1.riccati_backward_plain(*args, form=form, quu_solver=solver)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert k1.riccati_backward.launches == before


# ---------------- K11, the trial ----------------

@pytest.fixture(scope="module")
def trials(case, sweeps):
    """The trial for 1 and 4 step sizes, in both packages, on the case's
    plans, the collapsed gains and the defects. Member 1 starts from a NaN
    state (NaN cost and merit); member 2 has D = −inf, so its merit is −inf
    for α < 1 and only the finiteness test rejects it."""
    js, ts = case["js"], case["ts"]
    opts = js.opts
    ks, Ks, dV1, dV2 = sweeps["collapsed"]
    d = case["jlin"]["d"]
    X, U, params = to_jax((case["X"], case["U"], case["params"]))
    x0 = np.array(case["x0"])
    x0[1] = np.nan
    x0 = to_jax(x0)
    nu_w = jnp.asarray(opts.defect_weight, jnp.float64)
    D = jnp.sum(d * d, axis=(1, 2)).at[2].set(-jnp.inf)
    cost0 = jit(jax.vmap(js.total_cost))(X, U, params)
    merit0 = (cost0 + nu_w * D).at[2].set(cost0[2])

    def one(a):     # the Armijo test of the line search (msddp.py:1494-1578)
        Xn, Un = jax.vmap(
            lambda x0_, X_, U_, k_, K_, d_, p_: js._rollout(
                x0_, X_, U_, k_, K_, d_, p_, a)
        )(x0, X, U, ks, Ks, d, params)
        new_cost = jax.vmap(js.total_cost)(Xn, Un, params)
        new_merit = new_cost + nu_w * (1.0 - a) ** 2 * D
        expected = -(a * dV1 + a**2 * dV2) + (2.0 * a - a**2) * nu_w * D
        ok = (
            ((merit0 - new_merit) >= opts.beta * jnp.maximum(expected, 1e-16))
            & jnp.isfinite(new_merit)
            & (a >= opts.alpha_converge_threshold)
        )
        return Xn, Un, new_cost, new_merit, ok

    t = lambda a: to_torch(np_of(a))
    out = {}
    for nA in (1, 4):
        want = jit(jax.vmap(one))(jnp.asarray(ALPHAS[:nA]))
        args = (t(x0), to_torch(case["X"]), to_torch(case["U"]), t(ks), t(Ks),
                case["tlin"]["d"], to_torch(ALPHAS[:nA]),
                to_torch(case["params"]), t(merit0), t(D), t(dV1), t(dV2),
                ts.terms, ts.ocp.dt, ts._wc(F64), opts.defect_weight,
                opts.beta, opts.alpha_converge_threshold)
        out[nA] = (args, want)
    return out


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("out", range(5), ids=["Xn", "Un", "cost", "merit", "ok"])
def test_trial_twin_matches_jax(trials, nA, out):
    args, want = trials[nA]
    got = k11.lip_trial_plain(*args)[out]
    assert tuple(got.shape) == tuple(want[out].shape)
    if out == 4:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[out]))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want[out]),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nA", [1, 4])
def test_trial_rejects_non_finite_merit(trials, nA):
    args, _ = trials[nA]
    _, _, cost, merit, ok = k11.lip_trial_plain(*args)
    assert bool(torch.isnan(cost[:, 1]).all()) and not bool(ok[:, 1].any())
    assert not bool(ok[:, 2].any())
    assert bool(torch.isfinite(merit[:, 0]).all())
    if nA == 4:     # α < 1: merit −inf passes the decrease test alone
        assert bool(torch.isneginf(merit[1:, 2]).all())


def test_trial_wrapper_takes_plain_path_on_cpu(trials):
    args, _ = trials[4]
    before = k11.lip_trial.launches
    for g, w in zip(k11.lip_trial(*args), k11.lip_trial_plain(*args)):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    assert k11.lip_trial.launches == before


# ---------------- lip_evaluate ----------------

@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
def test_evaluate_twin_matches_jax(case, pin):
    """Member 1's plan holds a NaN: its cost and defect are NaN in both."""
    js, ts = case["js"], case["ts"]
    X = np.array(case["X"])
    X[1, 7, 4] = np.nan
    jX, jU, jpar, jx0 = to_jax((X, case["U"], case["params"], case["x0"]))
    if pin:
        jX = jX.at[:, 0].set(jx0)
    cost = jax.vmap(js.total_cost)(jX, jU, jpar)
    dmax = jnp.max(jnp.abs(jax.vmap(js._true_defects)(jX, jU, jpar)), axis=(1, 2))
    got = k11.lip_evaluate_plain(to_torch(X), to_torch(case["U"]),
                                 to_torch(case["params"]), ts.terms,
                                 ts.ocp.dt, ts._wc(F64),
                                 x0=to_torch(case["x0"]) if pin else None)
    assert len(got) == (3 if pin else 2)
    for g, w in zip(got[:2], (cost, dmax)):
        w = np.asarray(w)
        assert np.array_equal(np.isnan(g.numpy()), np.isnan(w))
        assert np.isnan(w[1]) and not np.isnan(w[[0, 2]]).any()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
    if pin:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jX))


def test_evaluate_wrapper_takes_plain_path_on_cpu(case):
    ts = case["ts"]
    args = (to_torch(case["X"]), to_torch(case["U"]), to_torch(case["params"]),
            ts.terms, ts.ocp.dt, ts._wc(F64))
    before = k11.lip_evaluate.launches
    x0 = to_torch(case["x0"])
    for g, w in zip(k11.lip_evaluate(*args, x0=x0),
                    k11.lip_evaluate_plain(*args, x0=x0)):
        assert torch.equal(g, w)
    assert k11.lip_evaluate.launches == before
