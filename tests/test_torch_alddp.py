"""PyTorch port, the AL layer and the constrained path as a whole against
the JAX package in float64 on the CPU.

The AL layer's pieces (`_constraints`, `_updated_multipliers`,
`shift_warmstart`, both gait-phase priors' seed and update) take the same
numpy state in both packages: exact, or 1e-12 where arithmetic is
involved. The path: from one JAX-side offline seed carried across as
numpy, WPG-advanced `serving_tick_batch` ticks with a `FullPhasePrior`
(1 outer × 1 inner iteration, cz stiffness 3200) in both packages —
iterations and convergence flags equal, X, U, λ and viol to 1e-7
relative; the offline `solve_batch` likewise; and the JAX batched path
gives the same result whatever `quu_solver` says, which is why the port
runs the block-Schur inverse of K1 for the AL solver too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu.solvers.alddp import FullPhasePrior as JFullPrior
from srbd_horizon_tpu.solvers.alddp import PhasePrior as JTailPrior
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch.convert import phase_prior_from_numpy
from srbd_horizon_tpu_torch.runtime.chunked import chunk_map
from srbd_horizon_tpu_torch.runtime.serving import constrained_tick
from srbd_horizon_tpu_torch.solvers import options as toptions
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

from _torch_parity import (
    F64, al_solvers, al_state_numpy, fleet_params, isrbd_problems,
    jax_al_state, jit, max_rel_err, np_of, perturbed_states, random_al_state,
    tight_box_params, to_jax, to_torch, torch_al_state,
)

torch.set_num_threads(1)

B = 4
NS = 8          # a short horizon keeps the JAX compiles and solves small
P = 20          # gait period in nodes
AL_FIELDS = ("lam_eq", "lam_eq_T", "mu_ub", "mu_lb", "mu_x_ub", "mu_x_lb",
             "mu_u_ub", "mu_u_lb")


@pytest.fixture(scope="module")
def case():
    jp, tp = isrbd_problems(ns=NS, cz_rho_weight=3200.0)
    js, ts = al_solvers(jp, tp, max_iters=3)
    st = random_al_state(jp.ocp, B, 31, *ts._sizes)
    params = tight_box_params(jp, B, 32)
    return dict(jp=jp, tp=tp, js=js, ts=ts, st=st, params=params)


def _close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol)


def test_constraints_match_jax(case):
    js, ts, st = case["js"], case["ts"], case["st"]
    X, U = st["sol"]["X"], st["sol"]["U"]
    want = jax.vmap(js._constraints)(jnp.asarray(X), jnp.asarray(U),
                                     to_jax(case["params"]))
    got = ts._constraints(to_torch(X), to_torch(U), to_torch(case["params"]))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)
    assert float(got[3].min()) > 0


def test_updated_multipliers_match_jax(case):
    js, ts, st = case["js"], case["ts"], case["st"]
    X, U = st["sol"]["X"], st["sol"]["U"]
    jparams, tparams = to_jax(case["params"]), to_torch(case["params"])
    jh, jhT, jg, _ = jax.vmap(js._constraints)(jnp.asarray(X), jnp.asarray(U),
                                               jparams)
    jst = jax_al_state(st)
    want = js._updated_multipliers(jst, jnp.asarray(X), jnp.asarray(U), jh,
                                   jhT, jg, jparams, jst.rho)
    tst = torch_al_state(st)
    t = lambda a: to_torch(np_of(a))
    got = ts._updated_multipliers(tst, to_torch(X), to_torch(U), t(jh),
                                  t(jhT), t(jg), tparams, tst.rho)
    for name, g, w in zip(AL_FIELDS, got, want):
        _close(g, w, rtol=1e-12, atol=1e-9)
        if name.startswith("mu"):
            assert float(g.min()) >= 0
    # dead sides stay zero: cones have no lower bound, unbounded dims no box
    assert float(got[3].abs().max()) == 0
    assert float(got[4][..., :19].abs().max()) == 0


def test_shift_warmstart_matches_jax(case):
    js, ts, st = case["js"], case["ts"], case["st"]
    want = al_state_numpy(jax.vmap(js.shift_warmstart)(jax_al_state(st)))
    got = al_state_numpy(ts.shift_warmstart(torch_al_state(st)))
    for k in AL_FIELDS + ("rho", "viol"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("X", "U"):
        np.testing.assert_array_equal(got["sol"][k], want["sol"][k])


def _random_priors(ts, seed):
    rng = np.random.RandomState(seed)
    n_eq, n_eq_T, _ = ts._sizes
    full = dict(lam_eq=rng.randn(B, P, NS, n_eq), lam_eq_T=rng.randn(B, P, n_eq_T),
                seen=rng.rand(B, P) < 0.5)
    tail = dict(lam_tail=rng.randn(B, P, n_eq), lam_T=rng.randn(B, P, n_eq_T),
                seen_tail=rng.rand(B, P) < 0.5, seen_T=rng.rand(B, P) < 0.5)
    phase = np.array([0, 7, 19, 3], np.int32)
    return full, tail, phase


@pytest.mark.parametrize("kind", ["full", "tail"])
def test_prior_seed_and_update_match_jax(case, kind):
    js, ts, st = case["js"], case["ts"], case["st"]
    full, tail, phase = _random_priors(ts, 33)
    fields = full if kind == "full" else tail
    jcls = JFullPrior if kind == "full" else JTailPrior
    jprior = jcls(**{k: jnp.asarray(v) for k, v in fields.items()})
    tprior = phase_prior_from_numpy(fields, device="cpu", dtype=F64)
    jseed, jupd = ((js._seed_full_prior, js._update_full_prior) if kind == "full"
                   else (js._seed_from_prior, js._update_prior))
    tseed, tupd = ((ts._seed_full_prior, ts._update_full_prior) if kind == "full"
                   else (ts._seed_from_prior, ts._update_prior))
    jst = jax_al_state(st)
    tst = torch_al_state(st)
    tphase = torch.as_tensor(phase)
    want = al_state_numpy(jax.vmap(jseed)(jst, jprior, jnp.asarray(phase)))
    got = al_state_numpy(tseed(tst, tprior, tphase))
    for k in ("lam_eq", "lam_eq_T"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jnew = jax.vmap(jupd, in_axes=(0, 0, 0, None))(jprior, jst,
                                                   jnp.asarray(phase), 0.5)
    tnew = tupd(tprior, tst, tphase, 0.5)
    assert type(tnew).__name__ == type(jnew).__name__
    for k in fields:
        _close(getattr(tnew, k), getattr(jnew, k), rtol=1e-12, atol=1e-14)
    # the input tables are left as they were
    for k in fields:
        np.testing.assert_array_equal(np_of(getattr(tprior, k)), fields[k])


@pytest.mark.parametrize("kind", ["full", "tail"])
def test_empty_priors_match_jax(case, kind):
    js, ts = case["js"], case["ts"]
    if kind == "full":
        want = js.init_full_phase_prior(P, jnp.float64)
        got = ts.init_full_phase_prior(P, B)
    else:
        want = js.init_phase_prior(P, jnp.float64)
        got = ts.init_phase_prior(P, B)
    for k in want._fields:
        g, w = np_of(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.shape == (B,) + w.shape and g.dtype == w.dtype
        assert not g.any()


def test_init_matches_jax(case):
    js, ts, jp = case["js"], case["ts"], case["jp"]
    x0 = perturbed_states(jp.initial_state, B, seed=34)
    U0 = np.tile(np.asarray(jp.static_input)[None], (NS, 1))
    want = al_state_numpy(jax.vmap(
        lambda x: js.init(x, U0=jnp.asarray(U0)))(jnp.asarray(x0)))
    got = al_state_numpy(ts.init(to_torch(x0), to_torch(U0)))
    for k in AL_FIELDS + ("rho", "viol"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("X", "U"):
        np.testing.assert_array_equal(got["sol"][k], want["sol"][k])


@pytest.mark.parametrize("preset", [
    "ddp_example_options", "ddp_online_options",
    "ipopt_offline_solver_options", "ipopt_online_solver_options",
    "sqp_offline_solver_options", "sqp_online_solver_options",
    "al_serving_options"])
def test_option_presets_match_jax(preset):
    from srbd_horizon_tpu.solvers import options as joptions
    want, got = getattr(joptions, preset)(), getattr(toptions, preset)()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), f.name


# ---------------- the path as a whole ----------------

@pytest.fixture(scope="module")
def seeded(case):
    """The JAX-side offline seed (outer_iters=2, max_iters=3), as numpy."""
    js, jp = case["js"], case["jp"]
    x0 = perturbed_states(jp.initial_state, B, seed=35)
    U0 = jnp.tile(jp.static_input[None], (NS, 1))
    params = fleet_params(jp.ocp.params, B)
    st0 = jax.vmap(lambda x: js.init(x, U0=U0))(jnp.asarray(x0))
    jst = jit(js.solve_batch)(st0, jnp.asarray(x0), to_jax(params))
    return dict(x0=x0, params=params, jst=jst, seed=al_state_numpy(jst))


def _assert_states_close(got, want, tol, what):
    g, w = al_state_numpy(got), al_state_numpy(want)
    np.testing.assert_array_equal(g["sol"]["iterations"], w["sol"]["iterations"],
                                  err_msg=what)
    np.testing.assert_array_equal(g["sol"]["converged"], w["sol"]["converged"],
                                  err_msg=what)
    errs = {k: max_rel_err(g[k], w[k]) for k in ("lam_eq", "lam_eq_T", "viol", "rho")}
    errs.update({k: max_rel_err(g["sol"][k], w["sol"][k]) for k in ("X", "U", "cost")})
    assert max(errs.values()) < tol, (what, errs)
    return errs


def test_offline_solve_batch_matches_jax(case, seeded):
    ts = case["ts"]
    U0 = np.tile(np.asarray(case["jp"].static_input)[None], (NS, 1))
    x0 = to_torch(seeded["x0"])
    got = ts.solve_batch(ts.init(x0, to_torch(U0)), x0,
                         to_torch(seeded["params"]))
    _assert_states_close(got, seeded["jst"], 1e-7, "offline solve_batch")
    for k in ("mu_ub", "mu_x_ub", "mu_u_lb"):
        _close(getattr(got, k), getattr(seeded["jst"], k), rtol=1e-6, atol=1e-6)
    assert int(got.sol.iterations.min()) >= 1


def test_serving_ticks_match_jax(case, seeded):
    """6 WPG-advanced serving ticks (1 outer × 1 inner iteration, full
    prior with ema 1, shifted warm start) from the same seed."""
    jp, tp = case["jp"], case["tp"]
    jon, ton = al_solvers(jp, tp, max_iters=1)
    jwpg = JWPG.build(0.0, NS, dtype=jnp.float64)
    twpg = TWPG.build(0.0, NS, dtype=F64, device="cpu")
    period = 2 * jwpg.step_nodes
    assert period == P == 2 * twpg.step_nodes

    def jtick(st, params, wst, action, rdot_ref, pr):
        phase = wst.step_counter % period
        p1, w1 = jax.vmap(jwpg.advance)(params, wst, action)
        p1["rdot_ref"] = p1["rdot_ref"].at[:, 1:].set(rdot_ref[:, None, :])
        st, pr = jon.serving_tick_batch(st, st.sol.X[:, 1], p1, outers=1,
                                        prior=pr, phase=phase, prior_ema=1.0)
        return st, p1, w1, pr

    jtick = jit(jtick)
    action = np.ones(B, np.int32)
    rdot = np.tile([[0.1, 0.0, 0.0]], (B, 1))
    jst, jparams = seeded["jst"], to_jax(seeded["params"])
    jw = jax.vmap(lambda _: jwpg.init_state())(jnp.arange(B))
    jpr = jax.vmap(lambda _: jon.init_full_phase_prior(period, jnp.float64))(
        jnp.arange(B))
    tst, tparams = torch_al_state(seeded["seed"]), to_torch(seeded["params"])
    tw = twpg.init_state((B,))
    tpr = ton.init_full_phase_prior(period, B)
    worst = {}
    for t in range(6):
        jst, jparams, jw, jpr = jtick(jst, jparams, jw, jnp.asarray(action),
                                      jnp.asarray(rdot), jpr)
        tst, tparams, tw, tpr = constrained_tick(
            ton, twpg, tst, tparams, tw, torch.as_tensor(action),
            to_torch(rdot), prior=tpr, outers=1, prior_ema=1.0)
        errs = _assert_states_close(tst, jst, 1e-7, f"tick {t}")
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in errs.items()}
        for k in ("c_ref", "rdot_ref"):
            np.testing.assert_array_equal(np_of(tparams[k]), np.asarray(jparams[k]))
    assert int(tst.sol.iterations.max()) == 1
    for k in jpr._fields:
        _close(getattr(tpr, k), getattr(jpr, k), rtol=1e-7, atol=1e-7)
    assert bool(tpr.seen[:, :6].all()) and not bool(tpr.seen[:, 6:].any())
    print("worst relative errors over the ticks:", worst)


def test_serving_tick_without_prior_and_with_tail_prior(case, seeded):
    """The other two forms of the tick: no prior (returns the state
    alone) and the tail prior, two outers each, against JAX."""
    jp, tp = case["jp"], case["tp"]
    jon, ton = al_solvers(jp, tp, max_iters=1)
    jst, jparams = seeded["jst"], to_jax(seeded["params"])
    tst, tparams = torch_al_state(seeded["seed"]), to_torch(seeded["params"])
    phase = np.array([1, 2, 3, 4], np.int32)
    jx0, tx0 = jst.sol.X[:, 1], tst.sol.X[:, 1]
    want = jit(lambda s, x, p: jon.serving_tick_batch(s, x, p, outers=2))(
        jst, jx0, jparams)
    got = ton.serving_tick_batch(tst, tx0, tparams, outers=2)
    _assert_states_close(got, want, 1e-7, "no prior")
    jpr = jax.vmap(lambda _: jon.init_phase_prior(P, jnp.float64))(jnp.arange(B))
    want, jpr = jit(lambda s, x, p, pr, ph: jon.serving_tick_batch(
        s, x, p, outers=2, prior=pr, phase=ph))(jst, jx0, jparams, jpr,
                                                jnp.asarray(phase))
    got, tpr = ton.serving_tick_batch(
        tst, tx0, tparams, outers=2,
        prior=ton.init_phase_prior(P, B), phase=torch.as_tensor(phase))
    _assert_states_close(got, want, 1e-7, "tail prior")
    for k in jpr._fields:
        _close(getattr(tpr, k), getattr(jpr, k), rtol=1e-7, atol=1e-7)


def test_chunk_map_carries_al_state_and_prior(case, seeded):
    """The chunked tick (two chunks of 2) equals the whole-fleet tick."""
    tp = case["tp"]
    _, ton = al_solvers(case["jp"], tp, max_iters=1)
    twpg = TWPG.build(0.0, NS, dtype=F64, device="cpu")
    tst, tparams = torch_al_state(seeded["seed"]), to_torch(seeded["params"])
    args = (tst, tparams, twpg.init_state((B,)),
            torch.ones(B, dtype=torch.int32),
            to_torch(np.tile([[0.1, 0.0, 0.0]], (B, 1))),
            ton.init_full_phase_prior(P, B))
    tick = lambda st, p, w, a, r, pr: constrained_tick(ton, twpg, st, p, w, a,
                                                       r, prior=pr)
    whole = tick(*args)
    parts = chunk_map(tick, 2)(*args)
    assert type(parts[0]).__name__ == "ALState"
    assert type(parts[3]).__name__ == "FullPhasePrior"
    g, w = al_state_numpy(parts[0]), al_state_numpy(whole[0])
    for k in AL_FIELDS + ("viol",):
        np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(g["sol"]["X"], w["sol"]["X"])
    np.testing.assert_array_equal(np_of(parts[3].seen), np_of(whole[3].seen))
    np.testing.assert_array_equal(np_of(parts[2].step_counter), [1] * B)


def test_jax_batched_path_ignores_quu_solver(case, seeded):
    """`ALDDP` asks its inner solver for Cholesky, but the batched
    lane-major sweep always takes the block-Schur inverse: the inner
    `solve_batch` gives bit-equal results under either setting."""
    js = case["js"]
    inner = js._inner
    assert inner.opts.quu_solver == "cholesky"
    schur = JMSDDP(inner.ocp, dataclasses.replace(inner.opts, quu_solver="schur"))
    jst = seeded["jst"]
    p_in = jax.vmap(js._params_with_multipliers)(to_jax(seeded["params"]), jst)
    x0 = jst.sol.X[:, 0]
    a = jit(inner.solve_batch)(jst.sol, x0, p_in)
    b = jit(schur.solve_batch)(jst.sol, x0, p_in)
    for f in ("X", "U", "cost", "iterations"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
