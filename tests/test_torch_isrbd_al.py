"""PyTorch port, K7 and K8 — the AL layer's entries of
`kernels/isrbd_al.py` (csrc/isrbd_al.cu) — on the CPU, where each entry
takes its plain twin, against the JAX package in float64.

    isrbd_al_constraints   K7: h, hT, g, viol (`ALDDP._constraints` under
                           vmap) to 1e-12; the online equality update and
                           the offline update with the penalty schedule on
                           a first outer (viol_prev = inf) and a later one
    isrbd_al_shift         K8a: `shift_warmstart`, then each prior's seed,
                           bit for bit
    isrbd_al_params        K8b: the padded dict of
                           `vmap(_params_with_multipliers)`, bit for bit,
                           with and without bound overrides
    isrbd_al_prior_update  K8c: each prior's update at EMA 0.5 and 1 to
                           1e-12, the argument left as it was

A NaN member's violation is NaN in both packages; a side whose bound is
infinite is 0 in both. The entries refuse other sizes and devices before
any device work (meta tensors stand in for CUDA ones), and the solver's
paths reach the AL layer only through the four entries.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu.solvers.alddp import FullPhasePrior as JFullPrior
from srbd_horizon_tpu.solvers.alddp import PhasePrior as JTailPrior
from srbd_horizon_tpu_torch.convert import phase_prior_from_numpy
from srbd_horizon_tpu_torch.kernels import isrbd_al as k78
from srbd_horizon_tpu_torch.solvers.alddp import ALState

from _torch_parity import (
    F64, al_solvers, al_state_numpy, fleet_params, isrbd_problems,
    jax_al_state, np_of, random_al_state, tight_box_params, to_jax, to_torch,
    torch_al_state,
)

torch.set_num_threads(1)

B = 4
NS = 8
P = 20
NAN_MEMBER = 2
AL_FIELDS = k78.MULTIPLIERS


@pytest.fixture(scope="module")
def case():
    jp, tp = isrbd_problems(ns=NS, cz_rho_weight=3200.0)
    js, ts = al_solvers(jp, tp, max_iters=1)
    st = random_al_state(jp.ocp, B, 41, *ts._sizes)
    nan_st = copy.deepcopy(st)
    nan_st["sol"]["U"][NAN_MEMBER, 3, 0] = np.nan      # r̈ₓ at node 3
    return dict(jp=jp, tp=tp, js=js, ts=ts, st=st, nan_st=nan_st,
                boxes=tight_box_params(jp, B, 42),
                static=fleet_params(jp.ocp.params, B))


def _close(got, want, tol=1e-12):
    """Each entry within tol·max(1, |want|); NaNs where JAX has them."""
    g, w = np_of(got), np.asarray(want)
    assert g.shape == w.shape
    if w.dtype == bool:
        np.testing.assert_array_equal(g, w)
        return
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    err = np.abs(g[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))
    assert err.size == 0 or float(err.max()) <= tol, float(err.max())


def _equal(got, want):
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


def _jax_constraints(js, st, params):
    return jax.vmap(js._constraints)(jnp.asarray(st["sol"]["X"]),
                                     jnp.asarray(st["sol"]["U"]), to_jax(params))


@pytest.mark.parametrize("bounds", ["static", "boxes"])
@pytest.mark.parametrize("which", ["st", "nan_st"])
def test_constraints_match_jax(case, bounds, which):
    st, params = case[which], case[bounds]
    want = _jax_constraints(case["js"], st, params)
    got = k78.isrbd_al_constraints(case["ts"], to_torch(st["sol"]["X"]),
                                   to_torch(st["sol"]["U"]), to_torch(params))
    for g, w in zip(got, want):
        _close(g, w)
    viol = np_of(got[3])
    if which == "nan_st":
        assert np.isnan(viol[NAN_MEMBER]) and np.isnan(np.asarray(want[3])[NAN_MEMBER])
        assert np.isnan(np_of(got[0])[NAN_MEMBER]).any()
    assert np.all(viol[np.arange(B) != NAN_MEMBER] > 0)


def _jax_offline(js, jst, X, U, params):
    """`solve_batch`'s outer step after the inner solve
    (srbd_horizon_tpu/solvers/alddp.py:547-552)."""
    opts = js.al_opts
    jparams = to_jax(params)
    h, hT, g, viol = jax.vmap(js._constraints)(X, U, jparams)
    mults = js._updated_multipliers(jst, X, U, h, hT, g, jparams, jst.rho)
    grow = viol > opts.viol_decrease * jst.viol
    rho = jnp.where(grow & (viol > opts.tol),
                    jnp.minimum(jst.rho * opts.rho_growth, opts.rho_max), jst.rho)
    return tuple(mults) + (rho, viol)


def _jax_online(js, jst, X, U, params):
    """`solve_online_batch`'s equality update (alddp.py:751-759)."""
    h, hT, _, viol = jax.vmap(js._constraints)(X, U, to_jax(params))
    r2 = jst.rho[:, None]
    w = js._w_eq if js._w_eq is not None else 1.0
    w_T = js._w_eq_T if js._w_eq_T is not None else 1.0
    return (jst.lam_eq + r2[..., None] * w * h, jst.lam_eq_T + r2 * w_T * hT,
            viol)


@pytest.mark.parametrize("outer", ["first", "later"])
@pytest.mark.parametrize("mode", ["online", "offline"])
@pytest.mark.parametrize("which", ["st", "nan_st"])
def test_multiplier_updates_match_jax(case, outer, mode, which):
    """First outer: viol_prev = inf, so ρ does not grow (inf·0.25 is inf);
    a later one: viol_prev per member on either side of the contraction
    test, member 1's growth clamped at rho_max."""
    st = copy.deepcopy(case[which])
    st["viol"] = (np.full(B, np.inf) if outer == "first"
                  else np.array([1e-9, 5.0, 0.3, 1e5]))
    st["rho"][1] = 9e4
    jst = jax_al_state(st)
    X, U = jnp.asarray(st["sol"]["X"]), jnp.asarray(st["sol"]["U"])
    ref = _jax_offline if mode == "offline" else _jax_online
    want = ref(case["js"], jst, X, U, case["boxes"])
    got = k78.isrbd_al_constraints(
        case["ts"], to_torch(st["sol"]["X"]), to_torch(st["sol"]["U"]),
        to_torch(case["boxes"]), st=torch_al_state(st),
        offline=mode == "offline")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    if mode == "offline":
        rho = np_of(got[8])
        grew = rho != st["rho"]
        if outer == "first":
            assert not grew.any()
        else:
            assert grew[:2].all() and not grew[3]
            assert rho[1] == case["ts"].al_opts.rho_max
        for name, g in zip(AL_FIELDS, got[:8]):
            if name.startswith("mu"):
                assert np.nanmin(np_of(g)) >= 0


def test_infinite_bounds_write_zero(case):
    """The cones have no lower bound and most state and input dims no box:
    those multipliers are 0 after the offline update in both packages, the
    NaN member's too."""
    st = case["nan_st"]
    got = k78.isrbd_al_constraints(
        case["ts"], to_torch(st["sol"]["X"]), to_torch(st["sol"]["U"]),
        to_torch(case["static"]), st=torch_al_state(st), offline=True)
    want = _jax_offline(case["js"], jax_al_state(st), jnp.asarray(st["sol"]["X"]),
                        jnp.asarray(st["sol"]["U"]), case["static"])
    mu_lb, mu_x_ub, mu_u_lb = np_of(got[3]), np_of(got[4]), np_of(got[7])
    assert not mu_lb.any() and not np.asarray(want[3]).any()
    x_free = ~np.isfinite(np_of(case["tp"].ocp.x_ub))
    u_free = ~np.isfinite(np_of(case["tp"].ocp.u_lb))
    assert x_free.any() and u_free.any()
    assert not mu_x_ub[:, x_free].any() and not mu_u_lb[:, u_free].any()
    # r̈ₓ is unboxed: the NaN there leaves its box multipliers at 0
    assert np_of(got[6])[NAN_MEMBER, 3, 0] == 0 == np_of(got[7])[NAN_MEMBER, 3, 0]
    for g, w in zip(got, want):
        _close(g, w)


def _priors(ts, seed):
    rng = np.random.RandomState(seed)
    n_eq, n_eq_T, _ = ts._sizes
    full = dict(lam_eq=rng.randn(B, P, NS, n_eq), lam_eq_T=rng.randn(B, P, n_eq_T),
                seen=rng.rand(B, P) < 0.5)
    tail = dict(lam_tail=rng.randn(B, P, n_eq), lam_T=rng.randn(B, P, n_eq_T),
                seen_tail=rng.rand(B, P) < 0.5, seen_T=rng.rand(B, P) < 0.5)
    # phase 0 wraps the tail's phase − 1 to P − 1
    return dict(full=full, tail=tail), np.array([0, 7, 19, 3], np.int32)


def _pair(kind, fields):
    jcls = JFullPrior if kind == "full" else JTailPrior
    return (jcls(**{k: jnp.asarray(v) for k, v in fields.items()}),
            phase_prior_from_numpy(fields, device="cpu", dtype=F64))


@pytest.mark.parametrize("kind", ["none", "tail", "full"])
def test_shift_and_seed_match_jax_bit_for_bit(case, kind):
    js, ts = case["js"], case["ts"]
    priors, phase = _priors(ts, 43)
    st = case["nan_st"]
    jst = jax.vmap(js.shift_warmstart)(jax_al_state(st))
    tst = torch_al_state(st)
    if kind == "none":
        got = k78.isrbd_al_shift(ts, tst)
        assert got.lam_eq_T is tst.lam_eq_T
    else:
        jprior, tprior = _pair(kind, priors[kind])
        seed = js._seed_full_prior if kind == "full" else js._seed_from_prior
        jst = jax.vmap(seed)(jst, jprior, jnp.asarray(phase))
        got = k78.isrbd_al_shift(ts, tst, tprior, torch.as_tensor(phase))
    want, got = al_state_numpy(jst), al_state_numpy(got)
    for k in AL_FIELDS + ("rho", "viol"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("X", "U"):
        np.testing.assert_array_equal(got["sol"][k], want["sol"][k])


@pytest.mark.parametrize("ema", [0.5, 1.0])
@pytest.mark.parametrize("kind", ["tail", "full"])
def test_prior_update_matches_jax(case, kind, ema):
    js, ts = case["js"], case["ts"]
    priors, phase = _priors(ts, 44)
    jprior, tprior = _pair(kind, priors[kind])
    upd = js._update_full_prior if kind == "full" else js._update_prior
    jst, tst = jax_al_state(case["st"]), torch_al_state(case["st"])
    want = jax.vmap(upd, in_axes=(0, 0, 0, None))(jprior, jst, jnp.asarray(phase), ema)
    for ph in (torch.as_tensor(phase), torch.as_tensor(phase, dtype=torch.int64)):
        got = k78.isrbd_al_prior_update(ts, tprior, tst, ph, ema)
        assert type(got).__name__ == type(want).__name__
        for k in priors[kind]:
            _close(getattr(got, k), getattr(want, k))
        # out of place: the tables handed in are as they were
        for k, v in priors[kind].items():
            _equal(getattr(tprior, k), v)


@pytest.mark.parametrize("bounds", ["static", "boxes"])
def test_params_match_jax_bit_for_bit(case, bounds):
    params = dict(case[bounds])
    if bounds == "boxes":            # x_lb and u_ub overridden, x_ub and u_lb static
        params = {k: v for k, v in params.items() if k not in ("x_ub", "u_lb")}
    js, ts = case["js"], case["ts"]
    st = case["nan_st"]
    want = jax.vmap(js._params_with_multipliers)(to_jax(params), jax_al_state(st))
    got = k78.isrbd_al_params(ts, to_torch(params), torch_al_state(st))
    assert sorted(got) == sorted(want)
    for k in want:
        _equal(got[k], want[k])
        assert got[k].shape == (B, NS + 1) + tuple(want[k].shape[2:])


# ---------------- the solver's paths reach the AL layer through the entries ----

ENTRIES = ("isrbd_al_constraints", "isrbd_al_shift", "isrbd_al_params",
           "isrbd_al_prior_update")


@pytest.fixture
def entry_calls(monkeypatch):
    """Count the calls of each entry (and, by mode, of K7) as the solver
    makes them through the module."""
    calls = {k: 0 for k in ENTRIES + ("offline", "online", "eval")}
    for name in ENTRIES:
        fn = getattr(k78, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            if _name == "isrbd_al_constraints":
                mode = ("eval" if kw.get("st") is None else
                        "offline" if kw.get("offline") else "online")
                calls[mode] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(k78, name, counted)
    return calls


def test_serving_tick_runs_the_entries(case, entry_calls):
    """One tick with a full prior and two outers: K8a once, then K8b and
    K7 online per outer, then K8c once; `_constraints` is K7's eval mode."""
    ts, st = case["ts"], torch_al_state(case["st"])
    priors, phase = _priors(ts, 45)
    _, tprior = _pair("full", priors["full"])
    params = to_torch(case["static"])
    out, _ = ts.serving_tick_batch(st, st.sol.X[:, 1], params, outers=2,
                                   prior=tprior, phase=torch.as_tensor(phase))
    assert isinstance(out, ALState)
    assert entry_calls == dict(isrbd_al_constraints=2, isrbd_al_shift=1,
                               isrbd_al_params=2, isrbd_al_prior_update=1,
                               offline=0, online=2, eval=0)
    ts._constraints(st.sol.X, st.sol.U, params)
    assert entry_calls["eval"] == 1


def test_offline_solve_runs_the_entries(case, entry_calls):
    ts = case["ts"]
    ts2 = dataclasses.replace(ts, al_opts=dataclasses.replace(ts.al_opts,
                                                              outer_iters=2))
    st = torch_al_state(case["st"])
    ts2.solve_batch(st, st.sol.X[:, 0], to_torch(case["static"]))
    assert entry_calls["isrbd_al_params"] == 2
    assert entry_calls["offline"] == 2 == entry_calls["isrbd_al_constraints"]


# ---------------- refusals off the CPU ----------------

def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _meta_calls(case, change=None):
    """Each entry's arguments on meta tensors of the ns=8 problem; with
    `change`, the solver's terms carry one size the kernels are not
    compiled for."""
    ts = case["ts"]
    if change is not None:
        terms = ts.terms
        if change == "nc":
            terms = dataclasses.replace(terms, outer=dataclasses.replace(
                terms.outer, nc=terms.outer.nc - 1))
        else:
            terms = dataclasses.replace(terms, **{change: getattr(terms, change) - 1})
        ts = copy.copy(ts)
        ts.terms = terms
    st = torch_al_state(case["st"])
    st = ALState(sol=type(st.sol)(*(_meta(t) for t in st.sol)),
                 **{k: _meta(getattr(st, k)) for k in st._fields if k != "sol"})
    params = {k: _meta(v) for k, v in to_torch(case["static"]).items()}
    priors, _ = _priors(case["ts"], 46)
    prior = type(ts.init_full_phase_prior(P, B))(
        **{k: torch.empty(np.shape(v), dtype=torch.bool if v.dtype == bool else F64,
                          device="meta") for k, v in priors["full"].items()})
    phase = torch.empty((B,), dtype=torch.int32, device="meta")
    return {
        "isrbd_al_constraints": lambda: k78.isrbd_al_constraints(
            ts, st.sol.X, st.sol.U, params, st=st),
        "isrbd_al_shift": lambda: k78.isrbd_al_shift(ts, st, prior, phase),
        "isrbd_al_params": lambda: k78.isrbd_al_params(ts, params, st),
        "isrbd_al_prior_update": lambda: k78.isrbd_al_prior_update(
            ts, prior, st, phase, 0.5),
    }


@pytest.mark.parametrize("change", ["nc", "n_eq", "n_eq_T", "n_ineq"])
@pytest.mark.parametrize("name", ENTRIES)
def test_entries_refuse_other_sizes_off_the_cpu(case, name, change):
    fn = getattr(k78, name)
    launches = fn.launches
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        _meta_calls(case, change)[name]()
    assert fn.launches == launches


@pytest.mark.parametrize("name", ENTRIES)
def test_entries_refuse_devices_other_than_cuda(case, name):
    """At the compiled sizes (ns is a run-time size) the entries pass the
    shape check and stop at the device check."""
    from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5

    ts = case["ts"]
    sizes = k5.kernel_sizes(ts.terms, ts.ocp.nx, ts.ocp.nu)
    assert sizes == {k: k5.KERNEL_SHAPES["kangaroo"][k] for k in sizes}
    fn = getattr(k78, name)
    launches = fn.launches
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        _meta_calls(case)[name]()
    assert fn.launches == launches
