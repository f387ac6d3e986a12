"""PyTorch port, the plain twins of the CUDA kernels against the JAX
package, on the CPU in float64:

  - K1 `riccati_backward_plain` (and the wrapper, which takes the plain
    path for CPU tensors) against JAX `MSDDP._backward_lanemajor` on the
    same sliced linearization: ks, Ks, dV1, dV2 to 1e-9 relative;
  - K3 `srbd_rollout_plain` for 4 step sizes against
    `jax.vmap(MSDDP._rollout)`, to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    fleet_params,
    max_rel_err,
    np_of,
    perturbed_states,
    problems,
    solvers,
    to_jax,
    to_torch,
    trajectories,
)
from srbd_horizon_tpu_torch.kernels.riccati import (
    RiccatiRows,
    riccati_backward,
    riccati_backward_plain,
)
from srbd_horizon_tpu_torch.kernels.rollout import srbd_rollout, srbd_rollout_plain

torch.set_num_threads(1)

ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
MU = 1e-6
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])


@pytest.fixture(scope="module")
def case():
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    B = 4
    X, U = trajectories(jp, B, seed=11)
    params = fleet_params(jp.ocp.params, B)
    jlin = jax.jit(jax.vmap(
        lambda x, u, p: js._linearize(x, u, p, sliced=True)
    ))(*to_jax((X, U, params)))
    jback = jax.jit(js._backward_lanemajor)(jlin, jnp.asarray(MU))
    tlin = {k: to_torch(np_of(v)) for k, v in jlin.items()}
    x0 = perturbed_states(jp.initial_state, B, seed=12)
    return dict(jp=jp, tp=tp, js=js, ts=ts, X=X, U=U, params=params,
                jlin=jlin, tlin=tlin, jback=jback, x0=x0)


@pytest.mark.parametrize("out", ["ks", "Ks", "dV1", "dV2"])
def test_riccati_plain_matches_jax(case, out):
    got = riccati_backward_plain(*(case["tlin"][k] for k in ORDER), MU,
                                 case["ts"].rows)
    i = ("ks", "Ks", "dV1", "dV2").index(out)
    assert max_rel_err(got[i], case["jback"][i]) < 1e-9


def test_riccati_wrapper_takes_plain_path_on_cpu(case):
    before = riccati_backward.launches
    args = tuple(case["tlin"][k] for k in ORDER) + (MU, case["ts"].rows)
    got = riccati_backward(*args)
    want = riccati_backward_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert riccati_backward.launches == before   # no kernel launch on CPU


def test_riccati_rows_from_ocp(case):
    rows = RiccatiRows.from_ocp(case["tp"].ocp)
    assert rows.rx == tuple(range(0, 19)) + (22, 23, 24)
    assert rows.ru == tuple(range(19, 37))
    assert rows.gx == tuple(range(15)) + (18, 19, 20) + tuple(range(57, 73))
    assert rows.gu == tuple(range(15, 57))
    assert [rows.gx[i] for i in rows.bx] == [18, 19, 20]
    assert [rows.gu[i] for i in rows.bu] == [18, 19, 20]
    assert rows.packed("cpu").dtype == torch.int32
    assert rows.packed("cpu").numel() == 22 + 18 + 34 + 42 + 6


@pytest.fixture(scope="module")
def rollouts(case):
    js = case["js"]
    ks, Ks = case["jback"][0], case["jback"][1]
    X, U, params, x0 = (to_jax(case[k]) for k in ("X", "U", "params", "x0"))
    d = case["jlin"]["d"]

    def one_alpha(a):
        return jax.vmap(
            lambda x0_, X_, U_, k_, K_, d_, p_: js._rollout(
                x0_, X_, U_, k_, K_, d_, p_, a)
        )(x0, X, U, ks, Ks, d, params)

    want = jax.jit(jax.vmap(one_alpha))(jnp.asarray(ALPHAS))
    c = case["tp"].ocp.constants
    args = (to_torch(case["x0"]), to_torch(case["X"]), to_torch(case["U"]),
            to_torch(np_of(ks)), to_torch(np_of(Ks)), case["tlin"]["d"],
            to_torch(ALPHAS), case["tp"].ocp.dt, c["m_scaled"],
            c["inertia_scaled"])
    return args, want


@pytest.mark.parametrize("out", [0, 1], ids=["Xn", "Un"])
def test_rollout_plain_matches_jax(rollouts, out):
    args, want = rollouts
    got = srbd_rollout_plain(*args)
    assert tuple(got[out].shape) == tuple(want[out].shape)
    np.testing.assert_allclose(got[out].numpy(), np.asarray(want[out]),
                               rtol=1e-12, atol=1e-12)


def test_rollout_wrapper_takes_plain_path_on_cpu(rollouts):
    args, _ = rollouts
    before = srbd_rollout.launches
    for g, w in zip(srbd_rollout(*args), srbd_rollout_plain(*args)):
        assert torch.equal(g, w)
    assert srbd_rollout.launches == before


def test_rollout_alpha_zero_recovers_iterate(rollouts):
    """α = 0 with zero feedback gain on a consistent plan retraces it:
    x̂ₙ₊₁ = x̂ₙ + dt ẋ − dₙ = Xₙ₊₁ when x̂ₙ = Xₙ."""
    args, _ = rollouts
    x0, X, U, ks, Ks, d = args[:6]
    zero = torch.zeros(1, dtype=torch.float64)
    Xn, Un = srbd_rollout_plain(X[:, 0].clone(), X, U, ks, Ks, d, zero,
                                *args[7:])
    np.testing.assert_allclose(Xn[0].numpy(), X.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Un[0].numpy(), U.numpy(), rtol=0, atol=1e-12)


def test_riccati_f32_inputs_cost_little_in_f64_arithmetic(case):
    """K1 computes in float64 on chip for float32 tensors as well. Rounding
    the sweep's inputs to float32 and carrying them in float64 must stay
    within 1e-5 relative of the float64 sweep — the ~1e-2 that a float32
    sweep loses (chip_smoke's float32 check) is float32 arithmetic."""
    args = tuple(case["tlin"][k] for k in ORDER)
    ref = riccati_backward_plain(*args, MU, case["ts"].rows)
    rounded = tuple(a.float().double() for a in args)
    got = riccati_backward_plain(*rounded, float(np.float32(MU)), case["ts"].rows)
    for g, r in zip(got, ref):
        assert max_rel_err(g, r) < 1e-5
