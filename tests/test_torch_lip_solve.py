"""PyTorch port, the MS-DDP solves on the LIP problem against the JAX
package, float64 on the CPU at ns = 20: `MSDDP.solve` (one robot; the
parallel and the sequential line search, the block-Schur and the Cholesky
gain solve) and `solve_batch` (B = 3). Iterations and convergence are
equal; X, U and the cost agree to 1e-9 relative, the defect norm to
1e-12 absolute.

Where the pushes sit: the LIP is linear–quadratic, so the first
Gauss–Newton step is exact and every solve ends its second iteration on
the merit's rounding floor, where an accept or a convergence decision
could flip between the two packages. The starts are the nominal state
pushed by 0.01–0.05·N(0, 1) (seeded) with cold plans, so the first step
removes ~95% of a merit of 5e4–1e6, far above the floor; the second
iteration's predicted reduction is then ~8e-16 of the merit in float64
(2.2e-12 of 2.7e3, 5.6e-11 of 6.8e4, read off the port's trials at these
pushes), below `cost_reduction_ths` = 1e-9 whatever the trial decides,
so both packages converge there: the counts are exact and the plans
differ only in rounding.
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
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet as t_feet
from srbd_horizon_tpu_torch.problems.lip import build_lip_problem as t_build
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

F64 = torch.float64
OPTS = dict(max_iters=30, alpha_converge_threshold=1e-12, beta=1e-3)


@pytest.fixture(scope="module")
def lip():
    jp = j_build(JSRBDConfig(dtype=jnp.float64), j_feet())
    tp = t_build(SRBDConfig(dtype=F64), t_feet(), device="cpu")
    return jp, tp


def _states(jp, B, seed, scale):
    rng = np.random.RandomState(seed)
    x = np.asarray(jp.initial_state)
    return x[None] + scale * rng.randn(B, x.shape[0])


def _compare(tsol, jsol):
    np.testing.assert_array_equal(np_of(tsol.iterations), np.asarray(jsol.iterations))
    np.testing.assert_array_equal(np_of(tsol.converged), np.asarray(jsol.converged))
    for f in ("X", "U", "cost"):
        assert max_rel_err(getattr(tsol, f), getattr(jsol, f)) < 1e-9, f
    np.testing.assert_allclose(np_of(tsol.defect_norm),
                               np.asarray(jsol.defect_norm), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
@pytest.mark.parametrize("solver", ["schur", "cholesky"])
@pytest.mark.parametrize("scale", [0.01, 0.05])
def test_solve_matches_jax(lip, mode, solver, scale):
    jp, tp = lip
    opts = dict(OPTS, line_search_mode=mode, quu_solver=solver)
    js = JMSDDP(jp.ocp, JDDPOptions(**opts))
    ts = MSDDP(tp.ocp, DDPOptions(**opts))
    x0 = _states(jp, 1, seed=31, scale=scale)[0]
    jsol = jit(js.solve)(js.init(jnp.asarray(x0)), jnp.asarray(x0),
                         jp.ocp.params)
    before = list(k1.riccati_backward.instance_launches)
    tsol = ts.solve(ts.init(to_torch(x0)), to_torch(x0), tp.ocp.params)
    assert k1.riccati_backward.instance_launches == before    # the CPU: twins
    assert int(tsol.iterations) >= 2 and bool(tsol.converged)
    _compare(tsol, jsol)


def test_solve_batch_matches_jax(lip):
    """B = 3 from pushed states, params with a walking reference and one
    member's switches off (a swing phase)."""
    jp, tp = lip
    js = JMSDDP(jp.ocp, JDDPOptions(**OPTS))
    ts = MSDDP(tp.ocp, DDPOptions(**OPTS))
    B = 3
    x0 = _states(jp, B, seed=32, scale=0.02)
    params = {k: np.broadcast_to(np.asarray(v)[None], (B,) + v.shape).copy()
              for k, v in jp.ocp.params.items()}
    params["rdot_ref"][:, -1, 0] = [0.3, 0.1, 0.0]
    params["cdot_switch"][1, 10:, :2] = 0.0
    jinit = jax.vmap(js.init)(jnp.asarray(x0))
    jsol = jit(js.solve_batch)(jinit, jnp.asarray(x0), to_jax(params))
    tsol = ts.solve_batch(ts.init(to_torch(x0)), to_torch(x0), to_torch(params))
    assert tsol.X.shape == (B, 21, 30) and tsol.iterations.shape == (B,)
    assert bool(tsol.converged.all())
    _compare(tsol, jsol)


def test_solve_runs_the_lip_kernels_by_family(lip, monkeypatch):
    """The solver takes K10, K11 and lip_evaluate for a LIP problem: on the
    CPU each wrapper is reached (and takes its twin), the SRBD ones never."""
    from srbd_horizon_tpu_torch.solvers import msddp

    _, tp = lip
    calls = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    kernels = {fam: tuple(spy(f"{fam}{i}", fn) for i, fn in enumerate(fns))
               for fam, fns in msddp._KERNELS.items()}
    monkeypatch.setattr(msddp, "_KERNELS", kernels)
    ts = MSDDP(tp.ocp, DDPOptions(**OPTS))
    x0 = tp.initial_state + 0.01
    sol = ts.solve(ts.init(x0), x0, tp.ocp.params)
    n = int(sol.iterations)
    assert calls == {"lip0": n, "lip1": calls["lip1"], "lip2": 2}
    assert calls["lip1"] >= n
    assert dataclasses.is_dataclass(ts.terms) and ts.terms.family == "lip"
