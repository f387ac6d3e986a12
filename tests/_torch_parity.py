"""Shared setup for the PyTorch-port parity tests (not collected).

The same SRBD problem is built in both packages in float64 on the CPU,
and every random input is drawn from a numpy seed and handed to both, so
each test compares the JAX function with its port on identical data.
Arrays cross between the frameworks as numpy only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet as j_feet
from srbd_horizon_tpu.problems.srbd import build_srbd_problem as j_build
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP

from srbd_horizon_tpu_torch.config import DDPOptions as TDDPOptions
from srbd_horizon_tpu_torch.config import SRBDConfig as TSRBDConfig
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet as t_feet
from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem as t_build
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP as TMSDDP

CPU = "cpu"
F64 = torch.float64

# the option set the fleet bench and the batched-solver tests run
SOLVER_OPTS = dict(max_iters=8, alpha_converge_threshold=1e-12, beta=1e-3)


def np_of(a):
    """Torch tensor or JAX array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def problems():
    """(jax SRBDProblem, torch SRBDProblem), both float64 on the CPU."""
    jp = j_build(JSRBDConfig(dtype=jnp.float64), j_feet())
    tp = t_build(TSRBDConfig(dtype=F64), t_feet(), device=CPU)
    return jp, tp


def solvers(jp, tp, **overrides):
    opts = dict(SOLVER_OPTS, **overrides)
    return JMSDDP(jp.ocp, JDDPOptions(**opts)), TMSDDP(tp.ocp, TDDPOptions(**opts))


def perturbed_states(x_nominal, B, seed, scale=0.01):
    """(B, nx) numpy states around the nominal one."""
    rng = np.random.RandomState(seed)
    x = np.asarray(x_nominal, np.float64)
    return x[None] + scale * rng.randn(B, x.shape[0])


def random_xup(ocp_params, nx, nu, seed, lead=()):
    """Numpy (x, u, p) around the walking regime: a non-unit quaternion,
    random contacts and velocities, random parameter rows with binary
    switches."""
    rng = np.random.RandomState(seed)
    x = np.concatenate(
        [
            rng.uniform(-0.5, 0.5, lead + (3,)) + [0, 0, 0.9],
            np.broadcast_to([0.1, -0.2, 0.05, 0.97], lead + (4,))
            + 0.01 * rng.randn(*lead, 4),
            rng.uniform(-0.3, 0.3, lead + (nx - 7,)),
        ],
        axis=-1,
    )
    u = 0.3 * rng.randn(*lead, nu)
    p = {}
    for k, v in ocp_params.items():
        row = np.asarray(np_of(v))[3]
        p[k] = row + 0.1 * np.abs(rng.randn(*lead, *row.shape))
    p["cdot_switch"] = np.round(np.clip(p["cdot_switch"], 0, 1))
    return x, u, p


def fleet_params(ocp_params, B):
    """(B, ns+1, dim) numpy params: the template copied per member."""
    return {k: np.broadcast_to(np_of(v)[None], (B,) + tuple(v.shape)).copy()
            for k, v in ocp_params.items()}


def to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: torch.tensor(np.asarray(v), dtype=F64) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=F64)


def trajectories(jp, B, seed):
    """A numpy linearization point near the walking regime: X (B,ns+1,nx)
    around the initial state, U (B,ns,nu) around the static input."""
    rng = np.random.RandomState(seed)
    ns = jp.ocp.ns
    x0 = np.asarray(jp.initial_state)
    u0 = np.asarray(jp.static_input)
    X = x0[None, None] + 0.02 * rng.randn(B, ns + 1, x0.shape[0])
    U = u0[None, None] + 0.05 * rng.randn(B, ns, u0.shape[0])
    return X, U


def max_rel_err(got, want):
    """max |got − want| / max |want| (norm-wise relative error)."""
    got, want = np_of(got), np_of(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    return float(np.max(np.abs(got - want))) / scale
