"""PyTorch port, math: quaternion helpers, the batch-first `lm_*`
contractions and the block-Schur `lm_spd_inverse` against the JAX
package's versions on the same numpy inputs, in float64 to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu.math import linalg as jlin
from srbd_horizon_tpu.math import quat as jquat
from srbd_horizon_tpu_torch.math import linalg as tlin
from srbd_horizon_tpu_torch.math import quat as tquat

torch.set_num_threads(1)

TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", [
    "skew", "quat_product", "quat_inverse", "quat_to_rot",
    "quat_derivative_world", "solve3x3", "quat_normalize",
])
def test_quat_helpers_match_jax(name):
    rng = np.random.RandomState(0)
    q = rng.randn(6, 4)
    p = rng.randn(6, 4)
    v = rng.randn(6, 3)
    A = rng.randn(6, 3, 3) + 3.0 * np.eye(3)
    args = {
        "skew": (v,),
        "quat_product": (p, q),
        "quat_inverse": (q,),
        "quat_to_rot": (q,),
        "quat_derivative_world": (q, v),
        "solve3x3": (A, v),
        "quat_normalize": (q,),
    }[name]
    want = getattr(jquat, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tquat, name)(*(_t(a) for a in args))
    _close(got, want)


def test_cross_matches_numpy():
    rng = np.random.RandomState(1)
    a, b = rng.randn(5, 3), rng.randn(5, 3)
    _close(tquat.cross(_t(a), _t(b)), np.cross(a, b))


@pytest.mark.parametrize("name", ["lm_matmul", "lm_matmul_tn", "lm_matvec",
                                  "lm_matvec_tn", "lm_transpose"])
def test_lm_contractions_match_lane_major(name):
    """The port is batch-first; the JAX versions are lane-major (batch
    last) — same numbers after moving the batch axis."""
    rng = np.random.RandomState(2)
    B = 7
    A = rng.randn(B, 5, 6)
    M = {"lm_matmul": rng.randn(B, 6, 4), "lm_matmul_tn": rng.randn(B, 5, 4),
         "lm_matvec": rng.randn(B, 6), "lm_matvec_tn": rng.randn(B, 5)}.get(name)
    lm = lambda a: jnp.moveaxis(jnp.asarray(a), 0, -1)
    if M is None:
        want = getattr(jlin, name)(lm(A))
        got = getattr(tlin, name)(_t(A))
    else:
        want = getattr(jlin, name)(lm(A), lm(M))
        got = getattr(tlin, name)(_t(A), _t(M))
    _close(got, np.moveaxis(np.asarray(want), -1, 0))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 24])
def test_lm_spd_inverse_matches_jax(n):
    rng = np.random.RandomState(3 + n)
    B = 6
    G = rng.randn(B, n + 4, n)
    A = np.einsum("bri,brj->bij", G, G) + 1e-3 * np.eye(n)
    want = jlin.lm_spd_inverse(jnp.moveaxis(jnp.asarray(A), 0, -1))
    got = tlin.lm_spd_inverse(_t(A))
    _close(got, np.moveaxis(np.asarray(want), -1, 0))
    # and it is an inverse
    eye = np.einsum("bij,bjk->bik", A, got.numpy())
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(n), eye.shape),
                               atol=1e-9)
