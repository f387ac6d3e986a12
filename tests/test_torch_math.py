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


@pytest.mark.parametrize("fn", ["cross", "solve3x3", "lm_spd_inverse"])
def test_index_tables_are_made_once_a_device(fn):
    """The closed forms' gathers take their index tables from one tensor a
    device (a fresh host-to-device copy each call would stall the CUDA
    stream), and give the written-out formula's bits."""
    rng = np.random.RandomState(4)
    a, b = _t(rng.randn(5, 3)), _t(rng.randn(5, 3))
    A = _t(rng.randn(5, 3, 3) + 3.0 * np.eye(3))
    call = {"cross": lambda: tquat.cross(a, b),
            "solve3x3": lambda: tquat.solve3x3(A, a),
            "lm_spd_inverse": lambda: tlin.lm_spd_inverse(A[..., :2, :2])}[fn]
    call()
    tables = dict(tlin._TABLES)
    assert tables and all(t.device.type == "cpu" for t in tables.values())
    call()
    assert all(tlin._TABLES[k] is t for k, t in tables.items())
    assert tlin.index_table((1, 2, 0), "cpu") is tlin.index_table(
        (1, 2, 0), torch.device("cpu"))
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    want = {"cross": lambda: torch.stack([a1 * b2 - a2 * b1,
                                          a2 * b0 - a0 * b2,
                                          a0 * b1 - a1 * b0], -1),
            "solve3x3": lambda: _cramer3(A, a),
            "lm_spd_inverse": lambda: _inv2(A[..., :2, :2])}[fn]
    assert torch.equal(call(), want())


def _cramer3(A, b):
    (a00, a01, a02), (a10, a11, a12), (a20, a21, a22) = (
        r.unbind(-1) for r in A.unbind(-2))
    c = [[a11 * a22 - a12 * a21, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11],
         [a12 * a20 - a10 * a22, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12],
         [a10 * a21 - a11 * a20, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10]]
    det = a00 * c[0][0] + a01 * c[1][0] + a02 * c[2][0]
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([(r[0] * b0 + r[1] * b1 + r[2] * b2) / det
                        for r in c], -1)


def _inv2(A):
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)],
                       -2) / det[..., None, None]


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
