"""Quaternion utilities in the (x, y, z, w) convention — the port of
srbd_horizon_tpu/math/quat.py. Every function batches along leading
axes and is traceable by `torch.func` (jacfwd, vmap)."""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis (written out: `torch.func` friendly and the
    same arithmetic as the CUDA rollout)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (cross-product) matrix of a 3-vector."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def quat_product(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product p ⊗ q with (x, y, z, w) layout."""
    pv, pw = p[..., :3], p[..., 3:4]
    qv, qw = q[..., :3], q[..., 3:4]
    vec = pw * qv + qw * pv + cross(pv, qv)
    w = pw * qw - torch.sum(pv * qv, dim=-1, keepdim=True)
    return torch.cat([vec, w], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Homogeneous (not normalized) rotation matrix of an (x, y, z, w)
    quaternion: the standard direction cosine matrix for ‖q‖=1."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    ww = w * w
    r00 = ww + xx - yy - zz
    r11 = ww - xx + yy - zz
    r22 = ww - xx - yy + zz
    return torch.stack(
        [
            torch.stack([r00, 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), r11, 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), r22], dim=-1),
        ],
        dim=-2,
    )


def quat_derivative_world(o: torch.Tensor, w_world: torch.Tensor) -> torch.Tensor:
    """ȯ = ½ ω ⊗ o for a world-aligned angular velocity."""
    w_quat = torch.cat([w_world, torch.zeros_like(w_world[..., :1])], dim=-1)
    return 0.5 * quat_product(w_quat, o)


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹ b for a 3×3 system via the adjugate (Cramer) formula — the
    same formula the CUDA rollout evaluates."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) / det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) / det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize; used only at the simulation boundary."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)
