"""Quaternion utilities in the (x, y, z, w) convention — the port of
srbd_horizon_tpu/math/quat.py. Every function batches along leading
axes and is traceable by `torch.func` (jacfwd, vmap)."""

from __future__ import annotations

import torch

from srbd_horizon_tpu_torch.math.linalg import adjugate3, index_table

# the components a cross product pairs: (1, 2, 0) with (2, 0, 1)
_CROSS_I = (1, 2, 0)
_CROSS_J = (2, 0, 1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis: (a1b2 − a2b1, a2b0 − a0b2, a0b1 − a1b0),
    each product minus another elementwise (`torch.func` friendly and the
    same arithmetic as the CUDA rollout)."""
    i, j = index_table(_CROSS_I, a.device), index_table(_CROSS_J, a.device)
    return (a.index_select(-1, i) * b.index_select(-1, j)
            - a.index_select(-1, j) * b.index_select(-1, i))


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
    """x = A⁻¹ b for a 3×3 system via the adjugate (Cramer) formula —
    xᵢ = (cᵢ₀b₀ + cᵢ₁b₁ + cᵢ₂b₂) / det, summed left to right, the same
    formula the CUDA rollout evaluates."""
    c, det = adjugate3(A)
    cb = c.unflatten(-1, (3, 3)) * b[..., None, :]
    return (cb[..., 0] + cb[..., 1] + cb[..., 2]) / det[..., None]


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize; used only at the simulation boundary."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)
