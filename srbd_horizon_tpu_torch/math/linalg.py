"""Batch-first small-matrix algebra — the port of
srbd_horizon_tpu/math/linalg.py: the `lm_*` contractions, the block-Schur
SPD inverse (`spd_inverse`, `lm_spd_inverse`) and `spd_solve`, and a
Cholesky factor-and-solve (`cho_factor`, `cho_solve`) in place of
`jax.scipy.linalg`'s.

The JAX package keeps the `lm_*` functions lane-major ((n, m, B), batch
last) for the TPU's vector lanes, beside batch-first `spd_inverse` and
`spd_solve`. Here the batch always leads ((..., n, m)), the layout the
CUDA kernels read and PyTorch's batched matmul takes, so `lm_spd_inverse`
and `spd_inverse` are one function. These functions are the plain twins
of the pieces of the Riccati kernel (K1) and of its in-kernel SPD inverse
(K2) and Cholesky solve.
"""

from __future__ import annotations

import torch


def lm_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C[..., i, j] = Σ_k A[..., i, k] B[..., k, j]."""
    return A @ B


def lm_matmul_tn(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C[..., i, j] = Σ_k A[..., k, i] B[..., k, j] — first operand transposed."""
    return A.transpose(-1, -2) @ B


def lm_matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y[..., i] = Σ_k A[..., i, k] v[..., k]."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def lm_matvec_tn(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y[..., i] = Σ_k A[..., k, i] v[..., k]."""
    return (A.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def lm_transpose(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


# the 3×3 adjugate, row-major: c_ij = a[p]·a[q] − a[r]·a[s] over A's
# row-major entries, listed operand by operand (all p, then q, r, s)
_ADJ3 = (4, 2, 1, 5, 0, 2, 3, 1, 0,
         8, 7, 5, 6, 8, 3, 7, 6, 4,
         5, 1, 2, 3, 2, 0, 4, 0, 1,
         7, 8, 4, 8, 6, 5, 6, 7, 3)
# the 2×2 one: [d, −b; −c, a], the entries before their signs
_ADJ2 = (3, 1, 2, 0)

_TABLES: dict = {}


def index_table(values: tuple, device) -> torch.Tensor:
    """`values` as an int64 tensor on `device`, made once a device: a
    host-to-device copy on each call would stall the stream."""
    key = (values, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.tensor(values, device=device)
    return t


def adjugate3(A: torch.Tensor):
    """The adjugate of (..., 3, 3) A as (..., 9) row-major cofactors and
    its determinant a00·c00 + a01·c10 + a02·c20 (each cofactor one
    product minus another, elementwise: the rounding of the written-out
    formula, in four gathers)."""
    a = A.reshape(A.shape[:-2] + (9,))
    g = a.index_select(-1, index_table(_ADJ3, A.device)).unflatten(-1, (4, 9))
    c = g[..., 0, :] * g[..., 1, :] - g[..., 2, :] * g[..., 3, :]
    det = a[..., 0] * c[..., 0] + a[..., 1] * c[..., 3] + a[..., 2] * c[..., 6]
    return c, det


def _lm_inv2(A):
    a = A.reshape(A.shape[:-2] + (4,))
    det = a[..., 0] * a[..., 3] - a[..., 1] * a[..., 2]
    g = a.index_select(-1, index_table(_ADJ2, A.device))
    adj = torch.cat([g[..., :1], -g[..., 1:3], g[..., 3:]], dim=-1)
    return (adj / det[..., None]).reshape(A.shape)


def _lm_inv3(A):
    c, det = adjugate3(A)
    return (c / det[..., None]).reshape(A.shape)


def lm_spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """Recursive block-Schur SPD inverse of (..., n, n): split at k=n//2,
    invert A11 and the Schur complement S = A22 − A21 A11⁻¹ A12
    recursively, closed forms at n ≤ 3, symmetrize each level."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    if n == 2:
        return _lm_inv2(A)
    if n == 3:
        return _lm_inv3(A)
    k = n // 2
    A11, A12 = A[..., :k, :k], A[..., :k, k:]
    A21, A22 = A[..., k:, :k], A[..., k:, k:]
    iA11 = lm_spd_inverse(A11)
    iA11_A12 = lm_matmul(iA11, A12)
    S = A22 - lm_matmul(A21, iA11_A12)
    iS = lm_spd_inverse(S)
    B12 = -lm_matmul(iA11_A12, iS)
    B11 = iA11 - lm_matmul(B12, lm_matmul(A21, iA11))
    B21 = lm_transpose(B12)
    top = torch.cat([B11, B12], dim=-1)
    bot = torch.cat([B21, iS], dim=-1)
    out = torch.cat([top, bot], dim=-2)
    return 0.5 * (out + lm_transpose(out))


# batch-first both ways here (see the module docstring)
spd_inverse = lm_spd_inverse


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹ b for SPD A (..., n, n), b (..., n, m), through
    `spd_inverse`, as the JAX package's `spd_solve` forms it."""
    return spd_inverse(A) @ b


def cho_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor L of (..., n, n) SPD A (A = L Lᵀ). Where A is
    not positive definite (or holds a NaN) the factor's lower triangle is
    NaN, as `jax.scipy.linalg.cho_factor` reads there (its upper factor
    NaN on and above the diagonal): nothing raises, and a solve with it
    gives NaN, which the line search rejects."""
    L, info = torch.linalg.cholesky_ex(A)
    n = A.shape[-1]
    tril = torch.ones((n, n), dtype=torch.bool, device=A.device).tril()
    return L.masked_fill((info != 0)[..., None, None] & tril, float("nan"))


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹ b from A's lower Cholesky factor L (`cho_factor`),
    b (..., n, m)."""
    return torch.cholesky_solve(b, L)
