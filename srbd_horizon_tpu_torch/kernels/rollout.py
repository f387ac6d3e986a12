"""K3: the SRBD multiple-shooting rollout over a vector of step sizes.

`srbd_rollout` is the wrapper the solver calls. A CPU tensor goes to
`srbd_rollout_plain`, the PyTorch transcription of the JAX package's
`MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410) for the
SRBD Euler step, evaluated for every α at once; a CUDA tensor launches
the hand-written kernel in `csrc/srbd_rollout.cu`, or raises.

Per member and α, from x̂₀ = x0, for n = 0 … ns−1:

    uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
    x̂ₙ₊₁ = x̂ₙ + dt·srbd_xdot(x̂ₙ, uₙ) − (1 − α) dₙ

The SRBD step reads no OCP parameter, only the scaled mass and inertia.
Outputs are Xn (nα, B, ns+1, nx) and Un (nα, B, ns, nu).
"""

from __future__ import annotations

import ctypes

import torch

from srbd_horizon_tpu_torch.kernels.build import check_tensor, library
from srbd_horizon_tpu_torch.math.linalg import lm_matvec
from srbd_horizon_tpu_torch.models.srbd import srbd_xdot

# the function K3 replaces (an XLA-fused scan; the JAX package wrote no
# Pallas kernel for it)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1391"
SOURCE = "srbd_horizon_tpu_torch/csrc/srbd_rollout.cu"


def srbd_rollout_plain(x0, X, U, ks, Ks, d, alphas, dt: float,
                       m_scaled: float, inertia_scaled):
    """Plain PyTorch rollout. x0 (B,nx), X (B,ns+1,nx), U (B,ns,nu),
    ks (B,ns,nu), Ks (B,ns,nu,nx), d (B,ns,nx), alphas (nα,)."""
    nA = alphas.shape[0]
    Bsz, ns, nx = d.shape
    consts = dict(m_scaled=m_scaled, inertia_scaled=inertia_scaled)
    a = alphas[:, None, None]                          # (nα, 1, 1)
    xhat = x0.expand(nA, Bsz, nx)
    Xs, Us = [], []
    for n in range(ns):
        u = U[:, n] + a * ks[:, n] + lm_matvec(Ks[:, n], xhat - X[:, n])
        xnext = xhat + dt * srbd_xdot(xhat, u, consts) - (1.0 - a) * d[:, n]
        Xs.append(xhat)
        Us.append(u)
        xhat = xnext
    Xs.append(xhat)
    return torch.stack(Xs, dim=2), torch.stack(Us, dim=2)


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def _kernel_fn(dtype):
    lib = library("srbd_rollout")
    fn = lib.srbd_rollout_f32 if dtype == torch.float32 else lib.srbd_rollout_f64
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 4 + [_D, _D] + [_P] * 3
        fn.restype = _I
    return fn


def srbd_rollout(x0, X, U, ks, Ks, d, alphas, dt: float, m_scaled: float,
                 inertia_scaled):
    """K3. Same contract as `srbd_rollout_plain`; launches the CUDA kernel
    for CUDA tensors (and counts the launch in `srbd_rollout.launches`)."""
    if d.device.type == "cpu":
        return srbd_rollout_plain(x0, X, U, ks, Ks, d, alphas, dt, m_scaled,
                                  inertia_scaled)
    if d.device.type != "cuda":
        raise ValueError(f"srbd_rollout runs on cpu or cuda, got {d.device}")
    dtype, dev = d.dtype, d.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"srbd_rollout takes float32 or float64, got {dtype}")
    Bsz, ns, nx = d.shape
    nu = U.shape[-1]
    nc = (nx - 13) // 6
    if nx != 13 + 6 * nc or nu != 6 * nc:
        raise ValueError(f"not an SRBD layout: nx={nx}, nu={nu}")
    nA = alphas.shape[0]
    check_tensor("x0", x0, (Bsz, nx), dtype, dev)
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    check_tensor("ks", ks, (Bsz, ns, nu), dtype, dev)
    check_tensor("Ks", Ks, (Bsz, ns, nu, nx), dtype, dev)
    check_tensor("d", d, (Bsz, ns, nx), dtype, dev)
    check_tensor("alphas", alphas, (nA,), dtype, dev)
    check_tensor("inertia_scaled", inertia_scaled, (3, 3), dtype, dev)
    Xn = torch.empty((nA, Bsz, ns + 1, nx), dtype=dtype, device=dev)
    Un = torch.empty((nA, Bsz, ns, nu), dtype=dtype, device=dev)
    fn = _kernel_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            x0.data_ptr(), X.data_ptr(), U.data_ptr(), ks.data_ptr(),
            Ks.data_ptr(), d.data_ptr(), alphas.data_ptr(),
            inertia_scaled.data_ptr(),
            Bsz, ns, nc, nA, float(dt), float(m_scaled),
            Xn.data_ptr(), Un.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"srbd_rollout kernel failed: CUDA error {err}")
    srbd_rollout.launches += 1
    return Xn, Un


srbd_rollout.launches = 0
