"""K6: the line-search trial of the isrbd AL inner problem — rollout, cost
and Armijo test — over a vector of step sizes.

`isrbd_trial` is the wrapper the solver calls. A CPU tensor goes to
`isrbd_trial_plain`: `isrbd_rollout_plain`, the PyTorch transcription of
the JAX package's `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:
1391-1410) for the RK2 double integrator evaluated for every α at once,
then the trial's `total_cost` on the inner stacks and the Armijo test
(:843-853); a CUDA tensor launches the hand-written kernel in
`csrc/isrbd_rollout.cu`, which does all three in one launch, or raises.

Per member and α, from x̂₀ = x0, for n = 0 … ns−1:

    uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
    x̂ₙ₊₁ = rk2(x̂ₙ, uₙ) − (1 − α) dₙ

then cost = Σₙ‖ρ(x̂ₙ, uₙ)‖² + ‖ρ_N(x̂_N)‖² over the inner stage and
terminal stacks (problems/isrbd_al.py), merit = cost + ν(1−α)²D and
ok = merit0 − merit ≥ β·max(expected, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min,
expected = −(αΔV₁ + α²ΔV₂) + (2α − α²)νD. Outputs are Xn (nα, B, ns+1, nx),
Un (nα, B, ns, nu), and cost, merit, ok (nα, B).

`isrbd_evaluate`, the second entry of the same source, evaluates a given
plan with no rollout, on the same stacks and step: per member the cost
Σₙ‖ρ(Xₙ, Uₙ)‖² + ‖ρ_N(X_N)‖² and the largest |rk2(Xₙ, Uₙ) − Xₙ₊₁| (NaN if
any entry is NaN), what the JAX package's solve computes with
`jax.vmap(total_cost)` and `jax.vmap(_true_defects)` (msddp.py:1222, :1240,
:1484-1490) on the AL inner OCP. Given x0 (B, nx), it evaluates the plan
with node 0 pinned to x0 and returns that plan as a third output,
`X.clone()` with `X[:, 0] = x0` (the solve's pin, msddp.py:1221), written by
the same launch. Its plain twin `isrbd_evaluate_plain` is
`ALTerms.total_cost` and the RK2 step.

Both run on the sizes of `isrbd_linearize.KERNEL_SHAPES` on CUDA tensors
and raise ValueError, naming the sizes, on any other; CPU tensors take the
twins at any sizes.
"""

from __future__ import annotations

import ctypes

import torch

from srbd_horizon_tpu_torch.kernels.build import (
    EVALUATE_OCCUPANCY_FIELDS,
    check_tensor,
    host_setup,
    library,
    occupancy_query,
)
from srbd_horizon_tpu_torch.kernels.isrbd_linearize import (
    check_kernel_shape,
    kernel_params,
    kernel_scalars,
    shape_index,
)
from srbd_horizon_tpu_torch.kernels.rollout import armijo_plain
from srbd_horizon_tpu_torch.math.linalg import lm_matvec

# the functions K6 replaces (an XLA-fused scan and the trial's cost and
# Armijo test on the AL inner OCP; the JAX package wrote no Pallas kernel
# for them)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1391"
SOURCE = "srbd_horizon_tpu_torch/csrc/isrbd_rollout.cu"
# the functions isrbd_evaluate replaces (the solve's vmapped total_cost and
# _true_defects on the AL inner OCP, XLA-fused)
EVALUATE_REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1222"


def isrbd_rollout_plain(x0, X, U, ks, Ks, d, alphas, dt: float, xdot):
    """Plain PyTorch rollout. x0 (B,nx), X (B,ns+1,nx), U (B,ns,nu),
    ks (B,ns,nu), Ks (B,ns,nu,nx), d (B,ns,nx), alphas (nα,); `xdot(x, u)`
    is the double integrator."""
    nA = alphas.shape[0]
    Bsz, ns, nx = d.shape
    a = alphas[:, None, None]                          # (nα, 1, 1)
    xhat = x0.expand(nA, Bsz, nx)
    Xs, Us = [], []
    for n in range(ns):
        u = U[:, n] + a * ks[:, n] + lm_matvec(Ks[:, n], xhat - X[:, n])
        k1 = xdot(xhat, u)
        xnext = (xhat + dt * xdot(xhat + 0.5 * dt * k1, u)) - (1.0 - a) * d[:, n]
        Xs.append(xhat)
        Us.append(u)
        xhat = xnext
    Xs.append(xhat)
    return torch.stack(Xs, dim=2), torch.stack(Us, dim=2)


def isrbd_trial_plain(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1,
                      dV2, terms, dt: float, nu_w: float, beta: float,
                      alpha_min: float):
    """Plain PyTorch K6: `isrbd_rollout_plain`, the cost Σ‖ρ‖² of each
    rolled plan on the inner stacks (`terms` is the inner problem's
    `ALTerms`) and the Armijo test. params leaves
    (B,ns+1,dim); merit0, D, dV1, dV2 (B,)."""
    Xn, Un = isrbd_rollout_plain(x0, X, U, ks, Ks, d, alphas, dt,
                                 terms.outer.xdot)
    new_cost = terms.total_cost(Xn, Un, params)               # (nα, B)
    new_merit, ok = armijo_plain(new_cost, alphas, merit0, D, dV1, dV2, nu_w,
                                 beta, alpha_min)
    return Xn, Un, new_cost, new_merit, ok


def isrbd_evaluate_plain(X, U, params, terms, dt: float, x0=None):
    """Plain PyTorch isrbd_evaluate: the cost (B,) of each plan on the inner
    stacks, `terms.total_cost`, and its largest |defect| (B,) under the RK2
    step of the double integrator, `torch.amax` of |rk2(Xₙ, Uₙ) − Xₙ₊₁| (NaN
    kept). X (B,ns+1,nx), U (B,ns,nu), params leaves (B,ns+1,dim). Given x0
    (B,nx), node 0 of the plan is x0, and the pinned plan is returned
    third."""
    if x0 is not None:
        X = X.clone()
        X[..., 0, :] = x0
    ns = U.shape[-2]
    xdot = terms.outer.xdot
    x = X[..., :ns, :]
    k1 = xdot(x, U)
    step = x + dt * xdot(x + 0.5 * dt * k1, U)
    defect_max = torch.amax(torch.abs(step - X[..., 1:, :]), dim=(-2, -1))
    cost = terms.total_cost(X, U, params)
    return (cost, defect_max) if x0 is None else (cost, defect_max, X)


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def _evaluate_setup(terms, nx: int, nu: int, dt: float):
    """What isrbd_evaluate checks and builds once for (terms, dtype): the
    sizes and cone bounds, and the scalars as a ctypes array."""
    check_kernel_shape("isrbd_evaluate", terms, nx, nu)
    sc = kernel_scalars(terms, dt)
    return (_D * len(sc))(*sc)


def isrbd_evaluate(X, U, params, terms, dt: float, x0=None):
    """isrbd_evaluate. Same contract as `isrbd_evaluate_plain`; launches the
    CUDA kernel for CUDA tensors of the sizes of a shape in `KERNEL_SHAPES`
    (and counts the launch in `isrbd_evaluate.launches`), raises ValueError
    for other sizes."""
    if X.device.type == "cpu":
        return isrbd_evaluate_plain(X, U, params, terms, dt, x0)
    Bsz, ns1, nx = X.shape
    ns, nu = ns1 - 1, U.shape[-1]
    dtype, dev = X.dtype, X.device
    scalars = host_setup(terms, ("isrbd_evaluate", dtype, nx, nu, dt),
                         lambda: _evaluate_setup(terms, nx, nu, dt))
    if dev.type != "cuda":
        raise ValueError(f"isrbd_evaluate runs on cpu or cuda, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"isrbd_evaluate takes float32 or float64, got {dtype}")
    if ns + 1 > 32:
        raise ValueError(f"isrbd_evaluate takes at most 31 stage nodes, got {ns}")
    o_ = terms.outer
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    if x0 is not None:                       # its rows may lie apart
        check_tensor("x0", x0, (Bsz, nx), dtype, dev, rows=True)
    pt = kernel_params(params, Bsz, ns, terms, dtype, dev)
    cost = torch.empty((Bsz,), dtype=dtype, device=dev)
    dmax = torch.empty((Bsz,), dtype=dtype, device=dev)
    Xp = None if x0 is None else torch.empty_like(X)
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    fn = _evaluate_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(X.data_ptr(), U.data_ptr(),
                 None if x0 is None else x0.data_ptr(),
                 0 if x0 is None else x0.stride(0), ptrs, Bsz, ns, o_.nc,
                 o_.contact_model, o_.number_of_legs, scalars,
                 cost.data_ptr(), dmax.data_ptr(),
                 None if Xp is None else Xp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"isrbd_evaluate kernel failed: CUDA error {err}")
    isrbd_evaluate.launches += 1
    return (cost, dmax) if Xp is None else (cost, dmax, Xp)


isrbd_evaluate.launches = 0
_evaluate_fns = {}


def _evaluate_fn(dtype):
    fn = _evaluate_fns.get(dtype)
    if fn is None:
        lib = library("isrbd_rollout")
        fn = (lib.isrbd_evaluate_f32 if dtype == torch.float32
              else lib.isrbd_evaluate_f64)
        fn.argtypes = [_P] * 3 + [_I, _P] + [_I] * 5 + [_P] * 5
        fn.restype = _I
        _evaluate_fns[dtype] = fn
    return fn


def evaluate_occupancy(ns: int, dtype=torch.float32, shape: str = "kangaroo"):
    """isrbd_evaluate's occupancy at the shape `shape` and ns stage nodes
    for tensors of `dtype`: blocks resident on one SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), warps and shared
    memory bytes a block, registers and local (spilled) bytes a thread."""
    return occupancy_query("isrbd_rollout", "isrbd_evaluate_occupancy",
                           EVALUATE_OCCUPANCY_FIELDS, shape_index(shape),
                           int(dtype == torch.float64), ns)


def _kernel_fn(dtype):
    lib = library("isrbd_rollout")
    fn = lib.isrbd_trial_f32 if dtype == torch.float32 else lib.isrbd_trial_f64
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 12 + [_I] * 6 + [_P] + [_D] * 3 + [_P] * 6)
        fn.restype = _I
    return fn


def trial_occupancy(dtype=torch.float32, shape: str = "kangaroo"):
    """K6's blocks resident on one SM of the current card
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), the depth of its
    per-warp ring of node buffers, warps and shared memory bytes a block,
    at the shape `shape` for tensors of `dtype`."""
    return occupancy_query(
        "isrbd_rollout", "isrbd_trial_occupancy",
        ("blocks_per_sm", "ring_depth", "warps_per_block",
         "shared_memory_bytes"),
        shape_index(shape), int(dtype == torch.float64))


def isrbd_trial(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1, dV2,
                terms, dt: float, nu_w: float, beta: float, alpha_min: float):
    """K6. Same contract as `isrbd_trial_plain`; launches the CUDA kernel
    for CUDA tensors of the sizes of a shape in `KERNEL_SHAPES` (and counts
    the launch in `isrbd_trial.launches`), raises ValueError for other
    sizes."""
    if d.device.type == "cpu":
        return isrbd_trial_plain(x0, X, U, ks, Ks, d, alphas, params, merit0,
                                 D, dV1, dV2, terms, dt, nu_w, beta, alpha_min)
    Bsz, ns, nx = d.shape
    nu = U.shape[-1]
    check_kernel_shape("isrbd_trial", terms, nx, nu)
    if d.device.type != "cuda":
        raise ValueError(f"isrbd_trial runs on cpu or cuda, got {d.device}")
    dtype, dev = d.dtype, d.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"isrbd_trial takes float32 or float64, got {dtype}")
    o_ = terms.outer
    nA = alphas.shape[0]
    check_tensor("x0", x0, (Bsz, nx), dtype, dev)
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    check_tensor("ks", ks, (Bsz, ns, nu), dtype, dev)
    check_tensor("Ks", Ks, (Bsz, ns, nu, nx), dtype, dev)
    check_tensor("d", d, (Bsz, ns, nx), dtype, dev)
    check_tensor("alphas", alphas, (nA,), dtype, dev)
    for name, t in (("merit0", merit0), ("D", D), ("dV1", dV1), ("dV2", dV2)):
        check_tensor(name, t, (Bsz,), dtype, dev)
    for name, t in (("U", U), ("ks", ks), ("Ks", Ks)):   # two-element copies
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name} must start {2 * t.element_size()}-byte aligned")
    pt = kernel_params(params, Bsz, ns, terms, dtype, dev)
    Xn = torch.empty((nA, Bsz, ns + 1, nx), dtype=dtype, device=dev)
    Un = torch.empty((nA, Bsz, ns, nu), dtype=dtype, device=dev)
    cost = torch.empty((nA, Bsz), dtype=dtype, device=dev)
    merit = torch.empty((nA, Bsz), dtype=dtype, device=dev)
    ok = torch.empty((nA, Bsz), dtype=torch.bool, device=dev)
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    sc = kernel_scalars(terms, dt)
    scalars = (_D * len(sc))(*sc)
    fn = _kernel_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            x0.data_ptr(), X.data_ptr(), U.data_ptr(), ks.data_ptr(),
            Ks.data_ptr(), d.data_ptr(), alphas.data_ptr(), ptrs,
            merit0.data_ptr(), D.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
            Bsz, ns, o_.nc, o_.contact_model, o_.number_of_legs, nA,
            scalars, float(nu_w), float(beta), float(alpha_min),
            Xn.data_ptr(), Un.data_ptr(), cost.data_ptr(), merit.data_ptr(),
            ok.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"isrbd_trial kernel failed: CUDA error {err}")
    isrbd_trial.launches += 1
    return Xn, Un, cost, merit, ok


isrbd_trial.launches = 0
