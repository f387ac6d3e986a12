"""K3: the SRBD line-search trial — rollout, cost and Armijo test — over a
vector of step sizes.

`srbd_trial` is the wrapper the solver calls. A CPU tensor goes to
`srbd_trial_plain`: `srbd_rollout_plain`, the PyTorch transcription of
the JAX package's `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:
1391-1410) for the problem's step (`SRBDTerms.step`: Euler, RK2 or RK4)
evaluated for every α at once, then
the trial's `total_cost` and Armijo test (:843-853); a CUDA tensor
launches the hand-written kernel in `csrc/srbd_rollout.cu`, which does all
three in one launch, or raises.

Per member and α, from x̂₀ = x0, for n = 0 … ns−1:

    uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
    x̂ₙ₊₁ = step(x̂ₙ, uₙ) − (1 − α) dₙ     (Euler: x̂ₙ + dt·srbd_xdot(x̂ₙ, uₙ))

then cost = Σₙ‖ρ(x̂ₙ, uₙ)‖² + ‖ρ_N(x̂_N)‖², merit = cost + ν(1−α)²D and
ok = merit0 − merit ≥ β·max(expected, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min,
expected = −(αΔV₁ + α²ΔV₂) + (2α − α²)νD. Outputs are Xn (nα, B, ns+1, nx),
Un (nα, B, ns, nu), and cost, merit, ok (nα, B).

`srbd_evaluate`, the second entry of the same source, evaluates a given
plan with no rollout: per member the cost Σₙ‖ρ(Xₙ, Uₙ)‖² + ‖ρ_N(X_N)‖² and
the largest |step(Xₙ, Uₙ) − Xₙ₊₁| (NaN if any entry is NaN), what the
JAX package's solve computes with `jax.vmap(total_cost)` and
`jax.vmap(_true_defects)` (msddp.py:1222, :1240, :1484-1490). Given x0
(B, nx), it evaluates the plan with node 0 pinned to x0 and returns that
plan as a third output, `X.clone()` with `X[:, 0] = x0` (the solve's pin,
msddp.py:1221), written by the same launch. Its plain twin
`srbd_evaluate_plain` is `SRBDTerms.total_cost` and the problem's step.

Both run at the (topology, step) instances of `linearize.KERNEL_SHAPES`
(the Kangaroo's, the quadruped's, the point-feet biped's, the
square-feet biped's and the line-feet quadruped's, each under Euler, RK2
and RK4) on CUDA tensors and raise ValueError for others;
CPU tensors take the twins at any size.
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
from srbd_horizon_tpu_torch.kernels.linearize import (
    KERNEL_SHAPES,
    OCCUPANCY_FIELDS,
    STEPS,
    check_kernel_shape,
    kernel_params,
    shape_index,
)
from srbd_horizon_tpu_torch.math.linalg import lm_matvec
from srbd_horizon_tpu_torch.models.srbd import srbd_xdot
from srbd_horizon_tpu_torch.ocp import integrators

# the functions K3 replaces (an XLA-fused scan and the trial's cost and
# Armijo test; the JAX package wrote no Pallas kernel for them)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1391"
SOURCE = "srbd_horizon_tpu_torch/csrc/srbd_rollout.cu"
# the functions srbd_evaluate replaces (the solve's vmapped total_cost and
# _true_defects, XLA-fused)
EVALUATE_REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1222"


def step_fn(xdot, dt: float, step: str = "EULER"):
    """x⁺ = step(x, u): the integrator `step` (EULER, RK2, RK4;
    ocp/integrators.py) of `xdot(x, u)` over dt."""
    discrete = integrators.BY_NAME[step](lambda x, u, p: xdot(x, u))
    return lambda x, u: discrete(x, u, None, dt)


def rollout_plain(x0, X, U, ks, Ks, d, alphas, dt: float, xdot,
                  step: str = "EULER"):
    """Plain PyTorch rollout under the step `step` of `xdot(x, u)`. x0
    (B,nx), X (B,ns+1,nx), U (B,ns,nu), ks (B,ns,nu), Ks (B,ns,nu,nx),
    d (B,ns,nx), alphas (nα,)."""
    f = step_fn(xdot, dt, step)
    nA = alphas.shape[0]
    Bsz, ns, nx = d.shape
    a = alphas[:, None, None]                          # (nα, 1, 1)
    xhat = x0.expand(nA, Bsz, nx)
    Xs, Us = [], []
    for n in range(ns):
        u = U[:, n] + a * ks[:, n] + lm_matvec(Ks[:, n], xhat - X[:, n])
        xnext = f(xhat, u) - (1.0 - a) * d[:, n]
        Xs.append(xhat)
        Us.append(u)
        xhat = xnext
    Xs.append(xhat)
    return torch.stack(Xs, dim=2), torch.stack(Us, dim=2)


def srbd_rollout_plain(x0, X, U, ks, Ks, d, alphas, dt: float,
                       m_scaled: float, inertia_scaled, step: str = "EULER"):
    """Plain PyTorch rollout of the SRBD problem under `step`
    (`rollout_plain`)."""
    consts = dict(m_scaled=m_scaled, inertia_scaled=inertia_scaled)
    return rollout_plain(x0, X, U, ks, Ks, d, alphas, dt,
                         lambda x, u: srbd_xdot(x, u, consts), step)


def armijo_plain(new_cost, alphas, merit0, D, dV1, dV2, nu_w: float,
                 beta: float, alpha_min: float):
    """The trial's merit (nα, B) of the costs `new_cost` (nα, B) and its
    Armijo flag against the model's predicted reduction."""
    a = alphas[:, None]
    new_merit = new_cost + nu_w * (1.0 - a) ** 2 * D
    expected = -(a * dV1 + a ** 2 * dV2) + (2.0 * a - a ** 2) * nu_w * D
    ok = (
        ((merit0 - new_merit) >= beta * torch.clamp(expected, min=1e-16))
        & torch.isfinite(new_merit)
        & (a >= alpha_min)
    )
    return new_merit, ok


def srbd_trial_plain(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1,
                     dV2, terms, dt: float, wc: float, nu_w: float,
                     beta: float, alpha_min: float):
    """Plain PyTorch K3: `srbd_rollout_plain`, the cost Σ‖ρ‖² of each rolled
    plan (`terms` is the problem's `SRBDTerms`, wc = √w_c) and the Armijo
    test. params leaves (B,ns+1,dim); merit0, D, dV1, dV2 (B,)."""
    Xn, Un = srbd_rollout_plain(x0, X, U, ks, Ks, d, alphas, dt,
                                terms.m_scaled, terms.inertia_scaled,
                                terms.step)
    new_cost = terms.total_cost(Xn, Un, params, wc)           # (nα, B)
    new_merit, ok = armijo_plain(new_cost, alphas, merit0, D, dV1, dV2, nu_w,
                                 beta, alpha_min)
    return Xn, Un, new_cost, new_merit, ok


def evaluate_plain(X, U, dt: float, xdot, cost, x0=None, step: str = "EULER"):
    """The cost `cost(X)` (B,) of each plan and its largest |defect| (B,)
    under the step `step` of `xdot(x, u)` (NaN kept); given x0, of the plan
    with node 0 pinned to x0, returned third."""
    if x0 is not None:
        X = X.clone()
        X[..., 0, :] = x0
    ns = U.shape[-2]
    x = X[..., :ns, :]
    xnext = step_fn(xdot, dt, step)(x, U)
    defect_max = torch.amax(torch.abs(xnext - X[..., 1:, :]), dim=(-2, -1))
    return (cost(X), defect_max) if x0 is None else (cost(X), defect_max, X)


def srbd_evaluate_plain(X, U, params, terms, dt: float, wc: float, x0=None):
    """Plain PyTorch srbd_evaluate: the cost (B,) of each plan,
    `terms.total_cost`, and its largest |defect| (B,) under the problem's
    step, `torch.amax` of |step(Xₙ, Uₙ) − Xₙ₊₁| (NaN kept). X (B,ns+1,nx),
    U (B,ns,nu), params leaves (B,ns+1,dim). Given x0 (B,nx), node 0 of
    the plan is x0, and the pinned plan is returned third."""
    consts = dict(m_scaled=terms.m_scaled, inertia_scaled=terms.inertia_scaled)
    return evaluate_plain(
        X, U, dt, lambda x, u: srbd_xdot(x, u, consts),
        lambda Xp: terms.total_cost(Xp, U, params, wc), x0, terms.step)


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def _evaluate_setup(terms, nx: int, nu: int, dt: float, wc: float):
    """What srbd_evaluate checks and builds once for (terms, dtype): the
    instance's name, and the scalars as a ctypes array."""
    shape = check_kernel_shape("srbd_evaluate", terms, nx, nu)
    return shape, (_D * 24)(*terms.kernel_scalars(dt, wc))


def srbd_evaluate(X, U, params, terms, dt: float, wc: float, x0=None):
    """srbd_evaluate. Same contract as `srbd_evaluate_plain`; launches the
    CUDA kernel for CUDA tensors of the sizes and step of an instance in
    `KERNEL_SHAPES` (and counts the launch in `srbd_evaluate.launches` and
    in its instance's entry of `srbd_evaluate.shape_launches`), raises
    ValueError for others."""
    if X.device.type == "cpu":
        return srbd_evaluate_plain(X, U, params, terms, dt, wc, x0)
    Bsz, ns1, nx = X.shape
    ns, nu = ns1 - 1, U.shape[-1]
    dtype, dev = X.dtype, X.device
    shape, scalars = host_setup(terms, ("srbd_evaluate", dtype, nx, nu, dt, wc),
                                lambda: _evaluate_setup(terms, nx, nu, dt, wc))
    if dev.type != "cuda":
        raise ValueError(f"srbd_evaluate runs on cpu or cuda, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"srbd_evaluate takes float32 or float64, got {dtype}")
    if ns + 1 > 32:
        raise ValueError(f"srbd_evaluate takes at most 31 stage nodes, got {ns}")
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    if x0 is not None:                       # its rows may lie apart
        check_tensor("x0", x0, (Bsz, nx), dtype, dev, rows=True)
    pt = kernel_params(params, Bsz, ns, terms.nc, dtype, dev)
    cost = torch.empty((Bsz,), dtype=dtype, device=dev)
    dmax = torch.empty((Bsz,), dtype=dtype, device=dev)
    Xp = None if x0 is None else torch.empty_like(X)
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    fn = _evaluate_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(X.data_ptr(), U.data_ptr(),
                 None if x0 is None else x0.data_ptr(),
                 0 if x0 is None else x0.stride(0), ptrs, Bsz, ns,
                 terms.nc, terms.contact_model, terms.number_of_legs,
                 STEPS.index(terms.step), scalars,
                 cost.data_ptr(), dmax.data_ptr(),
                 None if Xp is None else Xp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"srbd_evaluate kernel failed: CUDA error {err}")
    srbd_evaluate.launches += 1
    srbd_evaluate.shape_launches[shape] += 1
    return (cost, dmax) if Xp is None else (cost, dmax, Xp)


srbd_evaluate.launches = 0
# the launches of each (topology, step) instance, by its KERNEL_SHAPES name
srbd_evaluate.shape_launches = dict.fromkeys(KERNEL_SHAPES, 0)
_evaluate_fns = {}


def _evaluate_fn(dtype):
    fn = _evaluate_fns.get(dtype)
    if fn is None:
        lib = library("srbd_rollout")
        fn = (lib.srbd_evaluate_f32 if dtype == torch.float32
              else lib.srbd_evaluate_f64)
        fn.argtypes = [_P] * 3 + [_I, _P] + [_I] * 6 + [_P] * 5
        fn.restype = _I
        _evaluate_fns[dtype] = fn
    return fn


def evaluate_occupancy(ns: int, dtype=torch.float32, shape: str = "kangaroo"):
    """srbd_evaluate's occupancy at the shape `shape` (a
    `linearize.KERNEL_SHAPES` name) and ns stage nodes for tensors of
    `dtype`: blocks resident on one SM, warps and shared memory bytes a
    block, registers and local (spilled) bytes a thread."""
    return occupancy_query("srbd_rollout", "srbd_evaluate_occupancy",
                           EVALUATE_OCCUPANCY_FIELDS, shape_index(shape),
                           int(dtype == torch.float64), ns)


# K3's shared memory (csrc/srbd_rollout.cu): a warp's ring of RING node
# buffers (K, U, k, X, d and the packed parameter row, each node's rounded
# to 16 bytes), then x̂, x̂ − X, u and, under RK, the stage point; as many
# (member, α) warps a block as fit MAX_SMEM, four at most
RING = 3
TRIAL_WARPS = 4
MAX_SMEM = 232448


def trial_layout(dtype=torch.float32, shape: str = "kangaroo") -> dict:
    """K3's block at the shape `shape` for tensors of `dtype`, as
    `NodeBuf`, `TrialWarp` and `trial_warps` of the .cu reckon it: values
    a node buffer and a warp, warps a block and the block's bytes."""
    z = KERNEL_SHAPES[shape]
    E = torch.finfo(dtype).bits // 8
    vec = 16 // E
    up = lambda v: -(-v // vec) * vec
    nx, nu, nc = z["nx"], z["nu"], z["nc"]
    node = up(nu * nx + 2 * nu + 2 * nx + 12 + 2 * nc)
    scratch = nx if z["step"] != "EULER" else 0
    warp = up(RING * node + 2 * nx + nu + scratch)
    warps = next(w for w in (TRIAL_WARPS, 2, 1)
                 if w * warp * E <= MAX_SMEM or w == 1)
    return dict(node_values=node, warp_values=warp, warps=warps,
                bytes=warps * warp * E)


def trial_occupancy(dtype=torch.float32, shape: str = "kangaroo"):
    """K3's occupancy at the shape `shape` for tensors of `dtype`
    (`linearize.OCCUPANCY_FIELDS`)."""
    return occupancy_query("srbd_rollout", "srbd_trial_occupancy",
                           OCCUPANCY_FIELDS, shape_index(shape),
                           int(dtype == torch.float64))


def _kernel_fn(dtype):
    lib = library("srbd_rollout")
    fn = lib.srbd_trial_f32 if dtype == torch.float32 else lib.srbd_trial_f64
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 12 + [_I] * 7 + [_P] + [_D] * 3 + [_P] * 6)
        fn.restype = _I
    return fn


def srbd_trial(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1, dV2,
               terms, dt: float, wc: float, nu_w: float, beta: float,
               alpha_min: float):
    """K3. Same contract as `srbd_trial_plain`; launches the CUDA kernel
    for CUDA tensors of the sizes and step of an instance in
    `KERNEL_SHAPES` (and counts the launch in `srbd_trial.launches` and in
    its instance's entry of `srbd_trial.shape_launches`), raises ValueError
    for others."""
    if d.device.type == "cpu":
        return srbd_trial_plain(x0, X, U, ks, Ks, d, alphas, params, merit0,
                                D, dV1, dV2, terms, dt, wc, nu_w, beta,
                                alpha_min)
    Bsz, ns, nx = d.shape
    nc, nu = terms.nc, U.shape[-1]
    shape = check_kernel_shape("srbd_trial", terms, nx, nu)
    if d.device.type != "cuda":
        raise ValueError(f"srbd_trial runs on cpu or cuda, got {d.device}")
    dtype, dev = d.dtype, d.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"srbd_trial takes float32 or float64, got {dtype}")
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
    pt = kernel_params(params, Bsz, ns, nc, dtype, dev)
    Xn = torch.empty((nA, Bsz, ns + 1, nx), dtype=dtype, device=dev)
    Un = torch.empty((nA, Bsz, ns, nu), dtype=dtype, device=dev)
    cost = torch.empty((nA, Bsz), dtype=dtype, device=dev)
    merit = torch.empty((nA, Bsz), dtype=dtype, device=dev)
    ok = torch.empty((nA, Bsz), dtype=torch.bool, device=dev)
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    scalars = (_D * 24)(*terms.kernel_scalars(dt, wc))
    fn = _kernel_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            x0.data_ptr(), X.data_ptr(), U.data_ptr(), ks.data_ptr(),
            Ks.data_ptr(), d.data_ptr(), alphas.data_ptr(), ptrs,
            merit0.data_ptr(), D.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
            Bsz, ns, nc, terms.contact_model, terms.number_of_legs,
            STEPS.index(terms.step), nA,
            scalars, float(nu_w), float(beta), float(alpha_min),
            Xn.data_ptr(), Un.data_ptr(), cost.data_ptr(), merit.data_ptr(),
            ok.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"srbd_trial kernel failed: CUDA error {err}")
    srbd_trial.launches += 1
    srbd_trial.shape_launches[shape] += 1
    return Xn, Un, cost, merit, ok


srbd_trial.launches = 0
# the launches of each (topology, step) instance, by its KERNEL_SHAPES name
srbd_trial.shape_launches = dict.fromkeys(KERNEL_SHAPES, 0)
