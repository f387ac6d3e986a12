"""K5: the closed-form sliced linearization of the isrbd AL inner problem.

`isrbd_linearize` is the wrapper the solver calls. A CPU tensor goes to
`isrbd_linearize_plain`, the batched closed form in plain PyTorch (no
`torch.func`); a CUDA tensor launches the hand-written kernel in
`csrc/isrbd_linearize.cu`, or raises.

Both compute what the JAX package's `MSDDP._linearize_sliced`
(srbd_horizon_tpu/solvers/msddp.py:273-344) computes with `jax.jacfwd`
under `vmap` on the AL inner OCP (srbd_horizon_tpu/solvers/alddp.py:
215-256), in the batch-first layout K1 reads, per member b and node n:

    Sx  = (A − I)[rx]   (B,ns,|rx|,nx)     Bs  = B[ru][:, uc]  (B,ns,|ru|,|uc|)
    Jxp = (∂ρ/∂x)[gx]   (B,ns,|gx|,nx)     Jup = (∂ρ/∂u)[gu]   (B,ns,|gu|,nu)
    ρ   = the inner stage stack (B,ns,nr)  d   = rk2(x, u) − X[n+1]  (B,ns,nx)
    rt  = the inner terminal stack (B,nt)  Jt  = ∂rt/∂x  (B,nt,nx)

The dynamics is RK2 of a double integrator: with F = ∂ẋ/∂x (nonzero only
in the position rows: identity blocks for ṙ and ċ, and ∂ȯ/∂o = ½Ω(ω),
∂ȯ/∂ω = ½Ξ(o) of ȯ = ½(ω,0)⊗o) and G = ∂ẋ/∂u (a constant selection of the
acceleration inputs onto the velocity rows), x_mid = x + dt/2·ẋ(x, u),

    A = I + dt·F(x_mid)·(I + dt/2·F(x))      B = dt·(G + dt/2·F(x_mid)·G)

so only the quaternion rows of A − I carry products. The residual rows
are weights and selections, the equality rows S_j√(ρw_j) times the
Jacobian of h (selections, the LIP block m·(I on r̈, −η² on r, +η²/nc on
c_xy), and the Newton–Euler block with ∂Iw_j = R_j I Rᵀ + R I R_jᵀ, R_j the
derivative of the homogeneous `quat_to_rot`), and each one-sided row
±√ρ times its cone face or unit vector where the row is active (the
derivative of max(0, ·) at exactly 0 is ½, as `jax.jacfwd` takes it).

Parameters: the wrapper reads the padded `al_*` tensors that
`ALDDP._params_with_multipliers` materialises, as the JAX package does;
the kernel never sees the `ALState`.

What bounds the kernel on an H100: bytes — a member-node writes ~6.9k
values and reads ~0.43k, against a few thousand FLOP (the note in the
.cu gives the design).

K5, K6, isrbd_evaluate, K7 and K8 are compiled for two sets of sizes, the
AL inner problems of the Kangaroo's line feet and of the quadruped's point
feet (`isrbd::KangarooAlShape` and `isrbd::QuadAlShape` in
csrc/isrbd_common.cuh, `KERNEL_SHAPES` here); their wrappers raise
ValueError, naming the sizes, for CUDA tensors of any other, and take the
plain twin for CPU tensors of any sizes.
"""

from __future__ import annotations

import ctypes

import torch

from srbd_horizon_tpu_torch.kernels.build import (
    check_tensor,
    library,
    occupancy_query,
)
from srbd_horizon_tpu_torch.kernels.linearize import _drot
from srbd_horizon_tpu_torch.math.quat import quat_to_rot, skew
from srbd_horizon_tpu_torch.problems.isrbd_al import (
    PARAM_KEYS,
    one_sided_slopes,
)

# the function K5 replaces (jacfwd under vmap on the AL inner OCP,
# XLA-fused; the JAX package wrote no Pallas kernel for it)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:273"
SOURCE = "srbd_horizon_tpu_torch/csrc/isrbd_linearize.cu"
N_TRACK = 15       # rows of the outer terminal residual

# The sizes K5, K6, isrbd_evaluate, K7 and K8 are compiled for, in the order
# of the shape structs of csrc/isrbd_common.cuh (KangarooAlShape,
# QuadAlShape): the AL inner problem of build_isrbd_problem with the
# Kangaroo's line feet and with the quadruped's point feet. n_par is the
# packed parameter row (the widths of PARAM_KEYS); the row counts are K5's
# (`RiccatiRows.from_ocp` of the inner OCP, K1's isrbd_al and
# isrbd_al_quadruped instantiations).
KERNEL_SHAPES = {
    "kangaroo": dict(nc=4, cm=2, n_legs=2, nx=37, nu=30, n_rho=240,
                     n_term=101, n_eq=21, n_eq_T=12, n_in=20, n_par=357,
                     n_rx=19, n_ru=37, n_gx=60, n_gu=103, n_b=9, n_uc=18),
    "quadruped": dict(nc=4, cm=1, n_legs=4, nx=37, nu=30, n_rho=236,
                      n_term=97, n_eq=17, n_eq_T=8, n_in=20, n_par=349,
                      n_rx=19, n_ru=37, n_gx=56, n_gu=103, n_b=9, n_uc=18),
}


def kernel_params(params, Bsz, ns, terms, dtype, device):
    """The parameter tensors a kernel reads, checked: each (B, ns+1, dim),
    contiguous, on `device` and of `dtype`."""
    out = []
    for key, dim in zip(PARAM_KEYS, terms.param_dims()):
        check_tensor(key, params[key], (Bsz, ns + 1, dim), dtype, device)
        out.append(params[key])
    return out


def kernel_sizes(terms, nx: int, nu: int, rows=None):
    """The sizes an isrbd kernel would be compiled for: the problem's, and
    with `rows` (a `RiccatiRows`) the row counts K5 emits."""
    o = terms.outer
    sizes = dict(nc=o.nc, cm=o.contact_model, n_legs=o.number_of_legs,
                 nx=nx, nu=nu, n_rho=terms.n_rho, n_term=terms.n_term,
                 n_eq=terms.n_eq, n_eq_T=terms.n_eq_T, n_in=terms.n_ineq,
                 n_par=sum(terms.param_dims()))
    if rows is not None:
        sizes.update(n_rx=len(rows.rx), n_ru=len(rows.ru), n_gx=len(rows.gx),
                     n_gu=len(rows.gu), n_b=len(rows.bx), n_uc=len(rows.uc))
    return sizes


def check_kernel_shape(name: str, terms, nx: int, nu: int, rows=None) -> str:
    """The name of the shape in `KERNEL_SHAPES` that has these sizes, once
    the cone rows are checked to be `A f ≤ 0`, bounded above only, as the
    kernels assume; ValueError, naming the sizes, if the isrbd kernels are
    compiled for none."""
    sizes = kernel_sizes(terms, nx, nu, rows)
    for shape, want in KERNEL_SHAPES.items():
        if sizes == {k: want[k] for k in sizes}:
            terms.check_cone_bounds()
            return shape
    known = "; ".join(f"{shape} {want}" for shape, want in KERNEL_SHAPES.items())
    later = (" (the constrained path at nc=8, the square-feet biped and the "
             "line-feet quadruped, is ROADMAP.md Queue 2 row 13)"
             if sizes.get("nc") == 8 else "")
    raise ValueError(
        f"{name} has no kernel for the sizes {sizes}; it is compiled for "
        f"{known} (csrc/isrbd_common.cuh){later}")


def shape_index(shape: str) -> int:
    """The position of `shape` in `KERNEL_SHAPES`, which the occupancy
    entries and K8's launchers take (`isrbd::with_shape`)."""
    if shape not in KERNEL_SHAPES:
        raise ValueError(f"no isrbd kernel shape {shape!r}; the shapes are "
                         f"{tuple(KERNEL_SHAPES)}")
    return list(KERNEL_SHAPES).index(shape)


def kernel_scalars(terms, dt: float):
    """Host doubles of csrc/isrbd_common.cuh (`isrbd::Consts`): the outer
    problem's scalars, then S, √w, S_T, √w_T."""
    return terms.outer.kernel_scalars(dt) + terms.row_scales()


def _quat_rate_jacobians(o, w):
    """∂ȯ/∂o = ½Ω(ω) (..., 4, 4) and ∂ȯ/∂ω = ½Ξ(o) (..., 4, 3) of
    ȯ = ½ (ω, 0) ⊗ o."""
    eye3 = torch.eye(3, dtype=o.dtype, device=o.device)
    Foo = o.new_zeros(o.shape[:-1] + (4, 4))
    Foo[..., 0:3, 0:3] = skew(w)
    Foo[..., 3, 0:3] = -w
    Foo[..., 0:3, 3] = w
    Fow = torch.cat([o[..., 3, None, None] * eye3 - skew(o[..., :3]),
                     -o[..., None, :3]], dim=-2)
    return 0.5 * Foo, 0.5 * Fow


def _terminal_jac(x, p, terms):
    """∂/∂x of the inner terminal stack, (..., nt, nx)."""
    o_ = terms.outer
    nc, nx = o_.nc, x.shape[-1]
    i_c, i_rdot, i_w, i_cdot = 7, 7 + 3 * nc, 10 + 3 * nc, 13 + 3 * nc
    lead = x.shape[:-1]
    J = x.new_zeros(lead + (terms.n_term, nx))
    Wo = p["Wo"][..., 0]
    J[..., 0, 2] = o_.w_rz
    for j in range(4):
        J[..., 1 + j, 3 + j] = Wo
    for j in range(3):
        J[..., 5 + j, i_rdot + j] = o_.w_rdot
        J[..., 8 + j, i_w + j] = o_.w_w
    _rel_jac(J, 11, o_, i_c)
    rho = p["al_rho"][..., 0:1]
    sr = torch.sqrt(rho)
    srw = sr if terms.sqw_eq_T is None else sr * terms.sqw_eq_T
    sc = srw if terms.eq_scale_T is None else srw * terms.eq_scale_T
    row = N_TRACK
    row = _relvel_jac(J, row, o_, i_cdot, sc, 0)
    for k in range(nc):
        J[..., row + k, i_c + 3 * k + 2] = sc[..., o_.n_relvel + k]
    row += nc
    mz = p["mask_lipzone"][..., 0]
    e = o_.n_relvel + nc
    J[..., row, 2] = sc[..., e] * mz
    for j in range(3):
        J[..., row + 1 + j, i_w + j] = sc[..., e + 1 + j] * mz
    row += 4
    c_ub, c_lb = one_sided_slopes(x, p["al_x_lb"], p["al_x_ub"],
                                  p["al_mu_x_lb"], p["al_mu_x_ub"], rho, sr)
    J[..., row:row + nx, :] = torch.diag_embed(c_ub)
    J[..., row + nx:row + 2 * nx, :] = torch.diag_embed(c_lb)
    return J


def _rel_jac(J, row, o_, i_c):
    """The four foot-pair rows (y, x of pair 1, y, x of pair 2)."""
    f0, f1, f2, f3 = o_.fpi
    for g, a, b, ax in ((0, f0, f2, 1), (1, f0, f2, 0),
                        (2, f1, f3, 1), (3, f1, f3, 0)):
        J[..., row + g, i_c + 3 * a + ax] -= o_.w_rel
        J[..., row + g, i_c + 3 * b + ax] += o_.w_rel


def _relvel_jac(J, row, o_, i_cdot, sc, off):
    cm = o_.contact_model
    q = off
    for leg in range(o_.number_of_legs):
        base = leg * cm
        for k in range(1, cm):
            for ax in (0, 1):
                J[..., row, i_cdot + 3 * base + ax] = sc[..., q]
                J[..., row, i_cdot + 3 * (base + k) + ax] = -sc[..., q]
                row += 1
                q += 1
    return row


def isrbd_linearize_plain(X, U, params, terms, rows, dt: float):
    """Plain PyTorch K5. X (B,ns+1,nx), U (B,ns,nu), params leaves
    (B,ns+1,dim) with the `al_*` keys, `terms` the inner problem's
    `ALTerms`, `rows` its `RiccatiRows`. Returns the dict Sx, Bs, Jxp, Jup,
    rho, rt, Jt, d (contiguous, batch-first)."""
    o_ = terms.outer
    Bsz, ns1, nx = X.shape
    ns, nu, nc = ns1 - 1, U.shape[-1], o_.nc
    i_c, i_rdot, i_w, i_cdot = 7, 7 + 3 * nc, 10 + 3 * nc, 13 + 3 * nc
    n_res, n_in = o_.n_res, terms.n_ineq
    nr = terms.n_rho
    idx = rows.index(X.device)
    lead = (Bsz, ns)
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)

    x = X[:, :ns]
    p = {k: params[k][:, :ns] for k in PARAM_KEYS}
    s, i = o_.split(x, U)
    r, o, c, w = s["r"], s["o"], s["c"], s["w"]
    f, wdot = i["f"], i["wdot"]

    # ---- RK2 double integrator ----
    k1 = o_.xdot(x, U)
    xm = x + 0.5 * dt * k1
    d = (x + dt * o_.xdot(xm, U)) - X[:, 1:]
    Foo, Fow = _quat_rate_jacobians(o, w)
    Foo_m, Fow_m = _quat_rate_jacobians(xm[..., 3:7], xm[..., i_w:i_w + 3])
    S = X.new_zeros(lead + (nx, nx))
    S[..., 0:3, i_rdot:i_rdot + 3] = dt * eye3
    S[..., i_c:i_rdot, i_cdot:] = dt * torch.eye(3 * nc, dtype=X.dtype,
                                                 device=X.device)
    S[..., 3:7, 3:7] = dt * (Foo_m + (0.5 * dt) * (Foo_m @ Foo))
    S[..., 3:7, i_w:i_w + 3] = dt * (Fow_m + (0.5 * dt) * (Foo_m @ Fow))
    Bm = X.new_zeros(lead + (nx, nu))
    h2 = dt * (0.5 * dt)
    Bm[..., 0:3, 0:3] = h2 * eye3
    Bm[..., 3:7, 3:6] = h2 * Fow_m
    Bm[..., i_rdot:i_rdot + 3, 0:3] = dt * eye3
    Bm[..., i_w:i_w + 3, 3:6] = dt * eye3
    for k in range(nc):
        for j in range(3):
            Bm[..., i_c + 3 * k + j, 6 + 6 * k + j] = h2
            Bm[..., i_cdot + 3 * k + j, 6 + 6 * k + j] = dt

    # ---- the inner stage stack's Jacobians ----
    Jx = X.new_zeros(lead + (nr, nx))
    Ju = X.new_zeros(lead + (nr, nu))
    mt = p["mask_track"][..., 0]
    Wo = p["Wo"][..., 0]
    Jx[..., 0, 2] = mt * o_.w_rz
    for j in range(4):
        Jx[..., 1 + j, 3 + j] = mt * Wo
    for j in range(3):
        Jx[..., 5 + j, i_rdot + j] = mt * o_.w_rdot
        Jx[..., 8 + j, i_w + j] = mt * o_.w_w
    n_qddot = 6 + 3 * nc
    for j in range(6):
        Ju[..., 11 + j, j] = o_.w_qddot
    for k in range(nc):
        for j in range(3):
            Ju[..., 17 + 3 * k + j, 6 + 6 * k + j] = o_.w_qddot
            Ju[..., 15 + n_qddot + 3 * k + j, 9 + 6 * k + j] = o_.w_minf
    _rel_jac(Jx, 11 + n_qddot, o_, i_c)

    rho = p["al_rho"][..., 0:1]
    sr = torch.sqrt(rho)
    srw = sr if terms.sqw_eq is None else sr * terms.sqw_eq
    sc = srw if terms.eq_scale is None else srw * terms.eq_scale   # (B,ns,n_eq)
    row = _relvel_jac(Jx, n_res, o_, i_cdot, sc, 0)
    q = o_.n_relvel
    for k in range(nc):
        Jx[..., row + k, i_c + 3 * k + 2] = sc[..., q + k]
    row += nc
    q += nc
    # Newton–Euler: m(r̈ + g) − Σf ; Iw ω̇ + ω×(Iw ω) − Σ(c−r)×f
    ms = p["mask_srbd"][..., 0]
    R = quat_to_rot(o)
    RI = R @ o_.inertia
    Iw = RI @ R.transpose(-1, -2)
    hw = (Iw @ w[..., None])[..., 0]
    dR = _drot(o)
    dIw = (dR @ o_.inertia @ R.transpose(-1, -2)[..., None, :, :]
           + RI[..., None, :, :] @ dR.transpose(-1, -2))             # (...,4,3,3)
    v1 = (dIw @ wdot[..., None, :, None])[..., 0]
    v2 = (dIw @ w[..., None, :, None])[..., 0]
    wx = skew(w)
    ang_o = v1 + (wx[..., None, :, :] @ v2[..., None])[..., 0]       # (...,4,3)
    lin_s = (sc[..., q:q + 3] * ms[..., None])[..., None]            # (...,3,1)
    ang_s = (sc[..., q + 3:q + 6] * ms[..., None])[..., None]
    Ju[..., row:row + 3, 0:3] = lin_s * (o_.m * eye3)
    Jx[..., row + 3:row + 6, 0:3] = ang_s * (-skew(torch.sum(f, dim=-2)))
    Jx[..., row + 3:row + 6, 3:7] = ang_s * ang_o.transpose(-1, -2)
    Jx[..., row + 3:row + 6, i_w:i_w + 3] = ang_s * (wx @ Iw - skew(hw))
    Ju[..., row + 3:row + 6, 3:6] = ang_s * Iw
    for k in range(nc):
        Ju[..., row:row + 3, 9 + 6 * k:12 + 6 * k] = lin_s * (-eye3)
        Jx[..., row + 3:row + 6, i_c + 3 * k:i_c + 3 * k + 3] = (
            ang_s * skew(f[..., k, :]))
        Ju[..., row + 3:row + 6, 9 + 6 * k:12 + 6 * k] = (
            ang_s * (-skew(c[..., k, :] - r)))
    row += 6
    q += 6
    # LIP: m (r̈ − η²(r − zmp) + g), zmp = [mean c_xy, 0]
    lip_s = (sc[..., q:q + 3] * p["mask_lip"][..., 0:1])[..., None]
    Ju[..., row:row + 3, 0:3] = lip_s * (o_.m * eye3)
    Jx[..., row:row + 3, 0:3] = lip_s * (-(o_.m * o_.eta2) * eye3)
    for k in range(nc):
        for j in range(2):
            Jx[..., row + j, i_c + 3 * k + j] = (
                lip_s[..., j, 0] * (o_.m * o_.eta2 / nc))
    row += 3
    q += 3
    mz = p["mask_lipzone"][..., 0]
    Jx[..., row, 2] = sc[..., q] * mz
    for j in range(3):
        Jx[..., row + 1 + j, i_w + j] = sc[..., q + 1 + j] * mz
    row += 4
    # cones, then the x and u boxes
    ocp = terms.ocp
    c_ub, c_lb = one_sided_slopes(
        o_.stage_ineq(x, U, None), ocp.ineq_lb, ocp.ineq_ub, p["al_mu_lb"],
        p["al_mu_ub"], rho, sr)
    for slopes in (c_ub, c_lb):
        for k in range(nc):
            Ju[..., row + 5 * k:row + 5 * k + 5, 9 + 6 * k:12 + 6 * k] = (
                slopes[..., 5 * k:5 * k + 5, None] * o_.A_fc)
        row += n_in
    c_ub, c_lb = one_sided_slopes(x, p["al_x_lb"], p["al_x_ub"],
                                  p["al_mu_x_lb"], p["al_mu_x_ub"], rho, sr)
    Jx[..., row:row + nx, :] = torch.diag_embed(c_ub)
    Jx[..., row + nx:row + 2 * nx, :] = torch.diag_embed(c_lb)
    row += 2 * nx
    c_ub, c_lb = one_sided_slopes(U, p["al_u_lb"], p["al_u_ub"],
                                  p["al_mu_u_lb"], p["al_mu_u_ub"], rho, sr)
    Ju[..., row:row + nu, :] = torch.diag_embed(c_ub)
    Ju[..., row + nu:row + 2 * nu, :] = torch.diag_embed(c_lb)

    p_term = {k: params[k][:, ns] for k in PARAM_KEYS}
    xT = X[:, ns]
    return dict(
        Sx=S.index_select(-2, idx["rx"]).contiguous(),
        Bs=Bm.index_select(-2, idx["ru"]).index_select(-1, idx["uc"]).contiguous(),
        Jxp=Jx.index_select(-2, idx["gx"]).contiguous(),
        Jup=Ju.index_select(-2, idx["gu"]).contiguous(),
        rho=terms.stage_residual(x, U, p).contiguous(),
        rt=terms.terminal_residual(xT, p_term).contiguous(),
        Jt=_terminal_jac(xT, p_term, terms).contiguous(),
        d=d.contiguous(),
    )


_P = ctypes.c_void_p
_I = ctypes.c_int


def _kernel_fn(dtype):
    lib = library("isrbd_linearize")
    fn = lib.isrbd_linearize_f32 if dtype == torch.float32 else lib.isrbd_linearize_f64
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 11 + [_P] * 10
        fn.restype = _I
    return fn


def occupancy(dtype=torch.float32, shape: str = "kangaroo"):
    """K5's blocks resident on one SM of the current card
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), warps and shared
    memory bytes a block, at the shape `shape` for tensors of `dtype`."""
    return occupancy_query(
        "isrbd_linearize", "isrbd_linearize_occupancy",
        ("blocks_per_sm", "warps_per_block", "shared_memory_bytes"),
        shape_index(shape), int(dtype == torch.float64))


def isrbd_linearize(X, U, params, terms, rows, dt: float):
    """K5. Same contract as `isrbd_linearize_plain`; launches the CUDA
    kernel for CUDA tensors of the sizes of a shape in `KERNEL_SHAPES` (and
    counts the launch in `isrbd_linearize.launches`), raises ValueError for
    other sizes."""
    if X.device.type == "cpu":
        return isrbd_linearize_plain(X, U, params, terms, rows, dt)
    Bsz, ns1, nx = X.shape
    ns, nu = ns1 - 1, U.shape[-1]
    check_kernel_shape("isrbd_linearize", terms, nx, nu, rows)
    if X.device.type != "cuda":
        raise ValueError(f"isrbd_linearize runs on cpu or cuda, got {X.device}")
    dtype, dev = X.dtype, X.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"isrbd_linearize takes float32 or float64, got {dtype}")
    o_ = terms.outer
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    pt = kernel_params(params, Bsz, ns, terms, dtype, dev)
    n_rx, n_ru, n_gx, n_gu, n_b, n_uc = (
        len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu), len(rows.bx),
        len(rows.uc))
    nr, nt = terms.n_rho, terms.n_term
    if (max(rows.rx + rows.ru) >= nx or max(rows.gx + rows.gu) >= nr
            or max(rows.uc) >= nu):
        raise ValueError("row table out of range for this problem")
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    out = dict(Sx=new(Bsz, ns, n_rx, nx), Bs=new(Bsz, ns, n_ru, n_uc),
               Jxp=new(Bsz, ns, n_gx, nx), Jup=new(Bsz, ns, n_gu, nu),
               rho=new(Bsz, ns, nr), d=new(Bsz, ns, nx),
               rt=new(Bsz, nt), Jt=new(Bsz, nt, nx))
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    sc = kernel_scalars(terms, dt)
    scalars = (ctypes.c_double * len(sc))(*sc)
    fn = _kernel_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            X.data_ptr(), U.data_ptr(), ptrs, rows.packed(dev).data_ptr(),
            Bsz, ns, o_.nc, o_.contact_model, o_.number_of_legs,
            n_rx, n_ru, n_gx, n_gu, n_b, n_uc,
            scalars,
            *(out[k].data_ptr() for k in ("Sx", "Bs", "Jxp", "Jup", "rho",
                                           "d", "rt", "Jt")),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"isrbd_linearize kernel failed: CUDA error {err}")
    isrbd_linearize.launches += 1
    return out


isrbd_linearize.launches = 0
