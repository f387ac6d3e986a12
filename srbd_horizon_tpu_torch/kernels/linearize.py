"""K4: the closed-form sliced linearization of the SRBD problem.

`srbd_linearize` is the wrapper the solver calls. A CPU tensor goes to
`srbd_linearize_plain`, the batched closed form in plain PyTorch (no
`torch.func`); a CUDA tensor launches the hand-written kernel in
`csrc/srbd_linearize.cu`, or raises.

Both compute what the JAX package's `MSDDP._linearize_sliced`
(srbd_horizon_tpu/solvers/msddp.py:273-344) computes with `jax.jacfwd`
under `vmap`, in the batch-first layout K1 reads, per member b and node n:

    Sx  = (A − I)[rx]     (B,ns,|rx|,nx)    Bs  = B[ru]           (B,ns,|ru|,nu)
    Jxp = (∂ρ/∂x)[gx]     (B,ns,|gx|,nx)    Jup = (∂ρ/∂u)[gu]     (B,ns,|gu|,nu)
    ρ   = [residual; √w_c·eq]  (B,ns,nr)     d   = step(x, u) − X[n+1]  (B,ns,nx)
    rt  = terminal residual (B,15)          Jt  = ∂rt/∂x (B,15,nx)

with A = ∂step/∂x, B = ∂step/∂u of the problem's step (`SRBDTerms.step`)
and the row sets of `kernels/riccati.py::RiccatiRows`. Under Euler,
A = I + dt ∂ẋ/∂x and B = dt ∂ẋ/∂u; under RK2 and RK4 `step_jacobians`
composes them by the chain rule from ∂ẋ/∂x and ∂ẋ/∂u at each stage point
(x_s = x + c_s·dt·k_{s−1}, dk_s = F_x(x_s)(I + c_s·dt·dk_{s−1}) +
F_u(x_s)), and every row of B is live. The closed form is
srbd_horizon_tpu/problems/srbd.py::stage_jacobians (:236-375), except
∂ω̇/∂o, which that function takes by AD: here every column of ∂ω̇ is
Iw⁻¹ ∂b with Iw ω̇ = b = τ − ω×Iw ω, and for the quaternion columns
∂b/∂oⱼ = −∂Iwⱼ ω̇ − ω×(∂Iwⱼ ω), ∂Iwⱼ = Rⱼ I Rᵀ + R I Rⱼᵀ, Rⱼ the derivative
of the homogeneous (not normalized) `quat_to_rot`.

What bounds the kernel on an H100: bytes — a member-node writes 3,622
values (the quadruped 3,470, the point-feet biped 1,502; under RK the
Kangaroo 4,078) and reads ~120, against a few thousand FLOP a stage point
(the note in the .cu gives the design).

K3, K4 and srbd_evaluate are compiled for five SRBD topologies, the
Kangaroo's line feet, the point-feet quadruped's, the point-feet biped's,
the square-feet biped's (four contact points a foot, contact_model=4:
nc=8, nx=61, nu=48) and the line-feet quadruped's (two points a foot on
four legs, contact_model=2: nc=8, the same nx and nu; `srbd::KangarooShape`,
`srbd::QuadShape`, `srbd::PointFeetShape`, `srbd::SquareFeetShape`,
`srbd::LineFeetQuadShape` in csrc/srbd_common.cuh, `TOPOLOGIES` here),
each under the Euler, RK2 and RK4 steps (`KERNEL_SHAPES`, the fifteen
instances); their wrappers raise
ValueError, naming the sizes and the step, for CUDA tensors of any other
(an RK problem never reaches an Euler instance), and take the plain twin
for CPU tensors of any sizes.
"""

from __future__ import annotations

import ctypes

import torch

from srbd_horizon_tpu_torch.kernels.build import (
    check_tensor,
    library,
    occupancy_query,
)
from srbd_horizon_tpu_torch.math.quat import cross, quat_to_rot, skew, solve3x3
from srbd_horizon_tpu_torch.models.srbd import (
    split_srbd_input,
    split_srbd_state,
    srbd_xdot,
)

# the function K4 replaces (jacfwd under vmap, XLA-fused; the JAX package
# wrote no Pallas kernel for it)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:273"
SOURCE = "srbd_horizon_tpu_torch/csrc/srbd_linearize.cu"

# The topologies the SRBD kernels are compiled for, in the order of the
# shape structs of csrc/srbd_common.cuh (KangarooShape, QuadShape,
# PointFeetShape, SquareFeetShape, LineFeetQuadShape): build_srbd_problem
# with the Kangaroo's line feet, the quadruped's point feet, the point-feet
# biped, the square-feet biped (`SRBDConfig(contact_model=4,
# number_of_legs=2)`, four points a foot) and the line-feet quadruped
# (`SRBDConfig(contact_model=2, number_of_legs=4)`, two points a foot),
# under the Euler step. The row counts are K4's (`RiccatiRows.from_ocp` of
# each OCP).
TOPOLOGIES = {
    "kangaroo": dict(nc=4, cm=2, n_legs=2, nx=37, nu=24, n_rho=73, nt=15,
                     n_rx=22, n_ru=18, n_gx=34, n_gu=42),
    "quadruped": dict(nc=4, cm=1, n_legs=4, nx=37, nu=24, n_rho=69, nt=15,
                      n_rx=22, n_ru=18, n_gx=30, n_gu=42),
    "point_feet": dict(nc=2, cm=1, n_legs=2, nx=25, nu=12, n_rho=45, nt=15,
                       n_rx=16, n_ru=12, n_gx=24, n_gu=24),
    "square_feet": dict(nc=8, cm=4, n_legs=2, nx=61, nu=48, n_rho=129,
                        nt=15, n_rx=34, n_ru=30, n_gx=54, n_gu=78),
    "line_feet_quadruped": dict(nc=8, cm=2, n_legs=4, nx=61, nu=48,
                                n_rho=125, nt=15, n_rx=34, n_ru=30, n_gx=50,
                                n_gu=78),
}
# the steps, in the order of csrc/srbd_common.cuh's step tags (Euler, Rk2,
# Rk4); under RK2 and RK4 every row of B is live (n_ru = nx)
STEPS = ("EULER", "RK2", "RK4")


def _instance(topology: str, step: str) -> dict:
    sizes = dict(TOPOLOGIES[topology], step=step)
    if step != "EULER":
        sizes["n_ru"] = sizes["nx"]
    return sizes


def stepped_instances(instance, names) -> dict:
    """`instance(name, step)` of the topologies `names` under Euler, then
    of each under RK2 and RK4, keyed as `KERNEL_SHAPES` names them."""
    return {
        **{name: instance(name, "EULER") for name in names},
        **{f"{name}_{step.lower()}": instance(name, step)
           for name in names for step in STEPS[1:]},
    }


# The (topology, step) instances K3, K4 and srbd_evaluate are compiled
# for, in the order of csrc/srbd_common.cuh's `with_shape`: the first three
# topologies under Euler, then each under RK2 and RK4, then the square-feet
# biped and the line-feet quadruped, each under the three steps (appended,
# so the earlier indices stand).
KERNEL_SHAPES = {
    **stepped_instances(_instance, ("kangaroo", "quadruped", "point_feet")),
    **stepped_instances(_instance, ("square_feet",)),
    **stepped_instances(_instance, ("line_feet_quadruped",))}

# the parameter rows the residuals read, in the kernels' order
PARAM_KEYS = ("mask_track", "orientation_tracking_gain", "oref", "rdot_ref",
              "w_ref", "c_ref", "cdot_switch")
N_TRACK = 15      # tracking rows = terminal rows


def kernel_sizes(terms, nx: int, nu: int, rows=None):
    """The sizes an SRBD kernel would be compiled for: the problem's and
    its step, and with `rows` (a `RiccatiRows`) the row counts K4 emits."""
    sizes = dict(nc=terms.nc, cm=terms.contact_model,
                 n_legs=terms.number_of_legs, step=terms.step, nx=nx, nu=nu,
                 n_rho=terms.n_rho, nt=N_TRACK)
    if rows is not None:
        sizes.update(n_rx=len(rows.rx), n_ru=len(rows.ru),
                     n_gx=len(rows.gx), n_gu=len(rows.gu))
    return sizes


def check_kernel_shape(name: str, terms, nx: int, nu: int, rows=None) -> str:
    """The name of the instance in `KERNEL_SHAPES` that has these sizes
    and this step (an RK problem never matches an Euler instance);
    ValueError, naming the sizes, if the SRBD kernels are compiled for
    none."""
    sizes = kernel_sizes(terms, nx, nu, rows)
    for shape, want in KERNEL_SHAPES.items():
        if sizes == {k: want[k] for k in sizes}:
            return shape
    known = "; ".join(f"{shape} {want}" for shape, want in KERNEL_SHAPES.items())
    raise ValueError(
        f"{name} has no kernel for the sizes {sizes}; it is compiled for "
        f"{known} (csrc/srbd_common.cuh)")


def shape_index(shape: str) -> int:
    """The position of `shape` in `KERNEL_SHAPES`, which the sources'
    occupancy entries take (`srbd::with_shape`)."""
    if shape not in KERNEL_SHAPES:
        raise ValueError(f"no SRBD kernel shape {shape!r}; the shapes are "
                         f"{tuple(KERNEL_SHAPES)}")
    return list(KERNEL_SHAPES).index(shape)


# the fields K4's and K3's occupancy queries write, in order
OCCUPANCY_FIELDS = ("blocks_per_sm", "shared_memory_bytes",
                    "registers_per_thread", "local_bytes_per_thread")


def occupancy(dtype=torch.float32, shape: str = "kangaroo") -> dict:
    """K4's occupancy at the shape `shape` for tensors of `dtype`: blocks
    resident on one SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`),
    shared memory bytes a block, registers and local (spilled) bytes a
    thread."""
    return occupancy_query("srbd_linearize", "srbd_linearize_occupancy",
                           OCCUPANCY_FIELDS, shape_index(shape),
                           int(dtype == torch.float64))


def kernel_params(params, Bsz, ns, nc, dtype, device):
    """The seven parameter tensors a kernel reads, checked: each
    (B, ns+1, dim), contiguous, on `device` and of `dtype`."""
    out = []
    for key, dim in zip(PARAM_KEYS, (1, 1, 4, 3, 3, nc, nc)):
        check_tensor(key, params[key], (Bsz, ns + 1, dim), dtype, device)
        out.append(params[key])
    return out


def _drot(o):
    """∂R/∂oⱼ of the homogeneous quat_to_rot, (..., 4, 3, 3)."""
    x, y, z, w = (2 * o[..., i] for i in range(4))

    def m(*v):
        return torch.stack(v, dim=-1).reshape(o.shape[:-1] + (3, 3))

    return torch.stack([
        m(x, y, z, y, -x, -w, z, w, -x),
        m(-y, x, w, x, y, z, -w, z, -y),
        m(-z, -w, x, w, -z, y, x, y, z),
        m(w, -z, y, z, w, -x, -y, x, w),
    ], dim=-3)


def _wdot_jacobians(x, u, wdot, terms):
    """∂ω̇/∂x (..., 3, nx) and ∂ω̇/∂u (..., 3, nu): Iw⁻¹ applied (Cramer) to
    every column of ∂b, b = τ − ω × Iw ω."""
    nc = terms.nc
    nx, nu = x.shape[-1], u.shape[-1]
    lead = x.shape[:-1]
    i_c, i_w = 7, 10 + 3 * nc
    s, i = split_srbd_state(x, nc), split_srbd_input(u, nc)
    o, w, f = s["o"], s["w"], i["f"]
    I = terms.inertia_scaled
    R = quat_to_rot(o)
    RI = R @ I
    Iw = RI @ R.transpose(-1, -2)
    h = (Iw @ w[..., None])[..., 0]
    dR = _drot(o)
    dIw = (dR @ I @ R.transpose(-1, -2)[..., None, :, :]
           + RI[..., None, :, :] @ dR.transpose(-1, -2))         # (..., 4, 3, 3)
    v1 = (dIw @ wdot[..., None, :, None])[..., 0]
    v2 = (dIw @ w[..., None, :, None])[..., 0]
    m_o = -v1 - cross(w[..., None, :], v2)                         # (..., 4, 3)

    Mx = x.new_zeros(lead + (3, nx))
    Mx[..., 0:3] = skew(torch.sum(f, dim=-2))
    Mx[..., 3:7] = m_o.transpose(-1, -2)
    Mx[..., i_c:i_c + 3 * nc] = (-skew(f)).transpose(-3, -2).reshape(
        lead + (3, 3 * nc))
    Mx[..., i_w:i_w + 3] = skew(h) - skew(w) @ Iw
    Mu = u.new_zeros(lead + (3, nc, 6))
    Mu[..., 3:6] = skew(s["c"] - s["r"][..., None, :]).transpose(-3, -2)
    Mu = Mu.reshape(lead + (3, nu))

    def solve_cols(M):
        return solve3x3(Iw[..., None, :, :], M.transpose(-1, -2)).transpose(-1, -2)

    return solve_cols(Mx), solve_cols(Mu)


def _quat_err_jac(q):
    """∂(o ⊗ q)/∂o = [[q_w I − [q_v]ₓ, q_v], [−q_vᵀ, q_w]], (..., 4, 4)."""
    q0, q1, q2, q3 = (q[..., i] for i in range(4))
    rows = [[q3, q2, -q1, q0], [-q2, q3, q0, q1], [q1, -q0, q3, q2],
            [-q0, -q1, -q2, q3]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _tracking_jac(p, terms, nx, mt=None):
    """∂/∂x of the 15 tracking rows (the terminal residual's when mt is
    None: mask 1), (..., 15, nx)."""
    nc, cm = terms.nc, terms.contact_model
    i_c, i_rdot, i_w = 7, 7 + 3 * nc, 10 + 3 * nc
    otg = p["orientation_tracking_gain"][..., 0]
    lead = otg.shape
    J = otg.new_zeros(lead + (N_TRACK, nx))
    one = torch.ones_like(otg)
    mt = one if mt is None else mt
    J[..., 0, 2] = mt * terms.w_r
    J[..., 1:5, 3:7] = (mt * otg)[..., None, None] * _quat_err_jac(p["oref"])
    for j in range(3):
        J[..., 5 + j, i_rdot + j] = mt * terms.w_rdot
        J[..., 8 + j, i_w + j] = mt * terms.w_w
    wrel = mt * terms.w_rel
    for g, a, b in ((11, 1, 3 * cm + 1), (12, 0, 3 * cm),
                    (13, 3 * (cm - 1) + 1, 3 * (nc - 1) + 1),
                    (14, 3 * (cm - 1), 3 * (nc - 1))):
        J[..., g, i_c + a] -= wrel
        J[..., g, i_c + b] += wrel
    return J


def _xdot_jacobians(x, u, terms):
    """ẋ (..., nx), ∂ẋ/∂x (..., nx, nx) and ∂ẋ/∂u (..., nx, nu) of the
    SRBD dynamics at (x, u), in closed form."""
    nc = terms.nc
    nx, nu = x.shape[-1], u.shape[-1]
    i_c, i_rdot, i_w, i_cdot = 7, 7 + 3 * nc, 10 + 3 * nc, 13 + 3 * nc
    consts = dict(m_scaled=terms.m_scaled, inertia_scaled=terms.inertia_scaled)
    xd = srbd_xdot(x, u, consts)
    Wx, Wu = _wdot_jacobians(x, u, xd[..., i_w:i_w + 3], terms)
    s = split_srbd_state(x, nc)
    o, w = s["o"], s["w"]
    lead = x.shape[:-1]
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    Jxd = x.new_zeros(lead + (nx, nx))
    Jxd[..., 0:3, i_rdot:i_rdot + 3] = eye3
    Jxd[..., 3:7, 3:6] = 0.5 * torch.cat([skew(w), -w[..., None, :]], dim=-2)
    Jxd[..., 3:6, 6] = 0.5 * w
    Jxd[..., 3:7, i_w:i_w + 3] = 0.5 * torch.cat(
        [o[..., 3, None, None] * eye3 - skew(o[..., :3]), -o[..., None, :3]], dim=-2)
    Jxd[..., i_c:i_rdot, i_cdot:] = torch.eye(3 * nc, dtype=x.dtype, device=x.device)
    Jxd[..., i_w:i_w + 3, :] = Wx
    Jud = x.new_zeros(lead + (nx, nc, 6))
    for j in range(3):
        Jud[..., i_rdot + j, :, 3 + j] = 1.0 / terms.m_scaled
    Jud = Jud.reshape(lead + (nx, nu))
    Jud[..., i_w:i_w + 3, :] = Wu
    for q in range(3 * nc):
        Jud[..., i_cdot + q, 6 * (q // 3) + q % 3] = 1.0
    return xd, Jxd, Jud, Wx, Wu


# each step's stage points: stage s is evaluated at x + c_s·dt·k_{s−1}
# (ocp/integrators.py)
STAGE_POINTS = {"EULER": (0.0,), "RK2": (0.0, 0.5), "RK4": (0.0, 0.5, 0.5, 1.0)}


def step_jacobians(x, u, terms, dt: float):
    """The problem's step x⁺ = step(x, u) (`terms.step`: EULER, RK2 or
    RK4) and its Jacobians A − I = ∂x⁺/∂x − I and B = ∂x⁺/∂u, composed by
    the chain rule from ∂ẋ/∂x and ∂ẋ/∂u at each stage point, the stages'
    sums in the order of ocp/integrators.py. Returns (x⁺, A − I, B) and
    the ∂ω̇ blocks at (x, u) (the residual reads ω̇ there)."""
    xd, Fx, Fu, Wx, Wu = _xdot_jacobians(x, u, terms)
    if terms.step == "EULER":
        return x + dt * xd, dt * Fx, dt * Fu, Wx, Wu
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    k, kx, ku = xd, Fx, Fu
    ks, kxs, kus = [k], [kx], [ku]
    for c in STAGE_POINTS[terms.step][1:]:
        k, Fx_s, Fu_s, _, _ = _xdot_jacobians(x + (c * dt) * k, u, terms)
        kx = Fx_s @ (eye + (c * dt) * kx)
        ku = Fx_s @ ((c * dt) * ku) + Fu_s
        ks.append(k)
        kxs.append(kx)
        kus.append(ku)
    if terms.step == "RK2":
        return x + dt * ks[1], dt * kxs[1], dt * kus[1], Wx, Wu
    # x + dt/6 (k1 + 2 k2 + 2 k3 + k4), as integrators.rk4 sums it
    comb = lambda v: v[0] + 2 * v[1] + 2 * v[2] + v[3]
    return (x + (dt / 6.0) * comb(ks), (dt / 6.0) * comb(kxs),
            (dt / 6.0) * comb(kus), Wx, Wu)


def srbd_linearize_plain(X, U, params, terms, rows, dt: float, wc: float):
    """Plain PyTorch K4. X (B,ns+1,nx), U (B,ns,nu), params leaves
    (B,ns+1,dim), `terms` the problem's `SRBDTerms`, `rows` its
    `RiccatiRows`, wc = √w_c in the working dtype. Returns the dict
    Sx, Bs, Jxp, Jup, rho, rt, Jt, d (contiguous, batch-first), the
    dynamics blocks and the defects under the problem's step
    (`step_jacobians`)."""
    Bsz, ns1, nx = X.shape
    ns, nu, nc = ns1 - 1, U.shape[-1], terms.nc
    cm, n_legs = terms.contact_model, terms.number_of_legs
    i_c, i_rdot, i_w, i_cdot = 7, 7 + 3 * nc, 10 + 3 * nc, 13 + 3 * nc
    n_res = 21 + 9 * nc
    nr = terms.n_rho
    idx = rows.index(X.device)

    x = X[:, :ns]
    p = {k: params[k][:, :ns] for k in PARAM_KEYS}
    xnext, AmI, Bd, Wx, Wu = step_jacobians(x, U, terms, dt)
    lead = (Bsz, ns)

    # ∂ρ/∂x and ∂ρ/∂u of the stacked stage residual
    mt = p["mask_track"][..., 0]
    cs = p["cdot_switch"]
    Jrx = X.new_zeros(lead + (nr, nx))
    Jrx[..., :N_TRACK, :] = _tracking_jac(p, terms, nx, mt)
    Jrx[..., 18:21, :] = terms.w_qddot * Wx
    row = n_res
    for leg in range(n_legs):
        base = leg * cm
        for i in range(1, cm):
            for ax in (0, 1):
                Jrx[..., row, i_cdot + 3 * base + ax] = wc * 1.0
                Jrx[..., row, i_cdot + 3 * (base + i) + ax] = wc * -1.0
                row += 1
    for k in range(nc):
        Jrx[..., row + k, i_c + 3 * k + 2] = wc * 1.0
    row += nc
    for k in range(nc):
        for ax in (0, 1):
            Jrx[..., row, i_cdot + 3 * k + ax] = wc * cs[..., k]
            row += 1
    Jru = X.new_zeros(lead + (nr, nu))
    i_mf = 21 + 3 * nc
    for k in range(nc):
        for j in range(3):
            fcol = 6 * k + 3 + j
            Jru[..., 15 + j, fcol] = terms.w_qddot * (1.0 / terms.m_scaled)
            Jru[..., 21 + 3 * k + j, 6 * k + j] = terms.w_qddot
            Jru[..., i_mf + 3 * k + j, fcol] = terms.w_minf
            Jru[..., i_mf + 3 * nc + 3 * k + j, fcol] = (
                terms.w_fswitch * (1.0 - cs[..., k]))
    Jru[..., 18:21, :] = terms.w_qddot * Wu

    p_term = {k: params[k][:, ns] for k in PARAM_KEYS}
    xT = X[:, ns]
    return dict(
        Sx=AmI.index_select(-2, idx["rx"]).contiguous(),
        Bs=Bd.index_select(-2, idx["ru"]).contiguous(),
        Jxp=Jrx.index_select(-2, idx["gx"]).contiguous(),
        Jup=Jru.index_select(-2, idx["gu"]).contiguous(),
        rho=terms.stage_rho(x, U, p, wc).contiguous(),
        rt=terms.terminal_residual(xT, p_term).contiguous(),
        Jt=_tracking_jac(p_term, terms, nx).contiguous(),
        d=(xnext - X[:, 1:]).contiguous(),
    )


_P = ctypes.c_void_p
_I = ctypes.c_int


def _kernel_fn(dtype):
    lib = library("srbd_linearize")
    fn = lib.srbd_linearize_f32 if dtype == torch.float32 else lib.srbd_linearize_f64
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 10 + [_P] * 10
        fn.restype = _I
    return fn


def srbd_linearize(X, U, params, terms, rows, dt: float, wc: float):
    """K4. Same contract as `srbd_linearize_plain`; launches the CUDA kernel
    for CUDA tensors of the sizes and step of an instance in
    `KERNEL_SHAPES` (and counts the launch in `srbd_linearize.launches` and
    in its instance's entry of `srbd_linearize.shape_launches`), raises
    ValueError for others."""
    if X.device.type == "cpu":
        return srbd_linearize_plain(X, U, params, terms, rows, dt, wc)
    Bsz, ns1, nx = X.shape
    ns, nc = ns1 - 1, terms.nc
    nu = U.shape[-1]
    shape = check_kernel_shape("srbd_linearize", terms, nx, nu, rows)
    if X.device.type != "cuda":
        raise ValueError(f"srbd_linearize runs on cpu or cuda, got {X.device}")
    dtype, dev = X.dtype, X.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"srbd_linearize takes float32 or float64, got {dtype}")
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    pt = kernel_params(params, Bsz, ns, nc, dtype, dev)
    n_rx, n_ru, n_gx, n_gu = (len(rows.rx), len(rows.ru), len(rows.gx),
                              len(rows.gu))
    nr = terms.n_rho
    if max(rows.rx + rows.ru) >= nx or max(rows.gx + rows.gu) >= nr:
        raise ValueError("row table out of range for this problem")
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    out = dict(Sx=new(Bsz, ns, n_rx, nx), Bs=new(Bsz, ns, n_ru, nu),
               Jxp=new(Bsz, ns, n_gx, nx), Jup=new(Bsz, ns, n_gu, nu),
               rho=new(Bsz, ns, nr), d=new(Bsz, ns, nx),
               rt=new(Bsz, N_TRACK), Jt=new(Bsz, N_TRACK, nx))
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    scalars = (ctypes.c_double * 24)(*terms.kernel_scalars(dt, wc))
    fn = _kernel_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            X.data_ptr(), U.data_ptr(), ptrs, rows.packed(dev).data_ptr(),
            Bsz, ns, nc, terms.contact_model, terms.number_of_legs,
            STEPS.index(terms.step), n_rx, n_ru, n_gx, n_gu, scalars,
            *(out[k].data_ptr() for k in ("Sx", "Bs", "Jxp", "Jup", "rho",
                                           "d", "rt", "Jt")),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"srbd_linearize kernel failed: CUDA error {err}")
    srbd_linearize.launches += 1
    srbd_linearize.shape_launches[shape] += 1
    return out


srbd_linearize.launches = 0
# the launches of each (topology, step) instance, by its KERNEL_SHAPES name
srbd_linearize.shape_launches = dict.fromkeys(KERNEL_SHAPES, 0)
