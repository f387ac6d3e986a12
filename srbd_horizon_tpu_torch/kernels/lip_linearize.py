"""K10: the closed-form sliced linearization of the LIP problem.

`lip_linearize` is the wrapper the solver calls. A CPU tensor goes to
`lip_linearize_plain`, the batched closed form in plain PyTorch; a CUDA
tensor launches the hand-written kernel in `csrc/lip_linearize.cu`, or
raises.

Both compute, in the batch-first layout K1 reads, what the JAX package's
dense `MSDDP._linearize_impl` (srbd_horizon_tpu/solvers/msddp.py:200-246,
`jax.jacfwd` of the problem's step and of `_stage_rho`; the JAX LIP
problem declares no row sparsity) computes, sliced by the rows
`problems/lip.py::row_sets` declares, per member b and node n:

    Sx  = (A − I)[rx]     (B,ns,|rx|,nx)    Bs  = B[ru]           (B,ns,|ru|,nu)
    Jxp = (∂ρ/∂x)[gx]     (B,ns,|gx|,nx)    Jup = (∂ρ/∂u)[gu]     (B,ns,|gu|,nu)
    ρ   = [residual; √w_c·eq]  (B,ns,nr)     d   = step(x, u) − X[n+1]  (B,ns,nx)
    rt  = terminal residual (B,10)          Jt  = ∂rt/∂x (B,10,nx)

with A = ∂step/∂x, B = ∂step/∂u of the problem's step (`LIPTerms.step`):
under Euler A − I = dt·∂ẋ/∂x, B = dt·∂ẋ/∂u; under RK2 and RK4 the chain
rule through the stages (`step_blocks`), and every row of B is live.

The LIP is linear–quadratic: every Jacobian entry is a constant of dt, η²,
1/nc and the weights, except the tracking rows, which `mask_track`
scales, and the ċxy equality rows, which `cdot_switch` scales (those
rows are live at node 0 too: zmp and r̈, c̈ are never masked). Each state
pair (rₐ, ṙₐ) and (c_q, ċ_q) is its own linear system, so A and B are 2×2
blocks and 2-vectors a pair.

What bounds the kernel on an H100: bytes — a member-node of the
Kangaroo writes 2,069 values (Sx 540, Bs 225, Jxp 960, Jup 270, ρ 44,
d 30; under RK Bs is 450) and reads 87, and computes almost nothing (the
note in the .cu gives the design: groups of one member-node at small B,
of 16 bytes' worth at fleet sizes, the Jacobian templates formed once
here by `templates` and kept on the device, `schedule` its launch). A
call's host work: the shape check and a `_Setup` (entry, scalars, row and
template tables, output layout, pointer arrays) made once a size through
`host_setup`, one `check_tensors` pass, one buffer cut into the outputs
(`build.output_views`), the raw stream.

K10, K11 and lip_evaluate are compiled for five LIP topologies, the
Kangaroo's line feet, the point-feet quadruped's, the point-feet biped's,
the square-feet biped's and the line-feet quadruped's
(`lip::KangarooShape`, `lip::QuadShape`, `lip::PointFeetShape`,
`lip::SquareFeetShape`, `lip::LineFeetQuadShape` in csrc/lip_common.cuh,
`TOPOLOGIES` here), each under the Euler, RK2 and RK4 steps
(`KERNEL_SHAPES`, the fifteen instances); their wrappers raise
ValueError, naming the sizes and the step, for CUDA tensors of any other
(an RK problem never reaches an Euler instance), and take the plain twin
for CPU tensors of any sizes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from srbd_horizon_tpu_torch.kernels.build import (
    check_tensor,
    check_tensors,
    host_setup,
    launch,
    layout_of,
    library,
    out_slots,
    output_views,
)
from srbd_horizon_tpu_torch.kernels.linearize import (
    STAGE_POINTS,
    stepped_instances,
)
from srbd_horizon_tpu_torch.kernels.rollout import step_fn
from srbd_horizon_tpu_torch.problems.lip import N_TERMINAL

# the function K10 replaces (jacfwd under vmap, XLA-fused; the JAX package
# wrote no Pallas kernel for it)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:200"
SOURCE = "srbd_horizon_tpu_torch/csrc/lip_linearize.cu"

# The topologies K10, K11 and lip_evaluate are compiled for, in the order
# of the shape structs of csrc/lip_common.cuh (KangarooShape, QuadShape,
# PointFeetShape, SquareFeetShape, LineFeetQuadShape): build_lip_problem
# with the Kangaroo's line feet, the quadruped's point feet, the point-feet
# biped, the square-feet biped (contact_model=4, four points a foot: nx=54,
# nu=27) and the line-feet quadruped (contact_model=2 on four legs: the
# same nx and nu), under the Euler step. The row counts are K10's
# (`RiccatiRows.from_ocp` of each OCP).
TOPOLOGIES = {
    "kangaroo": dict(nc=4, cm=2, n_legs=2, nx=30, nu=15, n_rho=44, nt=10,
                     n_rx=18, n_ru=15, n_gx=32, n_gu=18),
    "quadruped": dict(nc=4, cm=1, n_legs=4, nx=30, nu=15, n_rho=40, nt=10,
                      n_rx=18, n_ru=15, n_gx=28, n_gu=18),
    "point_feet": dict(nc=2, cm=1, n_legs=2, nx=18, nu=9, n_rho=28, nt=10,
                       n_rx=12, n_ru=9, n_gx=22, n_gu=12),
    "square_feet": dict(nc=8, cm=4, n_legs=2, nx=54, nu=27, n_rho=76, nt=10,
                        n_rx=30, n_ru=27, n_gx=52, n_gu=30),
    "line_feet_quadruped": dict(nc=8, cm=2, n_legs=4, nx=54, nu=27, n_rho=72,
                                nt=10, n_rx=30, n_ru=27, n_gx=48, n_gu=30),
}
# the steps, in the order of csrc/lip_common.cuh's step tags (Euler, Rk2,
# Rk4); under RK2 and RK4 every row of B is live (n_ru = nx)
STEPS = ("EULER", "RK2", "RK4")


def _instance(topology: str, step: str) -> dict:
    sizes = dict(TOPOLOGIES[topology], step=step)
    if step != "EULER":
        sizes["n_ru"] = sizes["nx"]
    return sizes


# The (topology, step) instances K10, K11 and lip_evaluate are compiled
# for, in the order of csrc/lip_common.cuh's `with_shape`: the first three
# topologies under Euler, then each under RK2 and RK4, then the square-feet
# biped and the line-feet quadruped, each under the three steps (appended,
# so the earlier indices stand).
KERNEL_SHAPES = {
    **stepped_instances(_instance, ("kangaroo", "quadruped", "point_feet")),
    **stepped_instances(_instance, ("square_feet",)),
    **stepped_instances(_instance, ("line_feet_quadruped",))}

# the parameter rows the residuals read, in the kernels' order
PARAM_KEYS = ("mask_track", "rdot_ref", "c_ref", "cdot_switch")
N_SCALARS = 13       # LIPTerms.kernel_scalars


def kernel_sizes(terms, nx: int, nu: int, rows=None):
    """The sizes a LIP kernel would be compiled for: the problem's and its
    step, and with `rows` (a `RiccatiRows`) the row counts K10 emits."""
    sizes = dict(nc=terms.nc, cm=terms.contact_model,
                 n_legs=terms.number_of_legs, step=terms.step, nx=nx, nu=nu,
                 n_rho=terms.n_rho, nt=N_TERMINAL)
    if rows is not None:
        sizes.update(n_rx=len(rows.rx), n_ru=len(rows.ru),
                     n_gx=len(rows.gx), n_gu=len(rows.gu))
    return sizes


def check_kernel_shape(name: str, terms, nx: int, nu: int, rows=None) -> str:
    """The name of the instance in `KERNEL_SHAPES` that has these sizes and
    this step (an RK problem never matches an Euler instance); ValueError,
    naming the sizes, if the LIP kernels are compiled for none."""
    sizes = kernel_sizes(terms, nx, nu, rows)
    for shape, want in KERNEL_SHAPES.items():
        if sizes == {k: want[k] for k in sizes}:
            return shape
    known = "; ".join(f"{shape} {want}" for shape, want in KERNEL_SHAPES.items())
    raise ValueError(
        f"{name} has no kernel for the sizes {sizes}; it is compiled for "
        f"{known} (csrc/lip_common.cuh)")


def shape_index(shape: str) -> int:
    """The position of `shape` in `KERNEL_SHAPES`, which the C entries and
    the occupancy entries take (`lip::with_shape`)."""
    if shape not in KERNEL_SHAPES:
        raise ValueError(f"no LIP kernel shape {shape!r}; the shapes are "
                         f"{tuple(KERNEL_SHAPES)}")
    return list(KERNEL_SHAPES).index(shape)


def kernel_params(params, Bsz, ns, nc, dtype, device):
    """The four parameter tensors a kernel reads, checked: each
    (B, ns+1, dim), contiguous, on `device` and of `dtype`."""
    out = []
    for key, dim in zip(PARAM_KEYS, (1, 3, nc, nc)):
        check_tensor(key, params[key], (Bsz, ns + 1, dim), dtype, device)
        out.append(params[key])
    return out


def _rel_pairs(terms):
    """(row, a, b) of the four rel rows: the row is w·((−c[a] + c[b]) − d),
    a and b offsets into c."""
    cm, nc = terms.contact_model, terms.nc
    return ((0, 1, 3 * cm + 1), (1, 0, 3 * cm),
            (2, 3 * (cm - 1) + 1, 3 * (nc - 1) + 1),
            (3, 3 * (cm - 1), 3 * (nc - 1)))


def _tracking_jac(J, terms, mt, row_rel):
    """The tracking rows rz, rxy, ṙ (rows 0:6) and the rel rows (from
    `row_rel`) of ∂ρ/∂x, scaled by mt, into J (…, rows, nx)."""
    nc = terms.nc
    i_rdot = 3 + 3 * nc
    w_r = mt * terms.w_r
    J[..., 0, 2] = w_r
    for j in range(2):
        J[..., 1 + j, j] = w_r
        for k in range(nc):
            J[..., 1 + j, 3 + 3 * k + j] = -w_r / nc
    for j in range(3):
        J[..., 3 + j, i_rdot + j] = mt * terms.w_rdot
    w_rel = mt * terms.w_rel
    for g, a, b in _rel_pairs(terms):
        J[..., row_rel + g, 3 + a] -= w_rel
        J[..., row_rel + g, 3 + b] += w_rel


def lip_linearize_plain(X, U, params, terms, rows, dt: float, wc: float):
    """Plain PyTorch K10. X (B,ns+1,nx), U (B,ns,nu), params leaves
    (B,ns+1,dim), `terms` the problem's `LIPTerms`, `rows` its
    `RiccatiRows`, wc = √w_c in the working dtype. Returns the dict
    Sx, Bs, Jxp, Jup, rho, rt, Jt, d (contiguous, batch-first). Sx and Bs
    are the constants of the problem's step (`dynamics_entries`, the
    tables K10's templates hold); d is the step's own defect."""
    Bsz, ns1, nx = X.shape
    ns, nu, nc = ns1 - 1, U.shape[-1], terms.nc
    cm, n_legs = terms.contact_model, terms.number_of_legs
    i_cdot = 6 + 3 * nc
    n_res, nr = terms.n_res, terms.n_rho
    eta2 = terms.eta2
    idx = rows.index(X.device)
    lead = (Bsz, ns)

    x = X[:, :ns]
    p = {k: params[k][:, :ns] for k in PARAM_KEYS}

    # A − I and B of the step (constants)
    dyn = dynamics_entries(terms, rows, dt, X.dtype)
    Sx, Bs = (torch.from_numpy(dyn[k]).to(X.device).expand(
        lead + dyn[k].shape).contiguous() for k in ("Sx", "Bs"))

    # ∂ρ/∂x and ∂ρ/∂u of the stacked stage residual
    mt = p["mask_track"][..., 0]
    cs = p["cdot_switch"]
    Jrx = X.new_zeros(lead + (nr, nx))
    _tracking_jac(Jrx, terms, mt, 9)
    for j in range(3):
        for k in range(nc):
            Jrx[..., 6 + j, 3 + 3 * k + j] = -terms.w_zmp / nc
        Jrx[..., 13 + j, j] = terms.w_qddot * eta2
    row = n_res
    for leg in range(n_legs):
        base = leg * cm
        for i in range(1, cm):
            for ax in (0, 1):
                Jrx[..., row, i_cdot + 3 * base + ax] = wc * 1.0
                Jrx[..., row, i_cdot + 3 * (base + i) + ax] = wc * -1.0
                row += 1
    for k in range(nc):
        Jrx[..., row + k, 3 + 3 * k + 2] = wc * 1.0
    row += nc
    for k in range(nc):
        for ax in (0, 1):
            Jrx[..., row, i_cdot + 3 * k + ax] = wc * cs[..., k]
            row += 1
    Jru = X.new_zeros(lead + (nr, nu))
    for j in range(3):
        Jru[..., 6 + j, j] = terms.w_zmp
        Jru[..., 13 + j, j] = -(terms.w_qddot * eta2)
    for q in range(3 * nc):
        Jru[..., 16 + q, 3 + q] = terms.w_qddot

    p_term = {k: params[k][:, ns] for k in PARAM_KEYS}
    xT = X[:, ns]
    Jt = X.new_zeros((Bsz, N_TERMINAL, nx))
    _tracking_jac(Jt, terms, torch.ones_like(xT[:, 0]), 6)
    step = step_fn(terms.xdot, dt, terms.step)
    return dict(
        Sx=Sx,
        Bs=Bs,
        Jxp=Jrx.index_select(-2, idx["gx"]).contiguous(),
        Jup=Jru.index_select(-2, idx["gu"]).contiguous(),
        rho=terms.stage_rho(x, U, p, wc).contiguous(),
        rt=terms.terminal_residual(xT, p_term).contiguous(),
        Jt=Jt,
        d=(step(x, U) - X[:, 1:]).contiguous(),
    )


_P = ctypes.c_void_p
_I = ctypes.c_int
NAME = "lip_linearize"

# K10's block (the .cu's kSlotThreads, kMinBlocks, kGroupUnits): 512
# threads, the grid at most two blocks an SM, a fleet's group
# GROUP_UNITS · vec_nodes member-nodes
THREADS = 512
MIN_BLOCKS = 2
GROUP_UNITS = 1
# the outputs, in the kernel's and the returned dict's order
FIELDS = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "rt", "Jt")
# the per-node templates of the table, in its order (the .cu's K10<S>)
TEMPLATES = ("Sx", "Bs", "Jxp", "Jup", "Jt")


def vec_nodes(dtype) -> int:
    """Member-nodes a 16-byte group (the .cu's kVec<T>): 4 in float32, 2
    in float64."""
    return 16 // (torch.finfo(dtype).bits // 8)


def group_nodes(Bsz: int, ns: int, dtype, sms: int,
                shape: str = "kangaroo") -> int:
    """Member-nodes a K10 group at B members (the .cu's `group_nodes`):
    GROUP_UNITS · `vec_nodes` where those groups fill every one of `sms`
    SMs, else 1; always 1 past 32 state rows, the eight-contact robots'
    (the .cu's `kVecGroup`: their 16-byte groups spill)."""
    v = GROUP_UNITS * vec_nodes(dtype)
    if Bsz * ns < v * sms or KERNEL_SHAPES[shape]["nx"] > 32:
        return 1
    return v


def schedule(Bsz: int, ns: int, dtype, sms: int, shape: str = "kangaroo"):
    """K10's launch at B members on `sms` SMs at the instance `shape`:
    (member-nodes a group G, stage groups, all groups, blocks), as the
    .cu's `launch_groups` sets them."""
    v = group_nodes(Bsz, ns, dtype, sms, shape)
    n_stage = -(-Bsz * ns // v)
    n_groups = n_stage + -(-Bsz // v)
    return v, n_stage, n_groups, min(n_groups, sms * MIN_BLOCKS)


def output_shapes(Bsz: int, ns: int, sizes: dict):
    """K10's outputs ((slot, shape), …) in `FIELDS` order; `sizes` holds
    nx, nu, n_rho and the row counts (an entry of `KERNEL_SHAPES`)."""
    z = sizes
    nx, nu = z["nx"], z["nu"]
    return tuple(enumerate((
        (Bsz, ns, z["n_rx"], nx), (Bsz, ns, z["n_ru"], nu),
        (Bsz, ns, z["n_gx"], nx), (Bsz, ns, z["n_gu"], nu),
        (Bsz, ns, z["n_rho"]), (Bsz, ns, nx), (Bsz, N_TERMINAL),
        (Bsz, N_TERMINAL, nx))))


def _pair_step(m, n, dt: float, step: str, T):
    """(A − I, B) of one state pair (position, velocity) under the step
    `step`, its ẋ = m·(p, v) + n·w + const with m a 2×2 and n a 2-vector
    of T: the chain rule through the stages (dk_s = m (I + c_s·dt·dk_{s−1})
    in x, m (c_s·dt·dk_{s−1}) + n in w), the stages summed as
    ocp/integrators.py sums them, every product and sum rounded in T.
    Under Euler, A − I = dt·m and B = dt·n."""
    dt_ = T(dt)
    scale = lambda f, a: [[f * a[i][j] for j in range(2)] for i in range(2)]
    if step == "EULER":
        return scale(dt_, m), [dt_ * n[0], dt_ * n[1]]
    one, zero = T(1), T(0)
    kx, ku = m, list(n)
    kxs, kus = [kx], [ku]
    for c in STAGE_POINTS[step][1:]:
        cdt = T(c * dt)
        y = [[(one if i == j else zero) + cdt * kx[i][j] for j in range(2)]
             for i in range(2)]
        kx = [[m[i][0] * y[0][j] + m[i][1] * y[1][j] for j in range(2)]
              for i in range(2)]
        ku = [(m[i][0] * (cdt * ku[0]) + m[i][1] * (cdt * ku[1])) + n[i]
              for i in range(2)]
        kxs.append(kx)
        kus.append(ku)
    if step == "RK2":
        return scale(dt_, kxs[1]), [dt_ * kus[1][0], dt_ * kus[1][1]]
    sixth, two = T(dt / 6.0), T(2)
    comb = lambda v: ((v[0] + two * v[1]) + two * v[2]) + v[3]
    amI = [[sixth * comb([k[i][j] for k in kxs]) for j in range(2)]
           for i in range(2)]
    return amI, [sixth * comb([k[i] for k in kus]) for i in range(2)]


def step_blocks(terms, dt: float, dtype) -> dict:
    """The step's A − I (2×2) and B (2-vector) of the two kinds of state
    pair, in the working type: "com" — (rₐ, ṙₐ) with r̈ₐ = η²(rₐ − zₐ) − g
    — and "contact" — (c_q, ċ_q) with c̈_q the input."""
    T = np.float32 if dtype == torch.float32 else np.float64
    eta2, one, zero = T(terms.eta2), T(1), T(0)
    return dict(
        com=_pair_step(((zero, one), (eta2, zero)), (zero, -eta2), dt,
                       terms.step, T),
        contact=_pair_step(((zero, one), (zero, zero)), (zero, one), dt,
                           terms.step, T))


def dynamics_entries(terms, rows, dt: float, dtype) -> dict:
    """Sx = (A − I)[rx] and Bs = B[ru] of the problem's step, each a (rows,
    cols) numpy array in the working type (K10's first two templates and
    the twin's outputs), from `step_blocks`: state row r is the position
    (r < nx/2) or velocity row of pair i = r mod nx/2, whose columns are i
    and i + nx/2 in x and i in u. Made once for (rows, dt, dtype)."""
    key = ("dynamics", rows.rx, rows.ru, float(dt), dtype)
    if key not in terms._cache:
        T = np.float32 if dtype == torch.float32 else np.float64
        nc = terms.nc
        nx, nu, half = 6 + 6 * nc, 3 + 3 * nc, 3 + 3 * nc
        blocks = step_blocks(terms, dt, dtype)
        Sx = np.zeros((len(rows.rx), nx), T)
        Bs = np.zeros((len(rows.ru), nu), T)
        for out, rs in ((Sx, rows.rx), (Bs, rows.ru)):
            for k, r in enumerate(rs):
                i, h = r % half, r // half
                amI, b = blocks["com" if i < 3 else "contact"]
                if out is Sx:
                    out[k, i], out[k, i + half] = amI[h][0], amI[h][1]
                else:
                    out[k, i] = b[h]
        terms._cache[key] = dict(Sx=Sx, Bs=Bs)
    return terms._cache[key]


def template_entries(terms, rows, dt: float, wc: float, dtype) -> dict:
    """The Jacobian templates K10 stores, formed on the host in the working
    type by the .cu's entry formulas (each product and quotient rounded as
    the device rounds it), from the row table: Sx = (A − I)[rx] and Bs =
    B[ru] of the step (`dynamics_entries`), Jxp = (∂ρ/∂x)[gx] before its
    rows' scales (the tracking mask and cdot_switch taken as 1), Jup =
    (∂ρ/∂u)[gu], Jt = ∂rt/∂x; each a (rows, cols) numpy array."""
    T = np.float32 if dtype == torch.float32 else np.float64
    nc, cm, legs = terms.nc, terms.contact_model, terms.number_of_legs
    nx, nu = 6 + 6 * nc, 3 + 3 * nc
    i_c, i_rdot, i_cdot = 3, 3 + 3 * nc, 6 + 3 * nc
    n_res, n_rv = 16 + 3 * nc, 2 * legs * (cm - 1)
    (_, eta2, w_r, w_rdot, w_zmp, w_rel, w_qddot, wc_) = (
        T(v) for v in terms.kernel_scalars(dt, wc)[:8])
    zero, tnc = T(0), T(nc)

    def centroid_col(c, a):
        return i_c <= c < i_rdot and (c - i_c) % 3 == a

    def tracking(g, c):
        if g == 0:
            return w_r if c == 2 else zero
        if g < 3:
            if c == g - 1:
                return w_r
            return -w_r / tnc if centroid_col(c, g - 1) else zero
        if g < 6:
            return w_rdot if c == i_rdot + g - 3 else zero
        ax = 1 if (g - 6) % 2 == 0 else 0
        a = (0 if g - 6 < 2 else 3 * (cm - 1)) + ax
        b = (3 * cm if g - 6 < 2 else 3 * (nc - 1)) + ax
        if c == i_c + a:
            return -w_rel
        return w_rel if c == i_c + b else zero

    def jxp(r, c):
        if r < 6 or 9 <= r < 13:
            return tracking(r if r < 6 else r - 3, c)
        if r < 9:
            return -w_zmp / tnc if centroid_col(c, r - 6) else zero
        if r < 16:
            return w_qddot * eta2 if c == r - 13 else zero
        if r < n_res:
            return zero
        q = r - n_res
        per = 2 * (cm - 1)
        if q < n_rv:
            base, rem = (q // per) * cm, q % per
            i, ax = rem // 2 + 1, rem % 2
            if c == i_cdot + 3 * base + ax:
                return wc_
            return -wc_ if c == i_cdot + 3 * (base + i) + ax else zero
        q -= n_rv
        if q < nc:
            return wc_ if c == i_c + 3 * q + 2 else zero
        q -= nc
        return wc_ if c == i_cdot + 3 * (q // 2) + q % 2 else zero

    def jup(r, c):
        if 6 <= r < 9:
            return w_zmp if c == r - 6 else zero
        if 13 <= r < 16:
            return -(w_qddot * eta2) if c == r - 13 else zero
        if 16 <= r < n_res:
            return w_qddot if c == 3 + r - 16 else zero
        return zero

    def table(f, rs, ncol):
        return np.array([[f(r, c) for c in range(ncol)] for r in rs], dtype=T)

    dyn = dynamics_entries(terms, rows, dt, dtype)
    return dict(Sx=dyn["Sx"], Bs=dyn["Bs"],
                Jxp=table(jxp, rows.gx, nx), Jup=table(jup, rows.gu, nu),
                Jt=table(tracking, range(N_TERMINAL), nx))


def templates(terms, rows, dt: float, wc: float, dtype) -> np.ndarray:
    """K10's template table: `template_entries` in `TEMPLATES` order, each
    flattened and repeated `vec_nodes(dtype)` times (a 16-byte group's unit
    u is then entries [u·V, u·V + V) of its field's run)."""
    e = template_entries(terms, rows, dt, wc, dtype)
    return np.concatenate([np.tile(e[k].ravel(), vec_nodes(dtype))
                           for k in TEMPLATES])


_kernel_fns = {}


def _kernel_fn(dtype):
    fn = _kernel_fns.get(dtype)
    if fn is None:
        lib = library(NAME)
        fn = (lib.lip_linearize_f32 if dtype == torch.float32
              else lib.lip_linearize_f64)
        fn.argtypes = [_P] * 5 + [_I] * 10 + [_P] * 3
        fn.restype = _I
        _kernel_fns[dtype] = fn
    return fn


class _Setup:
    """K10's host work for one (terms, rows, device, dtype, B, ns, dt, wc):
    the entry with its argtypes, the scalars, the row table and the
    template table on the device, the output layout, the tensors' shapes
    and the pointer arrays a call fills in place."""

    def __init__(self, terms, rows, dev, dtype, Bsz, ns, nx, nu, dt, wc):
        self.rows = rows                 # held: the key holds its id
        self.shape = check_kernel_shape(NAME, terms, nx, nu, rows)
        self.fn = _kernel_fn(dtype)
        self.scalars = (ctypes.c_double * N_SCALARS)(
            *terms.kernel_scalars(dt, wc))
        self.table = rows.packed(dev)
        self.tmpl = torch.as_tensor(templates(terms, rows, dt, wc, dtype),
                                    device=dev)
        sizes = kernel_sizes(terms, nx, nu, rows)
        self.layout, self.total = layout_of(output_shapes(Bsz, ns, sizes),
                                            dtype)
        self.out_slots = out_slots(self.layout, dtype)
        nc = terms.nc
        self.shapes = ((Bsz, ns + 1, nx), (Bsz, ns, nu)) + tuple(
            (Bsz, ns + 1, d) for d in (1, 3, nc, nc))
        self.args = (self.table.data_ptr(), self.tmpl.data_ptr(), Bsz, ns,
                     nc, terms.contact_model, terms.number_of_legs,
                     STEPS.index(terms.step), sizes["n_rx"], sizes["n_ru"], sizes["n_gx"],
                     sizes["n_gu"], self.scalars)
        self.params = (_P * len(PARAM_KEYS))()
        self.outs = (_P * len(FIELDS))()


def setup(terms, rows, dev, dtype, Bsz, ns, nx, nu, dt, wc):
    """K10's `_Setup` for these sizes, made once (`host_setup`)."""
    return host_setup(terms, (NAME, id(rows), dev, dtype, Bsz, ns, dt, wc),
                      lambda: _Setup(terms, rows, dev, dtype, Bsz, ns, nx,
                                     nu, dt, wc))


def occupancy(dtype=torch.float32, vec: bool = True, shape: str = "kangaroo"):
    """K10's occupancy on the current card at the instance `shape` (a
    `KERNEL_SHAPES` name) for tensors of `dtype`, with 16-byte groups
    (`vec`, the fleet's launch) or groups of one member-node:
    blocks resident on one SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`;
    its grid takes at most `MIN_BLOCKS` an SM), warps and shared memory
    bytes a block, registers and local (spilled) bytes a thread."""
    fn = library(NAME).lip_linearize_occupancy
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        fn.restype = _I
    out = (_I * 5)()
    err = fn(shape_index(shape), int(dtype == torch.float64), int(vec), out)
    if err != 0:
        raise RuntimeError(f"lip_linearize occupancy query failed: error {err}")
    return dict(blocks_per_sm=out[0], warps_per_block=out[1],
                shared_memory_bytes=out[2], registers_per_thread=out[3],
                local_bytes_per_thread=out[4])


def lip_linearize(X, U, params, terms, rows, dt: float, wc: float):
    """K10. Same contract as `lip_linearize_plain`; launches the CUDA
    kernel for CUDA tensors of the sizes and step of an instance in
    `KERNEL_SHAPES` (and counts the launch in `lip_linearize.launches` and
    in its instance's entry of `lip_linearize.shape_launches`), raises
    ValueError for others. A call's outputs are views of one buffer
    (`output_shapes`, each 16-byte aligned)."""
    if X.device.type == "cpu":
        return lip_linearize_plain(X, U, params, terms, rows, dt, wc)
    nx, nu = X.shape[-1], U.shape[-1]
    dtype, dev = X.dtype, X.device
    shape = host_setup(terms, (NAME, id(rows), nx, nu),  # sizes, then device
                       lambda: (check_kernel_shape(NAME, terms, nx, nu, rows),
                                rows))[0]
    if dev.type != "cuda":
        raise ValueError(f"lip_linearize runs on cpu or cuda, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"lip_linearize takes float32 or float64, got {dtype}")
    out = _launched(X, U, params, terms, rows, dt, wc)
    lip_linearize.launches += 1
    lip_linearize.shape_launches[shape] += 1
    return out


def _launched(X, U, params, terms, rows, dt, wc):
    """K10's launch on X's device, past the shape and device checks: the
    setup, one check of the tensors, the outputs cut from one buffer."""
    Bsz, ns1, nx = X.shape
    ns, nu = ns1 - 1, U.shape[-1]
    dtype, dev = X.dtype, X.device
    s = setup(terms, rows, dev, dtype, Bsz, ns, nx, nu, dt, wc)
    pt = [params[k] for k in PARAM_KEYS]
    check_tensors(zip(("X", "U") + PARAM_KEYS, [X, U] + pt, s.shapes),
                  dtype, dev)
    for i, t in enumerate(pt):
        s.params[i] = t.data_ptr()
    buf, views = output_views(s.layout, s.total, dtype, dev)
    base = buf.data_ptr()
    for slot, off in s.out_slots:
        s.outs[slot] = base + off
    launch(NAME, s.fn, dev, X.data_ptr(), U.data_ptr(), s.params, *s.args,
           s.outs)
    return dict(zip(FIELDS, views))


lip_linearize.launches = 0
# the launches of each (topology, step) instance, by its KERNEL_SHAPES name
lip_linearize.shape_launches = dict.fromkeys(KERNEL_SHAPES, 0)
